"""Navier-Stokes residual kernels (device, jit/vmap/autodiff friendly).

Hand-derived element kernels for the reference's fixed form set — the
JAX-native replacement for the UFL->TSFC->C pipeline:

* ``pkp0`` residual (/root/reference/alfi/solver.py:562-572):
      nu (2 sym grad u, grad v) + gamma (cell_avg(div u), div v)
      + advect ((grad u) u, v) - (p, div v) - (div u, q)
* ``sv`` residual (/root/reference/alfi/solver.py:613-623): same with the
  exact gamma (div u, div v) term.

Everything is built from ONE per-cell kernel:

* global residual      = vmap(cell_kernel) + scatter-add,
* Newton matvec        = jax.jvp of the global residual (exact, matrix-free),
* element tensors      = vmap(jacfwd(cell_kernel)) for patch smoothers and
                         coarse-grid assembly,

so there is a single source of truth for the physics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import real_dtype
from .geometry import CellGeometry
from .quadrature import simplex_quadrature


def _map_cell_chunks(fn, *arrays, chunk):
    """Apply a per-cell-batch tensor builder sequentially over cell
    chunks (lax.map) and concatenate.

    The element-Jacobian builders materialise quadrature-sized temps
    (physical gradients g: nc x nq x nld doubles, plus einsum
    operand copies) — at 3D production sizes (nq = 125 for [P2+FB]^3,
    nc = 24,576 at ldc3d nref=2) that is ~4 GB per temp, plus XLA's
    remat copies.  lax.map
    guarantees the chunks run SEQUENTIALLY, so peak temp memory is one
    chunk's worth; splitting a cell-local contraction by cells is
    bit-exact."""
    from jax import lax

    nc = arrays[0].shape[0]
    if nc <= chunk:
        return fn(*arrays)
    npad = (-nc) % chunk
    if npad:
        arrays = tuple(
            jnp.concatenate(
                [a, jnp.zeros((npad,) + a.shape[1:], a.dtype)])
            for a in arrays)
    stacked = tuple(
        a.reshape((nc + npad) // chunk, chunk, *a.shape[1:])
        for a in arrays)
    out = lax.map(lambda args: fn(*args), stacked)

    def unchunk(o):
        o = o.reshape(-1, *o.shape[2:])
        return o[:nc] if npad else o

    return jax.tree.map(unchunk, out)


class Tabulation:
    """Reference-element tabulation at a quadrature rule (constants)."""

    def __init__(self, element, dim, degree):
        pts, wts = simplex_quadrature(dim, degree)
        self.ref_pts = pts
        self.w = jnp.asarray(wts, dtype=real_dtype)
        self.phi = jnp.asarray(element.tabulate(pts), dtype=real_dtype)
        self.gphi = jnp.asarray(element.tabulate_grad(pts), dtype=real_dtype)
        self.nq = len(wts)
        self.nloc = element.nloc


class NSForm:
    """Residual of the AL Navier-Stokes system for one (V, Q) pair.

    graddiv_mode: 'cell_avg' (Pk-P0) or 'exact' (Scott-Vogelius).
    """

    def __init__(self, V, Q, graddiv_mode, quad_degree=None, rhs=None):
        self.V = V
        self.Q = Q
        mesh = V.mesh
        self.mesh = mesh
        d = mesh.dim
        self.dim = d
        self.graddiv_mode = graddiv_mode
        ku = V.element.degree
        kq = Q.element.degree
        if quad_degree is None:
            # advection (grad u) u . v is the highest-degree term
            quad_degree = max(3 * ku - 1, 2 * ku, ku + kq, 2)
        self.quad_degree = quad_degree
        self.tab_v = Tabulation(V.element, d, quad_degree)
        self.tab_q = Tabulation(Q.element, d, quad_degree)
        self.geom = CellGeometry(mesh)
        self.cd_v = jnp.asarray(V.cell_dofs)
        self.cd_q = jnp.asarray(Q.cell_dofs)
        from ..utils.scatter import default_use_tables, make_gather_sum

        # scatter-add -> gather-sum on accelerators (utils/scatter.py)
        if default_use_tables():
            self._sum_v = make_gather_sum(V.cell_dofs, V.ndof)
            self._sum_q = make_gather_sum(Q.cell_dofs, Q.ndof)
        else:
            self._sum_v = self._sum_q = None
        #: optional forcing: rhs(x (nq,d), params) -> (f_v (nq,d), f_q (nq,))
        self.rhs = rhs
        #: optional extra velocity residual hook: fn(z, params) -> Rv global
        self.stabilisation = None

    # ------------------------------------------------------------------
    # per-cell kernels
    # ------------------------------------------------------------------
    def _vel_fields(self, u_loc, jinv):
        """u at quad points (nq, d) and grad u (nq, d, d) for one cell."""
        tv = self.tab_v
        u_q = jnp.einsum("ql,ld->qd", tv.phi, u_loc)
        gu = jnp.einsum("qle,ej,li->qij", tv.gphi, jinv, u_loc)
        return u_q, gu

    def _vel_testgrad(self, jinv):
        """Physical gradients of velocity test functions (nq, nloc, d)."""
        return jnp.einsum("qle,ej->qlj", self.tab_v.gphi, jinv)

    def cell_velocity_residual(self, u_loc, wind_loc, jinv, detj, vol,
                               params):
        """Velocity-block residual on one cell:
        nu (2 sym grad u, grad v) + gamma graddiv + advect ((grad u) wind, v)

        With wind_loc = u_loc this is the nonlinear velocity residual whose
        jvp is the Newton (0,0) block; with frozen wind it is the Oseen/
        grad-div operator of the graddiv harness
        (/root/reference/examples/graddiv/graddiv.py:80-83).
        """
        nu, gamma = params["nu"], params["gamma"]
        advect = params.get("advect", 0.0)
        tv = self.tab_v
        wdet = tv.w * detj  # (nq,)
        u_q, gu = self._vel_fields(u_loc, jinv)
        gtest = self._vel_testgrad(jinv)  # (nq, l, d)

        S = gu + jnp.swapaxes(gu, -1, -2)
        rv = nu * jnp.einsum("q,qij,qlj->li", wdet, S, gtest)
        divu = jnp.trace(gu, axis1=-2, axis2=-1)  # (nq,)
        int_div_test = jnp.einsum("q,qld->ld", wdet, gtest)
        if self.graddiv_mode == "cell_avg":
            int_divu = jnp.einsum("q,q->", wdet, divu)
            rv = rv + gamma * (int_divu / vol) * int_div_test
        else:
            rv = rv + gamma * jnp.einsum("q,q,qld->ld", wdet, divu, gtest)
        w_q = jnp.einsum("ql,ld->qd", tv.phi, wind_loc)
        conv = jnp.einsum("qij,qj->qi", gu, w_q)
        rv = rv + advect * jnp.einsum("q,qi,ql->li", wdet, conv, tv.phi)
        return rv

    def cell_residual(self, u_loc, p_loc, jinv, detj, vol, xq, params):
        """Full mixed residual on one cell -> (rv (nloc_v, d), rq (nloc_q,)).

        xq: (nq, d) physical quadrature points (any placeholder if rhs is
        None)."""
        tv, tq = self.tab_v, self.tab_q
        wdet = tv.w * detj
        rv = self.cell_velocity_residual(u_loc, u_loc, jinv, detj, vol,
                                         params)
        _, gu = self._vel_fields(u_loc, jinv)
        gtest = self._vel_testgrad(jinv)
        divu = jnp.trace(gu, axis1=-2, axis2=-1)
        p_q = jnp.einsum("ql,l->q", tq.phi, p_loc)
        # -(p, div v)
        rv = rv - jnp.einsum("q,q,qld->ld", wdet, p_q, gtest)
        # -(div u, q)
        rq = -jnp.einsum("q,q,ql->l", wdet, divu, tq.phi)
        if self.rhs is not None:
            f_v, f_q = self.rhs(xq, params)
            rv = rv - jnp.einsum("q,qd,ql->ld", wdet, f_v, tv.phi)
            rq = rq - jnp.einsum("q,q,ql->l", wdet, f_q, tq.phi)
        return rv, rq

    # ------------------------------------------------------------------
    # global assembly
    # ------------------------------------------------------------------
    def _geom_args(self):
        g = self.geom
        return g.jinv, g.detj, g.vol

    def _quad_x(self):
        if self.rhs is None:
            # placeholder; kernel ignores it
            return jnp.zeros((1, self.tab_v.nq, self.dim), dtype=real_dtype)
        return self.geom.quad_points_physical(self.tab_v.ref_pts)

    def residual(self, z, params):
        """Assembled residual pytree (Rv (ndofV, d), Rq (ndofQ,)).

        No boundary conditions applied here (the solver masks rows)."""
        u, p = z
        jinv, detj, vol = self._geom_args()
        xq = self._quad_x()
        if self.rhs is None:
            xq = jnp.broadcast_to(xq, (jinv.shape[0],) + xq.shape[1:])
        u_loc = u[self.cd_v]
        p_loc = p[self.cd_q]
        rv, rq = _map_cell_chunks(
            jax.vmap(
                lambda ul, pl, ji, dj, vo, x: self.cell_residual(
                    ul, pl, ji, dj, vo, x, params
                )
            ),
            u_loc, p_loc, jinv, detj, vol, xq,
            chunk=self._cell_chunk())
        if self._sum_v is not None:
            Rv = self._sum_v(rv)
            Rq = self._sum_q(rq)
        else:
            Rv = jnp.zeros_like(u).at[self.cd_v].add(rv)
            Rq = jnp.zeros_like(p).at[self.cd_q].add(rq)
        if self.stabilisation is not None:
            Sv, Sq = self.stabilisation(z, params)
            Rv = Rv + Sv
            Rq = Rq + Sq
        return (Rv, Rq)

    def velocity_residual(self, u, params, wind=None):
        """Global velocity-block residual (wind=None -> wind=u)."""
        jinv, detj, vol = self._geom_args()
        u_loc = u[self.cd_v]
        w_loc = u_loc if wind is None else wind[self.cd_v]
        rv = _map_cell_chunks(
            jax.vmap(
                lambda ul, wl, ji, dj, vo: self.cell_velocity_residual(
                    ul, wl, ji, dj, vo, params
                )
            ),
            u_loc, w_loc, jinv, detj, vol, chunk=self._cell_chunk())
        if self._sum_v is not None:
            return self._sum_v(rv)
        return jnp.zeros_like(u).at[self.cd_v].add(rv)

    # ------------------------------------------------------------------
    # element tensors (for patches / coarse grids)
    # ------------------------------------------------------------------
    def _static_velocity_tensors(self):
        """Geometry-only parts of the velocity Jacobian: (K viscous,
        G grad-div) as (nc, nl*d, nl*d).  Recomputed in-trace per call —
        a few cheap einsums; embedding them as jit constants (~tens of
        MB) was observed to blow up XLA compile times."""
        jinv, detj, vol = self._geom_args()
        tv = self.tab_v
        nl, d = tv.nloc, self.dim
        def one(ji, dj):
            wdet = tv.w[None, :] * dj[:, None]
            g = jnp.einsum("qle,cej->cqlj", tv.gphi, ji)  # phys grads
            return self._flat_viscous_K(wdet, g)

        K = _map_cell_chunks(one, jinv, detj, chunk=self._cell_chunk())
        Bt = self.graddiv_factors()
        G = jnp.einsum("cip,cjp->cij", Bt, Bt)
        return K, G

    def _cell_chunk(self):
        """Chunk size for _map_cell_chunks: ~256 MB of quadrature-
        materialised per-cell temps (g is nq x nld x dim doubles per
        cell).  2D rules are small so ordinary meshes stay unchunked;
        3D [P2+FB]^3 (nq = 125) chunks at ~6k cells.  Override with
        ALFI_TPU_ETENSOR_CHUNK."""
        import os

        env = os.environ.get("ALFI_TPU_ETENSOR_CHUNK")
        if env:
            return int(env)
        tv = self.tab_v
        per_cell = tv.w.shape[0] * tv.nloc * self.dim * 8
        # 64 MB nominal: XLA's pipelining/remat of the map body holds
        # several copies (an 8x buffer was measured at ldc3d nref=2),
        # so the nominal budget must leave that headroom
        return max(1024, (64 << 20) // per_cell)

    def _flat_dof_maps(self):
        """(l_of, c_of) for flat velocity dofs a = l*d + component."""
        a_idx = jnp.arange(self.tab_v.nloc * self.dim)
        return a_idx // self.dim, a_idx % self.dim

    def _flat_viscous_K(self, wdet, g):
        """Viscous element tensor 2 (sym grad u, sym grad v) built
        DIRECTLY in the flat (c, nl*d, nl*d) form:
        K[(l,i),(m,j)] = delta_ij int g_l . g_m + int g_m[i] g_l[j].

        The naive "...->climj" einsums materialise 6-D (c,nl,d,nl,d)
        temps (a 13.5 GB allocation at ldc3d nref=2 shapes).
        Instead: one batched GEMM over quadrature with FLAT basis
        indices, then a static index-gather for the component
        permutation — bit-identical output (gate:
        tests/test_assembly.py)."""
        nl, d = self.tab_v.nloc, self.dim
        gg = jnp.einsum("cq,cqla,cqma->clm", wdet, g, g)
        l_of, c_of = self._flat_dof_maps()
        K1 = (gg[:, l_of[:, None], l_of[None, :]]
              * (c_of[:, None] == c_of[None, :]))
        gf = g.reshape(g.shape[0], g.shape[1], nl * d)  # (c, q, (l,j))
        # T2'[c,(l,j),(m,i)] = sum_q wdet g[c,q,l,j] g[c,q,m,i]
        T2p = jnp.einsum("cq,cqa,cqb->cab", wdet, gf, gf)
        # K2[(l,i),(m,j)] = int g_m[i] g_l[j] = T2'[(l,j),(m,i)]
        IA = l_of[:, None] * d + c_of[None, :]
        IB = l_of[None, :] * d + c_of[:, None]
        return K1 + T2p[:, IA, IB]

    def velocity_element_tensors(self, params, wind):
        """(nc, nloc_v*d, nloc_v*d) Newton Jacobian of the velocity block
        at the given wind, flattened with local index l*d + component:

            nu K + gamma G + advect N(wind),

        with static K (viscous), G (grad-div) and the advection
        linearisation N[(l,i),(m,j)] =
            delta_ij (phi_l, grad phi_m . w) + (phi_l, d_j w_i phi_m)
        (the jvp of (grad u) u at w: (grad du) w + (grad w) du)."""
        K, G = self._static_velocity_tensors()
        jinv, detj, _ = self._geom_args()
        w_loc = wind[self.cd_v]
        return self._tensors_from_parts(params, K, G, w_loc, jinv, detj)

    def velocity_element_tensors_from(self, params, w_loc, jinv, detj,
                                      Bt):
        """Same closed-form tensors from EXPLICIT per-cell batches (the
        block-local entry point of the shard_map-distributed solver:
        each device passes its own cells' wind / geometry / grad-div
        factors, no global arrays)."""
        tv = self.tab_v

        def one(ji, dj):
            wdet = tv.w[None, :] * dj[:, None]
            g = jnp.einsum("qle,cej->cqlj", tv.gphi, ji)
            return self._flat_viscous_K(wdet, g)

        K = _map_cell_chunks(one, jinv, detj, chunk=self._cell_chunk())
        G = jnp.einsum("cip,cjp->cij", Bt, Bt)
        return self._tensors_from_parts(params, K, G, w_loc, jinv, detj)

    def _advection_tensors_from(self, w_loc, jinv, detj):
        """Advection linearisation N(wind) as (nc, nl*d, nl*d):
        N[(l,i),(m,j)] = delta_ij (phi_l, grad phi_m . w)
                       + (phi_l, d_j w_i phi_m)."""
        tv = self.tab_v

        def one(wl, ji, dj):
            wdet = tv.w[None, :] * dj[:, None]
            g = jnp.einsum("qle,cej->cqlj", tv.gphi, ji)
            w_q = jnp.einsum("ql,cld->cqd", tv.phi, wl)
            gw = jnp.einsum("cqlj,cli->cqij", g, wl)  # grad w at q
            adv1 = jnp.einsum("cq,ql,cqmd,cqd->clm", wdet, tv.phi, g,
                              w_q)
            # flat-form build (see _flat_viscous_K for why the 6-D
            # "...->climj" route is avoided): delta_ij kron
            # via gather, the gw part as a sum of per-quadrature
            # Kronecker terms mass_q (x) gw_q — phi couples only
            # (l, m) and gw only (i, j), so each q term is two
            # (c, nl*d, nl*d) gathers
            l_of, c_of = self._flat_dof_maps()
            N = (adv1[:, l_of[:, None], l_of[None, :]]
                 * (c_of[:, None] == c_of[None, :]))
            PHI2 = tv.phi[:, l_of[:, None]] * tv.phi[:, l_of[None, :]]
            for q in range(tv.w.shape[0]):
                Gq = gw[:, q, c_of[:, None], c_of[None, :]]
                N = N + (wdet[:, q, None, None] * PHI2[q][None]) * Gq
            return N

        return _map_cell_chunks(one, w_loc, jinv, detj,
                                chunk=self._cell_chunk())

    def advection_element_tensors(self, wind):
        """N(wind) alone — the only wind-dependent Jacobian part (used by
        the split patch-matrix path, mg/patches.py
        make_patch_factor_parts)."""
        jinv, detj, _ = self._geom_args()
        return self._advection_tensors_from(wind[self.cd_v], jinv, detj)

    def _tensors_from_parts(self, params, K, G, w_loc, jinv, detj):
        nu, gamma = params["nu"], params["gamma"]
        advect = params.get("advect", 0.0)
        N = self._advection_tensors_from(w_loc, jinv, detj)
        return nu * K + gamma * G + advect * N

    def velocity_element_tensors_ad(self, params, wind):
        """jacfwd reference implementation (used to validate the closed
        form above)."""
        jinv, detj, vol = self._geom_args()
        w_loc = wind[self.cd_v]
        nl, d = self.tab_v.nloc, self.dim

        def cell_jac(wl, ji, dj, vo):
            def r(ul):
                return self.cell_velocity_residual(ul, ul, ji, dj, vo,
                                                   params)

            J = jax.jacfwd(r)(wl)  # (nl, d, nl, d)
            return J.reshape(nl * d, nl * d)

        return jax.vmap(cell_jac)(w_loc, jinv, detj, vol)

    def mixed_element_tensors(self, z, params):
        """Per-cell Jacobian blocks of the full mixed residual at state z.

        Returns (Juu, Jup, Jpu, Jpp) with shapes
        (nc, nlv*d, nlv*d), (nc, nlv*d, nlq), (nc, nlq, nlv*d), (nc, nlq, nlq).
        """
        u, p = z
        jinv, detj, vol = self._geom_args()
        xq = self._quad_x()
        if self.rhs is None:
            xq = jnp.broadcast_to(xq, (jinv.shape[0],) + xq.shape[1:])
        u_loc = u[self.cd_v]
        p_loc = p[self.cd_q]
        nlv, d, nlq = self.tab_v.nloc, self.dim, self.tab_q.nloc

        def cell_jac(ul, pl, ji, dj, vo, x):
            Ju = jax.jacfwd(
                lambda uu: self.cell_residual(uu, pl, ji, dj, vo, x, params)
            )(ul)
            Jp = jax.jacfwd(
                lambda pp: self.cell_residual(ul, pp, ji, dj, vo, x, params)
            )(pl)
            Juu = Ju[0].reshape(nlv * d, nlv * d)
            Jpu = Ju[1].reshape(nlq, nlv * d)
            Jup = Jp[0].reshape(nlv * d, nlq)
            Jpp = Jp[1].reshape(nlq, nlq)
            return Juu, Jup, Jpu, Jpp

        return jax.vmap(cell_jac)(u_loc, p_loc, jinv, detj, vol, xq)

    # ------------------------------------------------------------------
    # gamma-split structure: per-cell factors of the grad-div term
    # ------------------------------------------------------------------
    def graddiv_factors(self):
        """Static per-cell low-rank factors Bt (nc, nloc_v*d, q) with

            G_cell = Bt @ Bt.T  =  unit-gamma grad-div element matrix.

        cell_avg mode: q = 1 (one rank-1 term per cell); exact mode:
        q = #points of a minimal degree-2(k-1) rule.  This is the key to
        f32-stable patch/coarse solves (ALFI_TPU_WOODBURY): A = M + gamma Bt Bt^T is
        factorised by Woodbury with gamma entering only as 1/gamma, so
        the factorisation conditioning is INDEPENDENT of gamma (the
        direct LU of A is singular to f32 at the default gamma=1e4)."""
        if getattr(self, "_gd_factors", None) is not None:
            return self._gd_factors
        d = self.dim
        nl = self.tab_v.nloc
        # always concrete, even when first called inside a jit trace
        # (the cache must never hold tracers)
        with jax.ensure_compile_time_eval():
            jinv, detj, vol = self._geom_args()
            if self.graddiv_mode == "cell_avg":
                tv = self.tab_v
                wdet = tv.w[None, :] * detj[:, None]
                gtest = jnp.einsum("qle,cej->cqlj", tv.gphi, jinv)
                g = jnp.einsum("cq,cqld->cld", wdet, gtest)
                B = (g / jnp.sqrt(vol)[:, None, None]).reshape(
                    -1, nl * d, 1)
            else:
                deg = max(2 * (self.V.element.degree - 1), 0)
                pts, wts = simplex_quadrature(d, deg)
                gphi = jnp.asarray(self.V.element.tabulate_grad(pts),
                                   dtype=real_dtype)
                w = jnp.asarray(wts, dtype=real_dtype)
                gtest = jnp.einsum("qle,cej->cqlj", gphi, jinv)
                # div of basis (l, i) at point q is gtest[q, l, i]
                sq = jnp.sqrt(w[None, :] * detj[:, None])  # (nc, nq)
                B = jnp.einsum("cqld,cq->cldq", gtest, sq).reshape(
                    -1, nl * d, len(wts))
        self._gd_factors = B
        return B

    # ------------------------------------------------------------------
    # off-diagonal blocks (for the Schur fieldsplit preconditioner,
    # /root/reference/alfi/solver.py:405-421)
    # ------------------------------------------------------------------
    def apply_pressure_gradient(self, p):
        """B^T p : velocity rows of the -(p, div v) coupling."""
        tv, tq = self.tab_v, self.tab_q
        jinv, detj, _ = self._geom_args()
        p_q = jnp.einsum("ql,cl->cq", tq.phi, p[self.cd_q])
        gtest = jnp.einsum("qle,cej->cqlj", tv.gphi, jinv)
        wdet = tv.w[None, :] * detj[:, None]
        rv = -jnp.einsum("cq,cq,cqld->cld", wdet, p_q, gtest)
        if self._sum_v is not None:
            return self._sum_v(rv)
        u = jnp.zeros((self.V.ndof, self.dim), dtype=rv.dtype)
        return u.at[self.cd_v].add(rv)

    def apply_divergence(self, u):
        """B u : pressure rows of the -(div u, q) coupling."""
        tv, tq = self.tab_v, self.tab_q
        jinv, detj, _ = self._geom_args()
        gu = jnp.einsum("qle,cej,cli->cqij", tv.gphi, jinv, u[self.cd_v])
        divu = jnp.einsum("cqii->cq", gu)
        wdet = tv.w[None, :] * detj[:, None]
        rq = -jnp.einsum("cq,cq,ql->cl", wdet, divu, tq.phi)
        if self._sum_q is not None:
            return self._sum_q(rq)
        p = jnp.zeros((self.Q.ndof,), dtype=rq.dtype)
        return p.at[self.cd_q].add(rq)

    def apply_pressure_massinv(self, minv, r):
        """Mp^{-1} r for a DG pressure space (dofs uniquely cell-owned),
        given per-cell inverse mass matrices ``minv`` (nc, nlq, nlq)."""
        r_loc = r[self.cd_q]
        out = jnp.einsum("clm,cm->cl", minv, r_loc)
        if self._sum_q is not None:
            return self._sum_q(out)
        return jnp.zeros_like(r).at[self.cd_q].add(out)

    # ------------------------------------------------------------------
    # auxiliary quantities
    # ------------------------------------------------------------------
    def pressure_mass_inverse(self):
        """Per-cell inverse DG mass matrices (nc, nloc_q, nloc_q).

        Closed-form replacement for the reference's DGMassInv PC
        (/root/reference/alfi/solver.py:15-38).  P0 is a scalar
        reciprocal; higher DG orders invert the small cell blocks."""
        tq = self.tab_q
        M = jnp.einsum(
            "q,c,ql,qm->clm", tq.w, self.geom.detj, tq.phi, tq.phi
        )
        if tq.nloc == 1:
            return 1.0 / M
        return jnp.linalg.inv(M)

    def pressure_integral(self, p):
        tq = self.tab_q
        p_q = jnp.einsum("ql,cl->cq", tq.phi, p[self.cd_q])
        return jnp.einsum("q,c,cq->", tq.w, self.geom.detj, p_q)

    def area(self):
        return self.geom.vol.sum()

    def velocity_norms(self, u):
        """(L2 norm, H1 seminorm) of a velocity field."""
        tv = self.tab_v
        u_loc = u[self.cd_v]
        u_q = jnp.einsum("ql,cld->cqd", tv.phi, u_loc)
        gu = jnp.einsum("qle,cej,cli->cqij", tv.gphi, self.geom.jinv, u_loc)
        wdet = tv.w[None, :] * self.geom.detj[:, None]
        l2 = jnp.sqrt(jnp.einsum("cq,cqd,cqd->", wdet, u_q, u_q))
        h1 = jnp.sqrt(jnp.einsum("cq,cqij,cqij->", wdet, gu, gu))
        return l2, h1

    def divergence_norm(self, u):
        tv = self.tab_v
        gu = jnp.einsum(
            "qle,cej,cli->cqij", tv.gphi, self.geom.jinv, u[self.cd_v]
        )
        divu = jnp.einsum("cqii->cq", gu)
        wdet = tv.w[None, :] * self.geom.detj[:, None]
        return jnp.sqrt(jnp.einsum("cq,cq,cq->", wdet, divu, divu))

    def pressure_norm(self, p):
        tq = self.tab_q
        p_q = jnp.einsum("ql,cl->cq", tq.phi, p[self.cd_q])
        wdet = tq.w[None, :] * self.geom.detj[:, None]
        return jnp.sqrt(jnp.einsum("cq,cq,cq->", wdet, p_q, p_q))
