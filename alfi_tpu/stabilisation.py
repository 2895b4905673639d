"""Advection stabilisation: SUPG / GLS (Pk-P0) and Burman edge
stabilisation (Scott-Vogelius).

Re-design of /root/reference/alfi/stabilisation.py + its wiring in
/root/reference/alfi/solver.py:202-237.  Semantics preserved exactly:

* the stabilisation COEFFICIENT beta, the strong residual Lu AND the
  SUPG test direction (grad v) w use the LIVE state u (the reference
  constructs SUPG with state=u, so self.wind IS u -> differentiable,
  enters the Newton Jacobian via jvp),
* only GLS's Lv advection uses the FROZEN wind = velocity of the
  previous Reynolds solution (z_last, /root/reference/alfi/solver.py:205,216),
  passed in through params["wind"],
* the whole term is multiplied by ``advect`` (vanishes for Stokes),
* Shakib-Hughes-Zohan coefficient
  beta = ((4 |u|^2 / h^2) + magic (4 nu / h^2)^2)^{-1/2}, default weight
  1.0 (2D) / 0.1 (3D), magic 9.0 at the solver level,
* Burman: 0.5 * w * h_F^2 * avg|u| * (jump(grad u . n), jump(grad v . n))
  over interior facets, default weight 3e-3.

The residual hook returns a FULL (Rv, Rq) contribution (GLS touches
pressure rows through grad q).
"""

from __future__ import annotations

import jax.numpy as jnp

from .config import real_dtype
from .fem.facets import InteriorFacets
from .fem.nsforms import Tabulation


class ShakibSUPG:
    """SUPG / GLS with the Shakib-Hughes-Zohan coefficient
    (/root/reference/alfi/stabilisation.py:73-97)."""

    def __init__(self, form, mode, magic=9.0, weight=None):
        self.form = form
        self.mode = mode  # 'supg' | 'gls'
        self.magic = magic
        d = form.dim
        self.weight = weight if weight is not None else (
            0.1 if d == 3 else 1.0)
        tv, tq = form.tab_v, form.tab_q
        # REFERENCE-element hessians / pressure gradients only: the
        # per-cell physical versions (H_phys = Jinv^T H_ref Jinv on
        # affine cells) are contracted IN-TRACE inside the kernels.
        # Materialising them eagerly baked an (nc, nq, nl, d, d)
        # constant into every lowered module — 387 MB of f64 for the
        # 3072-cell ldc3d north star, which blew the remote-compile
        # payload limit (HTTP 413) and would be ~3 GB at nref=2.
        self.href = jnp.asarray(
            form.V.element.tabulate_hess(tv.ref_pts), dtype=real_dtype)
        self.gq_ref = tq.gphi  # (nq, nlq, d)
        self.h = form.geom.h  # CellSize

    # ------------------------------------------------------------------
    # batched per-cell kernels (shared by the global assembly path and
    # the shard_map-distributed block-local path — per-cell results are
    # independent of the batch, so the two paths agree to roundoff)
    # ------------------------------------------------------------------
    def aux_global(self, params):
        """Global auxiliary scalar entering the coefficient (0.0 for
        Shakib; Turek overrides with the domain-averaged frozen-wind
        speed)."""
        return 0.0

    def aux_partial(self, w_loc, detj, owned):
        """Block-local partial sum for ``aux`` (the distributed path
        psums this over the device mesh and divides by the domain
        measure).  None = no reduction needed (Shakib)."""
        return None

    def _beta_batch(self, u_q, h, wdet, params, aux):
        nu = params["nu"]
        h2 = (h ** 2)[:, None]
        w2 = jnp.einsum("cqd,cqd->cq", u_q, u_q)
        return (4.0 * w2 / h2
                + self.magic * (4.0 * nu / h2) ** 2) ** (-0.5)

    def residual_local(self, u_loc, p_loc, w_loc, jinv, detj,
                       h, xq, params, aux):
        """Per-cell stabilisation residual from explicit per-cell
        batches: (rv_loc (nc, nl, d), rq_loc (nc, nlq) | None), NOT
        advect-scaled.  The global :meth:`residual` gathers and calls
        this; the distributed solver calls it on each block's owned
        cells with localized geometry.  Physical hessians / pressure
        gradients are contracted here from the shared reference
        tabulations — contract the basis index l FIRST so the
        (nc, nq, nl, d, d) physical-hessian batch never materialises."""
        form = self.form
        tv = form.tab_v
        href, gq_ref = self.href, self.gq_ref
        nu, advect = params["nu"], params["advect"]
        u_q = jnp.einsum("ql,cld->cqd", tv.phi, u_loc)
        gu = jnp.einsum("qle,cej,cli->cqij", tv.gphi, jinv, u_loc)
        # Hu[c,q,i,a,b] = sum_l H_phys[c,q,l,a,b] u_loc[c,l,i]
        Hu_ref = jnp.einsum("qlde,cli->cqide", href, u_loc)
        Hu = jnp.einsum("cqide,cda,ceb->cqiab", Hu_ref, jinv, jinv)
        # div(2 sym grad u)_i = lap u_i + d_i div u
        visc = jnp.einsum("cqiaa->cqi", Hu) + jnp.einsum("cqaia->cqi", Hu)
        gp = jnp.einsum("qle,cej,cl->cqj", gq_ref, jinv, p_loc)
        Lu = -nu * visc + advect * jnp.einsum(
            "cqij,cqj->cqi", gu, u_q) + gp
        if form.rhs is not None:
            f_v, _ = form.rhs(xq.reshape(-1, form.dim), params)
            Lu = Lu - f_v.reshape(Lu.shape)
        wdet = tv.w[None, :] * detj[:, None]
        beta = self._beta_batch(u_q, h, wdet, params, aux)
        coef = self.weight * wdet * beta  # (nc, nq)
        gtest = jnp.einsum("qle,cej->cqlj", tv.gphi, jinv)
        # SUPG test direction (grad v) w uses the LIVE state (the
        # reference's SUPG.form has w = self.wind = u, state=u at
        # /root/reference/alfi/solver.py:208-211)
        adv_test = jnp.einsum("cqlj,cqj->cql", gtest, u_q)
        rv_loc = jnp.einsum("cq,cqi,cql->cli", coef, Lu, adv_test)
        rq_loc = None
        if self.mode == "gls":
            # GLS's Lv advects the test function with the FROZEN wind
            # (z_last, /root/reference/alfi/solver.py:205,216)
            w_q = jnp.einsum("ql,cld->cqd", tv.phi, w_loc)
            adv_test = jnp.einsum("cqlj,cqj->cql", gtest, w_q)
            # Lv for v = phi_l e_i:
            #   (div 2 sym grad v)_j = delta_ij lap phi_l + d_i d_j phi_l
            #   ((grad v) w)_j       = delta_ij (grad phi_l . w)
            # so inner(Lu, Lv) for test (l, i) =
            #   Lu_i (-nu lap phi_l + grad phi_l . w)
            #   + sum_j Lu_j (-nu H[l, i, j])
            K = jnp.einsum("cda,cea->cde", jinv, jinv)
            lap = jnp.einsum("qlde,cde->cql", href, K)
            # sum_j Lu_j H_phys[l,i,j]: fold (coef, Lu, jinv_j) to a
            # (c, q, e) factor first, then contract with href
            cLu = jnp.einsum("cq,cqj,cej->cqe", coef, Lu, jinv)
            hess_term = jnp.einsum("qlde,cqe,cdi->cli", href, cLu, jinv)
            rv_loc = jnp.einsum("cq,cqi,cql->cli", coef, Lu,
                                -nu * lap + adv_test) \
                + (-nu) * hess_term
            # pressure rows: inner(Lu, grad q)
            rq_loc = jnp.einsum("cq,cqj,qle,cej->cl", coef, Lu,
                                gq_ref, jinv)
        return rv_loc, rq_loc

    def residual(self, z, params):
        form = self.form
        tv = form.tab_v
        u, p = z
        u_loc = u[jnp.asarray(form.V.cell_dofs)]
        p_loc = p[jnp.asarray(form.Q.cell_dofs)]
        w_loc = (params["wind"][jnp.asarray(form.V.cell_dofs)]
                 if self.mode == "gls" else jnp.zeros_like(u_loc))
        if form.rhs is not None:
            xq = form.geom.quad_points_physical(tv.ref_pts)
        else:
            xq = jnp.zeros((u_loc.shape[0], tv.nq, form.dim),
                           dtype=u_loc.dtype)
        aux = self.aux_global(params)
        # sequential cell chunks (fem/nsforms._map_cell_chunks): the
        # quadrature-wide hessian batches here — and their jvp inside
        # the outer Jacobian apply — were multi-GB temps at ldc3d
        # nref=2 on-chip (round-5 OOM log)
        from .fem.nsforms import _map_cell_chunks

        gls = self.mode == "gls"

        def one(ul, pl, wl, ji, dj, hh, x):
            rv, rq = self.residual_local(ul, pl, wl, ji, dj, hh, x,
                                         params, aux)
            return (rv, rq) if gls else rv

        out = _map_cell_chunks(
            one, u_loc, p_loc, w_loc, form.geom.jinv, form.geom.detj,
            self.h, xq, chunk=form._cell_chunk())
        rv_loc, rq_loc = out if gls else (out, None)
        if form._sum_v is not None:
            Rv = form._sum_v(rv_loc)
            Rq = (form._sum_q(rq_loc) if rq_loc is not None
                  else jnp.zeros((form.Q.ndof,), dtype=Rv.dtype))
        else:
            Rv = jnp.zeros((form.V.ndof, form.dim), dtype=rv_loc.dtype)
            Rv = Rv.at[jnp.asarray(form.V.cell_dofs)].add(rv_loc)
            Rq = jnp.zeros((form.Q.ndof,), dtype=Rv.dtype)
            if rq_loc is not None:
                Rq = Rq.at[jnp.asarray(form.Q.cell_dofs)].add(rq_loc)
        return Rv, Rq


    # ------------------------------------------------------------------
    # velocity-block element Jacobians (for the MG preconditioner)
    # ------------------------------------------------------------------
    def _beta_cell(self, u_q, hc, params, aux):
        """Per-cell stabilisation coefficient, (nq,) from u_q (nq, d)."""
        nu = params["nu"]
        h2 = hc ** 2
        w2 = jnp.einsum("qd,qd->q", u_q, u_q)
        return (4.0 * w2 / h2
                + self.magic * (4.0 * nu / h2) ** 2) ** (-0.5)

    def velocity_element_tensors(self, z, params):
        """(nc, nl*d, nl*d) per-cell velocity-block Jacobian of the
        stabilisation residual at state z — NOT advect-scaled (the
        caller multiplies by ``advect``, like the residual hook).

        The reference's PCPatch/PCMG operators are assembled from the
        full stabilised Jacobian (the form includes advect*stab,
        /root/reference/alfi/solver.py:204-237), so the MG level
        operators and patch matrices here must carry the same terms —
        without them the preconditioner drifts from the true Jacobian
        as Re grows and the outer Krylov counts climb.  Derived by
        jacfwd of a per-cell residual kernel mirroring
        :meth:`residual`."""
        form = self.form
        u, p = z
        tv = form.tab_v
        u_loc = u[form.cd_v]  # (nc, nl, d)
        p_loc = p[form.cd_q]
        geom = form.geom
        wind_loc = (params["wind"][form.cd_v] if self.mode == "gls"
                    else jnp.zeros_like(u_loc))
        aux = self.aux_global(params)
        if form.rhs is not None:
            xq = geom.quad_points_physical(tv.ref_pts)  # (nc, nq, d)
        else:
            nc = u_loc.shape[0]
            xq = jnp.zeros((nc, tv.nq, form.dim), dtype=u_loc.dtype)
        return self.velocity_element_tensors_from(
            params, u_loc, p_loc, wind_loc, geom.jinv, geom.detj,
            self.h, xq, aux)

    def velocity_element_tensors_from(self, params, u_loc, p_loc,
                                      wind_loc, jinv, detj, h,
                                      xq, aux):
        """Same per-cell Jacobians from EXPLICIT per-cell batches (the
        block-local entry point of the shard_map-distributed solver:
        each device passes its own cells' state / geometry / basis
        hessians, no global arrays).

        SUPG with the Shakib coefficient (the production 3D path) uses
        the hand-derived product-rule Jacobian in
        :meth:`_vet_supg_analytic`: jacfwd's 42-wide tangent batch
        through this kernel materialises O(nc*nt*nq) intermediates
        (1.8-22 GB at the ldc3d [P2+FB]^3 shapes), while the analytic form keeps
        every intermediate at O(nc*nq*nl) with q-contracted matmuls.
        GLS and Turek-coefficient variants keep the jacfwd derivation
        (their test coverage is small-mesh)."""
        if self.mode == "supg" and type(self) is ShakibSUPG:
            return self._vet_supg_analytic(params, u_loc, p_loc, jinv,
                                           detj, h, xq, aux)
        return self._vet_jacfwd(params, u_loc, p_loc, wind_loc, jinv,
                                detj, h, xq, aux)

    def _vet_supg_analytic(self, params, u_loc, p_loc, jinv, detj, h,
                           xq, aux, chunk=None):
        """Analytic per-cell SUPG velocity-block Jacobian.

        rv[l,i] = sum_q coef(q) Lu[q,i] at[q,l] with
          coef = weight * w_q * detj * beta(u),
          Lu   = -nu*(lap u + grad div u) + advect*(grad u) u + grad p
                 (- f),
          at   = (grad phi_l) . u_q.
        Product rule in ul[m,n] gives five terms (A: dcoef, B1/B3:
        delta_in viscous+advective parts, B2: basis-hessian part, B4:
        dgu part, C: dat part); each is a q-contraction of small
        per-cell factors — href only ever enters matmul-style products
        over (l,e)/(d,e)/(q,.), never broadcast against the cell batch.
        Cells are processed in static chunks to bound the peak
        (c, q, d, l)-sized intermediates."""
        import os

        import jax
        from jax import lax

        if chunk is None:
            env = os.environ.get("ALFI_TPU_SUPG_CHUNK")
            if env:
                chunk = int(env)
            else:
                # ~24 MB of (chunk, nq, nl, d) working set per chunk:
                # a fixed 2048 is too large a working set at ldc3d
                # nref=2 shapes (nq = 125; chunk = 512 passes); 2D
                # rules keep 2048
                tvv = self.form.tab_v
                per = tvv.w.shape[0] * tvv.nloc * self.form.dim * 8
                chunk = min(2048, max(256, (24 << 20) // per))
        form = self.form
        tv = form.tab_v
        nu, advect = params["nu"], params["advect"]
        phi, gphi, wq = tv.phi, tv.gphi, tv.w
        href, gq_ref = self.href, self.gq_ref
        weight, magic = self.weight, self.magic
        nc = u_loc.shape[0]
        nl = u_loc.shape[1]
        d = form.dim

        def chunk_J(args):
            ul, pl, ji, dj, hc, xqc = args
            u_q = jnp.einsum("ql,cld->cqd", phi, ul)
            g = jnp.einsum("qle,cej->cqlj", gphi, ji)
            at = jnp.einsum("cqlj,cqj->cql", g, u_q)
            gu = jnp.einsum("cqlj,cli->cqij", g, ul)
            K = jnp.einsum("cda,cea->cde", ji, ji)
            lap = jnp.einsum("qlde,cde->cql", href, K)
            lap_u = jnp.einsum("cql,cli->cqi", lap, ul)
            v_le = jnp.einsum("cea,cla->cle", ji, ul)
            t_qd = jnp.einsum("qlde,cle->cqd", href, v_le)
            gdiv_u = jnp.einsum("cqd,cdi->cqi", t_qd, ji)
            visc = lap_u + gdiv_u
            gp = jnp.einsum("qle,cej,cl->cqj", gq_ref, ji, pl)
            Lu = (-nu * visc
                  + advect * jnp.einsum("cqij,cqj->cqi", gu, u_q) + gp)
            if form.rhs is not None:
                f_v, _ = form.rhs(xqc.reshape(-1, d), params)
                Lu = Lu - f_v.reshape(Lu.shape)
            wdet = wq[None, :] * dj[:, None]
            h2 = (hc ** 2)[:, None]
            w2 = jnp.einsum("cqd,cqd->cq", u_q, u_q)
            beta = (4.0 * w2 / h2
                    + magic * (4.0 * nu / h2) ** 2) ** (-0.5)
            coef = weight * wdet * beta  # (c, q)
            # dcoef[q,(m,n)] = s[q] u_q[q,n] phi[q,m],
            # s = -4 coef beta^2 / h^2   (d beta = -4 beta^3 u_n/h^2)
            s = -4.0 * coef * beta ** 2 / h2

            # A: dcoef term
            T = jnp.einsum("cq,cqi,cql->cqil", s, Lu, at)
            S = jnp.einsum("cqn,qm->cqnm", u_q, phi)
            J = jnp.einsum("cqil,cqnm->climn", T, S)
            # B1+B3: delta_in (viscous-laplacian + advective) parts
            W = coef[:, :, None] * (-nu * lap + advect * at)
            D = jnp.einsum("cqm,cql->clm", W, at)
            J = J + D[:, :, None, :, None] * jnp.eye(
                d, dtype=J.dtype)[None, None, :, None, :]
            # B2: basis-hessian part -nu sum_q coef H_phys[q,m,i,n] at[q,l]
            Wc = coef[:, :, None] * at  # (c, q, l)
            X = jnp.einsum("qmde,cql->cmdel", href, Wc)
            J = J + (-nu) * jnp.einsum("cmdel,cdi,cen->climn",
                                       X, ji, ji)
            # B4: dgu part  advect sum_q coef gu[q,i,n] at[q,l] phi[q,m]
            G = advect * coef[:, :, None, None] * gu  # (c, q, i, n)
            T4 = jnp.einsum("cqin,cql->cqinl", G, at)
            J = J + jnp.einsum("cqinl,qm->climn", T4, phi)
            # C: dat part  sum_q coef Lu[q,i] g[q,l,n] phi[q,m]
            T5 = jnp.einsum("cq,cqi,cqln->cqiln", coef, Lu, g)
            J = J + jnp.einsum("cqiln,qm->climn", T5, phi)
            return J  # (c, l, i, m, n)

        if nc <= chunk:
            J = chunk_J((u_loc, p_loc, jinv, detj, h, xq))
        else:
            nch = -(-nc // chunk)
            npad = nch * chunk - nc

            def pad(a, fill=0.0):
                cfg = [(0, npad)] + [(0, 0)] * (a.ndim - 1)
                return jnp.pad(a, cfg, constant_values=fill)

            args = (pad(u_loc), pad(p_loc), pad(jinv), pad(detj),
                    pad(h, 1.0), pad(xq))
            args = jax.tree_util.tree_map(
                lambda a: a.reshape((nch, chunk) + a.shape[1:]), args)
            J = lax.map(chunk_J, args)
            J = J.reshape((nch * chunk,) + J.shape[2:])[:nc]
        return J.reshape(nc, nl * d, nl * d)

    def _vet_jacfwd(self, params, u_loc, p_loc, wind_loc, jinv, detj,
                    h, xq, aux):
        """jacfwd-derived per-cell Jacobians (GLS / Turek paths)."""
        import jax

        form = self.form
        tv = form.tab_v
        nu, advect = params["nu"], params["advect"]
        phi, gphi, wq = tv.phi, tv.gphi, tv.w
        href, gq_ref = self.href, self.gq_ref
        gls = self.mode == "gls"

        def cell_rv(ul, pl, wl, ji, dj, hc, xqc):
            u_q = jnp.einsum("ql,ld->qd", phi, ul)
            g = jnp.einsum("qle,ej->qlj", gphi, ji)
            gu = jnp.einsum("qlj,li->qij", g, ul)
            # div(2 sym grad u)_i = lap u_i + d_i(div u) from the
            # REFERENCE hessian tabulation.  Every contraction below
            # keeps href in matmul-style products over (l,e)/(d,e) —
            # under jacfwd's 42-wide tangent batch the naive
            # "qlde,li,da,eb->qiab" form makes XLA broadcast href over
            # (cells x tangents), a ~19 GB tiled intermediate that
            # OOM'd the ldc3d north-star compile; these staged forms
            # keep every tangent intermediate at (t, q, d)-size.
            K = jnp.einsum("da,ea->de", ji, ji)
            lap = jnp.einsum("qlde,de->ql", href, K)  # ul-independent
            lap_u = jnp.einsum("ql,li->qi", lap, ul)
            v_le = jnp.einsum("ea,la->le", ji, ul)
            t_qd = jnp.einsum("qlde,le->qd", href, v_le)
            graddiv_u = jnp.einsum("qd,di->qi", t_qd, ji)
            visc = lap_u + graddiv_u
            gp = jnp.einsum("qle,ej,l->qj", gq_ref, ji, pl)
            Lu = (-nu * visc
                  + advect * jnp.einsum("qij,qj->qi", gu, u_q) + gp)
            if form.rhs is not None:
                f_v, _ = form.rhs(xqc, params)
                Lu = Lu - f_v
            beta = self._beta_cell(u_q, hc, params, aux)
            coef = self.weight * (wq * dj) * beta  # (nq,)
            if gls:
                w_q = jnp.einsum("ql,ld->qd", phi, wl)
                adv_w = jnp.einsum("qlj,qj->ql", g, w_q)
                cLu = jnp.einsum("q,qj,ej->qe", coef, Lu, ji)
                A_ld = jnp.einsum("qlde,qe->ld", href, cLu)
                hess_term = jnp.einsum("ld,di->li", A_ld, ji)
                return (jnp.einsum("q,qi,ql->li", coef, Lu,
                                   -nu * lap + adv_w)
                        + (-nu) * hess_term)
            adv_test = jnp.einsum("qlj,qj->ql", g, u_q)
            return jnp.einsum("q,qi,ql->li", coef, Lu, adv_test)

        J = jax.vmap(jax.jacfwd(cell_rv, argnums=0))(
            u_loc, p_loc, wind_loc, jinv, detj, h, xq)
        nc, nl, d = J.shape[0], J.shape[1], J.shape[2]
        return J.reshape(nc, nl * d, nl * d)


class TurekSUPG(ShakibSUPG):
    """Turek's SUPG coefficient (/root/reference/alfi/stabilisation.py:100-136):
    Re_tau = cell_avg(|u|) h Re;  beta = magic h 2 Re_tau / (w_avg (1+Re_tau))
    with w_avg = (1/|Omega|) \\int |wind| dx (the FROZEN wind, updated per
    solve in the reference's update())."""

    def __init__(self, form, mode, char_LU=1.0, magic=1.0, weight=None):
        super().__init__(form, mode, magic=magic, weight=weight)
        self.char_LU = char_LU
        tv = form.tab_v
        self._wdet = tv.w[None, :] * form.geom.detj[:, None]
        self._domain_measure = float(form.area())

    def aux_global(self, params):
        """Global scalar w_avg from the FROZEN wind (not differentiated)."""
        form = self.form
        wind = params["wind"]
        w_loc = wind[jnp.asarray(form.V.cell_dofs)]
        w_qq = jnp.einsum("ql,cld->cqd", form.tab_v.phi, w_loc)
        return jnp.einsum(
            "cq,cq->", self._wdet,
            jnp.sqrt(jnp.einsum("cqd,cqd->cq", w_qq, w_qq))
        ) / self._domain_measure

    def aux_partial(self, w_loc, detj, owned):
        """Owned-cells partial of the w_avg NUMERATOR; the distributed
        caller psums over the mesh axis and divides by
        ``_domain_measure``."""
        tv = self.form.tab_v
        w_q = jnp.einsum("ql,cld->cqd", tv.phi, w_loc)
        wdet = tv.w[None, :] * detj[:, None]
        s = jnp.einsum("cq,cq->c", wdet,
                       jnp.sqrt(jnp.einsum("cqd,cqd->cq", w_q, w_q)))
        return jnp.sum(jnp.where(owned, s, 0.0))

    def _beta_batch(self, u_q, h, wdet, params, aux):
        nu = params["nu"]
        Re = self.char_LU / nu
        # cell average of |u| (live state); aux = frozen-wind w_avg
        unorm = jnp.sqrt(jnp.einsum("cqd,cqd->cq", u_q, u_q))
        cellavg = (jnp.einsum("cq,cq->c", wdet, unorm)
                   / (wdet.sum(axis=1) + 1e-300))
        re_tau = cellavg * h * Re
        beta = self.magic * h * 2.0 * re_tau / (aux * (1.0 + re_tau)
                                                + 1e-300)
        return beta[:, None] * jnp.ones_like(unorm)

    def _beta_cell(self, u_q, hc, params, aux):
        nu = params["nu"]
        Re = self.char_LU / nu
        tv = self.form.tab_v
        unorm = jnp.sqrt(jnp.einsum("qd,qd->q", u_q, u_q))
        # detj cancels between numerator and denominator (affine cells)
        cellavg = jnp.einsum("q,q->", tv.w, unorm) / tv.w.sum()
        re_tau = cellavg * hc * Re
        beta = (self.magic * hc * 2.0 * re_tau
                / (aux * (1.0 + re_tau) + 1e-300))
        return beta * jnp.ones_like(unorm)


class BurmanStabilisation:
    """Interior-penalty jump stabilisation
    (/root/reference/alfi/stabilisation.py:139-162)."""

    def __init__(self, form, weight=None):
        self.form = form
        self.weight = weight if weight is not None else 3e-3
        deg = 2 * form.V.element.degree
        self.facets = InteriorFacets(form.V, deg)
        from .utils.scatter import default_use_tables, make_gather_sum

        if default_use_tables():
            mesh = form.V.mesh
            fc = mesh.facet_cells[mesh.interior_facets]
            self._sum0 = make_gather_sum(form.V.cell_dofs[fc[:, 0]],
                                         form.V.ndof)
            self._sum1 = make_gather_sum(form.V.cell_dofs[fc[:, 1]],
                                         form.V.ndof)
        else:
            self._sum0 = self._sum1 = None

    def facet_statics(self):
        """Per-facet static arrays for the explicit-batch kernels: side
        tabulations, physical gradients, normals, the u-independent
        coefficient.  The distributed solver localizes these by facet
        id."""
        if getattr(self, "_fstat", None) is not None:
            return self._fstat
        import jax

        fa = self.facets
        # always concrete, even when first called inside a jit trace
        # (the cache must never hold tracers)
        with jax.ensure_compile_time_eval():
            jinv = self.form.geom.jinv
            c0, c1 = fa.cells[:, 0], fa.cells[:, 1]
            self._fstat = dict(
                t0=fa.tab[fa.config[:, 0]], t1=fa.tab[fa.config[:, 1]],
                g0=jnp.einsum("fqle,fej->fqlj",
                              fa.gtab[fa.config[:, 0]], jinv[c0]),
                g1=jnp.einsum("fqle,fej->fqlj",
                              fa.gtab[fa.config[:, 1]], jinv[c1]),
                n=fa.normal,
                coefc=0.5 * self.weight * fa.harea ** 2 * fa.scale,
            )
        return self._fstat

    def residual_pairs(self, u0_loc, u1_loc, st):
        """Per-facet residual pair (r0, r1) from explicit batches (the
        shared kernel of the global and block-local paths; per-facet
        results are independent of the batch)."""
        fa = self.facets
        t0, t1, g0, g1, n = st["t0"], st["t1"], st["g0"], st["g1"], \
            st["n"]
        u0 = jnp.einsum("fql,fld->fqd", t0, u0_loc)
        u1 = jnp.einsum("fql,fld->fqd", t1, u1_loc)
        gu0 = jnp.einsum("fqlj,fld->fqdj", g0, u0_loc)
        gu1 = jnp.einsum("fqlj,fld->fqdj", g1, u1_loc)
        jump = jnp.einsum("fqdj,fj->fqd", gu0 - gu1, n)
        # beta = facet average of sqrt(|u|^2 + 1e-10) (sides agree for
        # CG; average anyway like avg() does)
        wsum = fa.w.sum()
        sp0 = jnp.sqrt(jnp.einsum("fqd,fqd->fq", u0, u0) + 1e-10)
        sp1 = jnp.sqrt(jnp.einsum("fqd,fqd->fq", u1, u1) + 1e-10)
        beta = 0.5 * (jnp.einsum("q,fq->f", fa.w, sp0)
                      + jnp.einsum("q,fq->f", fa.w, sp1)) / wsum
        coef = st["coefc"] * beta  # (nif,)
        wq = fa.w
        tn0 = jnp.einsum("fqlj,fj->fql", g0, n)
        tn1 = jnp.einsum("fqlj,fj->fql", g1, n)
        r0 = jnp.einsum("f,q,fqd,fql->fld", coef, wq, jump, tn0)
        r1 = -jnp.einsum("f,q,fqd,fql->fld", coef, wq, jump, tn1)
        return r0, r1

    def residual(self, z, params):
        form = self.form
        fa = self.facets
        u = z[0]
        cd = jnp.asarray(form.V.cell_dofs)
        st = self.facet_statics()
        dofs0 = cd[fa.cells[:, 0]]
        dofs1 = cd[fa.cells[:, 1]]
        r0, r1 = self.residual_pairs(u[dofs0], u[dofs1], st)
        if self._sum0 is not None:
            Rv = self._sum0(r0) + self._sum1(r1)
        else:
            Rv = jnp.zeros((form.V.ndof, form.dim), dtype=u.dtype)
            Rv = Rv.at[dofs0].add(r0).at[dofs1].add(r1)
        Rq = jnp.zeros((form.Q.ndof,), dtype=u.dtype)
        return Rv, Rq

    def facet_velocity_tensors(self, u, params):
        """(nif, 2*nld, 2*nld) per-interior-facet velocity Jacobian of
        the Burman residual at state ``u`` — NOT advect-scaled; row/col
        blocks ordered [side-0 cell dofs, side-1 cell dofs], each in
        the (l*d + component) flattening of the level row maps.

        The reference assembles the FULL stabilised Jacobian into its
        PCMG/PCPatch operators (/root/reference/alfi/solver.py:204-237
        adds advect*stab to F; the mg operators are rediscretisations
        of derivative(F)), so the facet coupling belongs in the level
        operators and patch matrices.  beta uses the LIVE state
        (reference BurmanStabilisation gets state=u), so the
        linearisation includes d(beta)/du — jacfwd of a per-facet
        kernel mirroring :meth:`residual`."""
        form = self.form
        fa = self.facets
        cd = jnp.asarray(form.V.cell_dofs)
        st = self.facet_statics()
        u01 = jnp.stack([u[cd[fa.cells[:, 0]]],
                         u[cd[fa.cells[:, 1]]]], axis=1)  # (nif,2,nl,d)
        return self.facet_velocity_tensors_from(u01, st)

    def facet_velocity_tensors_from(self, u01, st):
        """Same per-facet Jacobians from EXPLICIT per-facet batches (the
        block-local entry point of the distributed solver)."""
        import jax

        w = self.facets.w
        wsum = w.sum()

        def kern(uu, t0f, g0f, t1f, g1f, n, cf):
            u0l, u1l = uu[0], uu[1]
            uq0 = jnp.einsum("ql,ld->qd", t0f, u0l)
            uq1 = jnp.einsum("ql,ld->qd", t1f, u1l)
            gu0 = jnp.einsum("qlj,ld->qdj", g0f, u0l)
            gu1 = jnp.einsum("qlj,ld->qdj", g1f, u1l)
            jump = jnp.einsum("qdj,j->qd", gu0 - gu1, n)
            sp0 = jnp.sqrt(jnp.einsum("qd,qd->q", uq0, uq0) + 1e-10)
            sp1 = jnp.sqrt(jnp.einsum("qd,qd->q", uq1, uq1) + 1e-10)
            beta = 0.5 * (w @ sp0 + w @ sp1) / wsum
            coef = cf * beta
            tn0 = jnp.einsum("qlj,j->ql", g0f, n)
            tn1 = jnp.einsum("qlj,j->ql", g1f, n)
            r0 = coef * jnp.einsum("q,qd,ql->ld", w, jump, tn0)
            r1 = -coef * jnp.einsum("q,qd,ql->ld", w, jump, tn1)
            return jnp.stack([r0, r1], axis=0)  # (2, nl, d)

        J = jax.vmap(jax.jacfwd(kern))(
            u01, st["t0"], st["g0"], st["t1"], st["g1"], st["n"],
            st["coefc"])
        nif = J.shape[0]
        nld = J.shape[2] * J.shape[3]
        return J.reshape(nif, 2 * nld, 2 * nld)


class StabilisationWrapper:
    """Adapts a stabilisation to the NSForm hook + solver lifecycle."""

    def __init__(self, impl):
        self.impl = impl

    def residual_hook(self, z, params):
        advect = params["advect"]
        Rv, Rq = self.impl.residual(z, params)
        return advect * Rv, advect * Rq

    @property
    def has_velocity_tensors(self):
        """True when per-cell velocity-block Jacobians are available for
        the MG preconditioner (SUPG/GLS)."""
        return isinstance(self.impl, ShakibSUPG)

    @property
    def has_facet_tensors(self):
        """True when per-interior-facet velocity Jacobians are available
        for the MG preconditioner (Burman — see
        BurmanStabilisation.facet_velocity_tensors)."""
        return isinstance(self.impl, BurmanStabilisation)

    def velocity_tensors_hook(self, z, params):
        """Un-advect-scaled per-cell Jacobian contribution (see
        ShakibSUPG.velocity_element_tensors); None when unsupported."""
        if not self.has_velocity_tensors:
            return None
        return self.impl.velocity_element_tensors(z, params)

    def update(self, wind):
        # wind travels through params["wind"]; nothing cached here
        pass


def make_stabilisation(form, kind, supg_method, supg_magic, weight,
                       char_LU=1.0):
    if kind in ("supg", "gls"):
        if supg_method == "shakib":
            impl = ShakibSUPG(form, kind, magic=supg_magic, weight=weight)
        elif supg_method == "turek":
            impl = TurekSUPG(form, kind, char_LU=char_LU,
                             magic=supg_magic, weight=weight)
        else:
            raise NotImplementedError(f"supg_method {supg_method!r}")
    elif kind == "burman":
        impl = BurmanStabilisation(form, weight=weight)
    else:
        raise ValueError(kind)
    return StabilisationWrapper(impl)
