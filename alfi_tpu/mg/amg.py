"""Smoothed-aggregation AMG for the AL velocity block — the ``alamg``
solver mode (/root/reference/alfi/solver.py:380-384: same Schur/AL setup
as almg but the velocity block goes to BoomerAMG/ML instead of the
patch-smoothed geometric MG).

This is the papers' WEAK-BASELINE contrast: an algebraic hierarchy has
no access to the divergence-free near-null space that the star-patch
smoother + Schoeberl transfer capture, so its iteration counts blow up
as gamma (and Re) grow — reproducing that contrast is the point of
shipping the mode.

JAX-first design:
* host one-time setup (numpy/scipy): scalar-dof aggregation by greedy
  maximal-independent-set rooting on the share-a-cell dof graph,
  componentwise tentative prolongator, Jacobi-smoothed
  P = (I - omega D^-1 A_s) P0 built from the STATIC symmetric part
  A_s = K + gamma G (standard SA practice: smooth on the symmetric
  part; the advection perturbation enters through the per-step Galerkin
  products), recursed until the coarse size fits a dense factor;
* per Newton step (in-trace): the level-1 Galerkin product is a single
  scatter-add of per-cell (P_c^T T_c P_c) contributions into a DENSE
  coarse matrix (P rows per cell are static tables), deeper levels are
  dense triple products, the coarse factor is the platform dense
  factorisation;
* cycle: V-cycle with Chebyshev-Jacobi smoothing on the fine level,
  dense-Jacobi Chebyshev on middle levels, direct coarse solve.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import real_dtype


# ----------------------------------------------------------------------
# host: aggregation + smoothed prolongator chain
# ----------------------------------------------------------------------
def _scalar_adjacency(cell_dofs, ndof):
    """CSR dof -> neighbour dofs (share a cell), self excluded."""
    from scipy.sparse import coo_matrix

    nc, nl = cell_dofs.shape
    r = np.repeat(cell_dofs, nl, axis=1).reshape(-1)
    c = np.repeat(cell_dofs, nl, axis=0).reshape(-1)
    A = coo_matrix((np.ones(len(r)), (r, c)), shape=(ndof, ndof))
    A = A.tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    return A


def aggregate(adj):
    """Greedy MIS-rooted aggregation (Vanek-style): unaggregated dofs
    with no aggregated neighbours become roots owning their whole
    neighbourhood; leftovers join the smallest adjacent aggregate."""
    ndof = adj.shape[0]
    agg = np.full(ndof, -1, dtype=np.int64)
    nagg = 0
    indptr, indices = adj.indptr, adj.indices
    for i in range(ndof):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if np.any(agg[nbrs] >= 0):
            continue
        agg[i] = nagg
        agg[nbrs] = nagg
        nagg += 1
    # leftovers: join the smallest adjacent aggregate (keeps aggregate
    # sizes balanced under the CSR visit order)
    sizes = np.bincount(agg[agg >= 0], minlength=max(nagg, 1))
    sizes = list(sizes[:nagg])
    for i in range(ndof):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        owned = np.unique(agg[nbrs])
        owned = owned[owned >= 0]
        if len(owned):
            a = int(owned[np.argmin([sizes[j] for j in owned])])
            agg[i] = a
            sizes[a] += 1
        else:
            agg[i] = nagg
            sizes.append(1)
            nagg += 1
    return agg, nagg


def smoothed_prolongator(A_s, agg, nagg, d, omega_scale=4.0 / 3.0):
    """Flat (N, nagg*d) CSR prolongator: componentwise tentative
    aggregates smoothed by one damped-Jacobi step of the flat static
    operator A_s (N = ndof*d)."""
    from scipy.sparse import coo_matrix, diags

    ndof = len(agg)
    N = ndof * d
    rows = np.arange(N)
    cols = agg[rows // d] * d + rows % d
    P0 = coo_matrix((np.ones(N), (rows, cols)),
                    shape=(N, nagg * d)).tocsr()
    dia = A_s.diagonal()
    dia = np.where(dia == 0.0, 1.0, dia)
    Dinv = diags(1.0 / dia)
    DA = Dinv @ A_s
    # rho(D^-1 A) by a few power iterations
    x = np.ones(N) / np.sqrt(N)
    rho = 1.0
    for _ in range(12):
        y = DA @ x
        rho = np.linalg.norm(y)
        x = y / (rho + 1e-300)
    omega = omega_scale / max(rho, 1e-12)
    P = (P0 - omega * (DA @ P0)).tocsr()
    return P


def csr_to_tables(P):
    """CSR (N, n_c) -> padded gather tables (idx (N, kmax), w) with
    zero-weight pads."""
    N = P.shape[0]
    kmax = int(np.diff(P.indptr).max()) if N else 0
    idx = np.zeros((N, max(kmax, 1)), dtype=np.int64)
    w = np.zeros((N, max(kmax, 1)))
    for i in range(N):
        s, e = P.indptr[i], P.indptr[i + 1]
        idx[i, : e - s] = P.indices[s:e]
        w[i, : e - s] = P.data[s:e]
    return idx, w


class VelocityAMG:
    """AMG velocity-block solver with the VelocityMG calling
    convention (setup/make_solve_A)."""

    def __init__(self, solver, coarse_max=1500, smoothing=None):
        form = solver.form
        V = solver.Z.V
        self.form = form
        self.d = d = form.dim
        self.mask_u = solver.bcset.mask[0]
        self.mask_flat = self.mask_u.reshape(-1)
        self.smoothing = smoothing or solver.smoothing
        from ..solvers.linear import vector_rows

        self.rows = jnp.asarray(np.asarray(vector_rows(V)))
        from ..utils.scatter import default_use_tables, make_gather_sum

        self.row_sum = (make_gather_sum(np.asarray(self.rows),
                                        V.ndof * d)
                        if default_use_tables() else None)
        st = getattr(solver, "stabilisation", None)
        self.stab = (st if st is not None
                     and getattr(st, "has_velocity_tensors", False)
                     else None)

        # ---- host: static symmetric part + aggregation chain ----
        from scipy.sparse import coo_matrix

        with jax.ensure_compile_time_eval():
            K, G = form._static_velocity_tensors()
            T_s = np.asarray(K) + float(solver.gamma) * np.asarray(G)
        rows_np = np.asarray(self.rows)
        N = V.ndof * d
        m = np.asarray(self.mask_flat)
        r = np.repeat(rows_np[:, :, None], rows_np.shape[1],
                      axis=2).reshape(-1)
        c = np.repeat(rows_np[:, None, :], rows_np.shape[1],
                      axis=1).reshape(-1)
        A_s = coo_matrix((T_s.reshape(-1) * m[r] * m[c], (r, c)),
                         shape=(N, N)).tocsr()

        cd = V.cell_dofs.astype(np.int64)
        adj = _scalar_adjacency(cd, V.ndof)
        agg, nagg = aggregate(adj)
        P1 = smoothed_prolongator(A_s, agg, nagg, d)
        # zero BC rows of P so corrections never touch constrained dofs
        from scipy.sparse import diags

        P1 = (diags(m) @ P1).tocsr()
        self.n1 = P1.shape[1]
        idx, w = csr_to_tables(P1)
        self.p_idx = jnp.asarray(idx)
        self.p_w = jnp.asarray(w, dtype=real_dtype)
        self.rt_sum = (make_gather_sum(idx, self.n1)
                       if default_use_tables() else None)

        # per-cell P rows for the in-trace Galerkin product
        kmax = idx.shape[1]
        self.cell_pidx = jnp.asarray(
            idx[rows_np].reshape(rows_np.shape[0], -1))  # (nc, nld*k)
        self.cell_pw = jnp.asarray(
            (w[rows_np] * m[rows_np][..., None]).reshape(
                rows_np.shape[0], -1), dtype=real_dtype)
        self.kmax = kmax

        # deeper levels on the STATIC coarse operator (dense products
        # per step, so just keep the P matrices dense)
        self.P_deep = []
        A_c = (P1.T @ A_s @ P1).tocsr()
        n = self.n1
        while n > coarse_max:
            adj_c = A_c.copy()
            adj_c.setdiag(0)
            adj_c.eliminate_zeros()
            adj_scalar = abs(adj_c)  # flat graph: aggregate flat dofs
            agg_c, nagg_c = aggregate(adj_scalar.tocsr())
            Pd = smoothed_prolongator(A_c, agg_c, nagg_c, 1)
            self.P_deep.append(jnp.asarray(Pd.toarray(),
                                           dtype=real_dtype))
            A_c = (Pd.T @ A_c @ Pd).tocsr()
            n = A_c.shape[0]

    # ------------------------------------------------------------------
    def level_apply(self, tensors, ftensors, v):
        """Masked fine velocity operator (same call shape as
        VelocityMG.level_apply on the finest level; facet-coupled
        (Burman) terms are not applied here — the AMG baseline modes
        never assemble them)."""
        if ftensors is not None:
            raise NotImplementedError(
                "VelocityAMG.level_apply does not support facet-coupled "
                "(Burman) operators")
        v0 = (self.mask_u * v).reshape(-1)
        vloc = v0[self.rows]
        rloc = jnp.einsum("cij,cj->ci", tensors, vloc)
        if self.row_sum is not None:
            rflat = self.row_sum(rloc)
        else:
            rflat = jnp.zeros((v0.shape[0],), dtype=v.dtype)
            rflat = rflat.at[self.rows].add(rloc)
        r = rflat.reshape(v.shape)
        return self.mask_u * r + (1.0 - self.mask_u) * v

    def _galerkin1(self, tensors):
        """Dense level-1 operator sum_c P_c^T T_c P_c + identity on
        unreached coarse dofs."""
        n1 = self.n1
        nc, nldk = self.cell_pidx.shape
        nld = tensors.shape[1]
        k = self.kmax
        # contributions: (nc, nld*k, nld*k)
        Pw = self.cell_pw.reshape(nc, nld, k)
        contrib = jnp.einsum("cia,cij,cjb->ciajb", Pw, tensors,
                             Pw).reshape(nc, nldk, nldk)
        A = jnp.zeros((n1 + 1, n1 + 1), dtype=tensors.dtype)
        ii = self.cell_pidx
        A = A.at[ii[:, :, None], ii[:, None, :]].add(contrib)
        A = A[:n1, :n1]
        dia = jnp.diag(A)
        return A + jnp.diag(jnp.where(jnp.abs(dia) < 1e-300, 1.0, 0.0))

    def setup(self, u_fine, params, p_fine=None):
        form = self.form
        tensors = form.velocity_element_tensors(params, u_fine)
        if self.stab is not None and p_fine is not None:
            Ts = self.stab.velocity_tensors_hook((u_fine, p_fine),
                                                 params)
            if Ts is not None:
                tensors = tensors + params["advect"] * Ts
        mats = [self._galerkin1(tensors)]
        for Pd in self.P_deep:
            mats.append(Pd.T @ (mats[-1] @ Pd))
        from ..solvers.batched_lu import get_factorization

        fs = get_factorization("dense")
        coarse_fac = fs.factor(mats[-1])
        # fine diagonal for Chebyshev-Jacobi
        dloc = jnp.einsum("cii->ci", tensors)
        if self.row_sum is not None:
            diag = self.row_sum(dloc)
        else:
            diag = jnp.zeros((self.mask_flat.shape[0],),
                             dtype=dloc.dtype)
            diag = diag.at[self.rows].add(dloc)
        diag = self.mask_flat * diag + (1.0 - self.mask_flat)
        state = {"tensors": tensors, "mats": mats,
                 "coarse_fac": coarse_fac, "diag": diag}
        state["lmax"] = self._lmax(state)
        return state

    def _lmax(self, state, iters=10):
        x = self.mask_u * jnp.ones(self.mask_u.shape,
                                   dtype=real_dtype)
        x = x / jnp.linalg.norm(x)
        lam = jnp.asarray(1.0, dtype=real_dtype)
        d2 = state["diag"].reshape(self.mask_u.shape)
        for _ in range(iters):
            y = self.level_apply(state["tensors"], None, x) / d2
            lam = jnp.linalg.norm(y)
            x = y / (lam + 1e-300)
        return 1.1 * lam

    def _restrict(self, r):
        """P^T r: fine flat -> level-1."""
        contrib = self.p_w * r.reshape(-1)[:, None]
        if self.rt_sum is not None:
            return self.rt_sum(contrib)
        out = jnp.zeros((self.n1,), dtype=r.dtype)
        return out.at[self.p_idx].add(contrib)

    def _prolong(self, xc):
        return jnp.einsum("nk,nk->n", self.p_w,
                          xc[self.p_idx]).reshape(self.mask_u.shape)

    def make_solve_A(self, state):
        from ..solvers.batched_lu import get_factorization
        from ..solvers.krylov import chebyshev

        fs = get_factorization("dense")
        diag = state["diag"].reshape(self.mask_u.shape)
        mats = state["mats"]
        m = self.smoothing

        def smooth(b, x0):
            return chebyshev(
                lambda v: self.level_apply(state["tensors"], None, v),
                b, lambda r: r / diag, x0=x0, maxit=m,
                lmax=state["lmax"])

        def coarse_chain(r1):
            # middle levels: one damped-Jacobi sweep down, direct at
            # the bottom, sweep back up
            rs = [r1]
            for Pd in self.P_deep:
                rs.append(Pd.T @ rs[-1])
            x = fs.solve(state["coarse_fac"], rs[-1])
            for i in range(len(self.P_deep) - 1, -1, -1):
                x = Pd_apply(self.P_deep[i], rs[i], x, mats[i])
            return x

        def Pd_apply(Pd, r, xc, Amid):
            x = Pd @ xc
            dmid = jnp.diag(Amid)
            dmid = jnp.where(jnp.abs(dmid) < 1e-300, 1.0, dmid)
            r2 = r - Amid @ x
            return x + 0.6 * r2 / dmid

        def solve_A(rv):
            x = smooth(rv, jnp.zeros_like(rv))
            r = rv - self.level_apply(state["tensors"], None, x)
            xc = coarse_chain(self._restrict(r))
            x = x + self.mask_u * self._prolong(xc)
            return smooth(rv, x)

        return solve_A
