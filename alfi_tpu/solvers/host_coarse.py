"""Telescoped host-side sparse coarse solve.

The reference's coarse grid leaves the parallel compute domain: it is
gathered onto a size/24 subcommunicator and solved by SuperLU_dist on
CPUs (/root/reference/alfi/solver.py:354-377).  The JAX-native analogue
of that telescope is a ``jax.pure_callback`` to the HOST: element
tensors and the rhs cross to CPU, scipy's SuperLU factors the assembled
sparse operator once per Newton step (cached by a device-computed
fingerprint), and only (N,)-vector solves ride the PCIe round trip in
the cycle hot loop.

This removes the dense-coarse memory cap (an N^2 f64 dense factor grows
quadratically with the coarse grid): reference bfs coarse meshes (e.g.
bfs2d coarse06, ~26k velocity dofs at k=2 on the base mesh) now work as
hierarchy bases.  Exactness: SuperLU runs in f64 on the host, so the
coarse solve is as exact as the reference's.
"""

from __future__ import annotations

import numpy as np


#: single-slot factor cache per solver instance: (fingerprint, splu)
class HostSparseCoarse:
    """Sparse f64 coarse factor/solve on the host for the velocity
    block A = sum_c P_c^T T_c P_c with BC rows/cols eliminated to the
    identity.

    Parameters
    ----------
    rows : (nc, nld) int — flattened global dof rows per cell
    N : total flat dofs
    mask_flat : (N,) 0/1 float — velocity BC mask
    """

    def __init__(self, rows, N, mask_flat):
        rows = np.asarray(rows)
        nc, nld = rows.shape
        self.N = int(N)
        r = np.repeat(rows[:, :, None], nld, axis=2).reshape(-1)
        c = np.repeat(rows[:, None, :], nld, axis=1).reshape(-1)
        self._r, self._c = r, c
        m = np.asarray(mask_flat)
        self._m = m
        self._scale = m[r] * m[c]
        self._diag = 1.0 - m
        self._fr = self._fc = self._fscale = None
        self._cache = (None, None)

    def set_facets(self, facet_rows):
        """Enable interior-facet coupled contributions (Burman
        stabilised Jacobian): facet_rows (nif, 2*nld)."""
        fr = np.asarray(facet_rows)
        nif, m2 = fr.shape
        self._fr = np.repeat(fr[:, :, None], m2, axis=2).reshape(-1)
        self._fc = np.repeat(fr[:, None, :], m2, axis=1).reshape(-1)
        self._fscale = self._m[self._fr] * self._m[self._fc]

    # ---------------- host side ----------------
    def _factor(self, Tvals, Jvals=None):
        from scipy.sparse import coo_matrix
        from scipy.sparse.linalg import splu

        data = Tvals.reshape(-1) * self._scale
        r, c = self._r, self._c
        if Jvals is not None:
            data = np.concatenate(
                [data, Jvals.reshape(-1) * self._fscale])
            r = np.concatenate([r, self._fr])
            c = np.concatenate([c, self._fc])
        A = coo_matrix((data, (r, c)), shape=(self.N, self.N)).tocsc()
        if self._diag.any():
            from scipy.sparse import diags

            A = A + diags(self._diag)
        return splu(A.tocsc())

    def _callback(self, Tvals, b, Jvals=None):
        # fingerprint on the HOST from the raw tensor bytes (exact):
        # computing a weighted projection on device would embed an
        # nc*nld*nld weight array as a constant in every jitted caller
        Tv = np.asarray(Tvals)
        Jv = None if Jvals is None else np.asarray(Jvals)
        key = hash(Tv.tobytes())
        if Jv is not None:
            key ^= hash(Jv.tobytes())
        ck, fac = self._cache
        if ck != key or fac is None:
            fac = self._factor(
                Tv.astype(np.float64),
                None if Jv is None else Jv.astype(np.float64))
            self._cache = (key, fac)
        out = fac.solve(np.asarray(b, dtype=np.float64))
        return out.astype(b.dtype)

    # ---------------- device side ----------------
    def solve(self, T, b, Jf=None):
        """A(T[, Jf])^{-1} b via host callback; T (nc, nld, nld) cell
        tensors, Jf (nif, 2nld, 2nld) facet tensors, b (N,)."""
        import jax

        out = jax.ShapeDtypeStruct(b.shape, b.dtype)
        if Jf is None:
            return jax.pure_callback(self._callback, out, T, b,
                                     vmap_method="sequential")
        return jax.pure_callback(self._callback, out, T, b, Jf,
                                 vmap_method="sequential")
