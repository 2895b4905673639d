"""Batched dense factorisations for the AL patch / coarse operators.

The AL operators have condition ~ gamma/nu * h^-2 (1e7+ at the default
gamma=1e4), far beyond f32 factorisation accuracy, so the production
factorisations are f64: XLA's native batched LU on every supported
platform (backend.py).  The small patch matrices are applied as
explicit inverses (the reference's ``patch_pc_patch_dense_inverse``),
the single large ones by LU solves.

The elementwise LU below (factorisation and triangular solves built from
adds/multiplies/gathers only) is kept as the ALFI_TPU_PATCH_DTYPE=lu64
arm.  Shapes: A (..., m, m); everything vmaps/batches over the leading
axes.  Pivoting is partial (row) pivoting, matching LAPACK getrf.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax import lax

from ..backend import check_platform
from ..config import real_dtype


def lu_factor_batched(A):
    """Returns (LU (..., m, m), perm (..., m)) with L unit-lower in the
    strictly-lower triangle and U upper; perm maps solve rhs rows."""
    m = A.shape[-1]
    batch = A.shape[:-2]
    perm0 = jnp.broadcast_to(jnp.arange(m), batch + (m,))
    rows = jnp.arange(m)

    def step(k, state):
        LU, perm = state
        col = jnp.abs(LU[..., :, k])
        col = jnp.where(rows >= k, col, -jnp.inf)
        p = jnp.argmax(col, axis=-1)  # (...,)
        # row swap k <-> p via a gather permutation
        idx = jnp.broadcast_to(rows, batch + (m,))
        pk = p[..., None]
        idx = jnp.where(idx == k, pk, jnp.where(idx == pk, k, idx))
        LU = jnp.take_along_axis(LU, idx[..., None], axis=-2)
        perm = jnp.take_along_axis(perm, idx, axis=-1)
        # eliminate below the pivot — update ONLY columns right of k: the
        # columns <= k of later rows hold already-stored L multipliers
        # which the rank-1 update must not touch
        pivval = LU[..., k, k]
        safe = jnp.where(pivval == 0.0, 1.0, pivval)
        fac = LU[..., :, k] / safe[..., None]
        below = rows > k
        pivrow = jnp.where(below, LU[..., k, :], 0.0)  # cols > k only
        upd = (jnp.where(below, fac, 0.0)[..., :, None]
               * pivrow[..., None, :])
        LU = LU - upd
        LU = jnp.where(
            (below[:, None] & (rows == k)[None, :]),
            jnp.broadcast_to(fac[..., :, None], LU.shape), LU)
        return LU, perm

    LU, perm = lax.fori_loop(0, m, step, (A, perm0))
    return LU, perm


def lu_solve_batched(lu_perm, b):
    """Solve A x = b given lu_factor_batched output; b (..., m)."""
    LU, perm = lu_perm
    m = LU.shape[-1]
    rows = jnp.arange(m)
    y = jnp.take_along_axis(b, perm, axis=-1)

    def fwd(k, y):
        # y_k -= sum_{j<k} L[k, j] y_j
        Lrow = jnp.where(rows < k, LU[..., k, :], 0.0)
        s = jnp.sum(Lrow * y, axis=-1)
        return y.at[..., k].add(-s)

    y = lax.fori_loop(0, m, fwd, y)

    def bwd(i, x):
        k = m - 1 - i
        Urow = jnp.where(rows > k, LU[..., k, :], 0.0)
        s = jnp.sum(Urow * x, axis=-1)
        diag = LU[..., k, k]
        safe = jnp.where(diag == 0.0, 1.0, diag)
        return x.at[..., k].set((x[..., k] - s) / safe)

    x = lax.fori_loop(0, m, bwd, y)
    return x


def lu_solve_batched_multi(lu_perm, B):
    """Multi-rhs variant: B (..., m, k) -> X (..., m, k)."""
    LU, perm = lu_perm
    m = LU.shape[-1]
    rows = jnp.arange(m)
    y = jnp.take_along_axis(B, perm[..., None], axis=-2)

    def fwd(j, y):
        Lrow = jnp.where(rows < j, LU[..., j, :], 0.0)
        s = jnp.einsum("...m,...mk->...k", Lrow, y)
        return y.at[..., j, :].add(-s)

    y = lax.fori_loop(0, m, fwd, y)

    def bwd(i, x):
        j = m - 1 - i
        Urow = jnp.where(rows > j, LU[..., j, :], 0.0)
        s = jnp.einsum("...m,...mk->...k", Urow, x)
        diag = LU[..., j, j]
        safe = jnp.where(diag == 0.0, 1.0, diag)
        return x.at[..., j, :].set((x[..., j, :] - s) / safe[..., None])

    return lax.fori_loop(0, m, bwd, y)


class _ScipyFactorization:
    """Native XLA LU (LAPACK getrf on the CPU, cuSOLVER/cuBLAS batched
    getrf on the GPU) in a fixed dtype: f64 by default, f32 only as the
    ALFI_TPU_PATCH_DTYPE=f32 speed-over-accuracy arm."""

    def __init__(self, dtype):
        self.dtype = dtype

    def factor(self, A):
        return jax.scipy.linalg.lu_factor(A.astype(self.dtype))

    def solve(self, fac, b):
        # cast to the FACTOR's dtype, not the construction dtype: the
        # f32-cycle state cast (mg/velocity.py setup) may have stored
        # the factor in the cycle dtype
        dt = fac[0].dtype
        x = jax.scipy.linalg.lu_solve(fac, b.astype(dt)[..., None])
        return x[..., 0].astype(b.dtype)


class _CustomF64Factorization:
    """Elementwise-ops f64 LU (the ALFI_TPU_PATCH_DTYPE=lu64 arm)."""

    def factor(self, A):
        return lu_factor_batched(A)

    def solve(self, fac, b):
        return lu_solve_batched(fac, b)


def apply_transposed_xla(fac, rp):
    """Batched GEMV of PATCH-MINOR inverses: out (m, np) = sum_j
    fac[i, j, :] * rp[j, :] as an elementwise multiply + reduce over j,
    which XLA fuses into a single stream over ``fac`` without
    relayouting to batch-major (an einsum/dot_general with the batch
    dim minor-most may transpose operands first).  The patch-minor
    layout puts the large patch axis minor-most, the layout the
    structured sliced gather produces."""
    npat = rp.shape[-1]
    npad = fac.shape[-1]
    if npad != npat:
        rp = jnp.pad(rp, ((0, 0), (0, npad - npat)))
    out = jnp.sum(fac * rp[None, :, :], axis=1)
    return out[:, :npat]


class _ExplicitInverseFactorization:
    """Dense patch INVERSES — the reference's own PkP0 patch trick
    (``patch_pc_patch_dense_inverse``, /root/reference/alfi/solver.py:599-602):
    pay one native f64 LU + multi-rhs solve at factor time, then every
    application is a single batched matvec.  Forward error of
    apply-by-inverse is ~kappa*eps64, the same order as an LU solve —
    and identical to what PETSc's dense inverse does.

    ``apply_dtype=f32``: keep the f64 factorisation (the
    gamma-conditioned cancellation lives there) but run the hot-loop
    matvec in f32.  The patch sweep is a PRECONDITIONER inside
    (flexible) FGMRES, which tolerates an inexact application by
    construction; iteration-count parity is the acceptance gate.

    ``transposed=True``: store the inverses PATCH-MINOR, (m, m, np)
    instead of (np, m, m), the layout the structured sliced gather
    produces (mg/structured.py).  See apply_transposed_xla.  The apply
    takes/returns patch-minor vectors via :meth:`solve_t`;
    :meth:`solve` keeps the batch-major interface for the remaining
    callers."""

    def __init__(self, apply_dtype=None, transposed=False,
                 promote=False):
        self.apply_dtype = apply_dtype
        self.transposed = transposed
        #: store-narrow / compute-wide (the config.mg_store pattern):
        #: inverses stored in apply_dtype but the GEMV runs in the
        #: RESIDUAL dtype via promotion — halved factor stream, exact
        #: iteration parity (consistent eps32 perturbation of the PC)
        self.promote = promote
        self.batch_axis = -1 if transposed else 0

    def factor(self, A):
        m = A.shape[-1]

        def one(Ac):
            eye = jnp.broadcast_to(jnp.eye(m, dtype=Ac.dtype), Ac.shape)
            inv = jax.scipy.linalg.lu_solve(
                jax.scipy.linalg.lu_factor(Ac), eye)
            if self.apply_dtype is not None:
                inv = inv.astype(self.apply_dtype)
            return inv

        # sequential patch chunks of ~256 MB working set each: the
        # factor plus the m-RHS inverse solve hold several (np, m, m)
        # buffers at once (7.2 GB in one buffer at ldc3d nref=2, np=4913,
        # m=189), and SV 3D macrostar patches reach m ~ 1600, so the
        # chunk floor is one patch.  2D batches (m ~ 14-62) stay whole.
        from ..fem.nsforms import _map_cell_chunks

        per = m * m * A.dtype.itemsize * 8
        chunk = max(1, (256 << 20) // per)
        inv = _map_cell_chunks(one, A, chunk=chunk)
        if self.transposed:
            inv = jnp.moveaxis(inv, 0, -1)  # (m, m, np)
        return inv

    def solve_t(self, Ainv, rp):
        """Patch-minor apply: rp (m, np) -> (m, np)."""
        if self.promote:
            return apply_transposed_xla(Ainv, rp)
        return apply_transposed_xla(
            Ainv, rp.astype(Ainv.dtype)).astype(rp.dtype)

    def solve(self, Ainv, b):
        if self.transposed:
            # compat path for batch-major callers (multiplicative
            # color sweeps, distributed blocks): transpose the small
            # vectors, never the factor
            return self.solve_t(Ainv, b.T).T
        if self.apply_dtype is not None:
            rhs = b if self.promote else b.astype(self.apply_dtype)
            y = jnp.einsum("...ij,...j->...i", Ainv, rhs)
            return y.astype(b.dtype)
        return jnp.einsum("...ij,...j->...i", Ainv, b)


_fs = {}
_PATCH_DTYPE = ("", "f32", "lu64", "lu")
_PATCH_APPLY = ("", "f32", "f32t", "t", "f32s", "f32st")


def get_factorization(kind="dense"):
    """Dense f64 factorisation for the ill-conditioned AL operators:
    XLA's native batched LU.  ``kind="patch"`` (the many small patch
    matrices) applies it as explicit inverses, one batched matvec per
    application; ``"dense"`` (lu/allu modes, AMG coarse) and
    ``"coarse"`` (the MG coarse grid) are single large matrices, applied
    by LU solves.

    Overrides: ALFI_TPU_PATCH_DTYPE=f32 (f32 LU everywhere, unsafe at
    high gamma/Re), =lu64 (elementwise f64 LU everywhere), =lu (native
    f64 LU solve per patch application).  ALFI_TPU_PATCH_APPLY picks
    the explicit patch inverses' apply variant:

    * f32   — f32 batch-major matvec
    * f32t  — f32 patch-minor layout, XLA multiply-reduce
    * t     — f64 patch-minor (the layout effect in isolation)
    * f32s / f32st — f32-STORED inverses, f64-COMPUTED matvec (dtype
      promotion): halved factor stream (the config.mg_store pattern)
    """
    if kind not in _fs:
        check_platform()
        env = os.environ.get("ALFI_TPU_PATCH_DTYPE", "")
        app = os.environ.get("ALFI_TPU_PATCH_APPLY", "")
        # a typo would silently pick another mode — refuse instead
        for name, val, allowed in (("PATCH_DTYPE", env, _PATCH_DTYPE),
                                   ("PATCH_APPLY", app, _PATCH_APPLY)):
            if val not in allowed:
                raise ValueError("ALFI_TPU_%s=%r: expected one of %s" % (
                    name, val, ", ".join(map(repr, allowed))))
        if env == "f32":
            _fs[kind] = _ScipyFactorization(jnp.float32)
        elif env == "lu64":
            _fs[kind] = _CustomF64Factorization()
        elif kind == "patch" and env != "lu":
            dt = jnp.float32 if app.startswith("f32") else None
            _fs[kind] = _ExplicitInverseFactorization(
                dt, transposed=app in ("f32t", "t", "f32st"),
                promote=app in ("f32s", "f32st"))
        else:
            _fs[kind] = _ScipyFactorization(real_dtype)
    return _fs[kind]
