"""Linearised operators and direct solves for the mixed system.

Replaces the PETSc Mat/LU machinery of the reference
(/root/reference/alfi/solver.py:396-421 "lu"/"allu" branches, MUMPS):

* matrix-free Jacobian action via ``jax.linearize`` of the residual (the
  reference's MatNest matvec becomes one fused XLA kernel),
* dense global Jacobian assembly from per-cell element tensors — the
  JAX equivalent of a direct factorisation: gathered-to-one-device LU
  (full system for "lu", velocity block for "allu" and the MG coarse grid,
  the telescoping analogue of /root/reference/alfi/solver.py:354-378),
* BC handling by row/col elimination with identity diagonal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import real_dtype


def flatten_mixed(z):
    u, p = z
    return jnp.concatenate([u.reshape(-1), p])


def unflatten_mixed(x, Z):
    nV = Z.V.ndof * Z.V.value_size
    u = x[:nV].reshape(Z.V.ndof, Z.V.value_size)
    return (u, x[nV:])


def make_jacobian_matvec(residual_fn, bcset, z, params):
    """v -> J(z) v with eliminated rows/cols (identity on BC dofs).

    residual_fn(z, params) must be the RAW (un-masked) residual; masking
    happens here so the Jacobian stays symmetric-consistent with the
    masked residual used by Newton."""

    _, jvp = jax.linearize(lambda zz: residual_fn(zz, params), z)

    def matvec(v):
        Jv = jvp(bcset.zero(v))
        return bcset.identity_rows(bcset.zero_rows(Jv), v)

    return matvec


def vector_rows(space):
    """(nc, nloc*d) flattened global row indices of a vector space, with
    flat index dof*d + component (the BAIJ-like blocking of
    /root/reference/alfi/solver.py:512)."""
    d = space.value_size
    cd = jnp.asarray(space.cell_dofs)
    return (cd[:, :, None] * d + jnp.arange(d)[None, None, :]).reshape(
        cd.shape[0], -1
    )


def assemble_dense_mixed(form, z, params, bcset):
    """Global dense Jacobian of the mixed residual at z, BC-eliminated.

    Layout: [u dofs (dof*d + comp) | p dofs].  Only sane for the coarse /
    small problems where the reference would call MUMPS."""
    Z = form_space(form)
    Juu, Jup, Jpu, Jpp = form.mixed_element_tensors(z, params)
    d = form.dim
    nV = form.V.ndof * d
    N = nV + form.Q.ndof
    rv = vector_rows(form.V)  # (nc, nlv*d)
    rq = nV + jnp.asarray(form.Q.cell_dofs)  # (nc, nlq)
    A = jnp.zeros((N, N), dtype=real_dtype)
    A = A.at[rv[:, :, None], rv[:, None, :]].add(Juu)
    A = A.at[rv[:, :, None], rq[:, None, :]].add(Jup)
    A = A.at[rq[:, :, None], rv[:, None, :]].add(Jpu)
    A = A.at[rq[:, :, None], rq[:, None, :]].add(Jpp)
    m = flatten_mixed(bcset.mask)
    A = m[:, None] * A * m[None, :] + jnp.diag(1.0 - m)
    return A


def form_space(form):
    from ..fem.spaces import MixedFunctionSpace

    return MixedFunctionSpace(form.V, form.Q)


def assemble_dense_velocity(form, wind, params, mask_u):
    """Dense velocity-block Jacobian (viscous + grad-div + linearised
    advection at ``wind``), BC-eliminated."""
    T = form.velocity_element_tensors(params, wind)  # (nc, nlv*d, nlv*d)
    return assemble_dense_from_tensors(form, T, mask_u)


def assemble_dense_from_tensors(form, T, mask_u, facet_tensors=None,
                                facet_rows=None):
    """Dense velocity operator from per-cell tensors, optionally plus
    interior-facet coupled tensors (Burman stabilised Jacobian,
    facet_rows (nif, 2*nld)); BC rows/cols eliminated to identity."""
    rows = vector_rows(form.V)
    N = form.V.ndof * form.dim
    A = jnp.zeros((N, N), dtype=real_dtype)
    A = A.at[rows[:, :, None], rows[:, None, :]].add(T)
    if facet_tensors is not None:
        A = A.at[facet_rows[:, :, None],
                 facet_rows[:, None, :]].add(facet_tensors)
    m = mask_u.reshape(-1)
    return m[:, None] * A * m[None, :] + jnp.diag(1.0 - m)


def assemble_dense_graddiv_factors(form, mask_u):
    """Dense (N, nc*q) grad-div factor matrix with BC rows zeroed — the
    coarse-grid companion of NSForm.graddiv_factors."""
    Bt = form.graddiv_factors()  # (nc, nld, q)
    nc, nld, q = Bt.shape
    rows = vector_rows(form.V)  # (nc, nld)
    N = form.V.ndof * form.dim
    cols = (jnp.arange(nc) * q)[:, None, None] + jnp.arange(q)[None, None]
    cols = jnp.broadcast_to(cols, (nc, nld, q))
    B = jnp.zeros((N, nc * q), dtype=real_dtype)
    B = B.at[rows[:, :, None], cols].add(Bt)
    return mask_u.reshape(-1)[:, None] * B


def woodbury_dense_factor(M, B, gamma):
    """Arrays-only factor state for the f32 gamma-split dense solve
    (see mg/patches.py build_patch_solver_woodbury); pairs with
    :func:`woodbury_dense_apply` so the state can cross jit boundaries
    and be timed per-op."""
    dt = jnp.float32
    M32, B32 = M.astype(dt), B.astype(dt)
    from ..mg.patches import woodbury_effective_gamma

    Minv = jax.scipy.linalg.lu_solve(jax.scipy.linalg.lu_factor(M32),
                                     jnp.eye(M32.shape[0], dtype=dt))
    fac = {"Minv": Minv}
    Y = Minv @ B32
    R = B.shape[1]
    S = B32.T @ Y
    geff = woodbury_effective_gamma(gamma, S)
    C = jnp.eye(R, dtype=dt) / geff + S
    Clu = jax.scipy.linalg.lu_factor(C)
    fac.update(Clu=Clu, Y=Y, B32=B32)
    return fac


def woodbury_dense_apply(fac, b):
    dt = jnp.float32
    y = fac["Minv"] @ b.astype(dt)
    s = jax.scipy.linalg.lu_solve(fac["Clu"], fac["B32"].T @ y)
    return (y - fac["Y"] @ s).astype(b.dtype)


def woodbury_dense_closure(M, B, gamma):
    """x -> (M + gamma B B^T)^{-1} x in f32 with gamma-independent
    conditioning."""
    fac = woodbury_dense_factor(M, B, gamma)
    return lambda b: woodbury_dense_apply(fac, b)


def lu_solve_closure(A):
    """Factor once with the native f64 LU (batched_lu.get_factorization),
    return x -> A^{-1} x on flat vectors."""
    from .batched_lu import get_factorization

    fs = get_factorization()
    fac = fs.factor(A)

    def solve(b):
        return fs.solve(fac, b)

    return solve


def refined_lu_solve_closure(A, rtol=1e-12, maxit=40):
    """Full-accuracy direct solve (the MUMPS analogue,
    /root/reference/alfi/solver.py:396-403).  With an f64-capable
    factorisation this is a plain factor+solve; when the factorisation is
    forced to f32 (ALFI_TPU_PATCH_DTYPE=f32) f64 accuracy is recovered by
    jittable iterative refinement."""
    from jax import lax

    from .batched_lu import get_factorization

    fs = get_factorization()
    fac = fs.factor(A)

    def base(b):
        return fs.solve(fac, b)

    if getattr(fs, "dtype", A.dtype) == A.dtype:
        return base

    def solve(b):
        bnorm = jnp.linalg.norm(b)
        x0 = base(b)

        def cond(state):
            x, r, it = state
            return (jnp.linalg.norm(r) > rtol * bnorm) & (it < maxit)

        def body(state):
            x, r, it = state
            x = x + base(r)
            return x, b - A @ x, it + 1

        x, r, _ = lax.while_loop(cond, body,
                                 (x0, b - A @ x0, jnp.asarray(0)))
        return x

    return solve
