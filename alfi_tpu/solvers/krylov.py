"""Jittable Krylov solvers over pytree vectors.

JAX-native replacements for the PETSc KSPs the reference configures
(/root/reference/alfi/solver.py:305-514): flexible GMRES (the outer solver,
``ksp_type fgmres``), CG (the graddiv harness driver,
/root/reference/examples/graddiv/graddiv.py:88-97), Richardson and
Chebyshev (the multigrid level drivers).

All solvers are pure functions of pytrees; operators / preconditioners are
closures.  Everything uses fixed-size buffers + ``lax.while_loop`` so the
whole solve stays inside one XLA program — no host round-trips per
iteration (the reference pays a Python/C crossing per PETSc callback).

Convergence semantics mirror KSPConvergedDefault with unpreconditioned
norms: stop when ||r|| <= max(rtol * ||r0||, atol); for right-
preconditioned (F)GMRES the Givens residual estimate IS the
unpreconditioned residual norm.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..config import real_dtype
from ..utils.tree import (
    taxpy,
    tdot,
    tget,
    tnorm,
    tscale,
    tset,
    tstack_zeros,
    tsub,
    tzeros_like,
)

_EPS = 1e-300


def _identity_pc(x):
    return x


class DotContext:
    """Inner-product context for the Krylov loops.

    The default is the plain single-program inner product; the
    shard_map-distributed solver passes an owner-weighted psum variant
    (parallel/distributed.py) so the SAME fgmres/cg implementation runs
    per-block with the reference's MPI-allreduce dot semantics
    (SURVEY.md §5.8)."""

    def dot(self, a, b):
        return tdot(a, b)

    def norm(self, a):
        return tnorm(a)

    def buf_dots(self, buf, w, j, n):
        return _buf_dots(buf, w, j, n)


class ShardDotContext(DotContext):
    """Owner-weighted dots with a psum over the device-mesh axis: every
    replicated (interface/halo) dof is counted once, matching the global
    inner product bit-for-bit up to summation order."""

    def __init__(self, weight, axis):
        #: pytree of 0/1 owner weights matching the vector pytrees
        self.weight = weight
        self.axis = axis

    def dot(self, a, b):
        loc = sum(
            jax.tree.leaves(
                jax.tree.map(lambda w, x, y: jnp.sum(w * x * y),
                             self.weight, a, b)))
        return lax.psum(loc, self.axis)

    def norm(self, a):
        return jnp.sqrt(self.dot(a, a))

    def buf_dots(self, buf, w, j, n):
        dots = sum(
            jax.tree.leaves(
                jax.tree.map(
                    lambda b, ww, wt: jnp.tensordot(
                        b.reshape(n, -1), (wt * ww).reshape(-1), axes=1),
                    buf, w, self.weight)))
        dots = lax.psum(dots, self.axis)
        return jnp.where(jnp.arange(n) < j, dots, 0.0)


def _buf_dots(buf, w, j, n):
    """dots[i] = <buf[i], w> for i < j else 0 — one batched reduction."""
    dots = sum(
        jax.tree.leaves(
            jax.tree.map(
                lambda b, ww: jnp.tensordot(
                    b.reshape(n, -1), ww.reshape(-1), axes=1
                ),
                buf,
                w,
            )
        )
    )
    return jnp.where(jnp.arange(n) < j, dots, 0.0)


def _buf_axpy(buf, coef, w):
    """w - sum_i coef[i] * buf[i]."""
    return jax.tree.map(
        lambda ww, b: ww - jnp.tensordot(coef, b, axes=(0, 0)), w, buf
    )


def fgmres(A, b, pc=None, x0=None, rtol=1e-9, atol=1e-10, maxit=500,
           restart=30, project=None, ctx=None):
    """Right-preconditioned flexible GMRES.

    Parameters
    ----------
    A, pc : pytree -> pytree closures (pc may be nonlinear/state-dependent,
        e.g. an inner Krylov-smoothed multigrid cycle — that is the
        "flexible" part the reference relies on for almg).
    project : optional nullspace projector applied to operator outputs
        (constant-pressure mode removal, the MatNullSpace analogue of
        /root/reference/alfi/problem.py:33-38).

    Returns
    -------
    (x, info) with info = dict(iters, rnorm, rnorm0, converged).
    """
    if pc is None:
        pc = _identity_pc
    if project is None:
        project = _identity_pc
    if ctx is None:
        ctx = DotContext()
    zero_guess = x0 is None
    if zero_guess:
        x0 = tzeros_like(b)
    b = project(b)
    m = restart
    # scalar state (Hessenberg, Givens, residual estimate) follows the
    # VECTOR dtype: the f32 MG level smoother (config.mg_dtype) must not
    # upcast its iterates through f64 scalars; the f64 outer solve is
    # unchanged
    vdt = jnp.result_type(*[x.dtype for x in jax.tree.leaves(b)])

    def opA(v):
        return project(A(v))

    # scalar results from the dot context are pinned to vdt: a context
    # that accumulates in f64 (ShardDotContext's owner-weighted psums)
    # must not upcast an f32 (MG-smoother) Krylov loop through its
    # norms/dots — the carries and the V-basis scaling would silently
    # promote to f64
    def _norm(v):
        return ctx.norm(v).astype(vdt)

    # zero initial guess: the residual IS b — no operator application
    # spent before the Krylov loop (the fixed-iteration MG smoother
    # calls this once per level per cycle, so the saving is real)
    r0 = b if zero_guess else tsub(b, opA(x0))
    rnorm0 = _norm(r0)
    target = jnp.maximum(rtol * rnorm0, atol)

    def cgs2(V, w, j):
        """Classical Gram-Schmidt with one re-orthogonalisation pass."""
        h1 = ctx.buf_dots(V, w, j, m + 1).astype(vdt)
        w = _buf_axpy(V, h1, w)
        h2 = ctx.buf_dots(V, w, j, m + 1).astype(vdt)
        w = _buf_axpy(V, h2, w)
        return w, h1 + h2

    def cycle(x, total_it, r=None):
        if r is None:
            r = tsub(b, opA(x))
        beta = _norm(r)
        V = tstack_zeros(b, m + 1)
        V = tset(V, 0, tscale(1.0 / (beta + _EPS), r))
        Z = tstack_zeros(b, m)
        R = jnp.zeros((m + 1, m), dtype=vdt)  # rotated Hessenberg
        cs = jnp.zeros((m,), dtype=vdt)
        sn = jnp.zeros((m,), dtype=vdt)
        g = jnp.zeros((m + 1,), dtype=vdt).at[0].set(beta)

        def arnoldi_cond(state):
            V, Z, R, cs, sn, g, j, rnorm = state
            return (j < m) & (rnorm > target) & (total_it + j < maxit)

        def arnoldi_step(state):
            V, Z, R, cs, sn, g, j, rnorm = state
            z = pc(tget(V, j))
            Z = tset(Z, j, z)
            w = opA(z)
            w, h = cgs2(V, w, j + 1)  # orthogonalise against V[0..j]
            hj1 = _norm(w)
            V = tset(V, j + 1, tscale(1.0 / (hj1 + _EPS), w))
            # apply stored Givens rotations to the new column h[0..j]
            def rot(i, hcol):
                hi, hi1 = hcol[i], hcol[i + 1]
                return hcol.at[i].set(cs[i] * hi + sn[i] * hi1).at[i + 1].set(
                    -sn[i] * hi + cs[i] * hi1
                )

            hcol = h.at[j + 1].set(hj1)  # j < m inside the loop
            hcol = lax.fori_loop(0, j, rot, hcol)
            a_, b_ = hcol[j], hcol[j + 1]
            denom = jnp.sqrt(a_ * a_ + b_ * b_) + _EPS
            c_new, s_new = a_ / denom, b_ / denom
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            R = R.at[:, j].set(hcol)
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
            rnorm = jnp.abs(g[j + 1])
            return V, Z, R, cs, sn, g, j + 1, rnorm

        init = (V, Z, R, cs, sn, g, 0, beta)
        V, Z, R, cs, sn, g, j, rnorm = lax.while_loop(
            arnoldi_cond, arnoldi_step, init
        )
        # back-substitute on the padded triangle: inactive columns get a
        # unit diagonal and zero rhs so their y_i vanish.
        idx = jnp.arange(m)
        active = idx < j
        Rsq = R[:m, :]
        Rsq = jnp.where(
            active[None, :] & active[:, None],
            Rsq,
            jnp.eye(m, dtype=vdt),
        )
        y = jax.scipy.linalg.solve_triangular(
            Rsq, jnp.where(active, g[:m], 0.0), lower=False
        )
        x = jax.tree.map(
            lambda xx, zz: xx + jnp.tensordot(y, zz, axes=(0, 0)), x, Z
        )
        return x, total_it + j, rnorm

    def outer_cond(state):
        x, it, rnorm = state
        return (rnorm > target) & (it < maxit)

    def outer_body(state):
        x, it, rnorm = state
        return cycle(x, it)

    if maxit <= restart:
        # fixed-iteration (smoother) mode: at most ONE Arnoldi cycle
        # can run (arnoldi_cond caps j at maxit, outer_cond then
        # fails), so call it directly with the known initial residual
        # instead of recomputing b - A x0 inside the loop body
        x, iters, rnorm = cycle(x0, 0, r0)
    else:
        x, iters, rnorm = lax.while_loop(
            outer_cond, outer_body, (x0, jnp.asarray(0), rnorm0)
        )
    info = {
        "iters": iters,
        "rnorm": rnorm,
        "rnorm0": rnorm0,
        "converged": rnorm <= target,
    }
    return x, info


def cg(A, b, pc=None, x0=None, rtol=1e-8, atol=1e-50, maxit=200,
       project=None, ctx=None):
    """Preconditioned CG with unpreconditioned-norm convergence test
    (``ksp_norm_type unpreconditioned`` of
    /root/reference/examples/graddiv/graddiv.py:90-96)."""
    if pc is None:
        pc = _identity_pc
    if project is None:
        project = _identity_pc
    if ctx is None:
        ctx = DotContext()
    if x0 is None:
        x0 = tzeros_like(b)
    b = project(b)
    r = tsub(b, project(A(x0)))
    rnorm0 = ctx.norm(r)
    target = jnp.maximum(rtol * rnorm0, atol)
    z = pc(r)
    p = z
    rz = ctx.dot(r, z)

    def cond(state):
        x, r, p, rz, it, rnorm = state
        return (rnorm > target) & (it < maxit)

    def body(state):
        x, r, p, rz, it, rnorm = state
        Ap = project(A(p))
        alpha = rz / (ctx.dot(p, Ap) + _EPS)
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, Ap, r)
        z = pc(r)
        rz_new = ctx.dot(r, z)
        beta = rz_new / (rz + _EPS)
        p = taxpy(beta, p, z)
        return x, r, p, rz_new, it + 1, ctx.norm(r)

    x, r, p, rz, iters, rnorm = lax.while_loop(
        cond, body, (x0, r, p, rz, jnp.asarray(0), rnorm0)
    )
    return x, {
        "iters": iters,
        "rnorm": rnorm,
        "rnorm0": rnorm0,
        "converged": rnorm <= target,
    }


def richardson(A, b, pc, x0=None, maxit=1, scale=1.0):
    """Fixed-iteration Richardson (the reference's MG outer driver,
    ``ksp_type richardson, ksp_max_it 1``, /root/reference/alfi/solver.py:346-366)."""
    if x0 is None:
        x0 = tzeros_like(b)

    def body(i, x):
        return taxpy(scale, pc(tsub(b, A(x))), x)

    return lax.fori_loop(0, maxit, body, x0)


def fixed_fgmres(A, b, pc, maxit, x0=None, ctx=None):
    """FGMRES with a fixed iteration count and no convergence test — the
    reference's MG level smoother driver (``ksp_convergence_test skip``,
    ``ksp_max_it`` = smoothing, /root/reference/alfi/solver.py:311-317).
    maxit is a Python int (compile-time constant), so buffers are exact."""
    x, _ = fgmres(A, b, pc=pc, x0=x0, rtol=0.0, atol=-1.0, maxit=maxit,
                  restart=maxit, ctx=ctx)
    return x


def chebyshev(A, b, pc, x0=None, maxit=2, lmin=None, lmax=None,
              eig_scale=(0.1, 1.1)):
    """Chebyshev smoother (graddiv harness jacobi branch,
    /root/reference/examples/graddiv/graddiv.py:99-111).  Eigenvalue bounds
    (for the preconditioned operator) must be supplied; when lmin is None
    the bounds are (0.1*lmax, 1.1*lmax) — deliberately wider at the low
    end than PETSc's (0.3, 1.1) because our power-iteration lmax estimate
    is looser than PETSc's GMRES-based esteig (docs/DESIGN.md)."""
    if x0 is None:
        x0 = tzeros_like(b)
    if lmin is None:
        lmin = eig_scale[0] * lmax
        lmax = eig_scale[1] * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def body(i, state):
        x, d, alpha = state
        r = pc(tsub(b, A(x)))
        beta = jnp.where(i == 0, 0.0, (0.5 * delta * alpha) ** 2)
        alpha = jnp.where(
            i == 0, 1.0 / theta, 1.0 / (theta - beta / (alpha + _EPS))
        )
        d = jax.tree.map(lambda dd, rr: beta * dd + rr, d, r)
        x = taxpy(alpha, d, x)
        return x, d, alpha

    vdt = jnp.result_type(*[xx.dtype for xx in jax.tree.leaves(b)])
    x, _, _ = lax.fori_loop(
        0, maxit, body,
        (x0, tzeros_like(b), jnp.asarray(0.0, vdt))
    )
    return x
