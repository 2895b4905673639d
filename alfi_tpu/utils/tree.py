"""Pytree vector-space helpers for Krylov methods.

Solution/residual vectors are pytrees (u (ndofV, d), p (ndofQ,)); these
replace PETSc Vec operations (VecDot/VecAXPY/VecNorm) with tree_map +
fused XLA reductions.
"""

import jax
import jax.numpy as jnp


def tdot(a, b):
    """Global (flattened) dot product of two pytrees."""
    leaves = jax.tree.leaves(jax.tree.map(lambda x, y: jnp.vdot(x, y), a, b))
    return sum(leaves)


def tnorm(a):
    return jnp.sqrt(tdot(a, a))


def taxpy(alpha, x, y):
    """alpha * x + y"""
    return jax.tree.map(lambda xx, yy: alpha * xx + yy, x, y)


def tscale(alpha, x):
    return jax.tree.map(lambda xx: alpha * xx, x)

def tadd(x, y):
    return jax.tree.map(jnp.add, x, y)


def tsub(x, y):
    return jax.tree.map(jnp.subtract, x, y)


def tzeros_like(x):
    return jax.tree.map(jnp.zeros_like, x)


def tmask(mask, x):
    """Elementwise multiply by a mask pytree (BC row masking)."""
    return jax.tree.map(jnp.multiply, mask, x)


def tstack_zeros(x, n):
    """Allocate a pytree with a leading axis of length n (Krylov basis)."""
    return jax.tree.map(
        lambda xx: jnp.zeros((n,) + xx.shape, dtype=xx.dtype), x
    )


def tset(buf, j, x):
    """buf[j] = x for a stacked pytree buffer, stored in the buffer's
    dtype (an f32 smoother Krylov basis may be handed f64 vectors)."""
    return jax.tree.map(lambda b, xx: b.at[j].set(xx.astype(b.dtype)),
                        buf, x)


def tget(buf, j):
    return jax.tree.map(lambda b: b[j], buf)


def tcombine(buf, coef):
    """sum_j coef[j] * buf[j] over the leading axis."""
    return jax.tree.map(
        lambda b: jnp.tensordot(coef, b, axes=(0, 0)), buf
    )


def cast_floating(t, dtype):
    """Cast every floating-point leaf of a pytree to ``dtype`` (int
    leaves — LU pivots, index tables — pass through)."""
    return jax.tree.map(
        lambda a: a.astype(dtype)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, t)
