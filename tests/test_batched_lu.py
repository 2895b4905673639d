"""Batched dense factorisation strategies (solvers/batched_lu.py) vs
numpy references — including the elementwise f64 LU of the
ALFI_TPU_PATCH_DTYPE=lu64 arm (regression: its rank-1 update once corrupted already-stored
L multipliers in columns <= k, giving O(1e-2) solve errors)."""

import jax.numpy as jnp
import numpy as np
import pytest

from alfi_tpu.solvers.batched_lu import (
    _CustomF64Factorization,
    _ExplicitInverseFactorization,
    _ScipyFactorization,
    lu_factor_batched,
    lu_solve_batched,
    lu_solve_batched_multi,
)


def _random_batch(seed=0, n=11, m=9, force_pivot=True):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m, m))
    if force_pivot:
        A[3, 0, 0] = 0.0  # forces a row swap at step 0
    b = rng.standard_normal((n, m))
    return A, b


def _np_solve(A, b):
    return np.stack([np.linalg.solve(Ai, bi) for Ai, bi in zip(A, b)])


def test_custom_lu_matches_numpy():
    A, b = _random_batch()
    x = lu_solve_batched(lu_factor_batched(jnp.asarray(A)),
                         jnp.asarray(b))
    assert np.abs(np.asarray(x) - _np_solve(A, b)).max() < 1e-11


def test_custom_lu_multi_rhs():
    A, _ = _random_batch()
    B = np.random.default_rng(1).standard_normal((11, 9, 4))
    X = lu_solve_batched_multi(lu_factor_batched(jnp.asarray(A)),
                               jnp.asarray(B))
    ref = np.stack([np.linalg.solve(Ai, Bi) for Ai, Bi in zip(A, B)])
    assert np.abs(np.asarray(X) - ref).max() < 1e-11


@pytest.mark.parametrize("fs", [
    _CustomF64Factorization(),
    _ExplicitInverseFactorization(),
    _ExplicitInverseFactorization(transposed=True),
    _ScipyFactorization(jnp.float64),
], ids=["lu64", "inverse", "inverse-patch-minor", "native-lu"])
def test_strategies_agree_on_al_like_operators(fs):
    """gamma-dominated AL-like patch operators (kappa ~ 1e6)."""
    A, b = _random_batch(force_pivot=False)
    rng = np.random.default_rng(2)
    Bt = rng.standard_normal((11, 9, 3))
    A = A + 1e6 * np.einsum("bip,bjp->bij", Bt, Bt) + 20 * np.eye(9)
    ref = _np_solve(A, b)
    x = fs.solve(fs.factor(jnp.asarray(A)), jnp.asarray(b))
    rel = np.abs(np.asarray(x) - ref).max() / np.abs(ref).max()
    assert rel < 1e-8, (type(fs).__name__, rel)


@pytest.mark.parametrize("promote", [False, True])
def test_patch_minor_apply_matches_batch_major(promote):
    """solve_t on patch-minor (m, np) vectors is solve on (np, m)."""
    fs = _ExplicitInverseFactorization(transposed=True, promote=promote)
    A, b = _random_batch(force_pivot=False)
    A = A + 20 * np.eye(9)
    fac = fs.factor(jnp.asarray(A))
    x = fs.solve_t(fac, jnp.asarray(b.T))
    assert x.shape == (9, 11)
    np.testing.assert_allclose(np.asarray(x).T, _np_solve(A, b),
                               rtol=1e-10, atol=1e-12)
