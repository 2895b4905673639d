"""Gather-sum accumulation tables (utils/scatter.py) vs native
scatter-add (backend policy gather_tables)."""

import jax.numpy as jnp
import numpy as np

from alfi_tpu.utils.scatter import make_gather_sum


def test_matches_scatter_add_scalar():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 50, (40, 6))
    vals = rng.standard_normal((40, 6))
    gs = make_gather_sum(idx, 50)
    ref = np.zeros(50)
    np.add.at(ref, idx, vals)
    out = np.asarray(gs(jnp.asarray(vals)))
    assert np.abs(out - ref).max() < 1e-12


def test_matches_scatter_add_trailing_dims():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 30, (25, 4))
    vals = rng.standard_normal((25, 4, 3))
    gs = make_gather_sum(idx, 30)
    ref = np.zeros((30, 3))
    np.add.at(ref, idx, vals)
    out = np.asarray(gs(jnp.asarray(vals)))
    assert np.abs(out - ref).max() < 1e-12


def test_padding_indices_dropped():
    """Out-of-range indices (the patch padding convention) contribute
    nothing — no dump slot needed."""
    idx = np.array([[0, 2, 99], [2, -1, 1]])  # 99, -1 invalid for nout=5
    vals = np.ones((2, 3))
    gs = make_gather_sum(idx, 5)
    out = np.asarray(gs(jnp.asarray(vals)))
    assert np.allclose(out, [1.0, 1.0, 2.0, 0.0, 0.0])


def test_empty_rows():
    idx = np.array([[1, 1, 1]])
    gs = make_gather_sum(idx, 4)
    out = np.asarray(gs(jnp.asarray([[2.0, 3.0, 4.0]])))
    assert np.allclose(out, [0.0, 9.0, 0.0, 0.0])


def test_bucketed_gather_sum_matches_padded_table():
    """The multiplicity-bucketed formulation must be BITWISE equal to
    the padded (nout, mu) table (same stable per-row summation order),
    including zero-contribution rows and dropped padding indices."""
    import os

    import jax.numpy as jnp
    import numpy as np

    from alfi_tpu.utils.scatter import make_gather_sum

    rng = np.random.default_rng(11)
    nout, nin = 700, 601
    idx = rng.integers(-1, nout + 2, size=(nin,))  # incl. pad entries
    vals = jnp.asarray(rng.standard_normal((nin, 3)))

    os.environ["ALFI_TPU_BUCKETED_SUM"] = "0"
    try:
        padded = make_gather_sum(idx, nout)
    finally:
        del os.environ["ALFI_TPU_BUCKETED_SUM"]
    bucketed = make_gather_sum(idx, nout)
    assert not padded.bucketed
    assert bucketed.bucketed, (bucketed.mu,)
    a = np.asarray(padded(vals))
    b = np.asarray(bucketed(vals))
    assert np.array_equal(a, b)

    # reference semantics: scatter-add with drops
    ref = np.zeros((nout, 3))
    ok = (idx >= 0) & (idx < nout)
    np.add.at(ref, idx[ok], np.asarray(vals)[ok])
    assert np.allclose(a, ref, rtol=0, atol=1e-12)
