"""d-VECTOR-ROW gather/scatter parity (ALFI_TPU_GATHER_SUM=1).

The accelerator hot paths fetch d-wide rows of the (ndof, d) view
instead of nld scalars (MGLevel.gather_cells / sum_cells, and the
patch gather/scatter via patches._scalar_pair_dofs): halving/thirding
the fetch count of the random gathers.  CPU test runs keep the default
scatter path, so this file forces the table path and checks it is
bitwise-equivalent at the level-apply, patch-apply, and full-solve
surfaces (reference hot loop: /root/reference/alfi/solver.py:313-344).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from alfi_tpu import ConstantPressureSolver, ScottVogeliusSolver
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem


def _make(tables, monkeypatch, sv=False):
    monkeypatch.setenv("ALFI_TPU_GATHER_SUM", "1" if tables else "0")
    problem = TwoDimLidDrivenCavityProblem(4)
    if sv:
        solver = ScottVogeliusSolver(
            problem, nref=1, k=2, solver_type="almg", hierarchy="bary",
            patch="macro", stabilisation_type="burman",
            stabilisation_weight=5e-3, gamma=1e4, verbose=False)
    else:
        solver = ConstantPressureSolver(
            problem, nref=1, k=2, solver_type="almg",
            hierarchy="uniform", stabilisation_type="supg",
            gamma=1e4, verbose=False)
    solver.advect_val = 1.0
    solver.nu_val = solver.char_L * solver.char_U / 100.0
    return solver


@pytest.mark.parametrize("sv", [False, True])
def test_level_apply_parity(monkeypatch, sv):
    s0 = _make(False, monkeypatch, sv=sv)
    s1 = _make(True, monkeypatch, sv=sv)
    # the d-row companions exist exactly on the table path
    assert s1.vmg.levels[0].srows is not None
    assert s0.vmg.levels[0].srows is None
    params = s0.params()
    st0 = s0.vmg.setup(s0.z[0], params,
                       static=getattr(s0, "_almg_static", None),
                       p_fine=s0.z[1])
    st1 = s1.vmg.setup(s1.z[0], params,
                       static=getattr(s1, "_almg_static", None),
                       p_fine=s1.z[1])
    rng = np.random.default_rng(0)
    for l in range(s0.vmg.nlevels):
        lev = s0.vmg.levels[l]
        v = jnp.asarray(rng.normal(size=(lev.V.ndof, s0.vmg.d)))
        f0 = (st0["ftensors"][l] if s0.vmg.stab_facet is not None
              else None)
        f1 = (st1["ftensors"][l] if s1.vmg.stab_facet is not None
              else None)
        y0 = np.asarray(s0.vmg.level_apply(l, st0["tensors"][l], v,
                                           ftensors=f0))
        y1 = np.asarray(s1.vmg.level_apply(l, st1["tensors"][l], v,
                                           ftensors=f1))
        rel = np.abs(y1 - y0).max() / max(np.abs(y0).max(), 1e-30)
        assert rel < 1e-12, (l, rel)


@pytest.mark.parametrize("sv", [False, True])
def test_patch_apply_parity(monkeypatch, sv):
    from alfi_tpu.mg.patches import _gather_scatter, _scalar_pair_dofs

    s1 = _make(True, monkeypatch, sv=sv)
    ps = s1.vmg.patchsets[-1]
    d = ps.space_d
    rng = np.random.default_rng(1)
    r = jnp.asarray(rng.normal(size=(ps.nflat,)))
    sdofs = _scalar_pair_dofs(ps, d)
    if not sv:
        # pkp0 star patches constrain whole vectors: pairing must hold
        assert sdofs is not None
    if sdofs is None:
        pytest.skip("per-component constraints — no d-row pairing")
    g1, s1c = _gather_scatter(ps)
    monkeypatch.setenv("ALFI_TPU_GATHER_SUM", "0")
    g0, s0c = _gather_scatter(ps)
    xp0 = np.asarray(g0(r))
    xp1 = np.asarray(g1(r))
    assert np.abs(xp1 - xp0).max() == 0.0
    vals = jnp.asarray(rng.normal(size=xp0.shape))
    y0 = np.asarray(s0c(vals, r.dtype))
    y1 = np.asarray(s1c(vals, r.dtype))
    assert np.abs(y1 - y0).max() < 1e-12


def test_full_solve_parity(monkeypatch):
    s0 = _make(False, monkeypatch)
    z0, i0 = s0.solve(100)
    s1 = _make(True, monkeypatch)
    z1, i1 = s1.solve(100)
    assert i0["converged"] and i1["converged"]
    assert i1["linear_iter"] == i0["linear_iter"]
    assert float(jnp.max(jnp.abs(z1[0] - z0[0]))) < 1e-6
