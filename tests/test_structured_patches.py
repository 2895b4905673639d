"""Sliced patch apply on structured meshes (mg/structured.py).

The geometric entity numbering (mesh/renumber.py) makes the star-patch
dof table affine over the interior seed grid of the generated LDC
meshes; the structured path replaces the random-gather patch apply with
dense slices.  Gates: exact layout detection, apply equivalence against
the generic table path, numbering invariants, end-to-end iteration-count
parity.  Reference loop being accelerated: PCPatch additive star sweep,
/root/reference/alfi/solver.py:313-344.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from alfi_tpu import ConstantPressureSolver
from alfi_tpu.mg import structured
from alfi_tpu.mg.patches import build_patch_solver, star_patches
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem


@pytest.fixture(scope="module")
def ldc_level():
    s = ConstantPressureSolver(
        TwoDimLidDrivenCavityProblem(8), nref=1, k=2,
        solver_type="almg", hierarchy="uniform", verbose=False)
    return s.vmg.levels[-1]


def test_mesh_numbering_lex(ldc_level):
    """Refined structured meshes get (y, x)-lex vertices and
    family-blocked lex edges."""
    mesh = ldc_level.V.mesh
    v = mesh.vertices
    key = np.lexsort((v[:, 0], v[:, 1]))
    assert np.array_equal(key, np.arange(mesh.num_vertices))
    ev = mesh.edge_vertices
    a, b = v[ev[:, 0]], v[ev[:, 1]]
    d = b - a
    ang = np.round(np.arctan2(d[:, 1], d[:, 0]) % np.pi, 9)
    mid = 0.5 * (a + b)
    ekey = np.lexsort((mid[:, 0], mid[:, 1], ang))
    assert np.array_equal(ekey, np.arange(mesh.num_edges))


def test_detects_interior_grid(ldc_level):
    ps = star_patches(ldc_level.V, np.asarray(ldc_level.mask_flat))
    lay = structured.detect(ps)
    assert lay is not None
    # baseN=8 nref=1 -> N=16 grid, 15x15 interior star patches
    assert (lay.ny, lay.nx, lay.ni) == (15, 15, 225)
    assert all(b >= ps.space_d * lay.nx for b in lay.bys)


def test_declines_unstructured():
    """A patchset whose seeds don't form a full rectangle (or with no
    seed points at all) falls back to the generic path."""
    s = ConstantPressureSolver(
        TwoDimLidDrivenCavityProblem(8), nref=1, k=2,
        solver_type="almg", hierarchy="uniform", verbose=False)
    lev = s.vmg.levels[-1]
    ps = star_patches(lev.V, np.asarray(lev.mask_flat))
    ps.seed_points = None
    assert structured.detect(ps) is None
    ps2 = star_patches(lev.V, np.asarray(lev.mask_flat))
    # knock out one interior patch -> the single-class rectangle fails;
    # parity pass 2 may still slice the three healthy classes, but the
    # knocked patch itself must land in the generic fringe
    ps2.sizes = ps2.sizes.copy()
    full = np.where(ps2.sizes == ps2.m)[0]
    knocked = full[len(full) // 2]
    ps2.sizes[knocked] = 0
    lay = structured.detect(ps2)
    if lay is not None:
        sliced = lay.order[:lay.ni]
        assert knocked not in sliced
        assert lay.ni < ps2.npatches


def test_structured_apply_matches_generic(ldc_level, monkeypatch):
    lev = ldc_level
    ps1 = star_patches(lev.V, np.asarray(lev.mask_flat))
    ps2 = star_patches(lev.V, np.asarray(lev.mask_flat))
    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "1")
    f1, a1 = build_patch_solver(ps1)
    assert getattr(ps1, "layout", None) is not None  # structured ran
    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "0")
    f2, a2 = build_patch_solver(ps2)

    nc = lev.V.mesh.num_cells
    nld = lev.V.cell_dofs.shape[1] * lev.V.value_size
    rng = np.random.default_rng(3)
    T = rng.standard_normal((nc, nld, nld))
    T = T + np.transpose(T, (0, 2, 1)) + 40 * np.eye(nld)
    Tj = jnp.asarray(T)
    r = jnp.asarray(rng.standard_normal(ps1.nflat))
    x1 = np.asarray(a1(f1(Tj), r))
    x2 = np.asarray(a2(f2(Tj), r))
    err = np.abs(x1 - x2).max() / np.abs(x2).max()
    assert err < 1e-11, err


def test_e2e_iteration_parity(monkeypatch):
    """Full almg Re-continuation: identical convergence and Krylov
    counts with the sliced smoother on and off."""
    def run():
        s = ConstantPressureSolver(
            TwoDimLidDrivenCavityProblem(8), nref=1, k=2,
            solver_type="almg", hierarchy="uniform",
            stabilisation_type="supg", patch="star",
            restriction=True, verbose=False)
        out = []
        for re in (1, 100):
            _, info = s.solve(re)
            out.append((re, info["converged"], info["linear_iter"],
                        info["nonlinear_iter"]))
        return out

    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "1")
    with_struct = run()
    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "0")
    without = run()
    assert all(c for _, c, _, _ in with_struct)
    assert with_struct == without


# ----------------------------------------------------------------------
# SV bary macrostar: per-parity-class slicing with axis-swapped slots
# (VERDICT r4 item 3 — the production family the struct path missed)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def sv_level():
    from alfi_tpu import ScottVogeliusSolver

    s = ScottVogeliusSolver(
        TwoDimLidDrivenCavityProblem(8), nref=1, k=2,
        solver_type="almg", hierarchy="bary", patch="macro",
        stabilisation_type="burman", stabilisation_weight=5e-3,
        gamma=1e4, verbose=False)
    return s.vmg.levels[-1]


def test_detects_sv_macrostar_parity_classes(sv_level):
    """Bary meshes repeat with period 2 (centroids appended in parent-
    cell order): all four (y%2, x%2) interior macrostar classes are
    affine, six of the 31 slot groups with Y-FASTEST numbering (the
    swapped-axis window path)."""
    from alfi_tpu.mg.patches import macrostar_patches

    lev = sv_level
    ps = macrostar_patches(lev.V, np.asarray(lev.mask_flat))
    lay = structured.detect(ps)
    assert lay is not None
    assert len(lay.blocks) == 4
    assert lay.ni == 15 * 15  # every interior macro vertex sliced
    assert any(b.swapped.any() for b in lay.blocks)


def test_sv_macrostar_apply_matches_generic(sv_level, monkeypatch):
    from alfi_tpu.mg.patches import macrostar_patches

    lev = sv_level
    ps1 = macrostar_patches(lev.V, np.asarray(lev.mask_flat))
    ps2 = macrostar_patches(lev.V, np.asarray(lev.mask_flat))
    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "1")
    f1, a1 = build_patch_solver(ps1)
    assert getattr(ps1, "layout", None) is not None  # structured ran
    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "0")
    f2, a2 = build_patch_solver(ps2)

    nc = lev.V.mesh.num_cells
    nld = lev.V.cell_dofs.shape[1] * lev.V.value_size
    rng = np.random.default_rng(7)
    T = rng.standard_normal((nc, nld, nld))
    T = T + np.transpose(T, (0, 2, 1)) + 40 * np.eye(nld)
    Tj = jnp.asarray(T)
    r = jnp.asarray(rng.standard_normal(ps1.nflat))
    x1 = np.asarray(a1(f1(Tj), r))
    x2 = np.asarray(a2(f2(Tj), r))
    err = np.abs(x1 - x2).max() / np.abs(x2).max()
    assert err < 1e-11, err


def test_sv_e2e_iteration_parity(monkeypatch):
    """SV bary macrostar almg continuation: identical Krylov counts
    with the sliced smoother on and off."""
    from alfi_tpu import ScottVogeliusSolver

    def run():
        s = ScottVogeliusSolver(
            TwoDimLidDrivenCavityProblem(8), nref=1, k=2,
            solver_type="almg", hierarchy="bary", patch="macro",
            stabilisation_type="burman", stabilisation_weight=5e-3,
            restriction=True, gamma=1e4, verbose=False)
        out = []
        for re in (1, 100):
            _, info = s.solve(re)
            out.append((re, info["converged"], info["linear_iter"],
                        info["nonlinear_iter"]))
        return out

    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "1")
    with_struct = run()
    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "0")
    without = run()
    assert all(c for _, c, _, _ in with_struct)
    assert with_struct == without


# ----------------------------------------------------------------------
# 3D: per-parity-class slicing (opt-in ALFI_TPU_GEOM_NUMBERING_3D)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ldc3d_level():
    import os

    os.environ["ALFI_TPU_GEOM_NUMBERING_3D"] = "1"
    try:
        from alfi_tpu.problems import ThreeDimLidDrivenCavityProblem

        s = ConstantPressureSolver(
            ThreeDimLidDrivenCavityProblem(4), nref=1, k=2,
            solver_type="almg", hierarchy="uniform", verbose=False)
        yield s.vmg.levels[-1]
    finally:
        os.environ.pop("ALFI_TPU_GEOM_NUMBERING_3D", None)


def test_detects_3d_parity_classes(ldc3d_level):
    """The structured tet lattice slices per parity class: the whole
    interior (here 7^3 = 343 of 729 stars, all 8 classes) is sliced."""
    lev = ldc3d_level
    ps = star_patches(lev.V, np.asarray(lev.mask_flat))
    lay = structured.detect(ps)
    assert lay is not None
    assert lay.ni == 343
    assert len(lay.blocks) == 8


def test_structured_apply_matches_generic_3d(ldc3d_level, monkeypatch):
    lev = ldc3d_level
    ps1 = star_patches(lev.V, np.asarray(lev.mask_flat))
    ps2 = star_patches(lev.V, np.asarray(lev.mask_flat))
    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "1")
    f1, a1 = build_patch_solver(ps1)
    assert getattr(ps1, "layout", None) is not None  # structured ran
    monkeypatch.setenv("ALFI_TPU_STRUCT_PATCH", "0")
    f2, a2 = build_patch_solver(ps2)

    nc = lev.V.mesh.num_cells
    nld = lev.V.cell_dofs.shape[1] * lev.V.value_size
    rng = np.random.default_rng(3)
    T = rng.standard_normal((nc, nld, nld))
    T = T + np.transpose(T, (0, 2, 1)) + 60 * np.eye(nld)
    Tj = jnp.asarray(T)
    r = jnp.asarray(rng.standard_normal(ps1.nflat))
    x1 = np.asarray(a1(f1(Tj), r))
    x2 = np.asarray(a2(f2(Tj), r))
    err = np.abs(x1 - x2).max() / np.abs(x2).max()
    assert err < 1e-11, err
