"""shard_map-distributed almg vs the global single-program solver.

The decomposition (parallel/decompose.py) + distributed step
(parallel/distributed.py) must reproduce the global almg solver
bitwise-close (identical FGMRES iteration counts; dz equal to summation-
order roundoff) on the virtual 8-device CPU mesh — the single-process
equivalent of the reference's `mpirun -n N` checks (SURVEY.md §4)."""

import numpy as np
import pytest

from alfi_tpu import ConstantPressureSolver, ScottVogeliusSolver
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem
from alfi_tpu.parallel import make_device_mesh
from alfi_tpu.parallel.distributed import DistributedSolver


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300)


def _make(cls, re=10.0, **kw):
    problem = TwoDimLidDrivenCavityProblem(4)
    solver = cls(problem, nref=1, k=2, solver_type="almg", gamma=1e4,
                 verbose=False, **kw)
    solver.advect_val = 1.0
    solver.nu_val = solver.char_L * solver.char_U / re
    return solver


CASES = [
    (ConstantPressureSolver, 10.0,
     dict(hierarchy="uniform", patch="star")),
    (ScottVogeliusSolver, 10.0, dict(hierarchy="bary", patch="macro")),
    # the flagship high-Re configuration: SUPG in the residual, the
    # Jacobian AND the MG/patch operators (VERDICT round-1 item 1)
    (ConstantPressureSolver, 1000.0,
     dict(hierarchy="uniform", patch="star",
          stabilisation_type="supg")),
    (ConstantPressureSolver, 1000.0,
     dict(hierarchy="uniform", patch="star", stabilisation_type="gls")),
    # SV production config: Burman in the residual, the Jacobian AND
    # the facet-coupled PC, distributed (owned-facet scatters + psum)
    (ScottVogeliusSolver, 100.0,
     dict(hierarchy="bary", patch="macro", stabilisation_type="burman",
          stabilisation_weight=5e-3)),
]


@pytest.mark.parametrize("cls,re,kw", CASES,
                         ids=["pkp0-star", "sv-macrostar",
                              "pkp0-supg-re1000", "pkp0-gls-re1000",
                              "sv-burman-re100"])
def test_distributed_linear_step_matches_global(cls, re, kw):
    solver = _make(cls, re=re, **kw)
    # a nonzero state so the stabilised terms are exercised off the
    # trivial wind (one global Newton step from rest)
    params0 = solver.params()
    F0 = solver.residual_masked(solver.z, params0)
    tstate0 = solver._transfer_setup(params0)
    dz0, _ = solver._linear_step(solver.z, F0, params0, tstate0)
    solver.z = (solver.z[0] + dz0[0], solver.z[1] + dz0[1])
    solver.z_last = solver.z

    params = solver.params()
    params.pop("wind", None)
    mesh = make_device_mesh(8)
    dist = DistributedSolver(solver, mesh)
    z, _ = dist.shard_state(solver.z, params)
    wind = (dist._shard_u(solver.z_last[0])
            if solver.stabilisation is not None else None)

    Fd, fnorm_d = dist.residual(z, params, wind)
    Fg = solver.residual_masked(solver.z, solver.params())
    Fd_g = dist.gather_state(Fd)
    assert rel(Fd_g[0], Fg[0]) < 5e-13
    assert rel(Fd_g[1], Fg[1]) < 5e-13

    tstate_g = solver._transfer_setup(params)
    dz_g, its_g = solver._linear_step(solver.z, Fg, solver.params(),
                                      tstate_g)
    dz_d, its_d = dist.linear_step(z, Fd, params,
                                   dist.transfer_setup(params), wind)
    assert its_d == int(its_g)
    dz_dg = dist.gather_state(dz_d)
    assert rel(dz_dg[0], dz_g[0]) < 1e-9
    assert rel(dz_dg[1], dz_g[1]) < 1e-9


def test_distributed_multiplicative_matches_global():
    """Ordered multiplicative patch sweeps (per-color additive
    sub-sweeps with halo exchange between colors) vs the global
    multiplicative solver."""
    solver = _make(ConstantPressureSolver, hierarchy="uniform",
                   patch="star", patch_composition="multiplicative")
    params = solver.params()
    mesh = make_device_mesh(8)
    dist = DistributedSolver(solver, mesh)
    assert dist.multiplicative
    z, _ = dist.shard_state(solver.z, params)
    Fd, _ = dist.residual(z, params)
    Fg = solver.residual_masked(solver.z, params)
    tstate_g = solver._transfer_setup(params)
    dz_g, its_g = solver._linear_step(solver.z, Fg, params, tstate_g)
    dz_d, its_d = dist.linear_step(z, Fd, params,
                                   dist.transfer_setup(params))
    assert its_d == int(its_g)
    dz_dg = dist.gather_state(dz_d)
    assert rel(dz_dg[0], dz_g[0]) < 1e-9
    assert rel(dz_dg[1], dz_g[1]) < 1e-9


def test_distributed_woodbury_matches_global():
    """gamma-split f32 patch + coarse solves distributed vs global (the
    f32 PC makes the FGMRES trajectory precision-sensitive; counts must
    agree within 1 and the step to outer-tolerance accuracy)."""
    from alfi_tpu.config import set_use_woodbury, use_woodbury

    prev = use_woodbury()
    set_use_woodbury(True)
    try:
        solver = _make(ConstantPressureSolver, hierarchy="uniform",
                       patch="star")
        assert solver.vmg.use_woodbury
        params = solver.params()
        mesh = make_device_mesh(8)
        dist = DistributedSolver(solver, mesh)
        assert dist.use_woodbury
        z, _ = dist.shard_state(solver.z, params)
        Fd, _ = dist.residual(z, params)
        Fg = solver.residual_masked(solver.z, params)
        tstate_g = solver._transfer_setup(params)
        dz_g, its_g = solver._linear_step(solver.z, Fg, params,
                                          tstate_g)
        dz_d, its_d = dist.linear_step(z, Fd, params,
                                       dist.transfer_setup(params))
        assert abs(its_d - int(its_g)) <= 1
        dz_dg = dist.gather_state(dz_d)
        assert rel(dz_dg[0], dz_g[0]) < 1e-6
        assert rel(dz_dg[1], dz_g[1]) < 1e-6
    finally:
        set_use_woodbury(prev)


@pytest.mark.slow
def test_distributed_sv_macrostar_continuation():
    """Full SV/macrostar continuation solve distributed vs global
    (VERDICT round-1 item 6: not just a linear step)."""
    solver = _make(ScottVogeliusSolver, hierarchy="bary", patch="macro")
    mesh = make_device_mesh(8)
    dist = DistributedSolver(solver, mesh)
    _, info = dist.solve(10)
    assert info["converged"]

    ref = _make(ScottVogeliusSolver, hierarchy="bary", patch="macro")
    _, info_g = ref.solve(10)
    assert info["linear_iter"] == info_g["linear_iter"]
    assert info["nonlinear_iter"] == info_g["nonlinear_iter"]
    assert rel(solver.z[0], ref.z[0]) < 1e-10
    assert rel(solver.z[1], ref.z[1]) < 1e-8


def test_distributed_supg_continuation_solve():
    """Full stabilised continuation step distributed vs global (same
    iteration counts, matching states)."""
    solver = _make(ConstantPressureSolver, hierarchy="uniform",
                   patch="star", stabilisation_type="supg")
    mesh = make_device_mesh(8)
    dist = DistributedSolver(solver, mesh)
    _, info = dist.solve(100)
    assert info["converged"]

    ref = _make(ConstantPressureSolver, hierarchy="uniform",
                patch="star", stabilisation_type="supg")
    _, info_g = ref.solve(100)
    assert info["linear_iter"] == info_g["linear_iter"]
    assert info["nonlinear_iter"] == info_g["nonlinear_iter"]
    assert rel(solver.z[0], ref.z[0]) < 1e-10
    assert rel(solver.z[1], ref.z[1]) < 1e-8


def test_distributed_dc32_smoother_matches_global():
    """Defect-correction f32 smoother (config.mg_smooth_dtype, dc32) in the shard_map path: distributed and global solvers
    under the same mdt must agree in iteration counts and state."""
    import jax.numpy as jnp

    from alfi_tpu.config import real_dtype, set_mg_smooth_dtype

    set_mg_smooth_dtype(jnp.float32)
    try:
        solver = _make(ConstantPressureSolver, hierarchy="uniform",
                       patch="star", stabilisation_type="supg")
        mesh = make_device_mesh(8)
        dist = DistributedSolver(solver, mesh)
        _, info = dist.solve(100)
        assert info["converged"]

        ref = _make(ConstantPressureSolver, hierarchy="uniform",
                    patch="star", stabilisation_type="supg")
        _, info_g = ref.solve(100)
    finally:
        set_mg_smooth_dtype(real_dtype)
    assert info["linear_iter"] == info_g["linear_iter"]
    assert info["nonlinear_iter"] == info_g["nonlinear_iter"]
    assert rel(solver.z[0], ref.z[0]) < 1e-10
    assert rel(solver.z[1], ref.z[1]) < 1e-8


def test_distributed_continuation_solve():
    solver = _make(ConstantPressureSolver, hierarchy="uniform",
                   patch="star")
    mesh = make_device_mesh(8)
    dist = DistributedSolver(solver, mesh)
    _, info = dist.solve(10)
    assert info["converged"]

    ref = _make(ConstantPressureSolver, hierarchy="uniform", patch="star")
    _, info_g = ref.solve(10)
    assert info["linear_iter"] == info_g["linear_iter"]
    assert info["nonlinear_iter"] == info_g["nonlinear_iter"]
    assert rel(solver.z[0], ref.z[0]) < 1e-10
    assert rel(solver.z[1], ref.z[1]) < 1e-8


def test_make_device_mesh_refuses_truncation():
    import jax

    n = len(jax.devices())
    with pytest.raises(RuntimeError):
        make_device_mesh(n + 1)


def test_rebalance_rcb_partition():
    """--rebalance switches to recursive coordinate bisection: on the
    reference's unstructured bfs mesh the block sizes are exactly
    balanced and the interface (cells adjacent to another block) is no
    worse than the lexsort chunks; the distributed step still matches
    the global solver."""
    import os

    from alfi_tpu.mesh import gmsh_read
    from alfi_tpu.parallel.decompose import (
        coarse_partition,
        rcb_partition,
        vertex_cells_csr,
    )

    mesh = gmsh_read(os.path.join(os.path.dirname(__file__), "fixtures",
                                  "bfs2d_coarse12.msh"))
    nb = 8
    for part in (coarse_partition(mesh, nb), rcb_partition(mesh, nb)):
        counts = np.bincount(part, minlength=nb)
        assert counts.min() > 0

    def interface(part):
        starts, cv = vertex_cells_csr(mesh)
        bad = 0
        for v in range(mesh.num_vertices):
            blocks = part[cv[starts[v]:starts[v + 1]]]
            bad += int(blocks.min() != blocks.max())
        return bad

    lex, rcb = coarse_partition(mesh, nb), rcb_partition(mesh, nb)
    c = np.bincount(rcb, minlength=nb)
    assert c.max() - c.min() <= 1  # exact halving
    assert interface(rcb) <= 1.2 * interface(lex)

    # solver correctness with the rcb decomposition
    solver = _make(ConstantPressureSolver, hierarchy="uniform",
                   patch="star", rebalance_vertices=True)
    mesh8 = make_device_mesh(8)
    dist = DistributedSolver(solver, mesh8)
    assert dist.partitioner == "rcb"
    params = solver.params()
    z, _ = dist.shard_state(solver.z, params)
    Fd, _ = dist.residual(z, params)
    Fg = solver.residual_masked(solver.z, params)
    dz_g, its_g = solver._linear_step(
        solver.z, Fg, params, solver._transfer_setup(params))
    dz_d, its_d = dist.linear_step(z, Fd, params,
                                   dist.transfer_setup(params))
    assert its_d == int(its_g)
    dz_dg = dist.gather_state(dz_d)
    assert rel(dz_dg[0], dz_g[0]) < 1e-9


def test_load_balance_report(capsys):
    """The reference's load_balance analogue: per-device owned cells and
    fine-level velocity dofs, balanced within a reasonable ratio by the
    coarse partition."""
    import numpy as np

    from alfi_tpu import ConstantPressureSolver
    from alfi_tpu.parallel.distributed import DistributedSolver
    from alfi_tpu.parallel.sharding import make_device_mesh
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem

    s = ConstantPressureSolver(
        TwoDimLidDrivenCavityProblem(8), nref=1, k=2,
        solver_type="almg", hierarchy="uniform", verbose=False)
    dist = DistributedSolver(s, make_device_mesh(4))
    stats = dist.load_balance()
    out = capsys.readouterr().out
    assert "Load balance" in out
    for name, c in stats.items():
        assert c.sum() > 0
        assert len(c) == 4
        # partition is balanced (generous bound: coarse blocks on a
        # small mesh)
        assert c.max() <= 3 * max(1, c.min()), (name, c)


def test_distributed_p1fb_bubble_matches_global():
    """[P1+FB]^3 distributed (the reference's LARGEST production config,
    p1fb_ldc3d at 12,288 ranks): the BubbleTransfer flux fix rides the
    block-local transfers as a matrix-weighted gather table
    (BubbleTransfer.as_table + split_transfer), exact vs the global
    solver."""
    from alfi_tpu.problems import ThreeDimLidDrivenCavityProblem

    problem = ThreeDimLidDrivenCavityProblem(2)
    solver = ConstantPressureSolver(
        problem, nref=1, k=1, solver_type="almg", hierarchy="uniform",
        gamma=1e4, verbose=False)
    assert solver.Z.V.element.name == "P1FB"
    assert not hasattr(solver.vmg.prolongs[0], "idx")  # bubble transfer
    solver.advect_val = 1.0
    solver.nu_val = solver.char_L * solver.char_U / 10.0

    params = solver.params()
    mesh = make_device_mesh(8)
    dist = DistributedSolver(solver, mesh)
    z, _ = dist.shard_state(solver.z, params)
    Fd, _ = dist.residual(z, params)
    Fg = solver.residual_masked(solver.z, params)
    Fd_g = dist.gather_state(Fd)
    assert rel(Fd_g[0], Fg[0]) < 5e-13
    tstate_g = solver._transfer_setup(params)
    dz_g, its_g = solver._linear_step(solver.z, Fg, params, tstate_g)
    dz_d, its_d = dist.linear_step(z, Fd, params,
                                   dist.transfer_setup(params))
    assert its_d == int(its_g)
    dz_dg = dist.gather_state(dz_d)
    assert rel(dz_dg[0], dz_g[0]) < 1e-9
    assert rel(dz_dg[1], dz_g[1]) < 1e-9
