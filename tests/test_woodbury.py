"""gamma-split (Woodbury) patch/coarse solver tests: the f32
path must agree with the direct f64 factorisation path (docs/DESIGN.md
precision strategy)."""

import jax.numpy as jnp
import numpy as np
import pytest

import alfi_tpu.config as cfg
from alfi_tpu.fem import (
    FunctionSpace,
    MixedFunctionSpace,
    NSForm,
    VectorFunctionSpace,
    dg_lagrange,
    lagrange,
)
from alfi_tpu.fem.bcs import BCSet, DirichletBC
from alfi_tpu.mesh import rectangle_mesh
from alfi_tpu.mg.patches import (
    build_patch_solver,
    build_patch_solver_woodbury,
    star_patches,
)


def make_form(graddiv_mode="cell_avg", n=4, k=2):
    mesh = rectangle_mesh(n, n, 2, 2)
    V = VectorFunctionSpace(mesh, lagrange(2, k))
    Q = FunctionSpace(mesh, dg_lagrange(2, k - 1 if
                                        graddiv_mode == "exact" else 0))
    Z = MixedFunctionSpace(V, Q)
    form = NSForm(V, Q, graddiv_mode=graddiv_mode)
    bcset = BCSet(Z, [DirichletBC(V, (0.0, 0.0), None)])
    return form, bcset


@pytest.mark.parametrize("mode", ["cell_avg", "exact"])
def test_graddiv_factors_reproduce_element_matrices(mode):
    form, _ = make_form(mode)
    params = {"nu": jnp.zeros(()), "gamma": jnp.ones(()),
              "advect": jnp.zeros(())}
    zero = jnp.zeros((form.V.ndof, 2))
    G = form.velocity_element_tensors(params, zero)
    Bt = form.graddiv_factors()
    G2 = jnp.einsum("cip,cjp->cij", Bt, Bt)
    assert float(jnp.max(jnp.abs(G - G2))) < 1e-10


@pytest.mark.parametrize("gamma", [1e2, 1e4, 1e6])
def test_woodbury_patch_solve_matches_direct(gamma):
    form, bcset = make_form("cell_avg")
    mask = np.asarray(bcset.mask[0]).reshape(-1)
    ps = star_patches(form.V, mask)
    wind = jnp.zeros((form.V.ndof, 2))
    params = {"nu": jnp.asarray(0.01), "gamma": jnp.asarray(gamma),
              "advect": jnp.asarray(1.0)}
    paramsM = dict(params, gamma=jnp.zeros(()))
    T_full = form.velocity_element_tensors(params, wind)
    T_M = form.velocity_element_tensors(paramsM, wind)

    f1, a1 = build_patch_solver(ps)
    f2, a2 = build_patch_solver_woodbury(ps, form.graddiv_factors())
    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.normal(size=(form.V.ndof * 2,))) * mask
    x1 = a1(f1(T_full), r)
    x2 = a2(f2(T_M, params["gamma"]), r)
    rel = float(jnp.linalg.norm(x1 - x2) / jnp.linalg.norm(x1))
    # x2 is computed in f32 but with gamma-independent conditioning
    assert rel < 5e-5, (gamma, rel)


def test_woodbury_almg_end_to_end():
    from alfi_tpu import ConstantPressureSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem

    old = cfg._use_woodbury
    cfg.set_use_woodbury(True)
    try:
        problem = TwoDimLidDrivenCavityProblem(4)
        s = ConstantPressureSolver(
            problem, nref=1, k=2, solver_type="almg", hierarchy="uniform",
            gamma=1e4, verbose=False)
        for re in [1, 100]:
            z, info = s.solve(re)
            assert info["converged"], re
            assert info["linear_iter"] <= 20
    finally:
        cfg.set_use_woodbury(old)


@pytest.mark.parametrize("gamma", [1.0, 1e2, 1e4])
def test_woodbury_dense_matches_direct(gamma):
    """The f32 gamma-split dense solve (the ALFI_TPU_WOODBURY coarse
    factor) against the direct f64 solve of M + gamma B B^T."""
    from alfi_tpu.solvers.linear import (
        woodbury_dense_apply,
        woodbury_dense_factor,
    )

    rng = np.random.default_rng(3)
    N, R = 60, 8
    A = rng.normal(size=(N, N))
    M = A @ A.T + N * np.eye(N)
    B = rng.normal(size=(N, R))
    b = rng.normal(size=(N,))
    x = woodbury_dense_apply(
        woodbury_dense_factor(jnp.asarray(M), jnp.asarray(B),
                              jnp.asarray(gamma)), jnp.asarray(b))
    ref = np.linalg.solve(M + gamma * B @ B.T, b)
    rel = float(np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref))
    assert rel < 1e-4, rel
