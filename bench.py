"""Benchmark: ldc2d [P2]^2-P0 almg Reynolds continuation, the reference's
headline workload shape (examples/iters.py) at a single-chip-friendly
size.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": seconds, "unit": "s", "extra": {...}}

Iteration counts — which ARE comparable to the reference's published
tables — are in "extra", along with the Vanka-smoother DoF/s kernel
metric BASELINE.md defines.
"""

import json
import time

RES = [1, 10, 100]


def vanka_dof_throughput(solver):
    """Fine-level patch-smoother application throughput (DoF/s): one
    additive sweep = gather + batched dense apply + scatter over every
    vertex-star patch."""
    import jax
    import jax.numpy as jnp

    vmg = solver.vmg
    L = vmg.nlevels - 1
    params = solver.params()
    static = getattr(solver, "_almg_static", None)
    _, papply = vmg.patch_solvers[L - 1]

    @jax.jit
    def factor(u, p_fine, p):
        # setup returns closures (coarse_solve) — extract only the
        # fine-level patch factorisation as the jit output.  p_fine is
        # passed so the PC being timed is the PRODUCTION operator
        # (stabilised terms included when stabilisation is wired).
        return vmg.setup(u, p, static=static,
                         p_fine=p_fine)["patch_lufacs"][L - 1]

    lufac = factor(solver.z[0], solver.z[1], params)
    # production smoother dtype (config.mg_smooth_dtype): the patch
    # factors are stored and applied in mdt
    cdt = getattr(vmg, "mdt", getattr(vmg, "cdt", solver.z[0].dtype))
    lufac = jax.tree.map(
        lambda a: (a.astype(cdt)
                   if jnp.issubdtype(a.dtype, jnp.floating) else a),
        lufac)
    r = jnp.ones((vmg.levels[L].V.ndof * vmg.d,), dtype=cdt)
    # chain K applications inside ONE jit so the per-dispatch cost does
    # not enter the number — inside the solver the sweep runs fused in
    # the Newton-step program.
    from jax import lax

    K = 32

    @jax.jit
    def run(fac, x):
        return lax.fori_loop(0, K, lambda i, v: papply(fac, v), x)

    @jax.jit
    def empty(x):
        return x + 1.0

    jax.block_until_ready(run(lufac, r))  # compile
    jax.block_until_ready(empty(r))
    n = 5
    best = best0 = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(run(lufac, r))
        best = min(best, time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(empty(r))
        best0 = min(best0, time.perf_counter() - t0)
    dt = max(best - best0, 1e-9) / K
    ndofs = int(vmg.patchsets[L - 1].sizes.sum())
    return ndofs / dt


def main():
    from alfi_tpu import ConstantPressureSolver
    from alfi_tpu.backend import gpu_name_and_power_limit
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem

    problem = TwoDimLidDrivenCavityProblem(16)
    solver = ConstantPressureSolver(
        problem, nref=2, k=2, solver_type="almg", hierarchy="uniform",
        gamma=1e4, verbose=False)

    # warmup: compile every kernel (params-only changes do not retrace)
    solver.solve(1)

    # reset state and time the continuation sweep
    solver.z = solver.bcset.apply(solver.Z.zero())
    solver.z_last = solver.z
    t0 = time.perf_counter()
    total_lin = total_newton = 0
    for re in RES:
        _, info = solver.solve(re)
        assert info["converged"], f"Re={re} diverged"
        total_lin += info["linear_iter"]
        total_newton += info["nonlinear_iter"]
    elapsed = time.perf_counter() - t0

    vanka = vanka_dof_throughput(solver)

    print("card:", gpu_name_and_power_limit())
    print(json.dumps({
        "metric": "ldc2d_pkp0_almg_nref2_re1-100_walltime",
        "value": round(elapsed, 3),
        "unit": "s",
        "extra": {
            "ndof": solver.Z.dim,
            "linear_iters": total_lin,
            "newton_iters": total_newton,
            "krylov_per_newton": round(total_lin / max(1, total_newton), 2),
            "dof_krylov_per_s": round(solver.Z.dim * total_lin / elapsed),
            "vanka_dofs_per_s": round(vanka),
        },
    }))


if __name__ == "__main__":
    main()
