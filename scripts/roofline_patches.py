"""Roofline placement of the Vanka patch-apply hot loop (VERDICT item 8).

The additive sweep's cost model per application:
  bytes  = patch inverses (np*m*m*itemsize, streamed once)
         + gather/scatter vectors (small)
  flops  = 2*np*m*m  (batched matvec)
With m ~ 30 the arithmetic intensity is ~0.25 FLOP/byte (f64) — far
below the H100's ridge point, so the op is HBM-BANDWIDTH-bound and its
speed-of-light time is bytes / 3.35 TB/s (NVIDIA H100 SXM data sheet).
This script measures the actual per-apply time for the f64 path and
the f32 path (ALFI_TPU_PATCH_APPLY=f32) and prints both against that
bound, plus the whole-solve effect (iteration counts must not move for
f32 to be legitimate).
"""

import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])



def measure(solver):
    import jax
    import jax.numpy as jnp

    vmg = solver.vmg
    L = vmg.nlevels - 1
    params = solver.params()
    static = getattr(solver, "_almg_static", None)
    _, papply = vmg.patch_solvers[L - 1]

    @jax.jit
    def factor(u, p):
        return vmg.setup(u, p, static=static)["patch_lufacs"][L - 1]

    lufac = factor(solver.z[0], params)
    jax.block_until_ready(lufac)
    r = jnp.ones((vmg.levels[L].V.ndof * vmg.d,),
                 dtype=solver.z[0].dtype)
    # chain K applies inside ONE jit: one-shot timing would measure
    # the dispatch, not the op
    from jax import lax

    K = 32

    @jax.jit
    def run(fac, x):
        return lax.fori_loop(0, K, lambda i, v: papply(fac, v), x)

    jax.block_until_ready(run(lufac, r))
    n = 5
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(run(lufac, r))
        best = min(best, time.perf_counter() - t0)
    dt = best / K

    ps = vmg.patchsets[L - 1]
    inv = lufac if not isinstance(lufac, tuple) else lufac[0]
    itemsize = jnp.asarray(inv).dtype.itemsize
    npat, m = ps.npatches, ps.m
    bytes_inv = npat * m * m * itemsize
    # honest per-apply HBM traffic: inverses + index tables (dof
    # gather (np, m) int32 + scatter table (nflat, mu) int32) + the
    # gathered/scattered vectors themselves
    nflat = ps.nflat
    mu = 7  # typical scatter-table multiplicity at these shapes
    bytes_idx = npat * m * 4 + nflat * mu * 4
    bytes_vec = (npat * m + nflat * 2) * 4
    bytes_total = bytes_inv + bytes_idx + bytes_vec
    flops = 2 * npat * m * m
    sol_s = bytes_total / 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
    ndofs = int(ps.sizes.sum())
    return {
        "apply_ms": round(dt * 1e3, 3),
        "speed_of_light_ms": round(sol_s * 1e3, 3),
        "frac_of_HBM_bound": round(sol_s / dt, 3),
        "patch_dofs_per_s": round(ndofs / dt),
        "npatches": npat, "m": m,
        "inv_dtype": str(jnp.asarray(inv).dtype),
        "bytes_inverses": bytes_inv,
        "bytes_total": bytes_total,
        "flops_per_apply": flops,
    }


def main(nref=2, dim=2):
    from alfi_tpu import ConstantPressureSolver

    if dim == 3:
        # the 3D shapes VERDICT r4 item 3 asks for: ldc3d [P2+FB]^3
        # star patches (m ~ 135 at nref>=1); per-parity-class slicing
        # needs the 3D geometric numbering (mesh/renumber.py)
        import os as _os

        _os.environ.setdefault("ALFI_TPU_GEOM_NUMBERING_3D", "1")
        from alfi_tpu.problems import ThreeDimLidDrivenCavityProblem

        solver = ConstantPressureSolver(
            ThreeDimLidDrivenCavityProblem(4), nref=nref, k=2,
            solver_type="almg", hierarchy="uniform", gamma=1e4,
            verbose=False)
    else:
        from alfi_tpu.problems import TwoDimLidDrivenCavityProblem

        solver = ConstantPressureSolver(
            TwoDimLidDrivenCavityProblem(16), nref=nref, k=2,
            solver_type="almg", hierarchy="uniform", gamma=1e4,
            verbose=False)
    solver.advect_val = 1.0
    solver.nu_val = solver.char_L * solver.char_U / 100.0
    print(json.dumps({"nref": nref, "dim": dim, **measure(solver)}))


def run_variants(nref, dim=2):
    """Measure every patch-apply variant in its own subprocess (the
    factorisation binds ALFI_TPU_PATCH_APPLY once per process):

      ""     f64 emulated einsum, batch-major (np, m, m)
      f32    f32 einsum, batch-major
      f32t   f32 patch-minor (m, m, np) XLA multiply-reduce

    The batch-major layouts are physically padded by XLA's (8, 128)
    minor-dim tiling (2.5-9x at patch sizes), so the roofline
    'frac_of_HBM_bound' computed from LOGICAL bytes understates them;
    the patch-minor variants are the ones that can actually reach it."""
    import os
    import subprocess

    # (name, ALFI_TPU_PATCH_APPLY, ALFI_TPU_STRUCT_PATCH): the table
    # variants pin STRUCT=0 so the gather/scatter comparison is honest
    # now that the sliced path is the default (mg/structured.py)
    variants = [
        ("f64", "", "0"),
        ("f32", "f32", "0"),
        ("f32t", "f32t", "0"),
        ("f32s", "f32s", "0"),
        ("struct", "", "1"),
        ("struct-f32", "f32t", "1"),
        ("struct-f32s", "f32st", "1"),
    ]
    only = os.environ.get("ROOFLINE_ONLY")  # substring filter
    for name, app, struct in variants:
        if only and only not in name:
            continue
        env = dict(os.environ, ALFI_TPU_PATCH_APPLY=app,
                   ALFI_TPU_STRUCT_PATCH=struct)
        r = subprocess.run(
            [sys.executable, __file__, str(nref), "--one"]
            + (["--dim3"] if dim == 3 else []),
            env=env, capture_output=True, text=True, timeout=3600)
        line = (r.stdout.strip().splitlines() or ["{}"])[-1]
        try:
            payload = json.loads(line)
        except json.JSONDecodeError:
            payload = {}
        print(json.dumps({"variant": name, **payload}), flush=True)
        if r.returncode != 0:
            print(json.dumps({"variant": name,
                              "error": r.stderr[-800:]}), flush=True)


if __name__ == "__main__":
    nref = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dim = 3 if "--dim3" in sys.argv else 2
    if "--one" in sys.argv:
        main(nref, dim)
    else:
        run_variants(nref, dim)
