"""On-card A/B of the backend policy's GPU choices, plus bring-up checks.

Every arm runs a chip_smoke phase (ldc2d_pkp0: nref=3, Re 1, 10, 100)
in a process of its own: one warm-up solve at Re=1 (compiles), then the
sweep twice from a cold state, each timed with the device synchronised.
Both sweeps must give identical counts; a state that differs between
them in any bit is reported (``bitwise_repeat``).  An arm sets
environment knobs for its process.  Arms run one after another, each
bounded by --timeout seconds.

    python scripts/gpu_ab.py lu                 # native f64 LU, patch shapes
    python scripts/gpu_ab.py ab [ARM ...]       # A/B arms, one process each
    python scripts/gpu_ab.py fit                # nref=4 2D / nref=2 3D, Re=1
    python scripts/gpu_ab.py knobs [--jobs 4]   # every ALFI_TPU_* arm runs

Results go to stdout as ``RESULT {json}`` lines.  ``knobs`` runs several
processes on the card at once, each with XLA_PYTHON_CLIENT_MEM_FRACTION
set to its share; it checks only that each arm converges.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: arm -> (environment, phase); "base" is the default configuration
ARMS = {
    "base": ({}, "ldc2d_pkp0"),
    "patch_lu": ({"ALFI_TPU_PATCH_DTYPE": "lu"}, "ldc2d_pkp0"),
    "struct": ({"ALFI_TPU_STRUCT_PATCH": "1"}, "ldc2d_pkp0"),
    "dc32": ({"ALFI_TPU_MG_SMOOTH_DTYPE": "f32"}, "ldc2d_pkp0"),
    "tables": ({"ALFI_TPU_GATHER_SUM": "1"}, "ldc2d_pkp0"),
    "scatter_deterministic": (
        {"XLA_FLAGS": "--xla_gpu_deterministic_ops=true"}, "ldc2d_pkp0"),
    "dc32_3d": ({"ALFI_TPU_MG_SMOOTH_DTYPE": "f32"}, "ldc3d_p2fb"),
    "base_3d": ({}, "ldc3d_p2fb"),
}

#: knob arms: (environment) — each must converge at ldc2d nref=2, Re=1
KNOBS = [
    {"ALFI_TPU_PATCH_APPLY": v}
    for v in ("f32", "f32t", "t", "f32s", "f32st")
] + [
    {"ALFI_TPU_PATCH_DTYPE": v} for v in ("f32", "lu64", "lu")
] + [
    {"ALFI_TPU_LEVEL_APPLY": "t"},
    {"ALFI_TPU_MG_DTYPE": "f32"},
    {"ALFI_TPU_MG_STORE": "f32"},
    {"ALFI_TPU_WOODBURY": "1"},
    {"ALFI_TPU_STRUCT_PATCH": "1"},
    {"ALFI_TPU_GATHER_SUM": "1"},
]


def _result(**kw):
    print("RESULT " + json.dumps(kw), flush=True)


def _digest(z):
    import numpy as np

    h = hashlib.sha256()
    for a in z:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def run_arm(name, extra=()):
    """One A/B arm in this process (its environment set by the
    parent)."""
    import jax

    import chip_smoke

    phase = ARMS[name][1]
    solver, args, res = chip_smoke.build(phase, extra)
    t0 = time.perf_counter()
    _, info = solver.solve(res[0])
    jax.block_until_ready(solver.z)
    warm = time.perf_counter() - t0
    sweeps = []
    for _ in range(2):
        solver.z = solver.bcset.apply(solver.Z.zero())
        solver.z_last = solver.z
        t0 = time.perf_counter()
        steps = {}
        for re in res:
            _, info = solver.solve(re)
            steps[str(re)] = [int(info["nonlinear_iter"]),
                              int(info["linear_iter"]),
                              bool(info["converged"])]
        jax.block_until_ready(solver.z)
        sweeps.append((time.perf_counter() - t0, steps, _digest(solver.z)))
    stats = jax.devices()[0].memory_stats() or {}
    _result(arm=name, phase=phase, dofs=int(solver.Z.dim),
            warmup_s=round(warm, 3),
            sweep_s=[round(s[0], 3) for s in sweeps],
            steps=sweeps[0][1],
            repeat_counts_equal=sweeps[0][1] == sweeps[1][1],
            bitwise_repeat=sweeps[0][2] == sweeps[1][2],
            peak_bytes_in_use=stats.get("peak_bytes_in_use"))


def run_once(phase, extra, res):
    """Build and solve ``res`` once (fit attempts, knob arms)."""
    import jax

    import chip_smoke

    t0 = time.perf_counter()
    solver, args, _ = chip_smoke.build(phase, extra)
    steps = {}
    for re in res:
        _, info = solver.solve(re)
        steps[str(re)] = [int(info["nonlinear_iter"]),
                          int(info["linear_iter"]),
                          bool(info["converged"])]
    jax.block_until_ready(solver.z)
    stats = jax.devices()[0].memory_stats() or {}
    return dict(dofs=int(solver.Z.dim), steps=steps,
                seconds=round(time.perf_counter() - t0, 3),
                peak_bytes_in_use=stats.get("peak_bytes_in_use"),
                bytes_limit=stats.get("bytes_limit"))


def lu_check():
    """Native batched f64 LU (jax.scipy.linalg.lu_factor) at the patch
    shapes: error against numpy and time per factorisation."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    for npat, m in ((16641, 14), (16641, 50), (4225, 62), (729, 135),
                    (729, 190), (4913, 189)):
        rng = np.random.default_rng(m)
        A = rng.standard_normal((npat, m, m)) + m * np.eye(m)
        b = rng.standard_normal((npat, m))
        Aj, bj = jnp.asarray(A), jnp.asarray(b)
        fac = jax.jit(jax.scipy.linalg.lu_factor)
        sol = jax.jit(lambda f, r: jax.scipy.linalg.lu_solve(
            f, r[..., None])[..., 0])
        f = jax.block_until_ready(fac(Aj))
        x = jax.block_until_ready(sol(f, bj))
        t0 = time.perf_counter()
        for _ in range(5):
            f = fac(Aj)
        jax.block_until_ready(f)
        tf = (time.perf_counter() - t0) / 5
        t0 = time.perf_counter()
        for _ in range(20):
            x = sol(f, bj)
        jax.block_until_ready(x)
        ts = (time.perf_counter() - t0) / 20
        k = min(npat, 64)
        ref = np.linalg.solve(A[:k], b[:k, :, None])[..., 0]
        err = float(np.abs(np.asarray(x[:k]) - ref).max()
                    / np.abs(ref).max())
        _result(lu=[npat, m], dtype=str(f[0].dtype), rel_err=err,
                factor_ms=round(tf * 1e3, 3), solve_ms=round(ts * 1e3, 3))


def _spawn(argv, env=None):
    return subprocess.Popen([sys.executable, __file__] + argv,
                            env=dict(os.environ, **(env or {})), cwd=REPO)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["lu", "ab", "arm", "fit", "fit1",
                                     "knobs", "knob1"])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds per A/B arm")
    opts = ap.parse_intermixed_args()

    if opts.mode == "ab":
        for name in opts.names or list(ARMS):
            p = _spawn(["arm", name], ARMS[name][0])
            try:
                rc = p.wait(timeout=opts.timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rc = "timeout %ds" % opts.timeout
            if rc:
                _result(arm=name, failed_rc=rc)
        return 0
    if opts.mode == "fit":
        for name in ("ldc2d_pkp0:4", "ldc3d_p2fb:2"):
            rc = _spawn(["fit1", name]).wait()
            if rc:
                _result(fit=name, failed_rc=rc)
        return 0
    if opts.mode == "knobs":
        frac = "%.2f" % (0.9 / opts.jobs)
        running, queue = [], list(enumerate(KNOBS))
        while queue or running:
            while queue and len(running) < opts.jobs:
                i, env = queue.pop(0)
                running.append((env, _spawn(
                    ["knob1", str(i)],
                    dict(env, XLA_PYTHON_CLIENT_MEM_FRACTION=frac))))
            time.sleep(1)
            for env, p in list(running):
                if p.poll() is not None:
                    running.remove((env, p))
                    if p.returncode:
                        _result(knob=env, failed_rc=p.returncode)
        return 0

    import jax

    import alfi_tpu  # noqa: F401

    if jax.default_backend() != "gpu":
        print("gpu_ab: JAX found no GPU", file=sys.stderr)
        return 1
    if opts.mode == "lu":
        lu_check()
    elif opts.mode == "arm":
        run_arm(opts.names[0])
    elif opts.mode == "fit1":
        phase, nref = opts.names[0].split(":")
        _result(fit=opts.names[0],
                **run_once(phase, ["--nref", nref], [1]))
    elif opts.mode == "knob1":
        env = KNOBS[int(opts.names[0])]
        _result(knob=env, **run_once("ldc2d_pkp0", ["--nref", "2"], [1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
