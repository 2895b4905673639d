"""Smoke test of the almg Navier-Stokes solver on an NVIDIA GPU.

Drives upstream's documented configurations through the normal entry
points (``get_default_parser`` / ``get_solver`` / ``run_solver``, as
examples/iters.py does), checks that every continuation step converges
with Newton and Krylov counts equal to the golden counts minted on the
CPU (tests/fixtures/chip_smoke_golden.json, written by
scripts/mint_smoke_golden.py), and prints one JSON line last.

    python chip_smoke.py               # the phases below, one card
    python chip_smoke.py --four-cards  # ldc2d nref=3 via --ndevices 4
                                       # against the one-card solver

Phases (one card):

* ldc2d_pkp0 — ``iters2dpkp0`` pins (SUPG shakib, star patches,
  --restriction, gamma=1e4, baseN=16, k=2) at nref=3, Re 1, 10, 100;
* ldc3d_p2fb — [P2+FB]^3-P0 with the generate_submission pins (SUPG
  0.05, smoothing 10), baseN=4, nref=1, Re 1, 10;
* ldc2d_sv — ``iters2dsv`` pins (bary, macrostar, Burman 5e-3), nref=1,
  Re 1, 10;
* bfs2d_host_coarse — tests/fixtures/bfs2d_coarse12.msh at nref=1: its
  coarse grid exceeds the dense cap, so the host sparse LU runs through
  ``pure_callback``; Re 1, 10.

There is no CPU fallback: without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "fixtures", "chip_smoke_golden.json")

_LDC2D = ["--discretisation", "pkp0", "--baseN", "16", "--k", "2",
          "--solver-type", "almg", "--mh", "uniform", "--patch", "star",
          "--stabilisation-type", "supg", "--restriction",
          "--gamma", "1e4"]

#: name -> (problem, CLI arguments, Reynolds continuation)
PHASES = {
    "ldc2d_pkp0": ("ldc2d", _LDC2D + ["--nref", "3"], [1, 10, 100]),
    "ldc3d_p2fb": ("ldc3d", [
        "--discretisation", "pkp0", "--baseN", "4", "--k", "2",
        "--nref", "1", "--solver-type", "almg", "--mh", "uniform",
        "--patch", "star", "--stabilisation-type", "supg",
        "--stabilisation-weight", "0.05", "--smoothing", "10",
        "--restriction"], [1, 10]),
    "ldc2d_sv": ("ldc2d", [
        "--discretisation", "sv", "--baseN", "12", "--k", "2",
        "--nref", "1", "--solver-type", "almg", "--mh", "bary",
        "--patch", "macro", "--stabilisation-type", "burman",
        "--stabilisation-weight", "5e-3", "--restriction"], [1, 10]),
    "bfs2d_host_coarse": ("bfs2d", [
        "--mesh", os.path.join(HERE, "tests", "fixtures",
                               "bfs2d_coarse12.msh"),
        "--discretisation", "pkp0", "--k", "2", "--nref", "1",
        "--solver-type", "almg", "--mh", "uniform", "--patch", "star",
        "--stabilisation-type", "supg", "--restriction"], [1, 10]),
}

#: the --four-cards comparison: ldc2d nref=3, Re 1 -> 10
FOUR_CARD_RES = [1, 10]
#: relative tolerance between the 4-card and 1-card states: both
#: solves stop at ksp_rtol 1e-9 / snes_atol 1e-8, and the distributed
#: dots sum in another order, so agreement is bounded by the solver
#: tolerances, not by round-off
FOUR_CARD_RTOL = 1e-6

#: lowering and XLA compilation (persistent-cache loads included); jaxpr
#: tracing is left out because nested jits report it more than once
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_seconds = [0.0]
_listening = []


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_seconds[0] += duration


def _listen():
    """Sum JAX's compile-duration events into ``_compile_seconds``."""
    if not _listening:
        import jax

        jax.monitoring.register_event_duration_secs_listener(_on_duration)
        _listening.append(True)


def build(name, extra=()):
    """(solver, args, Re list) for phase ``name`` through the CLI entry
    points; ``extra`` appends CLI arguments (e.g. --ndevices)."""
    from alfi_tpu import get_default_parser, get_solver
    from alfi_tpu.problems import (
        ThreeDimLidDrivenCavityProblem,
        TwoDimBackwardsFacingStepProblem,
        TwoDimLidDrivenCavityProblem,
    )

    kind, argv, res = PHASES[name]
    parser = get_default_parser()
    parser.add_argument("--mesh", type=str)
    args = parser.parse_args(list(argv) + list(extra))
    if kind == "ldc2d":
        problem = TwoDimLidDrivenCavityProblem(args.baseN)
    elif kind == "ldc3d":
        problem = ThreeDimLidDrivenCavityProblem(args.baseN)
    else:
        problem = TwoDimBackwardsFacingStepProblem(args.mesh)
    return get_solver(args, problem), args, res


def run_phase(name, res=None, extra=()):
    """Run one phase; returns its record (dofs, seconds, counts)."""
    import jax

    from alfi_tpu import run_solver

    _listen()
    c0, t0 = _compile_seconds[0], time.perf_counter()
    solver, args, default_res = build(name, extra)
    results = run_solver(solver, res or default_res, args)
    wall = time.perf_counter() - t0
    compile_s = _compile_seconds[0] - c0
    stats = jax.devices()[0].memory_stats() or {}
    rec = {
        "dofs": int(solver.Z.dim),
        "compile_s": round(compile_s, 3),
        "solve_s": round(wall - compile_s, 3),
        # JAX cannot reset the peak, so this is the process's
        # high-water mark on the first card up to the end of this phase
        "process_peak_bytes": stats.get("peak_bytes_in_use"),
        "steps": {str(re): [int(r["nonlinear_iter"]),
                            int(r["linear_iter"]), bool(r["converged"])]
                  for re, r in results.items()},
    }
    print("PHASE %s %s" % (name, json.dumps(rec)), flush=True)
    return solver, rec


def compare(measured, golden):
    """Mismatches (strings) between measured phase records and golden
    counts: dofs, and per Re (newton, krylov, converged)."""
    bad = []
    for name, rec in measured.items():
        gold = golden.get(name)
        if gold is None:
            bad.append("%s: no golden counts" % name)
            continue
        if rec["dofs"] != gold["dofs"]:
            bad.append("%s: dofs %d != golden %d"
                       % (name, rec["dofs"], gold["dofs"]))
        for re, step in rec["steps"].items():
            if not step[2]:
                bad.append("%s Re=%s: not converged" % (name, re))
            want = gold["steps"].get(re)
            if want is None or list(step) != list(want):
                bad.append("%s Re=%s: (newton, krylov, converged) %s != "
                           "golden %s" % (name, re, step, want))
    return bad


def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def four_cards():
    """ldc2d nref=3 through --ndevices 4 against the one-card solver;
    returns a list of failures."""
    bad = []
    ref, rec1 = run_phase("ldc2d_pkp0", res=FOUR_CARD_RES)
    dist, rec4 = run_phase("ldc2d_pkp0", res=FOUR_CARD_RES,
                           extra=["--ndevices", "4"])
    mesh_devs = {d.id for d in dist.mesh.devices.flat}
    u_sharded, _ = dist.shard_state(dist.solver.z)
    shard_devs = {s.device.id for s in u_sharded.addressable_shards}
    print("four-cards: mesh devices %s, velocity shards on %s"
          % (sorted(mesh_devs), sorted(shard_devs)), flush=True)
    if len(mesh_devs) != 4 or len(shard_devs) != 4:
        bad.append("shards not on four distinct cards")
    if rec1["steps"] != rec4["steps"]:
        bad.append("counts differ: 1 card %s, 4 cards %s"
                   % (rec1["steps"], rec4["steps"]))
    du = _rel(dist.solver.z[0], ref.z[0])
    dp = _rel(dist.solver.z[1], ref.z[1])
    print("four-cards: relative state difference u %.3e p %.3e "
          "(tolerance %.0e)" % (du, dp, FOUR_CARD_RTOL), flush=True)
    if not (du <= FOUR_CARD_RTOL and dp <= FOUR_CARD_RTOL):
        bad.append("state differs beyond %.0e" % FOUR_CARD_RTOL)
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run ldc2d nref=3 via --ndevices 4 against "
                         "one card, and nothing else")
    opts = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print("chip_smoke: JAX found no GPU (backend %r); there is no "
              "CPU fallback" % jax.default_backend(), file=sys.stderr)
        return 1

    import alfi_tpu  # noqa: F401  (sets precision, x64, compile cache)
    from alfi_tpu.backend import gpu_name_and_power_limit

    dev = jax.devices()[0]
    print("card: %s" % gpu_name_and_power_limit(), flush=True)
    print("jax %s, %d x %s, bytes_limit %s" % (
        jax.__version__, len(jax.devices()), dev.device_kind,
        (dev.memory_stats() or {}).get("bytes_limit")), flush=True)

    if opts.four_cards:
        if len(jax.devices()) < 4:
            print("chip_smoke: --four-cards needs 4 GPUs, found %d"
                  % len(jax.devices()), file=sys.stderr)
            return 1
        bad = four_cards()
    else:
        measured = {}
        for name in PHASES:
            measured[name] = run_phase(name)[1]
        with open(GOLDEN) as f:
            golden = json.load(f)["phases"]
        bad = compare(measured, golden)
        for name, rec in measured.items():
            print("SUMMARY %-18s dofs %7d compile %8.1f s solve %8.1f s "
                  "process peak %s steps %s" % (
                      name, rec["dofs"], rec["compile_s"], rec["solve_s"],
                      rec["process_peak_bytes"], rec["steps"]), flush=True)
    if bad:
        for b in bad:
            print("FAIL %s" % b, file=sys.stderr)
        return 1
    # the cards the run used, not the cards the host has
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if opts.four_cards else 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
