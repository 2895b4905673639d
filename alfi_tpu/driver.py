"""Shared CLI + Reynolds-continuation experiment loop.

Mirrors /root/reference/alfi/driver.py: the same 20 flags (so reference
users can switch without relearning the CLI), solver dispatch, and the
try-load-checkpoint-else-solve continuation loop with per-Re npz
checkpoints (the DumbCheckpoint analogue, keyed
``checkpoint/<ndofs>/nssolution-Re-<re>``)."""

from __future__ import annotations

import argparse
import os
import shutil
import zipfile

import numpy as np

from .solver import BLUE, GREEN, ConstantPressureSolver, ScottVogeliusSolver
from .utils.events import EVENTS


def get_default_parser():
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--nref", type=int, default=1)
    parser.add_argument("--nref-vis", type=int, default=0)
    parser.add_argument("--baseN", type=int, default=16)
    parser.add_argument("--k", type=int, default=2)
    parser.add_argument("--stabilisation-weight", type=float, default=None)
    parser.add_argument("--solver-type", type=str, default="almg",
                        choices=["lu", "allu", "almg", "alamg",
                                 "simple", "lsc"])
    parser.add_argument("--patch", type=str, default="star",
                        choices=["star", "macro"])
    parser.add_argument("--patch-composition", type=str, default="additive",
                        choices=["additive", "multiplicative"])
    parser.add_argument("--mh", type=str, default="uniform",
                        choices=["uniform", "bary", "uniformbary"])
    parser.add_argument("--stabilisation-type", type=str, default=None,
                        choices=["none", "burman", "gls", "supg"])
    parser.add_argument("--discretisation", type=str, required=True,
                        choices=["pkp0", "sv"])
    parser.add_argument("--gamma", type=float, default=1e4)
    parser.add_argument("--clear", dest="clear", default=False,
                        action="store_true")
    parser.add_argument("--time", dest="time", default=False,
                        action="store_true")
    parser.add_argument("--mkl", dest="mkl", default=False,
                        action="store_true")
    parser.add_argument("--checkpoint", dest="checkpoint", default=False,
                        action="store_true")
    parser.add_argument("--paraview", dest="paraview", default=False,
                        action="store_true")
    parser.add_argument("--restriction", dest="restriction", default=False,
                        action="store_true")
    parser.add_argument("--rebalance", dest="rebalance", default=False,
                        action="store_true")
    parser.add_argument("--high-accuracy", dest="high_accuracy",
                        default=False, action="store_true")
    parser.add_argument("--smoothing", type=int, default=None)
    # the reference gets multi-rank execution from the launcher
    # (mpirun -n N, /root/reference/examples/Makefile:1); the JAX
    # analogue is an explicit device count: shard the mesh-decomposed
    # solver over N chips of this host's jax.devices()
    parser.add_argument("--ndevices", type=int, default=1)
    return parser


def get_solver(args, problem, hierarchy_callback=None):
    solver_t = {"pkp0": ConstantPressureSolver,
                "sv": ScottVogeliusSolver}[args.discretisation]
    solver = solver_t(
        problem,
        solver_type=args.solver_type,
        stabilisation_type=args.stabilisation_type,
        nref=args.nref,
        k=args.k,
        gamma=args.gamma,
        nref_vis=args.nref_vis,
        patch=args.patch,
        use_mkl=args.mkl,
        supg_method="shakib",
        stabilisation_weight=args.stabilisation_weight,
        hierarchy=args.mh,
        patch_composition=args.patch_composition,
        restriction=args.restriction,
        smoothing=args.smoothing,
        rebalance_vertices=args.rebalance,
        high_accuracy=args.high_accuracy,
        hierarchy_callback=hierarchy_callback,
    )
    if getattr(args, "ndevices", 1) > 1:
        from .parallel import make_device_mesh
        from .parallel.distributed import DistributedSolver

        mesh = make_device_mesh(args.ndevices)
        return DistributedSolver(solver, mesh)
    return solver


def performance_info(solver):
    """Per-event timing report, mirroring
    /root/reference/alfi/driver.py:77-92 with the same metric
    (time and time-per-1k-dofs, sorted by cost).  The host-timed
    events (SNESSolve/KSPSolve/SNESFunctionEval) come from the solve
    loop; the intra-jit events (PCPATCHSolve, SchoeberlProlong, ...)
    are measured per-op by solver.micro_events and scaled by their
    exact invocation counts."""
    if hasattr(solver, "micro_events"):
        solver.micro_events()
    print(BLUE % "Some performance info:")
    ndofs = solver.Z.dim
    rows = sorted(EVENTS.items(), key=lambda kv: -kv[1]["time"])
    for name, v in rows:
        print(GREEN % (("%s:" % name).ljust(30)
                       + "Time = % 6.2fs, Time/1kdofs = %.2fs"
                       % (v["time"], 1000 * v["time"] / ndofs)))
    if rows:
        t = rows[0][1]["time"]
        print(BLUE % ("% 5.1fs \t % 4.2fs \t %i" % (t, 1000 * t / ndofs,
                                                    ndofs)))


def _numbering_tag():
    """Entity-numbering fingerprint stored in checkpoints: dof vectors
    are meaningless under a different numbering (mesh/renumber.py)."""
    from .mesh.renumber import (
        geom_numbering_3d_enabled,
        geom_numbering_enabled,
    )

    tag = "geom1" if geom_numbering_enabled() else "legacy0"
    if geom_numbering_3d_enabled():
        tag += "+3d"
    return tag


def _nearest_full_checkpoint(chkptdir, re_lo, re_hi):
    """Largest-Re FULL (u/p, converged, numbering-matching) checkpoint
    with re_lo < Re < re_hi, or None.  Used to warm-start a cache-miss
    re-solve BELOW the continuation frontier: with table-only distilled
    checkpoints (scripts/queue.py) the loop never touches solver.z for
    finished rows, so a gap row would otherwise start from the cold
    initial guess and likely diverge at high Re (ADVICE r4, medium)."""
    best = None
    try:
        names = os.listdir(chkptdir)
    except OSError:
        return None
    for f in names:
        if not (f.startswith("nssolution-Re-") and f.endswith(".npz")
                and ".tmp" not in f):
            continue
        try:
            f_re = float(f[len("nssolution-Re-"):-len(".npz")])
        except ValueError:
            continue
        if not (re_lo < f_re < re_hi):
            continue
        if best is not None and f_re <= best[0]:
            continue
        try:
            with np.load(os.path.join(chkptdir, f)) as chk:
                if ("u" in chk.files
                        and (bool(chk["converged"])
                             if "converged" in chk.files else True)
                        and (str(chk["numbering"])
                             if "numbering" in chk.files else "legacy0")
                        == _numbering_tag()):
                    best = (f_re, chk["u"], chk["p"])
        except Exception:
            continue  # truncated/corrupt npz: not a warm-start source
    return best


def run_solver(solver, res, args):
    problemsize = solver.Z.dim
    outdir = "output/%i/" % problemsize
    chkptdir = "checkpoint/%i/" % problemsize
    if args.clear:
        shutil.rmtree(chkptdir, ignore_errors=True)
        shutil.rmtree(outdir, ignore_errors=True)
    if args.checkpoint:
        os.makedirs(chkptdir, exist_ok=True)
    results = {}
    warm_re = float("-inf")  # Re whose state solver.z currently holds
    for re in res:
        path = chkptdir + "nssolution-Re-%s.npz" % re
        try:
            with np.load(path) as chk:
                import jax.numpy as jnp

                if ("converged" in chk.files
                        and not bool(chk["converged"])):
                    # legacy checkpoint of a DIVERGED solve (pre-fix
                    # runs stored them): retry instead of loading
                    raise KeyError("diverged checkpoint")
                if "u" in chk.files:
                    stored_numbering = (str(chk["numbering"])
                                        if "numbering" in chk.files
                                        else "legacy0")
                    if stored_numbering != _numbering_tag():
                        # dof vectors are permutation-laid-out: loading
                        # a checkpoint written under a different entity
                        # numbering would silently scramble the state
                        # (scripts/convert_checkpoints.py migrates)
                        raise KeyError("numbering mismatch: %s != %s"
                                       % (stored_numbering,
                                          _numbering_tag()))
                    solver.z = (jnp.asarray(chk["u"]),
                                jnp.asarray(chk["p"]))
                    warm_re = re
                elif "linear_iter" not in chk.files:
                    raise KeyError("empty checkpoint")
                # else: TABLE-ONLY checkpoint (scripts/queue.py
                # distills finished steps to their info dict so a
                # sweep's committed resume state is one full npz — the
                # continuation frontier — plus O(100-byte) table rows;
                # the solve state for later steps comes from the full
                # frontier npz, which sorts after every table row)
                # checkpoints carry the solve's info dict so resumed
                # sweeps reproduce the TRUE iteration/time tables; old
                # solution-only checkpoints fall back to placeholders
                # (which downstream table extraction tolerates)
                if "linear_iter" in chk.files:
                    info = {k: chk[k].item() for k in
                            ("nu", "linear_iter", "nonlinear_iter",
                             "time", "converged") if k in chk.files}
                else:
                    info = {"nu": None, "linear_iter": 0,
                            "nonlinear_iter": 0, "time": 0.0,
                            "converged": True}
            results[re] = dict(info, Re=re, checkpointed=True)
        except (FileNotFoundError, OSError, KeyError, ValueError,
                zipfile.BadZipFile):
            # BadZipFile/ValueError: a truncated npz (interrupted copy)
            # must trigger a re-solve, not crash the sweep (ADVICE r4)
            if args.checkpoint and warm_re < re:
                # cache miss below the frontier: solver.z may still be
                # cold (all earlier rows were table-only) — warm-start
                # from the nearest lower full checkpoint if one exists
                found = _nearest_full_checkpoint(chkptdir, warm_re, re)
                if found is not None:
                    import jax.numpy as jnp

                    print("Warm-starting Re = %s from checkpoint "
                          "Re = %g" % (re, found[0]))
                    solver.z = (jnp.asarray(found[1]),
                                jnp.asarray(found[2]))
                    warm_re = found[0]
            z, info_dict = solver.solve(re)
            if info_dict.get("converged", True):
                warm_re = re
            results[re] = info_dict
            # never checkpoint a diverged solve: the stored z would be
            # garbage and a resumed sweep would "skip" the failed Re
            # with poisoned state instead of retrying it
            if args.checkpoint and info_dict.get("converged", True):
                # atomic write (tmp + rename): a concurrent run sharing
                # the checkpoint dir (e.g. a CPU minting pass alongside
                # the GPU sweep) must never observe a half-written npz
                tmp = "%s.tmp%d.npz" % (path, os.getpid())
                np.savez(tmp, u=np.asarray(z[0]), p=np.asarray(z[1]),
                         numbering=_numbering_tag(),
                         **{k: info_dict[k] for k in
                            ("nu", "linear_iter", "nonlinear_iter",
                             "time", "converged") if k in info_dict})
                os.replace(tmp, path)
        if args.paraview:
            os.makedirs(outdir, exist_ok=True)
            from .utils.vtk import write_velocity_vtu, write_vtu

            # IO runs on the gathered global state (rank-0 analogue);
            # for a DistributedSolver that state lives on the inner
            # solver (whose .mesh is the FE mesh, not the device mesh)
            base = getattr(solver, "solver", solver)
            write_vtu(outdir + "velocity-Re-%s.vtu" % re, base.mesh,
                      base.Z, base.z)
            if getattr(base, "nref_vis", 0):
                uvis, vmesh, _ = base.visprolong(base.z[0])
                write_velocity_vtu(
                    outdir + "velocity-refined-Re-%s.vtu" % re, vmesh,
                    uvis)
    for re in results:
        print(results[re])
    if args.time:
        performance_info(solver)
    return results
