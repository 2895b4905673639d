#!/usr/bin/env python3
"""The measurement queue: one parameterized, resumable runner for long
Reynolds-continuation sweeps.

    python scripts/queue.py <queue> [--list]      # e.g. sweeps

Per stage:
  * runs examples/iters.py from this checkout (so every stage shares
    the compile cache at <repo>/.jax_cache) with a PERSISTENT checkpoint
    dir seeded from the committed results/resume/<name>/, so retries
    resume their Reynolds continuation instead of restarting;
  * GPU stages hold results/logs/.gpu_lock while they run: one GPU
    process at a time, even across concurrent queue invocations (a JAX
    process reserves most of the card's memory);
  * exit 0 -> results/logs/.done_<name> (FULL completion);
  * otherwise converged solves are counted ONLY after the last
    "=== attempt" marker of the CURRENT attempt and recorded in
    .partial_<name> as "<solves>/<full>" — partial credit is visibly
    distinct from done;
  * a stage that adds no converged step in STREAK_LIMIT attempts is
    marked .failed_<name> and skipped;
  * after every attempt the checkpoint dir is distilled back into
    results/resume/<name>/ (the frontier keeps u/p, earlier steps keep
    only their table row).
"""

from __future__ import annotations

import argparse
import fcntl
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = os.path.join(REPO, "results", "logs")


def iters(problem, need, **kw):
    """An examples/iters.py stage command; ``need`` = #continuation
    steps in the full sweep (for partial-credit accounting)."""
    cmd = [sys.executable, "examples/iters.py", "--checkpoint",
           "--problem", problem]
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        if v is True:
            cmd.append(flag)
        else:
            cmd += [flag, str(v)]
    return cmd, need


def _stage(name, log, cmd, need=0, timeout=14400, platform="gpu",
           env=None):
    return dict(name=name, log=log, cmd=cmd, need=need, timeout=timeout,
                platform=platform, env=env or {})


def sweeps():
    """The documented production sweeps whose resume state is committed
    (results/resume/<name>/)."""
    st = []
    # 2D pkp0 headline rows (examples/Makefile iters2dpkp0 pins)
    for name, nref in (("dcg", 2), ("c3t", 3)):
        cmd, need = iters(
            "ldc2d", 102, nref_start=nref, nref_end=nref, baseN=16, k=2,
            solver_type="almg", discretisation="pkp0", mh="uniform",
            stabilisation_type="supg", patch="star",
            restriction=True, re_max=10000)
        st.append(_stage(name, "iters_ldc2d_nref%d_re10000.log" % nref,
                         cmd, need=need))
    # 2D Scott-Vogelius headline row (iters2dsv pins)
    cmd, need = iters(
        "ldc2d", 102, nref_start=2, nref_end=2, baseN=16, k=2,
        solver_type="almg", discretisation="sv", mh="bary",
        stabilisation_type="burman", stabilisation_weight=5e-3,
        patch="macro", restriction=True, re_max=10000)
    st.append(_stage("svb5", "sv_ldc2d_nref2_re10000.log", cmd,
                     need=need))
    # ldc3d [P2+FB]^3-P0 (generate_submission:12-23 pins)
    cmd, need = iters(
        "ldc3d", 52, nref_start=1, nref_end=1, baseN=4, k=2,
        solver_type="almg", discretisation="pkp0", mh="uniform",
        stabilisation_type="supg", stabilisation_weight=0.05,
        patch="star", smoothing=10, restriction=True, re_max=5000)
    st.append(_stage("ns1", "ldc3d_p2fb_nref1_re5000.log", cmd,
                     need=need))
    # sv_ldc3d k=3 (generate_submission:71-87 pins)
    cmd, need = iters(
        "ldc3d", 52, nref_start=1, nref_end=1, baseN=2, k=3,
        solver_type="almg", discretisation="sv", mh="bary",
        stabilisation_type="burman", stabilisation_weight=5e-3,
        patch="macro", smoothing=10, restriction=True, re_max=5000)
    st.append(_stage("f1x", "sv_ldc3d_k3_nref1_re5000.log", cmd,
                     need=need))
    return st


QUEUES = {"sweeps": sweeps}


# ---------------------------------------------------------------------


MARKER = "=== attempt"


def solves_in_current_attempt(log):
    try:
        lines = open(log, errors="replace").read().splitlines()
    except OSError:
        return 0
    last = 0
    for i, ln in enumerate(lines):
        if ln.startswith(MARKER):
            last = i
    return sum("Nonlinear solve converged" in ln for ln in lines[last:])


RESUME = os.path.join(REPO, "results", "resume")
_TABLE_ONLY_MAX = 4096  # a table-only npz is O(1 KB); full state is MBs


def _seed_checkpoints(name):
    """Re-populate a stage's (gitignored, session-volatile) checkpoint
    dir from the COMMITTED compact resume state, so a sweep survives
    the machine being re-imaged between sessions (round 4 lost the
    nref=3/bfs3d/svbase1 tails exactly this way)."""
    src = os.path.join(RESUME, name)
    if not os.path.isdir(src):
        return
    for dofs in os.listdir(src):
        sd = os.path.join(src, dofs)
        dd = os.path.join(REPO, "results", "checkpoint_" + name, dofs)
        os.makedirs(dd, exist_ok=True)
        for f in os.listdir(sd):
            if ".tmp" in f:  # leftover from a crashed distill
                continue
            t = os.path.join(dd, f)
            if not os.path.exists(t):
                shutil.copy2(os.path.join(sd, f), t)


def _distill_checkpoints(name):
    """Distill a stage's checkpoint dir into results/resume/<name>:
    the continuation FRONTIER (max-Re converged step) keeps its full
    u/p state; every earlier step shrinks to its info dict (the
    driver's table-only checkpoint form), so the committed resume
    state is one npz of state + O(100-byte) table rows per sweep."""
    import numpy as np

    src = os.path.join(REPO, "results", "checkpoint_" + name)
    if not os.path.isdir(src):
        return
    for dofs in os.listdir(src):
        sd = os.path.join(src, dofs)
        if not os.path.isdir(sd):
            continue
        rows = []
        for f in os.listdir(sd):
            if ".tmp" in f:  # stale intermediate from a crashed write
                try:
                    os.unlink(os.path.join(sd, f))
                except OSError:
                    pass
                continue
            if f.startswith("nssolution-Re-") and f.endswith(".npz"):
                try:
                    rows.append((float(f[14:-4]), f))
                except ValueError:
                    pass
        if not rows:
            continue
        rows.sort()
        # the frontier must be a USABLE warm-start: full u/p state and
        # converged — a legacy diverged/table-only npz at the top of
        # the dir would otherwise become a resume state the driver
        # refuses, stranding the sweep (ADVICE r4)
        def _is_full(path):
            try:
                with np.load(path) as chk:
                    return ("u" in chk.files
                            and (bool(chk["converged"])
                                 if "converged" in chk.files else True))
            except Exception:
                return False

        fi = len(rows) - 1
        while fi >= 0 and not _is_full(os.path.join(sd, rows[fi][1])):
            fi -= 1
        if fi < 0:
            frontier = None
            tail = rows
        else:
            frontier = rows[fi][1]
            tail = rows[:fi] + rows[fi + 1:]
        dd = os.path.join(RESUME, name, dofs)
        os.makedirs(dd, exist_ok=True)
        for f in os.listdir(dd):
            if ".tmp" in f:
                try:
                    os.unlink(os.path.join(dd, f))
                except OSError:
                    pass
        if frontier is not None:
            # atomic: an interrupt mid-copy must not commit a
            # truncated npz as the resume frontier (ADVICE r4)
            tmp = os.path.join(dd, frontier + ".tmp%d" % os.getpid())
            shutil.copy2(os.path.join(sd, frontier), tmp)
            os.replace(tmp, os.path.join(dd, frontier))
        for _, f in tail:
            out = os.path.join(dd, f)
            if (os.path.exists(out)
                    and os.path.getsize(out) <= _TABLE_ONLY_MAX):
                continue
            try:
                with np.load(os.path.join(sd, f)) as chk:
                    info = {k: chk[k] for k in chk.files
                            if k not in ("u", "p", "numbering")}
            except Exception:
                continue  # corrupt npz: nothing distillable
            tmp = out + ".tmp%d" % os.getpid()
            np.savez(tmp, **info)
            os.replace(tmp + ".npz", out)
        # shrink any SUPERSEDED frontier already in resume/ (its info
        # keys are self-contained, so rewrite from its own content);
        # anything at or past the current frontier Re is left alone —
        # a resume dir can legitimately be AHEAD of a fresh partial
        # checkpoint dir, and shrinking that state would lose it
        for f in os.listdir(dd):
            if not (f.startswith("nssolution-Re-")
                    and f.endswith(".npz") and ".tmp" not in f):
                continue
            try:
                f_re = float(f[14:-4])
            except ValueError:
                continue
            p = os.path.join(dd, f)
            if (frontier is not None and f_re < rows[fi][0]
                    and os.path.getsize(p) > _TABLE_ONLY_MAX):
                try:
                    with np.load(p) as chk:
                        info = {k: chk[k] for k in chk.files
                                if k not in ("u", "p", "numbering")}
                except Exception:
                    continue
                tmp = p + ".tmp%d" % os.getpid()
                np.savez(tmp, **info)
                os.replace(tmp + ".npz", p)


def run_stage(s):
    name = s["name"]
    done = os.path.join(LOGS, ".done_" + name)
    failed = os.path.join(LOGS, ".failed_" + name)
    if os.path.exists(done) or os.path.exists(failed):
        return os.path.exists(done)
    log = os.path.join(LOGS, s["log"])
    with open(log, "a") as f:
        f.write("%s %s %s [%s]\n" % (
            MARKER, name, time.strftime("%F %T", time.gmtime()),
            s["platform"]))
    _seed_checkpoints(name)
    env = dict(os.environ, **s["env"])
    # examples/iters.py writes checkpoint/<dofs>/ under its cwd: each
    # stage runs in results/run_<name>/, whose checkpoint/ links to the
    # persistent results/checkpoint_<name>/ (both gitignored)
    cwd = os.path.join(REPO, "results", "run_" + name)
    ckpt = os.path.join(REPO, "results", "checkpoint_" + name)
    os.makedirs(cwd, exist_ok=True)
    os.makedirs(ckpt, exist_ok=True)
    if not os.path.islink(os.path.join(cwd, "checkpoint")):
        os.symlink(ckpt, os.path.join(cwd, "checkpoint"))
    cmd = list(s["cmd"])
    cmd[1] = os.path.join(REPO, cmd[1])
    if s["platform"] == "cpu":
        env["JAX_PLATFORMS"] = "cpu"
        cmd = ["nice", "-n", "19"] + cmd
    with open(log, "a") as f, open(os.path.join(LOGS, ".gpu_lock"),
                                   "w") as lock:
        if s["platform"] == "gpu":
            fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                                env=env, cwd=cwd,
                                timeout=s["timeout"]).returncode
        except subprocess.TimeoutExpired:
            f.write("\n[queue] attempt killed: timeout\n")
            rc = -1
    _distill_checkpoints(name)
    if rc == 0:
        open(done, "w").write("exit 0\n")
        partial = os.path.join(LOGS, ".partial_" + name)
        if os.path.exists(partial):
            os.unlink(partial)
        return True
    solves = solves_in_current_attempt(log)
    total = sum(solves_in_current_attempt_all(log))
    if s["need"] and total >= s["need"]:
        # every sweep step is checkpointed: cumulative credit across
        # attempts is sound ONLY because --checkpoint resumes skip
        # already-solved Re values (they print as 'checkpointed')
        open(os.path.join(LOGS, ".partial_" + name), "w").write(
            "%d/%d solves (this attempt: %d)\n"
            % (total, s["need"], solves))
    _triage(s, total)
    return False


STREAK_LIMIT = 3


def _triage(s, total):
    """No-progress triage: a failure streak is an attempt that adds NO
    new converged Re row; at STREAK_LIMIT the stage is marked
    .failed_<name> and skipped from then on — loudly."""
    name = s["name"]
    streak_file = os.path.join(LOGS, ".streak_" + name)
    streak, last_total = 0, -1
    try:
        streak, last_total = map(int, open(streak_file).read().split())
    except (OSError, ValueError):
        pass
    streak = 0 if total > last_total else streak + 1
    open(streak_file, "w").write("%d %d\n" % (streak, total))
    if streak >= STREAK_LIMIT:
        open(os.path.join(LOGS, ".failed_" + name), "w").write(
            "abandoned after %d no-progress attempts\n" % streak)
        print("[queue] stage %s: %d no-progress attempts -> ABANDONED "
              "(.failed_%s)" % (name, streak, name), flush=True)


def solves_in_current_attempt_all(log):
    """Converged-or-checkpointed count per attempt section."""
    try:
        lines = open(log, errors="replace").read().splitlines()
    except OSError:
        return [0]
    # count unique converged Re rows over the whole log: resumed
    # attempts re-print checkpointed rows, so dedup by Re value
    res = set()
    for ln in lines:
        if "'converged': True" in ln and "'Re':" in ln:
            try:
                res.add(ln.split("'Re':")[1].split(",")[0].strip())
            except IndexError:
                pass
    return [len(res)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("queue", choices=sorted(QUEUES))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--max-rounds", type=int, default=20)
    args = ap.parse_args()
    stages = QUEUES[args.queue]()
    if args.list:
        for s in stages:
            print(json.dumps({k: s[k] for k in
                              ("name", "log", "need", "timeout",
                               "platform")}))
        return
    os.makedirs(LOGS, exist_ok=True)
    for rnd in range(1, args.max_rounds + 1):
        pending = [s for s in stages
                   if not os.path.exists(
                       os.path.join(LOGS, ".done_" + s["name"]))
                   and not os.path.exists(
                       os.path.join(LOGS, ".failed_" + s["name"]))]
        print("[queue %s] round %d: %d pending" %
              (args.queue, rnd, len(pending)), flush=True)
        if not pending:
            break
        for s in pending:
            ok = run_stage(s)
            print("[queue %s] stage %s -> %s" %
                  (args.queue, s["name"], "done" if ok else "retry"),
                  flush=True)


if __name__ == "__main__":
    main()
