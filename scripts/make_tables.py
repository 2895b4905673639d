"""Reconstruct the iteration-robustness tables from harness logs.

`examples/iters.py` emits its LaTeX tables from the in-process
info_dicts, so continuation steps that were RESUMED from a checkpoint
(after a crash or relaunch) appear as placeholder zeros.  The
per-solve log lines

    Solving for Re = <re>
    ...
    Time taken: <t> min in <n> iterations (<k> Krylov iters per Newton step)

are written by every EXECUTED solve, across every (re)launch appending
to the same log, so scanning the whole file recovers the true table:
for each Re the LAST executed solve wins.

Usage:
    python scripts/make_tables.py results/logs/*.log
    python scripts/make_tables.py --res 10,100,1000,5000,10000 <log>

Prints, per log: dofs, a markdown row of Krylov-per-Newton at the
requested Re columns, the same for time-per-Re (seconds), and coverage
(#Re executed / #Re seen).
"""

import argparse
import re
import sys

SOLVE = re.compile(r"Solving for Re = (\d+)")
TAKEN = re.compile(
    r"Time taken: ([\d.]+) min in (\d+) iterations "
    r"\(([\d.]+) Krylov iters per Newton step\)")
DOFS = re.compile(r"Number of degrees of freedom: (\d+)")


def parse(path):
    """-> (dofs, {re: (kpn, seconds)}, n_seen)."""
    dofs, cur, seen, table = None, None, set(), {}
    with open(path, errors="replace") as fh:
        for line in fh:
            m = DOFS.search(line)
            if m:
                dofs = int(m.group(1))
            m = SOLVE.search(line)
            if m:
                cur = int(m.group(1))
                seen.add(cur)
            m = TAKEN.search(line)
            if m and cur is not None:
                table[cur] = (float(m.group(3)),
                              60.0 * float(m.group(1)))
    return dofs, table, len(seen)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("logs", nargs="+")
    ap.add_argument("--res", default="10,100,1000,5000,10000")
    args = ap.parse_args(argv)
    cols = [int(r) for r in args.res.split(",")]

    for path in args.logs:
        dofs, table, nseen = parse(path)
        print(f"== {path}  (dofs {dofs}, executed {len(table)}/{nseen} Re)")
        hdr = " | ".join(str(r) for r in cols)
        kpn = " | ".join(
            f"{table[r][0]:.2f}" if r in table else "-" for r in cols)
        tim = " | ".join(
            f"{table[r][1]:.1f}" if r in table else "-" for r in cols)
        print(f"   Re      | {hdr}")
        print(f"   kpn     | {kpn}")
        print(f"   time(s) | {tim}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
