"""Production run-matrix generator.

JAX analogue of /root/reference/examples/generate_submission
(ARCHER PBS job generator): emits, for each of the reference's four
production cases (p1fb_ldc3d, p1fb_bfs3d, sv_ldc3d, sv_bfs3d), the
command line + suggested GPU count.  The reference's weak-scaling
rule NODES = 2*8^(nref-1) (3D) becomes a chip-count suggestion; on a
single host the commands run as-is.

Usage: python examples/generate_submission.py [--queue print]
"""

import argparse

CASES = {
    # name: (harness args, nref, walltime hint, reference scale)
    "p1fb_ldc3d": (
        "iters.py --problem ldc3d --discretisation pkp0 --k 1 --baseN 18"
        " --solver-type almg --mh uniform --patch star"
        " --stabilisation-type supg --stabilisation-weight 0.05"
        " --re-max 5000 --smoothing 10",
        4, "4h", "1024 nodes x 12 ranks (ARCHER)"),
    "p1fb_bfs3d": (
        "iters.py --problem bfs3d --discretisation pkp0 --k 1"
        " --solver-type almg --mh uniform --patch star"
        " --stabilisation-type supg --stabilisation-weight 0.05"
        " --re-max 5000 --smoothing 10",
        4, "5h", "1024 nodes x 12 ranks"),
    "sv_ldc3d": (
        "iters.py --problem ldc3d --discretisation sv --k 3 --baseN 6"
        " --solver-type almg --mh bary --patch macro"
        " --stabilisation-type burman --stabilisation-weight 5e-3"
        " --re-max 5000 --checkpoint --smoothing 10",
        3, "24h", "64 nodes x 12 ranks, bigmem"),
    "sv_bfs3d": (
        "iters.py --problem bfs3d --discretisation sv --k 3"
        " --solver-type almg --mh bary --patch macro"
        " --stabilisation-type burman --stabilisation-weight 5e-3"
        " --re-max 5000 --checkpoint --smoothing 10",
        3, "24h", "256 nodes x 12 ranks"),
}


def chips_for(nref, dim=3):
    """Weak-scaling suggestion mirroring NODES = 2*8^(nref-1)."""
    return max(1, 2 * 8 ** (nref - 1) // 8)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--case", choices=list(CASES) + ["all"],
                        default="all")
    args = parser.parse_args()
    names = list(CASES) if args.case == "all" else [args.case]
    for name in names:
        cmd, nref, wall, ref_scale = CASES[name]
        print(f"# {name}: walltime ~{wall}; reference scale {ref_scale}")
        print(f"#   suggested GPUs: {chips_for(nref)} (--ndevices)")
        print(f"python {cmd} --nref-start {nref} --nref-end {nref}"
              f" --time\n")


if __name__ == "__main__":
    main()
