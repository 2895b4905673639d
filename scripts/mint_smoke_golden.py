"""Mint the golden Newton/Krylov counts of chip_smoke.py on the CPU.

Runs the chosen chip_smoke phases with JAX pinned to the CPU and merges
their counts into tests/fixtures/chip_smoke_golden.json (or --out):

    python scripts/mint_smoke_golden.py                  # every phase
    python scripts/mint_smoke_golden.py ldc2d_sv bfs2d_host_coarse
"""

import argparse
import json
import os
import sys

os.environ["ALFI_TPU_FORCE_CPU"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phases", nargs="*", default=list(chip_smoke.PHASES))
    ap.add_argument("--out", default=chip_smoke.GOLDEN)
    opts = ap.parse_args()
    import jax

    import alfi_tpu  # noqa: F401

    assert jax.default_backend() == "cpu", jax.default_backend()
    golden = {"phases": {}}
    if os.path.exists(opts.out):
        with open(opts.out) as f:
            golden = json.load(f)
    for name in opts.phases:
        rec = chip_smoke.run_phase(name)[1]
        golden["phases"][name] = {"dofs": rec["dofs"],
                                  "steps": rec["steps"]}
        golden["minted_on"] = "cpu, jax %s" % jax.__version__
        with open(opts.out, "w") as f:
            json.dump(golden, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main()
