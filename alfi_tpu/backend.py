"""Backend policy: the platforms the solver supports, and its precision.

The solver runs on two platforms, ``cpu`` (tests, golden iteration
counts) and ``gpu`` (NVIDIA H100), with the same code on both:

* f64 factorisations are native (LAPACK getrf on the CPU,
  cuSOLVER/cuBLAS batched getrf on the GPU), so patch, Schöberl, coarse
  and ``lu``/``allu`` factors all use ``jax.scipy.linalg.lu_factor``;
  patch solves apply explicit f64 inverses built from that LU (the
  reference's ``patch_pc_patch_dense_inverse``);
* the pressure-mass inverse, the MG operator stream, the smoother and
  the patch contractions run in f64, and hot-loop accumulations are
  XLA scatter-adds;
* host callbacks work, so coarse grids above the dense cap go to the
  host sparse LU (solvers/host_coarse.py).

The f32 and layout variants are opt-in ``ALFI_TPU_*`` knobs, read where
they act.  A platform outside :data:`PLATFORMS` raises
(:func:`check_platform`): nothing falls through to a default.

Matrix products run at full f32 precision wherever an f32 operand
appears ("highest": no TF32 on the GPU); it is set once, here, at
import.
"""

from __future__ import annotations

import subprocess

import jax

jax.config.update("jax_default_matmul_precision", "highest")

#: platforms the solver is built and tested for
PLATFORMS = ("cpu", "gpu")


def check_platform(platform=None):
    """Return ``platform`` (default: JAX's backend) if it is supported;
    raise otherwise."""
    if platform is None:
        platform = jax.default_backend()
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"alfi_tpu supports the platforms {list(PLATFORMS)}; JAX's "
            f"backend is {platform!r}")
    return platform


def gpu_name_and_power_limit():
    """``name, power.limit`` of the first card as nvidia-smi reports
    them, or None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]
