"""Global configuration for alfi_tpu.

The reference stack (Firedrake/PETSc) is double precision throughout, and
so is this one by default: the outer Krylov/Newton arithmetic is f64
(needed to hit the reference tolerances ksp_rtol=1e-9 / snes_atol=1e-8,
see /root/reference/alfi/solver.py:464-499).  The multigrid
preconditioner may run parts of its cycle in f32 (mg_dtype, mg_store,
mg_smooth_dtype below): flexible GMRES permits an inexact (lower
precision, nonlinear) preconditioner by construction, so this does not
change convergence semantics.  The supported platforms and the matmul
precision are set in alfi_tpu/backend.py.
"""

import os

import jax

from . import backend  # noqa: F401  (sets the matmul precision)

# f64 must be enabled before any arrays are created.
if os.environ.get("ALFI_TPU_X64", "1") == "1":
    jax.config.update("jax_enable_x64", True)

# ALFI_TPU_FORCE_CPU=1 pins JAX to the CPU from inside the process (e.g.
# a CPU run beside a GPU job on the same host).
if os.environ.get("ALFI_TPU_FORCE_CPU") == "1":
    jax.config.update("jax_platforms", "cpu")
    # XLA:CPU constant folding evaluates the big FEM tabulation einsums
    # at compile time (>2 GB HLO protos, multi-hour "Constant folding an
    # instruction is taking > 32s" stalls on ldc3d); disabling the pass
    # removes the stall with no measured runtime penalty.
    if "constant_folding" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_disable_hlo_passes=constant_folding").strip()

# persistent compilation cache: JAX reads JAX_COMPILATION_CACHE_DIR
# itself; without it, a fixed path inside the checkout, shared by every
# process that runs from it
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"))
if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
    # the solver programs take seconds to minutes to compile and are
    # identical across processes; tiny helper jits are not worth a file
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

#: dtype of outer solver arithmetic (residuals, Krylov vectors, dots).
real_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

#: host-side index dtype.
index_dtype = np.int32

_DTYPES = {"f32": jnp.float32, "f64": jnp.float64}

_mg_dtype = None


def mg_dtype():
    """dtype of the velocity-block MG CYCLE (level matvecs, smoother
    Krylov arithmetic, transfers, patch applies).  The cycle is a
    PRECONDITIONER inside flexible GMRES, which admits an inexact
    (lower-precision) application by construction; the factorisations
    that carry the gamma-conditioned cancellation (patch LU, coarse
    solve) stay f64 regardless — only the per-iteration STREAMING work
    changes precision.

    Default: f64.  The all-f32 cycle loses iteration parity at high Re
    (31 vs 15 Krylov its at Re=700 on ldc2d nref=2, measured on the CPU
    with bit-true f32); opt in with ALFI_TPU_MG_DTYPE=f32
    (+ ALFI_TPU_MG_F64_KEYS for the state entries to keep in f64)."""
    global _mg_dtype
    if _mg_dtype is None:
        env = os.environ.get("ALFI_TPU_MG_DTYPE")
        _mg_dtype = _DTYPES[env] if env else real_dtype
    return _mg_dtype


def set_mg_dtype(dtype):
    global _mg_dtype
    _mg_dtype = dtype


_mg_store = None


def mg_store():
    """STORAGE dtype of the MG level-operator stream (gamma-split
    M/B element tensors, facet tensors, static patch contractions) —
    independent of the cycle's COMPUTE dtype (mg_dtype).

    Storing the operator stream in f32 while computing in f64 is a
    consistent relative-eps32 operator perturbation (absorbed by
    flexible GMRES) that halves the HBM traffic of every level matvec;
    XLA fuses the widening converts into the loads.  At ldc2d nref=2,
    Re=1 it gives the f64 control's counts (PERF.md, knob arms); its
    parity over a Reynolds continuation is not measured in this tree.

    Default: the cycle dtype; opt in with ALFI_TPU_MG_STORE=f32."""
    global _mg_store
    if _mg_store is None:
        env = os.environ.get("ALFI_TPU_MG_STORE")
        _mg_store = _DTYPES[env] if env else mg_dtype()
    return _mg_store


def set_mg_store(dtype):
    global _mg_store
    _mg_store = dtype


_mg_smooth = None


def mg_smooth_dtype():
    """COMPUTE dtype of the level smoother's inner Krylov loop
    (defect-correction mixed precision, "dc32" when f32).

    The all-f32 cycle's parity loss is in f32 VECTOR arithmetic.  The
    classical mixed-precision-MG answer is defect correction: keep every
    RESIDUAL/correction accumulation (b - Ax, restrict, prolong-add,
    coarse) in f64, and run only the inner fixed-iteration smoother on
    the DEFECT in f32 — the smoother's output is a correction whose
    f32 rounding is RELATIVE to the defect it smooths, so the cycle's
    contraction factor survives while the m matvecs + patch applies +
    Arnoldi arithmetic per level stream half the bytes
    (mg/velocity.py _smooth).  On ldc2d nref=3, Re 1 -> 10 -> 100 it
    gives the f64 control's counts (PERF.md, backend A/B); its 3D count
    parity is not measured in this tree.

    Default: the cycle dtype; opt in with ALFI_TPU_MG_SMOOTH_DTYPE=f32."""
    global _mg_smooth
    if _mg_smooth is None:
        env = os.environ.get("ALFI_TPU_MG_SMOOTH_DTYPE")
        _mg_smooth = _DTYPES[env] if env else mg_dtype()
    return _mg_smooth


def set_mg_smooth_dtype(dtype):
    global _mg_smooth
    _mg_smooth = dtype


_use_woodbury = None


def use_woodbury():
    """gamma-split (Woodbury) patch/coarse solves: f32 factorisations
    whose conditioning is independent of gamma (docs/DESIGN.md).
    OPT-IN (ALFI_TPU_WOODBURY=1): exact vs the direct path at moderate
    Reynolds but the f32 M-solves lose smoother quality as nu drops
    (Re>=500 on the cavity)."""
    global _use_woodbury
    if _use_woodbury is None:
        _use_woodbury = os.environ.get("ALFI_TPU_WOODBURY") == "1"
    return _use_woodbury


def set_use_woodbury(v):
    global _use_woodbury
    _use_woodbury = v
