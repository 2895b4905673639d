"""Backend policy (alfi_tpu/backend.py), compile-cache location, and the
GPU smoke script's CPU refusal and golden-count comparator."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from alfi_tpu import backend, config
from alfi_tpu.mg import structured
from alfi_tpu.solvers import batched_lu
from alfi_tpu.utils import scatter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_KNOBS = ("ALFI_TPU_STRUCT_PATCH", "ALFI_TPU_GATHER_SUM",
          "ALFI_TPU_MG_SMOOTH_DTYPE", "ALFI_TPU_PATCH_DTYPE",
          "ALFI_TPU_PATCH_APPLY")


@pytest.fixture
def clean(monkeypatch):
    """No knob set; every cached choice is reset before and after."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    batched_lu._fs.clear()
    config.set_mg_smooth_dtype(None)
    yield monkeypatch
    batched_lu._fs.clear()
    config.set_mg_smooth_dtype(None)


@pytest.fixture
def platform(clean, request):
    """Pretend JAX's backend is ``request.param``."""
    clean.setattr(backend.jax, "default_backend", lambda: request.param)
    return request.param


@pytest.mark.parametrize("platform", ["cpu", "gpu"], indirect=True)
def test_platform_supported(platform):
    assert backend.check_platform() == platform


@pytest.mark.parametrize("platform", ["cpu", "gpu"], indirect=True)
def test_defaults_equal_on_every_platform(platform):
    """One code path on both platforms: explicit f64 patch inverses,
    native f64 LU for single large matrices, scatter-adds, the
    unstructured patch path and an f64 smoother."""
    fs = batched_lu.get_factorization("patch")
    assert isinstance(fs, batched_lu._ExplicitInverseFactorization)
    assert fs.apply_dtype is None and not fs.transposed
    for kind in ("coarse", "dense"):
        fs = batched_lu.get_factorization(kind)
        assert isinstance(fs, batched_lu._ScipyFactorization)
        assert fs.dtype == config.real_dtype
    assert not scatter.default_use_tables()
    assert not structured.struct_patch_enabled()
    assert config.mg_smooth_dtype() == config.real_dtype


def _patch_fs():
    return batched_lu.get_factorization("patch")


@pytest.mark.parametrize("env,check", [
    ({"ALFI_TPU_PATCH_DTYPE": "lu"},
     lambda: isinstance(_patch_fs(), batched_lu._ScipyFactorization)),
    ({"ALFI_TPU_PATCH_DTYPE": "lu64"},
     lambda: isinstance(_patch_fs(), batched_lu._CustomF64Factorization)),
    ({"ALFI_TPU_PATCH_DTYPE": "f32"},
     lambda: _patch_fs().dtype == jnp.float32),
    ({"ALFI_TPU_PATCH_APPLY": "f32st"},
     lambda: (_patch_fs().transposed and _patch_fs().promote
              and _patch_fs().apply_dtype == jnp.float32)),
    ({"ALFI_TPU_GATHER_SUM": "1"}, scatter.default_use_tables),
    ({"ALFI_TPU_STRUCT_PATCH": "1"}, structured.struct_patch_enabled),
    ({"ALFI_TPU_MG_SMOOTH_DTYPE": "f32"},
     lambda: config.mg_smooth_dtype() == jnp.float32),
], ids=["lu", "lu64", "f32", "f32st", "tables", "struct", "dc32"])
def test_knob_arm(clean, env, check):
    for k, v in env.items():
        clean.setenv(k, v)
    assert check()


@pytest.mark.parametrize("env", [{"ALFI_TPU_PATCH_DTYPE": "inv64"},
                                 {"ALFI_TPU_PATCH_APPLY": "bf16t"}])
def test_unknown_knob_value_raises(clean, env):
    for k, v in env.items():
        clean.setenv(k, v)
    with pytest.raises(ValueError, match="expected one of"):
        batched_lu.get_factorization("patch")


@pytest.mark.parametrize("name", ["rocm", "metal", "cuda", ""])
def test_unknown_platform_raises(name):
    with pytest.raises(RuntimeError, match="supports the platforms"):
        backend.check_platform(name)


@pytest.mark.parametrize("platform", ["rocm"], indirect=True)
def test_solver_setup_refuses_unknown_platform(platform):
    with pytest.raises(RuntimeError, match="supports the platforms"):
        batched_lu.get_factorization("coarse")


def test_precision_set_once_to_highest():
    assert jax.config.jax_default_matmul_precision == "highest"
    # no other module sets it (set once, at import of backend.py)
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "alfi_tpu")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if "jax_default_matmul_precision" in fh.read():
                        hits.append(os.path.relpath(path, REPO))
    assert hits == [os.path.join("alfi_tpu", "backend.py")]


def _python(code, env):
    base = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(base, JAX_PLATFORMS="cpu", **env),
                          capture_output=True, text=True, timeout=120)


def test_compile_cache_lands_in_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs go there."""
    out = _python(
        "import jax, alfi_tpu; "
        "jax.jit(lambda x: x * 2.0 + 1.0)(jax.numpy.ones(3)); "
        "print(jax.config.jax_compilation_cache_dir)",
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path),
         "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == str(tmp_path)
    assert os.listdir(tmp_path)


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
def test_compile_cache_defaults_to_repo(env):
    out = _python("import jax, alfi_tpu; "
                  "print(jax.config.jax_compilation_cache_dir)", env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == os.path.join(REPO, ".jax_cache")


def test_chip_smoke_refuses_cpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def _rec(steps, dofs=100):
    return {"dofs": dofs, "steps": steps}


@pytest.mark.parametrize("measured,golden,nbad", [
    ({"a": _rec({"1": [2, 7, True]})}, {"a": _rec({"1": [2, 7, True]})}, 0),
    ({"a": _rec({"1": [2, 8, True]})}, {"a": _rec({"1": [2, 7, True]})}, 1),
    ({"a": _rec({"1": [3, 7, True]})}, {"a": _rec({"1": [2, 7, True]})}, 1),
    ({"a": _rec({"1": [2, 7, False]})}, {"a": _rec({"1": [2, 7, False]})},
     1),
    ({"a": _rec({"1": [2, 7, True]}, dofs=99)},
     {"a": _rec({"1": [2, 7, True]})}, 1),
    ({"a": _rec({"10": [2, 7, True]})}, {"a": _rec({"1": [2, 7, True]})},
     1),
    ({"b": _rec({"1": [2, 7, True]})}, {"a": _rec({"1": [2, 7, True]})},
     1),
], ids=["equal", "krylov", "newton", "unconverged", "dofs", "missing-re",
        "missing-phase"])
def test_chip_smoke_compare(measured, golden, nbad):
    sys.path.insert(0, REPO)
    import chip_smoke

    assert len(chip_smoke.compare(measured, golden)) == nbad


def test_golden_counts_cover_every_phase():
    sys.path.insert(0, REPO)
    import chip_smoke

    with open(chip_smoke.GOLDEN) as f:
        golden = json.load(f)["phases"]
    for name, (_, _, res) in chip_smoke.PHASES.items():
        steps = golden[name]["steps"]
        assert sorted(steps, key=float) == [str(r) for r in res]
        assert all(s[2] for s in steps.values())
