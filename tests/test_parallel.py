"""Multi-device tests on the virtual 8-device CPU mesh (conftest.py) —
the JAX analogue of the reference's ``mpirun -n 12`` local testing
(SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, (z, params) = g.entry()
    out = jax.jit(fn)(z, params)
    assert np.isfinite(float(jnp.max(jnp.abs(out[0]))))


def test_dryrun_multichip_8():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_make_device_mesh_shape():
    from alfi_tpu.parallel import make_device_mesh

    mesh = make_device_mesh(8)
    assert mesh.devices.size == 8
