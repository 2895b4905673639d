"""Test configuration: run everything on a virtual 8-device CPU mesh.

The analogue of the reference's ``mpirun -n 12`` local testing
(/root/reference/examples/Makefile:1): multi-device semantics are
exercised without hardware via XLA's host-platform device splitting.
The platform is pinned through jax.config as well as JAX_PLATFORMS, so
the tests stay on the CPU even where JAX was imported (and a GPU found)
before this file ran, as long as no backend is initialised yet.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
