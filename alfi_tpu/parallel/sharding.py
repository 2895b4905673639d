"""Device-mesh construction for the distributed solver (SURVEY.md §5.8).

The reference's ONLY parallelism is MPI domain decomposition of the mesh
(SURVEY.md §2d — no TP/PP/EP exists in the reference); its JAX-native
analogue is the shard_map block decomposition in
``parallel/distributed.py``.  An earlier GSPMD prototype (dof-blocked
NamedShardings over the global step functions) lived here; it was
superseded by the explicit block formulation — same semantics, but the
block layout keeps halo traffic to packed psums instead of XLA-inferred
gathers — and has been folded out.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_device_mesh(n_devices=None, axis="mesh"):
    """Build a 1D device mesh over exactly ``n_devices`` devices.

    Raises when fewer devices are visible instead of silently truncating:
    an n-device sharding claim must never be "validated" on a smaller
    mesh (a 1-chip host faking an 8-device dryrun)."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"make_device_mesh: {n_devices} devices requested but only "
                f"{len(devs)} visible ({jax.default_backend()}); set "
                "XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{n_devices} JAX_PLATFORMS=cpu for a virtual mesh")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))
