"""Mesh construction for the band-sharded step.

The step only ever talks to ring NEIGHBORS (ppermute ghosts + migration).  The cards
of one host are joined all to all by NVLink, so every band pair costs the same and the
mesh is simply the devices in order.
"""

from __future__ import annotations

import jax
import numpy as np


def make_band_mesh(n_devices: int | None = None, axis: str = "bands") -> jax.sharding.Mesh:
    """1-D mesh over the first ``n_devices`` devices (all by default)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.sharding.Mesh(np.asarray(devices), (axis,))
