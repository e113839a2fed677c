"""Device mesh helpers.

The reference's only parallelism is two std::thread::scope forks inside one
process (sampling.rs:83-98, dct_quant.rs:29-60). Here the equivalent of
"more throughput" is a jax.sharding.Mesh: a flat "data" axis for
embarrassingly parallel batch encode, and the same axis reused as the MCU
band axis when sharding one huge image. Multi-host pods reuse these helpers
unchanged — jax.devices() spans all hosts after jax.distributed.initialize.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def data_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the first num_devices devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, have {len(devices)}"
            )
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
