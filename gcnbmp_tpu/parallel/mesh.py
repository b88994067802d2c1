"""Device mesh construction and sharding helpers."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` devices.

    ``model_parallel`` splits the model axis; the rest is data parallel.
    A plain reshape of jax's device order: the GPUs of one host are
    joined all to all by NVLink, so no device ordering is preferred;
    across hosts jax orders devices host by host, which keeps a model
    group inside one host.
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    arr = np.asarray(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, axis_names)


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dim over the data axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
