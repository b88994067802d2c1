"""Multi-host initialization and per-host data feeding.

The reference has no multi-host story (SURVEY §5.8: a 2-GPU
ParallelUpdater is its entire distribution stack).  Here: standard
jax.distributed bring-up across hosts, global-mesh construction
spanning all hosts, and helpers to build globally-sharded arrays from
per-host shards (collectives run over NVLink within a host and the
network across hosts, chosen by XLA from the mesh layout).

Executed for real by tests/test_multihost.py: two OS processes (4
virtual CPU devices each, Gloo cross-process collectives) run
``multihost_demo.py`` — initialize_multihost + host-local batch feeding
+ one edgeshard train step — and their loss/params are asserted
identical to the single-process 8-device run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize.  Without a cluster manager that JAX
    detects, pass all three arguments (coordinator ``host:port``, process
    count, this process's id)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(
    model_parallel: int = 1,
    axis_names: Sequence[str] = ("data", "model"),
) -> Mesh:
    """Mesh over ALL devices across hosts; the model axis is laid out
    within a host (NVLink), data across hosts."""
    devices = jax.devices()
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices % model_parallel={model_parallel}")
    arr = np.asarray(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, tuple(axis_names))


def host_local_to_global(
    local_batch: np.ndarray, mesh: Mesh, axis: str = "data"
):
    """Assemble a globally-sharded array from this host's shard
    (jax.make_array_from_process_local_data)."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local_batch)


def shard_packed_batch_multihost(packed, mesh: Mesh, axis: str = "graph"):
    """Multi-process variant of edgeshard.shard_packed_batch: every
    process computes the same deterministic global padded arrays, then
    contributes only its host-local row block via
    ``jax.make_array_from_process_local_data`` — no process ever
    device_puts rows it does not own.  Requires the mesh device order to
    follow process index (jax.devices() order, contiguous per process),
    which ``global_mesh``/1-D meshes over jax.devices() satisfy."""
    from gcnbmp_tpu.parallel.edgeshard import pad_packed_global

    arrays = pad_packed_global(packed, mesh.shape[axis])
    sharding = NamedSharding(mesh, P(axis))
    n_proc = jax.process_count()
    pid = jax.process_index()
    out = []
    for x in arrays:
        rows = x.shape[0]
        assert rows % n_proc == 0, (rows, n_proc)
        per = rows // n_proc
        local = x[pid * per:(pid + 1) * per]
        out.append(jax.make_array_from_process_local_data(sharding, local))
    return tuple(out)
