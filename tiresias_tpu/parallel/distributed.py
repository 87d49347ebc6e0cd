"""Multi-host (multi-controller) support: DCN across slices.

The reference has no distributed layer at all (SURVEY.md §2/§5 — single
process, no sockets). The scale-out beyond one host is JAX's
multi-controller runtime: every host runs the same program, calls
:func:`initialize_distributed` once, and then builds meshes over the
GLOBAL device set — ``pjit``/``shard_map`` emit ICI collectives within a
slice and DCN transfers across slices automatically.

Design for tiresias specifically:

  * The **host catalog is replicated**: every process restores the same
    checkpoint / syncs the same (shared) media directory, so each host
    holds the full ``[A, T, C]`` fingerprint matrix in RAM. This is cheap
    (2 float32 values per 32 ms frame ≈ 1 MB per audio-hour) and makes
    multi-host placement trivial.
  * The **device DB is sharded globally** on the ``db`` axis:
    :func:`put_global` materialises each process's addressable shards from
    the replicated host array via ``jax.make_array_from_callback`` — no
    host ever ships another host's shard over DCN.
  * **Searches** run under the same ``shard_map`` as single-host
    (parallel/sharding.py); vote columns are disjoint per shard and merge
    with one tiled all_gather over ICI+DCN.

Single-controller (one process, any number of local devices) remains the
default envelope and needs none of this module.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from tiresias_tpu.utils.logging import get_logger

log = get_logger(__name__)

_initialized = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Idempotent wrapper around ``jax.distributed.initialize``.

    With no arguments, JAX auto-detects the cluster from the environment
    (cluster auto-detection where JAX supports it, or ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
    ``JAX_PROCESS_ID``). Must run before the first device access in the
    process. After it, ``jax.devices()`` is the GLOBAL device list and
    ``jax.local_devices()`` this host's slice.
    """
    global _initialized
    if _initialized:
        return
    # idempotent against OUTSIDE initializers too: a host program (or
    # another library) may have called jax.distributed.initialize itself
    # before constructing the engine — re-initializing would raise
    try:
        from jax._src.distributed import global_state

        if getattr(global_state, "client", None) is not None:
            _initialized = True
            return
    except ImportError:  # pragma: no cover - internal layout changed
        pass
    kwargs = {}
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True
    log.info(
        "jax.distributed initialized: process %d/%d, %d local of %d global devices",
        jax.process_index(), jax.process_count(),
        len(jax.local_devices()), len(jax.devices()),
    )


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_mesh(n_db: int | None = None, n_batch: int | None = None) -> Mesh:
    """A ``(db, batch)`` mesh over ALL global devices (every process must
    build the identical mesh — same shapes, same device order)."""
    from tiresias_tpu.parallel.sharding import make_mesh

    return make_mesh(n_db, n_batch, devices=jax.devices())


def put_global(
    arr: np.ndarray, mesh: Mesh, spec: PartitionSpec
) -> jax.Array:
    """Place a replicated host array onto a (possibly multi-host) mesh.

    Fully-addressable meshes take the fast ``jax.device_put`` path. On a
    multi-host mesh, each process materialises only its addressable shards
    from its own copy of the host array (``jax.make_array_from_callback``)
    — the standard multi-controller placement pattern. Set
    ``TIRESIAS_FORCE_CALLBACK_PUT=1`` to exercise the callback path on a
    single host (used by tests).
    """
    sharding = NamedSharding(mesh, spec)
    if sharding.is_fully_addressable and not os.environ.get(
        "TIRESIAS_FORCE_CALLBACK_PUT"
    ):
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: np.ascontiguousarray(arr[idx])
    )
