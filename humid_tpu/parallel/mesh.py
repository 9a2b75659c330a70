"""Device mesh helpers for the data-parallel dedup pipeline.

The reference is a single-threaded binary with no distribution of any kind
(SURVEY.md §2.5; no threads or MPI anywhere in the reference sources).
This design scales over a 1-D ``'data'`` mesh axis: unique-word blocks
are sharded across devices, the neighbour search rotates blocks around a
``ppermute`` ring (NCCL over NVLink on GPUs), and cluster labels
converge via min-collectives.  The mesh follows the algorithm: every
device reaches every other at the same rate.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def data_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (DATA_AXIS,))


def shard_rows(mesh: Mesh) -> NamedSharding:
    """Shard the leading axis over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_shards(x: np.ndarray, n_shards: int, multiple: int = 8,
                  fill=0) -> np.ndarray:
    """Pad the leading axis so it divides evenly into ``n_shards`` blocks
    whose size is a multiple of ``multiple``."""
    n = x.shape[0]
    per = -(-n // n_shards)
    per = -(-per // multiple) * multiple
    total = per * n_shards
    if total == n:
        return x
    pad_shape = (total - n,) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)])
