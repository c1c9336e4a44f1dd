"""Device-mesh helpers.

The substrate for what the reference has none of: its entire concurrency
story is std.Thread + mutexes in one address space (reference
src/hnsw.zig:6,50; SURVEY.md §2.3). Here scale-out is a jax.sharding.Mesh
with XLA collectives between the devices (NCCL over NVLink on a GPU host,
where every device reaches every other at the same rate, so the mesh
follows the algorithm alone).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

SHARD_AXIS = "shard"   # corpus (N) partition — the EP/TP analog for a vector DB
DATA_AXIS = "data"     # query-batch partition — DP


def make_mesh(
    n_shards: Optional[int] = None,
    n_data: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, shard) mesh. Default: all devices on the shard axis."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_shards is None:
        n_shards = len(devs) // n_data
    use = devs[: n_data * n_shards]
    arr = np.array(use).reshape(n_data, n_shards)
    return Mesh(arr, (DATA_AXIS, SHARD_AXIS))


def shard_map(f, **kw):
    """jax.shard_map with the varying-manual-axes check disabled: the
    search/build kernels carry constant-initialized while_loop state, which
    trips the vma type check even though every shard's control flow is
    independent."""
    return jax.shard_map(f, **kw, check_vma=False)


def shard_spec() -> P:
    return P(SHARD_AXIS)


def replicated_spec() -> P:
    return P()
