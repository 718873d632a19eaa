"""Mesh construction and sharding policy.

The reference is single-threaded (SURVEY §2.5); every distributed piece
here is new design:

  * "data" axis — read batches shard across devices (the DP analog),
  * "bucket" axis — the q-gram occupancy bit-matrix shards by bucket
    word-range (the TP analog: the index is the 'model'); per-shard hit
    counts reduce via XLA-inserted collectives when the fused step takes
    max/top_k over the sharded axis.

We annotate shardings and let the SPMD partitioner insert all_gather /
reductions (NCCL between GPUs) — no hand-written collectives in the hot
path. Every GPU of a host reaches every other at the same rate, so the
mesh follows the algorithm, not a topology.
"""

from __future__ import annotations

import numpy as np
import jax


def make_mesh(n_devices: int | None = None, data: int | None = None,
              bucket: int | None = None) -> jax.sharding.Mesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    devs = devs[:n]
    if data is None or bucket is None:
        # default split: favor data parallelism, keep bucket shards
        # wide enough that each holds >= 1 word column
        bucket = 1
        data = n
        # use a 2D mesh when we have 4+ devices so both axes are
        # exercised; at 8+ devices widen the index-parallel axis (the fine tables are
        # the HBM bound: 4 B/base fine_pos shards as 1/bucket_shards)
        if n >= 4 and n % 2 == 0:
            data, bucket = n // 2, 2
        if n >= 8 and n % 4 == 0:
            data, bucket = n // 4, 4
    assert data * bucket == n, (data, bucket, n)
    arr = np.asarray(devs).reshape(data, bucket)
    return jax.sharding.Mesh(arr, ("data", "bucket"))
