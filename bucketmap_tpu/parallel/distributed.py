"""Multi-host runtime: process bootstrap + cross-host read sharding.

The reference has no distributed story (SURVEY §2.5: single process,
POSIX file IO). This module is the multi-host equivalent (one process
per host, each driving its local devices):

  * ``initialize()`` — wraps ``jax.distributed.initialize`` with env
    autodetection (cluster launchers set the env vars; explicit args
    otherwise). Call once per process before device use.
  * ``global_read_batch()`` — each host parses its own FASTQ shard and
    the batch becomes one global device array via
    ``jax.make_array_from_process_local_data`` (the DP input pipeline:
    hosts stream disjoint read ranges, SURVEY §2.5 'DP' row).
  * ``shard_fastq()`` — deterministic round-robin shard of a FASTQ file
    by read index for host-local streaming.

SAM assembly across hosts follows the reference's determinism rule: each
host writes records for its own reads; ranks concatenate in read order
(host files are disjoint, sorted merges are trivial).
"""

from __future__ import annotations

import os

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bootstrap the multi-process JAX runtime (no-op if single-process
    or already initialized)."""
    import jax

    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def shard_fastq(path, out_dir, num_shards: int, shard_id: int) -> str:
    """Write this host's shard (reads i with i % num_shards == shard_id)
    to out_dir and return the shard path. Deterministic by read index."""
    from bucketmap_tpu.io.fastq import read_fastq

    batch = read_fastq(path)
    sel = np.arange(shard_id, batch.num_reads, num_shards)
    out = os.path.join(str(out_dir), f"shard_{shard_id}_of_{num_shards}.fastq")
    ids = batch.ids
    with open(out, "w") as f:
        for i in sel:
            n = int(batch.lengths[i])
            f.write(f"@{ids[i]}\n"
                    f"{batch.seq_ascii[i, :n].tobytes().decode()}\n+\n"
                    f"{batch.qual_ascii[i, :n].tobytes().decode()}\n")
    return out


def global_read_batch(mesh, codes: np.ndarray, quals: np.ndarray,
                      lengths: np.ndarray, data_axis: str = "data"):
    """Assemble per-host read arrays into global device arrays sharded on
    the data axis. Each process passes ITS OWN reads; the global batch is
    their concatenation in process order."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_process_local_data(sh, x)

    return (put(codes, P(data_axis, None)),
            put(quals, P(data_axis, None)),
            put(lengths.astype(np.int32), P(data_axis)))
