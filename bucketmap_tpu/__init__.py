"""bucketmap_tpu — a hierarchical DNA read mapper on JAX (XLA + Pallas).

A from-scratch reimplementation of the capabilities of BucketMap
(GZHoffie/bucket-map): the reference genome is split into overlapping
fixed-length buckets; a q-gram occupancy bit-matrix in device memory
supports a bit-parallel coarse bucket-scoring stage; an in-bucket k-mer voting kernel
finds exact offsets; an optional banded semi-global alignment kernel emits
CIGARs; results are written as SAM.

Layout:
  ops/      device kernels and numeric primitives (encoding, coarse, vote, align)
  io/       host-side FASTA/FASTQ/SAM and index-artifact IO
  index/    offline index construction (occupancy matrix, packed buckets)
  mapper/   the end-to-end mapping pipeline
  parallel/ mesh/sharding for multi-device index + data parallelism
  sim/      ground-truth-emitting short-read simulator
  bench/    SAM/FASTQ accuracy and throughput analyzers
"""

__version__ = "0.1.0"

from bucketmap_tpu.config import MapperConfig  # noqa: F401
