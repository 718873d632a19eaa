"""Throughput benchmark: end-to-end read mapping on one NVIDIA GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N}

Baseline: the reference C++ BucketMap maps 1M x 300bp simulated reads
against the 1.7 Gbp Egu.v3 genome in 320.95 s single-threaded in
alignment-free mode (bucket_map/benchmark/README.md:169) = 3116 reads/s.
vs_baseline = our reads/s / 3116.

No egress: the genome is synthetic but carries repeat structure
(segmental duplications + mobile elements + tandem arrays,
sim/simulator.py:repeat_genome) so candidate lists behave like real
genomes (the reference sees 1.14-2.7 locations/read on Egu.v3/GRCh38,
benchmark/README.md:178; a uniform-random genome gives 1.00006).
Error rates are dwgsim-like. Env-tunable:
  BMTPU_BENCH_GENOME_MBP (default 1700), BMTPU_BENCH_READS (default 1000000),
  BMTPU_BENCH_BATCH (default 8192), BMTPU_BENCH_CACHE (default .bench_cache),
  BMTPU_BENCH_ALIGN=1 (align mode), BMTPU_BENCH_UNIFORM=1 (the old
  repeat-free genome, for comparison)
The workload (index + reads + ground truth) is cached on disk so repeated
runs measure mapping only, like the reference's map stage.

Needs a GPU: without one it exits non-zero before any work. The device
kind and count and the card's name and power limit go to stderr.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GENOME_MBP = float(os.environ.get("BMTPU_BENCH_GENOME_MBP", "1700"))
LONG = os.environ.get("BMTPU_BENCH_LONG", "0") == "1"
NUM_READS = int(os.environ.get("BMTPU_BENCH_READS",
                               "100000" if LONG else "1000000"))
ALIGN = os.environ.get("BMTPU_BENCH_ALIGN", "0") == "1"
# align mode holds the DP direction tensors alongside the map step's
# transients, so its map batch is half the align-free one
BATCH = int(os.environ.get("BMTPU_BENCH_BATCH",
                           "8192" if ALIGN else "16384"))
UNIFORM = os.environ.get("BMTPU_BENCH_UNIFORM", "0") == "1"
# FracMinHash fraction of q-grams kept in the coarse index (-f). The
# reference ships a GRCh38 f=0.25 variant (log/bucketmap_fracMinHash_map.log)
# — the 3.1 Gbp single-chip config uses it.
FRAC = float(os.environ.get("BMTPU_BENCH_FRAC", "1.0"))
# host-built fine index (a 6.8 GB artifact uploaded at init). Default 0:
# the fine index is built ON DEVICE from the packed genome at pipeline
# init (index/device_build.py).
HOST_FINE = os.environ.get("BMTPU_BENCH_HOST_FINE", "0") == "1"
CACHE = os.environ.get("BMTPU_BENCH_CACHE", os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".bench_cache"))
# align-free: 1M reads / 320.95 s; align: 1M / 426.78 s (benchmark/README.md:168-169)
BASELINE_READS_PER_SEC_NOALIGN = 3116.0
BASELINE_READS_PER_SEC_ALIGN = 2343.1
# GRCh38-scale (Setup B): the reference's committed 3.1 Gbp runs —
# 677.43 s user (log/bucketmap_map.time) and 711.5 s for the f=0.25
# FracMinHash variant (log/bucketmap_fracMinHash_map.log), 1M reads each
if GENOME_MBP >= 3000:
    BASELINE_READS_PER_SEC_NOALIGN = (1e6 / 711.5 if FRAC < 1.0
                                      else 1e6 / 677.43)
# long-read mode: the reference's committed long-read runs all failed
# (log/bucketmap_map.time: exit 255 in 0.02 s), so there is no reference
# long-read time; vs_baseline is reported in BASES/s against the
# align-free short-read baseline (3116 reads/s x 300 bp).
BASELINE_BASES_PER_SEC = BASELINE_READS_PER_SEC_NOALIGN * 300.0

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from bucketmap_tpu.utils.device import (gpu_name_power_limit,
                                            require_gpu, setup_compile_cache)

    devs = require_gpu("bench.py")
    log(f"[bench] device: {devs[0].device_kind} x{len(devs)} "
        f"({devs[0].platform}); nvidia-smi: {gpu_name_power_limit()}")
    log(f"[bench] compile cache: {setup_compile_cache()}")

    from bucketmap_tpu.bench.sam_analyzer import score_sam
    from bucketmap_tpu.config import MapperConfig
    from bucketmap_tpu.index import builder
    from bucketmap_tpu.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu.sim.simulator import (ShortReadSimulator, random_genome,
                                             repeat_genome)

    def make_genome():
        if UNIFORM:
            return random_genome(int(GENOME_MBP * 1e6), seed=1, n_refs=4)
        return repeat_genome(int(GENOME_MBP * 1e6), seed=1, n_refs=4)

    if LONG:
        # the reference's long-read parameterization
        # (benchmark/long_read/benchmark_map.sh:25)
        cfg = MapperConfig(bucket_len=65536, read_len=300, mapper_samples=30,
                           seed_miss_rate=0.9, indel_rate=0.1,
                           locator_samples=20, quality_threshold=5,
                           kmer_fraction=FRAC)
    else:
        cfg = MapperConfig(bucket_len=65536, read_len=300, kmer_fraction=FRAC)
    # 'rep2': identical-copy repeat structure (sim/simulator.py) — retags
    # the cache so stale round-2 artifacts are never mixed in
    gkind = "u" if UNIFORM else "rep2"
    gtag = f"{GENOME_MBP:g}{gkind}" + (f"_f{FRAC:g}" if FRAC != 1.0 else "")
    tag = f"g{gtag}m_r{NUM_READS}" + ("_long" if LONG else "")
    os.makedirs(CACHE, exist_ok=True)
    idx_path = os.path.join(CACHE, f"idx_{gtag}.bmtpu.json")
    fastq_path = os.path.join(CACHE, f"reads_{tag}.fastq")

    t0 = time.time()
    index_build_s = None
    if not os.path.exists(idx_path):
        log(f"[bench] building index for {GENOME_MBP} Mbp synthetic "
            f"{'uniform' if UNIFORM else 'repeat-structured'} genome...")
        genome = make_genome()
        t0 = time.time()  # index build proper (reference: 147.8 s @ 3.1 Gbp)
        index = builder.build_index(genome, cfg)
        if HOST_FINE:
            builder.build_fine_index(index)  # device build is the default
        index_build_s = time.time() - t0
        builder.save_index(index, CACHE, f"idx_{gtag}")
        log(f"[bench] index built in {index_build_s:.1f}s "
            f"({index.n_buckets} buckets)")
    else:
        index = builder.load_index(CACHE, f"idx_{gtag}")
        genome = None
        log(f"[bench] index loaded in {time.time()-t0:.1f}s")
        # the artifact stores the config it was BUILT with; re-apply this
        # run's QUERY-time parameterization (the long-read mode changes
        # sampling/thresholds but shares the index — a cache hit must not
        # silently drop -s/-e/-n/-p/-u)
        import dataclasses
        index.config = dataclasses.replace(
            index.config, mapper_samples=cfg.mapper_samples,
            seed_miss_rate=cfg.seed_miss_rate, indel_rate=cfg.indel_rate,
            locator_samples=cfg.locator_samples,
            quality_threshold=cfg.quality_threshold)

    if not os.path.exists(fastq_path):
        if genome is None:
            genome = make_genome()
        log(f"[bench] simulating {NUM_READS} reads...")
        if LONG:
            from bucketmap_tpu.sim.simulator import LongReadSimulator
            sim = LongReadSimulator(genome, mean_len=7500, sd_len=1500,
                                    min_len=5000, substitution_rate=0.02,
                                    insertion_rate=0.02, deletion_rate=0.02,
                                    seed=2)
            sim.generate(CACHE, f"reads_{tag}", NUM_READS)
        else:
            sim = ShortReadSimulator(cfg, substitution_rate=0.002,
                                     insertion_rate=0.00025,
                                     deletion_rate=0.00025, seed=2)
            sim.read(genome)
            sim.generate(CACHE, f"reads_{tag}", NUM_READS)

    from bucketmap_tpu.io import native
    io_native = native.available()  # (re)builds csrc from source on demand
    log(f"[bench] native host-IO: {'ENGAGED' if io_native else 'python fallback'}")
    # STREAMED mapping (round 5): the full-file parse held 4 dense
    # (1M, 300) matrices + the byte buffer (~2 GB); map_fastq now
    # parses + maps + emits per ~128k-read chunk. Only the warmup
    # prefix is parsed up front.
    t0 = time.time()
    from bucketmap_tpu.io.fastq import iter_fastq_batches
    warm_batch = next(iter(iter_fastq_batches(fastq_path,
                                              reads_per_batch=BATCH)))
    log(f"[bench] warmup prefix parsed in {time.time()-t0:.2f}s "
        f"({warm_batch.num_reads} reads)")

    # when the fine index exceeds the device budget the pipeline falls to
    # the table-free packed-scan vote path, which materializes
    # (vote_chunk, bucket_len) intermediates — cap the pair chunk there
    from bucketmap_tpu.mapper.device_pipeline import fine_index_fits
    fine_fits = fine_index_fits(index, devs[0])
    # align mode: DP sub-batches of 16384 pairs (half the dispatches of
    # 8192); the vote chunk is capped separately (pipeline.py)
    pair_batch = int(os.environ.get(
        "BMTPU_BENCH_PAIR_BATCH",
        str((16384 if ALIGN else BATCH) if fine_fits else 1024)))
    pipe = BucketMapPipeline(
        index, batch_size=BATCH, pair_batch=pair_batch, align=ALIGN,
        fetch_group=int(os.environ.get("BMTPU_FETCH_GROUP", "1")))
    # warmup: compile all jit programs on a small prefix. With a hot
    # persistent cache this is seconds; a cold cache pays full XLA
    # compile once and the next run hits.
    t0 = time.time()
    pipe.map_reads(warm_batch, os.path.join(CACHE, "warmup.sam"))
    warmup_s = time.time() - t0
    log(f"[bench] warmup (compile) {warmup_s:.1f}s "
        f"({'hot' if warmup_s < 60 else 'cold'} persistent cache)")
    del warm_batch

    sam_path = os.path.join(CACHE, f"out_{tag}{'_al' if ALIGN else ''}.sam")
    t0 = time.time()
    stats = pipe.map_fastq(fastq_path, sam_path)
    dt = time.time() - t0
    rps = stats.num_reads / dt
    log(f"[bench] mapped {stats.num_reads} reads in {dt:.1f}s: "
        f"{rps:.0f} reads/s  (coarse {stats.coarse_seconds:.1f}s, "
        f"fine {stats.fine_seconds:.1f}s, out {stats.output_seconds:.1f}s, "
        f"pairs {stats.candidate_pairs}, locations {stats.mapped_locations})")
    # resource snapshot BEFORE scoring: the accuracy scorer is a separate
    # analyzer in the reference's discipline (/usr/bin/time wraps the MAP
    # run only, benchmark/short_read/benchmark_map.sh) — its Python string
    # lists would otherwise dominate peak RSS
    from bucketmap_tpu.utils.debug import resource_report
    rsrc = resource_report()

    # accuracy vs ground truth (vectorized: numpy column scan, no
    # per-read Python dict loop)
    gt_path = os.path.join(CACHE, f"reads_{tag}.position_ground_truth")
    t0 = time.time()
    mapped_pct, correct_pct = score_sam(sam_path, gt_path, index)
    # the reference analyzer's default tolerance is +-5
    # (sam_file_analyzer.cpp:60); report it alongside the +-10 headline
    _, correct_tol5 = score_sam(sam_path, gt_path, index, tol=5)
    extra = {}
    if index_build_s is not None:
        extra["index_build_seconds"] = round(index_build_s, 1)
    if LONG:
        # +-10 is the short-read convention (sam_file_analyzer.cpp default);
        # ONT indels drift the implied read start by ~sqrt(rate*len) bases,
        # so also score at a drift-aware tolerance like long-read evals do
        tol = max(10, int(0.02 * stats.num_bases / max(1, stats.num_reads)))
        _, correct_drift = score_sam(sam_path, gt_path, index, tol=tol)
        extra[f"pct_correct_position_tol{tol}"] = round(correct_drift, 2)
    log(f"[bench] %mapped={mapped_pct:.2f} %correct-position={correct_pct:.2f} "
        f"{extra} (scored in {time.time()-t0:.1f}s)")

    if LONG:
        mean_len = stats.num_bases / max(1, stats.num_reads)
        desc = (f"{NUM_READS} x ~{mean_len/1000:.1f}kb ONT-like reads, "
                f"{GENOME_MBP:g} Mbp repeat-structured genome; vs_baseline "
                f"= bases/s over the 3116 reads/s x 300bp short-read "
                f"align-free C++ baseline (no valid reference long-read "
                f"time exists: its committed runs exited 255)")
        vsb = rps * mean_len / BASELINE_BASES_PER_SEC
    else:
        desc = (f"{NUM_READS} x 300bp sim reads, {GENOME_MBP:g} Mbp "
                f"{'uniform' if UNIFORM else 'repeat-structured'} genome"
                + (f", FracMinHash f={FRAC:g}" if FRAC != 1.0 else "")
                + f", {'align' if ALIGN else 'align-free'}")
        vsb = rps / (BASELINE_READS_PER_SEC_ALIGN if ALIGN
                     else BASELINE_READS_PER_SEC_NOALIGN)
    hbm_peak = rsrc["device_hbm_peak_bytes"]
    log(f"[bench] peak host RSS {rsrc['peak_host_rss_kb']/1048576:.2f} GB, "
        f"device memory peak {hbm_peak/2**30:.2f} GB")
    print(json.dumps({
        "metric": f"reads_per_sec_per_gpu ({desc})",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(vsb, 3),
        "pct_mapped": round(mapped_pct, 2),
        "pct_correct_position": round(correct_pct, 2),
        "pct_correct_position_tol5": round(correct_tol5, 2),
        "locations_per_read": round(stats.mapped_locations / stats.num_reads, 4),
        "warmup_seconds": round(warmup_s, 1),
        "peak_host_rss_kb": rsrc["peak_host_rss_kb"],
        "device_hbm_peak_bytes": hbm_peak,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
        "io_native": io_native,
        **extra,
    }))


if __name__ == "__main__":
    main()
