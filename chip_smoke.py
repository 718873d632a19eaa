"""Smoke run of the mapper on one NVIDIA GPU: `python chip_smoke.py`.

Phases, in order; any failure exits non-zero:
  1. device   — the first JAX device must be a GPU (else exit 1, naming
                the missing GPU); prints its kind and count, the card's
                nvidia-smi name and power limit, the JAX version, the
                compile-cache directory and whether native host IO is on.
  2. main     — bench.py's default deployment: a 1.7 Gbp repeat-
                structured genome, bucket_len 65536, read_len 300, f=1.0,
                the positional fine index built on the device. Simulated
                reads are mapped with map_fastq as the CLI calls it,
                align-free (B=16384) and with --align (B=8192); each SAM
                must reach >= 99.0% mapped and >= 98.0% correct within
                +-10. Prints compile time, the memory_stats() peak,
                reads/s, and device times of the map step, the coarse
                query and one align sub-batch of 16384 pairs. Every
                device computation is XLA's: the repository has no
                hand-written kernel (PERF.md says why).
  3. cpu-equal — on a 4.6 Mbp 2-reference world with 2000 reads, the
                GPU SAMs (align-free and --align) must equal byte for byte
                the SAMs a CPU-only child process (the CLI under
                JAX_PLATFORMS=cpu) writes from the same files.
The last line is {"ok": true, "device": {...}}.

`--four-gpu` runs only the mesh path on four GPUs: the sharded map step
on a 2x2 ("data", "bucket") mesh against the single-device step on the
same batch, and BucketMapPipeline(mesh=...) with --align against the
single-device pipeline, on the 4.6 Mbp world. Its last line reports
"count": 4.

Work files go to <repo>/.smoke/ (listed in .gitignore).
"""

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from bucketmap_tpu.utils.device import (gpu_name_power_limit,  # noqa: E402
                                        require_gpu, setup_compile_cache)

WORK = os.path.join(REPO, ".smoke")
CARD = ""          # first card's nvidia-smi name + power limit (phase 1)


def log(*a):
    print(*a, flush=True)


def device_seconds(fn, *args, reps: int = 10) -> float:
    """Median wall time of fn(*args) to completion (block_until_ready),
    after one warm-up call that compiles."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ----------------------------------------------------------------------
def phase_device(program: str):
    global CARD
    import jax

    devs = require_gpu(program)
    smi = gpu_name_power_limit()
    CARD = smi.splitlines()[0]
    from bucketmap_tpu.io import native

    log(f"[device] {devs[0].device_kind} x{len(devs)} ({devs[0].platform}); "
        f"jax {jax.__version__}")
    log("[device] nvidia-smi --query-gpu=name,power.limit:")
    log(smi)
    log(f"[device] compile cache: {setup_compile_cache()}")
    log(f"[device] native host IO: "
        f"{'engaged' if native.available() else 'not engaged'}")
    return devs


# ----------------------------------------------------------------------
def simulate(index_cfg, genome, out_dir, name, n_reads, seed=2):
    from bucketmap_tpu.sim.simulator import ShortReadSimulator

    sim = ShortReadSimulator(index_cfg, substitution_rate=0.002,
                             insertion_rate=0.00025, deletion_rate=0.00025,
                             seed=seed)
    sim.read(genome)
    return sim.generate(out_dir, name, n_reads)


def first_batch(fastq, n):
    from bucketmap_tpu.io.fastq import iter_fastq_batches

    return next(iter(iter_fastq_batches(fastq, reads_per_batch=n)))


def step_timings(pipe, fastq, B: int):
    """Device times of the fused map step and of the coarse query alone
    at batch B."""
    import jax
    import jax.numpy as jnp

    from bucketmap_tpu.ops.encoding import pack_reads, unpack_reads

    dev, cfg = pipe.device, pipe.cfg
    batch = first_batch(fastq, B)
    n = batch.num_reads
    codes = np.zeros((B, cfg.read_len), np.uint8)
    quals = np.zeros((B, cfg.read_len), np.uint8)
    w = min(cfg.read_len, batch.codes.shape[1])
    codes[:n, :w] = batch.codes[:, :w]
    quals[:n, :w] = batch.quals[:, :w]
    lengths = np.zeros(B, np.int32)
    lengths[:n] = np.minimum(batch.lengths, cfg.read_len)
    packed = jnp.asarray(pack_reads(codes, quals, lengths, cfg.query_seed,
                                    cfg.mapper_min_kmer_quality))
    _, vote_tabs = dev._vote_impl_and_tabs()
    step_args = (*dev.coarse._index_args(), vote_tabs, dev.fine.sample_tab,
                 packed)
    out = {"map_step_s": device_seconds(dev._step, *step_args)}

    c, q, ln = unpack_reads(packed, cfg.read_len, cfg.query_seed, xp=jnp)
    query = jax.jit(dev.coarse._query_impl)
    out["coarse_query_s"] = device_seconds(
        query, *dev.coarse._index_args(), c, q, ln)
    return out


def align_timings(pipe, fastq, gt_bucket, P: int = 16384):
    """Device time of one align sub-batch of P pairs (windows, DP,
    traceback, RLE) and of its forward DP alone, on the simulated reads
    at their true buckets and offsets."""
    import jax
    import jax.numpy as jnp

    from bucketmap_tpu.ops.align import band_geometry, dp_forward, pack_qcodes

    al, cfg = pipe.aligner, pipe.cfg
    batch = first_batch(fastq, P)
    n = batch.num_reads
    gt = np.loadtxt(gt_bucket, dtype=np.int64, usecols=(0, 1, 2),
                    max_rows=n).reshape(-1, 3)
    take = np.arange(P) % n
    Q = -(-batch.codes.shape[1] // 16) * 16      # the packed query width
    qcodes = np.zeros((P, Q), np.uint8)
    qcodes[:, :batch.codes.shape[1]] = batch.codes[take]
    qlen = batch.lengths[take].astype(np.int32)
    bids = gt[take, 0].astype(np.int32)
    offs = gt[take, 1].astype(np.int32)
    is_rc = gt[take, 2].astype(bool)
    width = np.minimum(
        qlen + 1 + (cfg.indel_rate * qlen).astype(np.int64),
        np.asarray(pipe.index.bucket_lengths)[bids] - offs).astype(np.int32)
    run_cap = -(-al.run_cap_per_pair * P // 2) * 2
    fn = jax.jit(lambda *a: al._align_runs_impl(*a, run_cap=run_cap))
    args = (al.buckets_tiled, jnp.asarray(pack_qcodes(qcodes)),
            jnp.asarray(qlen), jnp.asarray(bids), jnp.asarray(offs),
            jnp.asarray(is_rc), jnp.asarray(width))
    out = {"align_subbatch_s": device_seconds(fn, *args)}
    band, lo = band_geometry(Q, cfg.indel_rate)
    rng = np.random.RandomState(3)
    textp = jnp.asarray(rng.randint(0, 4, (P, Q + band + lo)), jnp.int32)
    fwd = jax.jit(lambda *a: dp_forward(*a, band, lo))
    out["align_dp_forward_s"] = device_seconds(
        fwd, textp, jnp.asarray(qcodes, jnp.int32), jnp.asarray(qlen),
        jnp.asarray(width))
    return out


def map_mode(index, fastq, gt_pos, align: bool, B: int, tag: str,
             vote_path: str | None):
    """map_fastq as `cli map --batch-size B [--align]` calls it; a first
    run compiles, a second is timed. Returns (pipeline, numbers)."""
    from bucketmap_tpu.bench.sam_analyzer import score_sam
    from bucketmap_tpu.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu.utils.debug import resource_report

    t0 = time.time()
    pipe = BucketMapPipeline(index, align=align, batch_size=B, pair_batch=B)
    init_s = time.time() - t0
    sam = os.path.join(WORK, f"{tag}.sam")
    t0 = time.time()
    pipe.map_fastq(fastq, sam)
    warm_s = time.time() - t0
    t0 = time.time()
    stats = pipe.map_fastq(fastq, sam)
    dt = time.time() - t0
    mapped, correct = score_sam(sam, gt_pos, index)
    peak = resource_report()["device_hbm_peak_bytes"]
    mode = "align" if align else "align-free"
    log(f"[main] {mode} B={B}: {stats.num_reads} reads, {mapped:.2f}% "
        f"mapped, {correct:.2f}% correct within +-10, "
        f"{stats.mapped_locations / stats.num_reads:.4f} locations/read; "
        f"init {init_s:.1f} s, first run (compile) {warm_s:.1f} s, "
        f"{stats.num_reads / dt:.0f} reads/s, memory peak "
        f"{(peak or 0) / 2**30:.2f} GiB, vote path {pipe.device._vote_path} "
        f"[{CARD}]")
    if vote_path and pipe.device._vote_path != vote_path:
        raise AssertionError(f"{mode}: vote path {pipe.device._vote_path}, "
                             f"expected {vote_path}")
    if mapped < 99.0 or correct < 98.0:
        raise AssertionError(
            f"{mode}: {mapped:.2f}% mapped / {correct:.2f}% correct is "
            f"below 99.0 / 98.0")
    return pipe, {"mapped_pct": mapped, "correct_pct": correct,
                  "reads_per_s": stats.num_reads / dt, "warmup_s": warm_s,
                  "peak_bytes": peak}


def phase_main(genome_mbp: float = 1700.0, n_reads: int = 16384,
               B: int = 16384, B_align: int = 8192, align_pairs: int = 16384,
               vote_path: str | None = "packed"):
    """vote_path: the fine path the pipeline must take ("packed" = the
    positional index built on the device); None accepts any."""
    from bucketmap_tpu.config import MapperConfig
    from bucketmap_tpu.index import builder
    from bucketmap_tpu.sim.simulator import repeat_genome

    cfg = MapperConfig(bucket_len=65536, read_len=300)
    t0 = time.time()
    genome = repeat_genome(int(genome_mbp * 1e6), seed=1, n_refs=4)
    t_gen = time.time() - t0
    t0 = time.time()
    index = builder.build_index(genome, cfg)
    t_idx = time.time() - t0
    t0 = time.time()
    paths = simulate(cfg, genome, WORK, "main", n_reads)
    t_sim = time.time() - t0
    del genome
    gc.collect()
    log(f"[main] {genome_mbp:g} Mbp repeat genome ({index.n_buckets} "
        f"buckets): generated {t_gen:.1f} s, host index {t_idx:.1f} s, "
        f"{n_reads} reads simulated {t_sim:.1f} s")
    fq = paths["fastq"]
    numbers = {}
    pipe, numbers["align_free"] = map_mode(index, fq, paths["position_gt"],
                                           False, B, "main_free", vote_path)
    t = step_timings(pipe, fq, B)
    numbers["align_free"].update(t)
    log(f"[main] device time at B={B}: map step "
        f"{t['map_step_s'] * 1e3:.2f} ms, coarse query "
        f"{t['coarse_query_s'] * 1e3:.2f} ms "
        f"({100 * t['coarse_query_s'] / t['map_step_s']:.1f}% of the step) "
        f"[{CARD}]")
    del pipe
    gc.collect()
    pipe, numbers["align"] = map_mode(index, fq, paths["position_gt"], True,
                                      B_align, "main_align", vote_path)
    t = align_timings(pipe, fq, paths["bucket_gt"], align_pairs)
    numbers["align"].update(t)
    log(f"[main] device time of one align sub-batch of {align_pairs} "
        f"pairs: {t['align_subbatch_s'] * 1e3:.2f} ms, forward DP alone "
        f"{t['align_dp_forward_s'] * 1e3:.2f} ms "
        f"({100 * t['align_dp_forward_s'] / t['align_subbatch_s']:.1f}%) "
        f"[{CARD}]")
    del pipe
    gc.collect()
    return numbers


# ----------------------------------------------------------------------
def small_world(n_reads: int = 2000, genome_len: int = 4_600_000):
    """E. coli-scale world saved under WORK: index "ecoli" (with the host
    fine index) and reads "ecoli_reads"."""
    from bucketmap_tpu.config import MapperConfig
    from bucketmap_tpu.index import builder
    from bucketmap_tpu.sim.simulator import random_genome

    cfg = MapperConfig(bucket_len=65536, read_len=300)
    genome = random_genome(genome_len, seed=1, n_refs=2)
    index = builder.build_index(genome, cfg)
    builder.build_fine_index(index)
    builder.save_index(index, WORK, "ecoli", overwrite=True)
    paths = simulate(cfg, genome, WORK, "ecoli_reads", n_reads)
    return index, paths


def cli_map_args(fastq, sam, align: bool, B: int):
    return (["map", "-i", "ecoli", "--index-dir", WORK, "-q", fastq,
             "-o", sam, "--batch-size", str(B)]
            + (["--align"] if align else []))


def phase_cpu_equal(n_reads: int = 2000, B: int = 1024):
    from bucketmap_tpu.cli import main as cli_main

    _, paths = small_world(n_reads)
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    for align in (False, True):
        mode = "align" if align else "align-free"
        gpu_sam = os.path.join(WORK, f"ecoli_gpu_{int(align)}.sam")
        cpu_sam = os.path.join(WORK, f"ecoli_cpu_{int(align)}.sam")
        if cli_main(cli_map_args(paths["fastq"], gpu_sam, align, B)) != 0:
            raise AssertionError(f"GPU cli map ({mode}) failed")
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "bucketmap_tpu.cli",
             *cli_map_args(paths["fastq"], cpu_sam, align, B)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise AssertionError(f"CPU child ({mode}) failed:\n{r.stderr}")
        with open(gpu_sam, "rb") as f:
            g = f.read()
        with open(cpu_sam, "rb") as f:
            c = f.read()
        if g != c:
            raise AssertionError(f"{mode}: GPU SAM != CPU SAM")
        n_rec = sum(1 for line in g.splitlines() if not line.startswith(b"@"))
        log(f"[cpu-equal] 4.6 Mbp, {n_reads} reads, {mode}: GPU SAM == CPU "
            f"SAM byte for byte ({len(g)} bytes, {n_rec} records; CPU child "
            f"{time.time() - t0:.1f} s)")


# ----------------------------------------------------------------------
def accepted(host):
    return set(zip(*(np.asarray(host[k]).tolist() for k in
                     ("lane_read", "lane_bucket", "lane_rc", "offset",
                      "votes"))))


def phase_mesh(n_devices: int = 4, n_reads: int = 2000, B: int = 2048):
    """Sharded map step on a 2x2 mesh vs the single-device step on the
    same batch; mesh pipeline with --align vs the single-device one."""
    import jax

    from bucketmap_tpu.mapper.device_pipeline import DeviceMapper
    from bucketmap_tpu.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu.parallel.sharding import make_mesh

    index, paths = small_world(n_reads)
    mesh = make_mesh(n_devices, data=2, bucket=n_devices // 2)
    batch = first_batch(paths["fastq"], B)
    cfg = index.config
    n = batch.num_reads
    codes = np.zeros((B, cfg.read_len), np.uint8)
    quals = np.zeros((B, cfg.read_len), np.uint8)
    codes[:n] = batch.codes[:, :cfg.read_len]
    quals[:n] = batch.quals[:, :cfg.read_len]
    lengths = np.zeros(B, np.int32)
    lengths[:n] = batch.lengths
    hosts = {}
    for name, m in (("mesh", mesh), ("single", None)):
        dm = DeviceMapper(index, batch_size=B, pairs_per_read=4,
                          vote_chunk=1024, mesh=m)
        hosts[name] = dm.decode_out(np.asarray(jax.device_get(
            dm.step(codes, quals, lengths))))
        del dm
    a_mesh, a_single = accepted(hosts["mesh"]), accepted(hosts["single"])
    if (a_mesh != a_single or not np.array_equal(hosts["mesh"]["counts"],
                                                  hosts["single"]["counts"])
            or not a_mesh):
        raise AssertionError(
            f"sharded step != single-device step: only-mesh "
            f"{len(a_mesh - a_single)}, only-single {len(a_single - a_mesh)}")
    log(f"[mesh] sharded step on mesh {dict(mesh.shape)} == single-device "
        f"step: {len(a_mesh)} accepted locations for {n} reads, counts equal")
    sams = {}
    for name, m in (("mesh", mesh), ("single", None)):
        pipe = BucketMapPipeline(index, align=True, batch_size=1024,
                                 pair_batch=1024, mesh=m)
        sams[name] = os.path.join(WORK, f"ecoli_{name}_align.sam")
        t0 = time.time()
        pipe.map_fastq(paths["fastq"], sams[name])
        log(f"[mesh] {name} pipeline --align: {time.time() - t0:.1f} s")
        del pipe
    with open(sams["mesh"], "rb") as f:
        sm = f.read()
    with open(sams["single"], "rb") as f:
        ss = f.read()
    if sm != ss:
        raise AssertionError("mesh --align SAM != single-device SAM")
    log(f"[mesh] BucketMapPipeline(mesh=...) --align SAM == single-device "
        f"SAM byte for byte ({len(sm)} bytes) [{CARD}]")


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpu", action="store_true",
                    help="run only the mesh path on four GPUs")
    args = ap.parse_args(argv)

    devs = phase_device("chip_smoke.py")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    if args.four_gpu:
        if len(devs) < 4:
            raise SystemExit(f"--four-gpu needs 4 GPUs; JAX found "
                             f"{len(devs)}")
        phase_mesh(4)
    else:
        phase_main()
        phase_cpu_equal()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
