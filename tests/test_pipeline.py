import numpy as np
import pytest

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_index
from bucketmap_tpu.io.fastq import read_fastq
from bucketmap_tpu.io.sam import read_sam
from bucketmap_tpu.mapper.pipeline import BucketMapPipeline, Location, filter_best_locations
from bucketmap_tpu.sim.simulator import ShortReadSimulator, random_genome

CFG = MapperConfig(bucket_len=4096, read_len=150, index_seed=6, query_seed=9,
                   mapper_samples=8)


@pytest.fixture(scope="module")
def world():
    genome = random_genome(120_000, seed=21, n_refs=2)
    index = build_index(genome, CFG)
    return genome, index


def test_filter_best_locations_merging():
    # two close locations on the same bucket+strand merge their votes
    locs = [Location(3, 100, 0, 5, True), Location(3, 102, 0, 4, True),
            Location(7, 50, 0, 6, True)]
    best = filter_best_locations(locs, 150, 0.02)  # window +-3
    assert len(best) == 1
    assert (best[0].bucket, best[0].offset, best[0].votes) == (3, 100, 9)
    # strand mismatch does not merge
    locs = [Location(3, 100, 0, 5, True), Location(3, 101, 0, 5, False)]
    best = filter_best_locations(locs, 150, 0.02)
    assert len(best) == 2  # tie: both kept


def test_errorfree_reads_map_exactly(world, tmp_path):
    genome, index = world
    sim = ShortReadSimulator(CFG, seed=31)
    sim.read(genome)
    paths = sim.generate(tmp_path, "clean", 300, simulate_error=False)
    batch = read_fastq(paths["fastq"])
    pipe = BucketMapPipeline(index, batch_size=128, pair_batch=64)
    stats = pipe.map_reads(batch, tmp_path / "clean.sam")

    gt = [line.split() for line in open(paths["position_gt"])]
    recs = {}
    for rec in read_sam(tmp_path / "clean.sam"):
        recs.setdefault(rec["qname"], []).append(rec)
    correct = 0
    for i, (rid, pos, rc, _cigar) in enumerate(gt):
        for rec in recs.get(str(i), []):
            ref_ok = rec["rname"] == index.ref_names[int(rid)].split(" ")[0]
            strand_ok = (rec["flag"] & 16 == 16) == bool(int(rc))
            if ref_ok and strand_ok and abs(rec["pos"] - int(pos)) <= 2:
                correct += 1
                break
    assert correct >= 290, f"{correct}/300 exact maps"
    assert stats.mapped_locations >= 290


def test_noisy_reads_map_mostly(world, tmp_path):
    genome, index = world
    sim = ShortReadSimulator(CFG, substitution_rate=0.01, insertion_rate=0.001,
                             deletion_rate=0.001, seed=32)
    sim.read(genome)
    paths = sim.generate(tmp_path, "noisy", 300)
    batch = read_fastq(paths["fastq"])
    pipe = BucketMapPipeline(index, batch_size=128, pair_batch=64)
    pipe.map_reads(batch, tmp_path / "noisy.sam")

    gt = [line.split() for line in open(paths["position_gt"])]
    recs = {}
    for rec in read_sam(tmp_path / "noisy.sam"):
        recs.setdefault(rec["qname"], []).append(rec)
    correct = 0
    for i, (rid, pos, rc, _cigar) in enumerate(gt):
        for rec in recs.get(str(i), []):
            ref_ok = rec["rname"] == index.ref_names[int(rid)].split(" ")[0]
            strand_ok = (rec["flag"] & 16 == 16) == bool(int(rc))
            if ref_ok and strand_ok and abs(rec["pos"] - int(pos)) <= 10:
                correct += 1
                break
    # reference achieves ~97% at these error rates on real genomes
    assert correct >= 270, f"{correct}/300 correct within tolerance"


def test_mapq_and_sam_shape(world, tmp_path):
    genome, index = world
    sim = ShortReadSimulator(CFG, seed=33)
    sim.read(genome)
    paths = sim.generate(tmp_path, "shape", 50, simulate_error=False)
    batch = read_fastq(paths["fastq"])
    pipe = BucketMapPipeline(index, batch_size=64, pair_batch=64)
    pipe.map_reads(batch, tmp_path / "shape.sam")
    lines = open(tmp_path / "shape.sam").read().splitlines()
    sq = [l for l in lines if l.startswith("@SQ")]
    assert len(sq) == len(index.ref_names)
    # LN is the reference's upper bound: buckets_in_ref * bucket_len
    assert sq[0].split("\t")[2] == f"LN:{index.sam_ref_lengths()[0]}"
    for rec in read_sam(tmp_path / "shape.sam"):
        assert rec["mapq"] == 60  # error-free: all locator samples vote
        assert rec["cigar"] == "*"
        assert len(rec["seq"]) == len(rec["qual"])


def test_long_read_segmentation(world, tmp_path):
    genome, index = world
    # synth a long read straight from the genome: 700bp > 2*read_len
    rng = np.random.RandomState(4)
    rec = genome[0]
    start = 10_000
    frag = rec.codes[start : start + 700]
    from bucketmap_tpu.ops.encoding import decode_to_ascii

    fastq = tmp_path / "long.fastq"
    seq = decode_to_ascii(frag).decode()
    fastq.write_text(f"@long0\n{seq}\n+\n{'E' * len(seq)}\n")
    batch = read_fastq(fastq)
    pipe = BucketMapPipeline(index, batch_size=16, pair_batch=64)
    pipe.map_reads(batch, tmp_path / "long.sam")
    recs = list(read_sam(tmp_path / "long.sam"))
    assert recs, "long read unmapped"
    bucket = start // CFG.bucket_len
    within = start - bucket * CFG.bucket_len
    # read start in reference coordinates
    assert any(abs(r["pos"] - (start + 1)) <= CFG.allowed_indel for r in recs), recs


def test_sorted_vote_matches_scan_vote(world, tmp_path):
    """The positional-fine-index vote must produce identical results to the
    packed-scan vote."""
    import copy
    from bucketmap_tpu.index.builder import build_fine_index
    from bucketmap_tpu.ops.vote import FineLocator

    genome, index = world
    index2 = copy.copy(index)
    build_fine_index(index2)
    sim = ShortReadSimulator(CFG, substitution_rate=0.01, seed=77)
    sim.read(genome)
    fl_scan = FineLocator(index)
    fl_sorted = FineLocator(index2)
    rng = np.random.RandomState(5)
    n = 64
    codes = np.zeros((n, CFG.read_len), np.uint8)
    lens = np.zeros(n, np.int32)
    gt_bucket = np.zeros(n, np.int32)
    rcs = np.zeros(n, bool)
    for i in range(n):
        c, bucket, start, rc, _ = sim.sample()
        c = c[: CFG.read_len]
        codes[i, : len(c)] = c
        lens[i] = len(c)
        gt_bucket[i] = bucket
        rcs[i] = rc
    quals = np.full((n, CFG.read_len), 36, np.uint8)
    sh, si = fl_scan.prepare(codes, quals, lens)
    o1, v1, a1 = fl_scan.vote(gt_bucket, rcs, sh, si, lens)
    o2, v2, a2 = fl_sorted.vote(gt_bucket, rcs, sh, si, lens)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(o1[a1], o2[a2])
    np.testing.assert_array_equal(v1[a1], v2[a2])
    assert a1.sum() >= 50  # most reads vote through


def test_pipeline_with_fine_index(world, tmp_path):
    import copy
    from bucketmap_tpu.index.builder import build_fine_index

    genome, index = world
    index2 = copy.copy(index)
    build_fine_index(index2)
    sim = ShortReadSimulator(CFG, substitution_rate=0.01, seed=78)
    sim.read(genome)
    paths = sim.generate(tmp_path, "fidx", 200)
    batch = read_fastq(paths["fastq"])
    pipe = BucketMapPipeline(index2, batch_size=128, pair_batch=64)
    pipe.map_reads(batch, tmp_path / "fidx.sam")
    gt = [line.split() for line in open(paths["position_gt"])]
    recs = {}
    for rec in read_sam(tmp_path / "fidx.sam"):
        recs.setdefault(rec["qname"], []).append(rec)
    correct = 0
    for i, (rid, pos, rc, _cigar) in enumerate(gt):
        for rec in recs.get(str(i), []):
            if (rec["rname"] == index.ref_names[int(rid)].split(" ")[0]
                    and (rec["flag"] & 16 == 16) == bool(int(rc))
                    and abs(rec["pos"] - int(pos)) <= 10):
                correct += 1
                break
    assert correct >= 180, f"{correct}/200"


def test_vectorized_pair_merge_matches_literal(tmp_path):
    """The vectorized 2-location merge fast path must emit exactly the
    records of the literal filter_best_locations for every pair shape:
    merged (same bucket+strand, close), max-vote winner (either side),
    and equal-vote ties (both records, key order)."""
    import numpy as np

    from bucketmap_tpu.config import MapperConfig
    from bucketmap_tpu.index.builder import build_fine_index, build_index
    from bucketmap_tpu.mapper.pipeline import BucketMapPipeline, MapStats
    from bucketmap_tpu.sim.simulator import ShortReadSimulator, random_genome

    cfg = MapperConfig(bucket_len=1024, read_len=100, index_seed=5,
                       query_seed=8, mapper_samples=6, locator_samples=5)
    genome = random_genome(40_000, seed=11, n_refs=2)
    index = build_index(genome, cfg)
    build_fine_index(index)
    sim = ShortReadSimulator(cfg, substitution_rate=0.0, seed=12)
    sim.read(genome)
    sim.generate(tmp_path, "r", 32)
    pipe = BucketMapPipeline(index, batch_size=32, pair_batch=32)

    from bucketmap_tpu.io.fastq import read_fastq
    import os
    batch = read_fastq(os.path.join(tmp_path, "r.fastq"))

    rng = np.random.default_rng(5)
    n = 400
    r = np.repeat(np.arange(n // 2, dtype=np.int64) % 32, 2)
    bk = rng.integers(0, index.n_buckets, n)
    # force many same-bucket pairs so all branches trigger
    bk[1::2] = np.where(rng.random(n // 2) < 0.6, bk[0::2], bk[1::2])
    off = rng.integers(1, 900, n)
    off[1::2] = np.where(rng.random(n // 2) < 0.5,
                         np.clip(off[0::2] + rng.integers(-15, 15, n // 2),
                                 1, None), off[1::2])
    votes = rng.integers(1, 6, n)
    votes[1::2] = np.where(rng.random(n // 2) < 0.4, votes[0::2], votes[1::2])
    orig = rng.random(n) < 0.5
    orig[1::2] = np.where(rng.random(n // 2) < 0.6, orig[0::2], orig[1::2])
    order = np.lexsort((~orig, bk, r))
    chunk = (r[order], bk[order], off[order].astype(np.int64),
             votes[order].astype(np.int64), orig[order],
             np.zeros(n, np.int64))

    class Rec:
        def __init__(self):
            self.rows = []
        def write(self, *a):
            self.rows.append(a)
        _f = None

    outs = []
    for flag in (True, False):
        pipe._vector_pair_merge = flag
        w = Rec()
        # force the python writer (deterministic capture)
        import bucketmap_tpu.mapper.pipeline as pl_mod
        from bucketmap_tpu.io import native as native_mod
        avail = native_mod.available
        native_mod.available = lambda: False
        try:
            pipe._emit_locations(w, batch, chunk, cfg.quality_threshold,
                                 MapStats())
        finally:
            native_mod.available = avail
        outs.append(w.rows)
    assert outs[0] == outs[1]
    assert len(outs[0]) > 0

def test_align_stream_emit_writer_failure_propagates():
    """A write failure (e.g. ENOSPC) mid-stream must propagate, not
    deadlock: the bounded emit queue's writer thread drains remaining
    jobs after an exception so the producer's put never blocks
    (ADVICE r3, pipeline.py:_align_stream_emit)."""
    import threading
    import types

    n = 64  # >> queue maxsize (4) so a dead consumer would deadlock
    lr = np.arange(n, dtype=np.int64)
    lbk = np.zeros(n, np.int64)
    loff = np.zeros(n, np.int64)
    lorig = np.ones(n, bool)

    class FakeAligner:
        def align_batch_stream(self, qcodes, qlen, bucket_ids, offsets,
                               is_rc, emit):
            # many tiny sub-batches, each one emit() -> one queue put
            for s in range(len(bucket_ids)):
                sc = np.zeros(1, np.int32)
                bg = np.zeros(1, np.int32)
                emit(s, s + 1, sc, bg, b"", np.zeros(2, np.int64))

    class FakeBatch:
        codes = np.zeros((n, 8), np.uint8)
        lengths = np.full(n, 8, np.int64)

    calls = []

    def failing_emit_records(self, writer, batch, *rec):
        calls.append(1)
        raise OSError(28, "No space left on device")

    fake = types.SimpleNamespace(
        _bucket_sam_offset=np.zeros(4, np.int64),
        cfg=types.SimpleNamespace(read_len=8),
        aligner=FakeAligner())
    fake._emit_records = types.MethodType(failing_emit_records, fake)

    stats = types.SimpleNamespace(mapped_locations=0)
    result = {}

    def run():
        try:
            BucketMapPipeline._align_stream_emit(
                fake, None, FakeBatch(), lr, lbk, loff, lorig, 0, stats)
            result["raised"] = None
        except OSError as e:
            result["raised"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "deadlocked: producer blocked on dead writer"
    assert isinstance(result.get("raised"), OSError)
    assert len(calls) == 1  # writer stopped writing after the failure


def test_fetch_group_concat_fetch_matches_single(world, tmp_path):
    """fetch_group > 1 fetches K concatenated step outputs with one
    device_get (pipeline.py:locate_chunks). Off by default but shipped
    — its SAM must be byte-identical to the fetch_group=1 path,
    including across the final partial group."""
    genome, index = world
    sim = ShortReadSimulator(CFG, substitution_rate=0.01, seed=77)
    sim.read(genome)
    paths = sim.generate(tmp_path, "fg", 700)   # 6 batches of 128: 4+2 group
    batch = read_fastq(paths["fastq"])

    pipe1 = BucketMapPipeline(index, batch_size=128, pair_batch=64,
                              fetch_group=1)
    pipe1.map_reads(batch, tmp_path / "fg1.sam")
    pipe4 = BucketMapPipeline(index, batch_size=128, pair_batch=64,
                              fetch_group=4)
    assert pipe4.fetch_group == 4
    pipe4.map_reads(batch, tmp_path / "fg4.sam")
    assert (tmp_path / "fg1.sam").read_bytes() == (tmp_path / "fg4.sam").read_bytes()
