"""End-to-end mapping pipeline: FASTQ -> coarse -> fine -> [align] -> SAM.

Orchestrates the device stages over fixed-shape batches. Long reads
(> 2*read_len) are decomposed into num_segment_samples read_len-windows
(q_gram_mapper.h:510-516); each segment is an independent batch row, and
segment results fold back to read coordinates (bucket_locator.h:671-693).
Reads of length (read_len, 2*read_len] are queried on their first
read_len bases only, like the reference (q_gram_mapper.h:521).
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax
import numpy as np

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import BucketIndex
from bucketmap_tpu.io.fastq import ReadBatch, read_fastq
from bucketmap_tpu.io.sam import SamWriter
from bucketmap_tpu.ops.coarse import CoarseMapper
from bucketmap_tpu.ops.sampler import sample_deterministic
from bucketmap_tpu.ops.vote import FineLocator


@dataclasses.dataclass
class Location:
    bucket: int
    offset: int          # read start within the bucket
    seg_offset: int
    votes: int
    is_orig: bool


def filter_best_locations(locs: list[Location], read_length: int,
                          indel_rate: float) -> list[Location]:
    """Literal port of _filter_best_locations (bucket_locator.h:350-405):
    merge votes onto ALL earlier proposals with the same (bucket, strand)
    within +-read_len*indel_rate (std::map iteration = sorted key order),
    then keep every location with the max total votes.

    A sorted key list + bisect replaces the reference's std::map scan, so
    repeat-heavy reads with many locations stay O(n log n) — the +=
    merge is order-independent, result identical."""
    import bisect

    loc_votes: dict[tuple[int, int, bool], int] = {}
    keys: list[tuple[int, int, bool]] = []   # kept sorted
    for loc in locs:
        key = (loc.bucket, loc.offset, loc.is_orig)
        if not loc_votes:
            loc_votes[key] = loc.votes
            keys.append(key)
        else:
            lo = int(loc.offset - read_length * indel_rate)
            hi = int(loc.offset + read_length * indel_rate)
            a = bisect.bisect_left(keys, (loc.bucket, lo, False))
            b = bisect.bisect_right(keys, (loc.bucket, hi, True))
            found = False
            for k in keys[a:b]:
                if lo <= k[1] <= hi and k[2] == loc.is_orig:
                    loc_votes[k] += loc.votes
                    found = True
            if not found:
                if key in loc_votes:
                    loc_votes[key] += loc.votes
                else:
                    loc_votes[key] = loc.votes
                    bisect.insort(keys, key)
    best: list[Location] = []
    max_votes = 0
    for k in keys:
        v = loc_votes[k]
        if v > max_votes:
            best, max_votes = [], v
        if v == max_votes:
            best.append(Location(k[0], k[1], 0, v, k[2]))
    return best


@dataclasses.dataclass
class MapStats:
    num_reads: int = 0
    num_bases: int = 0
    reads_with_candidates: int = 0
    candidate_pairs: int = 0
    mapped_locations: int = 0
    coarse_seconds: float = 0.0
    fine_seconds: float = 0.0
    output_seconds: float = 0.0


class BucketMapPipeline:
    def __init__(self, index: BucketIndex, align: bool = False,
                 batch_size: int = 512, pair_batch: int = 256,
                 pairs_per_read: int = 4, mesh=None, prefetch: int = 4,
                 fetch_group: int = 1):
        self.index = index
        self.cfg = index.config
        self.align = align
        self.batch_size = batch_size
        # fetch_group > 1 concatenates K step outputs ON DEVICE and
        # fetches them with one device_get (one transfer instead of K).
        # Default 1
        self.fetch_group = max(1, fetch_group)
        self.prefetch = max(1, prefetch, 2 * self.fetch_group)
        from bucketmap_tpu.mapper.device_pipeline import DeviceMapper
        # vote chunks cap at 4096 lanes: big enough to fill the device
        # with fine-stage gathers, small enough that cond-skipped dead
        # chunks waste little of the lane budget
        self.device = DeviceMapper(index, batch_size=batch_size,
                                   pairs_per_read=pairs_per_read,
                                   vote_chunk=min(4096, pair_batch,
                                                  batch_size),
                                   mesh=mesh)
        self.coarse = self.device.coarse
        self.fine = self.device.fine
        self.fine.pair_batch = pair_batch
        if align:
            from bucketmap_tpu.ops.align import BandedAligner
            self.aligner = BandedAligner(index, pair_batch=pair_batch)
            if mesh is None:
                # share the device-resident packed genome with the fine
                # stage (a second jnp.asarray would duplicate 0.4+ GB of
                # HBM)
                self.aligner.buckets_packed = self.fine.buckets_packed
            else:
                # mesh mode: the fine stage's copy is bucket-SHARDED, but
                # the aligner gathers arbitrary global bucket rows. Give
                # it its own copy of the 2-bit genome on the mesh's first
                # device (0.25 B/base — 0.78 GB even at GRCh38 scale) and
                # run the DP stage there: a sharded gather would
                # all-gather the table per dispatch, and replicated
                # compute would redo the same DP on every device.
                self.aligner.buckets_packed = jax.device_put(
                    np.asarray(index.buckets_packed), mesh.devices.flat[0])
        self._bucket_sam_offset = index.ref_offset_of_bucket()
        # vectorized 2-location merge fast path (tests toggle this to
        # compare against the literal sequential merge)
        self._vector_pair_merge = True

    # ------------------------------------------------------------------
    def _all_segments(self, batch: ReadBatch):
        """Fixed-shape segment arrays for ALL reads: codes/quals
        (S, read_len), seg_len, seg_read, seg_off. Short reads (<=
        2*read_len) are a vectorized copy; long reads expand to
        num_segment_samples windows (q_gram_mapper.h:510-516)."""
        cfg = self.cfg
        rl = cfg.read_len
        lengths = batch.lengths
        n = batch.num_reads
        long_mask = lengths > 2 * rl

        if not long_mask.any():
            # fast path (typical short-read workloads): segment = row prefix
            seg_read = np.arange(n, dtype=np.int32)
            seg_off = np.zeros(n, dtype=np.int32)
            seg_len = np.minimum(lengths, rl).astype(np.int32)
            if batch.codes.shape[1] == rl:
                codes, quals = batch.codes, batch.quals
            else:
                width = min(batch.codes.shape[1], rl)
                codes = np.zeros((n, rl), np.uint8)
                quals = np.zeros((n, rl), np.uint8)
                codes[:, :width] = batch.codes[:, :width]
                quals[:, :width] = batch.quals[:, :width]
            # zero any tail beyond rl in rows longer than rl (reads in
            # (rl, 2rl] are queried on their first rl bases only)
            return codes, quals, seg_len, seg_read, seg_off

        short_idx = np.nonzero(~long_mask)[0]
        rows = [short_idx]
        offs = [np.zeros(len(short_idx), np.int64)]
        for r in np.nonzero(long_mask)[0]:
            starts = sample_deterministic(cfg.num_segment_samples,
                                          int(lengths[r]) - rl - 1)
            rows.append(np.full(len(starts), r, np.int64))
            offs.append(starts.astype(np.int64))
        seg_read = np.concatenate(rows)
        seg_off = np.concatenate(offs)

        seg_len = np.minimum(lengths[seg_read] - seg_off, rl).astype(np.int32)
        col = np.arange(rl)
        src = seg_off[:, None] + col[None, :]
        mask = col[None, :] < seg_len[:, None]
        src = np.where(mask, src, 0)
        codes = np.where(mask, batch.codes[seg_read[:, None], src], 0).astype(np.uint8)
        quals = np.where(mask, batch.quals[seg_read[:, None], src], 0).astype(np.uint8)
        return (codes, quals, seg_len, seg_read.astype(np.int32),
                seg_off.astype(np.int32))

    # ------------------------------------------------------------------
    def locate_chunks(self, batch: ReadBatch, stats: MapStats):
        """Generator over per-dispatch location chunks.

        Dispatch boundaries align to READ boundaries (a read's segments
        never straddle two dispatches), so every yielded chunk carries
        the COMPLETE location set for a contiguous read range — the SAM
        merge/emit can stream per chunk while the device computes the
        next batches. Yields (r, bk, off, votes, orig, so) arrays sorted
        by (read asc, bucket asc, original-strand first) — the
        reference's per-read location order.

        All device batches are dispatched asynchronously up front (one
        fused program per batch); collection then overlaps transfer,
        host work, and compute of consecutive batches.
        """
        cfg = self.cfg
        n = batch.num_reads

        t0 = time.perf_counter()
        codes, quals, seg_len, seg_read, seg_off = self._all_segments(batch)
        if not np.all(seg_read[:-1] <= seg_read[1:]):
            order = np.argsort(seg_read, kind="stable")
            codes, quals = codes[order], quals[order]
            seg_len, seg_read, seg_off = (seg_len[order], seg_read[order],
                                          seg_off[order])
        S = len(seg_read)
        bs = self.batch_size
        assert bs >= cfg.num_segment_samples

        bounds = []
        s = 0
        while s < S:
            e = min(s + bs, S)
            if e < S and seg_read[e] == seg_read[e - 1]:
                # retreat to this read's first segment (reads have at
                # most num_segment_samples segments << bs)
                e_adj = int(np.searchsorted(seg_read, seg_read[e], "left"))
                if e_adj > s:
                    e = e_adj
            bounds.append((s, e))
            s = e
        stats.coarse_seconds += time.perf_counter() - t0

        # Sliding dispatch window: keep `prefetch` batches in flight so
        # host packing of batch i+k overlaps device compute of batch i
        # (eager full dispatch would front-load ~5 s of packing before
        # the first collect at 1M-read scale).
        prefetch = self.prefetch
        inflight: list[tuple[int, int, object]] = []
        next_b = 0

        def _fill():
            nonlocal next_b
            t0 = time.perf_counter()
            while next_b < len(bounds) and len(inflight) < prefetch:
                sb, eb = bounds[next_b]
                inflight.append((sb, eb,
                                 self._dispatch(codes, quals, seg_len, sb, eb)))
                next_b += 1
            stats.coarse_seconds += time.perf_counter() - t0

        reads_with_cand = np.zeros(n, dtype=bool)
        _fill()
        while inflight:
            group = [inflight.pop(0)
                     for _ in range(min(self.fetch_group, len(inflight)))]
            t0 = time.perf_counter()
            if len(group) == 1:
                vecs = [np.asarray(jax.device_get(group[0][2]))]
            else:
                # one fetch for the whole group: concat on device
                flat = np.asarray(jax.device_get(
                    self.device.concat_outs([g[2] for g in group])))
                vl = flat.shape[0] // len(group)
                vecs = [flat[i * vl:(i + 1) * vl] for i in range(len(group))]
            stats.fine_seconds += time.perf_counter() - t0
            _fill()  # refill the window before host-side extraction
            for (s, e, _), vec in zip(group, vecs):
                t0 = time.perf_counter()
                host = self.device.decode_out(vec)
                stats.candidate_pairs += int(host["total_valid"])
                counts = host["counts"][: e - s]
                reads_with_cand[seg_read[s + np.nonzero(counts.sum(axis=1) > 0)[0]]] = True

                if (int(host["local_valid"].max()) > self.device.lane_budget
                        or int(host["n_accept"].max()) > self.device.out_cap):
                    # lane/output budget overflow (heavily repetitive
                    # genomes): redo this batch split in half — per-read
                    # budget doubles per split, stays on the (possibly
                    # sharded) fused path
                    chunks = self._locate_split(batch, seg_read, seg_off,
                                                seg_len, codes, quals, s, e)
                else:
                    chunks = [self._extract_chunk(host, s, e, batch,
                                                  seg_read, seg_off, seg_len)]
                r = np.concatenate([c[0] for c in chunks]).astype(np.int64)
                bk = np.concatenate([c[1] for c in chunks])
                off = np.concatenate([c[2] for c in chunks])
                votes = np.concatenate([c[3] for c in chunks]).astype(np.int64)
                orig = np.concatenate([c[4] for c in chunks])
                so = np.concatenate([c[5] for c in chunks]).astype(np.int64)
                order = np.lexsort((~orig, bk, r))
                stats.fine_seconds += time.perf_counter() - t0
                yield (r[order], bk[order], off[order], votes[order],
                       orig[order], so[order])
        stats.reads_with_candidates += int(reads_with_cand.sum())
        stats.num_reads += n
        stats.num_bases += int(batch.lengths.sum())

    def locate_arrays(self, batch: ReadBatch, stats: MapStats | None = None):
        """Map every read; returns parallel numpy arrays of locations
        (read, bucket, read_offset, votes, is_orig, seg_offset) sorted by
        (read asc, bucket asc, original-strand first)."""
        stats = stats if stats is not None else MapStats()
        chunks = list(self.locate_chunks(batch, stats))
        if chunks:
            out = tuple(np.concatenate([c[i] for c in chunks])
                        for i in range(6))
        else:
            z = np.zeros(0, np.int64)
            out = (z, z, z, z, np.zeros(0, bool), z)
        return out, stats

    def locate_batch(self, batch: ReadBatch, stats: MapStats | None = None):
        """Compatibility wrapper: per-read list[Location] view."""
        (r, bk, off, votes, orig, so), stats = self.locate_arrays(batch, stats)
        per_read: list[list[Location]] = [[] for _ in range(batch.num_reads)]
        for i in range(len(r)):
            per_read[r[i]].append(Location(int(bk[i]), int(off[i]), int(so[i]),
                                           int(votes[i]), bool(orig[i])))
        return per_read, stats

    # ------------------------------------------------------------------
    def _dispatch(self, codes, quals, seg_len, s, e):
        """Pad segment rows [s, e) to the batch size and dispatch (async)."""
        bs = self.batch_size
        pad = bs - (e - s)
        c, q, sl = codes[s:e], quals[s:e], seg_len[s:e]
        if pad:
            c = np.pad(c, ((0, pad), (0, 0)))
            q = np.pad(q, ((0, pad), (0, 0)))
            sl = np.pad(sl, (0, pad))
        return self.device.step(c, q, sl)

    def _extract_chunk(self, host, s, e, batch, seg_read, seg_off, seg_len):
        """Accepted lanes of one decoded dispatch -> location arrays in
        read coordinates (fold-back, bucket_locator.h:671-693)."""
        srow = s + host["lane_read"]
        keep = srow < e  # drop padded segment rows
        srow = srow[keep]
        r = seg_read[srow]
        so = seg_off[srow]
        sl = seg_len[srow]
        x = host["offset"][keep]
        rc = host["lane_rc"][keep]
        read_off = np.where(rc, x - (batch.lengths[r] - so - sl), x - so)
        return (r, host["lane_bucket"][keep].astype(np.int64),
                read_off.astype(np.int64), host["votes"][keep],
                ~rc, so)

    def _locate_split(self, batch, seg_read, seg_off, seg_len,
                      codes, quals, s, e):
        """Overflow fallback: re-dispatch [s, e) as two halves through the
        fused step (budget per read doubles each level); a single row can
        never overflow (lane_budget >= 2 * max_candidate_buckets)."""
        mid = (s + e) // 2
        parts = ((s, mid), (mid, e)) if e - s > 1 else ((s, e),)
        chunks = []
        for a, b in parts:
            if a == b:
                continue
            host = self.device.decode_out(
                np.asarray(jax.device_get(
                    self._dispatch(codes, quals, seg_len, a, b))))
            if (int(host["local_valid"].max()) > self.device.lane_budget
                    or int(host["n_accept"].max()) > self.device.out_cap) \
                    and b - a > 1:
                chunks.extend(self._locate_split(batch, seg_read, seg_off,
                                                 seg_len, codes, quals, a, b))
            else:
                chunks.append(self._extract_chunk(host, a, b, batch,
                                                  seg_read, seg_off, seg_len))
        return chunks

    # ------------------------------------------------------------------
    def map_fastq(self, fastq_path, sam_path,
                  quality_threshold: int | None = None,
                  reads_per_chunk: int | None = None) -> MapStats:
        """STREAMED file mapping: parse + map + emit per ~128k-read
        chunk, holding ~two chunks of read arrays at any moment instead
        of the whole file (4 dense (n, L) matrices + the byte buffer =
        ~2 GB at 1M x 300bp; the reference's whole-run peak is 0.87 GB,
        benchmark/README.md:168). A reader thread pre-parses the next
        chunk while the current one maps, so parse time hides behind
        device compute. BMTPU_STREAM_CHUNK overrides the chunk size;
        0 disables streaming (whole-file parse, the old behavior)."""
        import queue
        import threading

        from bucketmap_tpu.io.fastq import iter_fastq_batches

        if reads_per_chunk is None:
            reads_per_chunk = int(os.environ.get("BMTPU_STREAM_CHUNK",
                                                 str(1 << 17)))
        if reads_per_chunk <= 0:
            return self.map_reads(read_fastq(fastq_path), sam_path,
                                  quality_threshold)
        cfg = self.cfg
        stats = MapStats()
        writer = SamWriter(sam_path, [n for n in self.index.ref_names],
                           self.index.sam_ref_lengths())
        qt = (cfg.quality_threshold if quality_threshold is None
              else quality_threshold)

        q: queue.Queue = queue.Queue(maxsize=1)
        rerr: list[BaseException] = []
        stop = threading.Event()

        def _reader():
            try:
                for b in iter_fastq_batches(fastq_path,
                                            reads_per_batch=reads_per_chunk):
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:
                rerr.append(e)
            finally:
                stop.set()      # EOF or error: q.get timeouts below end

        thr = threading.Thread(target=_reader, name="bmtpu-fastq-reader")
        thr.start()
        try:
            while True:
                try:
                    batch = q.get(timeout=0.25)
                except queue.Empty:
                    if stop.is_set() and q.empty():
                        break
                    continue
                self._map_batch(writer, batch, qt, stats)
                del batch
        finally:
            stop.set()          # error path: unblock the reader's put
            thr.join()
            writer.close()
        if rerr:
            raise rerr[0]
        return stats

    def map_reads(self, batch: ReadBatch, sam_path,
                  quality_threshold: int | None = None) -> MapStats:
        """Map one in-memory ReadBatch (tests, warmup, simulators)."""
        cfg = self.cfg
        stats = MapStats()
        writer = SamWriter(sam_path, [n for n in self.index.ref_names],
                           self.index.sam_ref_lengths())
        qt = (cfg.quality_threshold if quality_threshold is None
              else quality_threshold)
        try:
            self._map_batch(writer, batch, qt, stats)
        finally:
            writer.close()
        return stats

    def _map_batch(self, writer, batch: ReadBatch, qt, stats) -> None:
        """Locate + merge + SAM-emit one ReadBatch, STREAMED per device
        dispatch with a dedicated writer thread: the collection loop
        stays blocked on device results while merge/format/write of
        earlier chunks runs on the writer (numpy + native-C formatting
        release the GIL). The reference runs these phases strictly
        sequentially (bucket_locator.h:455-611); round 2 interleaved
        them on one thread, which serialized host output against
        collection on slow hosts. output_seconds is writer-thread time
        (overlapped)."""
        import queue
        import threading

        from bucketmap_tpu.utils.debug import maybe_trace

        if self.align:
            # two-phase: locate everything first, then align ALL
            # locations in one pass. Interleaving per-chunk alignment
            # with the map loop puts each align job behind the queued
            # map dispatches on the in-order device (measured 1.4 s per
            # 13k-location chunk); batched at the end, the aligner's
            # async sub-batch dispatches overlap their own downloads.
            chunks = list(self.locate_chunks(batch, stats))
            t0 = time.perf_counter()
            if chunks:
                chunk = tuple(np.concatenate([c[i] for c in chunks])
                              for i in range(6))
            else:
                z = np.zeros(0, np.int64)
                chunk = (z, z, z, z, np.zeros(0, bool), z)
            self._emit_locations(writer, batch, chunk, qt, stats)
            stats.output_seconds += time.perf_counter() - t0
            return

        q: queue.Queue = queue.Queue(maxsize=max(2, self.prefetch))
        werr: list[BaseException] = []

        def _writer_loop():
            while True:
                chunk = q.get()
                if chunk is None:
                    return
                try:
                    t0 = time.perf_counter()
                    self._emit_locations(writer, batch, chunk, qt, stats)
                    stats.output_seconds += time.perf_counter() - t0
                except BaseException as e:  # propagate to the main thread
                    werr.append(e)
                    return

        thr = threading.Thread(target=_writer_loop, name="bmtpu-sam-writer")
        thr.start()
        try:
            with maybe_trace():  # BMTPU_PROFILE=<dir> -> jax.profiler trace
                for chunk in self.locate_chunks(batch, stats):
                    if werr:
                        break
                    q.put(chunk)
        finally:
            q.put(None)
            thr.join()
        if werr:
            raise werr[0]

    def _emit_locations(self, writer, batch, chunk, qt, stats):
        """Merge + format + write SAM records for one location chunk
        (a contiguous read range with complete location sets)."""
        cfg = self.cfg
        lr, lbk, loff, lvotes, lorig, _lso = chunk
        bucket_sam_off = self._bucket_sam_offset

        if not self.align:
            # alignment-free: merge/keep-best per read. Reads with a single
            # location (the overwhelming majority) pass through unchanged;
            # only multi-location reads run the literal merge.
            n = batch.num_reads
            # lr is sorted: multi-location reads = runs of equal ids
            multi_mask = np.zeros(len(lr), bool)
            if len(lr) > 1:
                same = lr[1:] == lr[:-1]
                multi_mask[1:] |= same
                multi_mask[:-1] |= same
            s_r = lr[~multi_mask]
            s_bk = lbk[~multi_mask]
            s_off = loff[~multi_mask]
            s_votes = lvotes[~multi_mask]
            s_orig = lorig[~multi_mask]

            m_read, m_bk, m_off, m_votes, m_orig = [], [], [], [], []
            if multi_mask.any():
                mr = lr[multi_mask]
                mbk, moff = lbk[multi_mask], loff[multi_mask]
                mv, mo = lvotes[multi_mask], lorig[multi_mask]
                starts = np.nonzero(np.diff(mr, prepend=-1))[0]
                ends = np.append(starts[1:], len(mr))
                runlen = ends - starts
                pairable = (runlen == 2) if self._vector_pair_merge \
                    else np.zeros_like(runlen, bool)
                # 2-location runs (the bulk on real genomes) vectorize:
                # the literal merge reduces to one comparison per pair
                # (same bucket+strand within +-read_len*indel_rate ->
                # vote sum onto the FIRST; else keep max-vote side(s),
                # ties keep both in (bucket, offset, strand) key order)
                p2 = starts[pairable]
                if len(p2):
                    i1, i2 = p2, p2 + 1
                    x = batch.lengths[mr[i1]] * cfg.indel_rate
                    lo = np.trunc(moff[i2] - x)
                    hi = np.trunc(moff[i2] + x)
                    merged = ((mbk[i1] == mbk[i2]) & (mo[i1] == mo[i2])
                              & (lo <= moff[i1]) & (moff[i1] <= hi))
                    k1_first = ((mbk[i1] < mbk[i2])
                                | ((mbk[i1] == mbk[i2])
                                   & ((moff[i1] < moff[i2])
                                      | ((moff[i1] == moff[i2])
                                         & (~mo[i1] | mo[i2])))))
                    vsum = mv[i1] + mv[i2]
                    for sel1, sel2, v1, v2 in (
                            (merged, None, vsum, None),
                            (~merged & (mv[i1] > mv[i2]), None, mv[i1], None),
                            (~merged & (mv[i2] > mv[i1]), "i2", mv[i2], None),
                            (~merged & (mv[i1] == mv[i2]) & k1_first, "both12",
                             mv[i1], mv[i2]),
                            (~merged & (mv[i1] == mv[i2]) & ~k1_first,
                             "both21", mv[i1], mv[i2])):
                        idx = np.nonzero(sel1)[0]
                        if not len(idx):
                            continue
                        a1, a2 = i1[idx], i2[idx]
                        if sel2 is None:        # first location wins
                            m_read.extend(mr[a1]); m_bk.extend(mbk[a1])
                            m_off.extend(moff[a1]); m_votes.extend(v1[idx])
                            m_orig.extend(mo[a1])
                        elif sel2 == "i2":      # second location wins
                            m_read.extend(mr[a2]); m_bk.extend(mbk[a2])
                            m_off.extend(moff[a2]); m_votes.extend(mv[a2])
                            m_orig.extend(mo[a2])
                        else:                   # tie: both, key order
                            first, second = (a1, a2) if sel2 == "both12" \
                                else (a2, a1)
                            for aa in (first, second):
                                m_read.extend(mr[aa]); m_bk.extend(mbk[aa])
                                m_off.extend(moff[aa]); m_votes.extend(mv[aa])
                                m_orig.extend(mo[aa])
                # runs > 2: the literal sequential merge
                for a, b in zip(starts[~pairable], ends[~pairable]):
                    r = int(mr[a])
                    locs = [Location(int(mbk[i]), int(moff[i]), 0,
                                     int(mv[i]), bool(mo[i]))
                            for i in range(a, b)]
                    for loc in filter_best_locations(
                            locs, int(batch.lengths[r]), cfg.indel_rate):
                        m_read.append(r)
                        m_bk.append(loc.bucket)
                        m_off.append(loc.offset)
                        m_votes.append(loc.votes)
                        m_orig.append(loc.is_orig)

            rec_read = np.concatenate([s_r, np.asarray(m_read, np.int64)])
            rec_bucket = np.concatenate([s_bk, np.asarray(m_bk, np.int64)])
            rec_off = np.concatenate([s_off, np.asarray(m_off, np.int64)])
            rec_votes = np.concatenate([s_votes, np.asarray(m_votes, np.int64)])
            rec_orig = np.concatenate([s_orig, np.asarray(m_orig, bool)])
            order = np.argsort(rec_read, kind="stable")
            rec_read, rec_bucket, rec_off = rec_read[order], rec_bucket[order], rec_off[order]
            rec_votes, rec_orig = rec_votes[order], rec_orig[order]

            rec_flag = np.where(rec_orig, 0, 16).astype(np.int32)
            rec_pos0 = bucket_sam_off[rec_bucket] + rec_off
            rec_mapq = np.minimum(60, 6 * rec_votes).astype(np.int32)
            rec_cigar = None
        else:
            # align mode: every location goes through the banded aligner;
            # tracebacks are RLE'd to CIGAR bytes per sub-batch (native
            # C) and records stream to a writer thread as sub-batches
            # land — SAM formatting/IO overlaps the next DP dispatch.
            # Location chunks are read-sorted and sub-batches contiguous,
            # so in-order emission preserves read order.
            # Long reads (> 2*read_len) route to the segment-stitched
            # aligner: a 7.5 kb ONT read drifts far past the 128-diagonal
            # band, so whole-read banded DP silently fails (its windows
            # are the read_len segments, where the band holds).
            long_mask = batch.lengths[lr] > 2 * self.cfg.read_len
            if long_mask.any():
                self._align_long_emit(
                    writer, batch, lr[long_mask], lbk[long_mask],
                    loff[long_mask], lorig[long_mask], _lso[long_mask],
                    qt, stats)
            if not long_mask.all():
                sm = ~long_mask
                self._align_stream_emit(writer, batch, lr[sm], lbk[sm],
                                        loff[sm], lorig[sm], qt, stats)
            return
        stats.mapped_locations += len(rec_read)
        self._emit_records(writer, batch, rec_read, rec_flag, rec_bucket,
                           rec_pos0, rec_mapq, rec_cigar)

    def _align_long_emit(self, writer, batch, lr, lbk, loff, lorig, lso,
                         qt, stats):
        """Segment-stitched alignment for long reads (> 2*read_len).

        The whole-read banded DP cannot hold a multi-kb ONT read: net
        indel drift walks off the 128-diagonal band and the voted begin
        has O(indel_rate*len) error. Instead, every surviving SEGMENT
        location (the 5 read_len windows of q_gram_mapper.h:510-516,
        pre-merge) is aligned with the standard short-read kernel
        against a window at ITS OWN voted offset — the band trivially
        holds over 300 bases — and the host stitches:

          * clusters segment locations per (read, bucket, strand) within
            a read-length of each other (one cluster = one mapping),
          * refines the read start from the boundary segment's DP begin
            (segment 0 starts at read position 0, so its begin IS the
            read begin; reverse-strand uses the max-offset segment and
            TRUE forward-genome coordinates — the short-read rc window
            quirk would shift POS by indel_rate*len ≈ 750 bases, far
            past any tolerance, so it does not apply here),
          * concatenates the verified segment CIGARs with gap filler
            between anchors (min(g_r,g_t) M + |g_r-g_t| I/D), emitted in
            reference order for reverse-strand records; query-consuming
            ops always sum to the read length,
          * MAPQ = clip(60 + 120 * sum(score)/sum(seg_len), 0, 60) — an
            identity-margin score (6% ONT error -> ~45; an unrelated
            locus scores < 0 -> 0 and is dropped by the quality gate).
            The short-read path's size_t wrap stays untouched; it is a
            reproduced reference quirk, meaningless at ONT error rates.

        The reference has no observable long-read align behavior to
        match: every committed bucketmap_align long-read run exited 255
        (benchmark/long_read/log). This is new capability (all DPs are
        fixed-shape read_len-row batches).
        """
        cfg = self.cfg
        rl = cfg.read_len
        n = len(lr)
        if n == 0:
            return
        lens = batch.lengths[lr].astype(np.int64)
        so = lso.astype(np.int64)
        sl = np.minimum(lens - so, rl).astype(np.int64)
        off_j = np.where(lorig, loff + so,
                         loff + (lens - so - sl)).astype(np.int64)
        col = np.arange(rl)
        mask = col[None, :] < sl[:, None]
        src = np.where(mask, so[:, None] + col[None, :], 0)
        qcodes = np.where(mask, batch.codes[lr[:, None], src], 0) \
            .astype(np.uint8)

        sc = np.zeros(n, np.int64)
        bg = np.zeros(n, np.int64)
        nM = np.zeros(n, np.int64)
        nI = np.zeros(n, np.int64)
        nD = np.zeros(n, np.int64)
        seg_runs: list = [None] * n

        def emit_runs(s, e, sc_, bg_, nr, runs, row_off):
            sc[s:e] = sc_
            bg[s:e] = bg_
            tot = int(row_off[-1])
            ops_f = (runs[:tot] & 3).astype(np.int64)
            lens_f = (runs[:tot] >> 2).astype(np.int64)
            row_id = np.repeat(np.arange(e - s), np.diff(row_off))
            for code, acc in ((1, nM), (2, nI), (3, nD)):
                acc[s:e] = np.bincount(
                    row_id, weights=np.where(ops_f == code, lens_f, 0),
                    minlength=e - s)
            for i in range(e - s):
                r0, r1 = int(row_off[i]), int(row_off[i + 1])
                seg_runs[s + i] = [(int(l), int(o)) for l, o in
                                   zip(lens_f[r0:r1], ops_f[r0:r1])]

        # ONT-rate segments carry ~2*indel_rate*read_len runs each —
        # budget well above the short-read default. wrap_star=False: a
        # segment with > 60 edits is still a usable traceback here (the
        # size_t-wrap '*' rule is a short-read parity quirk).
        self.aligner.align_batch_runs_stream(
            qcodes, sl.astype(np.int32), lbk.astype(np.int32),
            off_j.astype(np.int32), ~lorig, emit_runs,
            run_cap_per_pair=48, wrap_star=False)

        blen = np.asarray(self.index.bucket_lengths)[lbk]
        width = np.minimum(sl + 1 + (cfg.indel_rate * sl).astype(np.int64),
                           blen - off_j)
        # stitching coordinate p: increases along the STORED read
        # direction (forward: p = absolute; reverse: p = -absolute)
        begin_p = np.where(lorig, off_j + bg,
                           -(off_j + width - 1 - bg))
        TL = nM + nD
        seg_ok = (nM + nI) == sl                  # traceback spans the segment

        # ---- cluster + stitch ------------------------------------------
        rec_read, rec_flag, rec_bucket = [], [], []
        rec_pos0, rec_mapq, rec_cigar = [], [], []
        op_char = {1: b"M", 2: b"I", 3: b"D"}
        gkeys = np.stack([lr, lbk, lorig.astype(np.int64)], axis=1)
        bounds = np.nonzero(np.any(np.diff(gkeys, axis=0) != 0, axis=1))[0] + 1
        bounds = np.concatenate([[0], bounds, [n]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            grp = np.arange(a, b)[np.argsort(loff[a:b], kind="stable")]
            rlen = int(lens[a])
            # clusters: loff gaps beyond a read length start a new mapping
            cl_start = 0
            cuts = list(np.nonzero(np.diff(loff[grp]) > rlen)[0] + 1) + [len(grp)]
            for cut in cuts:
                members = grp[cl_start:cut]
                cl_start = cut
                members = members[np.argsort(so[members], kind="stable")]
                # dedupe segment offsets (repeat loci in one cluster)
                _, keep = np.unique(so[members], return_index=True)
                members = members[np.sort(keep)]
                valid = members[seg_ok[members]]
                if len(valid) == 0:
                    continue
                cov = int(sl[valid].sum())
                rate = float(sc[valid].sum()) / max(1, cov)
                mapq = max(0, min(60, 60 + int(np.floor(120.0 * rate))))
                if mapq < qt:
                    continue
                runs: list[tuple[int, int]] = []
                first = valid[0]
                pcur = int(begin_p[first] - so[first])
                rcur = 0
                for j in valid:
                    g_r = int(so[j]) - rcur
                    g_t = max(0, int(begin_p[j]) - pcur)
                    m = min(g_r, g_t)
                    if m:
                        runs.append((m, 1))
                    if g_r > g_t:
                        runs.append((g_r - g_t, 2))
                    elif g_t > g_r:
                        runs.append((g_t - g_r, 3))
                    runs.extend(seg_runs[j])
                    rcur = int(so[j] + sl[j])
                    pcur = int(begin_p[j] + TL[j])
                tail = rlen - rcur
                if tail > 0:
                    runs.append((tail, 1))
                    pcur += tail
                is_fwd = bool(lorig[first])
                if is_fwd:
                    pos0 = int(begin_p[first] - so[first])
                else:
                    # leftmost forward-genome base = last stored-direction
                    # position; reference-order CIGAR = reversed runs
                    pos0 = -(pcur - 1)
                    runs = runs[::-1]
                # merge adjacent equal ops (filler meeting segment edges)
                merged: list[tuple[int, int]] = []
                for cnt, op in runs:
                    if merged and merged[-1][1] == op:
                        merged[-1] = (merged[-1][0] + cnt, op)
                    else:
                        merged.append((cnt, op))
                rec_read.append(int(lr[first]))
                rec_flag.append(0 if is_fwd else 16)
                rec_bucket.append(int(lbk[first]))
                rec_pos0.append(max(0, pos0))
                rec_mapq.append(mapq)
                rec_cigar.append(b"".join(
                    str(c).encode() + op_char[o] for c, o in merged))

        stats.mapped_locations += len(rec_read)
        if rec_read:
            bucket_sam_off = self._bucket_sam_offset
            rb = np.asarray(rec_bucket, np.int64)
            self._emit_records(
                writer, batch, np.asarray(rec_read, np.int64),
                np.asarray(rec_flag, np.int32), rb,
                bucket_sam_off[rb] + np.asarray(rec_pos0, np.int64),
                np.asarray(rec_mapq, np.int32), rec_cigar)

    def _align_stream_emit(self, writer, batch, lr, lbk, loff, lorig, qt,
                           stats):
        import queue
        import threading

        bucket_sam_off = self._bucket_sam_offset
        if not len(lr):
            return
        wq: queue.Queue = queue.Queue(maxsize=4)
        werr: list[BaseException] = []

        def _writer_loop():
            # After a write failure the loop keeps DRAINING jobs (discarding
            # them) until the sentinel: exiting here would leave the producer
            # blocked forever in wq.put on the bounded queue (e.g. ENOSPC
            # mid-run) instead of seeing werr and propagating the error.
            failed = False
            while True:
                job = wq.get()
                if job is None:
                    return
                if failed:
                    continue
                try:
                    self._emit_records(writer, batch, *job)
                except BaseException as e:
                    werr.append(e)
                    failed = True

        thr = threading.Thread(target=_writer_loop, name="bmtpu-align-emit")
        thr.start()

        def emit(s, e, scores, begins, cbuf, coffs):
            # size_t wrap: scores below -60 bypass the threshold
            # (bucket_locator.h:571); seqan3 then truncates to uint8
            mapq = 60 + scores.astype(np.int64)
            mapq = np.where(mapq < 0, mapq & 0xFF, mapq)
            keep = np.where(scores < -60, True, mapq >= qt)
            kidx = np.nonzero(keep)[0]
            rec_read = lr[s:e][keep]
            rec_bucket = lbk[s:e][keep]
            rec_flag = np.where(lorig[s:e][keep], 0, 16).astype(np.int32)
            rec_pos0 = (bucket_sam_off[rec_bucket] + begins[keep]
                        + loff[s:e][keep])
            rec_mapq = mapq[keep].astype(np.int32)
            # gather the kept rows' CIGAR byte spans (vectorized)
            klens = coffs[kidx + 1] - coffs[kidx]
            koffs = np.zeros(len(kidx) + 1, np.int64)
            np.cumsum(klens, out=koffs[1:])
            if len(kidx) and koffs[-1]:
                src = (np.repeat(coffs[kidx] - koffs[:-1], klens)
                       + np.arange(koffs[-1], dtype=np.int64))
                kbuf = np.frombuffer(cbuf, np.uint8)[src].tobytes()
            else:
                kbuf = b""
            stats.mapped_locations += len(rec_read)
            if werr:
                raise werr[0]
            wq.put((rec_read, rec_flag, rec_bucket, rec_pos0, rec_mapq,
                    (kbuf, koffs)))

        lri = lr.astype(np.int32)
        # short-path reads are <= 2*read_len by definition; in a MIXED
        # batch the code matrix is as wide as the longest (long) read —
        # slice it down or the DP compiles Q = longest-read rows
        qc = batch.codes[lri]
        wmax = min(qc.shape[1], 2 * self.cfg.read_len)
        qc = np.ascontiguousarray(qc[:, :wmax])
        try:
            self.aligner.align_batch_stream(
                qc, batch.lengths[lri],
                lbk.astype(np.int32), loff.astype(np.int32), ~lorig, emit)
        finally:
            wq.put(None)
            thr.join()
        if werr:
            raise werr[0]

    # ------------------------------------------------------------------
    def _emit_records(self, writer, batch, rec_read, rec_flag, rec_bucket,
                      rec_pos0, rec_mapq, rec_cigar):
        """rec_cigar: (cigar_buf bytes, (n+1,) offsets) per-record spans
        (empty span = '*'), a list of bytes per record, or None = all '*'."""
        from bucketmap_tpu.io import native

        if isinstance(rec_cigar, list):
            buf = b"".join(rec_cigar)
            offs = np.zeros(len(rec_cigar) + 1, np.int64)
            np.cumsum([len(c) for c in rec_cigar], out=offs[1:])
            rec_cigar = (buf, offs)

        bucket_names = self.index.bucket_names
        if native.available() and len(rec_read):
            ids_buf = batch.ids_buf
            id_offsets = batch.id_offsets
            # rname per bucket -> its reference's (truncated) name
            ref_short = [n.split(" ")[0].encode() for n in self.index.ref_names]
            rnames_buf = b"".join(ref_short)
            rname_offsets = np.zeros(len(ref_short) + 1, np.int64)
            np.cumsum([len(x) for x in ref_short], out=rname_offsets[1:])
            rid = self.index.bucket_ref[np.asarray(rec_bucket, np.int64)]
            if rec_cigar is None:
                cigar_buf = b"\0"
                cigar_offsets = np.zeros(len(rec_read) + 1, np.int64)
            else:
                cigar_buf = rec_cigar[0] or b"\0"
                cigar_offsets = rec_cigar[1]
            rr = np.asarray(rec_read, np.int32)
            out = native.format_sam_records(
                rr, id_offsets, np.ascontiguousarray(ids_buf, np.uint8),
                np.asarray(rec_flag, np.int32), rid.astype(np.int32),
                rname_offsets, np.frombuffer(rnames_buf, np.uint8),
                np.asarray(rec_pos0, np.int64), np.asarray(rec_mapq, np.int32),
                cigar_offsets, np.frombuffer(cigar_buf, np.uint8),
                rr, batch.lengths[rr].astype(np.int32),
                batch.seq_ascii, batch.qual_ascii)
            if out is not None:
                writer._f.flush()
                writer._f.buffer.write(out) if hasattr(writer._f, "buffer") \
                    else writer._f.write(out.decode())
                return
        for i in range(len(rec_read)):
            r = int(rec_read[i])
            seq = batch.seq_ascii[r, : batch.lengths[r]].tobytes().decode()
            qual = batch.qual_ascii[r, : batch.lengths[r]].tobytes().decode()
            cig = "*" if rec_cigar is None else (
                rec_cigar[0][rec_cigar[1][i]:rec_cigar[1][i + 1]].decode()
                or "*")
            writer.write(batch.ids[r], int(rec_flag[i]),
                         bucket_names[int(rec_bucket[i])],
                         int(rec_pos0[i]), int(rec_mapq[i]), seq, qual, cig)
