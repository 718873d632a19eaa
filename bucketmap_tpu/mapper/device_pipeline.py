"""Single-dispatch device map step (single device or sharded mesh).

The whole per-batch pipeline — coarse scoring, locator sampling,
candidate->pair compaction, and chunked fine voting — runs as ONE
jitted program, and the host downloads only the compact per-lane
results. Dispatches stay asynchronous, so consecutive batches overlap
transfer and compute.

Pair compaction: the (B, 2, C) candidate tensor is flattened and valid
lanes are packed (argsort on lane index, invalid keys pushed to the
end) into a fixed lane budget. If a batch ever produces more lanes than
the budget (heavily repetitive genomes), the host detects it from the
returned per-shard totals and re-runs that batch split in half (the
budget per read doubles each split).

Mesh mode (SPMD over a ('data', 'bucket') mesh via shard_map): reads
shard on 'data' (DP); the q-gram occupancy matrix AND all fine-stage
tables (fine_pos / fine_low / fine_ptab / buckets_packed) shard by
bucket range on 'bucket' — the index-parallel axis the reference cannot
have (its whole index lives in one address space, q_gram_mapper.h:318).
Each device scores its bucket range, the candidate policy runs on
all-gathered per-shard top-C lists (tiny), and every (read, candidate)
pair is voted by the device that OWNS the candidate's bucket range — no
all-to-all of reads (reads are replicated along the small 'bucket'
axis) and no gather across shards of the multi-GB fine tables. Device
memory per shard scales as 1/n_bucket_shards; see PERF.md for the
GRCh38 budget.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from bucketmap_tpu.index.builder import BucketIndex
from bucketmap_tpu.ops.coarse import CoarseMapper, _chunk_scan
from bucketmap_tpu.ops.encoding import pack_reads, unpack_reads
from bucketmap_tpu.ops.vote import FineLocator


def _resident_index_bytes(index: BucketIndex) -> int:
    """Device bytes of the index tables that sit beside the fine index:
    the occupancy words, the 2-bit genome and the fine prefix table."""
    return (index.qgram_words.nbytes + index.buckets_packed.nbytes
            + 4 * 4097 * index.n_buckets)


def fine_index_fits(index: BucketIndex, device, shards: int = 1,
                    n_rows: int | None = None) -> bool:
    """Whether the device-built fine index of `index` (4 B per slot;
    n_rows bucket rows, default all), split over `shards` bucket shards,
    fits fine_index_budget on `device` (its memory_stats() limit)."""
    rows = index.n_buckets if n_rows is None else n_rows
    lb = index.buckets_packed.shape[1] * 16
    limit = (device.memory_stats() or {}).get("bytes_limit")
    return 4 * rows * lb // shards <= fine_index_budget(
        limit, _resident_index_bytes(index) // shards)


def fine_index_budget(bytes_limit: int | None, resident_bytes: int) -> int:
    """Device bytes the positional fine index may take: the allocator's
    limit less the other resident index tables and a quarter of the
    limit, which stays free for the map step's per-batch buffers."""
    if not bytes_limit:
        raise RuntimeError(
            "the device reports no memory limit "
            "(memory_stats()['bytes_limit']): cannot size the fine index")
    return bytes_limit - bytes_limit // 4 - resident_bytes


class DeviceMapper:
    def __init__(self, index: BucketIndex, batch_size: int = 8192,
                 pairs_per_read: int = 4, vote_chunk: int = 1024,
                 mesh: jax.sharding.Mesh | None = None,
                 data_axis: str = "data", bucket_axis: str = "bucket"):
        self.index = index
        self.cfg = index.config
        self.batch_size = batch_size
        self.vote_chunk = vote_chunk
        self._padded_read_len = index.config.read_len
        self.coarse = CoarseMapper(index)
        self.fine = FineLocator(index)
        self.mesh = mesh
        self.data_axis, self.bucket_axis = data_axis, bucket_axis
        bp_dev = None
        if mesh is None:
            # One genome upload feeds BOTH on-device builds (occupancy +
            # fine) instead of one upload per consumer.
            env = os.environ.get("BMTPU_DEVICE_OCC", "auto")
            occ_want = env == "1" or (
                env == "auto" and jax.default_backend() != "cpu"
                and self.coarse._qgram_host.nbytes > (64 << 20))
            if occ_want:
                from bucketmap_tpu.index.builder import slab_upload
                bp_dev = slab_upload(index.buckets_packed)
                self.coarse._bp_dev = bp_dev
                _ = self.coarse.qgram_words   # device occupancy build now
                self.coarse._bp_dev = None
                # reuse for the scan-path vote / aligner window gathers
                self.fine.buckets_packed = bp_dev
        self._maybe_build_fine_on_device(bp_dev)
        if bp_dev is not None and self.fine.has("fine_packed"):
            # the packed vote path never touches bucket rows — do not
            # pin this 0.43 GB (1.7 Gbp) next to the fine tables. Back to
            # lazy: the aligner re-uploads on first use in align mode.
            self.fine._dev.pop("buckets_packed", None)
            del bp_dev
        # the genome artifact's file-backed pages (0.43 GB at 1.7 Gbp)
        # were touched by the device builds and stay counted in RSS;
        # nothing host-side reads them again on the packed path — drop
        # them (a later lazy access transparently re-pages)
        bph = self.index.buckets_packed
        if isinstance(bph, np.memmap):
            try:
                import mmap

                bph._mmap.madvise(mmap.MADV_DONTNEED)
            except (AttributeError, ValueError, OSError):
                pass
        if self.fine.has("fine_packed"):
            self._vote_path = "packed"
        elif self.fine.has("fine_ptab"):
            self._vote_path = "prefix"
        elif self.fine.has("fine_pos"):
            self._vote_path = "sorted"
        else:
            self._vote_path = "scan"

        if mesh is None:
            p = batch_size * pairs_per_read
            self.lane_budget = (p + vote_chunk - 1) // vote_chunk * vote_chunk
            self.out_cap = self._pick_out_cap(batch_size)
            self._init_pack_bits(batch_size)
            self._data_sharding = None
            self._step = jax.jit(self._step_impl)
        else:
            self._init_mesh(mesh, pairs_per_read)

    def _init_pack_bits(self, rows: int):
        """Bit layout of a packed accepted lane (2 uint32 words — see
        _pack_result):
          w0 = lane | votes << la | bucket_hi << (la + 8)
          w1 = offset | bucket_lo << ob
        lane < rows*2*C (la bits), votes clipped to 8 bits, offset <
        the packed bucket row length (ob bits), bucket splits around the
        32-ob boundary."""
        C = self.cfg.max_candidate_buckets
        nl = max(2, rows * 2 * C)
        self._lane_bits = (nl - 1).bit_length()
        lb = self.index.buckets_packed.shape[1] * 16
        self._off_bits = max(1, int(lb).bit_length())
        nb = max(2, getattr(self, "_n_pad_global", 0) or self.index.n_buckets)
        bucket_bits = (nb - 1).bit_length()
        bhi_bits = max(0, bucket_bits - (32 - self._off_bits))
        assert self._lane_bits + 8 + bhi_bits <= 32, \
            (self._lane_bits, self._off_bits, bucket_bits)

    def _pick_out_cap(self, rows: int) -> int:
        """Accepted-lane download budget per (shard-local) batch: ~1
        accepted location per read on real genomes (BASELINE.md: 1.11 -
        1.15/read), so 2x rows is generous; overflow re-dispatches the
        batch split in half like the lane budget does."""
        cap = min(self.lane_budget, max(4 * self.cfg.max_candidate_buckets,
                                        -(-2 * rows // 128) * 128))
        # votes are clipped to 8 bits in the packed lane (_init_pack_bits)
        assert self.cfg.locator_samples * FineLocator.MAX_OCC <= 255
        return cap

    # ------------------------------------------------------------------
    def _maybe_build_fine_on_device(self, bp_dev=None):
        """Construct the fine tables ON the device from buckets_packed
        instead of uploading multi-GB host arrays (index/device_build.py).
        Default on for single-device non-CPU backends when the table fits
        fine_index_budget; BMTPU_DEVICE_FINE=1/0 forces/disables. bp_dev:
        an existing device copy of buckets_packed to slice from (shared
        with the occupancy build) instead of per-chunk uploads."""
        env = os.environ.get("BMTPU_DEVICE_FINE", "auto")
        if env == "0" or self.mesh is not None:
            return
        idx = self.index
        lb = idx.buckets_packed.shape[1] * 16
        est_bytes = 4 * idx.n_buckets * lb
        if env != "1":
            if jax.default_backend() == "cpu":
                return  # host arrays transfer for free on CPU; keep tests
                        # on the host-built tables unless forced
            # only worth a device sort when the upload it replaces is big
            # (tiny worlds keep their configured path and skip the
            # build-kernel compile)
            if est_bytes < (64 << 20):
                return
            # a fine index that doesn't leave room for the other tables
            # + the batch must not be built: fall back to the table-free
            # packed-scan vote path
            if not fine_index_fits(idx, jax.devices()[0]):
                return
        from bucketmap_tpu.index.device_build import build_fine_index_on_device
        built = build_fine_index_on_device(self.index, bp_dev=bp_dev)
        if built is None:
            return
        fp, pt, steps, low_bits = built
        self.fine.fine_packed = fp
        self.fine.fine_ptab = pt
        self.fine.fine_low = None
        self.fine.fine_pos = None
        self.fine.search_steps = steps
        self.fine.low_bits = low_bits

    # ------------------------------------------------------------------
    def _init_mesh(self, mesh, pairs_per_read):
        from jax.sharding import NamedSharding, PartitionSpec as P

        da, ba = self.data_axis, self.bucket_axis
        Dd, Db = mesh.shape[da], mesh.shape[ba]
        self.Dd, self.Db = Dd, Db
        assert self.batch_size % Dd == 0, (self.batch_size, Dd)
        # per-device lane budget (rounded up to the vote chunk)
        p = self.batch_size * pairs_per_read // Db
        self.vote_chunk = min(self.vote_chunk, max(32, p))
        self.lane_budget = -(-p // self.vote_chunk) * self.vote_chunk
        assert self.lane_budget >= 2 * self.cfg.max_candidate_buckets

        ns = lambda *spec: NamedSharding(mesh, P(*spec))
        idx = self.index
        # Shard geometry. Every bucket table (occupancy words, fine_pos/
        # fine_ptab/buckets_packed/...) shards by word range: wr words ->
        # 32*wr bucket rows per shard; candidate ownership uses the same
        # ranges. The last shard's missing columns are zero and sit past
        # `bound`, so they can never produce candidates.
        w = idx.qgram_words.shape[1]
        wr = -(-w // Db)
        self._npf = 32 * wr                  # bucket rows per shard
        self._n_pad_global = 32 * wr * Db
        n = idx.n_buckets

        def padded(a, rows, fill):
            from bucketmap_tpu.index.builder import materialize
            if a is None:
                return None
            if a.shape[0] >= rows:
                return materialize(np.asarray(a))
            pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return np.pad(np.asarray(a), pad, constant_values=fill)

        # shard bi's columns = words [bi*wr, (bi+1)*wr), zero-padded
        qw = np.pad(np.asarray(idx.qgram_words), ((0, 0), (0, Db * wr - w)))
        npad = self._n_pad_global
        self.coarse.qgram_words = jax.device_put(qw, ns(None, ba))
        self.fine.bucket_lengths = jax.device_put(
            padded(idx.bucket_lengths, npad, 0), ns(ba))
        self.fine.buckets_packed = jax.device_put(
            padded(idx.buckets_packed, npad, 0), ns(ba, None))
        if self.fine.has("fine_pos"):
            self.fine.fine_pos = jax.device_put(
                padded(idx.fine_pos, npad, -1), ns(ba, None))
        if self.fine.has("fine_ptab"):
            self.fine.fine_ptab = jax.device_put(
                padded(idx.fine_ptab, npad, 0), ns(ba, None))
            if self.fine.has("fine_low"):
                self.fine.fine_low = jax.device_put(
                    padded(idx.fine_low, npad, 0xFFFF), ns(ba, None))
        if self.fine.has("fine_packed"):
            self.fine.fine_packed = jax.device_put(
                padded(idx.fine_packed, npad, 0xFFFFFFFF), ns(ba, None))
        self._data_sharding2 = ns(da, None)
        self._data_sharding = ns(da)

        # no host fine tables -> build them sharded ON the mesh (each
        # device sorts its own bucket range; no upload, no cross-shard
        # traffic), same flow as the single-device build but per shard
        if (self._vote_path == "scan"
                and os.environ.get("BMTPU_DEVICE_FINE", "auto") != "0"
                and jax.default_backend() != "cpu"):
            if fine_index_fits(idx, mesh.devices.flat[0], shards=Db,
                               n_rows=npad):
                from bucketmap_tpu.index.device_build import \
                    build_fine_index_on_device_sharded
                built = build_fine_index_on_device_sharded(
                    self.fine.buckets_packed, self.fine.bucket_lengths,
                    self.cfg, mesh, ba)
                if built is not None:
                    (self.fine.fine_packed, self.fine.fine_ptab,
                     self.fine.search_steps, self.fine.low_bits) = built
                    self._vote_path = "packed"

        vote_specs = {
            # fine_packed is 3-D tile-stored when device-built (the
            # hybrid-search layout), 2-D when uploaded from a host build
            "packed": (P(ba, None),
                       P(ba, *([None] * (self.fine.fine_packed.ndim - 1)))
                       if self.fine.has("fine_packed") else P(ba, None)),
            "prefix": (P(ba, None), P(ba, None), P(ba, None)),
            "sorted": (P(ba, None), P(ba, None)),
            "scan": (P(ba, None), P(ba)),
        }[self._vote_path]
        self.out_cap = self._pick_out_cap(self.batch_size // Dd)
        self._init_pack_bits(self.batch_size // Dd)
        self._step = jax.jit(jax.shard_map(
            self._sharded_step_impl, mesh=mesh,
            in_specs=(P(None, ba), P(), P(), P(None, None), vote_specs,
                      P(None, None), P(da, None)),
            out_specs=P((da, ba)),
            check_vma=False))

    # ------------------------------------------------------------------
    def _vote_impl_and_tabs(self):
        if self._vote_path == "packed":
            return self.fine._vote_packed_impl, (
                self.fine.fine_ptab, self.fine.fine_packed)
        if self._vote_path == "prefix":
            return self.fine._vote_prefix_impl, (
                self.fine.fine_ptab, self.fine.fine_low, self.fine.fine_pos)
        if self._vote_path == "sorted":
            return self.fine._vote_sorted_impl, (
                self.fine.fine_pos, self.fine.buckets_packed)
        return self.fine._vote_impl, (
            self.fine.buckets_packed, self.fine.bucket_lengths)

    def _chunked_vote(self, vote_impl, vote_tabs, total_valid, lane_bucket,
                      lane_rc, samp_hash, samp_idx, lengths, lane_read, P):
        """Voting chunked sequentially inside the dispatch; chunks whose
        lanes are all padding (compaction puts valid lanes first) skip
        the vote entirely via cond — on typical data only ~1/4 of the
        lane budget is live."""
        ch = self.vote_chunk
        n_chunks = P // ch

        def chunk_fn(args):
            ci, b, rc, sh, si, sl = args

            def live(_):
                return vote_impl(*vote_tabs, b, rc, sh, si, sl)

            def dead(_):
                z = jnp.zeros(b.shape, jnp.int32)
                return z, z, jnp.zeros(b.shape, bool)

            return jax.lax.cond(ci * ch < total_valid, live, dead, None)

        xs = (jnp.arange(n_chunks, dtype=jnp.int32),
              lane_bucket.reshape(n_chunks, ch),
              lane_rc.reshape(n_chunks, ch),
              samp_hash[lane_read].reshape(n_chunks, ch, -1),
              samp_idx[lane_read].reshape(n_chunks, ch, -1),
              lengths[lane_read].reshape(n_chunks, ch))
        off, votes, acc = jax.lax.map(chunk_fn, xs)
        return off.reshape(P), votes.reshape(P), acc.reshape(P)

    # ------------------------------------------------------------------
    def _step_impl(self, qgram_words, kmer_to_row, dist_tab, c_sample_tab,
                   vote_tabs, f_sample_tab, packed_reads):
        """packed_reads: (B, cw+qw+1) uint32 transfer layout (2-bit codes
        + quality-gate bitmask + length; encoding.pack_reads) — one
        array = one host->device transfer.

        vote_tabs is a tuple pytree whose layout matches the available
        fine index: (fine_ptab, fine_low, fine_pos) for the prefix path,
        (fine_pos, buckets_packed) for the plain positional path, else
        (buckets_packed, bucket_lengths) for the packed-scan path."""
        cfg = self.cfg
        B = packed_reads.shape[0]
        C = cfg.max_candidate_buckets
        P = self.lane_budget
        codes, qual_ok, lengths = unpack_reads(
            packed_reads, self._padded_read_len, cfg.query_seed, xp=jnp)
        cand, counts, _ = self.coarse._query_impl(
            qgram_words, kmer_to_row, dist_tab, c_sample_tab, codes, qual_ok,
            lengths)
        samp_hash, samp_idx = self.fine._prepare_impl(
            f_sample_tab, codes, qual_ok, lengths)

        # ---- compact valid candidate lanes into the lane budget ----------
        # scatter-by-rank (argsort over B*2*C keys costs a full sort
        # pass; the compaction only needs valid lanes first in lane
        # order). Slots past total_valid read lane 0 — everything
        # downstream is masked by slot_ok.
        flat = cand.reshape(-1)                       # (B*2*C,)
        nl = flat.shape[0]
        lane = jnp.arange(nl, dtype=jnp.int32)
        valid = flat >= 0
        rank = jnp.cumsum(valid.astype(jnp.int32))
        sel = jnp.zeros(P + 1, jnp.int32).at[
            jnp.where(valid, rank - 1, P)].set(lane, mode="drop")[:P]
        total_valid = rank[-1]
        slot_ok = jnp.arange(P, dtype=jnp.int32) < total_valid
        lane_read = sel // (2 * C)
        lane_rc = ((sel // C) % 2).astype(bool)
        lane_bucket = jnp.clip(flat[sel], 0, None).astype(jnp.int32)

        vote_impl = {"packed": self.fine._vote_packed_impl,
                     "prefix": self.fine._vote_prefix_impl,
                     "sorted": self.fine._vote_sorted_impl,
                     "scan": self.fine._vote_impl}[self._vote_path]
        off, votes, acc = self._chunked_vote(
            vote_impl, vote_tabs, total_valid, lane_bucket, lane_rc,
            samp_hash, samp_idx, lengths, lane_read, P)
        acc = acc & slot_ok

        return self._pack_result(acc, sel, lane_bucket, off, votes,
                                 total_valid, total_valid, counts)

    def _pack_result(self, acc, sel, bucket, off, votes, total_valid,
                     local_valid, counts, di=None):
        """Compact the step result into ONE int32 vector: dead lanes are
        compacted away on device and the host fetches a single small
        array per dispatch instead of nine budget-sized ones. Layout
        (decode_out is the inverse):
          [0]=n_accept [1]=total_valid [2]=local_valid [3]=out_cap
          [4]=data-shard index [5:8]=0
          [8 : 8+B]          counts (B, 2) as c0 << 16 | c1 (values <= C)
          [8+B : 8+B+2*cap]  accepted lanes, 2 words each
                             (bit layout: _init_pack_bits)
        """
        P = acc.shape[0]
        OC = self.out_cap
        la, ob = self._lane_bits, self._off_bits
        arank = jnp.cumsum(acc.astype(jnp.int32))
        aord = jnp.zeros(OC + 1, jnp.int32).at[
            jnp.where(acc, arank - 1, OC)].set(
            jnp.arange(P, dtype=jnp.int32), mode="drop")[:OC]
        n_acc = arank[-1]
        bsel = sel[aord].astype(jnp.uint32)
        bbk = bucket[aord].astype(jnp.uint32)
        boff = off[aord].astype(jnp.uint32)
        bv = jnp.clip(votes[aord], 0, 255).astype(jnp.uint32)
        blo_bits = jnp.uint32(32 - ob)
        w0 = bsel | (bv << jnp.uint32(la)) \
            | ((bbk >> blo_bits) << jnp.uint32(la + 8))
        w1 = boff | ((bbk & ((jnp.uint32(1) << blo_bits) - 1))
                     << jnp.uint32(ob))
        out2 = jax.lax.bitcast_convert_type(
            jnp.stack([w0, w1], axis=1), jnp.int32)
        cw = jax.lax.bitcast_convert_type(
            (counts[:, 0].astype(jnp.uint32) << 16)
            | counts[:, 1].astype(jnp.uint32), jnp.int32)
        hdr = jnp.stack([n_acc, total_valid, local_valid, jnp.int32(OC),
                         jnp.int32(0) if di is None else di,
                         jnp.int32(0), jnp.int32(0), jnp.int32(0)])
        return jnp.concatenate([hdr, cw, out2.reshape(-1)])

    def decode_out(self, vec: np.ndarray, rows: int | None = None):
        """Host-side inverse of _pack_result. vec: the device_get of a
        step result — one packed vector per device, concatenated along
        axis 0 in mesh (data, bucket) order. Returns a dict:
          lane_read/lane_rc/lane_bucket/offset/votes — accepted lanes
          (global read rows), counts (B, 2), total_valid, local_valid
          (per shard), n_accept (per shard)."""
        vec = np.ascontiguousarray(np.asarray(vec), dtype=np.int32)
        B = rows if rows is not None else self.batch_size
        Dd = getattr(self, "Dd", 1)
        Db = getattr(self, "Db", 1)
        Bl = B // Dd
        C = self.cfg.max_candidate_buckets
        la, ob = self._lane_bits, self._off_bits
        vl = 8 + Bl + 2 * self.out_cap
        assert vec.shape[0] == Dd * Db * vl, (vec.shape, Dd, Db, vl)
        counts = np.zeros((B, 2), np.int32)
        reads, rcs, buckets, offs, votes = [], [], [], [], []
        n_accept = np.zeros(Dd * Db, np.int32)
        local_valid = np.zeros(Dd * Db, np.int32)
        total_valid = 0
        for d in range(Dd * Db):
            v = vec[d * vl : (d + 1) * vl]
            di, bi = d // Db, d % Db
            na, total_valid, lv = int(v[0]), int(v[1]), int(v[2])
            n_accept[d], local_valid[d] = na, lv
            if bi == 0:  # counts replicated across bucket shards
                cw = v[8 : 8 + Bl].view(np.uint32)
                counts[di * Bl : (di + 1) * Bl, 0] = cw >> 16
                counts[di * Bl : (di + 1) * Bl, 1] = cw & 0xFFFF
            out2 = v[8 + Bl :].view(np.uint32).reshape(self.out_cap, 2)
            out2 = out2[: min(na, self.out_cap)]
            w0, w1 = out2[:, 0], out2[:, 1]
            lane = (w0 & np.uint32((1 << la) - 1)).astype(np.int64)
            reads.append(di * Bl + lane // (2 * C))
            rcs.append((lane // C) % 2 == 1)
            bucket = ((w1 >> np.uint32(ob)).astype(np.int64)
                      | ((w0 >> np.uint32(la + 8)).astype(np.int64)
                         << (32 - ob)))
            buckets.append(bucket)
            offs.append((w1 & np.uint32((1 << ob) - 1)).astype(np.int64))
            votes.append(((w0 >> np.uint32(la)) & np.uint32(0xFF))
                         .astype(np.int64))
        return {
            "lane_read": np.concatenate(reads),
            "lane_rc": np.concatenate(rcs),
            "lane_bucket": np.concatenate(buckets),
            "offset": np.concatenate(offs),
            "votes": np.concatenate(votes),
            "counts": counts,
            "total_valid": total_valid,
            "local_valid": local_valid,
            "n_accept": n_accept,
        }

    # ------------------------------------------------------------------
    def _sharded_step_impl(self, qgram_words, kmer_to_row, dist_tab,
                           c_sample_tab, vote_tabs, f_sample_tab,
                           packed_reads):
        """Per-device body under shard_map: local coarse scoring over this
        device's bucket range, global candidate policy via tiny
        collectives (pmax/psum of per-read stats + all_gather of
        per-shard top-C lists), then fine voting of the pairs whose
        candidate bucket falls in the local range."""
        cfg = self.cfg
        C = cfg.max_candidate_buckets
        Pl = self.lane_budget
        n = self.coarse.n_buckets
        n_pad_g = self._n_pad_global
        bi = jax.lax.axis_index(self.bucket_axis)
        di = jax.lax.axis_index(self.data_axis)
        B = packed_reads.shape[0]                     # local data rows

        codes, qual_ok, lengths = unpack_reads(
            packed_reads, self._padded_read_len, cfg.query_seed, xp=jnp)
        # ownership geometry: this shard owns bucket rows
        # [bi*npf, (bi+1)*npf), npf = 32*wr
        n_local = self._npf
        col0 = bi * n_local
        bound = jnp.clip(jnp.int32(n) - col0, 0, n_local)

        presence, num_good, give_up = self.coarse._presence_impl(
            qgram_words, kmer_to_row, dist_tab, c_sample_tab, codes,
            qual_ok, lengths)
        chunk_max, chunk_cnt, planes = _chunk_scan(presence, bound)
        local_max = chunk_max.max(axis=2)                        # (B,2) i32
        gmax = jax.lax.pmax(local_max, self.bucket_axis)
        ok = (gmax >= cfg.min_coarse_hits) & ~give_up[:, None]
        local_cnt = jnp.where((chunk_max == gmax[:, :, None])
                              & ok[..., None], chunk_cnt, 0).sum(axis=2)
        gcnt = jax.lax.psum(local_cnt, self.bucket_axis)
        over = gcnt > C                                # clear (:471-476)
        counts = jnp.where(over, 0, gcnt)

        # per-shard two-level extraction (ops/coarse.py:_extract_at_max2),
        # merged via all_gather: Db*C ints per (read, strand), NOT the
        # hit vector
        cand_l = self.coarse._extract_at_max2(planes, chunk_max, gmax,
                                              ok & ~over, n, col0)
        vals = jnp.where(cand_l >= 0, n_pad_g - cand_l, 0)
        allv = jax.lax.all_gather(vals, self.bucket_axis)        # (Db,B,2,C)
        allv = jnp.moveaxis(allv, 0, 2).reshape(B, 2, -1)
        gvals, _ = jax.lax.top_k(allv, C)
        cand = jnp.where(gvals > 0, n_pad_g - gvals, -1).astype(jnp.int32)

        samp_hash, samp_idx = self.fine._prepare_impl(
            f_sample_tab, codes, qual_ok, lengths)

        # ---- pairs owned by THIS bucket shard ----------------------------
        flat = cand.reshape(-1)
        nl = flat.shape[0]
        lane = jnp.arange(nl, dtype=jnp.int32)
        mine = (flat >= col0) & (flat < col0 + n_local)
        mrank = jnp.cumsum(mine.astype(jnp.int32))
        sel = jnp.zeros(Pl + 1, jnp.int32).at[
            jnp.where(mine, mrank - 1, Pl)].set(lane, mode="drop")[:Pl]
        local_valid = mrank[-1]
        slot_ok = jnp.arange(Pl, dtype=jnp.int32) < local_valid
        lane_read = sel // (2 * C)
        lane_rc = ((sel // C) % 2).astype(bool)
        bucket_g = jnp.clip(flat[sel], 0, None).astype(jnp.int32)
        bid_local = jnp.clip(bucket_g - col0, 0, n_local - 1)

        vote_impl = {"packed": self.fine._vote_packed_impl,
                     "prefix": self.fine._vote_prefix_impl,
                     "sorted": self.fine._vote_sorted_impl,
                     "scan": self.fine._vote_impl}[self._vote_path]
        off, votes, acc = self._chunked_vote(
            vote_impl, vote_tabs, local_valid, bid_local, lane_rc,
            samp_hash, samp_idx, lengths, lane_read, Pl)
        acc = acc & slot_ok

        total_valid = jax.lax.psum(local_valid,
                                   (self.data_axis, self.bucket_axis))
        return self._pack_result(acc, sel, bucket_g, off, votes,
                                 total_valid, local_valid, counts, di=di)

    # ------------------------------------------------------------------
    def step(self, codes: np.ndarray, quals: np.ndarray, lengths: np.ndarray):
        """Async dispatch; returns device outputs (don't block).

        Reads are packed host-side into the compact transfer layout
        (encoding.pack_reads; native C twin when available — the numpy
        pack costs ~40 ms/batch at B=8192, the C loop ~3 ms)."""
        from bucketmap_tpu.io import native
        packed = native.pack_reads(codes, quals, np.asarray(lengths),
                                   self.cfg.query_seed,
                                   self.cfg.mapper_min_kmer_quality)
        if packed is None:
            packed = pack_reads(codes, quals, np.asarray(lengths),
                                self.cfg.query_seed,
                                self.cfg.mapper_min_kmer_quality)
        return self.step_packed(packed)

    def step_packed(self, packed: np.ndarray):
        packed = jnp.asarray(packed)
        if self._data_sharding is not None:
            packed = jax.device_put(packed, self._data_sharding2)
        return self.step_global(packed)

    _concat_fns: dict = {}

    def concat_outs(self, outs):
        """Concatenate K step-output vectors ON DEVICE so the host can
        fetch a whole fetch-group with one device_get."""
        fn = DeviceMapper._concat_fns.get(len(outs))
        if fn is None:
            fn = jax.jit(lambda *vs: jnp.concatenate(vs))
            DeviceMapper._concat_fns[len(outs)] = fn
        return fn(*outs)

    def step_global(self, packed):
        """Run the fused step on an already-placed (possibly
        multi-process global) packed-read array."""
        _, vote_tabs = self._vote_impl_and_tabs()
        return self._step(
            *self.coarse._index_args(), vote_tabs, self.fine.sample_tab,
            packed)
