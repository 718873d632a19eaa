"""Fine stage: in-bucket offset voting.

The reference rebuilds an unordered_multimap<kmer, offset> per candidate
bucket at locate time — its dominant cost (384.5 s of a 715 s GRCh38 run;
bucket_locator.h:162-177 and SURVEY §3.2) — then lets ~10 sampled read
k-mers vote for the implied segment start with +-allowed_indel merging
(_find_offset, bucket_locator.h:209-290).

Design: no per-bucket hash map at all. Interchangeable kernels produce
identical results:

  * packed-scan (_vote_impl): gather the bucket's 2-bit packed row,
    expand to its k-mer hash array with a log-shift combine, and extract
    each sample's occurrence positions with top_k over the match mask;
  * positional-index (_vote_sorted_impl): binary-search each sample's
    hash in the bucket's hash-sorted k-mer array built at index time
    (index/builder.py:build_fine_index) — O(p log L) tiny gathers,
    preferred whenever the index carries the sorted arrays.

All feed the extracted occurrences into _tally, a literal device port
of _find_offset's
sequential semantics (bucket_locator.h:227-290): occurrences are
processed sample-by-sample (reverse sample order for revcomp pairs,
:235-236); while the counter is empty a sample's occurrences each
propose their position (exact-key merge only); afterwards every
occurrence increments ALL existing proposals within +-allowed_indel
(so votes can exceed num_samples), creating a new proposal only when
none is close. Winner = max votes then smallest position (:281-283).

Remaining divergences (tandem repeats only): (a) occurrences are
iterated in ascending position order, where the reference's
unordered_multimap::equal_range order is implementation-defined;
(b) at most MAX_OCC occurrences per sample are considered.

Reverse-complement pairs query the reverse-complemented sample hash at
mirrored index seg_len - k - idx (bucket_locator.h:236-243).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import BucketIndex
from bucketmap_tpu.ops.encoding import kmer_hashes, revcomp_hash, unpack_2bit, window_quality_sums
from bucketmap_tpu.ops.sampler import sample_table


class FineLocator:
    def __init__(self, index: BucketIndex, pair_batch: int = 256):
        cfg = index.config
        self.cfg = cfg
        self.pair_batch = pair_batch
        self.bucket_lengths = jnp.asarray(index.bucket_lengths)
        # The big per-bucket tables transfer to device LAZILY (first
        # access) so a mesh owner can install bucket-sharded versions
        # first (device_pipeline.DeviceMapper): positional fine index
        # (hash-ordered positions, 4 B/base), prefix acceleration (12-bit
        # segment table + uint16 low bits), and the 2-bit packed bucket
        # sequences. Setting an attribute (incl. None) overrides the
        # host-backed source.
        self._host = {
            "fine_pos": index.fine_pos,
            "fine_ptab": index.fine_ptab,
            "fine_low": index.fine_low,
            "fine_packed": index.fine_packed,
            "buckets_packed": index.buckets_packed,
        }
        self._dev = {}
        self.search_steps = index.fine_search_steps \
            if index.fine_ptab is not None else 0
        self.low_bits = index.fine_low_bits
        self.sample_tab = jnp.asarray(sample_table(cfg.locator_samples, cfg.read_len))
        # index arrays are jit arguments, not closure captures (capture
        # would embed them as HLO constants; see ops/coarse.py)
        self._prepare = jax.jit(self._prepare_from_quals_impl)
        self._vote = jax.jit(self._vote_impl)
        self._vote_s = jax.jit(self._vote_sorted_impl)
        self._vote_p = jax.jit(self._vote_prefix_impl)
        self._vote_k = jax.jit(self._vote_packed_impl)

    def _lazy(self, name):
        if name not in self._dev:
            from bucketmap_tpu.index.builder import materialize, slab_upload
            h = self._host[name]
            if h is None:
                self._dev[name] = None
            elif h.ndim == 2 and h.nbytes > (64 << 20):
                # bounded-transient transfer for the multi-GB tables
                # (buckets_packed / host-built fine_packed)
                self._dev[name] = slab_upload(h)
            else:
                self._dev[name] = jnp.asarray(materialize(h))
        return self._dev[name]

    def _set(self, name, v):
        self._dev[name] = v
        if v is None:
            self._host[name] = None

    def has(self, name: str) -> bool:
        """Table availability WITHOUT forcing the host->device transfer."""
        return (self._dev.get(name) is not None
                or (name not in self._dev and self._host[name] is not None))

    buckets_packed = property(lambda s: s._lazy("buckets_packed"),
                              lambda s, v: s._set("buckets_packed", v))
    fine_pos = property(lambda s: s._lazy("fine_pos"),
                        lambda s, v: s._set("fine_pos", v))
    fine_ptab = property(lambda s: s._lazy("fine_ptab"),
                         lambda s, v: s._set("fine_ptab", v))
    fine_low = property(lambda s: s._lazy("fine_low"),
                        lambda s, v: s._set("fine_low", v))
    fine_packed = property(lambda s: s._lazy("fine_packed"),
                           lambda s, v: s._set("fine_packed", v))

    # ------------------------------------------------------------------
    def _prepare_from_quals_impl(self, sample_tab, codes, quals, lengths):
        """Compatibility wrapper over raw phred ranks (see coarse)."""
        qual_ok = window_quality_sums(quals, self.cfg.query_seed, xp=jnp) \
            >= self.cfg.mapper_min_kmer_quality
        return self._prepare_impl(sample_tab, codes, qual_ok, lengths)

    def _prepare_impl(self, sample_tab, codes, qual_ok, lengths):
        """Sample locator k-mers per segment (_prepare_read_query,
        bucket_locator.h:292-347): quality gate only (no
        distinguishability); if no k-mer passes, use all of them.

        codes: (S, read_len); qual_ok: (S, K) bool gate; lengths: (S,).
        Returns samp_hash (S, p) uint32, samp_idx (S, p) int32.
        """
        cfg = self.cfg
        k, p = cfg.query_seed, cfg.locator_samples
        S, L = codes.shape
        K = L - k + 1
        kmers = kmer_hashes(codes, k, xp=jnp)
        pos = jnp.arange(K, dtype=jnp.int32)
        valid = pos[None, :] < (lengths[:, None] - (k - 1))
        good = valid & qual_ok
        num_good = good.sum(axis=1).astype(jnp.int32)
        # fallback: all valid k-mers when none pass (bucket_locator.h:330-332)
        use_all = num_good == 0
        good = jnp.where(use_all[:, None], valid, good)
        num_good = jnp.where(use_all, valid.sum(axis=1).astype(jnp.int32), num_good)

        # rank-match extraction of the sel-th good positions (no argsort
        # — see ops/coarse.py:_sample_hashes_impl)
        ub = jnp.clip(num_good - 1, 0, sample_tab.shape[0] - 1)
        sel = sample_tab[ub]                                      # (S, p)
        rank = jnp.cumsum(good.astype(jnp.int32), axis=1)
        r = jnp.where(good, rank, 0)
        samp_idx = jnp.sum(
            jnp.where(r[:, :, None] == (sel + 1)[:, None, :],
                      pos[None, :, None], 0), axis=1).astype(jnp.int32)
        samp_hash = jnp.take_along_axis(kmers, samp_idx, axis=1)
        return samp_hash, samp_idx

    # ------------------------------------------------------------------
    # occurrences per sampled k-mer considered (a 12-mer matches a 65 kb
    # bucket ~1.02 times on average; > MAX_OCC only in tandem repeats)
    MAX_OCC = 8

    def _tally(self, prop, occ_valid, is_rc):
        """Sequential vote accumulation — literal port of _find_offset
        (bucket_locator.h:227-290).

        prop/occ_valid: (P, p, O) proposed segment starts per (sample,
        occurrence), occurrences in ascending position order. Proposal
        slot s = j*O + o is reserved for occurrence (j, o); it becomes
        live only when that occurrence creates a new proposal. Samples
        are processed in order (reversed for revcomp pairs, :235-236);
        within the still-empty counter a sample's occurrences merge on
        exact position only (vote_counter[position]++, :247-252); once
        non-empty, each occurrence increments every live proposal within
        +-allowed_indel, else creates its own (:254-271). Winner = max
        votes then smallest position (:281-283); accepted iff votes >=
        num_samples - allowed_mismatch and position >= 1 (:284, :674)."""
        cfg = self.cfg
        P, p, O = prop.shape
        S = p * O
        indel = cfg.allowed_indel
        # revcomp pairs iterate samples last-to-first; creation order is
        # observable, so flip the sample axis for those rows
        prop = jnp.where(is_rc[:, None, None], prop[:, ::-1, :], prop)
        occ_valid = jnp.where(is_rc[:, None, None], occ_valid[:, ::-1, :],
                              occ_valid)
        flat_prop = prop.reshape(P, S)
        flat_valid = occ_valid.reshape(P, S)
        slot_ids = jnp.arange(S, dtype=jnp.int32)

        def sample_body(j, state):
            pos_arr, votes, created = state
            # branch chosen ONCE per sample (:247), before its occurrences
            counter_empty = ~created.any(axis=1)                   # (P,)
            tol = jnp.where(counter_empty, 0, indel)               # (P,)
            for o in range(O):
                idx = j * O + o
                pcur = jax.lax.dynamic_slice_in_dim(flat_prop, idx, 1,
                                                    axis=1)[:, 0]
                val = jax.lax.dynamic_slice_in_dim(flat_valid, idx, 1,
                                                   axis=1)[:, 0]
                close = created & (jnp.abs(pos_arr - pcur[:, None])
                                   <= tol[:, None])
                any_close = close.any(axis=1)
                votes = votes + (close & val[:, None]).astype(jnp.int32)
                create = val & ~any_close
                newslot = (slot_ids == idx)[None, :]
                hit = create[:, None] & newslot
                pos_arr = jnp.where(hit, pcur[:, None], pos_arr)
                votes = jnp.where(hit, 1, votes)
                created = created | hit
            return pos_arr, votes, created

        init = (jnp.zeros((P, S), jnp.int32), jnp.zeros((P, S), jnp.int32),
                jnp.zeros((P, S), bool))
        pos_arr, votes, created = jax.lax.fori_loop(0, p, sample_body, init)

        xoff = pos_arr + cfg.read_len           # >= 0 (pos >= -read_len)
        # votes <= p*O + 1 and xoff < 2^18, so the key fits int32
        key = jnp.where(created,
                        votes * (1 << 19) + ((1 << 19) - 1 - xoff), -1)
        best = jnp.argmax(key, axis=1)
        best_votes = jnp.take_along_axis(votes, best[:, None], axis=1)[:, 0]
        offset = jnp.take_along_axis(pos_arr, best[:, None], axis=1)[:, 0]
        accept = (created.any(axis=1)
                  & (best_votes >= cfg.min_vote)
                  & (offset >= 1))
        return offset.astype(jnp.int32), best_votes, accept

    def _vote_impl(self, buckets_packed, bucket_lengths,
                   bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """bucket_ids (P,) int32; is_rc (P,) bool; samp_hash (P, p) uint32;
        samp_idx (P, p) int32; seg_len (P,) int32.
        Returns (offset (P,) int32 segment start in bucket, votes (P,) int32,
        accept (P,) bool).

        Sparse formulation: each sampled k-mer occurs O(1) times in the
        bucket, so instead of a dense vote histogram we extract up to
        MAX_OCC occurrence positions per sample (top_k over the match
        mask) and vote among the <= p*MAX_OCC proposed starts directly —
        no per-pair dense shifts (which lower to large gathers).
        """
        cfg = self.cfg
        k, p, indel = cfg.query_seed, cfg.locator_samples, cfg.allowed_indel
        O = self.MAX_OCC
        P = bucket_ids.shape[0]
        wb = buckets_packed.shape[1]
        lb = wb * 16
        lpos = lb - k + 1

        packed = buckets_packed[bucket_ids]                       # (P, Wb)
        blen = bucket_lengths[bucket_ids]                         # (P,)
        codes = unpack_2bit(packed, lb, xp=jnp)                   # (P, Lb)
        bk = kmer_hashes(codes, k, xp=jnp)                        # (P, Lpos)
        bpos = jnp.arange(lpos, dtype=jnp.int32)
        bvalid = bpos[None, :] <= (blen[:, None] - k)

        tgt_hash = jnp.where(is_rc[:, None],
                             revcomp_hash(samp_hash, k, xp=jnp), samp_hash)
        tgt_idx = jnp.where(is_rc[:, None],
                            seg_len[:, None] - k - samp_idx, samp_idx)
        # reverse-complement pairs iterate samples last-to-first
        # (bucket_locator.h:233-236) — irrelevant here: voting is order-free.

        # match positions per sample -> top O earliest positions
        # (looped over samples to bound the materialized (P, Lpos) score)
        occ_scores = []
        for j in range(p):
            match = (bk == tgt_hash[:, j][:, None]) & bvalid      # (P, Lpos)
            score = jnp.where(match, lpos - bpos[None, :], 0)     # earliest = max
            top, _ = jax.lax.top_k(score, O)                      # (P, O)
            occ_scores.append(top)
        occ_score = jnp.stack(occ_scores, axis=1)                 # (P, p, O)
        occ_valid = occ_score > 0
        occ_pos = jnp.where(occ_valid, lpos - occ_score, 0)
        # proposed segment starts x = occurrence - sample index in segment
        prop = occ_pos - tgt_idx[:, :, None]                      # (P, p, O)
        return self._tally(prop, occ_valid, is_rc)

    # ------------------------------------------------------------------
    def _vote_sorted_impl(self, fine_pos, buckets_packed,
                          bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """Positional-index variant of _vote_impl: occurrences come from a
        binary search over the bucket's hash-ordered position array —
        O(p * (log Lpos + MAX_OCC)) tiny gathers per pair. The probe's
        hash is DERIVED from the 2-bit packed bucket row (two word
        gathers + shifts), so only positions (4 B/base) live in HBM.
        Identical results to the scan kernel (stable sort keeps equal
        hashes in position order = earliest-position extraction)."""
        cfg = self.cfg
        k, p, indel = cfg.query_seed, cfg.locator_samples, cfg.allowed_indel
        O = self.MAX_OCC
        P = bucket_ids.shape[0]
        lpos = fine_pos.shape[1]
        kmask = jnp.uint32(4**k - 1)

        def hash_at(bid_arr, pos):
            """k-mer hash at base position `pos` in bucket `bid_arr`
            (invalid pos<0 -> sentinel 0xFFFFFFFF). Packing is LSB-first
            16 bases/word; hashes are big-endian base order, so the
            extracted chunk's base order is reversed."""
            valid = pos >= 0
            sp = jnp.clip(pos, 0, None)
            w0 = sp >> 4
            o = (sp & 15).astype(jnp.uint32)
            a = buckets_packed[bid_arr, w0]
            w1 = jnp.minimum(w0 + 1, buckets_packed.shape[1] - 1)
            bword = buckets_packed[bid_arr, w1]
            lowshift = 2 * o
            upshift = (jnp.uint32(32) - lowshift) & jnp.uint32(31)
            chunk = (a >> lowshift) | jnp.where(
                o > 0, bword << upshift, jnp.uint32(0))
            chunk = chunk & kmask  # base i of k-mer at bits 2i (LSB-first)
            h = jnp.zeros_like(chunk)
            for i in range(k):  # reverse base order -> big-endian hash
                h = h | (((chunk >> jnp.uint32(2 * i)) & jnp.uint32(3))
                         << jnp.uint32(2 * (k - 1 - i)))
            return jnp.where(valid, h, jnp.uint32(0xFFFFFFFF))

        tgt_hash = jnp.where(is_rc[:, None],
                             revcomp_hash(samp_hash, k, xp=jnp), samp_hash)
        tgt_idx = jnp.where(is_rc[:, None],
                            seg_len[:, None] - k - samp_idx, samp_idx)

        # lower-bound binary search per (pair, sample)
        lo = jnp.zeros((P, p), dtype=jnp.int32)
        hi = jnp.full((P, p), lpos, dtype=jnp.int32)
        # lower_bound over [0, lpos]: gap lpos -> 0 needs bit_length(lpos)
        # halvings ((lpos-1).bit_length() is one short at powers of two)
        steps = max(1, lpos.bit_length())
        bid = bucket_ids[:, None]
        for _ in range(steps):
            mid = (lo + hi) // 2
            v = hash_at(bid, fine_pos[bid, jnp.clip(mid, 0, lpos - 1)])
            below = v < tgt_hash
            lo = jnp.where(below, mid + 1, lo)
            hi = jnp.where(below, hi, mid)

        occ_idx = jnp.clip(lo[:, :, None] + jnp.arange(O, dtype=jnp.int32),
                           0, lpos - 1)                   # (P, p, O)
        occ_pos_raw = fine_pos[bid[:, :, None], occ_idx]
        h_o = hash_at(bid[:, :, None], occ_pos_raw)
        occ_valid = h_o == tgt_hash[:, :, None]
        occ_pos = jnp.where(occ_valid, occ_pos_raw, 0)
        prop = occ_pos - tgt_idx[:, :, None]
        return self._tally(prop, occ_valid, is_rc)

    # ------------------------------------------------------------------
    def _vote_prefix_impl(self, fine_ptab, fine_low, fine_pos,
                          bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """Prefix-accelerated variant of _vote_sorted_impl (preferred).

        The 2k-bit hash splits into a 12-bit prefix and low bits. The
        segment [lo, hi) of slots with the query's prefix comes from TWO
        fine_ptab gathers; a binary search over the uint16 fine_low array
        (index.fine_search_steps steps — bounded by the largest prefix
        segment in the index, typically ~log2(Lpos/4096)) finds the
        lower bound; occurrences are the consecutive equal-low slots
        (prefix+low = the exact hash, so no verification gathers at
        all). ~6 small gathers per (pair, sample) instead of ~17x3
        packed-row derivations. Results identical to _vote_sorted_impl.
        """
        cfg = self.cfg
        k, p = cfg.query_seed, cfg.locator_samples
        O = self.MAX_OCC
        P = bucket_ids.shape[0]
        lpos = fine_pos.shape[1]
        low_bits = jnp.uint32(2 * k - 12)

        tgt_hash = jnp.where(is_rc[:, None],
                             revcomp_hash(samp_hash, k, xp=jnp), samp_hash)
        tgt_idx = jnp.where(is_rc[:, None],
                            seg_len[:, None] - k - samp_idx, samp_idx)
        prefix = (tgt_hash >> low_bits).astype(jnp.int32)       # (P, p)
        low = (tgt_hash & ((jnp.uint32(1) << low_bits) - 1)).astype(jnp.int32)

        bid = bucket_ids[:, None]
        lo = fine_ptab[bid, prefix]
        seg_hi = fine_ptab[bid, prefix + 1]
        hi = seg_hi
        for _ in range(self.search_steps):
            active = lo < hi
            mid = (lo + hi) // 2
            v = fine_low[bid, jnp.clip(mid, 0, lpos - 1)].astype(jnp.int32)
            below = active & (v < low)
            lo = jnp.where(below, mid + 1, lo)
            hi = jnp.where(active & ~below, mid, hi)

        occ_idx = lo[:, :, None] + jnp.arange(O, dtype=jnp.int32)  # (P,p,O)
        occ_clamped = jnp.clip(occ_idx, 0, lpos - 1)
        occ_low = fine_low[bid[:, :, None], occ_clamped].astype(jnp.int32)
        occ_valid = (occ_idx < seg_hi[:, :, None]) & (occ_low == low[:, :, None])
        occ_pos = jnp.where(occ_valid,
                            fine_pos[bid[:, :, None], occ_clamped], 0)
        prop = occ_pos - tgt_idx[:, :, None]
        return self._tally(prop, occ_valid, is_rc)

    # ------------------------------------------------------------------
    def _vote_packed_impl(self, fine_ptab, fine_packed,
                          bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """Fused-slot variant of _vote_prefix_impl (preferred in
        production): each sorted slot is one uint32 (pos << low_bits) |
        low, so the occurrence phase reads position AND verifies the
        hash with a SINGLE gather (vs fine_low + fine_pos), and HBM
        holds 4 B/base instead of 6. Results identical (the packed array
        preserves the stable sort's slot order)."""
        cfg = self.cfg
        k, p = cfg.query_seed, cfg.locator_samples
        O = self.MAX_OCC
        P = bucket_ids.shape[0]
        # tiled 3-D (N, T, 128) when device-built (the hybrid-search
        # storage layout); legacy 2-D (N, lpos) when host-built
        tiled = fine_packed.ndim == 3
        lpos = (fine_packed.shape[1] * 128 if tiled
                else fine_packed.shape[1])
        low_bits = jnp.uint32(self.low_bits)
        low_mask = jnp.uint32((1 << self.low_bits) - 1)

        tgt_hash = jnp.where(is_rc[:, None],
                             revcomp_hash(samp_hash, k, xp=jnp), samp_hash)
        tgt_idx = jnp.where(is_rc[:, None],
                            seg_len[:, None] - k - samp_idx, samp_idx)
        prefix = (tgt_hash >> low_bits).astype(jnp.int32)       # (P, p)
        low = (tgt_hash & low_mask).astype(jnp.int32)

        bid = bucket_ids[:, None]
        lo = fine_ptab[bid, prefix]
        seg_hi = fine_ptab[bid, prefix + 1]
        hi = seg_hi
        # Hybrid search: element-granular probes lower to per-element
        # gathers, so the binary search only narrows [lo, hi) down to
        # <= 128 slots (search_steps - 7 probes) when the table is
        # tile-stored; then
        # ONE 3-sub-tile ROW gather per sample (the gather shape XLA
        # lowers efficiently) both ranks the exact first match and
        # supplies the occurrence slots. Results identical to the full
        # search: slots within [lo, hi) are low-bits sorted, so
        # first-match = lo + |{slots in [lo, hi) with low_slot < low}|.
        steps = max(0, self.search_steps - 7) if tiled \
            else self.search_steps
        for _ in range(steps):
            active = lo < hi
            mid = (lo + hi) // 2
            mc = jnp.clip(mid, 0, lpos - 1)
            if tiled:
                v = (fine_packed[bid, mc // 128, mc % 128]
                     & low_mask).astype(jnp.int32)
            else:
                v = (fine_packed[bid, mc] & low_mask).astype(jnp.int32)
            below = active & (v < low)
            lo = jnp.where(below, mid + 1, lo)
            hi = jnp.where(active & ~below, mid, hi)

        if tiled:
            ft = fine_packed
            T = ft.shape[1]
            t0 = jnp.clip(lo // 128, 0, T - 3)                  # (P, p)
            # flat single-index ROW gather: (N, T, 128) -> (N*T, 128) is
            # layout-free (T % 8 == 0, tile rows align), and a 1-index
            # 128-lane row gather is the shape XLA lowers best
            ftf = ft.reshape(-1, 128)
            frow = bucket_ids[:, None] * T + t0                 # (P, p)
            win = jnp.concatenate(
                [ftf[frow + i] for i in range(3)], axis=-1)     # (P,p,384)
            idxs = (t0 * 128)[:, :, None] + jnp.arange(384, dtype=jnp.int32)
            wlow = (win & low_mask).astype(jnp.int32)
            inseg = (idxs >= lo[:, :, None]) & (idxs < hi[:, :, None])
            lo = lo + jnp.sum(inseg & (wlow < low[:, :, None]),
                              axis=2, dtype=jnp.int32)
            # occurrences: shift the window so slot `lo` lands at 0
            s = jnp.clip(lo - t0 * 128, 0, 384 - O)             # (P, p)
            sh = 1
            while sh < 384:
                shifted = jnp.concatenate(
                    [win[:, :, sh:],
                     jnp.full((P, p, sh), 0xFFFFFFFF, jnp.uint32)], axis=2)
                win = jnp.where((s & sh)[:, :, None] != 0, shifted, win)
                sh *= 2
            pk = win[:, :, :O]
            occ_idx = lo[:, :, None] + jnp.arange(O, dtype=jnp.int32)
        else:
            occ_idx = lo[:, :, None] + jnp.arange(O, dtype=jnp.int32)
            occ_clamped = jnp.clip(occ_idx, 0, lpos - 1)
            pk = fine_packed[bid[:, :, None], occ_clamped]      # ONE gather
        occ_low = (pk & low_mask).astype(jnp.int32)
        occ_valid = (occ_idx < seg_hi[:, :, None]) & (occ_low == low[:, :, None])
        occ_pos = jnp.where(occ_valid, (pk >> low_bits).astype(jnp.int32), 0)
        prop = occ_pos - tgt_idx[:, :, None]
        return self._tally(prop, occ_valid, is_rc)

    # ------------------------------------------------------------------
    def prepare(self, codes: np.ndarray, quals: np.ndarray, lengths: np.ndarray):
        h, i = self._prepare(self.sample_tab, jnp.asarray(codes),
                             jnp.asarray(quals),
                             jnp.asarray(lengths, dtype=jnp.int32))
        return np.asarray(h), np.asarray(i)

    def vote(self, bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """Batched voting with host-side padding to the pair-batch size."""
        n = len(bucket_ids)
        out_off = np.zeros(n, dtype=np.int32)
        out_votes = np.zeros(n, dtype=np.int32)
        out_acc = np.zeros(n, dtype=bool)
        pb = self.pair_batch
        for s in range(0, n, pb):
            e = min(s + pb, n)
            pad = pb - (e - s)
            def _pad(a, fill=0):
                a = np.asarray(a[s:e])
                return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a
            args = (jnp.asarray(_pad(bucket_ids)), jnp.asarray(_pad(is_rc)),
                    jnp.asarray(_pad(samp_hash)), jnp.asarray(_pad(samp_idx)),
                    jnp.asarray(_pad(seg_len, fill=1)))
            if self.has("fine_packed"):
                off, v, acc = self._vote_k(self.fine_ptab, self.fine_packed,
                                           *args)
            elif self.has("fine_ptab"):
                off, v, acc = self._vote_p(self.fine_ptab, self.fine_low,
                                           self.fine_pos, *args)
            elif self.has("fine_pos"):
                off, v, acc = self._vote_s(self.fine_pos, self.buckets_packed, *args)
            else:
                off, v, acc = self._vote(
                    self.buckets_packed, self.bucket_lengths, *args)
            out_off[s:e] = np.asarray(off)[: e - s]
            out_votes[s:e] = np.asarray(v)[: e - s]
            out_acc[s:e] = np.asarray(acc)[: e - s]
        return out_off, out_votes, out_acc
