"""Coarse stage: score every bucket against every read's sampled k-mers.

A counting reformulation of the reference's fault_tolerate_filter cascade
(q_gram_mapper.h:27-136). The cascade
    filters[i] &= filters[i+1] | input ;  filters[last] &= input
followed by best_results() (highest non-empty level) is equivalent to:

    hits[b]  = #{samples s : bucket b contains ALL q-grams of s}
    answer   = { b : hits[b] == max_hits }   if max_hits >= m - fault + 1
             = {}                            otherwise

so instead of maintaining `fault` cascaded bitsets per read we compute the
per-bucket hit *count* with dense word-parallel AND + bit-unpack + add —
the data-parallel scale-up of std::bitset word-parallelism. Everything is
fixed-shape: candidate lists are padded to max_candidate_buckets with -1.

Per-read flow (query_sequence, q_gram_mapper.h:414-480):
  1. k-mer hashes + rolling quality sums over the segment,
  2. keep k-mers that are highly distinguishable (any contained q-gram
     with zeros >= d*N, :189-196) AND pass the quality gate,
  3. give up if fewer than 0.2*num_samples remain (strict double
     compare, replicated via math.ceil of the python-float product),
  4. deterministically sample num_samples of them,
  5. score buckets for the samples and their reverse complements,
  6. drop a strand's list if it exceeds max_candidate_buckets.
"""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import BucketIndex
from bucketmap_tpu.ops.encoding import kmer_hashes, revcomp_hash, window_quality_sums
from bucketmap_tpu.ops.sampler import sample_table


def min_good_kmers(cfg: MapperConfig) -> int:
    """Smallest good-k-mer count that is NOT skipped: the reference compares
    size < 0.2*num_samples in double (q_gram_mapper.h:445); python floats
    are IEEE doubles so math.ceil of the float product is exact."""
    return math.ceil(0.2 * cfg.mapper_samples)


def _word_max_cnt(planes, vmask):
    """Per-word max + at-max count of 32 bit-plane-packed counters.

    planes[j] bit b = bit j of bucket b's hit count; vmask = valid-bucket
    bits. Bitwise max: scan planes high->low keeping the candidate set —
    cand starts as vmask; at each plane, if any candidate has the bit
    set, the max has it and candidates narrow to those. O(n_planes) word
    ops instead of expanding 32 per-bucket counts. Fully-masked words
    read max -1, count 32 (they never equal a live read's max).

    Returns (cm int32, cc int32) with planes' shape."""
    cand = vmask
    m = jnp.zeros(vmask.shape, jnp.int32)
    for j in range(len(planes) - 1, -1, -1):
        t = cand & planes[j]
        nz = t != jnp.uint32(0)
        cand = jnp.where(nz, t, cand)
        m = m * 2 + nz.astype(jnp.int32)
    empty = vmask == jnp.uint32(0)
    cm = jnp.where(empty, -1, m)
    cc = jnp.where(empty, 32,
                   jax.lax.population_count(cand).astype(jnp.int32))
    return cm, cc


def _valid_word_mask(colbase, bound, xp=jnp):
    """uint32 word of valid-bucket bits for words whose first bucket is
    colbase: all-ones below the boundary word, partial at it, 0 past."""
    rem = bound - colbase
    shift = xp.clip(rem, 0, 31).astype(xp.uint32)
    part = (xp.uint32(1) << shift) - xp.uint32(1)
    return xp.where(rem >= 32, xp.uint32(0xFFFFFFFF),
                    xp.where(rem <= 0, xp.uint32(0), part))


def _first_set_indices(mask, C: int):
    """Indices of the first C set lanes along the last axis — exact capped
    compaction via cumsum ranks + a fused rank-match reduction.

    Gather- and sort-free (TopK is a sort, and a binary search over the
    rank vector is one scalar gather per probe): the j-th set bit is the
    unique position whose masked running rank equals j+1, so a compare
    against each of the C target ranks and a sum over the position axis
    extracts all C indices in streaming passes (XLA fuses the indicator
    into the reduction — it never exists in device memory). Looping the
    C targets keeps n in the minor axis, so every pass is a full-width
    fused compare+select+reduce over an int8 rank vector.

    mask: (..., n) bool. Returns (idx (..., C) int32 ascending, valid
    (..., C) bool); idx is 0 where invalid."""
    n = mask.shape[-1]
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=-1)       # (..., n)
    total = rank[..., -1:]
    tgt = jnp.arange(1, C + 1, dtype=jnp.int32)              # (C,)
    valid = tgt <= total
    # ranks beyond C can never match a target — clip into int8
    rt = jnp.int8 if C + 1 <= 127 else jnp.int32
    r8 = jnp.where(mask, jnp.minimum(rank, C + 1), 0).astype(rt)
    pos = jnp.arange(n, dtype=jnp.int32)
    cols = [jnp.sum(jnp.where(r8 == rt(c), pos, 0), axis=-1)
            for c in range(1, C + 1)]
    idx = jnp.stack(cols, axis=-1)                           # (..., C)
    return jnp.where(valid, idx, 0), valid


def _presence_rows(qgram_words, rows):
    """Bucket-presence words of each sample: the AND of its q-gram
    occupancy rows. qgram_words (G1, w) uint32; rows (R, nq) int32 table
    rows. Returns (R, w) uint32."""
    pres = qgram_words[rows[:, 0]]
    for i in range(1, rows.shape[1]):
        pres = pres & qgram_words[rows[:, i]]
    return pres


def _chunk_scan(presence, bound):
    """Fused bit-sliced counting + per-word-chunk reduction.

    presence: (B, 2, s, w) uint32 — per-sample bucket-presence words (the
    AND of each sample's q-gram occupancy rows). bound: int32 scalar, the
    first out-of-range bucket column (masked out — required because the
    all-ones sentinel row sets phantom bits beyond the last real bucket).

    The s samples ripple-carry into n_planes = s.bit_length() bit-plane
    words (plane j bit b = bit j of bucket b's hit count), then each
    word's 32 packed counters reduce to chunk max + at-max count with
    the bitwise plane scan (_word_max_cnt) — no per-bucket expansion;
    the (B, 2, 32*w) per-bucket hit tensor never exists.

    Returns (chunk_max (B, 2, w) i32, chunk_cnt (B, 2, w) i32, planes
    (B, 2, n_planes, w) uint32 packed per-bucket counters).
    """
    B, two, s, w = presence.shape
    n_planes = s.bit_length()
    planes = [jnp.zeros((B, two, w), jnp.uint32) for _ in range(n_planes)]
    for i in range(s):
        carry = presence[:, :, i, :]
        for j in range(n_planes):
            tmp = planes[j] & carry
            planes[j] = planes[j] ^ carry
            carry = tmp
    colbase = jnp.arange(w, dtype=jnp.int32) * 32
    vmask = _valid_word_mask(colbase[None, None, :], bound)
    cm, cc = _word_max_cnt(planes, vmask)
    return cm, cc, jnp.stack(planes, axis=2)


class CoarseMapper:
    """Holds the coarse index on device and a jitted batch query."""

    def __init__(self, index: BucketIndex):
        cfg = index.config
        cfg.validate()
        self.cfg = cfg
        self.n_buckets = index.n_buckets
        g = index.qgram_words.shape[0] - 1  # sentinel row index
        # lazy device transfer: a mesh owner installs the bucket-sharded
        # version before first use (device_pipeline.DeviceMapper)
        self._qgram_host = index.qgram_words
        self._qgram_dev = None
        self._index = index      # for the on-device occupancy build
        # -1 (unsampled q-gram) -> sentinel all-ones row / zeros==-1
        k2r = index.kmer_to_row.astype(np.int32)
        self.kmer_to_row = jnp.asarray(np.where(k2r < 0, g, k2r))
        # FracMinHash f=1.0 keeps every q-gram in hash order, so the
        # row map is the identity — the (B,2,s,nq) row gather can be
        # skipped entirely
        self.k2r_identity = bool(
            k2r.shape[0] == g and np.array_equal(k2r, np.arange(g)))
        self.zeros = jnp.asarray(index.zeros)
        # distinguishability threshold: (unsigned)(d * N) (q_gram_mapper.h:163)
        self.dist_threshold = int(cfg.distinguishability * self.n_buckets)
        # Precompute is_highly_distinguishable per whole k-mer (one uint8
        # gather at query time instead of 2 gathers x (k-q+1) shifts).
        # 4^k entries; for k <= 13 that is <= 64 MB.
        if 4**cfg.query_seed <= (1 << 26):
            qb = np.uint32(4**cfg.index_seed - 1)
            per_gram = index.zeros[np.where(k2r < 0, g, k2r)] >= self.dist_threshold
            h = np.arange(4**cfg.query_seed, dtype=np.uint32)
            dist = np.zeros(4**cfg.query_seed, dtype=bool)
            for i in range(cfg.qgrams_per_kmer):
                dist |= per_gram[(h >> np.uint32(2 * i)) & qb]
            self.dist_by_kmer = jnp.asarray(dist.astype(np.uint8))
        else:
            self.dist_by_kmer = None
            self.zeros_ge = jnp.asarray(
                (index.zeros[np.where(k2r < 0, g, k2r)] >= self.dist_threshold
                 ).astype(np.uint8))
        self.sample_tab = jnp.asarray(
            sample_table(cfg.mapper_samples, cfg.read_len))
        # index arrays are passed as jit ARGUMENTS (not closure captures):
        # captured arrays become HLO constants, which recompile on every
        # index change and bloat the compiled program.
        self._query = jax.jit(self._query_from_quals_impl)

    @property
    def qgram_words(self):
        if self._qgram_dev is None:
            import jax as _jax

            from bucketmap_tpu.index.builder import slab_upload
            qw = self._qgram_host
            # BMTPU_DEVICE_OCC=1|auto: rebuild the occupancy table on the
            # device from buckets_packed (bit-identical, verified) instead
            # of uploading it; the device build rides the genome upload
            # the fine stage needs anyway
            env = os.environ.get("BMTPU_DEVICE_OCC", "auto")
            want = env == "1" or (env == "auto"
                                  and _jax.default_backend() != "cpu")
            if want:
                from bucketmap_tpu.index.device_build import \
                    build_occupancy_on_device
                self._qgram_dev = build_occupancy_on_device(
                    self._index, bp_dev=getattr(self, "_bp_dev", None))
            if self._qgram_dev is None:
                self._qgram_dev = slab_upload(qw)
        return self._qgram_dev

    @qgram_words.setter
    def qgram_words(self, v):
        self._qgram_dev = v

    def _index_args(self):
        dist_tab = self.dist_by_kmer if self.dist_by_kmer is not None else self.zeros_ge
        return (self.qgram_words, self.kmer_to_row, dist_tab, self.sample_tab)

    # -------------------------------------------------------------------
    def _query_from_quals_impl(self, qgram_words, kmer_to_row, dist_tab,
                               sample_tab, codes, quals, lengths):
        """Compatibility wrapper: derive the quality-gate mask from raw
        phred ranks on device, then run the mask-based query."""
        qual_ok = window_quality_sums(quals, self.cfg.query_seed, xp=jnp) \
            >= self.cfg.mapper_min_kmer_quality
        return self._query_impl(qgram_words, kmer_to_row, dist_tab,
                                sample_tab, codes, qual_ok, lengths)

    def _sample_hashes_impl(self, kmer_to_row, dist_tab, sample_tab,
                            codes: jax.Array, qual_ok: jax.Array,
                            lengths: jax.Array):
        """Distinguishability/quality gating + deterministic sampling:
        the shared front half of the coarse query (q_gram_mapper.h:
        414-460). Returns (both (B, 2, s) uint32 sampled k-mer hashes
        with axis 1 = strand, num_good (B,) int32, give_up (B,) bool)."""
        cfg = self.cfg
        k, q = cfg.query_seed, cfg.index_seed
        B, L = codes.shape
        K = L - k + 1  # k-mer positions (padded tail masked below)
        qbits = jnp.uint32(4**q - 1)

        kmers = kmer_hashes(codes, k, xp=jnp)                       # (B, K)
        pos = jnp.arange(K, dtype=jnp.int32)
        valid = pos[None, :] < (lengths[:, None] - (k - 1))

        # distinguishability: any contained q-gram with zeros >= threshold,
        # precomputed per k-mer (or per q-gram for very large k)
        if self.dist_by_kmer is not None:
            disting = dist_tab[kmers] > 0
        else:
            disting = jnp.zeros((B, K), dtype=bool)
            for i in range(k - q + 1):
                gram = (kmers >> jnp.uint32(2 * i)) & qbits
                disting = disting | (dist_tab[gram] > 0)

        good = valid & disting & qual_ok
        num_good = good.sum(axis=1).astype(jnp.int32)
        give_up = num_good < min_good_kmers(cfg)

        # deterministic sampling of good positions in increasing order:
        # the sel[j]-th good position is the unique one whose masked
        # running rank equals sel[j]+1, so a compare + sum extracts each
        # sample in one full-width streaming pass — no argsort over
        # (B, K) keys, and K (not s) stays the minor axis
        ub = jnp.clip(num_good - 1, 0, sample_tab.shape[0] - 1)
        sel = sample_tab[ub]                                   # (B, s)
        rank = jnp.cumsum(good.astype(jnp.int32), axis=1)
        r16 = jnp.where(good, rank, 0).astype(jnp.int16)       # K < 2^15
        pos16 = pos.astype(jnp.int16)
        samp_pos = jnp.stack(
            [jnp.sum(jnp.where(r16 == (sel[:, j:j + 1] + 1)
                               .astype(jnp.int16), pos16, jnp.int16(0)),
                     axis=1, dtype=jnp.int32)
             for j in range(sel.shape[1])], axis=1)            # (B, s)
        samp_hash = jnp.take_along_axis(kmers, samp_pos, axis=1)    # (B, s)

        both = jnp.stack([samp_hash, revcomp_hash(samp_hash, k, xp=jnp)],
                         axis=1)
        return both, num_good, give_up

    def _gram_rows(self, kmer_to_row, grams, nq: int):
        """Occupancy-table row of each contained q-gram; the gather is
        skipped when the FracMinHash row map is the identity (f=1.0)."""
        if self.k2r_identity:
            return grams.astype(jnp.int32).reshape(-1, nq)
        return kmer_to_row[grams].reshape(-1, nq)

    def _presence_impl(self, qgram_words, kmer_to_row, dist_tab, sample_tab,
                       codes: jax.Array, qual_ok: jax.Array,
                       lengths: jax.Array):
        """Per-sample bucket presence for a batch — the gather half of the
        query, valid on a bucket-range SHARD of the index (pass the local
        word columns). Each sample's presence word vector is the AND of
        its k-q+1 q-gram occupancy rows (query, q_gram_mapper.h:398-407).
        Returns (presence (B, 2, s, w) uint32, num_good (B,) int32,
        give_up (B,) bool)."""
        cfg = self.cfg
        s = cfg.mapper_samples
        B = codes.shape[0]
        w = qgram_words.shape[1]
        both, num_good, give_up = self._sample_hashes_impl(
            kmer_to_row, dist_tab, sample_tab, codes, qual_ok, lengths)
        nq = cfg.qgrams_per_kmer
        shifts = 2 * jnp.arange(nq, dtype=jnp.uint32)
        grams = (both[..., None] >> shifts) & jnp.uint32(4**cfg.index_seed - 1)
        rows = self._gram_rows(kmer_to_row, grams, nq)          # (B*2*s, nq)
        pres = _presence_rows(qgram_words, rows)
        return pres.reshape(B, 2, s, w), num_good, give_up

    # -------------------------------------------------------------------
    CAND_CHUNK = 32  # bucket-chunk width (one u32 word) for extraction

    def _extract_at_max2(self, planes, chunk_max, max_hits, live, n,
                         col0: int = 0):
        """Bucket ids at the (global) max hit count — word-rank extraction.

        A direct top_k over a (B, 2, n_pad) hit tensor is a sort over
        52k-wide rows, and a two-level chunk extraction needs element
        gathers plus a (C,32)->C*32 relayout. Gather-free instead:
        dense per-bucket "count == gmax" flag WORDS (XNOR-AND over the
        packed plane counters), then popcount + word-rank cumsum locate
        the word holding the c-th set bit with one full-width
        crossing-match reduction per target, and a 5-step
        halving ladder selects the bit by local rank inside that word.
        Live reads have <= C at-max buckets (more clears the read,
        q_gram_mapper.h:471-476), so C targets extract everything.
        Results identical to a dense extraction: ascending global ids.

        planes: (B, 2, n_planes, nc) uint32 packed per-bucket counters
        (from _chunk_scan).
        Returns cand (B,2,C) int32 — ascending global ids, -1 padded."""
        C = self.cfg.max_candidate_buckets
        B, _, n_planes, nc = planes.shape

        # dense per-bucket "count == gmax" flags, ONE u32 word per
        # 32-bucket chunk: bucket bit set iff every plane bit matches
        # gmax's bit (counts fit n_planes bits, n_planes = s.bit_length())
        eq = None
        for j in range(n_planes):
            gb = ((max_hits >> j) & 1)[..., None]                 # (B,2,1)
            pj = planes[:, :, j]
            term = jnp.where(gb == 1, pj, ~pj)
            eq = term if eq is None else (eq & term)
        colbase = jnp.arange(nc, dtype=jnp.int32) * 32
        vmask = _valid_word_mask(colbase, n - col0)               # (nc,) u32
        eq = jnp.where(live[..., None], eq & vmask, jnp.uint32(0))

        pop = jax.lax.population_count(eq).astype(jnp.int32)      # (B,2,nc)
        wrank = jnp.cumsum(pop, axis=-1)                          # inclusive
        total = wrank[..., -1:]
        # ranks clip into int8 (live reads never exceed C+1 <= 127)
        rt = jnp.int8 if C + 1 <= 127 else jnp.int32
        wr = jnp.minimum(wrank, C + 1).astype(rt)
        wx = jnp.minimum(wrank - pop, C + 1).astype(rt)
        eqi = jax.lax.bitcast_convert_type(eq, jnp.int32)
        lanes = jnp.arange(nc, dtype=jnp.int32)

        cols = []
        for c in range(1, C + 1):
            m = (wr >= rt(c)) & (wx < rt(c))      # the ONE crossing word
            wval = jnp.sum(jnp.where(m, eqi, 0), axis=-1)         # (B,2)
            base = jnp.sum(jnp.where(m, wx.astype(jnp.int32), 0), axis=-1)
            lane = jnp.sum(jnp.where(m, lanes, 0), axis=-1)
            # bit of local rank r inside wval: halving ladder
            r = c - 1 - base
            w32 = jax.lax.bitcast_convert_type(wval, jnp.uint32)
            pos = jnp.zeros_like(r)
            for width in (16, 8, 4, 2, 1):
                lowc = jax.lax.population_count(
                    w32 & jnp.uint32((1 << width) - 1)).astype(jnp.int32)
                hi = r >= lowc
                r = jnp.where(hi, r - lowc, r)
                pos = pos + jnp.where(hi, width, 0)
                w32 = jnp.where(hi, w32 >> width, w32)
            cols.append(lane * 32 + pos)
        cand_local = jnp.stack(cols, axis=-1)                     # (B,2,C)
        tgt = jnp.arange(1, C + 1, dtype=jnp.int32)
        valid = tgt <= total
        return jnp.where(valid, col0 + cand_local, -1).astype(jnp.int32)

    def _query_impl(self, qgram_words, kmer_to_row, dist_tab, sample_tab,
                    codes: jax.Array, qual_ok: jax.Array, lengths: jax.Array):
        """codes: (B, L) uint8; qual_ok: (B, L-k+1) bool (the quality gate
        sum(qual ranks over k) >= mapper_min_kmer_quality, precomputable
        host-side — see encoding.pack_reads); lengths: (B,) int32.

        Returns (candidates (B, 2, C) int32 -1-padded ascending,
                 counts (B, 2) int32, num_good (B,) int32).
        Axis 1 is strand: 0 = original, 1 = reverse complement.
        """
        cfg = self.cfg
        n = self.n_buckets
        presence, num_good, give_up = self._presence_impl(
            qgram_words, kmer_to_row, dist_tab, sample_tab, codes, qual_ok,
            lengths)
        chunk_max, chunk_cnt, planes = _chunk_scan(presence, jnp.int32(n))
        max_hits = chunk_max.max(axis=2)                         # (B,2) i32
        ok = (max_hits >= cfg.min_coarse_hits) & ~give_up[:, None]
        counts = jnp.where((chunk_max == max_hits[:, :, None])
                           & ok[..., None], chunk_cnt, 0).sum(axis=2)
        over = counts > cfg.max_candidate_buckets                # clear (:471-476)
        counts = jnp.where(over, 0, counts)
        cand = self._extract_at_max2(planes, chunk_max, max_hits,
                                     ok & ~over, n)
        return cand, counts, num_good

    # -------------------------------------------------------------------
    def query_batch(self, codes: np.ndarray, quals: np.ndarray,
                    lengths: np.ndarray):
        cand, counts, num_good = self._query(
            *self._index_args(), jnp.asarray(codes), jnp.asarray(quals),
            jnp.asarray(lengths, dtype=jnp.int32))
        return np.asarray(cand), np.asarray(counts), np.asarray(num_good)
