"""Verification stage: banded semi-global alignment with CIGAR traceback.

Equivalent of the reference's SeqAn3 align_pairwise call
(bucket_locator.h:520-589): global alignment with free leading/trailing
gaps on sequence1 (the reference-window text) only, edit scheme
(match 0 / mismatch -1 / gap -1), outputs score, begin position in the
text, and a CIGAR (M/I/D, as seqan3::cigar_from_alignment emits).

Formulation: batched banded DP over pairs. Rows = query positions
(sequential scan), band = workload-sized diagonals (band_geometry: 48
for 300bp at 2% indels, legacy 128 for ONT rates), all pairs advance
together. The intra-row dependency of the
left (text-gap) move is solved in closed form with a cummax transform:

    new[d] = max(base[d], new[d-1] - 1)
           = cummax(base[d] + d) - d          (max-plus prefix scan)

Each cell stores one byte: direction (2 bits) plus the length of the
same-op chain ending there (6 bits), so the device traceback JUMPS
whole chains — emitting CIGAR runs directly in ~T2=64 scan steps
instead of one step per DP cell (tb_mode="runs"); only the merged runs
ship to the host.

Window semantics match the reference: text = bucket[offset : offset +
min(qlen + 1 + trunc(indel_rate*qlen), blen - offset)]; for reverse-
strand hits the *window* is reverse-complemented and aligned against
the original read, and the begin position is reported in the
reverse-complemented window's coordinates (reference behavior — its
reverse-strand POS is systematically ~(width-qlen) high, within the
analyzer's tolerance; we reproduce it for agreement).

MAPQ = 60 + score as size_t: scores below -60 wrap (bucket_locator.h:571)
and bypass the quality threshold; we reproduce the wrap mod 256.

Divergence note: co-optimal tracebacks are canonicalized diagonal-first
(then up), which may pick a different CIGAR than seqan3 among
equal-score alignments; scores and positions agree.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import BucketIndex

NEG = -(10**8)
BAND = 128
LO = 32          # j - i >= -LO
_OP_CHARS = {1: "M", 2: "I", 3: "D"}


def band_geometry(Q: int, indel_rate: float) -> tuple[int, int]:
    """(band, lo) for a query width Q at the config's indel rate.

    The optimal path of a REAL alignment stays within net-indel drift of
    the main diagonal: |j - i| <= begin + drift where begin <= width -
    qlen = 1 + trunc(indel_rate*qlen) (bucket_locator.h:521-527 window)
    and drift <= ceil(indel_rate*qlen). The legacy fixed 128-diagonal
    band is ~10x oversized for short reads at indel_rate 0.02 — DP time
    and the traceback tensor scale linearly with the band, so sizing it
    to the workload is the single biggest align-stage win. Q is
    64-quantized so neighbouring batch widths (reads of 300+-8 bp)
    share one compiled geometry. Falls back to the legacy (128, 32)
    whenever the computed window would exceed it (e.g. ONT-rate
    indel_rate=0.1 segments), so capability is never reduced.
    """
    qb = -(-Q // 64) * 64
    drift = int(np.ceil(indel_rate * qb)) + 8
    lo = -(-drift // 8) * 8
    hi = 1 + int(indel_rate * qb) + drift
    band = max(32, -(-(lo + hi) // 16) * 16)
    if lo > LO or band > BAND:
        return BAND, LO
    return band, lo


def pack_qcodes(q: np.ndarray) -> np.ndarray:
    """2-bit-pack a (P, Q) uint8 code matrix into (P, ceil(Q/16)) uint32
    (LSB-first) — 4x smaller host->device upload for the align stage."""
    P, Q = q.shape
    W = -(-Q // 16)
    qp = np.zeros((P, W * 16), np.uint32)
    qp[:, :Q] = q
    qp = qp.reshape(P, W, 16) << (np.arange(16, dtype=np.uint32)
                                  * 2)[None, None, :]
    return np.bitwise_or.reduce(qp, axis=2)


def dp_forward(textp, qcodes, qlen, width, band: int, lo: int):
    """Forward pass of the banded DP: one lax.scan step per query row.

    textp (P, wmax + lo) int32 window text left-padded by lo (sentinel 4
    never matches); qcodes (P, Q); qlen/width (P,) int32. Returns
    (final_row (P, band) int32 — the DP row at i == qlen, dirs
    (Q + 1, P, band) uint8 — direction | run length << 2 per cell,
    row 0 all stop).

    The intra-row left move is solved in closed form with the cummax
    transform (module docstring), so each step is a handful of fused
    elementwise ops and two cummax scans over the band.
    """
    P, Q = qcodes.shape
    d_idx = jnp.arange(band, dtype=jnp.int32)
    # row 0: M[0][j] = 0 for 0 <= j <= width else NEG ; j = d - lo
    j0 = d_idx[None, :] - lo
    row0 = jnp.where((j0 >= 0) & (j0 <= width[:, None]), 0, NEG)

    def step(carry, i):
        prev, prev_db, final_row = carry
        qchar = qcodes[:, i - 1].astype(jnp.int32)       # (P,)
        trow = jax.lax.dynamic_slice_in_dim(textp, i - 1, band, axis=1)
        sub = jnp.where(trow == qchar[:, None], 0, -1)
        diag = prev + sub
        up = jnp.concatenate([prev[:, 1:], jnp.full((P, 1), NEG, jnp.int32)],
                             axis=1) - 1
        base = jnp.maximum(diag, up)
        m = jax.lax.cummax(base + d_idx[None, :], axis=1) - d_idx[None, :]
        # cell validity: j = i + d - lo within [0, width]
        j = i + d_idx[None, :] - lo
        valid = (j >= 0) & (j <= width[:, None])
        m = jnp.where(valid, m, NEG)
        dirs = jnp.where(m == diag, 1, jnp.where(m == up, 2, 3))
        dirs = jnp.where(valid & (m > NEG // 2), dirs, 0)
        # run lengths (capped 63) so the traceback can JUMP whole
        # same-op chains: byte = dir | run << 2 (tb_mode="runs").
        # diag chain predecessor = (i-1, d); up (I) = (i-1, d+1);
        # left (D) = (i, d-1) — the D chain is intra-row, solved as
        # distance-to-last-non-D via a cummax
        pd = prev_db & 3
        pr = prev_db >> 2
        run1 = jnp.minimum(jnp.where(pd == 1, pr, 0) + 1, 63)
        pd_up = jnp.concatenate([pd[:, 1:], jnp.zeros((P, 1), jnp.int32)],
                                axis=1)
        pr_up = jnp.concatenate([pr[:, 1:], jnp.zeros((P, 1), jnp.int32)],
                                axis=1)
        run2 = jnp.minimum(jnp.where(pd_up == 2, pr_up, 0) + 1, 63)
        last = jax.lax.cummax(
            jnp.where(dirs != 3, d_idx[None, :], -1), axis=1)
        run3 = jnp.minimum(d_idx[None, :] - last, 63)
        run = jnp.where(dirs == 1, run1,
                        jnp.where(dirs == 2, run2,
                                  jnp.where(dirs == 3, run3, 0)))
        db = jnp.where(dirs > 0, dirs | (run << 2), 0)
        final_row = jnp.where((i == qlen)[:, None], m, final_row)
        return (m, db, final_row), db.astype(jnp.uint8)

    init_final = jnp.where((qlen == 0)[:, None], row0,
                           jnp.full((P, band), NEG))
    (_, _, final_row), dirs = jax.lax.scan(
        step, (row0, jnp.zeros((P, band), jnp.int32), init_final),
        jnp.arange(1, Q + 1))
    dirs = jnp.concatenate(
        [jnp.zeros((1, P, band), jnp.uint8), dirs])  # row 0 all stop
    return final_row, dirs


class BandedAligner:
    def __init__(self, index: BucketIndex, pair_batch: int = 512):
        self.index = index
        self.cfg = index.config
        self.pair_batch = pair_batch
        # lazy device transfer: the pipeline installs the fine stage's
        # device-resident copy instead (a second upload would duplicate
        # 0.4+ GB of HBM at genome scale)
        self._bp_host = index.buckets_packed
        self._bp_dev = None
        self.bucket_lengths = jnp.asarray(index.bucket_lengths)
        self._align = jax.jit(self._align_impl)
        self._align_runs = jax.jit(self._align_runs_impl,
                                   static_argnames=("run_cap", "wrap_star"))
        # device-RLE run budget per pair (shared across the sub-batch);
        # short reads carry ~1.2 runs/CIGAR, so 8 is generous. Overflow
        # falls back to the packed-ops path for that sub-batch.
        self.run_cap_per_pair = int(os.environ.get("BMTPU_ALIGN_RUN_CAP", "8"))

    @property
    def buckets_packed(self):
        if self._bp_dev is None:
            from bucketmap_tpu.index.builder import materialize
            self._bp_dev = jnp.asarray(materialize(self._bp_host))
        return self._bp_dev

    @buckets_packed.setter
    def buckets_packed(self, v):
        self._bp_dev = v
        self._bp_tiles = None

    _NT_PAD = 4   # zero sub-tiles appended so t0+i never needs clipping

    @property
    def buckets_tiled(self):
        """(N, T, 128) zero-padded sub-tile view of buckets_packed.

        The window extraction gathers whole 128-word sub-tile rows from
        this view — the row-granular gather XLA lowers efficiently —
        instead of (P, 24) element-granular windows, which it lowers to
        per-element gathers (measured 14 ms per 8192 pairs, ~10x this
        path + shifts).
        """
        if getattr(self, "_bp_tiles", None) is None:
            bp = self.buckets_packed
            wb = bp.shape[1]
            T = -(-wb // 128) + self._NT_PAD

            @jax.jit
            def tile(a):
                return jnp.pad(
                    a, ((0, 0), (0, T * 128 - wb))).reshape(a.shape[0], T,
                                                            128)

            self._bp_tiles = jax.block_until_ready(tile(bp))
        return self._bp_tiles

    # ------------------------------------------------------------------
    def _extract_windows(self, tiles, bucket_ids, offsets, wmax: int):
        """Gather text windows (P, wmax) of base codes from the tiled
        packed buckets (buckets_tiled).

        Per pair: nt whole-sub-tile row gathers covering the window,
        then a word-level log-shift (7 masked static shifts) and a
        base-level log-shift replace the element-granular gather +
        per-row dynamic_slice. Positions beyond the bucket read as code
        0; callers mask by width.
        """
        P = bucket_ids.shape[0]
        words_needed = wmax // 16 + 2
        wb = self._bp_host.shape[1]
        nt = min((words_needed + 127) // 128 + 1, tiles.shape[1])
        word0 = jnp.clip(jnp.clip(offsets, 0, None) // 16, 0,
                         max(0, wb - words_needed))
        t0 = word0 // 128
        parts = [tiles[bucket_ids, t0 + i] for i in range(nt)]
        words = jnp.concatenate(parts, axis=1)           # (P, nt*128)
        s = word0 - t0 * 128                             # in [0, 128)
        k = 1
        while k < 128:
            shifted = jnp.concatenate(
                [words[:, k:], jnp.zeros((P, k), words.dtype)], axis=1)
            words = jnp.where((s & k)[:, None] != 0, shifted, words)
            k *= 2
        win_words = words[:, :words_needed]
        shifts = jnp.arange(16, dtype=jnp.uint32) * 2
        bases = (win_words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(3)
        flat = bases.reshape(P, -1).astype(jnp.int32)    # (P, 16*wn)
        # residual base shift; matches the old dynamic_slice's clamping
        start = jnp.clip(jnp.clip(offsets, 0, None) - word0 * 16, 0,
                         16 * words_needed - wmax)
        k = 1
        while k < 16 * words_needed:
            shifted = jnp.concatenate(
                [flat[:, k:], jnp.zeros((P, k), flat.dtype)], axis=1)
            flat = jnp.where((start & k)[:, None] != 0, shifted, flat)
            k *= 2
        return flat[:, :wmax]

    # ------------------------------------------------------------------
    def _align_core(self, buckets_packed, qcodes, qlen, bucket_ids, offsets,
                    is_rc, width, tb_mode: str = "cell",
                    wrap_star: bool = True):
        """qcodes (P, Q) int-like; qlen/offsets/width (P,) int32; is_rc (P,) bool.

        tb_mode "cell": returns score (P,) i32, begin (P,) i32 (text
        begin position), ops (P, Q + 2*lo) uint8 reversed per-cell
        traceback codes (0 = unused) — one scan step per DP cell on the
        optimal path.
        tb_mode "runs": the traceback JUMPS whole same-op chains using
        the run lengths the forward pass stored in bits 2-7 of each
        direction byte — T2 scan steps instead of Q + 2*lo (64 vs 364
        at 300bp; a CIGAR is 1-3 runs, the per-cell scan was ~40% of
        the align cycle). Returns (score, begin, run_op (P, T2),
        run_len (P, T2), unterminated (P,) bool) in traceback order;
        adjacent runs may share an op (63-cap chain splits) — merged by
        the caller's RLE. wrap_star skips the traceback entirely for
        score < -60 rows (their runs are zeroed anyway; a garbage row
        would otherwise overflow T2 and force the sub-batch fallback).
        """
        P, Q = qcodes.shape
        band, lo = band_geometry(Q, self.cfg.indel_rate)
        wmax = Q + band  # static upper bound on window length
        text = self._extract_windows(buckets_packed, bucket_ids, offsets,
                                     wmax).astype(jnp.int32)
        jcol = jnp.arange(wmax, dtype=jnp.int32)
        in_win = jcol[None, :] < width[:, None]
        # reverse-complement the *window* for reverse-strand pairs:
        # text_rc[j] = 3 - text[width-1-j] = (3 - flip(text))[j + wmax -
        # width], i.e. a static flip (cheap reverse op) plus a per-row
        # LEFT shift by delta = wmax - width, done as log2(wmax) masked
        # static shifts instead of a take_along_axis, which lowers to a
        # general gather.
        text_rc = 3 - text[:, ::-1]
        delta = (wmax - width).astype(jnp.int32)             # in [0, wmax]
        k = 1
        while k < wmax:
            shifted = jnp.concatenate(
                [text_rc[:, k:], jnp.full((P, k), 4, jnp.int32)], axis=1)
            text_rc = jnp.where((delta & k)[:, None] != 0, shifted, text_rc)
            k *= 2
        text = jnp.where(is_rc[:, None], text_rc, text)
        text = jnp.where(in_win, text, 4)                    # sentinel: never matches

        # left-pad by lo so row i reads text[(i-1) + d - lo] as a slice at i-1
        textp = jnp.pad(text, ((0, 0), (lo, 0)), constant_values=4)

        final_row, dirs = dp_forward(textp, qcodes, qlen, width, band, lo)

        def get_byte(i, d):
            return dirs[i, jnp.arange(P),
                        jnp.clip(d, 0, band - 1)].astype(jnp.int32)

        score = final_row.max(axis=1)
        # smallest j among co-optimal ends
        end_d = jnp.argmax(final_row, axis=1).astype(jnp.int32)

        if tb_mode == "runs":
            # run-jump traceback: each step consumes one whole same-op
            # chain (runs capped at 63; longer chains land on another
            # cell of the same chain and continue)
            T2 = 192 if band >= BAND else 64
            i0 = jnp.where(score < -60, 0, qlen) if wrap_star else qlen

            def tbr_step(state, _):
                i, d = state
                b = get_byte(i, d)
                active = i > 0
                op = jnp.where(active, b & 3, 0)
                run = jnp.where(active, b >> 2, 0)
                i = jnp.where((op == 1) | (op == 2), i - run, i)
                d = jnp.where(op == 2, d + run,
                              jnp.where(op == 3, d - run, d))
                return (i, d), jnp.stack([op, run])          # (2, P)

            (fin_i, fin_d), ys = jax.lax.scan(
                tbr_step, (i0, end_d), None, length=T2)
            begin = fin_d - lo
            return (score, begin, ys[:, 0].T, ys[:, 1].T, fin_i > 0)

        # per-cell traceback (legacy, feeds the packed-ops format). The
        # scan is latency-bound (per-step dispatch of (P,) gathers), so
        # 4 steps run per iteration and ops are EMITTED (scan ys)
        # instead of scatter-carried.
        max_ops = Q + 2 * lo
        UNROLL = 4
        n_iter = -(-max_ops // UNROLL)

        def tb_step(state, _):
            i, d = state
            opl = []
            for _j in range(UNROLL):
                cur = get_byte(i, d) & 3
                active = (i > 0)
                op = jnp.where(active, cur, 0).astype(jnp.uint8)
                opl.append(op)
                i = jnp.where(active & (op != 3), i - 1, i)
                d = jnp.where(op == 2, d + 1, jnp.where(op == 3, d - 1, d))
            return (i, d), jnp.stack(opl)                    # (UNROLL, P)

        (fin_i, fin_d), opsy = jax.lax.scan(
            tb_step, (qlen, end_d), None, length=n_iter)
        ops = opsy.reshape(n_iter * UNROLL, P).T[:, :max_ops]
        begin = fin_d - lo                                   # j at i == 0
        return score, begin, ops

    def _align_impl(self, buckets_packed, qcodes, qlen, bucket_ids, offsets,
                    is_rc, width):
        """Packed-ops output format: (score, begin, packed 2-bit op rows)."""
        P, Q = qcodes.shape
        max_ops = Q + 2 * band_geometry(Q, self.cfg.indel_rate)[1]
        score, begin, ops = self._align_core(
            buckets_packed, qcodes, qlen, bucket_ids, offsets, is_rc, width)
        # op codes are 2 bits; pack 16/word so the download is 1/4 the
        # bytes
        ow = -(-max_ops // 16)
        opsp = jnp.pad(ops, ((0, 0), (0, ow * 16 - max_ops)))
        opsp = opsp.reshape(P, ow, 16).astype(jnp.uint32)
        shifts = jnp.arange(16, dtype=jnp.uint32) * 2
        packed = (opsp << shifts[None, None, :]).sum(axis=2).astype(jnp.uint32)
        return score, begin, packed

    # ------------------------------------------------------------------
    # Per-row run cap of the device RLE (static shape). A RECORD-worthy
    # alignment at quality threshold qt has score >= qt - 60, i.e. at
    # most 60 - qt edits and ~2x that many runs; 128 covers qt >= 0.
    MAX_ROW_RUNS = 128

    def _align_runs_impl(self, buckets_packed, qpacked, qlen, bucket_ids,
                         offsets, is_rc, width, run_cap: int,
                         wrap_star: bool = True):
        """Device-RLE output format: ONE int32 vector per sub-batch.

        The packed-ops result is 92 B/pair; a CIGAR is typically 1-3
        runs, so the traceback is run-length-encoded ON
        DEVICE and only the runs ship. qpacked (P, W) uint32 carries the
        query codes 2-bit packed (4x smaller upload than the u8 matrix).
        Layout of the result vector:
          [0] total_runs  [1] max_runs_in_any_row  [2] max_run_len
          [3] n_unterminated_tracebacks
          [4      : 4+P ]  score  (i32)
          [4+P    : 4+2P]  begin  (i32)
          [4+2P   : 4+3P]  n_runs (i32)
          [4+3P   :     ]  run_cap/2 words, 2 uint16 runs per word
                           (run = length << 2 | op, query order)
        Overflow (total_runs > run_cap, a row with > MAX_ROW_RUNS runs,
        or a run longer than 16383 — the uint16 packing's length field)
        is flagged in [0]/[1]/[2]; the caller falls back to the
        packed-ops path for that sub-batch.

        wrap_star (static): apply the short-read size_t-wrap rule — zero
        all runs of rows with score < -60 so the SAM emits '*'
        (PARITY.md DIVERGENCES; bucket_locator.h:571). The long-read
        segment path passes False: a 300bp ONT segment with > 60 edits
        is still a real alignment whose traceback the stitcher needs."""
        P, W = qpacked.shape
        Qp = W * 16
        shifts = jnp.arange(16, dtype=jnp.uint32) * 2
        qcodes = ((qpacked[:, :, None] >> shifts[None, None, :])
                  & jnp.uint32(3)).reshape(P, Qp).astype(jnp.uint8)
        # run-jump traceback (tb_mode="runs"): emits (op, len) per
        # same-op chain in traceback order — T2 (= 64/192) columns
        # instead of Q + 2*lo per-cell steps. Wrap-kept rows (score <
        # -60, the reproduced size_t-wrap quirk, bucket_locator.h:571)
        # skip the traceback entirely under wrap_star: their CIGARs are
        # meaningless garbage with ~50-180 runs and the SAM prints '*'
        # (PARITY.md DIVERGENCES).
        score, begin, t_op, t_len, unterm = self._align_core(
            buckets_packed, qcodes, qlen, bucket_ids, offsets, is_rc, width,
            tb_mode="runs", wrap_star=wrap_star)

        T = t_op.shape[1]
        MR = min(self.MAX_ROW_RUNS, T)
        col = jnp.arange(T, dtype=jnp.int32)[None, :]
        # query order = reversed traceback order; chain splits (63-cap)
        # leave adjacent same-op entries — merge them with the same
        # masked-reduction RLE as before, now weighted by chain length
        codes = t_op[:, ::-1].astype(jnp.int32)
        weights = t_len[:, ::-1].astype(jnp.int32)
        nz = codes != 0
        key = jnp.where(nz, col * 4 + codes, -1)
        prev_key = jax.lax.cummax(
            jnp.pad(key[:, :-1], ((0, 0), (1, 0)), constant_values=-1),
            axis=1)
        prev_code = jnp.where(prev_key >= 0, prev_key & 3, 0)
        isstart = nz & (codes != prev_code)
        run_id = jnp.cumsum(isstart, axis=1, dtype=jnp.int32) - 1
        n_runs = isstart.sum(axis=1, dtype=jnp.int32)
        # per-run length/op as masked one-hot reductions over (P, T, MR)
        # — XLA fuses the one-hot into the sums, nothing materializes
        ridx = jnp.arange(MR, dtype=jnp.int32)[None, :]
        oh = nz[:, :, None] & (run_id[:, :, None] == ridx[:, None, :])
        rlen = jnp.sum(jnp.where(oh, weights[:, :, None], 0), axis=1,
                       dtype=jnp.int32)                          # (P, MR)
        cnt = jnp.sum(oh, axis=1, dtype=jnp.int32)
        ropsum = jnp.sum(jnp.where(oh, codes[:, :, None], 0), axis=1,
                         dtype=jnp.int32)
        rop = ropsum // jnp.maximum(cnt, 1)                      # constant/run
        valid_run = ridx < jnp.minimum(n_runs, MR)[:, None]
        max_rlen = jnp.where(valid_run, rlen, 0).max()  # >16383 ⇒ fallback
        run16 = jnp.where(valid_run, (rlen << 2) | rop, 0).astype(jnp.uint32)
        # flatten rows' runs back-to-back into the shared budget
        goff = jnp.cumsum(n_runs, dtype=jnp.int32)
        base = (goff - n_runs)[:, None]
        tgt = jnp.where(valid_run, base + ridx, run_cap)
        flat = jnp.zeros(run_cap + 1, jnp.uint32).at[
            tgt.reshape(-1)].set(run16.reshape(-1), mode="drop")[:run_cap]
        flat2 = flat.reshape(run_cap // 2, 2)
        runs_w = flat2[:, 0] | (flat2[:, 1] << jnp.uint32(16))
        # [3] counts rows whose traceback did not terminate within T2
        # run-jumps (> T2 runs, e.g. dense-indel garbage with
        # wrap_star=False): the consumer falls back to packed ops
        hdr = jnp.stack([goff[-1], n_runs.max(), max_rlen,
                         unterm.sum(dtype=jnp.int32)])
        return jnp.concatenate([
            hdr, score, begin,
            n_runs, jax.lax.bitcast_convert_type(runs_w, jnp.int32)])

    # ------------------------------------------------------------------
    def _run_batched(self, qcodes, qlen, bucket_ids, offsets, is_rc, consume,
                     mode: str = "ops", run_cap_per_pair: int | None = None,
                     wrap_star: bool = True):
        """Sliding-window sub-batch driver: dispatches pb-row jobs, keeps
        two in flight (device compute of batch i+1 overlaps batch i's
        download AND the host-side `consume` work). Fully eager dispatch
        of a 1.5M-location workload exhausts HBM with ~95 live
        input/workspace buffers; the DP's direction tensor is
        (Q+1, pb, BAND) uint8 — ~40 KB per pair — so pb caps at 16384.

        mode "ops": consume(s, e, sc, bg, packed_ops) — packed 2-bit
        traceback rows. mode "runs": consume(s, e, vec) with the raw
        device-RLE result vector (_align_runs_impl layout)."""
        cfg = self.cfg
        n = len(bucket_ids)
        width = np.minimum(
            qlen + 1 + (cfg.indel_rate * qlen).astype(np.int64),
            np.asarray(self.index.bucket_lengths)[bucket_ids] - offsets,
        ).astype(np.int32)
        pb = min(self.pair_batch, 16384)
        # window depth bounds the live DP direction workspace
        # ((Q+1, pb, BAND) uint8 ≈ 316 MB at pb=8192): 3-deep hides the
        # download behind compute; at pb=16384 cap at 2 (1.26 GB live)
        depth = 2 if pb > 8192 else 3
        if mode == "runs":
            cpp = run_cap_per_pair or self.run_cap_per_pair
            run_cap = -(-cpp * pb // 2) * 2              # even
        bounds = [(s, min(s + pb, n)) for s in range(0, n, pb)]
        pending: list = []
        next_b = 0

        def _p_range(s, e, a, fill=0):
            pad = pb - (e - s)
            a = np.asarray(a[s:e])
            if pad:
                a = np.concatenate(
                    [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            return a

        def _dispatch_one():
            nonlocal next_b
            s, e = bounds[next_b]
            next_b += 1
            args = (jnp.asarray(_p_range(s, e, qlen, 1), dtype=jnp.int32),
                    jnp.asarray(_p_range(s, e, bucket_ids)),
                    jnp.asarray(_p_range(s, e, offsets)),
                    jnp.asarray(_p_range(s, e, is_rc)),
                    jnp.asarray(_p_range(s, e, width, 1)))
            if mode == "runs":
                out = self._align_runs(
                    self.buckets_tiled,
                    jnp.asarray(pack_qcodes(_p_range(s, e, qcodes))),
                    *args, run_cap=run_cap, wrap_star=wrap_star)
            else:
                out = self._align(self.buckets_tiled,
                                  jnp.asarray(_p_range(s, e, qcodes)), *args)
            pending.append((s, e, out))

        while next_b < len(bounds) and len(pending) < depth:
            _dispatch_one()
        while pending:
            s, e, out = pending.pop(0)
            if next_b < len(bounds):
                _dispatch_one()
            if mode == "runs":
                consume(s, e, np.asarray(out))
            else:
                sc, bg, packed = out
                consume(s, e, np.asarray(sc)[: e - s],
                        np.asarray(bg)[: e - s], np.asarray(packed)[: e - s])

    def _ops_rerun(self, qcodes, qlen, bucket_ids, offsets, is_rc, s, e):
        """Overflow fallback: run rows [s, e) through the packed-ops
        program (padded to the sub-batch shape so no new compile) and
        return (sc, bg, packed_ops) numpy."""
        cfg = self.cfg
        width = np.minimum(
            qlen + 1 + (cfg.indel_rate * qlen).astype(np.int64),
            np.asarray(self.index.bucket_lengths)[bucket_ids] - offsets,
        ).astype(np.int32)
        pb = min(self.pair_batch, 16384)

        def _p(a, fill=0):
            pad = pb - (e - s)
            a = np.asarray(a[s:e])
            if pad:
                a = np.concatenate(
                    [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            return a

        sc, bg, packed = self._align(
            self.buckets_tiled, jnp.asarray(_p(qcodes)),
            jnp.asarray(_p(qlen, 1), dtype=jnp.int32),
            jnp.asarray(_p(bucket_ids)), jnp.asarray(_p(offsets)),
            jnp.asarray(_p(is_rc)), jnp.asarray(_p(width, 1)))
        return (np.asarray(sc)[: e - s], np.asarray(bg)[: e - s],
                np.asarray(packed)[: e - s])

    def align_batch_runs_stream(self, qcodes, qlen, bucket_ids, offsets,
                                is_rc, emit_runs,
                                run_cap_per_pair: int | None = None,
                                wrap_star: bool = True):
        """Streaming alignment with device-RLE'd CIGARs: per sub-batch,
        `emit_runs(s, e, sc, bg, n_runs, runs, row_off)` — runs is a
        uint16 array (length << 2 | op, query order), row i's runs are
        runs[row_off[i] : row_off[i+1]). Sub-batches whose run budget
        overflows transparently re-run through the packed-ops path."""
        q = qcodes.shape[1]
        max_ops = q + 2 * band_geometry(q, self.cfg.indel_rate)[1]
        pb = min(self.pair_batch, 16384)
        shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]

        def consume(s, e, vec):
            total, max_row = int(vec[0]), int(vec[1])
            nr_all = vec[4 + 2 * pb: 4 + 3 * pb]
            cap = (len(vec) - 4 - 3 * pb) * 2
            # vec[2] = longest run: > 16383 overflows the uint16 length
            # field (length << 2 | op) and would corrupt silently.
            # vec[3] = tracebacks that did not finish within the
            # run-jump budget (see _align_core tb_mode="runs")
            if total > cap or max_row > self.MAX_ROW_RUNS \
                    or int(vec[2]) > 16383 or int(vec[3]) > 0:
                # rare: dense-indel sub-batch; redo via packed ops
                sc, bg, pk = self._ops_rerun(qcodes, qlen, bucket_ids,
                                             offsets, is_rc, s, e)
                ops = ((pk[:, :, None] >> shifts) & 3).astype(np.uint8)
                ops = ops.reshape(e - s, -1)[:, :max_ops]
                nrs = np.zeros(e - s, np.int64)
                runs_l = []
                for i in range(e - s):
                    # same wrap rule as the device RLE: garbage
                    # alignments kept by the size_t wrap emit '*'
                    # (short-read path only; see wrap_star)
                    row = (ops[i] if not wrap_star or sc[i] >= -60
                           else ops[i][:0])
                    nz = row[row != 0][::-1].astype(np.uint16)
                    if len(nz):
                        ch = np.nonzero(np.diff(nz))[0]
                        st = np.concatenate([[0], ch + 1])
                        en = np.concatenate([ch + 1, [len(nz)]])
                        runs_l.append(((en - st).astype(np.uint16) << 2)
                                      | nz[st])
                        nrs[i] = len(st)
                    else:
                        runs_l.append(np.zeros(0, np.uint16))
                runs = (np.concatenate(runs_l) if runs_l
                        else np.zeros(0, np.uint16))
                row_off = np.zeros(e - s + 1, np.int64)
                np.cumsum(nrs, out=row_off[1:])
                emit_runs(s, e, sc.astype(np.int32), bg.astype(np.int32),
                          nrs.astype(np.int32), runs, row_off)
                return
            sc = vec[4: 4 + pb][: e - s]
            bg = vec[4 + pb: 4 + 2 * pb][: e - s]
            nr = nr_all[: e - s]
            runs = vec[4 + 3 * pb:].view(np.uint16)
            row_off = np.zeros(e - s + 1, np.int64)
            np.cumsum(nr, out=row_off[1:])
            emit_runs(s, e, sc, bg, nr, runs, row_off)

        self._run_batched(qcodes, qlen, bucket_ids, offsets, is_rc, consume,
                          mode="runs", run_cap_per_pair=run_cap_per_pair,
                          wrap_star=wrap_star)

    def align_batch(self, qcodes: np.ndarray, qlen, bucket_ids, offsets, is_rc):
        """Batched with host padding; returns (score, begin, ops) numpy."""
        n = len(bucket_ids)
        q = qcodes.shape[1]
        max_ops = q + 2 * band_geometry(q, self.cfg.indel_rate)[1]
        ow = -(-max_ops // 16)
        out_s = np.zeros(n, np.int32)
        out_b = np.zeros(n, np.int32)
        out_ops = np.zeros((n, max_ops), np.uint8)
        shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]

        def consume(s, e, sc, bg, pk):
            out_s[s:e] = sc
            out_b[s:e] = bg
            ops = ((pk[:, :, None] >> shifts) & 3).astype(np.uint8)
            out_ops[s:e] = ops.reshape(e - s, ow * 16)[:, :max_ops]

        self._run_batched(qcodes, qlen, bucket_ids, offsets, is_rc, consume)
        return out_s, out_b, out_ops

    def align_batch_stream(self, qcodes, qlen, bucket_ids, offsets, is_rc,
                           emit):
        """Streaming alignment: the device RLEs each traceback into runs
        (only ~1-3 per CIGAR), the host formats them to CIGAR bytes
        (native C when available) and hands
        `emit(s, e, scores, begins, cigar_buf, offs)` —
        scores/begins/buf cover rows [s, e) only, offs is (e-s+1,). The
        (n, max_ops) uint8 ops matrix (568 MB at 1.5M locations) never
        exists, and neither does its 2-bit packed download."""
        from bucketmap_tpu.io import native

        use_native = native.available()

        def emit_runs(s, e, sc, bg, nr, runs, row_off):
            res = native.runs_to_cigar(runs, row_off) if use_native else None
            if res is not None:
                buf, offs = res
            else:
                parts = []
                offs = np.zeros(e - s + 1, np.int64)
                for i in range(e - s):
                    rr = runs[row_off[i]: row_off[i + 1]]
                    c = "".join(f"{int(v) >> 2}{_OP_CHARS[int(v) & 3]}"
                                for v in rr)
                    parts.append(c.encode())
                    offs[i + 1] = offs[i] + len(parts[-1])
                buf = b"".join(parts)
            emit(s, e, sc, bg, buf, offs)

        self.align_batch_runs_stream(qcodes, qlen, bucket_ids, offsets,
                                     is_rc, emit_runs)

    def align_batch_cigars(self, qcodes, qlen, bucket_ids, offsets, is_rc):
        """Collected variant of align_batch_stream: returns
        (score, begin, cigar_buf bytes, offsets (n+1,))."""
        n = len(bucket_ids)
        out_s = np.zeros(n, np.int32)
        out_b = np.zeros(n, np.int32)
        bufs: list[bytes] = []
        lens = np.zeros(n, np.int64)

        def emit(s, e, sc, bg, buf, offs):
            out_s[s:e] = sc
            out_b[s:e] = bg
            bufs.append(buf)
            lens[s:e] = np.diff(offs)

        self.align_batch_stream(qcodes, qlen, bucket_ids, offsets, is_rc, emit)
        offsets_out = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offsets_out[1:])
        return out_s, out_b, b"".join(bufs), offsets_out


def ops_to_cigar(ops_row: np.ndarray) -> str:
    """Reversed op codes -> CIGAR string (run-length encoded)."""
    codes = ops_row[ops_row != 0][::-1]
    if len(codes) == 0:
        return "*"
    # vectorized RLE
    change = np.nonzero(np.diff(codes))[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [len(codes)]])
    return "".join(f"{e - s}{_OP_CHARS[int(codes[s])]}" for s, e in zip(starts, ends))
