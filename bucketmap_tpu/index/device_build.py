"""On-device construction of the positional fine index.

The host-built fine tables (index/builder.py:build_fine_index) are
~4 bytes per genome base — 6.8 GB for a 1.7 Gbp genome — and building
plus uploading them is the largest startup cost. But every byte of
those tables is a pure function of the 2-bit packed bucket sequences
(0.43 GB): fine_packed is the hash-stable-sorted (position, hash-low)
per bucket and fine_ptab its 12-bit-prefix segment table.

So build them ON the device: upload only buckets_packed, then per
row-chunk unpack -> k-mer hashes -> lax.sort (stable, carrying
positions) -> searchsorted prefix table, written into donated output
buffers. The device sorts ~1.7 G u32 keys in seconds.

Bit-exact with the host build: the host uses np.argsort(kind="stable")
over hashes with a 0xFFFFFFFF invalid sentinel (builder.py:182-204);
jax.lax.sort(is_stable=True) over the same keys carrying the position
iota yields the identical slot order (verified in
tests/test_device_build.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bucketmap_tpu.index.builder import BucketIndex
from bucketmap_tpu.ops.encoding import kmer_hashes, unpack_2bit


def _build_chunk_impl(packed_rows, lengths_rows, k: int, lb: int,
                      low_bits: int):
    """One row-chunk of the device fine-index build.

    packed_rows: (R, Wb) uint32 2-bit bucket sequences; lengths_rows (R,).
    Returns (fine_packed (R, Lpos) u32, fine_ptab (R, 4097) i32,
    max_seg () i32).
    """
    lpos = lb - k + 1
    codes = unpack_2bit(packed_rows, lb, xp=jnp)
    h = kmer_hashes(codes, k, xp=jnp)                       # (R, Lpos) u32
    pos = jax.lax.broadcasted_iota(jnp.int32, h.shape, 1)
    invalid = pos > (lengths_rows[:, None] - k)
    # 2k <= 30 bits, so 0xFFFFFFFF can never be a real hash
    h = jnp.where(invalid, jnp.uint32(0xFFFFFFFF), h)
    sh, spos = jax.lax.sort((h, pos), num_keys=1, is_stable=True,
                            dimension=1)
    sinvalid = sh == jnp.uint32(0xFFFFFFFF)
    low_mask = jnp.uint32((1 << low_bits) - 1)
    fine_packed = jnp.where(
        sinvalid, jnp.uint32(0xFFFFFFFF),
        (spos.astype(jnp.uint32) << jnp.uint32(low_bits)) & jnp.uint32(0xFFFFFFFF)
        | (sh & low_mask))
    prefix = jnp.where(sinvalid, jnp.int32(4096),
                       (sh >> jnp.uint32(low_bits)).astype(jnp.int32))
    pvals = jnp.arange(4097, dtype=jnp.int32)
    ptab = jax.vmap(
        lambda row: jnp.searchsorted(row, pvals, side="left"))(prefix)
    max_seg = jnp.diff(ptab, axis=1).max()
    return fine_packed, ptab.astype(jnp.int32), max_seg


_build_chunk = jax.jit(_build_chunk_impl, static_argnums=(2, 3, 4))


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _write_chunk(fp_buf, pt_buf, fp_chunk, pt_chunk, row0):
    # fp_buf is tiled 3-D (n, T, 128); pad+retile the (R, lpos) chunk
    # (a small copy — the table itself is never reshaped)
    R = fp_chunk.shape[0]
    Tp = fp_buf.shape[1]
    fp3 = jnp.pad(fp_chunk, ((0, 0), (0, Tp * 128 - fp_chunk.shape[1])),
                  constant_values=np.uint32(0xFFFFFFFF)).reshape(R, Tp, 128)
    fp_buf = jax.lax.dynamic_update_slice(fp_buf, fp3, (row0, 0, 0))
    pt_buf = jax.lax.dynamic_update_slice(pt_buf, pt_chunk, (row0, 0))
    return fp_buf, pt_buf


def build_fine_index_on_device(index: BucketIndex, row_chunk: int = 2048,
                               bp_dev=None):
    """Device-resident (fine_packed, fine_ptab, search_steps, low_bits)
    built from index.buckets_packed without any host fine tables.

    Returns (fine_packed (N, Lpos) u32 DeviceArray, fine_ptab (N, 4097)
    i32 DeviceArray, search_steps int, low_bits int), or None when the
    packed encoding doesn't apply (same conditions as the host build:
    0 <= 2k-12 <= 16 and positions fit 32-low_bits bits).
    """
    cfg = index.config
    k = cfg.query_seed
    if k >= 16:
        return None
    n = index.n_buckets
    lb = index.buckets_packed.shape[1] * 16
    lpos = lb - k + 1
    low_bits = 2 * k - 12
    if not (0 <= low_bits <= 16) or lpos > (1 << (32 - low_bits)):
        return None

    lengths = np.asarray(index.bucket_lengths)
    # stored 3-D (n, T, 128): whole 128-lane sub-tiles + 2 spare, so the
    # vote's hybrid search fetches 3 consecutive sub-tile rows per
    # sample with NO reshape (a 2-D->3-D reshape at query time re-tiles
    # the layout = a 6.4 GB copy, an instant OOM); sentinel fill =
    # invalid slots
    Tp = -(-(-(-lpos // 128) + 2) // 8) * 8   # mult of 8: (n*Tp, 128)
    fp = jnp.full((n, Tp, 128), jnp.uint32(0xFFFFFFFF))
    pt = jnp.full((n, 4097), jnp.int32(lpos))
    max_seg = 1
    for s in range(0, n, row_chunk):
        e = min(s + row_chunk, n)
        lens = lengths[s:e]
        if e - s < row_chunk:
            lens = np.pad(lens, (0, row_chunk - (e - s)))
        if bp_dev is not None:
            # rows already on device (shared upload with the occupancy
            # build) — slice instead of re-transferring
            rows = bp_dev[s:e]
            if e - s < row_chunk:
                rows = jnp.pad(rows, ((0, row_chunk - (e - s)), (0, 0)))
        else:
            rows = np.array(index.buckets_packed[s:e])  # memmap -> resident
            if e - s < row_chunk:   # pad the tail chunk (one compile)
                rows = np.pad(rows, ((0, row_chunk - (e - s)), (0, 0)))
            rows = jnp.asarray(rows)
        fpc, ptc, ms = _build_chunk(rows, jnp.asarray(lens, jnp.int32),
                                    k, lb, low_bits)
        if e - s < row_chunk:
            fpc, ptc = fpc[: e - s], ptc[: e - s]
        fp, pt = _write_chunk(fp, pt, fpc, ptc, s)
        max_seg = max(max_seg, int(ms))
    steps = int(max(1, max_seg)).bit_length()
    return fp, pt, steps, low_bits


def build_fine_index_on_device_sharded(bp, lengths, cfg, mesh,
                                       bucket_axis: str,
                                       row_chunk: int = 1024):
    """Sharded variant: each device builds the fine rows of ITS bucket
    range from its local buckets_packed shard — no host fine tables, no
    cross-device traffic, and per-shard HBM is 1/Db of the full table
    (PERF.md §4 has the per-genome table sizes).

    bp: (Npad, Wb) uint32, sharded P(bucket, None); lengths: (Npad,)
    int32, sharded P(bucket). Padded rows (length 0) come out all-invalid
    (slots 0xFFFFFFFF, ptab all-zero), matching the host padding fills.
    Returns (fine_packed, fine_ptab — both sharded like bp —
    search_steps int, low_bits int), or None when the packed encoding
    doesn't apply.
    """
    from jax.sharding import PartitionSpec as P

    k = cfg.query_seed
    if k >= 16:
        return None
    wb = bp.shape[1]
    lb = wb * 16
    lpos = lb - k + 1
    low_bits = 2 * k - 12
    if not (0 <= low_bits <= 16) or lpos > (1 << (32 - low_bits)):
        return None
    npad = bp.shape[0]
    Db = mesh.shape[bucket_axis]
    nl = npad // Db
    cr = min(row_chunk, nl)
    while nl % cr:
        cr -= 1

    def body(bp_l, lens_l):
        # Incremental fori_loop with the output buffers as loop carries
        # (XLA aliases carries in place): peak HBM = final table + ONE
        # chunk's sort workspace. A lax.map over chunks materialized the
        # whole (n_chunks, cr, Lpos) stack NEXT TO the reshaped result —
        # 2x the 6.8 GB table.
        n_chunks = bp_l.shape[0] // cr

        Tp = -(-(-(-lpos // 128) + 2) // 8) * 8  # see single-device build

        def it(i, carry):
            fp, pt, ms = carry
            s = i * cr
            rows = jax.lax.dynamic_slice_in_dim(bp_l, s, cr, 0)
            lens = jax.lax.dynamic_slice_in_dim(lens_l, s, cr, 0)
            fpc, ptc, m2 = _build_chunk_impl(rows, lens, k, lb, low_bits)
            fp3 = jnp.pad(fpc, ((0, 0), (0, Tp * 128 - fpc.shape[1])),
                          constant_values=np.uint32(0xFFFFFFFF)
                          ).reshape(cr, Tp, 128)
            fp = jax.lax.dynamic_update_slice(fp, fp3, (s, 0, 0))
            pt = jax.lax.dynamic_update_slice(pt, ptc, (s, 0))
            return fp, pt, jnp.maximum(ms, m2)

        # carries are constant-initialized; mark them device-varying
        # explicitly so shard_map's varying-manual-axes check (check_vma,
        # on by default) stays enabled for the whole body
        fp0 = jax.lax.pcast(
            jnp.full((bp_l.shape[0], Tp, 128), jnp.uint32(0xFFFFFFFF)),
            bucket_axis, to="varying")
        pt0 = jax.lax.pcast(
            jnp.full((bp_l.shape[0], 4097), jnp.int32(lpos)),
            bucket_axis, to="varying")
        ms0 = jax.lax.pcast(jnp.int32(1), bucket_axis, to="varying")
        fp, pt, ms = jax.lax.fori_loop(0, n_chunks, it, (fp0, pt0, ms0))
        return fp, pt, ms.reshape(1)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(bucket_axis, None), P(bucket_axis)),
        out_specs=(P(bucket_axis, None, None), P(bucket_axis, None),
                   P(bucket_axis))))
    fp, pt, ms = fn(bp, lengths)
    steps = int(max(1, int(np.asarray(ms).max()))).bit_length()
    return fp, pt, steps, low_bits


# ----------------------------------------------------------------------
# On-device q-gram OCCUPANCY build: the coarse bit-matrix is, like the
# fine tables, a pure function of buckets_packed, so it is built on the
# device from the genome upload instead of uploaded itself.
#
# Scatter-free formulation (no colliding scatter-ORs): per 32-bucket
# GROUP (one u32 word column of the table, bucket_indexer.h:49-61
# semantics), flatten (row = kmer_to_row[qgram_hash], lane = bucket%32)
# into keys row*32+lane, lax.sort, mark first occurrences (dedup), map
# each kept key to its lane bit 1<<lane, prefix-sum, and read each
# row's word as S[bnd[row+1]] - S[bnd[row]] where bnd = searchsorted of
# the row grid — distinct powers of two per segment make the sum an OR.
# Bit-identical to the host build (tests/test_device_build.py).
# ----------------------------------------------------------------------

def _occ_chunk_impl(packed_rows, lengths_rows, k2r, q: int, lb: int,
                    g_rows: int):
    """One chunk of the device occupancy build.

    packed_rows: (GC*32, Wb) u32; lengths_rows: (GC*32,) i32;
    k2r: (4^q,) i32 FracMinHash row map (-1 = unsampled).
    Returns (g_rows, GC) u32 word columns (groups in input order).
    """
    GC = packed_rows.shape[0] // 32
    codes = unpack_2bit(packed_rows, lb, xp=jnp)
    h = kmer_hashes(codes, q, xp=jnp)                     # (GC*32, lpos)
    pos = jax.lax.broadcasted_iota(jnp.int32, h.shape, 1)
    row = k2r[h]                                          # (GC*32, lpos)
    invalid = (pos > (lengths_rows[:, None] - q)) | (row < 0)
    lane = (jax.lax.broadcasted_iota(jnp.int32, h.shape, 0) % 32)
    key = jnp.where(invalid, jnp.uint32(0xFFFFFFFF),
                    (row.astype(jnp.uint32) << jnp.uint32(5))
                    | lane.astype(jnp.uint32))
    key = key.reshape(GC, -1)
    sk = jax.lax.sort(key, dimension=1)
    prev = jnp.concatenate(
        [jnp.full((GC, 1), 0xFFFFFFFF, jnp.uint32), sk[:, :-1]], axis=1)
    keep = (sk != prev) & (sk != jnp.uint32(0xFFFFFFFF))
    vals = jnp.where(keep, jnp.uint32(1) << (sk & jnp.uint32(31)),
                     jnp.uint32(0))
    S = jnp.concatenate([jnp.zeros((GC, 1), jnp.uint32),
                         jnp.cumsum(vals, axis=1)], axis=1)
    grid = (jnp.arange(g_rows + 1, dtype=jnp.uint32) << jnp.uint32(5))
    bnd = jax.vmap(lambda r: jnp.searchsorted(r, grid, side="left"))(sk)
    words = (jnp.take_along_axis(S, bnd[:, 1:], axis=1)
             - jnp.take_along_axis(S, bnd[:, :-1], axis=1))  # (GC, g_rows)
    return words.T


_occ_chunk = jax.jit(_occ_chunk_impl, static_argnums=(3, 4, 5))


def build_occupancy_on_device(index: BucketIndex, width: int | None = None,
                              groups_per_call: int = 8, bp_dev=None):
    """Device-resident q-gram occupancy table (g_rows+1, width) u32 —
    the coarse table the CoarseMapper would otherwise upload — built
    from the device copy of buckets_packed. Sentinel row (all-ones,
    builder.py:347) and column zero-padding to `width` included.
    Returns the device array, or None when the shape is out of scope
    (q > 10: the searchsorted grid would dominate).
    """
    cfg = index.config
    q = cfg.index_seed
    k2r_host = index.kmer_to_row
    g_rows = index.qgram_words.shape[0] - 1
    if q > 10 or g_rows <= 0:
        return None
    n = index.n_buckets
    w = -(-n // 32)
    wq = w if width is None else width
    lb = index.buckets_packed.shape[1] * 16
    lengths = np.asarray(index.bucket_lengths)
    GC = groups_per_call
    k2r = jnp.asarray(np.asarray(k2r_host))

    if bp_dev is None:
        from bucketmap_tpu.index.builder import slab_upload
        bp_dev = slab_upload(index.buckets_packed)

    buf = jnp.zeros((g_rows + 1, wq), jnp.uint32)

    @functools.partial(jax.jit, donate_argnums=(0,), static_argnums=(3,))
    def write(b, cols, c0, gc):
        pad = jnp.zeros((1, gc), jnp.uint32)      # sentinel row, set later
        return jax.lax.dynamic_update_slice(
            b, jnp.concatenate([cols, pad], axis=0), (jnp.int32(0), c0))

    rows_pad = GC * 32
    for c0 in range(0, w, GC):
        gc = min(GC, w - c0)
        r0, r1 = c0 * 32, min((c0 + gc) * 32, n)
        rows = jax.lax.dynamic_slice_in_dim(bp_dev, r0, min(rows_pad, bp_dev.shape[0] - r0), 0)
        lens = lengths[r0:r1]
        if rows.shape[0] < rows_pad:
            rows = jnp.pad(rows, ((0, rows_pad - rows.shape[0]), (0, 0)))
        if len(lens) < rows_pad:
            lens = np.pad(lens, (0, rows_pad - len(lens)))
        cols = _occ_chunk(rows, jnp.asarray(lens, jnp.int32), k2r, q, lb,
                          g_rows)
        if gc < GC:
            cols = cols[:, :gc]
        buf = write(buf, cols, jnp.int32(c0), gc)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def set_sentinel(b):
        # ones over the REAL word columns only: padded columns stay zero
        # in every row, exactly like the host np.pad path (phantom
        # buckets must never gain presence through the sentinel)
        return b.at[g_rows, :w].set(jnp.uint32(0xFFFFFFFF))

    return jax.block_until_ready(set_sentinel(buf))
