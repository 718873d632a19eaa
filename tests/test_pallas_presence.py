"""The coarse presence gather (ops/coarse.py:_presence_rows, the AND of
each sample's q-gram occupancy rows) must equal numpy take+AND, and
presence + chunk scan must equal a per-bucket numpy count — at table
widths that are not a multiple of any tile."""

import numpy as np
import jax
import jax.numpy as jnp

from bucketmap_tpu.ops.coarse import _chunk_scan, _presence_rows


def _ref(tab2, rows):
    out = tab2[rows[:, 0]]
    for i in range(1, rows.shape[1]):
        out = out & tab2[rows[:, i]]
    return out


def test_presence_gather_matches_take_and():
    rng = np.random.default_rng(3)
    G1, wq = 513, 813                       # 813 words: no tile multiple
    tab2 = rng.integers(0, 2**32, (G1, wq), dtype=np.uint32)
    tab = jnp.asarray(tab2)
    for R, nq in [(240, 4), (60, 4), (480, 2), (30, 7), (17, 4)]:
        rows = rng.integers(0, G1, (R, nq)).astype(np.int32)
        out = np.asarray(_presence_rows(tab, jnp.asarray(rows)))
        np.testing.assert_array_equal(out, _ref(tab2, rows))


def test_presence_gather_repeated_rows():
    """All samples hitting the same row (sentinel-style)."""
    rng = np.random.default_rng(4)
    G1, wq = 64, 1000
    tab2 = rng.integers(0, 2**32, (G1, wq), dtype=np.uint32)
    rows = np.full((96, 4), G1 - 1, np.int32)
    out = np.asarray(_presence_rows(jnp.asarray(tab2), jnp.asarray(rows)))
    np.testing.assert_array_equal(out, _ref(tab2, rows))
    np.testing.assert_array_equal(out, np.broadcast_to(tab2[G1 - 1], out.shape))


def test_coarse_score_fused_matches_reference():
    """Presence gather + chunk scan (the whole coarse scoring) must equal
    per-bucket hit counts taken bit by bit in numpy."""
    rng = np.random.default_rng(5)
    G1, wq, s, nq = 257, 45, 15, 4
    B2 = 8
    # sparse-ish rows so max-hit structure is non-trivial
    tab2 = (rng.integers(0, 2**32, (G1, wq), dtype=np.uint32)
            & rng.integers(0, 2**32, (G1, wq), dtype=np.uint32))
    rows = rng.integers(0, G1, (B2 * s, nq)).astype(np.int32)
    bound = wq * 32 - 40
    pres = _presence_rows(jnp.asarray(tab2), jnp.asarray(rows))
    cm, cc, planes = jax.device_get(_chunk_scan(
        pres.reshape(B2 // 2, 2, s, wq), jnp.int32(bound)))
    # numpy: AND the rows, count set bits per bucket over the s samples
    p = _ref(tab2, rows).reshape(B2 // 2, 2, s, wq)
    bits = (p[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    hits = bits.sum(axis=2).reshape(B2 // 2, 2, wq * 32).astype(np.int64)
    hits[..., bound:] = -1
    hc = hits.reshape(B2 // 2, 2, wq, 32)
    np.testing.assert_array_equal(cm, hc.max(axis=3))
    np.testing.assert_array_equal(
        cc, (hc == hc.max(axis=3)[..., None]).sum(axis=3))
    # packed planes decode to the unmasked counts
    counts = sum(((planes[:, :, j, :, None] >> np.arange(32, dtype=np.uint32))
                  & 1).astype(np.int64) << j for j in range(planes.shape[2]))
    np.testing.assert_array_equal(
        counts.reshape(B2 // 2, 2, -1)[..., :bound], hits[..., :bound])
