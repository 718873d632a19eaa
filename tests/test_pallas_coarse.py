"""The coarse chunk scan (bit-sliced counting + per-word max / at-max
count, ops/coarse.py:_chunk_scan) must equal a numpy oracle on the same
presence words, including the sentinel masking beyond `bound`."""

import numpy as np
import jax
import jax.numpy as jnp

from bucketmap_tpu.ops.coarse import _chunk_scan


def _reference_counts(presence, bound):
    """Tiny numpy oracle: per-bucket hit counts with out-of-range -1."""
    B, two, s, w = presence.shape
    n = w * 32
    bits = np.zeros((B, two, s, n), np.int32)
    for word in range(w):
        for b in range(32):
            bits[..., word * 32 + b] = (presence[..., word] >> b) & 1
    hits = bits.sum(axis=2)
    col = np.arange(n)
    return np.where(col[None, None] < bound, hits, -1)


def _check(B, s, w, bound, seed, dense=False):
    rng = np.random.RandomState(seed)
    if dense:
        presence = rng.randint(0, 2**32, (B, 2, s, w), np.uint64) \
            .astype(np.uint32)
    else:
        # realistic sparsity: ~1 bit per sample-row
        presence = np.zeros((B, 2, s, w), np.uint32)
        hot = rng.randint(0, w * 32, (B, 2, s, 3))
        keep = rng.random_sample(hot.shape) < 0.7
        for i in range(3):
            word, bit = hot[..., i] // 32, hot[..., i] % 32
            np.put_along_axis(
                presence, word[..., None],
                np.take_along_axis(presence, word[..., None], axis=3)
                | np.where(keep[..., i, None], np.uint32(1) << bit[..., None],
                           0).astype(np.uint32), axis=3)
    cm, cc, planes = jax.device_get(
        _chunk_scan(jnp.asarray(presence), jnp.int32(bound)))
    assert cm.shape == cc.shape == (B, 2, w)
    assert planes.shape == (B, 2, s.bit_length(), w)
    # planes are the packed per-bucket counters
    hits = _reference_counts(presence, w * 32)  # unmasked counts
    unpacked = np.zeros_like(hits)
    for j in range(planes.shape[2]):
        for word in range(w):
            for b in range(32):
                unpacked[..., word * 32 + b] |= (
                    ((planes[:, :, j, word] >> b) & 1) << j).astype(np.int32)
    np.testing.assert_array_equal(unpacked, hits)
    # chunk max / at-max count vs the oracle; fully masked words read
    # max -1, count 32
    hc = _reference_counts(presence, bound).reshape(B, 2, w, 32)
    np.testing.assert_array_equal(cm, hc.max(axis=3))
    cnt = (hc == hc.max(axis=3)[..., None]).sum(axis=3)
    np.testing.assert_array_equal(cc, cnt)


def test_chunk_scan_sparse():
    _check(B=24, s=15, w=40, bound=40 * 32, seed=1)


def test_chunk_scan_dense_and_bound():
    # dense bits + bound mid-word: sentinel phantom-bit masking
    _check(B=8, s=15, w=9, bound=9 * 32 - 17, seed=2, dense=True)


def test_chunk_scan_small_samples():
    # s=6 -> 3 planes; bound inside the first word
    _check(B=16, s=6, w=3, bound=5, seed=3, dense=True)
