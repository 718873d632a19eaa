"""Literal _find_offset oracle vs. the device vote kernels.

The oracle below is a line-by-line Python port of the reference's
sequential vote accumulation (bucket_locator.h:209-290), operating on a
per-bucket k-mer -> positions multimap exactly like the C++. Fixtures
include tandem repeats where votes exceed num_samples (per-occurrence
multiplicity) — the reference behavior round 1 diverged from.

Known modeled divergences (documented in ops/vote.py): occurrences are
iterated in ascending position order (the reference's
unordered_multimap::equal_range order is implementation-defined), and at
most MAX_OCC occurrences per sample are considered. The oracle models
both choices, so equality here validates the kernel against the modeled
semantics.
"""

import numpy as np
import pytest

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_fine_index, build_index
from bucketmap_tpu.io.fasta import FastaRecord
from bucketmap_tpu.ops.encoding import kmer_hashes, revcomp_hash
from bucketmap_tpu.ops.vote import FineLocator
from bucketmap_tpu.sim.simulator import random_genome


def find_offset_oracle(bucket_kmer_index, samples, indices, length, rc,
                       cfg: MapperConfig, max_occ=None):
    """Literal port of _find_offset (bucket_locator.h:209-290).

    bucket_kmer_index: dict hash -> list of positions ascending.
    """
    k = cfg.query_seed
    num_samples = len(samples)
    vote_counter: dict[int, int] = {}
    for i in range(num_samples):
        sample_index = num_samples - 1 - i if rc else i
        current_kmer = int(samples[sample_index])
        current_index = int(indices[sample_index])
        if rc:
            current_kmer = int(revcomp_hash(np.uint32(current_kmer), k))
            current_index = length - k - current_index
        occs = bucket_kmer_index.get(current_kmer, [])
        if max_occ is not None:
            occs = occs[:max_occ]
        if not vote_counter:
            for occ in occs:
                position = occ - current_index
                vote_counter[position] = vote_counter.get(position, 0) + 1
        else:
            for occ in occs:
                position = occ - current_index
                close = [kk for kk in vote_counter
                         if position - cfg.allowed_indel <= kk
                         <= position + cfg.allowed_indel]
                if close:
                    for kk in close:
                        vote_counter[kk] += 1
                else:
                    vote_counter[position] = vote_counter.get(position, 0) + 1
    if vote_counter:
        # max votes, tie -> smallest position (max_element comparator)
        pos, votes = max(vote_counter.items(), key=lambda kv: (kv[1], -kv[0]))
        if votes >= num_samples - cfg.allowed_mismatch and pos >= 0:
            return pos, votes
    return -1, 0


def _bucket_multimap(index, bucket, cfg):
    from bucketmap_tpu.ops.encoding import unpack_2bit

    lb = index.buckets_packed.shape[1] * 16
    codes = unpack_2bit(index.buckets_packed[bucket : bucket + 1], lb)[0]
    blen = int(index.bucket_lengths[bucket])
    hashes = kmer_hashes(codes[None, :blen], cfg.query_seed)[0]
    mm: dict[int, list[int]] = {}
    for posn, h in enumerate(hashes):
        mm.setdefault(int(h), []).append(posn)
    return mm


def _run_case(genome, starts, rcs, bucket_len=2048, read_len=150):
    cfg = MapperConfig(bucket_len=bucket_len, read_len=read_len,
                       query_seed=12, locator_samples=10)
    index = build_index(genome, cfg)
    build_fine_index(index, keep_unpacked=True)
    fl = FineLocator(index)

    all_codes = genome[0].codes
    n = len(starts)
    codes = np.zeros((n, cfg.read_len), np.uint8)
    quals = np.full((n, cfg.read_len), 36, np.uint8)
    seg_len = np.full(n, cfg.read_len, np.int32)
    for i, s in enumerate(starts):
        window = all_codes[s : s + cfg.read_len]
        if rcs[i]:
            window = (3 - window)[::-1]
        codes[i] = window
    bucket_ids = (np.asarray(starts) // cfg.bucket_len).astype(np.int32)
    is_rc = np.asarray(rcs, bool)

    samp_hash, samp_idx = fl.prepare(codes, quals, seg_len)
    expected = []
    for i in range(n):
        mm = _bucket_multimap(index, int(bucket_ids[i]), cfg)
        pos, votes = find_offset_oracle(
            mm, samp_hash[i], samp_idx[i], int(seg_len[i]), bool(is_rc[i]),
            cfg, max_occ=FineLocator.MAX_OCC)
        expected.append((pos, votes, votes >= cfg.min_vote and pos >= 1))

    for name in ("packed", "prefix", "sorted", "scan"):
        if name == "prefix":
            fl.fine_packed = None
        if name == "sorted":
            fl.fine_ptab = fl.fine_low = None
        if name == "scan":
            fl.fine_pos = None
        off, votes, acc = fl.vote(bucket_ids, is_rc, samp_hash, samp_idx,
                                  seg_len)
        for i, (epos, evotes, eacc) in enumerate(expected):
            assert bool(acc[i]) == bool(eacc), \
                f"{name} row {i}: accept {acc[i]} != oracle {eacc}"
            if eacc:
                assert int(off[i]) == epos, \
                    f"{name} row {i}: offset {off[i]} != oracle {epos}"
                assert int(votes[i]) == evotes, \
                    f"{name} row {i}: votes {votes[i]} != oracle {evotes}"
    return expected


def test_oracle_equality_random():
    rng = np.random.default_rng(51)
    codes = rng.integers(0, 4, 12 * 2048).astype(np.uint8)
    genome = [FastaRecord("r", codes)]
    starts = rng.integers(1, len(codes) - 150, 24).tolist()
    rcs = (rng.random(24) < 0.5).tolist()
    exp = _run_case(genome, starts, rcs)
    assert sum(1 for e in exp if e[2]) >= 20


def test_oracle_equality_tandem_votes_exceed_samples():
    """Reads drawn from a short-period tandem array: each sampled k-mer
    occurs many times, so the reference's per-occurrence multiplicity
    makes votes exceed num_samples."""
    rng = np.random.default_rng(52)
    # period-3 unit: occurrence proposals are 3 apart = within
    # allowed_indel (ceil(0.02*150) = 3), so one sample's occurrences
    # all vote for the same proposals
    codes = rng.integers(0, 4, 8 * 2048).astype(np.uint8)
    # short arrays (11 units = 33 bp): every in-frame k-mer occurs 7x,
    # all within MAX_OCC, proposals 3 apart -> multi-votes at the winner
    unit = np.array([0, 2, 1], np.uint8)
    for at in (700, 2100, 4500):
        codes[at : at + 33] = np.tile(unit, 11)
    genome = [FastaRecord("tandem", codes)]
    starts = [660, 680, 2080, 2060, 4460, 4480]
    rcs = [False, True, False, True, False, True]
    exp = _run_case(genome, starts, rcs)
    accepted = [e for e in exp if e[2]]
    assert accepted, "tandem fixture should accept at least one location"
    assert any(e[1] > 10 for e in accepted), \
        "expected votes > num_samples on the tandem array"


def test_oracle_equality_mixed_repeat():
    """Reads straddling a repeat/unique boundary: early samples propose
    from the unique flank, later ones hit many tandem occurrences; the
    outcome depends on the reference's sequential creation order."""
    rng = np.random.default_rng(53)
    unit = rng.integers(0, 4, 23).astype(np.uint8)
    block = np.concatenate([
        rng.integers(0, 4, 512).astype(np.uint8),
        np.tile(unit, 40),
        rng.integers(0, 4, 512).astype(np.uint8),
    ])
    codes = np.tile(block, 10)[: 10 * 2048]
    genome = [FastaRecord("mix", codes)]
    starts = [450, 480, 500, 920, 1400, 1960]
    rcs = [False, False, True, True, False, True]
    _run_case(genome, starts, rcs)


def tally_oracle(prop, valid, is_rc, indel, min_vote):
    """The sequential tally of _find_offset (bucket_locator.h:227-290) on
    proposed segment starts: prop/valid (p, O) per pair, samples visited
    in reverse for revcomp pairs; exact-position merge while the counter
    is empty, +-indel merge into every close proposal afterwards."""
    counter: dict[int, int] = {}
    order = range(prop.shape[0] - 1, -1, -1) if is_rc else range(prop.shape[0])
    for j in order:
        tol = indel if counter else 0
        for o in range(prop.shape[1]):
            if not valid[j, o]:
                continue
            x = int(prop[j, o])
            close = [c for c in counter if abs(c - x) <= tol]
            for c in close:
                counter[c] += 1
            if not close:
                counter[x] = 1
    if not counter:
        return 0, 0, False
    best = min(counter, key=lambda c: (-counter[c], c))
    return best, counter[best], counter[best] >= min_vote and best >= 1


@pytest.mark.parametrize("tandem", [False, True])
def test_tally_matches_sequential_oracle(tandem):
    """FineLocator._tally on random proposals (70 pairs, odd-sized) ==
    the sequential oracle, offset/votes/accept on every pair. Tandem
    cases pile near-identical proposals so votes exceed num_samples and
    creation order matters."""
    import jax
    import jax.numpy as jnp

    cfg = MapperConfig(bucket_len=1024, read_len=300)
    fl = FineLocator(build_index(random_genome(8 * 1024, seed=3), cfg))
    rng = np.random.RandomState(11 + tandem)
    P, p, O = 70, cfg.locator_samples, FineLocator.MAX_OCC
    prop = rng.randint(-300, 2000, (P, p, O)).astype(np.int32)
    valid = rng.random_sample((P, p, O)) < 0.35
    valid[:, :, 0] |= rng.random_sample((P, p)) < 0.9
    if tandem:
        base = rng.randint(0, 1500, (P, 1, 1))
        near = rng.random_sample((P, p, O)) < 0.85
        prop = np.where(near, base + rng.randint(-6, 7, (P, p, O)),
                        prop).astype(np.int32)
    is_rc = rng.random_sample(P) < 0.5
    off, votes, acc = jax.device_get(fl._tally(
        jnp.asarray(prop), jnp.asarray(valid), jnp.asarray(is_rc)))
    for i in range(P):
        want = tally_oracle(prop[i], valid[i], is_rc[i], cfg.allowed_indel,
                            cfg.min_vote)
        assert (int(off[i]), int(votes[i]), bool(acc[i])) == want, i
    if tandem:
        assert acc.any()
