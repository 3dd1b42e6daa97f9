"""The group-batched native probe engine vs a sequential python oracle.

The native replay (native/modset_native.cpp ms_probe_group + serial
placement) resolves probe chains against a frozen table snapshot and
resumes the walk on in-group conflicts; these tests pin that the resulting
probe LAYOUT (the serialized index table, modset.c:79-104), ids, values and
depths are bit-identical to a one-at-a-time sequential replay of the
reference insertion semantics (modset.c:45-62, modutils.c:26) on a
minimum-size table driven to its 25% load cap — the regime where probe
chains are longest and in-group conflicts are plentiful.
"""

import numpy as np
import pytest

from modimizer.core.modset import Modset
from modimizer.core.seqhash import Seqhash


def oracle_insert(ms, kmers, counts=None):
    mask = ms.table_mask
    bits = ms.table_bits
    f1, s1 = ms.hasher.factor1, ms.hasher.shift1
    for i, kmer in enumerate(kmers):
        h = (int(kmer) * f1 & 0xFFFFFFFFFFFFFFFF) >> s1
        off = h & mask
        idx = ms.index[off]
        diff = 0
        while idx and ms.value[idx] != kmer:
            if not diff:
                diff = ((h >> bits) & mask) | 1
            off = (off + diff) & mask
            idx = ms.index[off]
        if not idx:
            ms.max += 1
            idx = ms.max
            ms.index[off] = idx
            ms.value[idx] = kmer
        d = int(ms.depth[idx]) + int(counts[i] if counts is not None else 1)
        ms.depth[idx] = min(d, 0xFFFF)


@pytest.mark.parametrize("seed,n_uniq,n_stream", [
    (7, 60_000, 200_000),     # dense: load ~23% of the bits=20 table
    (8, 500, 20_000),         # dup-heavy: in-group duplicates guaranteed
    (9, 200_000, 200_000),    # unique-heavy at ~76% of the size cap
])
def test_insert_matches_sequential_oracle(seed, n_uniq, n_stream):
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(seed)
    uniq = rng.choice(1 << 32, n_uniq, replace=False).astype(np.uint64)
    kmers = rng.choice(uniq, n_stream).astype(np.uint64)
    a = Modset(sh, 20)
    b = Modset(sh, 20)
    oracle_insert(a, kmers)
    b.add_batch(kmers)
    assert a.max == b.max
    assert np.array_equal(a.index, b.index)
    assert np.array_equal(a.value[:a.max + 1], b.value[:b.max + 1])
    assert np.array_equal(a.depth[:a.max + 1], b.depth[:b.max + 1])
    # find parity, incl. absent keys
    q = rng.choice(1 << 32, 5000).astype(np.uint64)
    assert np.array_equal(a.find_batch(q), b.find_batch(q))


def oracle_merge(ms, kmers, depths2, infos2):
    """Sequential modsetMerge (modset.c:106-128) incl. the quirky
    info1 = (info1 & 3) | min(copy1+copy2, 3) update."""
    mask = ms.table_mask
    bits = ms.table_bits
    f1, s1 = ms.hasher.factor1, ms.hasher.shift1
    for kmer, d2, i2 in zip(kmers, depths2, infos2):
        h = (int(kmer) * f1 & 0xFFFFFFFFFFFFFFFF) >> s1
        off = h & mask
        idx = ms.index[off]
        diff = 0
        while idx and ms.value[idx] != kmer:
            if not diff:
                diff = ((h >> bits) & mask) | 1
            off = (off + diff) & mask
            idx = ms.index[off]
        if not idx:
            ms.max += 1
            idx = ms.max
            ms.index[off] = idx
            ms.value[idx] = kmer
        ms.depth[idx] = min(int(ms.depth[idx]) + int(d2), 0xFFFF)
        c = min((int(ms.info[idx]) & 3) + (int(i2) & 3), 3)
        ms.info[idx] = (int(ms.info[idx]) & 3) | c


def test_merge_matches_oracle():
    sh = Seqhash.create(14, 16, 3)
    rng = np.random.default_rng(11)
    k1 = rng.choice(1 << 28, 40_000, replace=False).astype(np.uint64)
    k2 = np.concatenate([k1[:20_000],
                         rng.choice(1 << 28, 20_000).astype(np.uint64)])
    stream = rng.choice(k1, 120_000).astype(np.uint64)
    a = Modset(sh, 20); a.add_batch(stream)
    b = Modset(sh, 20); b.add_batch(stream)
    assert np.array_equal(a.index, b.index)
    ms2 = Modset(sh, 20)
    ms2.add_batch(rng.choice(k2, 120_000).astype(np.uint64))
    ms2.info[1:ms2.max + 1] = rng.integers(0, 256, ms2.max).astype(np.uint8)
    n2 = ms2.max
    b.size = (b.table_size >> 2) - 1  # room for the oracle's growth
    grow = b.size - len(b.value)
    if grow > 0:
        b.value = np.concatenate([b.value, np.zeros(grow, np.uint64)])
        b.depth = np.concatenate([b.depth, np.zeros(grow, np.uint16)])
        b.info = np.concatenate([b.info, np.zeros(grow, np.uint8)])
    oracle_merge(b, ms2.value[1:n2 + 1], ms2.depth[1:n2 + 1],
                 ms2.info[1:n2 + 1])
    a.merge(ms2)
    assert a.max == b.max
    assert np.array_equal(a.index, b.index)
    assert np.array_equal(a.value[:a.max + 1], b.value[:b.max + 1])
    assert np.array_equal(a.depth[:a.max + 1], b.depth[:b.max + 1])
    assert np.array_equal(a.info[:a.max + 1], b.info[:b.max + 1])
