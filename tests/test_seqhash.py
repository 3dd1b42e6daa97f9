"""Seqhash unit tests: glibc PRNG, struct layout, scan vs device kernel."""

import numpy as np
import pytest

from modimizer.core.seqhash import Seqhash
from modimizer.ops.seqhash import (ModimizerScanner, _validity,
                                       first_encounter_unique)
from modimizer.utils.glibc_random import GlibcRandom


def test_glibc_factors_known_values():
    # cross-checked against compiled C (srandom/random) on this platform
    g = GlibcRandom(17)
    assert g.seqhash_factor() == 0x49308BB9003CB3AD
    assert g.seqhash_factor() == 0x0FB4E87F75655103
    g0 = GlibcRandom(0)  # glibc maps seed 0 -> 1
    g1 = GlibcRandom(1)
    assert g0.seqhash_factor() == g1.seqhash_factor() == 0x6B8B4567327B23C7


def test_seqhash_struct_roundtrip():
    sh = Seqhash.create(19, 31, 17)
    b = sh.to_bytes()
    assert len(b) == 80
    sh2 = Seqhash.from_bytes(b)
    assert sh2.to_bytes() == b
    assert (sh2.k, sh2.w, sh2.seed) == (19, 31, 17)
    assert sh2.factor1 == sh.factor1 and sh2.mask == sh.mask


def test_scan_matches_reference_recurrence():
    """Position-parallel scan == the sequential rolling recurrence."""
    rng = np.random.default_rng(11)
    sh = Seqhash.create(13, 7, 5)
    codes = rng.integers(0, 4, size=300).astype(np.uint8)
    kmers, hashes, isF = sh.scan(codes)

    # sequential oracle implementing seqhash.c:60-79 literally
    mask = sh.mask
    h = 0
    for j in range(sh.k):
        h = (h << 2) | int(codes[j])
    hrc = 0
    for j in range(sh.k):
        hrc = (hrc >> 2) | ((3 - int(codes[j])) << (2 * (sh.k - 1)))
    for p in range(len(codes) - sh.k + 1):
        if p > 0:
            h = ((h << 2) & mask) | int(codes[p + sh.k - 1])
            hrc = (hrc >> 2) | ((3 - int(codes[p + sh.k - 1])) << (2 * (sh.k - 1)))
        hf = ((h * sh.factor1) & 0xFFFFFFFFFFFFFFFF) >> sh.shift1
        hr = ((hrc * sh.factor1) & 0xFFFFFFFFFFFFFFFF) >> sh.shift1
        exp_isF = hf < hr
        assert bool(isF[p]) == exp_isF, p
        assert int(hashes[p]) == (hf if exp_isF else hr), p
        assert int(kmers[p]) == (h if exp_isF else hrc), p


def test_device_scan_matches_host():
    rng = np.random.default_rng(3)
    sh = Seqhash.create(19, 31, 17)
    lens = [500, 3, 19, 18, 1000, 250, 0, 777]
    seqs = [rng.integers(0, 4, size=l).astype(np.uint8) for l in lens]
    codes = np.concatenate(seqs)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    sc = ModimizerScanner(sh, chunk=1 << 10)
    class B:  # minimal SeqBatch
        pass
    b = B(); b.codes = codes; b.offsets = offsets
    kmers, rid, rpos, isF = sc.scan_batch(b)

    exp = [[], [], [], []]
    for i, s in enumerate(seqs):
        km, pos, f = sh.modimizers(s)
        exp[0].append(km); exp[1].append(np.full(len(km), i))
        exp[2].append(pos); exp[3].append(f)
    assert np.array_equal(kmers, np.concatenate(exp[0]))
    assert np.array_equal(rid, np.concatenate(exp[1]))
    assert np.array_equal(rpos, np.concatenate(exp[2]).astype(np.int64))
    assert np.array_equal(isF, np.concatenate(exp[3]))


def test_validity_mask():
    offsets = np.array([0, 10, 13, 33], np.int64)
    v = _validity(offsets, 33, 5)
    # read0: positions 0..5 valid (len 10, k 5)
    assert v[:6].all() and not v[6:10].any()
    # read1: len 3 < k: none valid
    assert not v[10:13].any()
    # read2: len 20: positions 13..28 valid
    assert v[13:29].all() and not v[29:33].any()


def test_first_encounter_unique():
    kmers = np.array([5, 7, 5, 9, 7, 5], np.uint64)
    u, c = first_encounter_unique(kmers)
    assert u.tolist() == [5, 7, 9]
    assert c.tolist() == [3, 2, 1]
