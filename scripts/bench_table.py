"""Microbench: the exact MSHSTv2 probe-table replay (native modset engine).

Measures insert (stream replay with duplicates), find, merge and
rebuild_table rates on the PERF.md reference shape (bits=24, ~6M unique,
30M-kmer stream), and cross-checks the group-batched probe engine against a
pure-python/numpy sequential oracle on a small table so the measured code is
the verified code.

Usage: python scripts/bench_table.py [bits] [n_unique_log2] [stream_mult]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from modimizer.core.modset import Modset
from modimizer.core.seqhash import Seqhash

BITS = int(sys.argv[1]) if len(sys.argv) > 1 else 25
NU_LOG2 = int(sys.argv[2]) if len(sys.argv) > 2 else 22
MULT = int(sys.argv[3]) if len(sys.argv) > 3 else 5
REPS = int(sys.argv[4]) if len(sys.argv) > 4 else 3


def oracle_insert(ms, kmers):
    """Sequential reference replay (modset.c:45-62 + modutils.c:26)."""
    mask = ms.table_mask
    bits = ms.table_bits
    f1, s1 = ms.hasher.factor1, ms.hasher.shift1
    for kmer in kmers:
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
        d = int(ms.depth[idx]) + 1
        ms.depth[idx] = min(d, 0xFFFF)


def check_small():
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(7)
    # minimum-size table (bits=20) filled to its 25% size cap: probe chains
    # and in-group conflicts for the serial resume path are both plentiful
    km_uniq = rng.choice(1 << 32, 150_000, replace=False).astype(np.uint64)
    kmers = rng.choice(km_uniq, 600_000).astype(np.uint64)
    a = Modset(sh, 20)
    b = Modset(sh, 20)
    oracle_insert(a, kmers)
    b.add_batch(kmers)
    assert a.max == b.max, (a.max, b.max)
    assert np.array_equal(a.index, b.index), "probe layout diverged"
    assert np.array_equal(a.value[:a.max + 1], b.value[:b.max + 1])
    assert np.array_equal(a.depth[:a.max + 1], b.depth[:b.max + 1])
    # find parity
    q = rng.choice(1 << 32, 3000).astype(np.uint64)
    fa, fb = a.find_batch(q), b.find_batch(q)
    assert np.array_equal(fa, fb)
    print("small-table oracle parity: OK (max=%d, chains exercised)" % a.max,
          file=sys.stderr)


def main():
    check_small()
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(42)
    n_uniq = 1 << NU_LOG2
    uniq = rng.choice(1 << 62, n_uniq, replace=False).astype(np.uint64)
    stream = rng.choice(uniq, n_uniq * MULT).astype(np.uint64)
    n = len(stream)

    dt = None
    for _ in range(REPS):
        ms = Modset(sh, BITS)
        t0 = time.perf_counter()
        ms.add_batch(stream)
        d = time.perf_counter() - t0
        dt = d if dt is None else min(dt, d)
    print(f"insert {n/1e6:.0f}M stream ({ms.max/1e6:.1f}M uniq, bits={BITS})"
          f": {dt:6.2f} s  {n/dt/1e6:7.1f} Mk/s")

    q = rng.choice(stream, 10 * 1000 * 1000).astype(np.uint64)
    dt = None
    for _ in range(REPS):
        t0 = time.perf_counter()
        r = ms.find_batch(q)
        d = time.perf_counter() - t0
        dt = d if dt is None else min(dt, d)
    assert r.all()
    print(f"find   {len(q)/1e6:.0f}M queries              "
          f": {dt:6.2f} s  {len(q)/dt/1e6:7.1f} Mk/s")

    # merge: a second modset with half-overlapping keys
    ms2 = Modset(sh, BITS)
    uniq2 = np.concatenate([uniq[:n_uniq // 2],
                            rng.choice(1 << 62, n_uniq // 4).astype(np.uint64)])
    ms2.add_batch(uniq2.astype(np.uint64))
    t0 = time.perf_counter()
    ms.merge(ms2)
    dt = time.perf_counter() - t0
    print(f"merge  {ms2.max/1e6:.1f}M entries             "
          f": {dt:6.2f} s  {ms2.max/dt/1e6:7.1f} Mk/s")

    t0 = time.perf_counter()
    ms.depth_prune(1, 0)
    dt = time.perf_counter() - t0
    print(f"rebuild {ms.max/1e6:.1f}M entries (prune)     "
          f": {dt:6.2f} s  {ms.max/dt/1e6:7.1f} Mk/s")


if __name__ == "__main__":
    main()
