"""Device overlap counting (parallel/overlaps.py) vs a literal python
oracle of findOverlaps phase 1 (modasm.c:314-353)."""

import numpy as np
import pytest


class FakeMS:
    def __init__(self, info, depth):
        self.info = info
        self.depth = depth


class FakeRS:
    def __init__(self, hits, hit_off, ms):
        self.hits = hits
        self.hit_off = hit_off
        self.ms = ms


TOPBIT = 0x80000000
TOPMASK = 0x7FFFFFFF


def make_readset(seed, n_reads=40, n_mods=60, c1_frac=0.5):
    rng = np.random.default_rng(seed)
    info = np.zeros(n_mods + 1, np.uint8)
    c1 = rng.random(n_mods + 1) < c1_frac
    info[c1] = 1
    info[~c1] = rng.choice([0, 2, 3], (~c1).sum()).astype(np.uint8)
    info[0] = 0
    rows = []
    off = [0]
    for x in range(n_reads + 1):
        nh = 0 if x == 0 else int(rng.integers(0, 30))
        for _ in range(nh):
            m = int(rng.integers(1, n_mods + 1))
            s = int(rng.integers(0, 2))
            rows.append(m | (TOPBIT if s else 0))
        off.append(len(rows))
    hits = np.array(rows, np.uint32)
    depth = np.bincount(hits & TOPMASK, minlength=n_mods + 1
                        ).astype(np.uint16)
    return FakeRS(hits, np.array(off, np.int64), FakeMS(info, depth))


def oracle(rs):
    """Literal phase-1 walk (modasm.c:326-353) for every read."""
    n_reads = len(rs.hit_off) - 1
    info, hits, off = rs.ms.info, rs.hits, rs.hit_off
    # inv lists: per mod, (read, occurrence) in read-then-position order
    inv = {}
    for x in range(n_reads):
        for j in range(off[x], off[x + 1]):
            h = int(hits[j]) & TOPMASK
            inv.setdefault(h, []).append(x)
    out_pairs = {}
    n_repeat = np.zeros(n_reads, np.int32)
    for x in range(n_reads):
        hmap = {}
        olap_order = []   # candidate ids in first-encounter order
        counts = {}
        plus = {}
        for j in range(off[x], off[x + 1]):
            hxx = int(hits[j]) & TOPMASK
            if (info[hxx] & 3) != 1:
                continue
            if hxx in hmap:
                n_repeat[x] += 1
                continue
            hmap[hxx] = j - off[x]
            sx = (int(hits[j]) >> 31) & 1
            for y in inv.get(hxx, []):
                if y not in counts:
                    counts[y] = 0
                    plus[y] = 0
                    olap_order.append(y)
                counts[y] += 1
        # strand agreement: every occurrence of an hmap mod in y
        for y in olap_order:
            p = 0
            for j2 in range(off[y], off[y + 1]):
                h2 = int(hits[j2]) & TOPMASK
                if h2 in hmap:
                    jx = hmap[h2] + off[x]
                    if (int(hits[j2]) >> 31) == (int(hits[jx]) >> 31):
                        p += 1
            plus[y] = p
        # stable sort by descending count over first-encounter order
        order = sorted(olap_order, key=lambda y: -counts[y])
        out_pairs[x] = [(y, counts[y], plus[y]) for y in order]
    return out_pairs, n_repeat


@pytest.mark.parametrize("seed,slab_pairs", [
    (1, 1 << 28), (2, 1 << 28), (3, 1 << 28),
    # slabs of a few groups each: per-slab counts summed on the host
    (1, 200), (2, 500), (4, 1),
])
def test_device_overlap_counts_match_oracle(monkeypatch, seed, slab_pairs):
    from modimizer.parallel import overlaps
    monkeypatch.setattr(overlaps, "SLAB_PAIRS", slab_pairs)
    rs = make_readset(seed)
    # small dmax: exercises the widen path
    got = overlaps.overlap_counts(rs, dmax=8)
    want_pairs, want_rep = oracle(rs)
    assert np.array_equal(got["n_repeat"], want_rep)
    assert np.array_equal(got["bad_repeat"], want_rep > 0)
    # group device rows by x and compare ordered candidate lists
    n_reads = len(rs.hit_off) - 1
    by_x = {x: [] for x in range(n_reads)}
    for x, y, c, a in zip(got["x"], got["y"], got["n_hit"], got["n_agree"]):
        by_x[int(x)].append((int(y), int(c), int(a)))
    for x in range(n_reads):
        assert by_x[x] == want_pairs.get(x, []), f"read {x}"
