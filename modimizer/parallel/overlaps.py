"""Device overlap discovery for modasm (reference: findOverlaps,
modasm.c:314-418).

The reference walks, for every read x and every first-occurrence copy-1 hit
h of x, the CSR inverse list inv[h], incrementing a per-candidate counter —
a random-increment workload.  The device formulation is a *self-join of
the hit table on the mod id*, computed entirely with sorts, uniform shifts
and segment reductions (no scatters, no gathers):

1. hit rows (x, j, h, strand) are sorted by (h, x, j); within-read duplicate
   copy-1 mods are masked (and counted: nRepeat / badRepeat, modasm.c:336);
2. all ordered pairs inside an h-group are enumerated by OFFSET: for
   delta = 0..D-1 the partner of sorted row p is row p+delta, valid iff
   h[p] == h[p+delta] — a uniform shift, one mask compare per delta;
   both (x,y) and (y,x) directions are emitted per delta > 0;
3. pair keys (x<<32|y) are sorted once and segment-reduced to per-pair
   counts; the strand-agreement bit rides along, so the same reduction
   yields the orientation vote (nPlus/nMinus seed, modasm.c:361-365);
   the first-encounter rank min-reduces so candidates can be ordered
   exactly like the reference's stable sort by descending count over
   first-encounter insertion order (modasm.c:300-304,353).

The per-candidate order-violation scan (modasm.c:369-391) is genuinely
sequential per pair and stays on the host; it consumes these counts.

On a mesh, step 2's groups shard cleanly by mod (the same hash-prefix
partition as the table builder) and step 3 reshards by x — both are rides
of the existing all_to_all machinery (parallel/sharded.py); this module
implements the single-device op those shards would run.
"""

import functools

import numpy as np

import modimizer

modimizer.configure_jax()

import jax
import jax.numpy as jnp

from .sharded import _join64, _sort_multi

TOPBIT = np.uint32(0x80000000)
TOPMASK = np.uint32(0x7FFFFFFF)


@functools.partial(jax.jit, static_argnames=("dmax", "pair_cap"))
def _overlap_pairs_device(xs, js, hs, strand, is_c1, firstc1, *, dmax,
                          pair_cap):
    """Sorted-group pair enumeration + reduction.

    Inputs are per-hit-row arrays (u32; is_c1 marks copy-1 rows — these
    form the h-groups = the inv lists; firstc1 additionally marks the
    first occurrence within its read — only those act as the x side,
    matching the hmap gate at modasm.c:335-338, while EVERY group row acts
    as the y side, matching the per-inv-entry increment at modasm.c:345).
    Returns per-distinct-pair arrays of length pair_cap: keys (x<<32|y u64,
    sentinel-padded), counts, nPlus, min first-encounter rank ((j<<20|k)
    u64), plus n_pairs, max group size, and an overflow flag."""
    n = xs.shape[0]
    hkey = jnp.where(is_c1, hs, jnp.uint32(0xFFFFFFFF))
    h_s, x_s, j_s, st_s, f_s = _sort_multi(
        [hkey, xs, js], [strand, firstc1.astype(jnp.uint32)],
        is_stable=True)
    grp_live = h_s != jnp.uint32(0xFFFFFFFF)
    live_x = grp_live & (f_s == 1)
    # k = rank within the h-group (inv-list position of the y-side row)
    idx = jnp.arange(n, dtype=jnp.int32)
    grp_start = jnp.where(
        jnp.concatenate([jnp.array([True]), h_s[1:] != h_s[:-1]]), idx, 0)
    grp_start = jax.lax.associative_scan(jnp.maximum, grp_start)
    k_rank = (idx - grp_start).astype(jnp.uint32)
    max_group = jnp.max(jnp.where(grp_live, k_rank, jnp.uint32(0))) + 1

    pair_k, pair_v, pair_r = [], [], []
    for delta in range(dmax):
        if delta == 0:
            ok = live_x
            pair_k.append(jnp.where(ok, _join64(x_s, x_s),
                                    jnp.uint64(0xFFFFFFFFFFFFFFFF)))
            pair_v.append(ok.astype(jnp.uint32))
            pair_r.append(jnp.where(
                ok, (j_s.astype(jnp.uint64) << jnp.uint64(20))
                | k_rank.astype(jnp.uint64),
                jnp.uint64(0xFFFFFFFFFFFFFFFF)))
            continue
        h2 = jnp.roll(h_s, -delta)
        x2 = jnp.roll(x_s, -delta)
        j2 = jnp.roll(j_s, -delta)
        st2 = jnp.roll(st_s, -delta)
        g2 = jnp.roll(grp_live, -delta)
        fx2 = jnp.roll(live_x, -delta)
        same = grp_live & g2 & (h_s == h2) & (idx < n - delta)
        agree = (st_s == st2).astype(jnp.uint32)
        k2 = jnp.roll(k_rank, -delta)
        # direction 1: x-side = row p (first copy1), y-side = row p+delta
        ok1 = same & live_x
        pair_k.append(jnp.where(ok1, _join64(x_s, x2),
                                jnp.uint64(0xFFFFFFFFFFFFFFFF)))
        pair_v.append(agree * ok1.astype(jnp.uint32))
        pair_r.append(jnp.where(
            ok1, (j_s.astype(jnp.uint64) << jnp.uint64(20))
            | k2.astype(jnp.uint64), jnp.uint64(0xFFFFFFFFFFFFFFFF)))
        # direction 2: x-side = row p+delta (first copy1), y-side = row p
        ok2 = same & fx2
        pair_k.append(jnp.where(ok2, _join64(x2, x_s),
                                jnp.uint64(0xFFFFFFFFFFFFFFFF)))
        pair_v.append(agree * ok2.astype(jnp.uint32))
        pair_r.append(jnp.where(
            ok2, (j2.astype(jnp.uint64) << jnp.uint64(20))
            | k_rank.astype(jnp.uint64), jnp.uint64(0xFFFFFFFFFFFFFFFF)))

    allk = jnp.concatenate(pair_k)
    allv = jnp.concatenate(pair_v).astype(jnp.uint32)
    allr = jnp.concatenate(pair_r)
    k_srt, r_srt, v_srt = _sort_multi([allk, allr], [allv])
    m = k_srt.shape[0]
    livep = k_srt != jnp.uint64(0xFFFFFFFFFFFFFFFF)
    first = jnp.concatenate([jnp.array([True]),
                             k_srt[1:] != k_srt[:-1]]) & livep
    n_pairs = jnp.sum(first.astype(jnp.int32))
    # segment reduce: count + sum(agree) per pair via cumsum differences
    ones = livep.astype(jnp.uint32)
    cs_c = jnp.cumsum(ones)
    cs_p = jnp.cumsum(v_srt * ones)
    order = _sort_multi([(~first).astype(jnp.uint8)],
                        [jnp.arange(m, dtype=jnp.int32)], is_stable=True)[1]
    jj = jnp.arange(m, dtype=jnp.int32)
    n_live = jnp.sum(ones).astype(jnp.int32)
    p = order
    p_next = jnp.where(jj + 1 < n_pairs, jnp.roll(order, -1), n_live)
    seg_cnt = (jnp.take(cs_c, jnp.maximum(p_next - 1, 0))
               - jnp.take(cs_c, p) + 1)
    seg_plus = (jnp.take(cs_p, jnp.maximum(p_next - 1, 0))
                - jnp.take(cs_p, p) + jnp.take(v_srt, p))
    is_head = jj < n_pairs
    S = pair_cap
    out_k = jnp.where(is_head[:S], jnp.take(k_srt, p[:S]),
                      jnp.uint64(0xFFFFFFFFFFFFFFFF))
    out_c = jnp.where(is_head[:S], seg_cnt[:S], jnp.uint32(0))
    out_p = jnp.where(is_head[:S], seg_plus[:S], jnp.uint32(0))
    out_r = jnp.where(is_head[:S], jnp.take(r_srt, p[:S]),
                      jnp.uint64(0xFFFFFFFFFFFFFFFF))
    return out_k, out_c, out_p, out_r, n_pairs, max_group, n_pairs > S


# pair rows (hit rows x (2*dmax - 1) offsets) one device call may hold:
# the call concatenates them (u64 key + u64 rank + u32 vote, 20 B a row,
# 5.4 GB at 2^28 rows) and sorts a copy
SLAB_PAIRS = 1 << 28


def _slabs(h_live, dmax, slab_pairs):
    """Cut the copy-1 rows into slabs of whole h-groups.  Returns (slabs,
    dmax): row indices into h_live per slab, in row order, and dmax widened
    to cover the deepest group.  A slab holds the groups that start within
    slab_pairs // (2*dmax - 1) rows of its first row."""
    if not len(h_live):
        return [], dmax
    order = np.argsort(h_live, kind="stable")
    hs = h_live[order]
    new = np.concatenate([[True], hs[1:] != hs[:-1]])
    idx = np.arange(len(hs))
    start = np.maximum.accumulate(np.where(new, idx, 0))
    max_group = int(np.max(idx - start)) + 1
    if max_group > dmax:   # deeper inv lists than the offset sweep
        dmax = 1 << (max_group - 1).bit_length()
    sid = start // max(max_group, slab_pairs // (2 * dmax - 1))
    cut = np.flatnonzero(np.concatenate([[True], sid[1:] != sid[:-1],
                                         [True]]))
    return [np.sort(order[a:b]) for a, b in zip(cut[:-1], cut[1:])], dmax


def _merge_slabs(parts):
    """Sum the per-slab counts of each pair (groups never span slabs, so
    every hit is counted in exactly one slab); the first-encounter rank is
    the minimum over slabs."""
    keys, cnt, plus, rank = (np.concatenate(c) for c in zip(*parts))
    o = np.argsort(keys, kind="stable")
    keys, cnt, plus, rank = keys[o], cnt[o], plus[o], rank[o]
    head = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    head = head[head < len(keys)]
    return (keys[head], np.add.reduceat(cnt, head),
            np.add.reduceat(plus, head), np.minimum.reduceat(rank, head))


def overlap_counts(readset, dmax: int = 64, pair_cap: int = None):
    """Batched findOverlaps phase 1 for ALL reads at once.

    readset: object with hits (u32 mod|TOPBIT), hit_off (i64 CSR), and the
    modset info/depth arrays (copy-number bits, modset.h:44-56).

    Only copy-1 rows form h-groups (the inv lists); the other rows make no
    pairs and stay on the host.  The groups are cut into slabs of at most
    about SLAB_PAIRS pair rows, one device call each, so device memory is
    bounded whatever the readset's size; dmax widens to the deepest group.

    Returns dict with per-pair arrays (x, y, n_hit, n_agree, first_rank)
    sorted by (x, -n_hit, first-encounter order) — the reference's olap
    order after its stable sort (modasm.c:300-304,353) — plus per-read
    n_repeat and bad_repeat."""
    hits = np.ascontiguousarray(readset.hits, np.uint32)
    off = np.asarray(readset.hit_off, np.int64)
    n_reads = len(off) - 1
    info = readset.ms.info
    h = hits & TOPMASK
    strand = (hits >> np.uint32(31)).astype(np.uint32)
    x = np.repeat(np.arange(n_reads, dtype=np.uint32), np.diff(off))
    j = (np.arange(len(hits), dtype=np.uint32)
         - np.repeat(off[:-1], np.diff(off)).astype(np.uint32))
    is_c1 = (info[h] & 3) == 1
    # saturated-depth mods have no inv list (rs_inv_build / modasm.c:269)
    # and their inv walk is skipped on the x side too — exclude them from
    # COUNTING everywhere (they still participate in hmap/dup semantics)
    depth_ok = readset.ms.depth[h] != np.uint16(0xFFFF)

    # first-occurrence-within-read of each copy1 mod (modasm.c:335-338):
    # order (x, j) within (x, h) groups picks the smallest j as first
    o = np.lexsort((j, h, x))
    xo, ho, c1o = x[o], h[o], is_c1[o]
    same = np.concatenate([[False], (xo[1:] == xo[:-1]) & (ho[1:] == ho[:-1])])
    firstc1 = np.zeros(len(hits), bool)
    firstc1[o] = (~same) & c1o
    dup_c1 = np.zeros(len(hits), bool)
    dup_c1[o] = same & c1o
    n_repeat = np.bincount(x[dup_c1], minlength=n_reads).astype(np.int32)
    bad_repeat = n_repeat > 0

    live = np.flatnonzero(is_c1 & depth_ok)
    firstc1_cnt = firstc1 & depth_ok
    slabs, dmax = _slabs(h[live], dmax, SLAB_PAIRS)
    slabs = [live[s] for s in slabs]
    n_pad = max((len(s) for s in slabs), default=0)
    n_pad = -(-n_pad // 1024) * 1024   # one compiled shape for all slabs
    if pair_cap is None and slabs:
        # expectation sum(depth of first-copy1 rows); cap with margin
        d = max(int(readset.ms.depth[h[s[firstc1_cnt[s]]]].astype(
            np.int64).sum()) for s in slabs)
        pair_cap = int(max(1024, min(d + 1024, 1 << 26)))
    from ..ops import route
    route.log(f"overlaps slabs={len(slabs)} rows={len(live)} "
              f"pad={n_pad} dmax={dmax} pair_cap={pair_cap}")
    import jax.numpy as jnp

    def padded(a, rows):
        out = np.zeros(n_pad, a.dtype)
        out[:len(rows)] = a[rows]
        return jnp.asarray(out)

    ones = np.ones(len(hits), bool)
    parts = []
    for rows in slabs:
        args = [padded(a, rows) for a in (x, j, h, strand, ones,
                                           firstc1_cnt)]
        while True:
            out = _overlap_pairs_device(*args, dmax=dmax, pair_cap=pair_cap)
            if bool(np.asarray(out[6])):
                pair_cap *= 2
                continue
            break
        assert int(np.asarray(out[5])) <= dmax
        keys = np.asarray(out[0])
        real = keys != 0xFFFFFFFFFFFFFFFF
        parts.append((keys[real], np.asarray(out[1])[real],
                      np.asarray(out[2])[real], np.asarray(out[3])[real]))
    parts.append((np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                  np.zeros(0, np.uint32), np.zeros(0, np.uint64)))
    keys, cnt, plus, rank = _merge_slabs(parts)
    px = (keys >> 32).astype(np.uint32)
    py = (keys & 0xFFFFFFFF).astype(np.uint32)
    # reference candidate order: per x, stable sort by descending count
    # over first-encounter order
    oo = np.lexsort((rank, (~cnt).astype(np.uint32), px))
    return {
        "x": px[oo], "y": py[oo], "n_hit": cnt[oo],
        "n_agree": plus[oo], "first_rank": rank[oo],
        "n_repeat": n_repeat, "bad_repeat": bad_repeat,
    }
