"""Device scan programs, split out so host-path CLI runs never import jax
(which costs ~2 s).

Per-chunk pipeline (re-design of the reference's sequential rolling
iterator, seqhash.c:154-196): phase-major funnel scan + per-block
compaction (parallel/sharded.py _scan_compact_core), then an
order-preserving densify of the block rows into the first n_emit slots, so
rows leave the device in exact stream order.  Device->host traffic stays
proportional to matches (~C/w of positions), not positions."""

import functools

import modimizer

modimizer.configure_jax()

import jax
import jax.numpy as jnp

from ..parallel.sharded import BLK, _expand_valid, _scan_compact_core
from .packed import expand_sparse_valid
from .seqhash import BLK_COMPACT, scan_bo  # noqa: F401  (re-export)

assert BLK_COMPACT == BLK  # keep the jax-free mirror honest


def _densify_cols(cols, live, bo, cap, sentinels):
    """Butterfly-compact sentinel-padded [nb*bo] block rows into the first
    n_emit slots (then slice to cap) — 21 conditional-roll stages instead of
    a lax.sort.  Correct
    for the same reason as the block butterfly: displacements are monotone
    non-decreasing, and a wrapped arrival's remaining move is always smaller
    than its position.  ORDER-PRESERVING: live rows keep their relative
    order, which is already exact stream order (in-block one-hot ranks are
    emit order; blocks are position-major), so consumers need no sort.

    cols: tuple of [nb*bo] arrays sharing the same live mask."""
    nb = live.shape[0] // bo
    # exclusive global live-count: within-block via an SLT matmul (counts
    # <= bo are exact in f32), block bases via a short cumsum over [nb]
    l2 = live.reshape(nb, bo)
    slt = (jax.lax.broadcasted_iota(jnp.int32, (bo, bo), 0)
           < jax.lax.broadcasted_iota(jnp.int32, (bo, bo), 1)
           ).astype(jnp.bfloat16)
    within = jax.lax.dot_general(l2.astype(jnp.bfloat16), slt,
                                 (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.float32
                                 ).astype(jnp.uint32)
    per_blk = jnp.sum(l2.astype(jnp.uint32), axis=1)
    bases = jnp.concatenate([jnp.zeros(1, jnp.uint32),
                             jnp.cumsum(per_blk)[:-1].astype(jnp.uint32)])
    excl = (bases[:, None] + within).reshape(-1)
    n = live.shape[0]
    idx = jnp.arange(n, dtype=jnp.uint32)
    move = jnp.where(live, idx - excl, jnp.uint32(0))
    cols = list(cols)
    for b in range((n - 1).bit_length()):
        sft = 1 << b
        move_sh = jnp.roll(move, -sft)
        arrive = ((move_sh >> jnp.uint32(b)) & jnp.uint32(1)) == jnp.uint32(1)
        leave = ((move >> jnp.uint32(b)) & jnp.uint32(1)) == jnp.uint32(1)
        cols = [jnp.where(arrive, jnp.roll(c, -sft), c) for c in cols]
        move = jnp.where(arrive, move_sh - jnp.uint32(sft),
                         jnp.where(leave, jnp.uint32(0), move))
    n_live = jnp.sum(live.astype(jnp.int32))
    keep = jnp.arange(cap, dtype=jnp.int32) < n_live
    return tuple(jnp.where(keep, c[:cap], s)
                 for c, s in zip(cols, sentinels))


def _densify_cols_roll2(cols, live, bo, cap, sentinels):
    """Two-phase aligned butterfly densify — same math as _densify_cols
    (ascending-bit conditional rolls of the global move distances), but
    the rolls are reshaped so most stages move whole aligned rows:

    - low bits (sft < 128) run on the TRANSPOSED view [128, n/128] where
      element (c, r) = flat r*128 + c: a flat roll by sft becomes a
      MAJOR-axis roll by sft plus a minor-axis roll by 1 for the carry
      lane(s) (y[c, r] = x[(c+sft)%128, r + ((c+sft) >= 128)]);
    - high bits (sft = 128 m) run on the natural view [n/128, 128] as
      MAJOR-axis rolls by m — aligned whole-row copies.

    Major-axis rolls are plain row relabels, where the flat 1-D rolls of
    _densify_cols can lower to misaligned concat pairs.  Output is
    bit-identical (test)."""
    n = live.shape[0]
    nb = n // bo
    L = 128
    R = n // L
    assert n % L == 0
    l2 = live.reshape(nb, bo)
    slt = (jax.lax.broadcasted_iota(jnp.int32, (bo, bo), 0)
           < jax.lax.broadcasted_iota(jnp.int32, (bo, bo), 1)
           ).astype(jnp.bfloat16)
    within = jax.lax.dot_general(l2.astype(jnp.bfloat16), slt,
                                 (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.float32
                                 ).astype(jnp.uint32)
    per_blk = jnp.sum(l2.astype(jnp.uint32), axis=1)
    bases = jnp.concatenate([jnp.zeros(1, jnp.uint32),
                             jnp.cumsum(per_blk)[:-1].astype(jnp.uint32)])
    excl = (bases[:, None] + within).reshape(-1)
    idx = jnp.arange(n, dtype=jnp.uint32)
    move = jnp.where(live, idx - excl, jnp.uint32(0))

    def low_stage(arrs, move, b):
        # transposed view [L, R]: flat roll by sft = major roll + carry
        sft = 1 << b
        cidx = jax.lax.broadcasted_iota(jnp.uint32, (L, R), 0)
        nocarry = cidx < jnp.uint32(L - sft)

        def flatroll(x):
            xr = jnp.roll(x, -sft, axis=0)
            return jnp.where(nocarry, xr, jnp.roll(xr, -1, axis=1))

        move_sh = flatroll(move)
        arrive = ((move_sh >> jnp.uint32(b)) & jnp.uint32(1)) == jnp.uint32(1)
        leave = ((move >> jnp.uint32(b)) & jnp.uint32(1)) == jnp.uint32(1)
        arrs = [jnp.where(arrive, flatroll(a), a) for a in arrs]
        move = jnp.where(arrive, move_sh - jnp.uint32(sft),
                         jnp.where(leave, jnp.uint32(0), move))
        return arrs, move

    def high_stage(arrs, move, b):
        # natural view [R, L]: flat roll by sft = 128 m = major roll by m
        m = (1 << b) // L
        move_sh = jnp.roll(move, -m, axis=0)
        arrive = ((move_sh >> jnp.uint32(b)) & jnp.uint32(1)) == jnp.uint32(1)
        leave = ((move >> jnp.uint32(b)) & jnp.uint32(1)) == jnp.uint32(1)
        arrs = [jnp.where(arrive, jnp.roll(a, -m, axis=0), a) for a in arrs]
        move = jnp.where(arrive, move_sh - jnp.uint32(1 << b),
                         jnp.where(leave, jnp.uint32(0), move))
        return arrs, move

    nbits = (n - 1).bit_length()
    # low bits on the transposed view (transpose once in, once out)
    arrs = [c.reshape(R, L).T for c in cols]
    move = move.reshape(R, L).T
    for b in range(min(7, nbits)):
        arrs, move = low_stage(arrs, move, b)
    arrs = [a.T for a in arrs]
    move = move.T
    for b in range(7, nbits):
        arrs, move = high_stage(arrs, move, b)
    n_live = jnp.sum(live.astype(jnp.int32))
    keep = jnp.arange(cap, dtype=jnp.int32) < n_live
    return tuple(jnp.where(keep, a.reshape(-1)[:cap], s)
                 for a, s in zip(arrs, sentinels))


def _densify_cols_search(cols, live, bo, cap, sentinels):
    """Search-based densify: compaction backends emit each block's live
    rows as a dense prefix (in-block ranks are 0..cnt-1), so dense row j
    is simply block b = max{b : bases[b] <= j} at offset j - bases[b].
    One binary search over the per-block exclusive counts (log2(nb) gather
    rounds into a cache-resident [nb] table) + one gather per column —
    replaces the 21-stage conditional-roll butterfly.
    Bit-identical output: same rows, same order, same sentinels."""
    nb = live.shape[0] // bo
    l2 = live.reshape(nb, bo)
    per_blk = jnp.sum(l2.astype(jnp.int32), axis=1)
    bases = jnp.cumsum(per_blk) - per_blk               # exclusive [nb]
    j = jnp.arange(cap, dtype=jnp.int32)
    lo = jnp.zeros(cap, jnp.int32)
    hi = jnp.full(cap, nb - 1, jnp.int32)
    for _ in range(max(1, (nb - 1).bit_length())):      # largest b with
        mid = (lo + hi + 1) >> 1                        # bases[b] <= j
        le = bases[mid] <= j
        lo = jnp.where(le, mid, lo)
        hi = jnp.where(le, hi, mid - 1)
    src = jnp.minimum(lo * bo + (j - bases[lo]),
                      jnp.int32(live.shape[0] - 1))
    keep = j < jnp.sum(per_blk)
    return tuple(jnp.where(keep, c[src], s)
                 for c, s in zip(cols, sentinels))


# Densify default when MODIMIZER_DENSIFY is unset: "search" won the H100
# A/B against "roll2" at every measured shape (docs/PERF.md); all modes
# are bit-identical (tests/test_scan_kmers.py).
DENSIFY_DEFAULT = "search"


def densify_default() -> str:
    """Densify mode: MODIMIZER_DENSIFY (search | roll | roll2, read at
    trace time like the compaction backend knob) or DENSIFY_DEFAULT."""
    import os
    return os.environ.get("MODIMIZER_DENSIFY") or DENSIFY_DEFAULT


def _densify_dispatch(cols, live, bo, cap, sentinels):
    mode = densify_default()
    if mode == "roll2" and live.shape[0] % 128 == 0:
        return _densify_cols_roll2(cols, live, bo, cap, sentinels)
    if mode in ("roll", "roll2"):
        return _densify_cols(cols, live, bo, cap, sentinels)
    return _densify_cols_search(cols, live, bo, cap, sentinels)


def _densify(out_k, out_meta, bo, cap):
    live = out_meta != jnp.uint32(0xFFFFFFFF)
    sent_k = (jnp.uint32(0xFFFFFFFF) if out_k.dtype == jnp.uint32
              else jnp.uint64(0xFFFFFFFFFFFFFFFF))
    return _densify_dispatch((out_k, out_meta), live, bo, cap,
                            (sent_k, jnp.uint32(0xFFFFFFFF)))


def _scan_kmers_body(sw, vbits, *, k, w, factor1, bo, cap, front=None):
    """Kmers-only scan chunk for table builds (modutils -a / bench e2e).

    Validity (read boundaries + tail) rides as packed bits (1/8 B/base up),
    so the ONLY download is the dense kmer rows — half the bytes of the
    meta path and no host-side position filtering.  Rows come back in exact
    stream order (see _densify_cols), which is all Modset.add_batch needs
    for first-encounter-id parity (modset.c:56-59).

    Returns (kmers [cap] u32 for k<=16 else u64, total i32; total < 0
    signals overflow — caller rescans the chunk on the host oracle)."""
    C = 32 * (sw.shape[0] - 2)
    valid = _expand_valid(vbits, C)
    out_k, out_meta, n_emit, overflow = _scan_compact_core(
        sw, valid, k=k, w=w, factor1=factor1, C=C, bo=bo, meta_isf=False,
        front=front, vbits=vbits)
    live = out_meta != jnp.uint32(0xFFFFFFFF)
    if k <= 16:
        out_k = out_k.astype(jnp.uint32)
    sent_k = (jnp.uint32(0xFFFFFFFF) if k <= 16
              else jnp.uint64(0xFFFFFFFFFFFFFFFF))
    cap = min(cap, out_k.shape[0])
    (out_k,) = _densify_dispatch((out_k,), live, bo, cap, (sent_k,))
    overflow = overflow | (n_emit > cap)
    total = jnp.where(overflow, jnp.int32(-1), n_emit.astype(jnp.int32))
    return out_k, total


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "factor1", "bo", "cap",
                                    "front"))
def _scan_chunk_kmers(sw, vbits, *, k, w, factor1, bo, cap, front=None):
    return _scan_kmers_body(sw, vbits, k=k, w=w, factor1=factor1, bo=bo,
                            cap=cap, front=front)


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "factor1", "bo", "cap",
                                    "front"))
def _scan_chunk_kmers_sparse(sw, sv_idx, sv_val, m, *, k, w, factor1, bo,
                             cap, front=None):
    """_scan_chunk_kmers with the validity plane shipped as a sorted
    sparse exception list + live count m instead of dense words (~8x
    fewer upload bytes; see ops/packed.expand_sparse_valid)."""
    C = 32 * (sw.shape[0] - 2)
    vbits = expand_sparse_valid(sv_idx, sv_val, m, C // 64)
    return _scan_kmers_body(sw, vbits, k=k, w=w, factor1=factor1, bo=bo,
                            cap=cap, front=front)


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "factor1", "bo", "cap",
                                    "front"))
def _scan_chunk_kmers_sparse_scan(sws, svi, svv, ms, *, k, w, factor1, bo,
                                  cap, front=None):
    """Group-chained kmers-only scan: S chunks ride ONE XLA program via
    lax.scan.  One stacked upload, one dispatch, one stacked download —
    amortizes the per-program launch gap and the per-transfer round trips
    S-fold.

    sws [S, NW+2] u64, svi/svv [S, P] sparse validity exceptions,
    ms [S] i32 live counts (m = 0 pads the final partial group: zero
    validity -> zero emits).  Returns (kmers [S, cap], totals [S] i32;
    a negative total flags that chunk for the caller's wide retry)."""
    C = 32 * (sws.shape[1] - 2)

    def body(_, xs):
        sw, si, sv, m = xs
        vbits = expand_sparse_valid(si, sv, m, C // 64)
        ok, tot = _scan_kmers_body(sw, vbits, k=k, w=w, factor1=factor1,
                                   bo=bo, cap=cap, front=front)
        return None, (ok, tot)

    _, (oks, tots) = jax.lax.scan(body, None, (sws, svi, svv, ms))
    return oks, tots


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "factor1", "bo", "cap",
                                    "front"))
def _scan_chunk(sw, m, *, k, w, factor1, bo, cap, front=None):
    """Packed-stream scan of C positions (C = 32*(len(sw)-2)).

    sw: u64 [C/32 + 2] (big-endian-packed words + halo).  m: i32 live-
    position count.  Returns (kmers [cap] dense block-major, meta u32 [cap]
    = (pos << 1) | isF with 0xFFFFFFFF sentinels past the live rows,
    total i32).  total < 0 signals a block or cap overflow (rows dropped):
    the caller re-runs wider or falls back to a host rescan."""
    C = 32 * (sw.shape[0] - 2)
    NW = C // 32
    rows = jax.lax.broadcasted_iota(jnp.uint32, (32, NW), 0)
    pos = (jax.lax.broadcasted_iota(jnp.uint32, (32, NW), 1) * jnp.uint32(32)
           + rows)
    valid = pos < jnp.uint32(m)
    out_k, out_meta, n_emit, overflow = _scan_compact_core(
        sw, valid, k=k, w=w, factor1=factor1, C=C, bo=bo, meta_isf=True,
        front=front)
    if k <= 16:  # kmer fits u32: halve the device->host bytes
        out_k = out_k.astype(jnp.uint32)
    cap = min(cap, out_k.shape[0])  # dense rows can't exceed padded rows
    out_k, out_meta = _densify(out_k, out_meta, bo, cap)
    overflow = overflow | (n_emit > cap)
    total = jnp.where(overflow, jnp.int32(-1), n_emit.astype(jnp.int32))
    return out_k, out_meta, total
