"""Multi-device sharded modset construction (the reference has no distributed
layer at all — SURVEY.md section 2.3; this subsystem is new design).

Mesh design: one logical axis ``shard``.  Every device plays both roles:

  1. *data / sequence parallel*: each device scans its slice of the 2-bit
     packed read stream (with a k-1 halo) using the same position-parallel
     extraction as ops/seqhash.py;
  2. *table parallel*: the k-mer multiset is partitioned by a hash prefix;
     emitted kmers are routed to their owner shard with ``all_to_all`` over
     the interconnect, and each shard maintains a sorted (kmer, depth, first-position)
     state merged by device sort + segment-reduce.

Reduction semantics implement exactly the reference's merge math: depth is a
saturating U16 add (modutils.c:26, modset.c:122); the *first-encounter stream
position* is min-reduced so the canonical host table (first-encounter ids,
modset.c:57) can be replayed exactly after a final gather — the parallel
build is bit-reproducible against the sequential one.

Host->device traffic is 0.25 B/base (packed stream) + 1/8 B/base (validity
bits); per-step device->host traffic is two scalars.
"""

import functools
import os

import modimizer

modimizer.configure_jax()

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.packed import (derive_tw, div_mod_owner, grev64, mod_is_zero,
                          pack_bits, pack_sw)

U64_SENTINEL = jnp.uint64(0xFFFFFFFFFFFFFFFF)
POS_INF = jnp.uint64(0xFFFFFFFFFFFFFFFF)


def build_mesh(n_devices=None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.array(devices[:n]), ("shard",))


def _split64(x):
    return ((x >> jnp.uint64(32)).astype(jnp.uint32),
            (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32))


def _join64(hi, lo):
    return (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)


def _sort_multi(keys, payloads, is_stable=False):
    """lax.sort with u64 keys/payloads split into u32 pairs."""
    cols = []
    layout = []
    for a, is_key in ([(k, True) for k in keys] +
                      [(p, False) for p in payloads]):
        if a.dtype == jnp.uint64:
            hi, lo = _split64(a)
            cols += [hi, lo]
            layout.append((is_key, "u64"))
        else:
            cols.append(a)
            layout.append((is_key, None))
    nkeys = sum(2 if t == "u64" else 1 for is_key, t in layout if is_key)
    out = jax.lax.sort(tuple(cols), num_keys=nkeys, is_stable=is_stable)
    res = []
    i = 0
    for _is_key, t in layout:
        if t == "u64":
            res.append(_join64(out[i], out[i + 1]))
            i += 2
        else:
            res.append(out[i])
            i += 1
    return res


def sort_u64_with_payload(keys, *payloads):
    """Sort u64 keys ascending with payloads (stable)."""
    out = _sort_multi([keys], list(payloads), is_stable=True)
    return (out[0], *out[1:])


# ------------------------------------------------------------------
# scatter-free build pipeline
#
# Every placement here is a sort + gather (no data-dependent scatters):
#   - routing pads each owner group to `cap` slots by sorting cap sentinel
#     rows per owner alongside the real rows, then gathering group_start+r;
#   - received rows are appended to a contiguous ring with a
#     dynamic_update_slice (contiguous, fast);
#   - the periodic compaction sorts (kmer, pos) lexicographically, compacts
#     segment heads to the front with one stable argsort, and reduces depth
#     with a cumsum difference — no segment_sum, no scatter.
# ------------------------------------------------------------------


# Positions per one-hot compaction block (n=1 path).  The one-hot cube is
# C*bo operand bytes regardless of BLK, but bo itself is mean + 6 sigma of
# Binomial(BLK, 1/w) — sublinear in BLK — so smaller blocks shrink the cube
# (BLK=512 at w=16: bo 64 vs 112).  Inherited value, not re-swept on the
# GPU; MODIMIZER_BLK overrides it (a power of two >= 128).
BLK = int(os.environ.get("MODIMIZER_BLK", "512"))
if BLK < 128 or (BLK & (BLK - 1)):
    raise ValueError("MODIMIZER_BLK must be a power of two >= 128")


def _scan_front(sw, *, k, factor1, C):
    """Phase-major scan front end shared by the single-chip compaction step
    and the multi-device routing step.

    Works on [32, NW] arrays (the long axis minor).  Element [r, i] is
    stream position 32 i + r.  Returns (hashes u64, canonical kmers u64, pos u32,
    isF bool) — all [32, NW]."""
    NW = C // 32
    tw = derive_tw(sw)
    shift1 = jnp.uint64(64 - 2 * k)
    mask2k = jnp.uint64((1 << (2 * k)) - 1)
    w0s, w1s = sw[:NW], sw[1:NW + 1]
    w0t, w1t = tw[:NW], tw[1:NW + 1]
    h_rows, r_rows = [], []
    for r in range(32):
        if r == 0:
            hs, ht = w0s, w0t
        else:
            hs = (w0s << jnp.uint64(2 * r)) | (w1s >> jnp.uint64(64 - 2 * r))
            ht = (w0t >> jnp.uint64(2 * r)) | (w1t << jnp.uint64(64 - 2 * r))
        h_rows.append(hs >> shift1)
        r_rows.append(ht & mask2k)
    h = jnp.stack(h_rows, axis=0)      # [32, NW], element [r, i] = pos 32i+r
    hrc = jnp.stack(r_rows, axis=0)
    f1_ = jnp.uint64(factor1)
    hf = (h * f1_) >> shift1
    hr = (hrc * f1_) >> shift1
    isF = hf < hr
    hashes = jnp.where(isF, hf, hr)
    kmers = jnp.where(isF, h, hrc)
    rows = jax.lax.broadcasted_iota(jnp.uint32, (32, NW), 0)
    pos = (jax.lax.broadcasted_iota(jnp.uint32, (32, NW), 1) * jnp.uint32(32)
           + rows)
    return hashes, kmers, pos, isF


def front_backend_default():
    """Scan-front policy (overridable with MODIMIZER_FRONT): 'funnel64' is
    the u64 funnel; 'u32' computes the whole front in u32 for
    k <= 16 (kmers fit 32 bits, so the hash multiply shrinks from an
    emulated u64 x u64 to four 16x16 partial products + one u32 mullo per
    strand, and every funnel shift halves).  Bit-exact either way
    (tests/test_scan_front_u32.py); read at trace time like
    MODIMIZER_COMPACT."""
    return os.environ.get("MODIMIZER_FRONT", "funnel64")


def _hash32_hi(a, factor1):
    """Bits 32..63 of (a * factor1) mod 2^64 for u32 a, as u32 — the only
    hash window the scan needs for k <= 16 (hf = product >> (64-2k) is a
    sub-window of it).  Exact 16-bit-limb mulhi: the compiler sees four
    16x16->32 partial products with compile-time constant factors instead
    of an emulated 64x64 multiply.

    hi32(a*Fl) = a1*b1 + carry(a1*b0 + a0*b1 + (a0*b0 >> 16)); the inner
    sum is split (c = a1*b0 + (a0*b0>>16), d = a0*b1) so no intermediate
    overflows u32; then + lo32(a*Fh) with natural mod-2^32 wraparound."""
    Fl = factor1 & 0xFFFFFFFF
    b0 = jnp.uint32(Fl & 0xFFFF)
    b1 = jnp.uint32(Fl >> 16)
    Fh = jnp.uint32((factor1 >> 32) & 0xFFFFFFFF)
    a0 = a & jnp.uint32(0xFFFF)
    a1 = a >> jnp.uint32(16)
    c = a1 * b0 + ((a0 * b0) >> jnp.uint32(16))
    d = a0 * b1
    carry = ((c >> jnp.uint32(16)) + (d >> jnp.uint32(16))
             + (((c & jnp.uint32(0xFFFF)) + (d & jnp.uint32(0xFFFF)))
                >> jnp.uint32(16)))
    return a1 * b1 + carry + a * Fh


def _scan_front_u32(sw, *, k, factor1, C):
    """u32 scan front for k <= 16 — bit-exact to _scan_front, all arrays
    u32.  The u64 funnel words are consumed as (hi, lo) u32 halves: the
    forward kmer is bits 32..63 >> (32-2k) of the funnel shift, the RC kmer
    is bits 0..31 of the complement funnel, and both hashes come from
    _hash32_hi.  Returns (hashes u32, kmers u32, pos u32, isF bool)."""
    assert k <= 16
    NW = C // 32
    tw = derive_tw(sw)
    sA = (sw >> jnp.uint64(32)).astype(jnp.uint32)
    sB = sw.astype(jnp.uint32)
    tA = (tw >> jnp.uint64(32)).astype(jnp.uint32)
    tB = tw.astype(jnp.uint32)
    A0, B0, A1 = sA[:NW], sB[:NW], sA[1:NW + 1]
    At0, Bt0, Bt1 = tA[:NW], tB[:NW], tB[1:NW + 1]
    kshift = jnp.uint32(32 - 2 * k)
    mask2k = jnp.uint32((1 << (2 * k)) - 1)
    h_rows, r_rows = [], []
    for r in range(32):
        # bits 32..63 of (w0s << 2r | w1s >> (64-2r)) and bits 0..31 of
        # (w0t >> 2r | w1t << (64-2r)), branching on r so no u32 shift
        # count ever reaches 32
        if r == 0:
            h32, t32 = A0, Bt0
        elif r < 16:
            h32 = (A0 << jnp.uint32(2 * r)) | (B0 >> jnp.uint32(32 - 2 * r))
            t32 = (Bt0 >> jnp.uint32(2 * r)) | (At0 << jnp.uint32(32 - 2 * r))
        elif r == 16:
            h32, t32 = B0, At0
        else:
            h32 = (B0 << jnp.uint32(2 * r - 32)) | (A1 >> jnp.uint32(64 - 2 * r))
            t32 = (At0 >> jnp.uint32(2 * r - 32)) | (Bt1 << jnp.uint32(64 - 2 * r))
        h_rows.append(h32 >> kshift if k < 16 else h32)
        r_rows.append(t32 & mask2k if k < 16 else t32)
    h = jnp.stack(h_rows, axis=0)       # [32, NW], element [r, i] = pos 32i+r
    hrc = jnp.stack(r_rows, axis=0)
    hf = _hash32_hi(h, factor1) >> kshift
    hr = _hash32_hi(hrc, factor1) >> kshift
    isF = hf < hr
    hashes = jnp.where(isF, hf, hr)
    kmers = jnp.where(isF, h, hrc)
    rows = jax.lax.broadcasted_iota(jnp.uint32, (32, NW), 0)
    pos = (jax.lax.broadcasted_iota(jnp.uint32, (32, NW), 1) * jnp.uint32(32)
           + rows)
    return hashes, kmers, pos, isF


def _scan_front_bcast16(sw, *, k, factor1, C):
    """Broadcast scan front for k <= 16 in [16, 2, NW] layout (NW = C/32;
    element [s, par, i] = stream position 32 i + 16 par + s).

    Bit-exact to _scan_front_u32 but with NO per-phase rows: the stream
    rides as four [2, NW] u32 word planes (axis 0 = the u32-half parity of
    the funnel start word — avoiding any [N, 2]-minor interleave), the 16
    funnel phases ride the second axis, and the shift amount is a
    broadcasted iota — so the whole front is ONE fused elementwise
    expression, with no 32-row jnp.stack (a materialized concatenate).

    Position p = 32 i + 16 par + s with j = 2 i + par:
      fwd(p) = P[j] << 2s | P[j+1] >> (32-2s),  P = [hi, lo] pairs of sw
      rc(p)  = Z[j] >> 2s | Z[j+1] << (32-2s),  Z = [lo, hi] pairs of tw

    Returns (hashes u32, kmers u32, isF bool), all [16, 2, NW]."""
    assert k <= 16
    NW = C // 32
    tw = derive_tw(sw)
    hi = (sw >> jnp.uint64(32)).astype(jnp.uint32)
    lo = sw.astype(jnp.uint32)
    thi = (tw >> jnp.uint64(32)).astype(jnp.uint32)
    tlo = tw.astype(jnp.uint32)
    # P[j]/P[j+1] and Z[j]/Z[j+1] by parity of j = 2i + par:
    pa = jnp.stack([hi[:NW], lo[:NW]], axis=0)[None]          # [1, 2, NW]
    pb = jnp.stack([lo[:NW], hi[1:NW + 1]], axis=0)[None]
    za = jnp.stack([tlo[:NW], thi[:NW]], axis=0)[None]
    zb = jnp.stack([thi[:NW], tlo[1:NW + 1]], axis=0)[None]
    s2 = jax.lax.broadcasted_iota(jnp.uint32, (16, 2, NW), 0) * jnp.uint32(2)
    inv = jnp.uint32(32) - s2
    zero = s2 == jnp.uint32(0)
    kf = jnp.where(zero, pa, (pa << s2) | (pb >> inv))
    kr = jnp.where(zero, za, (za >> s2) | (zb << inv))
    if k < 16:
        kshift = jnp.uint32(32 - 2 * k)
        mask2k = jnp.uint32((1 << (2 * k)) - 1)
        kf = kf >> kshift
        kr = kr & mask2k
        hf = _hash32_hi(kf, factor1) >> kshift
        hr = _hash32_hi(kr, factor1) >> kshift
    else:
        hf = _hash32_hi(kf, factor1)
        hr = _hash32_hi(kr, factor1)
    isF = hf < hr
    hashes = jnp.where(isF, hf, hr)
    kmers = jnp.where(isF, kf, kr)
    return hashes, kmers, isF


def _valid16(valid, C):
    """[32, NW] validity ([r, i] = pos 32i+r) -> [16, 2, NW] ([s, par, i] =
    pos 32i+16par+s): a pure index shuffle that fuses into consumers."""
    NW = C // 32
    return valid.reshape(2, 16, NW).transpose(1, 0, 2)


def _scan_compact_fused(sw, valid, *, k, w, factor1, C, bo, meta_isf=False,
                        posmajor=True, vbits=None):
    """Fused scan+compact step for k <= 16 (backend "fused") — same output
    contract as the other backends, restructured so XLA materializes almost
    nothing around the one-hot dot (onehot_i8 materializes a front
    concatenate, s8 limb planes and a reassembly):

    - the front is _scan_front_bcast16 (no stacks, no concatenates);
    - the dot's cols operand is ONE elementwise expression (broadcast the
      kmer/meta planes along a new minor axis, iota-selected shifts), so
      XLA fuses limb generation into the dot operand exactly like it
      already fuses the one-hot side — no s8 plane retiles;
    - the pos column is compacted as a BLOCK-LOCAL 2-limb meta (the block
      base is reconstructed linearly afterwards), so ncols drops 8 -> 6.

    posmajor=True: blocks are contiguous position ranges and rows leave in
    exact stream order — bit-identical to the onehot backends' posmajor
    path.  posmajor=False skips the transpose; blocks are then [16, 2, NW]
    row-major stripes (stride-32 position groups), a DIFFERENT but equally
    legal partition (consumers are order-free; rows carry true positions).
    """
    assert k <= 16
    nb = C // BLK
    NW = C // 32
    hashes, kmers, isF = _scan_front_bcast16(sw, k=k, factor1=factor1, C=C)
    if vbits is not None:
        # [16, 2, NW] validity straight from the packed bit-words: bit
        # (16 par + s) of the u32 half-word i.  The u64->u32 view is a
        # bitcast (little-endian halves ARE the per-32-position words in
        # order), and the reshape + bit test fuse into the emit AND —
        # nothing materializes, unlike _expand_valid's stacked concat.
        v32 = jax.lax.bitcast_convert_type(vbits, jnp.uint32).reshape(NW)
        bit = (jax.lax.broadcasted_iota(jnp.uint32, (16, 2, NW), 1)
               * jnp.uint32(16)
               + jax.lax.broadcasted_iota(jnp.uint32, (16, 2, NW), 0))
        valid16 = ((v32[None, None, :] >> bit) & jnp.uint32(1)).astype(
            jnp.bool_)
    else:
        valid16 = _valid16(valid, C)
    emit = valid16 & mod_is_zero(hashes, w)
    # reshape to block shape BEFORE the staging barrier so the retile fuses
    # into the front's elementwise loop instead of materializing as a
    # standalone relayout
    if posmajor:
        def blk(x):                      # pos-major: [i, par, s] flatten
            return x.transpose(2, 1, 0).reshape(nb, BLK)
        lpos = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1)
        base = jax.lax.broadcasted_iota(jnp.uint32, (nb, 1), 0) \
            * jnp.uint32(BLK)
    else:
        def blk(x):                      # row-major [s, par, i] stripes
            return x.reshape(nb, BLK)
        lpos = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1) \
            * jnp.uint32(32)
        ipb = NW // BLK                  # blocks per (s, par) row
        brow = jax.lax.broadcasted_iota(jnp.uint32, (nb, 1), 0)
        base = ((brow % jnp.uint32(ipb)) * jnp.uint32(32 * BLK)
                + (brow // jnp.uint32(ipb)) % jnp.uint32(2) * jnp.uint32(16)
                + brow // jnp.uint32(2 * ipb))
    stage = os.environ.get("MODIMIZER_FUSED_STAGE", "1") != "0"
    if meta_isf:
        km2, isf2, e2 = blk(kmers), blk(isF), blk(emit)
        if stage:
            km2, isf2, e2 = jax.lax.optimization_barrier((km2, isf2, e2))
        lm2 = (lpos << jnp.uint32(1)) | isf2.astype(jnp.uint32)
        base = base << jnp.uint32(1)
    else:
        # isF is dead here (kmers-only consumers): keep it out of the
        # barrier so its plane is never materialized
        km2, e2 = blk(kmers), blk(emit)
        if stage:
            km2, e2 = jax.lax.optimization_barrier((km2, e2))
        lm2 = lpos
    return _fused_compact_tail(km2, lm2, e2, base, bo=bo)


def _fused_compact_tail(km2, lm2, e2, base, *, bo):
    """One-hot matmul compaction shared by the fused backends: km2/lm2/e2 are
    [nb, BLK] (kmer u32, block-local meta u16, emit bool), base [nb, 1]
    is the per-block meta offset.  Returns the standard backend 4-tuple."""
    nb = km2.shape[0]
    if os.environ.get("MODIMIZER_FUSED_TAIL") == "t1":
        # transposed cumsum: stationary lower-triangular LHS, data RHS —
        # csum_T[j, b] = #emits at p <= j of block b (the data operand
        # contracts on its major axis instead; same values)
        lt = (jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 1)
              <= jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 0)
              ).astype(jnp.int8)
        csum_t = jax.lax.dot_general(lt, e2.astype(jnp.int8),
                                     (((1,), (1,)), ((), ())),
                                     preferred_element_type=jnp.int32)
        csum = csum_t.T
    else:
        # in-block cumsum as a matmul (int8 operands, s32 accumulation)
        ut = (jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 0)
              <= jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 1)
              ).astype(jnp.int8)
        csum = jax.lax.dot_general(e2.astype(jnp.int8), ut,
                                   (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    dest = jnp.where(e2, csum - 1, -1)
    slots = jax.lax.broadcasted_iota(jnp.int32, (nb, bo, BLK), 1)
    cnts = csum[:, -1]
    live = jax.lax.broadcasted_iota(jnp.int32, (nb, bo), 1) < cnts[:, None]
    # (No f32 limbs: default-precision f32 dots may run at reduced
    # precision on an accelerator (bf16 passes, TF32), which truncates
    # limbs wider than 8 bits; int8 limbs with s32 accumulation are exact.)
    mode = os.environ.get("MODIMIZER_FUSED_COLS", "t")
    onehot = (dest[:, None, :] == slots).astype(jnp.int8)
    # cols: biased 8-bit limbs of (kmer u32, local meta u16) as ONE
    # broadcast expression — c < 4 are kmer limbs (msb first), c in {4, 5}
    # the meta limbs.  The limb axis is second-minor ([nb, 6, BLK] and the
    # dot emits [nb, 6, bo]) so no fusion runs over a size-6 minor axis.
    if mode == "t":
        c3 = jax.lax.broadcasted_iota(jnp.uint32, (nb, 6, BLK), 1)
        ksh = jnp.uint32(24) - jnp.minimum(c3, jnp.uint32(3)) * jnp.uint32(8)
        msh = jnp.where(c3 == jnp.uint32(4), jnp.uint32(8), jnp.uint32(0))
        val = jnp.where(c3 < jnp.uint32(4),
                        km2[:, None, :] >> ksh,
                        lm2[:, None, :] >> msh) & jnp.uint32(0xFF)
        cols = (val.astype(jnp.int32) - 128).astype(jnp.int8)
        out = jax.lax.dot_general(cols, onehot,
                                  (((2,), (2,)), ((0,), (0,))),
                                  preferred_element_type=jnp.int32)
        o = jnp.where(live[:, None, :], out + 128, 0).astype(jnp.uint32)
        if os.environ.get("MODIMIZER_FUSED_PACK", "1") != "0":
            # single-pass reassembly: the two u32 rebuilds each re-read the
            # whole [nb, 6, bo] dot output; packing (kmer, meta) into ONE
            # u64 [nb, bo] array reads it once
            pk = ((o[:, 0].astype(jnp.uint64) << jnp.uint64(40))
                  | (o[:, 1].astype(jnp.uint64) << jnp.uint64(32))
                  | (o[:, 2].astype(jnp.uint64) << jnp.uint64(24))
                  | (o[:, 3].astype(jnp.uint64) << jnp.uint64(16))
                  | (o[:, 4].astype(jnp.uint64) << jnp.uint64(8))
                  | o[:, 5].astype(jnp.uint64))
            okmer = (pk >> jnp.uint64(16)).astype(jnp.uint32)
            olm = pk.astype(jnp.uint32) & jnp.uint32(0xFFFF)
        else:
            okmer = ((o[:, 0] << jnp.uint32(24)) | (o[:, 1] << jnp.uint32(16))
                     | (o[:, 2] << jnp.uint32(8)) | o[:, 3])
            olm = (o[:, 4] << jnp.uint32(8)) | o[:, 5]
    else:
        c3 = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK, 6), 2)
        ksh = jnp.uint32(24) - jnp.minimum(c3, jnp.uint32(3)) * jnp.uint32(8)
        msh = jnp.where(c3 == jnp.uint32(4), jnp.uint32(8), jnp.uint32(0))
        val = jnp.where(c3 < jnp.uint32(4),
                        km2[:, :, None] >> ksh,
                        lm2[:, :, None] >> msh) & jnp.uint32(0xFF)
        cols = (val.astype(jnp.int32) - 128).astype(jnp.int8)
        out = jax.lax.dot_general(onehot, cols,
                                  (((2,), (1,)), ((0,), (0,))),
                                  preferred_element_type=jnp.int32)
        o = jnp.where(live[:, :, None], out + 128, 0).astype(jnp.uint32)
        okmer = ((o[:, :, 0] << jnp.uint32(24))
                 | (o[:, :, 1] << jnp.uint32(16))
                 | (o[:, :, 2] << jnp.uint32(8)) | o[:, :, 3])
        olm = (o[:, :, 4] << jnp.uint32(8)) | o[:, :, 5]
    out_k = jnp.where(live, okmer.astype(jnp.uint64),
                      U64_SENTINEL).reshape(-1)
    out_p = jnp.where(live, base + olm,
                      jnp.uint32(0xFFFFFFFF)).reshape(-1)
    # total emits from the per-block counts ([nb] i32) instead of a
    # full-plane pred reduce
    n_emit = jnp.sum(cnts).astype(jnp.int64)
    return out_k, out_p, n_emit, jnp.any(cnts > bo)


def _scan_compact_fused_blocks(sw, vbits, *, k, w, factor1, C, bo,
                               meta_isf=False):
    """Fused scan+compact with the front BORN in block shape (backend
    "fusedb", k <= 16, stripe partition only — the posmajor=False
    contract).  "fused" pays [16, 2, NW] -> [nb, BLK] relayouts that
    materialize even without a transpose under tiled layouts.  Here every
    big tensor starts as
    [16, 2, ipb, BLK]: the four u32 word planes are [1, 2, ipb, BLK]
    row-broadcasts (4 MB each, trivially tiled), the funnel shift rides
    the size-16 leading broadcast axis, validity bits come from the
    packed words with a per-(s, par) bit index, and the flatten to
    [nb, BLK] merges MAJOR dims only — a layout no-op XLA folds into the
    consumer.  Output rows/meta/base are identical to fused@posmajor=False
    (element [s, par, i] = position 32 i + 16 par + s; block row
    b = (2 s + par) ipb + i//BLK).

    Matches seqhash.c:170-196 modimizer semantics, same bit-exactness
    contract as the other backends (verified multiset-identical)."""
    assert k <= 16
    NW = C // 32
    nb = C // BLK
    ipb = NW // BLK
    tw = derive_tw(sw)
    hi = (sw >> jnp.uint64(32)).astype(jnp.uint32)
    lo = sw.astype(jnp.uint32)
    thi = (tw >> jnp.uint64(32)).astype(jnp.uint32)
    tlo = tw.astype(jnp.uint32)

    def planes(p0, p1):                       # [1, 2, ipb, BLK] word plane
        return jnp.stack([p0, p1], 0).reshape(1, 2, ipb, BLK)

    pa = planes(hi[:NW], lo[:NW])             # P[j],  j = 2i + par
    pb = planes(lo[:NW], hi[1:NW + 1])        # P[j+1]
    za = planes(tlo[:NW], thi[:NW])           # Z[j]
    zb = planes(thi[:NW], tlo[1:NW + 1])      # Z[j+1]
    s2 = (jax.lax.broadcasted_iota(jnp.uint32, (16, 1, 1, 1), 0)
          * jnp.uint32(2))
    inv = jnp.uint32(32) - s2
    zero = s2 == jnp.uint32(0)
    kf = jnp.where(zero, pa, (pa << s2) | (pb >> inv))
    kr = jnp.where(zero, za, (za >> s2) | (zb << inv))
    if k < 16:
        kshift = jnp.uint32(32 - 2 * k)
        mask2k = jnp.uint32((1 << (2 * k)) - 1)
        kf = kf >> kshift
        kr = kr & mask2k
        hf = _hash32_hi(kf, factor1) >> kshift
        hr = _hash32_hi(kr, factor1) >> kshift
    else:
        hf = _hash32_hi(kf, factor1)
        hr = _hash32_hi(kr, factor1)
    isF = hf < hr
    hashes = jnp.where(isF, hf, hr)
    kmers = jnp.where(isF, kf, kr)
    # validity bit (16 par + s) of packed u32 half-word i (see fused)
    v32 = jax.lax.bitcast_convert_type(vbits, jnp.uint32).reshape(
        1, 1, ipb, BLK)
    bit = (jax.lax.broadcasted_iota(jnp.uint32, (16, 1, 1, 1), 0)
           + jax.lax.broadcasted_iota(jnp.uint32, (1, 2, 1, 1), 1)
           * jnp.uint32(16))
    valid = ((v32 >> bit) & jnp.uint32(1)).astype(jnp.bool_)
    emit = valid & mod_is_zero(hashes, w)

    def blk(x):                               # major-dim merge: layout no-op
        return x.reshape(nb, BLK)

    lpos = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1) \
        * jnp.uint32(32)
    brow = jax.lax.broadcasted_iota(jnp.uint32, (nb, 1), 0)
    base = ((brow % jnp.uint32(ipb)) * jnp.uint32(32 * BLK)
            + (brow // jnp.uint32(ipb)) % jnp.uint32(2) * jnp.uint32(16)
            + brow // jnp.uint32(2 * ipb))
    stage = os.environ.get("MODIMIZER_FUSED_STAGE", "1") != "0"
    if meta_isf:
        km2, isf2, e2 = blk(kmers), blk(isF), blk(emit)
        if stage:
            km2, isf2, e2 = jax.lax.optimization_barrier((km2, isf2, e2))
        lm2 = (lpos << jnp.uint32(1)) | isf2.astype(jnp.uint32)
        base = base << jnp.uint32(1)
    else:
        km2, e2 = blk(kmers), blk(emit)
        if stage:
            km2, e2 = jax.lax.optimization_barrier((km2, e2))
        lm2 = lpos
    return _fused_compact_tail(km2, lm2, e2, base, bo=bo)


def _scan_compact_fused_sublane(sw, vbits, *, k, w, factor1, C, bo,
                                meta_isf=False, posmajor=False):
    """Fused scan+compact with the funnel-phase axis second-minor (backend
    "fusedc", k <= 16, stripe partition — same consumer contract as
    fusedb).  fusedb's [16, 2, ipb, BLK] tensors put the 16-phase axis
    major-most, so under a tiled layout the flatten to [nb, BLK] needs a
    real retile and every word-plane broadcast materializes.

    Here the axes are [2, ipb, 16, BLK]: the phase axis sits second-minor,
    so the word planes are [2, ipb, 1, BLK] tensors broadcast along it —
    an in-tile replication XLA fuses — and the flatten to [nb, BLK]
    merges major dims only, a bitcast.

    Block row b = (par * ipb + ib) * 16 + s holds positions
    32 (ib BLK + c) + 16 par + s, c = 0..BLK-1: a stride-32 position
    group, the same partition class as fusedb (order-free consumers;
    rows carry true positions via base + 32 c).

    posmajor=True (the kmers-only e2e path, _scan_kmers_body): the front
    still computes in the phase-second-minor layout, then ONE explicit
    transpose [par, ib, s, c] -> [ib, c, par, s] (a single materialized
    relayout of the kmer/emit planes) re-blocks it so
    block b holds positions [b BLK, (b+1) BLK) in order — rows leave the
    device in EXACT stream order, bit-identical to the onehot posmajor
    path (first-encounter-id parity, modset.c:56-59).

    Matches seqhash.c:170-196 modimizer semantics; multiset-identical to
    every other backend (tests/test_scan_kernel_mxu.py)."""
    assert k <= 16
    NW = C // 32
    nb = C // BLK
    ipb = NW // BLK
    tw = derive_tw(sw)
    hi = (sw >> jnp.uint64(32)).astype(jnp.uint32)
    lo = sw.astype(jnp.uint32)
    thi = (tw >> jnp.uint64(32)).astype(jnp.uint32)
    tlo = tw.astype(jnp.uint32)

    def planes(p0, p1):                       # [2, ipb, 1, BLK] word plane
        return jnp.stack([p0, p1], 0).reshape(2, ipb, 1, BLK)

    pa = planes(hi[:NW], lo[:NW])             # P[j],  j = 2i + par
    pb = planes(lo[:NW], hi[1:NW + 1])        # P[j+1]
    za = planes(tlo[:NW], thi[:NW])           # Z[j]
    zb = planes(thi[:NW], tlo[1:NW + 1])      # Z[j+1]
    s2 = (jax.lax.broadcasted_iota(jnp.uint32, (1, 1, 16, 1), 2)
          * jnp.uint32(2))
    inv = jnp.uint32(32) - s2
    zero = s2 == jnp.uint32(0)
    kf = jnp.where(zero, pa, (pa << s2) | (pb >> inv))
    kr = jnp.where(zero, za, (za >> s2) | (zb << inv))
    if k < 16:
        kshift = jnp.uint32(32 - 2 * k)
        mask2k = jnp.uint32((1 << (2 * k)) - 1)
        kf = kf >> kshift
        kr = kr & mask2k
        hf = _hash32_hi(kf, factor1) >> kshift
        hr = _hash32_hi(kr, factor1) >> kshift
    else:
        hf = _hash32_hi(kf, factor1)
        hr = _hash32_hi(kr, factor1)
    isF = hf < hr
    hashes = jnp.where(isF, hf, hr)
    kmers = jnp.where(isF, kf, kr)
    # validity bit (16 par + s) of packed u32 half-word i (see fused)
    v32 = jax.lax.bitcast_convert_type(vbits, jnp.uint32).reshape(
        1, ipb, 1, BLK)
    bit = (jax.lax.broadcasted_iota(jnp.uint32, (2, 1, 1, 1), 0)
           * jnp.uint32(16)
           + jax.lax.broadcasted_iota(jnp.uint32, (1, 1, 16, 1), 2))
    valid = ((v32 >> bit) & jnp.uint32(1)).astype(jnp.bool_)
    emit = valid & mod_is_zero(hashes, w)

    def blk(x):                               # major-dim merge: layout no-op
        return x.reshape(nb, BLK)

    if posmajor:
        # stream-order re-block AFTER the staging barrier (below): the
        # front fusions stay byte-for-byte the fast stripe program, and
        # the reorder [par, ib, s, c] -> [ib, c, par, s] (flat index
        # ((ib BLK + c) 2 + par) 16 + s == position) is one explicit
        # relayout per staged plane.  Re-blocking BEFORE the barrier
        # instead changes the front's layout assignment (the word-plane
        # broadcasts then materialize at transpose-friendly layouts).
        def reblock(x):
            return (x.reshape(2, ipb, 16, BLK).transpose(1, 3, 0, 2)
                    .reshape(nb, BLK))

        lpos = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1)
        base = jax.lax.broadcasted_iota(jnp.uint32, (nb, 1), 0) \
            * jnp.uint32(BLK)
    else:
        reblock = None
        lpos = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1) \
            * jnp.uint32(32)
        brow = jax.lax.broadcasted_iota(jnp.uint32, (nb, 1), 0)
        base = ((brow // jnp.uint32(16)) % jnp.uint32(ipb)
                * jnp.uint32(32 * BLK)
                + brow // jnp.uint32(16 * ipb) * jnp.uint32(16)
                + brow % jnp.uint32(16))
    stage = os.environ.get("MODIMIZER_FUSED_STAGE", "1") != "0"
    if meta_isf:
        km2, isf2, e2 = blk(kmers), blk(isF), blk(emit)
        if stage:
            km2, isf2, e2 = jax.lax.optimization_barrier((km2, isf2, e2))
        if reblock is not None:
            km2, isf2, e2 = reblock(km2), reblock(isf2), reblock(e2)
        lm2 = (lpos << jnp.uint32(1)) | isf2.astype(jnp.uint32)
        base = base << jnp.uint32(1)
    else:
        km2, e2 = blk(kmers), blk(emit)
        if stage:
            km2, e2 = jax.lax.optimization_barrier((km2, e2))
        if reblock is not None:
            km2, e2 = reblock(km2), reblock(e2)
        lm2 = lpos
    return _fused_compact_tail(km2, lm2, e2, base, bo=bo)


def _scan_compact_fused_sublane64(sw, vbits, *, k, w, factor1, C, bo,
                                  meta_isf=False, posmajor=False):
    """u64 phase-second-minor fused scan+compact for 16 < k <= 32 — the fusedc
    backend's wide-k path, so the reference's DEFAULT parameters (k=19 w=31,
    modmap.c:314-317, modutils.c:140) and BASELINE config 3 (k=24) ride the
    fused family instead of falling back to onehot_i8.

    Same design as _scan_compact_fused_sublane but the funnel works on
    whole u64 words, so all 32 funnel phases ride ONE axis: layout
    [ipb, 32, BLK], phase r = p mod 32 second-minor (the flatten to
    [nb, BLK] stays a bitcast), word planes are
    [ipb, 1, BLK] broadcasts.  XLA emulates u64 elementwise ops as u32
    pairs, which is exactly what the hand-split u32 front does for k <= 16
    — for 2k > 32 the pair math is irreducible, so there is nothing to
    hand-optimize below this.

    Block row b = ib*32 + r holds positions 32*(ib*BLK + c) + r — a
    stride-32 position group (stripe partition).  posmajor=True re-blocks
    AFTER the staging barrier ([ipb, 32, BLK] -> [ipb, BLK, 32], whose
    flatten is position order) so rows leave in exact stream order.

    Matches seqhash.c:154-196 semantics (hash = (kmer*factor1) >> (64-2k),
    canonical = min(fwd, rc), emit iff hash % w == 0); multiset-identical
    to onehot/onehot_i8 at the same shapes (tests/test_scan_kernel_mxu.py).
    """
    assert 16 < k <= 32
    NW = C // 32
    nb = C // BLK
    ipb = NW // BLK
    tw = derive_tw(sw)
    pa = sw[:NW].reshape(ipb, 1, BLK)
    pb = sw[1:NW + 1].reshape(ipb, 1, BLK)
    za = tw[:NW].reshape(ipb, 1, BLK)
    zb = tw[1:NW + 1].reshape(ipb, 1, BLK)
    r2 = (jax.lax.broadcasted_iota(jnp.uint64, (1, 32, 1), 1)
          * jnp.uint64(2))
    inv = jnp.uint64(64) - r2
    zero = r2 == jnp.uint64(0)
    inv_s = jnp.where(zero, jnp.uint64(1), inv)   # no undefined >>64
    shift1 = jnp.uint64(64 - 2 * k)
    mask2k = jnp.uint64((1 << (2 * k)) - 1)
    kf = jnp.where(zero, pa, (pa << r2) | (pb >> inv_s)) >> shift1
    kr = jnp.where(zero, za, (za >> r2) | (zb << inv_s)) & mask2k
    f1_ = jnp.uint64(factor1)
    hf = (kf * f1_) >> shift1
    hr = (kr * f1_) >> shift1
    isF = hf < hr
    hashes = jnp.where(isF, hf, hr)
    kmers = jnp.where(isF, kf, kr)
    # validity bit r of the u32 half-word i (v32[i] = positions 32i..32i+31)
    v32 = jax.lax.bitcast_convert_type(vbits, jnp.uint32).reshape(
        ipb, 1, BLK)
    bit = jax.lax.broadcasted_iota(jnp.uint32, (1, 32, 1), 1)
    valid = ((v32 >> bit) & jnp.uint32(1)).astype(jnp.bool_)
    emit = valid & mod_is_zero(hashes, w)

    def blk(x):                               # major-dim merge: layout no-op
        return x.reshape(nb, BLK)

    if posmajor:
        # stream-order re-block after the barrier: [ipb, 32, BLK] ->
        # [ipb, BLK, 32], flat index 32*(ib*BLK + c) + r == position
        def reblock(x):
            return (x.reshape(ipb, 32, BLK).transpose(0, 2, 1)
                    .reshape(nb, BLK))

        lpos = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1)
        base = jax.lax.broadcasted_iota(jnp.uint32, (nb, 1), 0) \
            * jnp.uint32(BLK)
    else:
        reblock = None
        lpos = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1) \
            * jnp.uint32(32)
        brow = jax.lax.broadcasted_iota(jnp.uint32, (nb, 1), 0)
        base = ((brow >> jnp.uint32(5)) * jnp.uint32(32 * BLK)
                + (brow & jnp.uint32(31)))
    stage = os.environ.get("MODIMIZER_FUSED_STAGE", "1") != "0"
    if meta_isf:
        km2, isf2, e2 = blk(kmers), blk(isF), blk(emit)
        if stage:
            km2, isf2, e2 = jax.lax.optimization_barrier((km2, isf2, e2))
        if reblock is not None:
            km2, isf2, e2 = reblock(km2), reblock(isf2), reblock(e2)
        lm2 = (lpos << jnp.uint32(1)) | isf2.astype(jnp.uint32)
        base = base << jnp.uint32(1)
    else:
        km2, e2 = blk(kmers), blk(emit)
        if stage:
            km2, e2 = jax.lax.optimization_barrier((km2, e2))
        if reblock is not None:
            km2, e2 = reblock(km2), reblock(e2)
        lm2 = lpos
    return _fused_compact_tail_u64(km2, lm2, e2, base, bo=bo, k=k)


def _fused_compact_tail_u64(km2, lm2, e2, base, *, bo, k):
    """One-hot compaction tail for u64 kmers (16 < k <= 32): the virtual
    V = (kmer << 16 | meta) value is 2k+16 <= 80 bits, carried as
    ceil((2k+16)/8) biased int8 limb planes (7 for k=19, 8 for k=24, 10
    for k=31/32 — the same exact-by-construction scheme as the k <= 16
    tail).  Same contract as _fused_compact_tail."""
    nb = km2.shape[0]
    ut = (jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 0)
          <= jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 1)
          ).astype(jnp.int8)
    csum = jax.lax.dot_general(e2.astype(jnp.int8), ut,
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    dest = jnp.where(e2, csum - 1, -1)
    slots = jax.lax.broadcasted_iota(jnp.int32, (nb, bo, BLK), 1)
    onehot = (dest[:, None, :] == slots).astype(jnp.int8)
    cnts = csum[:, -1]
    live = jax.lax.broadcasted_iota(jnp.int32, (nb, bo), 1) < cnts[:, None]
    nbits = 2 * k + 16
    nl = -(-nbits // 8)
    vlo = (km2 << jnp.uint64(16)) | lm2.astype(jnp.uint64)   # V bits 0..63
    vhi = (km2 >> jnp.uint64(48)).astype(jnp.uint32)         # V bits 64..79
    # limb c = bits [8c, 8c+8) of V, via a c3-dependent shift (elementwise
    # u64 shift by a broadcast amount — one fused expression, no stacks)
    c3 = jax.lax.broadcasted_iota(jnp.uint32, (nb, nl, BLK), 1)
    lo_sh = (jnp.minimum(c3, jnp.uint32(7)) * jnp.uint32(8)).astype(
        jnp.uint64)
    val = jnp.where(c3 < jnp.uint32(8),
                    ((vlo[:, None, :] >> lo_sh)
                     & jnp.uint64(0xFF)).astype(jnp.uint32),
                    (vhi[:, None, :]
                     >> ((c3 - jnp.uint32(8)) * jnp.uint32(8)))
                    & jnp.uint32(0xFF))
    cols = (val.astype(jnp.int32) - 128).astype(jnp.int8)
    out = jax.lax.dot_general(cols, onehot,
                              (((2,), (2,)), ((0,), (0,))),
                              preferred_element_type=jnp.int32)
    o = jnp.where(live[:, None, :], out + 128, 0).astype(jnp.uint32)
    olo = o[:, 0].astype(jnp.uint64)
    for c in range(1, min(nl, 8)):
        olo = olo | (o[:, c].astype(jnp.uint64) << jnp.uint64(8 * c))
    ohi = jnp.zeros((nb, bo), jnp.uint64)
    for c in range(8, nl):
        ohi = ohi | (o[:, c].astype(jnp.uint64) << jnp.uint64(8 * (c - 8)))
    okmer = (olo >> jnp.uint64(16)) | (ohi << jnp.uint64(48))
    olm = (olo & jnp.uint64(0xFFFF)).astype(jnp.uint32)
    out_k = jnp.where(live, okmer, U64_SENTINEL).reshape(-1)
    out_p = jnp.where(live, base + olm,
                      jnp.uint32(0xFFFFFFFF)).reshape(-1)
    n_emit = jnp.sum(cnts).astype(jnp.int64)
    return out_k, out_p, n_emit, jnp.any(cnts > bo)


def _scan_compact_fused_pm(sw, vbits, *, k, w, factor1, C, bo,
                           meta_isf=False, posmajor=False):
    """Phase-major fused scan+compact (backend "fusedd"): the plain
    [32, NW] scan front glued straight onto the fused one-hot tail; it
    materializes only its (kmer, emit) planes, where the phase-second-minor
    fronts (fusedc) also materialize word-plane broadcasts.

    Blocks are the [32, NW] rows split into BLK-lane runs: block
    b = r * ipb + jb holds positions 32 (jb BLK + c) + r, c = 0..BLK-1 —
    a stride-32 position group (stripe class; consumers are order-free
    and rows carry true positions).  posmajor=True re-blocks to exact
    stream order with one explicit transpose AFTER the staging barrier,
    like the other fused backends.

    k <= 16 rides the hand-split u32 front + 6-limb tail; 16 < k <= 32
    the u64 funnel front + the (2k+16)-bit limb tail (any w via u64
    Lemire).  Matches seqhash.c:154-196 modimizer semantics; multiset-
    identical to every other backend (tests/test_scan_kernel_mxu.py)."""
    NW = C // 32
    nb = C // BLK
    ipb = NW // BLK
    wide = k > 16
    if wide:
        # u32-pair front: no u64 tensors anywhere (XLA's u64 emulation
        # pairs would materialize in the 32-row stack)
        kmh, kml, hh, hl, isF = _scan_front_u32pair(sw, k=k,
                                                    factor1=factor1, C=C)
        emit = _expand_valid(vbits, C) & _pair_mod_is_zero(hh, hl, w)
        planes = (kmh, kml)
    else:
        hashes, kmers, _pos, isF = _scan_front_u32(sw, k=k,
                                                   factor1=factor1, C=C)
        emit = _expand_valid(vbits, C) & mod_is_zero(hashes, w)
        planes = (kmers,)

    def blk(x):                     # row split: minor-dim split, layout no-op
        return x.reshape(nb, BLK)

    if posmajor:
        # stream-order re-block after the barrier: [32, NW] -> [NW, 32],
        # flat index 32 i + r == position
        def reblock(x):
            return x.reshape(32, NW).T.reshape(nb, BLK)

        lpos = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1)
        base = jax.lax.broadcasted_iota(jnp.uint32, (nb, 1), 0) \
            * jnp.uint32(BLK)
    else:
        reblock = None
        lpos = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1) \
            * jnp.uint32(32)
        brow = jax.lax.broadcasted_iota(jnp.uint32, (nb, 1), 0)
        base = ((brow % jnp.uint32(ipb)) * jnp.uint32(32 * BLK)
                + brow // jnp.uint32(ipb))
    stage = os.environ.get("MODIMIZER_FUSED_STAGE", "1") != "0"
    staged = tuple(blk(p) for p in planes) + (blk(emit),)
    if meta_isf:
        staged = staged + (blk(isF),)
    if stage:
        staged = jax.lax.optimization_barrier(staged)
    if reblock is not None:
        staged = tuple(reblock(x) for x in staged)
    e2 = staged[len(planes)]
    if meta_isf:
        lm2 = (lpos << jnp.uint32(1)) | staged[-1].astype(jnp.uint32)
        base = base << jnp.uint32(1)
    else:
        lm2 = lpos
    if wide:
        return _fused_compact_tail_u64pair(staged[0], staged[1], lm2, e2,
                                           base, bo=bo, k=k)
    return _fused_compact_tail(staged[0], lm2, e2, base, bo=bo)


def _mulhi32(a, b_const):
    """Bits 32..63 of a * b for u32 a and a compile-time u32 constant, via
    16-bit partial products (cf. _hash32_hi, which fuses the +lo32(a*Fh)
    term; this is the bare mulhi for the pair-math paths)."""
    b0 = jnp.uint32(b_const & 0xFFFF)
    b1 = jnp.uint32(b_const >> 16)
    a0 = a & jnp.uint32(0xFFFF)
    a1 = a >> jnp.uint32(16)
    c = a1 * b0 + ((a0 * b0) >> jnp.uint32(16))
    d = a0 * b1
    carry = ((c >> jnp.uint32(16)) + (d >> jnp.uint32(16))
             + (((c & jnp.uint32(0xFFFF)) + (d & jnp.uint32(0xFFFF)))
                >> jnp.uint32(16)))
    return a1 * b1 + carry


def _pair_mul64(ah, al, m_const):
    """(ah, al) * m mod 2^64 for a u32 pair and a 64-bit constant, as a
    u32 pair: lo = mullo(al, Ml); hi = mulhi(al, Ml) + al*Mh + ah*Ml."""
    Ml = m_const & 0xFFFFFFFF
    Mh = (m_const >> 32) & 0xFFFFFFFF
    lo = al * jnp.uint32(Ml)
    hi = _mulhi32(al, Ml) + al * jnp.uint32(Mh) + ah * jnp.uint32(Ml)
    return hi, lo


def _pair_mod_is_zero(hh, hl, w):
    """mod_is_zero for a u64 hash carried as a u32 pair — same Lemire-Kaser
    test as ops/packed.mod_is_zero's u64 branch, with the multiply, rotate,
    and compare all in u32 pair math (no u64 tensors)."""
    from ..ops.packed import _inv_odd, _is_pow2
    if _is_pow2(w):
        if w <= (1 << 32):
            return (hl & jnp.uint32(w - 1)) == jnp.uint32(0)
        return ((hl == jnp.uint32(0))
                & ((hh & jnp.uint32((w >> 32) - 1)) == jnp.uint32(0)))
    t = (w & -w).bit_length() - 1
    ph, plo = _pair_mul64(hh, hl, _inv_odd(w >> t, 64))
    if t:  # ror64 by t (1..63) on the pair
        if t < 32:
            s, inv = jnp.uint32(t), jnp.uint32(32 - t)
            ph, plo = ((ph >> s) | (plo << inv), (plo >> s) | (ph << inv))
        elif t == 32:
            ph, plo = plo, ph
        else:
            s, inv = jnp.uint32(t - 32), jnp.uint32(64 - t)
            ph, plo = ((plo >> s) | (ph << inv), (ph >> s) | (plo << inv))
    lim = ((1 << 64) - 1) // w
    Lh, Ll = jnp.uint32(lim >> 32), jnp.uint32(lim & 0xFFFFFFFF)
    return (ph < Lh) | ((ph == Lh) & (plo <= Ll))


def _scan_front_u32pair(sw, *, k, factor1, C):
    """Phase-major scan front for 16 < k <= 32 with every tensor a u32
    pair — bit-exact to _scan_front, no u64 arrays anywhere (XLA's u64
    emulation materializes its hi/lo pairs at unfortunate layouts in the
    32-row stack; hand-split pairs keep everything in the same fused u32
    loops that make the k <= 16 phase-major front fast).

    Returns (kmh, kml, emit_hash_hi, emit_hash_lo, isF) — canonical kmer
    pair, canonical hash pair, strand flag — all [32, NW]."""
    assert 16 < k <= 32
    NW = C // 32
    tw = derive_tw(sw)
    sA = (sw >> jnp.uint64(32)).astype(jnp.uint32)
    sB = sw.astype(jnp.uint32)
    tA = (tw >> jnp.uint64(32)).astype(jnp.uint32)
    tB = tw.astype(jnp.uint32)
    A0, B0, A1, B1 = sA[:NW], sB[:NW], sA[1:NW + 1], sB[1:NW + 1]
    At0, Bt0, At1, Bt1 = tA[:NW], tB[:NW], tA[1:NW + 1], tB[1:NW + 1]
    shift1 = 64 - 2 * k                       # in [0, 30] for k > 16
    s1 = jnp.uint32(shift1)
    inv1 = jnp.uint32(32 - shift1)
    kh_rows, kl_rows, rh_rows, rl_rows = [], [], [], []
    for r in range(32):
        # forward funnel pair f = w0s << 2r | w1s >> (64-2r)
        if r == 0:
            fh, fl = A0, B0
        elif r < 16:
            s, i32 = jnp.uint32(2 * r), jnp.uint32(32 - 2 * r)
            fh = (A0 << s) | (B0 >> i32)
            fl = (B0 << s) | (A1 >> i32)
        elif r == 16:
            fh, fl = B0, A1
        else:
            s, i32 = jnp.uint32(2 * r - 32), jnp.uint32(64 - 2 * r)
            fh = (B0 << s) | (A1 >> i32)
            fl = (A1 << s) | (B1 >> i32)
        # rc funnel pair g = w0t >> 2r | w1t << (64-2r)
        if r == 0:
            gh, gl = At0, Bt0
        elif r < 16:
            s, i32 = jnp.uint32(2 * r), jnp.uint32(32 - 2 * r)
            gl = (Bt0 >> s) | (At0 << i32)
            gh = (At0 >> s) | (Bt1 << i32)
        elif r == 16:
            gh, gl = Bt1, At0
        else:
            s, i32 = jnp.uint32(2 * r - 32), jnp.uint32(64 - 2 * r)
            gl = (At0 >> s) | (Bt1 << i32)
            gh = (Bt1 >> s) | (At1 << i32)
        # kf = f >> shift1, kr = g & mask2k
        if shift1 == 0:
            kh_rows.append(fh)
            kl_rows.append(fl)
        else:
            kh_rows.append(fh >> s1)
            kl_rows.append((fl >> s1) | (fh << inv1))
        rh_rows.append(gh & jnp.uint32((1 << (2 * k - 32)) - 1)
                       if k < 32 else gh)
        rl_rows.append(gl)
    kfh = jnp.stack(kh_rows, axis=0)
    kfl = jnp.stack(kl_rows, axis=0)
    krh = jnp.stack(rh_rows, axis=0)
    krl = jnp.stack(rl_rows, axis=0)
    # hash = (kmer * factor1) mod 2^64 >> shift1, per strand, pair math
    def hash_pair(ah, al):
        qh, ql = _pair_mul64(ah, al, factor1)
        if shift1 == 0:
            return qh, ql
        return qh >> s1, (ql >> s1) | (qh << inv1)
    hfh, hfl = hash_pair(kfh, kfl)
    hrh, hrl = hash_pair(krh, krl)
    isF = (hfh < hrh) | ((hfh == hrh) & (hfl < hrl))
    hh = jnp.where(isF, hfh, hrh)
    hl = jnp.where(isF, hfl, hrl)
    kmh = jnp.where(isF, kfh, krh)
    kml = jnp.where(isF, kfl, krl)
    return kmh, kml, hh, hl, isF


def _fused_compact_tail_u64pair(kmh, kml, lm2, e2, base, *, bo, k):
    """The u64 fused tail (_fused_compact_tail_u64) with the kmer carried
    as a u32 pair end to end: limb planes come from three u32 words
    (V = kmer << 16 | meta, 2k+16 <= 80 bits), the dot is unchanged, and
    reassembly rebuilds u32 words — u64 appears only in the final
    [nb, bo] outputs (sentinel contract)."""
    nb = kmh.shape[0]
    ut = (jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 0)
          <= jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 1)
          ).astype(jnp.int8)
    csum = jax.lax.dot_general(e2.astype(jnp.int8), ut,
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    dest = jnp.where(e2, csum - 1, -1)
    slots = jax.lax.broadcasted_iota(jnp.int32, (nb, bo, BLK), 1)
    onehot = (dest[:, None, :] == slots).astype(jnp.int8)
    cnts = csum[:, -1]
    live = jax.lax.broadcasted_iota(jnp.int32, (nb, bo), 1) < cnts[:, None]
    nbits = 2 * k + 16
    nl = -(-nbits // 8)
    # V's three u32 words: v0 = bits 0..31, v1 = 32..63, v2 = 64..79
    v0 = (kml << jnp.uint32(16)) | lm2
    v1 = (kml >> jnp.uint32(16)) | (kmh << jnp.uint32(16))
    v2 = kmh >> jnp.uint32(16)
    c3 = jax.lax.broadcasted_iota(jnp.uint32, (nb, nl, BLK), 1)
    word = jnp.where(c3 < jnp.uint32(4), v0[:, None, :],
                     jnp.where(c3 < jnp.uint32(8), v1[:, None, :],
                               v2[:, None, :]))
    val = (word >> ((c3 & jnp.uint32(3)) * jnp.uint32(8))) & jnp.uint32(0xFF)
    cols = (val.astype(jnp.int32) - 128).astype(jnp.int8)
    out = jax.lax.dot_general(cols, onehot,
                              (((2,), (2,)), ((0,), (0,))),
                              preferred_element_type=jnp.int32)
    o = jnp.where(live[:, None, :], out + 128, 0).astype(jnp.uint32)
    def word_of(c0):
        w_ = o[:, c0]
        for c in range(c0 + 1, min(c0 + 4, nl)):
            w_ = w_ | (o[:, c] << jnp.uint32(8 * (c - c0)))
        return w_
    o0, o1 = word_of(0), word_of(4)
    o2 = word_of(8) if nl > 8 else jnp.zeros((nb, bo), jnp.uint32)
    okl = (o0 >> jnp.uint32(16)) | (o1 << jnp.uint32(16))
    okh = (o1 >> jnp.uint32(16)) | (o2 << jnp.uint32(16))
    olm = o0 & jnp.uint32(0xFFFF)
    okmer = (okh.astype(jnp.uint64) << jnp.uint64(32)) | okl.astype(
        jnp.uint64)
    out_k = jnp.where(live, okmer, U64_SENTINEL).reshape(-1)
    out_p = jnp.where(live, base + olm,
                      jnp.uint32(0xFFFFFFFF)).reshape(-1)
    n_emit = jnp.sum(cnts).astype(jnp.int64)
    return out_k, out_p, n_emit, jnp.any(cnts > bo)


def _expand_valid(vbits, C):
    """[32, NW] validity mask from the packed little-endian bit words:
    vb32[i] holds the bits of positions 32i..32i+31."""
    NW = C // 32
    vlo = (vbits & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    vhi = (vbits >> jnp.uint64(32)).astype(jnp.uint32)
    vb32 = jnp.stack([vlo, vhi], axis=1).reshape(-1)   # [NW]
    rows = jax.lax.broadcasted_iota(jnp.uint32, (32, NW), 0)
    return ((vb32[None, :] >> rows) & jnp.uint32(1)).astype(jnp.bool_)


# Compaction backend when MODIMIZER_COMPACT is unset: "gather" (rank +
# gather, no one-hot cube) won the H100 A/B against "fusedd" and
# "onehot_i8" at every measured shape (docs/PERF.md).
COMPACT_DEFAULT = "gather"


def compact_backend_default():
    """Compaction backend policy: MODIMIZER_COMPACT, read at trace time,
    or COMPACT_DEFAULT.  All backends are bit-identical (rows, or the
    (pos, kmer) multiset on the order-free stripe path;
    tests/test_scan_kernel_mxu.py).  "fusedd" handles
    both block layouts and all k <= 32 (u32 front for k <= 16, u64 funnel
    above); it falls back to "fused" only where its gate fails — no
    packed validity words (vbits is None), block-local meta overflowing
    the 2-limb/16-bit budget (huge BLK and/or meta_isf), C not a positive
    multiple of 32*BLK, or k <= 16 with w >= 2^32 — and further to
    "onehot_i8" for the shapes "fused" cannot take."""
    return os.environ.get("MODIMIZER_COMPACT") or COMPACT_DEFAULT


def _stage_fronts(kmers, pos, emit, k):
    """Split the scan front's outputs into u32 planes and pin them behind an
    optimization barrier.  Without this, XLA fuses the 32-phase u64 funnel
    front into EVERY 8-bit limb plane of the compaction cols (8-9 full
    recomputes); one forced materialization is far cheaper."""
    if kmers.dtype == jnp.uint32:       # u32 front (k <= 16)
        klo, khi = kmers, None
    else:
        klo = (kmers & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        khi = (kmers >> jnp.uint64(32)).astype(jnp.uint32)
    if k > 16:
        klo, khi, pos, emit = jax.lax.optimization_barrier(
            (klo, khi, pos, emit))
    else:
        klo, pos, emit = jax.lax.optimization_barrier((klo, pos, emit))
        khi = jnp.zeros_like(klo)
    return klo, khi, pos, emit


def _limb_cols(klo, khi, pos, k, nb, blk):
    """8-bit limb planes of (kmer, pos) as a list of u32 [nb, blk] arrays,
    most-significant first (khi limbs drop out for k <= 16)."""
    n_khi = (2 * k - 32 + 7) // 8 if k > 16 else 0
    limbs = [(khi >> jnp.uint32(8 * i)) & jnp.uint32(0xFF)
             for i in reversed(range(n_khi))]
    limbs += [(v >> jnp.uint32(sh_)) & jnp.uint32(0xFF)
              for v in (klo, pos) for sh_ in (24, 16, 8, 0)]
    return [x.reshape(nb, blk) for x in limbs], n_khi


def _assemble_rows(o, live, n_khi, nb, bo):
    """Rebuild (kmer u64, pos u32) from compacted limb planes o [nb, bo, nc]
    (u32 values 0..255), sentinel the dead slots."""
    def u32_of(i, nl=4):
        v = o[:, :, i]
        for t in range(1, nl):
            v = (v << 8) | o[:, :, i + t]
        return v

    okhi = u32_of(0, n_khi) if n_khi else jnp.zeros_like(o[:, :, 0])
    okmer = _join64(okhi, u32_of(n_khi))
    opos = u32_of(n_khi + 4)
    out_k = jnp.where(live, okmer, U64_SENTINEL).reshape(-1)
    out_p = jnp.where(live, opos, jnp.uint32(0xFFFFFFFF)).reshape(-1)
    return out_k, out_p


def _compact_blocks_onehot(kmers, pos, emit, *, k, C, bo, int8=False):
    """Single-level one-hot compaction: per BLK-position block, a matmul
    cumsum (emit-row @ triangular ones) drives a
    [nb, bo, BLK] one-hot that gathers the 8-bit limbs of (kmer, pos).

    int8=True swaps the bf16 operands for int8 with s32 accumulation —
    exact because limbs ride biased (limb - 128 fits int8; each live output
    slot receives exactly one contribution, so adding 128*live afterwards
    restores the value) — and halves the one-hot cube's bytes."""
    nb = C // BLK
    klo, khi, pos, emit = _stage_fronts(kmers, pos, emit, k)
    limbs, n_khi = _limb_cols(klo, khi, pos, k, nb, BLK)
    e2 = emit.reshape(nb, BLK)
    if int8:
        op_t, acc_t = jnp.int8, jnp.int32
        cols = jnp.stack([x.astype(jnp.int32) - 128 for x in limbs],
                         axis=2).astype(jnp.int8)
    else:
        op_t, acc_t = jnp.bfloat16, jnp.float32
        cols = jnp.stack(limbs, axis=2).astype(jnp.bfloat16)
    # cumsum as a matmul: emit-row @ upper-triangular ones (counts <= BLK
    # are exact in both the f32 and s32 accumulators).
    ut = (jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 0)
          <= jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 1)
          ).astype(op_t)
    csum = jax.lax.dot_general(e2.astype(op_t), ut,
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=acc_t)
    csum = csum.astype(jnp.int32) if not int8 else csum
    dest = jnp.where(e2, csum - 1, -1)
    slots = jax.lax.broadcasted_iota(jnp.int32, (nb, bo, BLK), 1)
    onehot = (dest[:, None, :] == slots).astype(op_t)
    out = jax.lax.dot_general(onehot, cols,
                              (((2,), (1,)), ((0,), (0,))),
                              preferred_element_type=acc_t)
    cnts = csum[:, -1].astype(jnp.int32)
    live = jax.lax.broadcasted_iota(jnp.int32, (nb, bo), 1) < cnts[:, None]
    if int8:
        o = jnp.where(live[:, :, None], out + 128, 0).astype(jnp.uint32)
    else:
        o = out.astype(jnp.uint32)
    out_k, out_p = _assemble_rows(o, live, n_khi, nb, bo)
    n_emit = jnp.sum(emit).astype(jnp.int64)
    return out_k, out_p, n_emit, jnp.any(cnts > bo)


B1 = 128  # level-1 sub-block positions


def twolevel_b1(bo: int) -> int:
    """Level-1 slots per B1-position sub-block, derived from the block
    capacity bo so widen-and-replay grows both levels together (floor 32);
    at bo/4 the margin over the Binomial(B1, 1/w)
    mean is always wider than bo's own 6-sigma rule."""
    return int(min(B1, max(32, -(-bo // 4 // 32) * 32)))


def _block_csum(e2, nb):
    """Inclusive in-block cumsum of the emit mask as a matmul (emit-row @
    upper-triangular ones; counts <= BLK are exact in the f32 accumulator)."""
    ut = (jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 0)
          <= jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 1)
          ).astype(jnp.bfloat16)
    return jax.lax.dot_general(e2.astype(jnp.bfloat16), ut,
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32
                               ).astype(jnp.int32)           # [nb, BLK]


def _grab_rows(klo, khi, pos, idx, live, *, k, nb, bo):
    """Gather the u32 planes at per-slot in-block indices idx [nb, bo] and
    sentinel the dead slots — the cube-free backends' common tail."""
    def grab(plane):
        return jnp.take_along_axis(plane.reshape(nb, BLK), idx, axis=1)

    okmer = _join64(grab(khi) if k > 16 else jnp.zeros((nb, bo), jnp.uint32),
                    grab(klo))
    opos = grab(pos)
    out_k = jnp.where(live, okmer, U64_SENTINEL).reshape(-1)
    out_p = jnp.where(live, opos, jnp.uint32(0xFFFFFFFF)).reshape(-1)
    return out_k, out_p


def _rank_bs(csum, bo):
    """In-block index of the j-th emit (j = 0..bo-1) by binary search on
    the inclusive cumsum: smallest p with csum[p] >= j+1 (emits have
    csum[p] == csum[p-1]+1 so the hit is exact).  Returns (target, idx);
    dead slots (target > block count) settle at BLK-1."""
    nb = csum.shape[0]
    target = jax.lax.broadcasted_iota(jnp.int32, (nb, bo), 1) + 1
    lo = jnp.zeros((nb, bo), jnp.int32)
    hi = jnp.full((nb, bo), BLK - 1, jnp.int32)
    for _ in range(BLK.bit_length() - 1):          # 10 rounds for BLK 1024
        mid = (lo + hi) >> 1
        cm = jnp.take_along_axis(csum, mid, axis=1)
        ge = cm >= target
        hi = jnp.where(ge, mid, hi)
        lo = jnp.where(ge, lo, mid + 1)
    return target, hi


def _rank_cmp(csum, bo):
    """In-block index of the j-th emit by fused compare-reduce:
    idx = |{p : csum[p] < j+1}| — a broadcast compare over [nb, bo, BLK]
    that XLA fuses into the reduction (nothing cube-sized is written).  Same contract as _rank_bs."""
    nb = csum.shape[0]
    target = jax.lax.broadcasted_iota(jnp.int32, (nb, bo), 1) + 1
    idx = jnp.sum((csum[:, None, :] < target[:, :, None]).astype(jnp.int32),
                  axis=2)
    return target, jnp.minimum(idx, BLK - 1)   # dead slots clamp


def _compact_blocks_gather(kmers, pos, emit, *, k, C, bo, cmp_rank=False):
    """Cube-free compaction: instead of materializing the C*bo one-hot
    cube (the step's dominant HBM traffic), rank emits in-block (binary
    search on the cumsum, or compare-reduce with cmp_rank — the
    'searchcmp' backend name) and gather the u32 planes directly.  Bit-
    identical rows/slots/sentinels to the one-hot backends."""
    nb = C // BLK
    klo, khi, pos, emit = _stage_fronts(kmers, pos, emit, k)
    e2 = emit.reshape(nb, BLK)
    csum = _block_csum(e2, nb)
    cnts = csum[:, -1]
    target, idx = (_rank_cmp if cmp_rank else _rank_bs)(csum, bo)
    live = target <= cnts[:, None]
    out_k, out_p = _grab_rows(klo, khi, pos, idx, live, k=k, nb=nb, bo=bo)
    n_emit = jnp.sum(emit).astype(jnp.int64)
    return out_k, out_p, n_emit, jnp.any(cnts > bo)


def _compact_blocks_posgather(sw, emit, *, k, factor1, C, bo, posmajor,
                              meta_isf, cmp_rank=False):
    """Sparse-rematerializing compaction: the scan front materializes ONLY
    the emit bitmask (1 B/position) — no kmer/pos/isF planes (16 B/position
    in every other backend) and no one-hot cube.  After ranking emits
    in-block, the k-mer at each emitted position is re-derived from the
    packed stream words themselves: 2 u64 gathers into sw (4 MB,
    cache-resident) + the same funnel shift as the front, the RC k-mer by
    2-bit-group reversal + complement (revcomp(x) == ~grev64(x << (64-2k))
    & mask), and both hashes recomputed on the [nb, bo] emit set (~1/w of
    positions).  Bit-identical to the one-hot backends by construction:
    the funnel/hash math is the front's own (seqhash.h:58 semantics).

    `posmajor` tells how block-flat indices map to stream positions
    (contiguous blocks vs the phase-major stride-32 layout)."""
    nb = C // BLK
    NW = C // 32
    emit = jax.lax.optimization_barrier(emit)
    e2 = emit.reshape(nb, BLK)
    csum = _block_csum(e2, nb)
    cnts = csum[:, -1]
    target, idx = (_rank_cmp if cmp_rank else _rank_bs)(csum, bo)
    live = target <= cnts[:, None]
    f = (jax.lax.broadcasted_iota(jnp.int32, (nb, bo), 0) * BLK + idx)
    if posmajor:
        gpos = f                                   # flat index IS position
    else:
        gpos = 32 * (f % NW) + f // NW             # [32, NW] phase-major
    i = gpos >> 5
    w0 = sw[i]
    w1 = sw[i + 1]
    sh = (jnp.uint64(2) * (gpos & 31).astype(jnp.uint64))
    sh_s = jnp.maximum(sh, jnp.uint64(1))          # no undefined >>64
    hs = jnp.where(sh == 0, w0,
                   (w0 << sh) | (w1 >> (jnp.uint64(64) - sh_s)))
    shift1 = jnp.uint64(64 - 2 * k)
    mask2k = jnp.uint64((1 << (2 * k)) - 1)
    h = hs >> shift1
    hrc = (~grev64(h << shift1)) & mask2k
    f1_ = jnp.uint64(factor1)
    hf = (h * f1_) >> shift1
    hr = (hrc * f1_) >> shift1
    isF = hf < hr
    okmer = jnp.where(isF, h, hrc)
    gp32 = gpos.astype(jnp.uint32)
    if meta_isf:
        gp32 = (gp32 << jnp.uint32(1)) | isF.astype(jnp.uint32)
    out_k = jnp.where(live, okmer, U64_SENTINEL).reshape(-1)
    out_p = jnp.where(live, gp32, jnp.uint32(0xFFFFFFFF)).reshape(-1)
    n_emit = jnp.sum(emit).astype(jnp.int64)
    return out_k, out_p, n_emit, jnp.any(cnts > bo)


def _compact_blocks_twolevel(kmers, pos, emit, *, k, C, bo, int8=True):
    """Two-level int8 one-hot compaction.

    The single-level one-hot cube is C*bo operand elements; almost all of
    the scan step's time is XLA materializing it to HBM.  Compacting each
    B1=128-position sub-block into b1=32 slots first (cube C*b1), then
    concatenating the G=BLK/B1 survivor groups of a block with a second
    one-hot over only G*b1 source slots (cube C*(bo*G*b1/BLK)) cuts the
    cube bytes ~4x at w=16 on top of int8's 2x vs bf16.

    Output is bit-identical to the single-level backends: an element's
    level-2 destination off[g] + j equals its in-block emit rank, so rows,
    slots, sentinels and overflow semantics all match (level-1 overflow is
    OR-ed into the flag; the caller's widen doubles bo and thus b1)."""
    b1 = twolevel_b1(bo)
    G = BLK // B1
    nb = C // BLK
    ns = C // B1
    klo, khi, pos, emit = _stage_fronts(kmers, pos, emit, k)
    limbs, n_khi = _limb_cols(klo, khi, pos, k, ns, B1)
    ncols = len(limbs)
    if int8:
        op_t, acc_t = jnp.int8, jnp.int32
        cols1 = jnp.stack([x.astype(jnp.int32) - 128 for x in limbs],
                          axis=2).astype(jnp.int8)        # [ns, B1, ncols]
    else:
        op_t, acc_t = jnp.bfloat16, jnp.float32
        cols1 = jnp.stack(limbs, axis=2).astype(jnp.bfloat16)
    e1 = emit.reshape(ns, B1)
    ut1 = (jax.lax.broadcasted_iota(jnp.int32, (B1, B1), 0)
           <= jax.lax.broadcasted_iota(jnp.int32, (B1, B1), 1)
           ).astype(op_t)
    csum1 = jax.lax.dot_general(e1.astype(op_t), ut1,
                                (((1,), (0,)), ((), ())),
                                preferred_element_type=acc_t
                                ).astype(jnp.int32)
    dest1 = jnp.where(e1, csum1 - 1, -1)
    slots1 = jax.lax.broadcasted_iota(jnp.int32, (ns, b1, B1), 1)
    onehot1 = (dest1[:, None, :] == slots1).astype(op_t)
    out1 = jax.lax.dot_general(onehot1, cols1,
                               (((2,), (1,)), ((0,), (0,))),
                               preferred_element_type=acc_t)
    cnt1 = csum1[:, -1]                                   # [ns]
    live1 = (jax.lax.broadcasted_iota(jnp.int32, (ns, b1), 1)
             < cnt1[:, None])
    ovf1 = jnp.any(cnt1 > b1)

    # level 2: concatenate the G survivor groups of each BLK block.
    # source slot (g, j) lands at off[g] + j, off = exclusive cumsum of cnt1
    cnt1b = cnt1.reshape(nb, G)
    off = jnp.cumsum(cnt1b, axis=1) - cnt1b               # [nb, G]
    dest2 = jnp.where(live1.reshape(nb, G, b1),
                      off[:, :, None]
                      + jax.lax.broadcasted_iota(jnp.int32, (nb, G, b1), 2),
                      -1).reshape(nb, G * b1)
    if int8:
        # out1 values are biased limbs + 128*live; re-bias for the int8
        # ride (dead level-1 slots carry 0 == -128 biased; never land)
        cols2 = jnp.where(live1[:, :, None], out1, -128).astype(jnp.int8)
    else:
        cols2 = out1.astype(jnp.bfloat16)  # limbs 0..255 exact in bf16
    cols2 = cols2.reshape(nb, G * b1, ncols)
    slots2 = jax.lax.broadcasted_iota(jnp.int32, (nb, bo, G * b1), 1)
    onehot2 = (dest2[:, None, :] == slots2).astype(op_t)
    out2 = jax.lax.dot_general(onehot2, cols2,
                               (((2,), (1,)), ((0,), (0,))),
                               preferred_element_type=acc_t)
    cnts = (off[:, -1] + cnt1b[:, -1]).astype(jnp.int32)  # per-block emits
    live = jax.lax.broadcasted_iota(jnp.int32, (nb, bo), 1) < cnts[:, None]
    if int8:
        o = jnp.where(live[:, :, None], out2 + 128, 0).astype(jnp.uint32)
    else:
        o = out2.astype(jnp.uint32)
    out_k, out_p = _assemble_rows(o, live, n_khi, nb, bo)
    n_emit = jnp.sum(emit).astype(jnp.int64)
    return out_k, out_p, n_emit, ovf1 | jnp.any(cnts > bo)


def _scan_compact_core(sw, valid, *, k, w, factor1, C, bo, meta_isf=False,
                       backend=None, posmajor=True, front=None, vbits=None):
    """Single-device scan step with block compaction, phase-major layout.

    All elementwise work runs on [32, NW] arrays (the long axis minor).  A
    compaction block is therefore 512 consecutive *words* at one funnel
    phase — a stride-32 position group, not 512 consecutive positions.
    That is legal because every consumer is order-free: the emitted rows
    carry their true chunk-local position and the builder's compaction
    sorts by (kmer, pos).  Stride-32 blocks also spread bursty emit runs
    across blocks, reducing per-block overflows.

    Per block, the default backends compact emitted rows with a one-hot
    matmul: the 8-bit limbs of (kmer, position) ride as int8 (or bf16)
    columns, exact by construction, and the in-block cumsum that drives
    the one-hot comes from a triangular-ones matmul.  The "gather"
    backends rank emits and gather rows instead; every backend gives the
    same rows.

    bo = output rows per BLK positions (block overflow flagged).  valid is
    the [32, NW] position mask (from _expand_valid or pos-bound logic).
    With meta_isf the pos column carries (pos << 1) | isF instead.  Returns
    (kmers u64 [C/BLK*bo] with sentinel padding, chunk-local pos/meta u32,
    n_emit, overflow)."""
    backend = backend or compact_backend_default()
    # the fused tail carries block-local meta in 2 biased limbs, so it
    # must fit 16 bits: stripe blocks encode lpos = 32 c (max 32 (BLK-1)),
    # posmajor blocks lpos = c, and meta_isf shifts one more bit
    _lm_max = (((BLK - 1) if posmajor else 32 * (BLK - 1))
               << (1 if meta_isf else 0)) | 1
    if backend == "fusedd":
        # phase-major front + fused tail: same gate class as fusedc.
        # k <= 16 rides the u32 phase-major front; wide k delegates to
        # fusedc's u64 path (MODIMIZER_FUSEDD_WIDE=pm forces the
        # phase-major u32-pair front instead).
        if (vbits is not None and _lm_max < (1 << 16) and C >= 32 * BLK
                and C % (32 * BLK) == 0):
            if k <= 16 and w < (1 << 32):
                return _scan_compact_fused_pm(sw, vbits, k=k, w=w,
                                              factor1=factor1, C=C, bo=bo,
                                              meta_isf=meta_isf,
                                              posmajor=posmajor)
            if k > 16:
                if os.environ.get("MODIMIZER_FUSEDD_WIDE") == "pm":
                    return _scan_compact_fused_pm(sw, vbits, k=k, w=w,
                                                  factor1=factor1, C=C,
                                                  bo=bo, meta_isf=meta_isf,
                                                  posmajor=posmajor)
                return _scan_compact_fused_sublane64(sw, vbits, k=k, w=w,
                                                     factor1=factor1, C=C,
                                                     bo=bo,
                                                     meta_isf=meta_isf,
                                                     posmajor=posmajor)
        backend = "fused"
    if backend == "fusedc":
        # phase-second-minor front (stripe partition, or stream-order posmajor
        # via one explicit relayout); needs packed validity words and
        # whole (s, par) rows per block.  k <= 16 rides the hand-split u32
        # front; 16 < k <= 32 the u64 phase front (any w via u64 Lemire).
        if (vbits is not None and _lm_max < (1 << 16) and C >= 32 * BLK
                and C % (32 * BLK) == 0):
            if k <= 16 and w < (1 << 32):
                return _scan_compact_fused_sublane(sw, vbits, k=k, w=w,
                                                   factor1=factor1, C=C,
                                                   bo=bo, meta_isf=meta_isf,
                                                   posmajor=posmajor)
            if k > 16:
                return _scan_compact_fused_sublane64(sw, vbits, k=k, w=w,
                                                     factor1=factor1, C=C,
                                                     bo=bo,
                                                     meta_isf=meta_isf,
                                                     posmajor=posmajor)
        backend = "fused"
    if backend == "fusedb":
        # born-in-block front: stripe partition only (posmajor=False),
        # needs the packed validity words and C >= 32*BLK so blocks tile
        # whole (s, par) rows; otherwise fall through to plain fused
        if (not posmajor and vbits is not None and k <= 16
                and w < (1 << 32) and _lm_max < (1 << 16)
                and C >= 32 * BLK and C % (32 * BLK) == 0):
            return _scan_compact_fused_blocks(sw, vbits, k=k, w=w,
                                              factor1=factor1, C=C, bo=bo,
                                              meta_isf=meta_isf)
        backend = "fused"
    if backend == "fused":
        # fused front is u32-only, and its block-local meta rides 2 limbs
        # (must fit 16 bits; small chunks force the posmajor layout below,
        # so recompute the bound for the layout actually taken)
        _pm = posmajor or C < 32 * BLK
        _lm_max = (((BLK - 1) if _pm else 32 * (BLK - 1))
                   << (1 if meta_isf else 0)) | 1
        if not (k <= 16 and w < (1 << 32) and _lm_max < (1 << 16)):
            backend = "onehot_i8"     # same math, wider-shape fallback
        else:
            # the stripe partition's base math needs whole (s, par) rows
            # per block (ipb = NW//BLK >= 1); for small chunks fall back
            # to the position-major transpose — stream order is always a
            # legal partition for the order-free consumers too
            return _scan_compact_fused(sw, valid, k=k, w=w, factor1=factor1,
                                       C=C, bo=bo, meta_isf=meta_isf,
                                       posmajor=(posmajor or C < 32 * BLK),
                                       vbits=vbits)
    front = front or front_backend_default()
    if k <= 16 and w < (1 << 32) and front == "u32":
        hashes, kmers, pos, isF = _scan_front_u32(sw, k=k, factor1=factor1,
                                                  C=C)
    else:
        hashes, kmers, pos, isF = _scan_front(sw, k=k, factor1=factor1, C=C)
    if meta_isf:
        pos = (pos << jnp.uint32(1)) | isF.astype(jnp.uint32)
    emit = valid & mod_is_zero(hashes, w)
    if backend in ("posgather", "posgather_cmp"):
        # kmers/pos/isF planes are dead code here (XLA DCE drops them):
        # the backend re-derives rows from sw at emitted positions only
        return _compact_blocks_posgather(
            sw, emit.T if posmajor else emit, k=k, factor1=factor1, C=C,
            bo=bo, posmajor=posmajor, meta_isf=meta_isf,
            cmp_rank=backend.endswith("_cmp"))
    if posmajor:
        # position-major before blocking: compaction blocks become
        # contiguous position ranges and in-block one-hot ranks equal emit
        # order, so the dense rows leave the device in EXACT stream order —
        # consumers (scan_kmers table replay, scan_stream) need no
        # reordering.  Order-insensitive consumers (the sharded route,
        # which sorts anyway) skip it.
        kmers, pos, emit = kmers.T, pos.T, emit.T
    if backend not in ("onehot", "onehot_i8", "twolevel", "twolevel_i8",
                       "gather", "searchcmp", "butterfly"):
        raise ValueError(f"unknown compaction backend {backend!r} "
                         "(MODIMIZER_COMPACT)")
    int8 = backend.endswith("_i8")
    if backend.startswith("twolevel") and twolevel_b1(bo) < B1:
        # (when b1 == B1 the level-1 pass is a no-op; degenerate to onehot)
        return _compact_blocks_twolevel(kmers, pos, emit, k=k, C=C, bo=bo,
                                        int8=int8)
    if backend == "gather":
        return _compact_blocks_gather(kmers, pos, emit, k=k, C=C, bo=bo)
    if backend == "searchcmp":
        return _compact_blocks_gather(kmers, pos, emit, k=k, C=C, bo=bo,
                                      cmp_rank=True)
    if backend == "butterfly":
        return _compact_blocks_butterfly(kmers, pos, emit, k=k, C=C, bo=bo)
    return _compact_blocks_onehot(kmers, pos, emit, k=k, C=C, bo=bo,
                                  int8=int8)


def _compact_blocks_butterfly(kmers, pos, emit, *, k, C, bo):
    """Alternative compaction backend: per-block stream compaction by a
    butterfly of conditional rolls (log2(BLK) stages) instead of the one-hot
    matmul.  Correctness: displacements are monotone non-decreasing in
    position, so routing bit-by-bit (ascending) is collision-free, and a
    wrapped roll arrival can never be taken (an element at in-block position
    j has displacement <= j < 2^b).  Output is bit-identical to the one-hot
    backend (same rows, same slots, same sentinels)."""
    nb = C // BLK
    e2 = emit.reshape(nb, BLK)
    # exclusive in-block cumsum as a matmul (counts <= BLK are exact in f32)
    slt = (jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 0)
           < jax.lax.broadcasted_iota(jnp.int32, (BLK, BLK), 1)
           ).astype(jnp.bfloat16)
    csum = jax.lax.dot_general(e2.astype(jnp.bfloat16), slt,
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32
                               ).astype(jnp.uint32)
    iota = jax.lax.broadcasted_iota(jnp.uint32, (nb, BLK), 1)
    move = jnp.where(e2, iota - csum, jnp.uint32(0))
    klo = (kmers & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32).reshape(nb, BLK)
    cols = [klo, pos.reshape(nb, BLK)]
    if k > 16:
        cols.append((kmers >> jnp.uint64(32)).astype(jnp.uint32)
                    .reshape(nb, BLK))
    for b in range(BLK.bit_length() - 1):
        s = 1 << b
        move_sh = jnp.roll(move, -s, axis=1)
        arrive = ((move_sh >> jnp.uint32(b)) & jnp.uint32(1)) == jnp.uint32(1)
        leave = ((move >> jnp.uint32(b)) & jnp.uint32(1)) == jnp.uint32(1)
        cols = [jnp.where(arrive, jnp.roll(c, -s, axis=1), c) for c in cols]
        move = jnp.where(arrive, move_sh - jnp.uint32(s),
                         jnp.where(leave, jnp.uint32(0), move))
    cnts = (csum[:, -1] + e2[:, -1].astype(jnp.uint32)).astype(jnp.int32)
    live = jax.lax.broadcasted_iota(jnp.int32, (nb, bo), 1) < cnts[:, None]
    okhi = cols[2][:, :bo] if k > 16 else jnp.zeros((nb, bo), jnp.uint32)
    okmer = _join64(okhi, cols[0][:, :bo])
    out_k = jnp.where(live, okmer, U64_SENTINEL).reshape(-1)
    out_p = jnp.where(live, cols[1][:, :bo],
                      jnp.uint32(0xFFFFFFFF)).reshape(-1)
    n_emit = jnp.sum(emit).astype(jnp.int64)
    return out_k, out_p, n_emit, jnp.any(cnts > bo)


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "factor1", "C", "bo",
                                    "backend", "front"))
def _scan_compact_local(sw, vbits, *, k, w, factor1, C, bo, backend=None,
                        front=None):
    # builder path: consumers sort downstream, skip the posmajor transpose
    return _scan_compact_core(sw, _expand_valid(vbits, C), k=k, w=w,
                              factor1=factor1, C=C, bo=bo, backend=backend,
                              posmajor=False, front=front, vbits=vbits)


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "factor1", "C", "bo"))
def _scan_compact_local_packed(buf, *, k, w, factor1, C, bo):
    """Single-transfer variant: buf = [sw (C/32+2) | vb (C/64)] u64, so
    the builder ships one host->device buffer per step."""
    NW = C // 32
    sw = buf[:NW + 2]
    vb = buf[NW + 2:NW + 2 + C // 64]
    return _scan_compact_core(sw, _expand_valid(vb, C), k=k, w=w,
                              factor1=factor1, C=C, bo=bo, posmajor=False,
                              vbits=vb)


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "factor1", "cap", "n_shards",
                                    "C", "bo", "mesh"))
def sharded_scan_route(sw, vbits, gpos_base, *, k, w, factor1, cap, n_shards,
                       C, bo, mesh):
    """Multi-device path: scan each device's packed slice, compact emitted
    rows per block (the same compaction step as the n=1 path), then route
    the ~C/w compacted rows to their owner shard with all_to_all over the
    mesh.  Compacting first shrinks the routing sort by ~w/(1+w*bo/BLK)
    (it used to sort all C positions per step — the bulk of the sharded
    path's 2x per-work overhead vs the n=1 fast path).  Returns
    (recv_k, recv_p u64 global positions) of shape [n_shards, n_shards*cap]
    (sentinel-padded), per-shard emit counts and an overflow flag
    (block-compaction or routing-capacity; the caller widens both)."""

    def step(sw_l, vb_l, base_l):
        sw_l, vb_l, base_l = sw_l[0], vb_l[0], base_l[0, 0]
        ck, cp, n_emit, ovf_blk = _scan_compact_core(
            sw_l, _expand_valid(vb_l, C), k=k, w=w, factor1=factor1, C=C,
            bo=bo, posmajor=False)
        live = ck != U64_SENTINEL
        # canonical hash from the compacted kmer (seqhash.h:58) for routing
        hashes = (ck * jnp.uint64(factor1)) >> jnp.uint64(64 - 2 * k)
        gpos = jnp.where(live, base_l + cp.astype(jnp.uint64), POS_INF)
        owner = div_mod_owner(hashes, w, n_shards)

        # sort real rows (key 2*owner) with cap pad rows per owner (2*o+1):
        # pad-to-cap by sorting, then gather group_start + rank — no scatter
        key_real = jnp.where(live, owner * 2, jnp.uint32(2 * n_shards))
        key_pad = (jnp.arange(n_shards * cap, dtype=jnp.uint32) // cap) * 2 + 1
        allk = jnp.concatenate([key_real, key_pad])
        allv = jnp.concatenate([ck, jnp.full(n_shards * cap, U64_SENTINEL,
                                             jnp.uint64)])
        allp = jnp.concatenate([gpos, jnp.full(n_shards * cap, POS_INF,
                                               jnp.uint64)])
        sk, sv, sp = _sort_multi([allk], [allv, allp])
        starts = jnp.searchsorted(sk, jnp.arange(n_shards,
                                                 dtype=jnp.uint32) * 2)
        ends = jnp.searchsorted(sk, jnp.arange(n_shards,
                                               dtype=jnp.uint32) * 2 + 1)
        overflow = ovf_blk | jnp.any((ends - starts) > cap)
        j = jnp.arange(n_shards * cap)
        idx = starts[j // cap] + (j % cap)
        send_k = jnp.take(sv, idx)
        send_p = jnp.take(sp, idx)

        def a2a(x):
            return jax.lax.all_to_all(x.reshape(n_shards, cap), "shard",
                                      split_axis=0, concat_axis=0,
                                      tiled=True).reshape(-1)

        recv_k = a2a(send_k)
        recv_p = a2a(send_p)
        return recv_k[None], recv_p[None], n_emit[None], overflow[None]

    f = jax.shard_map(step, mesh=mesh,
                      in_specs=(P("shard"), P("shard"), P("shard")),
                      out_specs=(P("shard"),) * 4)
    return f(sw, vbits, gpos_base)


def _compact_core(sk, sd, sm, bk, bm, S):
    """Shared compaction math on 1-D arrays: sort (kmer, pos) lex, compact
    heads to the front with one stable sort, reduce depth by cumsum diff."""
    allk = jnp.concatenate([sk, bk])
    alld = jnp.concatenate(
        [sd, jnp.where(bk != U64_SENTINEL, jnp.uint32(1), jnp.uint32(0))])
    allm = jnp.concatenate([sm, bm])
    N = allk.shape[0]
    k_s, m_s, d_s = _sort_multi([allk, allm], [alld])
    live = k_s != U64_SENTINEL
    first = jnp.concatenate([jnp.array([True]),
                             k_s[1:] != k_s[:-1]]) & live
    n_heads = jnp.sum(first.astype(jnp.int32))
    n_live = jnp.sum(live.astype(jnp.int32))
    order = _sort_multi([(~first).astype(jnp.uint8)],
                        [jnp.arange(N, dtype=jnp.int32)],
                        is_stable=True)[1]
    cs = jnp.cumsum(d_s.astype(jnp.uint64))
    j = jnp.arange(N, dtype=jnp.int32)
    p = order
    p_next = jnp.where(j + 1 < n_heads, jnp.roll(order, -1), n_live)
    total = (jnp.take(cs, jnp.maximum(p_next - 1, 0)) - jnp.take(cs, p)
             + jnp.take(d_s, p).astype(jnp.uint64))
    depth = jnp.minimum(total, jnp.uint64(0xFFFF)).astype(jnp.uint32)
    is_head_row = j < n_heads
    new_k = jnp.where(is_head_row[:S], jnp.take(k_s, p[:S]), U64_SENTINEL)
    new_d = jnp.where(is_head_row[:S], depth[:S], jnp.uint32(0))
    new_m = jnp.where(is_head_row[:S], jnp.take(m_s, p[:S]), POS_INF)
    return new_k, new_d, new_m, n_heads, n_heads > S


@functools.partial(jax.jit, static_argnames=("S", "n_recv"))
def compact_local(state_k, state_d, state_m, bases, *recv, S, n_recv):
    """n=1 compaction: fold n_recv (kmers u64, pos u32) batches (each with a
    u64 base offset in `bases`) into the sorted state."""
    ks = [r for r in recv[:n_recv]]
    ps = [r for r in recv[n_recv:]]
    bk = jnp.concatenate(ks)
    bm = jnp.concatenate(
        [p.astype(jnp.uint64) + bases[i] for i, p in enumerate(ps)])
    bm = jnp.where(bk != U64_SENTINEL, bm, POS_INF)
    return _compact_core(state_k[0], state_d[0], state_m[0], bk, bm, S)


@functools.partial(jax.jit, static_argnames=("S", "n_recv", "mesh"))
def compact_sharded(state_k, state_d, state_m, *recv, S, n_recv, mesh):
    """Multi-device compaction: fold n_recv [n, width] u64 (kmer, gpos)
    batches into each shard's sorted state."""

    def step(sk, sd, sm, *rs):
        bk = jnp.concatenate([r[0] for r in rs[:n_recv]])
        bm = jnp.concatenate([r[0] for r in rs[n_recv:]])
        nk, nd, nm, nh, ov = _compact_core(sk[0], sd[0], sm[0], bk, bm, S)
        return nk[None], nd[None], nm[None], nh[None], ov[None]

    f = jax.shard_map(step, mesh=mesh,
                      in_specs=(P("shard"),) * (3 + 2 * n_recv),
                      out_specs=(P("shard"),) * 5)
    return f(state_k, state_d, state_m, *recv)


class ShardedModsetBuilder:
    """Host driver: feeds packed stream chunks to the mesh, accumulates the
    routed batches as device arrays (zero-copy), compacts on memory pressure
    or finalize, and returns the exact first-encounter insertion stream.

    n=1 meshes skip routing and shard_map entirely (plain jit, u32 local
    positions); n>1 routes by hash prefix with all_to_all."""

    # chunk_per_dev: inherited value, not re-swept on the GPU
    def __init__(self, sh, mesh: Mesh, chunk_per_dev=1 << 22,
                 state_size=1 << 20, cap=None, max_state_size=1 << 28,
                 max_buffer_rows=1 << 25, merge_every=None):
        self.sh = sh
        self.mesh = mesh
        self.n = mesh.devices.size
        self.chunk = max(BLK, (chunk_per_dev // BLK) * BLK)
        self.S = state_size
        self.max_S = max_state_size
        self.max_buffer_rows = max_buffer_rows
        # cap = routing slots per (sender, owner) pair.  Hashing balances
        # owners, so the expectation is chunk/(w*n); keep a 4x margin.
        # Without the /n the per-device routing buffer (n*cap rows) and the
        # per-step accumulation (n^2*cap rows) grow superlinearly with the
        # mesh.  Undersizing is safe: overflow triggers widen-and-replay.
        self.cap = cap or int(max(1024,
                                  4 * self.chunk / sh.w / mesh.devices.size))
        if cap and self.n == 1:
            want = cap * BLK // self.chunk
        else:
            # emits per block ~ Binomial(BLK, 1/w): mean + 6 sigma.
            # Stride-32 blocks de-cluster bursts; a rare overflow is
            # caught by the flag and replayed at double bo (exactness
            # preserved, tests/test_sharded.py overflow case).
            import math
            mean = BLK // sh.w
            want = mean + 6 * max(1, math.isqrt(max(0, mean - 1)) + 1)
        self.bo = int(min(BLK, max(8, ((want + 7) // 8) * 8)))
        n, S = self.n, self.S
        self.state_k = jnp.full((n, S), U64_SENTINEL, jnp.uint64)
        self.state_d = jnp.zeros((n, S), jnp.uint32)
        self.state_m = jnp.full((n, S), POS_INF, jnp.uint64)
        self.recv_k = []   # accumulated device arrays
        self.recv_p = []
        self.bases = []    # u64 chunk base per batch (n=1 path)
        self.total_emitted = 0
        self.n_replay = 0   # chunks re-routed after an overflow
        self._pending = []  # (inputs, base, out) awaiting overflow check

    def _fetch(self, x):
        """Materialize a (possibly sharded) array on the host; the
        multi-host subclass overrides this with a process_allgather."""
        return np.asarray(x)

    def _recv_rows(self):
        if self.n == 1:
            return (self.chunk // BLK) * self.bo
        return self.n * self.cap

    def _widen(self):
        self.bo = min(BLK, self.bo * 2)
        if self.n > 1:
            self.cap *= 2

    def _grow(self, new_S):
        if new_S > self.max_S:
            raise RuntimeError("sharded modset state exceeds max_state_size")
        n = self.n
        pad = new_S - self.S
        self.state_k = jnp.concatenate(
            [self.state_k, jnp.full((n, pad), U64_SENTINEL, jnp.uint64)], 1)
        self.state_d = jnp.concatenate(
            [self.state_d, jnp.zeros((n, pad), jnp.uint32)], 1)
        self.state_m = jnp.concatenate(
            [self.state_m, jnp.full((n, pad), POS_INF, jnp.uint64)], 1)
        self.S = new_S

    def _route(self, inputs):
        sh = self.sh
        if self.n == 1:
            if len(inputs) == 1:  # packed single-transfer path
                return _scan_compact_local_packed(
                    inputs[0], k=sh.k, w=sh.w, factor1=sh.factor1,
                    C=self.chunk, bo=self.bo)
            sw, vb, _gpos = inputs
            return _scan_compact_local(sw[0], vb[0], k=sh.k, w=sh.w,
                                       factor1=sh.factor1, C=self.chunk,
                                       bo=self.bo)
        return sharded_scan_route(
            *inputs, k=sh.k, w=sh.w, factor1=sh.factor1,
            cap=self.cap, n_shards=self.n, C=self.chunk, bo=self.bo,
            mesh=self.mesh)

    def _append(self, out, base):
        self.recv_k.append(out[0])
        self.recv_p.append(out[1])
        self.bases.append(base)

    def _buffered_rows(self):
        return len(self.recv_k) * self._recv_rows()

    def _compact(self):
        self._check_pending(force=True)
        if not self.recv_k:
            return
        while True:
            if self.n == 1:
                bases = jnp.asarray(np.array(self.bases, np.uint64))
                out = compact_local(self.state_k, self.state_d, self.state_m,
                                    bases, *(self.recv_k + self.recv_p),
                                    S=self.S, n_recv=len(self.recv_k))
            else:
                out = compact_sharded(self.state_k, self.state_d,
                                      self.state_m,
                                      *(self.recv_k + self.recv_p),
                                      S=self.S, n_recv=len(self.recv_k),
                                      mesh=self.mesh)
            if not bool(np.any(self._fetch(out[4]))):
                break
            need = int(self._fetch(out[3]).max())
            new_s = self.S * 2
            while new_s < need:
                new_s *= 2
            self._grow(new_s)
        nk, nd, nm = out[:3]
        if self.n == 1:
            nk, nd, nm = nk[None], nd[None], nm[None]
        self.state_k, self.state_d, self.state_m = nk, nd, nm
        self.recv_k, self.recv_p, self.bases = [], [], []

    def _check_pending(self, force=False, window=4):
        while self._pending and (force or len(self._pending) > window):
            inputs, base, out = self._pending.pop(0)
            if bool(np.any(self._fetch(out[3]))):
                self._replay_overflow((inputs, base))
                continue
            self.total_emitted += int(self._fetch(out[2]).sum())

    def _replay_overflow(self, first):
        """A chunk overflowed its routing capacity (low-complexity input):
        drop its batch (and all later uncommitted ones), widen, re-route."""
        replay = [first] + [(i, b) for (i, b, _o) in self._pending]
        self._pending = []
        n_drop = len(replay)
        self.n_replay += n_drop
        del self.recv_k[-n_drop:]
        del self.recv_p[-n_drop:]
        del self.bases[-n_drop:]
        self._widen()
        for inputs, base in replay:
            while True:
                out = self._route(inputs)
                if not bool(np.any(self._fetch(out[3]))):
                    break
                self._widen()
            self._append(out, base)
            self.total_emitted += int(self._fetch(out[2]).sum())

    def feed_stream(self, codes: np.ndarray, offsets: np.ndarray,
                    base: int = 0):
        """Chunk a flat host stream across devices and feed until consumed."""
        from ..ops.seqhash import _validity
        sh = self.sh
        k = sh.k
        n_total = len(codes)
        codes = np.ascontiguousarray(codes).view(np.uint8)
        valid_all = _validity(np.asarray(offsets, np.int64), n_total, k)
        C = self.chunk
        NW = C // 32
        super_chunk = self.n * C
        for s in range(0, max(n_total, 1), super_chunk):
            sw = np.zeros((self.n, NW + 2), np.uint64)
            vb = np.zeros((self.n, C // 64), np.uint64)
            for d in range(self.n):
                st = s + d * C
                if st >= n_total:
                    break
                seg = codes[st:st + C + k - 1]
                sw[d] = pack_sw(seg, NW + 2)
                m = min(C, n_total - st)
                vb[d] = pack_bits(valid_all[st:st + m], C // 64)
            if self.n == 1:
                inputs = (jnp.asarray(
                    np.concatenate([sw[0], vb[0]])),)
            else:
                # place inputs with their mesh sharding explicitly: letting
                # jit reshard single-device arrays into a shard_map trips an
                # XLA-CPU input-buffer bug when another executable has
                # already run in the process (gpos is [n, 1] for the same
                # reason: a degenerate rank-1 sharded input is mishandled)
                shd = jax.sharding.NamedSharding(self.mesh, P("shard"))
                gpos = (np.uint64(base + s) +
                        np.arange(self.n, dtype=np.uint64) * np.uint64(C)
                        ).reshape(self.n, 1)
                inputs = (jax.device_put(sw, shd), jax.device_put(vb, shd),
                          jax.device_put(gpos, shd))
            out = self._route(inputs)
            if self._buffered_rows() + self._recv_rows() > self.max_buffer_rows:
                self._compact()
            self._append(out, np.uint64(base + s))
            self._pending.append((inputs, np.uint64(base + s), out))
            self._check_pending()
        self._check_pending(force=True)

    # ---------- device-state snapshotting (SURVEY §5) ----------
    # The reference checkpoints by persisting finished structures (-w stem /
    # -r stem, modutils.c:103-106); a long sharded/multi-host build also
    # needs its IN-PROGRESS device table snapshotted so a preempted run
    # resumes mid-stream instead of restarting.  The snapshot is the
    # compacted state triple + the builder's exactness-relevant scalars.

    SNAP_VERSION = 1

    def save(self, path, cursor: int = 0):
        """Snapshot the in-progress build to `path` (.npz).  Flushes pending
        chunks and compacts first, so the snapshot is exactly the state a
        fresh builder reaches after consuming the same stream prefix.
        `cursor` is an opaque caller value (e.g. codes consumed) returned
        by `restore` so the caller can reposition its stream.  On a
        multi-host mesh every process must call this (the state gather is
        collective); only process 0 writes."""
        self._compact()
        ks = self._fetch(self.state_k)
        ds = self._fetch(self.state_d)
        ms = self._fetch(self.state_m)
        if jax.process_index() == 0:
            meta = np.array([self.SNAP_VERSION, self.sh.k, self.sh.w,
                             self.sh.seed, self.n, self.S, self.bo,
                             self.cap, self.chunk, self.total_emitted,
                             int(cursor)], np.int64)
            with open(path, "wb") as f:
                np.savez(f, meta=meta, state_k=ks, state_d=ds, state_m=ms)

    @classmethod
    def restore(cls, path, sh, mesh: Mesh, **kwargs):
        """Rebuild a builder from a `save` snapshot; returns (builder,
        cursor).  Seqhash params and mesh size must match the snapshot
        (re-sharding onto a different mesh = finalize + modset merge
        instead).  Keyword overrides (max_buffer_rows etc.) pass through."""
        with open(path, "rb") as f:
            d = np.load(f)
            meta = d["meta"]
            ks, ds, ms = d["state_k"], d["state_d"], d["state_m"]
        (ver, k, w, seed, n, S, bo, cap, chunk, total_emitted,
         cursor) = (int(x) for x in meta)
        if ver != cls.SNAP_VERSION:
            raise ValueError(f"{path}: snapshot version {ver} != "
                             f"{cls.SNAP_VERSION}")
        if (k, w, seed) != (sh.k, sh.w, sh.seed):
            raise ValueError(
                f"{path}: snapshot seqhash (k={k} w={w} seed={seed}) does "
                f"not match (k={sh.k} w={sh.w} seed={sh.seed})")
        if n != mesh.devices.size:
            raise ValueError(
                f"{path}: snapshot has {n} shards but the mesh has "
                f"{mesh.devices.size} — finalize + merge to re-shard")
        b = cls(sh, mesh, chunk_per_dev=chunk, state_size=S, **kwargs)
        b.bo, b.cap, b.total_emitted = bo, cap, total_emitted
        if b.n == 1:
            put = jnp.asarray
        else:
            shd = jax.sharding.NamedSharding(mesh, P("shard"))

            def put(a):  # works single- and multi-process
                return jax.make_array_from_callback(
                    a.shape, shd, lambda idx: a[idx])
        b.state_k = put(np.ascontiguousarray(ks))
        b.state_d = put(np.ascontiguousarray(ds))
        b.state_m = put(np.ascontiguousarray(ms))
        return b, cursor

    def finalize(self):
        """Gather shards and return (kmers, counts) in first-encounter order —
        identical to the sequential build's insertion stream."""
        self._compact()
        ks = np.asarray(self.state_k).reshape(-1)
        ds = np.asarray(self.state_d).reshape(-1)
        ms = np.asarray(self.state_m).reshape(-1)
        real = ks != 0xFFFFFFFFFFFFFFFF
        ks, ds, ms = ks[real], ds[real], ms[real]
        order = np.argsort(ms, kind="stable")
        return ks[order], np.minimum(ds[order], 0xFFFF).astype(np.uint32)


# ------------------------------------------------------------------
# sharded modset merge: modutils -m / modsetMerge (modset.c:106-128)
# distributed by hash prefix over the mesh
# ------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_shards", "cap", "mesh"))
def sharded_merge_step(kmers, depth, info, rank, *, n_shards, cap, mesh):
    """Route (kmer, depth, info, rank) rows by a kmer partition; per shard
    reduce with the reference's exact merge math (modset.c:106-128):
      depth: saturating U16 add (modset.c:122)
      info:  A-only keeps full info (modsetMerge never touches it); any
             entry the B pass lands on gets (infoA & 3) | min(cA+cB, 3)
             with flag bits cleared (modset.c:124-125) — for B-only kmers
             infoA is the fresh entry's 0, so the result is copyB with B's
             flags CLEARED.  B rows carry marker bit 8 in the u32 info
             column so singles know their origin.
      rank:  min (first-encounter order for the replayed insertion stream)

    A rows always carry smaller ranks than B rows, so after a (kmer, rank)
    sort each segment's first row is A's when both are present.  Everything
    is sorts + gathers — no scatters.

    Inputs [n_shards, cap], kmers sentinel-padded.  Returns reduced arrays
    (sentinel-padded, kmer-sorted per shard) + per-shard overflow flags.
    """

    def step(km, dp, nf, rk):
        km, dp, nf, rk = km[0], dp[0], nf[0], rk[0]
        n = km.shape[0]
        owner = div_mod_owner(km, 1, n_shards)
        key_real = jnp.where(km != U64_SENTINEL, owner * 2,
                             jnp.uint32(2 * n_shards))
        key_pad = (jnp.arange(n_shards * cap,
                              dtype=jnp.uint32) // cap) * 2 + 1
        allk = jnp.concatenate([key_real, key_pad])

        def pad(v, fill, dt):
            return jnp.concatenate([v, jnp.full(n_shards * cap, fill, dt)])

        sk, sv, sd, si, sr = _sort_multi(
            [allk], [pad(km, U64_SENTINEL, jnp.uint64),
                     pad(dp, 0, jnp.uint32), pad(nf, 0, jnp.uint32),
                     pad(rk, POS_INF, jnp.uint64)])
        starts = jnp.searchsorted(sk, jnp.arange(n_shards,
                                                 dtype=jnp.uint32) * 2)
        ends = jnp.searchsorted(sk, jnp.arange(n_shards,
                                               dtype=jnp.uint32) * 2 + 1)
        overflow = jnp.any((ends - starts) > cap)
        j = jnp.arange(n_shards * cap)
        idx = starts[j // cap] + (j % cap)

        def a2a(x):
            return jax.lax.all_to_all(
                jnp.take(x, idx).reshape(n_shards, cap), "shard",
                split_axis=0, concat_axis=0, tiled=True).reshape(-1)

        rk_k, rk_d, rk_i, rk_r = a2a(sv), a2a(sd), a2a(si), a2a(sr)

        # reduce per kmer: sort (kmer, rank); <= 2 contributors per kmer
        k_s, r_s, d_s, i_s = _sort_multi([rk_k, rk_r], [rk_d, rk_i])
        m = k_s.shape[0]
        live = k_s != U64_SENTINEL
        first = jnp.concatenate([jnp.array([True]),
                                 k_s[1:] != k_s[:-1]]) & live
        n_heads = jnp.sum(first.astype(jnp.int32))
        n_live = jnp.sum(live.astype(jnp.int32))
        order = _sort_multi([(~first).astype(jnp.uint8)],
                            [jnp.arange(m, dtype=jnp.int32)],
                            is_stable=True)[1]
        jj = jnp.arange(m, dtype=jnp.int32)
        p = order
        p_next = jnp.where(jj + 1 < n_heads, jnp.roll(order, -1), n_live)
        q = jnp.maximum(p_next - 1, p)  # last row of the segment
        both = q > p
        d_p = jnp.take(d_s, p)
        d_q = jnp.where(both, jnp.take(d_s, q), jnp.uint32(0))
        depth_out = jnp.minimum(d_p + d_q, jnp.uint32(0xFFFF))
        i_p = jnp.take(i_s, p)
        i_q = jnp.take(i_s, q)
        c_sum = jnp.minimum((i_p & 3) + (i_q & 3), jnp.uint32(3))
        is_b = (i_p >> jnp.uint32(8)) & jnp.uint32(1)
        single = jnp.where(is_b == 1, i_p & jnp.uint32(3),
                           i_p & jnp.uint32(0xFF))
        info_out = jnp.where(both, (i_p & jnp.uint32(3)) | c_sum, single)
        rank_out = jnp.take(r_s, p)
        is_head = jj < n_heads
        S = n_shards * cap
        out_k = jnp.where(is_head[:S], jnp.take(k_s, p[:S]), U64_SENTINEL)
        out_d = jnp.where(is_head[:S], depth_out[:S], jnp.uint32(0))
        out_i = jnp.where(is_head[:S], info_out[:S], jnp.uint32(0))
        out_r = jnp.where(is_head[:S], rank_out[:S], POS_INF)
        return (out_k[None], out_d[None], out_i[None], out_r[None],
                overflow[None])

    f = jax.shard_map(step, mesh=mesh, in_specs=(P("shard"),) * 4,
                      out_specs=(P("shard"),) * 5)
    return f(kmers, depth, info, rank)


def sharded_merge(ms1, ms2, mesh: Mesh):
    """Device-accelerated modsetMerge: returns (kmers, depth, info) in the
    exact first-encounter order the sequential merge produces (ms1's ids,
    then ms2's new kmers in ms2 id order).  The caller replays them into a
    canonical Modset table.  Returns None when the hashers differ, like
    modsetMerge (modset.c:110-111)."""
    s1, s2 = ms1.hasher, ms2.hasher
    if s1.w != s2.w or s1.k != s2.k or s1.factor1 != s2.factor1:
        return None
    n = mesh.devices.size
    n1, n2 = ms1.max, ms2.max
    total = n1 + n2
    cap = max(1024, -(-total // n))  # per-shard slot budget
    pad = n * cap - total

    kmers = np.concatenate([ms1.value[1:n1 + 1], ms2.value[1:n2 + 1],
                            np.full(pad, 0xFFFFFFFFFFFFFFFF, np.uint64)])
    depth = np.concatenate([ms1.depth[1:n1 + 1], ms2.depth[1:n2 + 1],
                            np.zeros(pad, np.uint16)]).astype(np.uint32)
    info = np.concatenate([ms1.info[1:n1 + 1].astype(np.uint32),
                           ms2.info[1:n2 + 1].astype(np.uint32) | 0x100,
                           np.zeros(pad, np.uint32)])
    rank = np.concatenate([np.arange(total, dtype=np.uint64),
                           np.full(pad, 0xFFFFFFFFFFFFFFFF, np.uint64)])

    def shard2d(a):
        return jnp.asarray(a.reshape(n, cap))

    out = sharded_merge_step(shard2d(kmers), shard2d(depth), shard2d(info),
                             shard2d(rank), n_shards=n, cap=cap, mesh=mesh)
    ok = np.asarray(out[0]).reshape(-1)
    od = np.asarray(out[1]).reshape(-1)
    oi = np.asarray(out[2]).reshape(-1)
    orr = np.asarray(out[3]).reshape(-1)
    if bool(np.any(np.asarray(out[4]))):
        raise RuntimeError("sharded merge shard overflow; raise cap")
    real = ok != 0xFFFFFFFFFFFFFFFF
    ok, od, oi, orr = ok[real], od[real], oi[real], orr[real]
    order = np.argsort(orr, kind="stable")
    return (ok[order], np.minimum(od[order], 0xFFFF).astype(np.uint16),
            oi[order].astype(np.uint8))
