"""Compaction backends and the divisibility test vs the plain XLA
front-end oracle (CPU jit, small shapes)."""

import numpy as np
import pytest

import modimizer

modimizer.configure_jax()

import jax.numpy as jnp

from modimizer.ops.packed import mod_is_zero, pack_bits, pack_sw
from modimizer.parallel.sharded import _scan_compact_local


def test_mod_is_zero_lemire_exact():
    """Direct check of the division-free divisibility test over random
    hashes and a spread of w (pow2 / odd / even-composite, u32 + u64)."""
    rng = np.random.default_rng(9)
    ws = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 17, 24, 31, 32, 48, 63, 100,
          255, 1000, 65537, (1 << 20) + 7]
    h64 = rng.integers(0, 1 << 63, 4096, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, 4096, dtype=np.uint64)
    # force plenty of true positives for each w
    for w in ws:
        mult = rng.integers(0, 1 << 32, 256, dtype=np.uint64)
        hs = np.concatenate([h64, mult * np.uint64(w)])
        got = np.asarray(mod_is_zero(jnp.asarray(hs), w))
        assert np.array_equal(got, hs % np.uint64(w) == 0), f"u64 w={w}"
        h32 = hs.astype(np.uint32)
        got32 = np.asarray(mod_is_zero(jnp.asarray(h32), w))
        assert np.array_equal(got32, h32 % np.uint32(w) == 0), f"u32 w={w}"


@pytest.mark.parametrize("k,w,bo", [(16, 16, 112), (19, 31, 64),
                                    (16, 31, 112), (24, 31, 64),
                                    (31, 101, 64), (32, 16, 112)])
def test_compact_backends_bit_identical(k, w, bo):
    """onehot / onehot_i8 / twolevel / twolevel_i8 / butterfly all return
    byte-identical rows (incl. sentinels and overflow flags)."""
    rng = np.random.default_rng(7)
    f1 = 0x9E3779B97F4A7C15 | 1
    C = 1 << 15
    codes = rng.integers(0, 4, C + k - 1).astype(np.uint8)
    sw = jnp.asarray(pack_sw(codes, C // 32 + 2))
    vb = jnp.asarray(pack_bits(np.ones(C, bool), C // 64))
    ref = None
    for be in ["onehot", "onehot_i8", "twolevel", "twolevel_i8",
               "butterfly", "gather", "searchcmp", "posgather",
               "posgather_cmp"]:
        out = tuple(np.asarray(x) for x in _scan_compact_local(
            sw, vb, k=k, w=w, factor1=f1, C=C, bo=bo, backend=be))
        if ref is None:
            ref = out
        else:
            for a, b in zip(ref, out):
                assert np.array_equal(a, b), be
    # the fused backends use a different (legal) block partition on this
    # posmajor=False path: rows must match as a (pos, kmer) multiset
    def row_multiset(t):
        live = t[1] != np.uint32(0xFFFFFFFF)
        return sorted(zip(t[1][live].tolist(),
                          t[0][live].astype(np.uint64).tolist()))
    want = row_multiset(ref)
    for be in ["fused", "fusedb", "fusedc", "fusedd"]:
        out = tuple(np.asarray(x) for x in _scan_compact_local(
            sw, vb, k=k, w=w, factor1=f1, C=C, bo=bo, backend=be))
        assert row_multiset(out) == want, be
        assert int(out[2]) == int(ref[2]), be


@pytest.mark.parametrize("clog", [11, 12, 15, 17])
def test_fused_small_chunks_multiset(clog):
    """Regression: C < 32*BLK used to hit the stripe base math with
    ipb = NW//BLK = 0 (y % 0 garbage positions) once fused became
    reachable as a default; such chunks must take the position-major
    fused path and still match onehot_i8 exactly as a multiset."""
    k, w = 16, 16
    f1 = 0x9E3779B97F4A7C15 | 1
    C = 1 << clog
    rng = np.random.default_rng(clog)
    codes = rng.integers(0, 4, C + k - 1).astype(np.uint8)
    sw = jnp.asarray(pack_sw(codes, C // 32 + 2))
    vb = jnp.asarray(pack_bits(np.ones(C, bool), C // 64))
    bo = 112

    def row_multiset(t):
        live = t[1] != np.uint32(0xFFFFFFFF)
        return sorted(zip(t[1][live].tolist(),
                          t[0][live].astype(np.uint64).tolist()))
    ref = tuple(np.asarray(x) for x in _scan_compact_local(
        sw, vb, k=k, w=w, factor1=f1, C=C, bo=bo, backend="onehot_i8"))
    for be in ["fused", "fusedb", "fusedc", "fusedd"]:
        out = tuple(np.asarray(x) for x in _scan_compact_local(
            sw, vb, k=k, w=w, factor1=f1, C=C, bo=bo, backend=be))
        assert row_multiset(out) == row_multiset(ref), (be, clog)
        assert int(out[2]) == int(ref[2]), (be, clog)


@pytest.mark.parametrize("k,w,clog", [(16, 16, 15), (13, 31, 14),
                                      (16, 31, 16), (19, 31, 15),
                                      (24, 31, 15), (32, 16, 15)])
def test_fusedc_posmajor_bit_identical(k, w, clog):
    """fusedc on the posmajor (stream-order) path — the kmers-only e2e
    layout — must be BYTE-identical to the onehot posmajor oracle (same
    contiguous-position block partition, in-block ranks = stream order),
    both meta flavors, under ragged validity words."""
    from modimizer.parallel.sharded import (_expand_valid,
                                                _scan_compact_core)
    rng = np.random.default_rng(7)
    f1 = 0x9E3779B97F4A7C15 | 1
    C = 1 << clog
    codes = rng.integers(0, 4, C + k - 1).astype(np.uint8)
    sw = jnp.asarray(pack_sw(codes, C // 32 + 2))
    # full-range u64 words (two u32 halves): all 64 validity bit
    # positions exercised, incl. bit 63 (integers(0, 2**63) left it 0)
    _vrng = np.random.default_rng(3)
    vbn = ((_vrng.integers(0, 2 ** 32, C // 64).astype(np.uint64)
            << np.uint64(32))
           | _vrng.integers(0, 2 ** 32, C // 64).astype(np.uint64))
    vb = jnp.asarray(vbn)
    valid = _expand_valid(vb, C)
    for meta_isf in (False, True):
        ref = tuple(np.asarray(x) for x in _scan_compact_core(
            sw, valid, k=k, w=w, factor1=f1, C=C, bo=112,
            backend="onehot_i8", posmajor=True, meta_isf=meta_isf,
            vbits=vb))
        got = tuple(np.asarray(x) for x in _scan_compact_core(
            sw, valid, k=k, w=w, factor1=f1, C=C, bo=112,
            backend="fusedc", posmajor=True, meta_isf=meta_isf, vbits=vb))
        for a, b in zip(ref, got):
            assert np.array_equal(a, b), (k, w, clog, meta_isf)


_BLK_PROBE = r"""
import numpy as np
import modimizer
modimizer.configure_jax()
import jax.numpy as jnp
from modimizer.ops.packed import pack_bits, pack_sw
from modimizer.ops.seqhash import scan_bo
from modimizer.parallel.sharded import BLK, _scan_compact_local
k, w = 16, 16
f1 = 0x9E3779B97F4A7C15 | 1
C = 1 << 15
rng = np.random.default_rng(11)
codes = rng.integers(0, 4, C + k - 1).astype(np.uint8)
sw = jnp.asarray(pack_sw(codes, C // 32 + 2))
vb = jnp.asarray(pack_bits(np.ones(C, bool), C // 64))
ok, op, n, ovf = (np.asarray(x) for x in _scan_compact_local(
    sw, vb, k=k, w=w, factor1=f1, C=C, bo=scan_bo(w)))
assert not ovf, BLK
live = ok != np.uint64(0xFFFFFFFFFFFFFFFF)
rows = sorted(zip(op[live].tolist(), ok[live].tolist()))
print(BLK, int(n), hash(tuple(map(tuple, rows))))
"""


def test_blk_env_row_set_invariant():
    """MODIMIZER_BLK only re-blocks the compaction: the emitted (pos, kmer)
    row set is identical for BLK 256/512/1024 (bo re-derived per BLK)."""
    import os
    import subprocess
    import sys
    outs = set()
    for blk in ("256", "512", "1024"):
        env = dict(os.environ, MODIMIZER_BLK=blk, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", _BLK_PROBE], env=env,
                           capture_output=True, text=True, check=True)
        blk_got, n, digest = r.stdout.split()
        assert blk_got == blk
        outs.add((n, digest))
    assert len(outs) == 1, outs


@pytest.mark.parametrize("k,w,posmajor", [(19, 31, False), (19, 31, True),
                                          (24, 101, False), (31, 31, True)])
def test_fusedd_wide_pair_path_bit_identical(k, w, posmajor):
    """The env-gated u32-pair wide-k path (MODIMIZER_FUSEDD_WIDE=pm,
    _scan_front_u32pair + _fused_compact_tail_u64pair) must stay
    bit-identical to the shipped sublane64 route — it is the measured-
    slower ablation kept runnable (docs/PERF.md round-5) and the pair
    Lemire emit test deserves its own regression."""
    from modimizer.core.seqhash import Seqhash as SH
    from modimizer.ops.seqhash import scan_bo
    from modimizer.parallel.sharded import (BLK, _expand_valid,
                                                _scan_compact_core)
    sh = SH.create(k, w, 17)
    C = 32 * BLK
    rng = np.random.default_rng(k * 100 + w)
    codes = rng.integers(0, 4, C + k - 1).astype(np.uint8)
    vmask = rng.random(C) < 0.9
    sw = jnp.asarray(pack_sw(codes, C // 32 + 2))
    vb = jnp.asarray(pack_bits(vmask, C // 64))
    bo = scan_bo(w)

    def run(env_pm):
        import os
        old = os.environ.pop("MODIMIZER_FUSEDD_WIDE", None)
        if env_pm:
            os.environ["MODIMIZER_FUSEDD_WIDE"] = "pm"
        try:
            o = _scan_compact_core(
                sw, _expand_valid(vb, C), k=k, w=w, factor1=sh.factor1,
                C=C, bo=bo, backend="fusedd", posmajor=posmajor,
                meta_isf=True, vbits=vb)
        finally:
            os.environ.pop("MODIMIZER_FUSEDD_WIDE", None)
            if old is not None:
                os.environ["MODIMIZER_FUSEDD_WIDE"] = old
        ok, op = np.asarray(o[0]), np.asarray(o[1])
        live = ok != np.uint64(0xFFFFFFFFFFFFFFFF)
        rows = list(zip(ok[live].tolist(), op[live].tolist()))
        return (int(o[2]), rows if posmajor else sorted(rows), bool(o[3]))

    assert run(True) == run(False)
