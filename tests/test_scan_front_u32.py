"""u32 scan front (MODIMIZER_FRONT=u32) is bit-exact to the u64 funnel.

The u32 front re-derives the forward/RC kmers from u32 halves of the
funnel words and computes the hash window through the 16-bit-limb mulhi
(_hash32_hi) instead of an emulated u64 multiply — every (hash, kmer, pos,
isF) plane must match _scan_front exactly for any k <= 16, and the full
scan+compact step must produce identical rows.
"""

import numpy as np
import pytest

import modimizer  # noqa: F401

import jax.numpy as jnp

from modimizer.core.seqhash import Seqhash
from modimizer.ops.packed import pack_bits, pack_sw
from modimizer.ops.seqhash import scan_bo
from modimizer.parallel.sharded import (_hash32_hi, _scan_compact_local,
                                            _scan_front, _scan_front_u32)


@pytest.mark.parametrize("k", [1, 5, 9, 12, 15, 16])
def test_front_u32_matches_funnel64(k):
    rng = np.random.default_rng(100 + k)
    sh = Seqhash.create(k, 16, 17)
    C = 1 << 12
    codes = rng.integers(0, 4, C + k - 1).astype(np.uint8)
    # sprinkle homopolymer runs (kmer 0 / saturated kmers hit the hash's
    # carry chains hardest)
    codes[100:180] = 0
    codes[500:600] = 3
    sw = jnp.asarray(pack_sw(codes, C // 32 + 2))
    h64, k64, p64, f64 = _scan_front(sw, k=k, factor1=sh.factor1, C=C)
    h32, k32, p32, f32 = _scan_front_u32(sw, k=k, factor1=sh.factor1, C=C)
    assert h32.dtype == jnp.uint32 and k32.dtype == jnp.uint32
    assert np.array_equal(np.asarray(h64), np.asarray(h32).astype(np.uint64))
    assert np.array_equal(np.asarray(k64), np.asarray(k32).astype(np.uint64))
    assert np.array_equal(np.asarray(p64), np.asarray(p32))
    assert np.array_equal(np.asarray(f64), np.asarray(f32))


def test_hash32_hi_exact_vs_python():
    """_hash32_hi == bits 32..63 of a * factor1 over adversarial operands
    (carry-propagation edges) and random ones."""
    rng = np.random.default_rng(7)
    factors = [Seqhash.create(16, 16, s).factor1 for s in (17, 1, 12345)]
    edge = np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                     0xFFFF0000, 0xFFFFFFFF], np.uint64)
    vals = np.concatenate([edge, rng.integers(0, 1 << 32, 4096,
                                              dtype=np.uint64)])
    for f in factors:
        want = ((vals * np.uint64(f)) >> np.uint64(32)).astype(np.uint32)
        got = np.asarray(_hash32_hi(jnp.asarray(vals.astype(np.uint32)), f))
        assert np.array_equal(got, want), hex(f)


@pytest.mark.parametrize("k,w", [(16, 16), (12, 31), (16, 7)])
def test_scan_compact_u32_front_bitexact(k, w):
    """Full step equality: same compacted rows/slots/counts/overflow with
    the u32 front forced, across pow2 and non-pow2 w."""
    rng = np.random.default_rng(200 + k + w)
    sh = Seqhash.create(k, w, 17)
    C = 1 << 13
    bo = scan_bo(w)
    codes = rng.integers(0, 4, C + k - 1).astype(np.uint8)
    valid = rng.random(C) < 0.95
    sw = jnp.asarray(pack_sw(codes, C // 32 + 2))
    vb = jnp.asarray(pack_bits(valid, C // 64))

    ref = _scan_compact_local(sw, vb, k=k, w=w, factor1=sh.factor1, C=C,
                              bo=bo, front="funnel64")
    got = _scan_compact_local(sw, vb, k=k, w=w, factor1=sh.factor1, C=C,
                              bo=bo, front="u32")
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_scan_kmers_pipeline_u32_front():
    """The full device pipeline (scan_kmers incl. wide-retry tier, and
    scan_stream's exact order) is identical under both fronts, forced via
    the scanner's per-instance policy."""
    from modimizer.ops.seqhash import ModimizerScanner
    rng = np.random.default_rng(41)
    sh = Seqhash.create(16, 16, 17)
    lens = rng.integers(50, 400, size=120)
    seqs = [rng.integers(0, 4, size=l).astype(np.uint8) for l in lens]
    # a homopolymer read forces the block-overflow wide-retry tier
    seqs[10][:] = 0
    codes = np.concatenate(seqs)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    outs = {}
    for fr in ("funnel64", "u32"):
        sc = ModimizerScanner(sh, chunk=1 << 12, host_threshold=0)
        sc.front = fr
        outs[fr] = (sc.scan_kmers(codes, offsets),
                    sc.scan_stream(codes, offsets))
    (k_a, (sk_a, sg_a, sf_a)), (k_b, (sk_b, sg_b, sf_b)) = \
        outs["funnel64"], outs["u32"]
    assert np.array_equal(k_a, k_b)
    assert np.array_equal(sk_a, sk_b)
    assert np.array_equal(sg_a, sg_b)
    assert np.array_equal(sf_a, sf_b)
    # and both match the host oracle
    host = ModimizerScanner(sh, host_threshold=1 << 62)
    assert np.array_equal(k_a, host.scan_kmers(codes, offsets))
