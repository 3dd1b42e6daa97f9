"""Kmers-only pipelined scan (device validity masking) vs the host oracle."""

import numpy as np
import pytest

import modimizer

modimizer.configure_jax()

from modimizer.core.seqhash import Seqhash
from modimizer.ops.seqhash import ModimizerScanner


def _mk(rng, n_reads, lo, hi):
    lens = rng.integers(lo, hi, n_reads)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    codes = rng.integers(0, 4, offsets[-1]).astype(np.uint8)
    return codes, offsets


@pytest.mark.parametrize("k,w", [(16, 16), (19, 31), (11, 10)])
def test_scan_kmers_matches_host(k, w):
    sh = Seqhash.create(k, w, 17)
    rng = np.random.default_rng(5)
    codes, offsets = _mk(rng, 300, 50, 900)
    host = ModimizerScanner(sh, host_threshold=1 << 62)
    want = host.scan_kmers(codes, offsets)
    # force device path, multi-chunk (chunk rounds down to BLOCK multiple)
    dev = ModimizerScanner(sh, chunk=1 << 14, host_threshold=0)
    got = dev.scan_kmers(codes, offsets)
    assert dev.used_device
    assert np.array_equal(got, want)
    # consumer-mode streams the same kmers in the same order
    parts = []
    tot = dev.scan_kmers(codes, offsets, consumer=parts.append)
    assert tot == len(want)
    assert np.array_equal(np.concatenate(parts), want)


def test_scan_kmers_overflow_rescan():
    """A low-complexity (all-A) stream overflows even the widened device
    retry (every position emits); the chunk must fall back to the exact
    native host rescan."""
    sh = Seqhash.create(16, 16, 17)
    codes = np.zeros(1 << 15, np.uint8)  # kmer 0 everywhere
    offsets = np.array([0, len(codes)], np.int64)
    host = ModimizerScanner(sh, host_threshold=1 << 62)
    want = host.scan_kmers(codes, offsets)
    dev = ModimizerScanner(sh, chunk=1 << 14, host_threshold=0)
    got = dev.scan_kmers(codes, offsets)
    assert np.array_equal(got, want)
    assert dev.n_fallback > 0


def test_scan_kmers_overflow_wide_retry():
    """A moderate poly-A burst (> bo, <= 4*bo emits in one block) is
    absorbed by the widened device retry without touching the host
    fallback (the round-3 posmajor layout makes blocks contiguous position
    ranges, so a ~200 bp homopolymer run overflows a block's 6-sigma
    budget — common in real genomes, must not cost a chunk rescan)."""
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 1 << 15).astype(np.uint8)
    codes[5000:5000 + 220] = 0  # poly-A run: ~220 emits in its block
    offsets = np.array([0, len(codes)], np.int64)
    host = ModimizerScanner(sh, host_threshold=1 << 62)
    want = host.scan_kmers(codes, offsets)
    dev = ModimizerScanner(sh, chunk=1 << 14, host_threshold=0)
    got = dev.scan_kmers(codes, offsets)
    assert np.array_equal(got, want)
    assert dev.n_wide > 0 and dev.n_fallback == 0
    # scan_stream takes the same retry tiers
    dev2 = ModimizerScanner(sh, chunk=1 << 14, host_threshold=0)
    kk, pp, ff = dev2.scan_stream(codes, offsets)
    hk, hp, hf = host.scan_stream(codes, offsets)
    assert np.array_equal(kk, hk) and np.array_equal(pp, hp)
    assert np.array_equal(ff, hf)
    assert dev2.n_wide > 0 and dev2.n_fallback == 0


def test_scan_stream_rows_in_stream_order():
    """The dense rows a chunk returns are already in stream order (the
    in-block one-hot ranks are emit order, blocks are position-major, and
    the densify butterfly is order-preserving) — the invariant scan_kmers'
    id-parity relies on."""
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 1 << 15).astype(np.uint8)
    sc = ModimizerScanner(sh, chunk=1 << 14, host_threshold=0)
    meta = np.asarray(sc._dispatch(codes, 0, 1 << 14)[1])
    live = meta[meta != 0xFFFFFFFF]
    assert np.all(np.diff(live.astype(np.int64)) > 0)


@pytest.mark.parametrize("backend", ["posgather", "posgather_cmp"])
def test_scan_kmers_posgather_backend(backend, monkeypatch):
    """Sparse-rematerializing backends on the posmajor (stream-order)
    path: _scan_chunk_kmers must match the host oracle exactly (order,
    values) for k<=16 and k>16."""
    monkeypatch.setenv("MODIMIZER_COMPACT", backend)
    rng = np.random.default_rng(6)
    for k, w in [(16, 16), (19, 31)]:
        sh = Seqhash.create(k, w, 17)
        codes, offsets = _mk(rng, 120, 50, 900)
        host = ModimizerScanner(sh, host_threshold=1 << 62)
        want = host.scan_kmers(codes, offsets)
        dev = ModimizerScanner(sh, chunk=1 << 14, host_threshold=0)
        got = dev.scan_kmers(codes, offsets)
        assert dev.used_device
        assert np.array_equal(got, want), (backend, k, w)


def test_sparse_validity_paths_identical():
    """Sparse exception-list validity upload vs dense words: same rows,
    same overflow behavior, across tail chunks and a tiny sparse budget
    (forcing the dense fallback)."""
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(8)
    codes, offsets = _mk(rng, 200, 50, 900)

    dense = ModimizerScanner(sh, chunk=1 << 13, host_threshold=0)
    dense.dense_valid = True
    want = dense.scan_kmers(codes, offsets)

    sparse = ModimizerScanner(sh, chunk=1 << 13, host_threshold=0)
    assert not sparse.dense_valid
    got = sparse.scan_kmers(codes, offsets)
    assert np.array_equal(want, got)

    tiny = ModimizerScanner(sh, chunk=1 << 13, host_threshold=0)
    tiny.sparse_cap = 1          # everything overflows into dense
    got2 = tiny.scan_kmers(codes, offsets)
    assert np.array_equal(want, got2)

    # streaming path rides the same dispatcher
    stream = ModimizerScanner(sh, chunk=1 << 13, host_threshold=0)
    got3 = stream.scan_kmers_batches([(codes, offsets)])
    assert np.array_equal(want, got3)


def test_expand_sparse_valid_matches_dense():
    """Device expansion == the native dense plane for random read layouts
    and live counts (incl. m on/off word boundaries, zero exceptions)."""
    import jax.numpy as jnp
    from modimizer.native import lib as native_lib
    from modimizer.ops.packed import expand_sparse_valid
    L = native_lib()
    rng = np.random.default_rng(9)
    k = 16
    for m in (64 * 7, 64 * 7 - 5, 64 * 3 + 1, 1):
        NV = 8
        lens = rng.integers(20, 120, 12)
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        offsets = np.clip(offsets, 0, m)
        vw = np.zeros(NV, np.uint64)
        L.pk_valid_words(offsets, len(offsets) - 1, m, k, vw, NV)
        nv_m = (m + 63) // 64
        head = vw[:nv_m]
        nz = np.flatnonzero(head != np.uint64(0xFFFFFFFFFFFFFFFF))
        P = 16
        sv_idx = np.full(P, NV, np.int32)
        sv_idx[:len(nz)] = nz
        sv_val = np.zeros(P, np.uint64)
        sv_val[:len(nz)] = head[nz]
        got = np.asarray(expand_sparse_valid(
            jnp.asarray(sv_idx), jnp.asarray(sv_val), jnp.int32(m), NV))
        assert np.array_equal(got, vw), m


def test_densify_search_equals_roll(monkeypatch):
    """Search / roll-butterfly / two-phase-aligned-butterfly densify:
    bit-identical chunk outputs (kmers path and meta path) on multi-chunk
    streams."""
    import jax.numpy as jnp
    from modimizer.ops.device_scan import _scan_chunk
    from modimizer.ops.packed import pack_sw
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(10)
    codes, offsets = _mk(rng, 150, 50, 900)

    outs = {}
    for mode in ("search", "roll", "roll2"):
        monkeypatch.setenv("MODIMIZER_DENSIFY", mode)
        sc = ModimizerScanner(sh, chunk=1 << 13, host_threshold=0)
        outs[mode] = sc.scan_kmers(codes, offsets)
        # meta path (scan_stream's per-chunk program)
        C = 1 << 13
        sw = jnp.asarray(pack_sw(codes[:C + 15].view(np.uint8), C // 32 + 2))
        km, meta, tot = _scan_chunk(sw, jnp.int32(C), k=16, w=16,
                                    factor1=sh.factor1, bo=112, cap=1024)
        outs[mode + "_meta"] = (np.asarray(km), np.asarray(meta),
                                int(tot))
        import modimizer.ops.device_scan as ds
        ds._scan_chunk.clear_cache()
        ds._scan_chunk_kmers.clear_cache()
        ds._scan_chunk_kmers_sparse.clear_cache()
    assert np.array_equal(outs["search"], outs["roll"])
    assert np.array_equal(outs["search"], outs["roll2"])
    for a, b in zip(outs["search_meta"], outs["roll_meta"]):
        assert np.array_equal(a, b)
    for a, b in zip(outs["search_meta"], outs["roll2_meta"]):
        assert np.array_equal(a, b)
