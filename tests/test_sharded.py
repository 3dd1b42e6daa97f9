"""Multi-chip sharded modset build == sequential build, on an 8-device CPU mesh."""

import numpy as np
import pytest

from modimizer.core.seqhash import Seqhash
from modimizer.ops.seqhash import ModimizerScanner, first_encounter_unique
from modimizer.parallel.sharded import ShardedModsetBuilder, build_mesh

import jax


@pytest.mark.skipif(jax.device_count() < 2, reason="needs multiple devices")
def test_sharded_build_matches_sequential():
    rng = np.random.default_rng(21)
    sh = Seqhash.create(16, 16, 17)
    lens = rng.integers(50, 400, size=200)
    seqs = [rng.integers(0, 4, size=l).astype(np.uint8) for l in lens]
    codes = np.concatenate(seqs)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    # sequential oracle
    sc = ModimizerScanner(sh, chunk=1 << 12)
    kmers, _g, _f = sc.scan_stream(codes, offsets)
    uniq, counts = first_encounter_unique(kmers)

    mesh = build_mesh()
    b = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << 10, state_size=1 << 12)
    b.feed_stream(codes, offsets)
    ks, ds = b.finalize()

    assert b.total_emitted == len(kmers)
    assert np.array_equal(ks, uniq)
    assert np.array_equal(ds, counts)


@pytest.mark.skipif(jax.device_count() < 2, reason="needs multiple devices")
def test_sharded_build_feeds_canonical_modset(tmp_path):
    """Sharded build -> canonical byte-exact Modset file."""
    from modimizer.core.modset import Modset
    rng = np.random.default_rng(5)
    sh = Seqhash.create(16, 16, 17)
    seqs = [rng.integers(0, 4, size=300).astype(np.uint8) for _ in range(50)]
    codes = np.concatenate(seqs)
    offsets = np.arange(0, 300 * 51, 300, dtype=np.int64)

    mesh = build_mesh()
    b = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << 10, state_size=1 << 12)
    b.feed_stream(codes, offsets)
    ks, ds = b.finalize()
    ms1 = Modset(Seqhash.create(16, 16, 17), 20)
    ms1.add_batch(ks, ds)

    sc = ModimizerScanner(sh)
    kmers, _g, _f = sc.scan_stream(codes, offsets)
    uniq, counts = first_encounter_unique(kmers)
    ms2 = Modset(Seqhash.create(16, 16, 17), 20)
    ms2.add_batch(uniq, counts)

    ms1.write(tmp_path / "a.mod")
    ms2.write(tmp_path / "b.mod")
    assert (tmp_path / "a.mod").read_bytes() == (tmp_path / "b.mod").read_bytes()


@pytest.mark.skipif(jax.device_count() < 2, reason="needs multiple devices")
def test_sharded_merge_matches_native():
    """Device merge == exact modsetMerge semantics (modset.c:106-128)."""
    from modimizer.core.modset import Modset
    from modimizer.parallel.sharded import sharded_merge
    rng = np.random.default_rng(33)
    sh = Seqhash.create(16, 16, 17)

    def make_ms(seed, n_seqs):
        r = np.random.default_rng(seed)
        seqs = [r.integers(0, 4, size=400).astype(np.uint8)
                for _ in range(n_seqs)]
        codes = np.concatenate(seqs)
        offsets = np.arange(0, 400 * (n_seqs + 1), 400, dtype=np.int64)
        sc = ModimizerScanner(sh)
        kmers, _g, _f = sc.scan_stream(codes, offsets)
        uniq, counts = first_encounter_unique(kmers)
        ms = Modset(Seqhash.create(16, 16, 17), 20)
        ms.add_batch(uniq, counts)
        # scatter some copy numbers + flag bits to exercise the merge math
        ms.info[1:ms.max + 1] = rng.integers(0, 64, ms.max).astype(np.uint8)
        return ms

    # overlapping kmer content: same genome seed, different sampling
    ms_a, ms_b = make_ms(7, 60), make_ms(7, 40)
    ms_b2 = make_ms(99, 30)          # plus disjoint content
    assert ms_b.merge(ms_b2)

    mesh = build_mesh()
    kd = sharded_merge(ms_a, ms_b, mesh)
    assert kd is not None
    ks, ds, infos = kd

    # native oracle
    assert ms_a.merge(ms_b)
    n = ms_a.max
    assert np.array_equal(ks, ms_a.value[1:n + 1])
    assert np.array_equal(ds, ms_a.depth[1:n + 1])
    assert np.array_equal(infos, ms_a.info[1:n + 1])

    # replay into a canonical table: byte-identical file
    ms_c = Modset(Seqhash.create(16, 16, 17), 20)
    ms_c.add_batch(ks, np.zeros(len(ks), np.uint32))
    ms_c.depth[1:ms_c.max + 1] = ds
    ms_c.info[1:ms_c.max + 1] = infos
    assert ms_c.to_bytes() == ms_a.to_bytes()


@pytest.mark.skipif(jax.device_count() < 2, reason="needs multiple devices")
def test_sharded_build_cap_overflow_replay():
    """Low-complexity input (every position emits the same kmer) overflows
    the per-owner routing cap; the builder must replay with a wider cap and
    still match the sequential build exactly."""
    sh = Seqhash.create(16, 16, 17)
    # find a repeating base whose homopolymer kmer is emitted
    rng = np.random.default_rng(2)
    for b in range(4):
        codes = np.full(6000, b, np.uint8)
        sc = ModimizerScanner(sh, chunk=1 << 12)
        kmers, _g, _f = sc.scan_stream(
            codes, np.array([0, len(codes)], np.int64))
        if len(kmers) > 3000:
            break
    else:
        pytest.skip("no homopolymer kmer emits for this seed")
    # mix with random sequence
    tail = rng.integers(0, 4, size=4000).astype(np.uint8)
    codes = np.concatenate([codes, tail])
    offsets = np.array([0, len(codes)], np.int64)
    sc = ModimizerScanner(sh, chunk=1 << 12)
    kmers, _g, _f = sc.scan_stream(codes, offsets)
    uniq, counts = first_encounter_unique(kmers)

    mesh = build_mesh()
    b = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << 10,
                             state_size=1 << 12, cap=64)  # force overflow
    b.feed_stream(codes, offsets)
    ks, ds = b.finalize()
    assert b.total_emitted == len(kmers)
    assert np.array_equal(ks, uniq)
    assert np.array_equal(ds, counts)
    assert b.cap > 64  # the replay actually widened the cap


def test_single_device_fast_path():
    """n=1 mesh uses the blockwise top_k path (no sort, no collective)."""
    rng = np.random.default_rng(8)
    sh = Seqhash.create(16, 16, 17)
    lens = rng.integers(100, 500, size=80)
    seqs = [rng.integers(0, 4, size=l).astype(np.uint8) for l in lens]
    codes = np.concatenate(seqs)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    sc = ModimizerScanner(sh, chunk=1 << 12)
    kmers, _g, _f = sc.scan_stream(codes, offsets)
    uniq, counts = first_encounter_unique(kmers)

    mesh = build_mesh(n_devices=1)
    b = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << 13,
                             state_size=1 << 12)
    assert b.bo > 0
    b.feed_stream(codes, offsets)
    ks, ds = b.finalize()
    assert np.array_equal(ks, uniq)
    assert np.array_equal(ds, counts)

    # and the overflow/widen path on a homopolymer stream
    for base in range(4):
        cd = np.full(5000, base, np.uint8)
        km2, _g2, _f2 = sc.scan_stream(cd, np.array([0, 5000], np.int64))
        if len(km2) > 2000:
            b2 = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << 13,
                                      state_size=1 << 12, cap=16)
            b2.feed_stream(cd, np.array([0, 5000], np.int64))
            k2, d2 = b2.finalize()
            u2, c2 = first_encounter_unique(km2)
            assert np.array_equal(k2, u2)
            assert np.array_equal(d2, c2)
            break


def test_sharded_build_non_pow2_w():
    """w=10 exercises the emulated-u64 modulo fallback (mod_is_zero) and the
    non-pow2 owner routing (div_mod_owner) against the host oracle."""
    rng = np.random.default_rng(33)
    sh = Seqhash.create(16, 10, 17)
    lens = rng.integers(50, 400, size=120)
    codes = np.concatenate([rng.integers(0, 4, size=l).astype(np.uint8)
                            for l in lens])
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    sc = ModimizerScanner(sh, chunk=1 << 12)
    kmers, _g, _f = sc.scan_stream(codes, offsets)
    uniq, counts = first_encounter_unique(kmers)
    b = ShardedModsetBuilder(sh, build_mesh(), chunk_per_dev=1 << 10,
                             state_size=1 << 12)
    b.feed_stream(codes, offsets)
    ks, ds = b.finalize()
    assert np.array_equal(ks, uniq)
    assert np.array_equal(ds, counts)


@pytest.mark.skipif(jax.device_count() < 2, reason="needs multiple devices")
def test_sharded_merge_clears_flags_of_new_entries():
    """modsetMerge's B pass runs info = (info & 3) | min(cA+cB, 3) on EVERY
    entry it lands on — so B-only kmers arrive with their flag bits
    CLEARED (fresh entry info is 0, modset.c:124-125), while A-only kmers
    keep full info.  Caught by fuzz_sharded trial 7 (round 3)."""
    from modimizer.core.modset import Modset
    from modimizer.parallel.sharded import sharded_merge
    sh_args = (16, 16, 17)
    ms_a = Modset(Seqhash.create(*sh_args), 20)
    ms_a.add_batch(np.array([11, 22, 33], np.uint64))
    ms_a.info[1:4] = [0x31, 0x02, 0x13]      # flags + copy bits
    ms_b = Modset(Seqhash.create(*sh_args), 20)
    ms_b.add_batch(np.array([22, 44], np.uint64))
    ms_b.info[1:3] = [0x21, 0x3A]            # 44 is new to A, has flags
    got = sharded_merge(ms_a, ms_b, build_mesh())
    assert ms_a.merge(ms_b)
    n = ms_a.max
    ks, ds, infos = got
    assert np.array_equal(ks, ms_a.value[1:n + 1])
    assert np.array_equal(ds, ms_a.depth[1:n + 1])
    assert np.array_equal(infos, ms_a.info[1:n + 1])


@pytest.mark.skipif(jax.device_count() < 2, reason="needs multiple devices")
@pytest.mark.parametrize("n_dev", [1, None])
def test_builder_snapshot_resume(tmp_path, n_dev):
    """Device-state snapshotting (SURVEY §5): save mid-stream, restore into
    a fresh builder, feed the rest — identical insertion stream to the
    uninterrupted build, on both the n=1 fast path and the full mesh."""
    rng = np.random.default_rng(31)
    sh = Seqhash.create(16, 16, 17)
    lens = rng.integers(50, 400, size=240)
    seqs = [rng.integers(0, 4, size=l).astype(np.uint8) for l in lens]
    codes = np.concatenate(seqs)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    mesh = build_mesh(n_devices=n_dev)
    kw = dict(chunk_per_dev=1 << 10, state_size=1 << 12)
    full = ShardedModsetBuilder(sh, mesh, **kw)
    full.feed_stream(codes, offsets)
    want_k, want_d = full.finalize()

    # split at a sequence boundary mid-stream
    cut_seq = 100
    cut = int(offsets[cut_seq])
    b1 = ShardedModsetBuilder(sh, mesh, **kw)
    b1.feed_stream(codes[:cut], offsets[:cut_seq + 1])
    snap = tmp_path / "build.snap"
    b1.save(str(snap), cursor=cut)

    b2, cursor = ShardedModsetBuilder.restore(str(snap), sh, mesh)
    assert cursor == cut
    assert b2.total_emitted == b1.total_emitted
    b2.feed_stream(codes[cursor:], offsets[cut_seq:] - cut, base=cursor)
    ks, ds = b2.finalize()
    assert np.array_equal(ks, want_k)
    assert np.array_equal(ds, want_d)


@pytest.mark.skipif(jax.device_count() < 2, reason="needs multiple devices")
def test_builder_snapshot_mismatch_errors(tmp_path):
    rng = np.random.default_rng(32)
    sh = Seqhash.create(16, 16, 17)
    codes = rng.integers(0, 4, size=3000).astype(np.uint8)
    offsets = np.array([0, 3000], np.int64)
    mesh = build_mesh()
    b = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << 10,
                             state_size=1 << 12)
    b.feed_stream(codes, offsets)
    snap = tmp_path / "s.snap"
    b.save(str(snap))
    with pytest.raises(ValueError, match="does not match"):
        ShardedModsetBuilder.restore(str(snap), Seqhash.create(17, 16, 17),
                                     mesh)
    with pytest.raises(ValueError, match="re-shard"):
        ShardedModsetBuilder.restore(str(snap), sh, build_mesh(n_devices=2))
