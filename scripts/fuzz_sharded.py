"""Mesh-path differential fuzzer: sharded build / merge / lookup vs the
sequential oracles on randomized parameters over 1/2/4/8 virtual CPU
devices.

Randomizes k, w (incl. non-pow2), seed, read layouts (incl. overflow-
forcing low-complexity runs), builder chunk/state/cap sizes chosen to
force the widen-and-replay, state-grow and buffer-compaction paths, mesh
size — and checks exact equality with the host scan + first-encounter
oracle (feed_stream), the native modsetMerge (sharded_merge), and the
open-addressed probe table (DeviceTable.find).

Usage: python scripts/fuzz_sharded.py [iters=30] [seed=0] [--multihost]
`--multihost` additionally runs the 2-process jax.distributed loopback
builder (tests/test_multihost.py machinery) on a random split.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           ).strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import modimizer

modimizer.configure_jax()

import jax

jax.config.update("jax_platforms", "cpu")

from modimizer.core.modset import Modset
from modimizer.core.seqhash import Seqhash
from modimizer.ops.seqhash import (ModimizerScanner,
                                       first_encounter_unique)
from modimizer.parallel.lookup import DeviceTable
from modimizer.parallel.sharded import (BLK, ShardedModsetBuilder,
                                            build_mesh, sharded_merge)


def rand_stream(rng, overflow_bias):
    """Random read layout; with overflow_bias, inject low-complexity runs
    (kmer 0 hashes to 0 -> emits at every position -> block overflow)."""
    n_reads = int(rng.integers(1, 40))
    lens = rng.integers(30, 1200, n_reads)
    codes = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    if overflow_bias and len(codes) > 200:
        s = int(rng.integers(0, len(codes) - 150))
        codes[s:s + 150] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return codes, offsets


BACKENDS = ["onehot", "onehot_i8", "twolevel", "twolevel_i8",
            "butterfly", "gather", "searchcmp", "posgather",
            "posgather_cmp", "fused", "fusedb", "fusedc", "fusedd",
            "fusedd"]  # fusedd over-weighted: it is the shipped default


def trial_build(rng, trial):
    k = int(rng.integers(11, 32))
    w = int(rng.choice([2, 3, 5, 8, 10, 16, 31, 63, 64]))
    seed = int(rng.integers(1, 1000))
    sh = Seqhash.create(k, w, seed)
    n_dev = int(rng.choice([1, 2, 4, 8]))
    # compact_backend_default() reads the env per call, so the backend can
    # vary per trial (BLK is frozen at import — sweep it from the shell)
    be = str(rng.choice(BACKENDS))
    os.environ["MODIMIZER_COMPACT"] = be
    fr = str(rng.choice(["funnel64", "u32"]))   # u32 applies when k <= 16
    os.environ["MODIMIZER_FRONT"] = fr
    codes, offsets = rand_stream(rng, overflow_bias=rng.random() < 0.4)
    # chunk sizes straddle the fused-family stripe gate C >= 32*BLK
    # (round 4's latent ipb = NW//BLK = 0 bug lived exactly at this
    # boundary): small posmajor-forced chunks, just-below, at, and above
    chunk = int(rng.choice([BLK, 2 * BLK, 3 * BLK, 4 * BLK, 31 * BLK,
                            32 * BLK, 64 * BLK]))
    state = int(rng.choice([1 << 8, 1 << 10, 1 << 14]))
    cap = int(rng.choice([64, 256, 0])) or None
    b = ShardedModsetBuilder(sh, build_mesh(n_dev), chunk_per_dev=chunk,
                             state_size=state, cap=cap,
                             max_buffer_rows=int(rng.choice([1 << 12,
                                                             1 << 20])))
    b.feed_stream(codes, offsets)
    ks, ds = b.finalize()
    host = ModimizerScanner(sh, host_threshold=1 << 62)
    km = host.scan_kmers(codes, offsets)
    wk, wd = first_encounter_unique(km)
    assert np.array_equal(ks, wk), \
        f"trial {trial}: kmers diverge (n_dev={n_dev} k={k} w={w})"
    assert np.array_equal(ds, np.minimum(wd, 0xFFFF)), \
        f"trial {trial}: depths diverge (n_dev={n_dev} k={k} w={w})"
    assert b.total_emitted == len(km)
    return (f"build n_dev={n_dev} k={k} w={w} be={be} fr={fr} "
            f"n={len(codes)} uniq={len(ks)}")


def trial_merge(rng, trial):
    k = int(rng.integers(11, 32))
    w = int(rng.choice([4, 16, 31]))
    sh_args = (k, w, int(rng.integers(1, 100)))

    def mk(seedval, n_km):
        r = np.random.default_rng(seedval)
        km = np.unique(r.integers(1, 1 << min(2 * k, 40), n_km,
                                  dtype=np.uint64))
        r.shuffle(km)
        ms = Modset(Seqhash.create(*sh_args), 20)
        ms.add_batch(km, r.integers(1, 70000, len(km)).astype(np.uint32))
        ms.info[1:ms.max + 1] = r.integers(0, 64, ms.max).astype(np.uint8)
        return ms

    shared = int(rng.integers(0, 500))
    ms_a, ms_b = mk(shared, int(rng.integers(1, 3000))), \
        mk(shared, int(rng.integers(1, 2000)))
    if rng.random() < 0.5:
        ms_b.merge(mk(shared + 7, 500))
    n_dev = int(rng.choice([2, 4, 8]))
    got = sharded_merge(ms_a, ms_b, build_mesh(n_dev))
    assert ms_a.merge(ms_b)   # native oracle mutates ms_a
    n = ms_a.max
    ks, ds, infos = got
    assert np.array_equal(ks, ms_a.value[1:n + 1]), f"trial {trial} merge k"
    assert np.array_equal(ds, ms_a.depth[1:n + 1]), f"trial {trial} merge d"
    assert np.array_equal(infos, ms_a.info[1:n + 1]), f"trial {trial} merge i"
    return f"merge n_dev={n_dev} k={k} entries={n}"


def trial_lookup(rng, trial):
    k = int(rng.integers(11, 32))
    sh = Seqhash.create(k, 16, int(rng.integers(1, 100)))
    r = np.random.default_rng(int(rng.integers(0, 1 << 30)))
    kmers = np.unique(r.integers(0, 1 << min(2 * k, 40),
                                 int(rng.integers(2, 20000)),
                                 dtype=np.uint64))
    r.shuffle(kmers)
    ms = Modset(sh, 20)
    ms.add_batch(kmers)
    n_dev = int(rng.choice([1, 2, 4, 8]))
    dt = DeviceTable(ms.value[1:ms.max + 1],
                     np.arange(1, ms.max + 1, dtype=np.uint32), sh,
                     build_mesh(n_dev))
    nq = int(rng.integers(1, 5000))
    q = np.concatenate([r.choice(kmers, nq),
                        r.integers(0, 1 << min(2 * k, 41), nq
                                   ).astype(np.uint64)])
    r.shuffle(q)
    got = dt.find(q)
    want = ms.find_batch(q)
    assert np.array_equal(got, want), f"trial {trial}: lookup diverges"
    return f"lookup n_dev={n_dev} k={k} nq={len(q)}"


def trial_multihost(rng, trial):
    import subprocess
    env = {**os.environ, "MH_SPLIT_READ": str(int(rng.integers(10, 110)))}
    r = subprocess.run(
        [sys.executable, "-m", "pytest",
         os.path.join(os.path.dirname(os.path.dirname(
             os.path.abspath(__file__))), "tests", "test_multihost.py"),
         "-x", "-q"], capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stdout[-2000:]
    return f"multihost split={env['MH_SPLIT_READ']}"


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    iters = int(args[0]) if len(args) > 0 else 30
    seed = int(args[1]) if len(args) > 1 else 0
    multihost = "--multihost" in sys.argv
    rng = np.random.default_rng(seed)
    kinds = [trial_build, trial_merge, trial_lookup]
    for t in range(iters):
        fn = kinds[t % len(kinds)]
        msg = fn(rng, t)
        print(f"[{t + 1}/{iters}] OK {msg}", flush=True)
    if multihost:
        print(trial_multihost(rng, iters), "OK", flush=True)
    print(f"fuzz_sharded: {iters} trials green "
          f"(seed {seed}{', +multihost' if multihost else ''})")


if __name__ == "__main__":
    main()
