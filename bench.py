"""Modset-build benchmark on one NVIDIA GPU.

Checks for the GPU first (exits non-zero without one, before any data is
generated), then on a seeded synthetic read set (200 Mbp of 1 kb reads,
k=16 w=16 — BASELINE config 1 shape):

- the device step rate: the n=1 builder's scan+compact program on
  device-resident data, timed per call with block_until_ready;
- the end-to-end streamed build (parse + device scan + exact host table
  replay), checked against the in-repo host oracle on the same data: unique
  count and .mod bytes must be identical.

Prints one JSON line with the device (platform, kind, count), the card's
name and power limit, and both rates.  Benchmark cells and the trace
reduction are not defined here yet.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BENCH_DIR = Path(os.environ.get("MODIMIZER_BENCH_DIR",
                                os.path.join(REPO, ".smoke_work", "bench")))
N_READS = int(os.environ.get("BENCH_READS", 200_000))
READ_LEN = int(os.environ.get("BENCH_READ_LEN", 1000))
K, W, SEED, BITS = 16, 16, 17, 26
STEP_CHUNK = 1 << 23
REPS = 20


def log(msg):
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def require_gpu():
    """Device description; raises SystemExit unless JAX's backend is a GPU."""
    import modimizer
    modimizer.configure_jax()
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py: JAX found no GPU (platform "
                         f"{devs[0].platform!r}); nothing measured")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    card = r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card}
    log(f"device: {info}")
    return info


def make_data() -> Path:
    import numpy as np
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    fa = BENCH_DIR / f"reads_{N_READS}x{READ_LEN}.fa"
    if fa.exists():
        return fa
    log(f"generating {N_READS}x{READ_LEN}bp synthetic reads ...")
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(fa, "wb") as f:
        for s in range(0, N_READS, 10_000):
            n = min(10_000, N_READS - s)
            arr = bases[rng.integers(0, 4, size=(n, READ_LEN))]
            f.write(b"".join(b">r%d\n%s\n" % (s + i, arr[i].tobytes())
                             for i in range(n)))
    return fa


def step_rate(sh):
    """Positions/s of the builder's scan+compact step on resident data."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from modimizer.ops.packed import pack_bits, pack_sw
    from modimizer.parallel.sharded import (ShardedModsetBuilder,
                                            _scan_compact_local, build_mesh)
    b = ShardedModsetBuilder(sh, build_mesh(1), chunk_per_dev=STEP_CHUNK)
    C = b.chunk
    codes = np.random.default_rng(1).integers(0, 4, C + K - 1, np.uint8)
    sw = jnp.asarray(pack_sw(codes, C // 32 + 2))
    vb = jnp.asarray(pack_bits(np.ones(C, bool), C // 64))
    kw = dict(k=K, w=W, factor1=sh.factor1, C=C, bo=b.bo)
    t0 = time.perf_counter()
    compiled = _scan_compact_local.lower(sw, vb, **kw).compile()
    log(f"step compile {time.perf_counter() - t0:.2f} s")
    jax.block_until_ready(compiled(sw, vb))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(sw, vb))
        times.append(time.perf_counter() - t0)
    best = min(times)
    log(f"step: {best * 1e3:.3f} ms min, "
        f"{sum(times) / len(times) * 1e3:.3f} ms mean per {C} positions")
    return C / best


def build_mod(sh, fa, out, device):
    """Streamed modutils -a equivalent; returns (kmers, unique, seconds)."""
    from modimizer.core.modset import Modset
    from modimizer.io import seqio
    from modimizer.io.stream_seq import iter_fasta_batches
    from modimizer.ops.seqhash import ModimizerScanner
    sc = ModimizerScanner(sh, host_threshold=0 if device else 1 << 62)
    ms = Modset(sh, BITS)
    t0 = time.perf_counter()
    if device:
        n_km = sc.scan_kmers_batches(
            iter_fasta_batches(str(fa), seqio.dna2index_n0()),
            consumer=ms.add_batch)
    else:
        batch, _t = seqio.read_seq_file(str(fa), seqio.dna2index_n0(),
                                        is_qual=False, want_ids=False)
        n_km = sc.scan_kmers(batch.codes, batch.offsets,
                             consumer=ms.add_batch)
    dt = time.perf_counter() - t0
    ms.write(str(out))
    if device:
        assert sc.n_fallback == 0, "host fallback on random data"
    return n_km, ms.max, dt


def main():
    info = require_gpu()
    fa = make_data()
    from modimizer.core.seqhash import Seqhash
    sh = Seqhash.create(K, W, SEED)
    chip = step_rate(sh)
    # warm the streamed feed's programs on a throwaway copy of the data
    build_mod(sh, fa, BENCH_DIR / "warm.mod", device=True)
    n_km, uniq, dt = build_mod(sh, fa, BENCH_DIR / "dev.mod", device=True)
    n_h, uniq_h, dt_h = build_mod(sh, fa, BENCH_DIR / "host.mod",
                                  device=False)
    same = ((BENCH_DIR / "dev.mod").read_bytes()
            == (BENCH_DIR / "host.mod").read_bytes())
    if not (same and n_km == n_h and uniq == uniq_h):
        raise SystemExit(f"device build diverged from the host oracle: "
                         f"{uniq} vs {uniq_h} unique, .mod equal {same}")
    positions = N_READS * (READ_LEN - K + 1)
    log(f"e2e: {dt:.2f} s device, {dt_h:.2f} s host oracle; {n_km} kmers, "
        f"{uniq} unique, .mod identical")
    print(json.dumps({"metric": "modset_build_kmer_throughput",
                      "value": chip, "unit": "kmers/s",
                      "e2e_kmers_per_s": positions / dt,
                      "host_e2e_kmers_per_s": positions / dt_h,
                      "unique": uniq, "device": info}))


if __name__ == "__main__":
    main()
