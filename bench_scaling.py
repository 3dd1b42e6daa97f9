"""Multi-GPU weak-scaling harness for the sharded modset build.

Measures the full sharded pipeline (per-device scan -> all_to_all routing
-> sorted segment-reduce merge) over 1, 2, 4 and 8-GPU meshes, as many as
the machine has.  Weak scaling: each device gets a fixed CHUNK of stream
positions per step, so perfect scaling keeps step time flat as n grows;
efficiency(n) = t(1 device) / t(n devices).

Exits non-zero unless JAX's devices are GPUs: a virtual CPU mesh shares
one host's cores, so its times say nothing about the interconnect (the CPU
rehearsal of the same path is __graft_entry__.dryrun_multichip).

Usage:  python bench_scaling.py
Prints one JSON line per mesh size plus one efficiency line per n > 1.
"""

import json
import time

import numpy as np

import modimizer

modimizer.configure_jax()
import jax  # noqa: E402

from modimizer.core.seqhash import Seqhash  # noqa: E402
from modimizer.parallel.sharded import (ShardedModsetBuilder,  # noqa: E402
                                        build_mesh)

CHUNK = 1 << 18          # positions per device per step
STEPS = 4                # timed steps
READ_LEN = 5000


def run(n_dev):
    sh = Seqhash.create(16, 16, 17)
    mesh = build_mesh(n_dev)
    total = n_dev * CHUNK * STEPS
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=total).astype(np.uint8)
    offsets = np.arange(0, total + 1, READ_LEN, dtype=np.int64)
    if offsets[-1] != total:
        offsets = np.concatenate([offsets, [total]])
    b = ShardedModsetBuilder(sh, mesh, chunk_per_dev=CHUNK,
                             state_size=1 << 22,
                             max_buffer_rows=1 << 23)
    # warm-up: one step's worth to compile
    b.feed_stream(codes[:n_dev * CHUNK], offsets[offsets <= n_dev * CHUNK])
    t0 = time.perf_counter()
    b.feed_stream(codes, offsets)
    jax.block_until_ready((b.state_k, b.state_d, b.state_m))
    dt = time.perf_counter() - t0
    # finalize outside the timed window: its sort/compact program compiles
    # on first use (seconds on the CPU mesh) and runs once per BUILD, not
    # per step — the weak-scaling claim is about the steady-state step
    ks, _ = b.finalize()
    return dt, total / dt / 1e6, len(ks)


def main():
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_scaling.py: JAX found no GPU (platform "
                         f"{jax.devices()[0].platform!r}); nothing measured")
    sizes = [n for n in (1, 2, 4, 8) if n <= jax.device_count()]
    times = {}
    for n in sizes:
        dt, rate, uniq = run(n)
        times[n] = dt
        print(json.dumps({"devices": n, "time_s": round(dt, 3),
                          "rate_mpos_s": round(rate, 1), "unique": uniq,
                          "kind": jax.devices()[0].device_kind}))
    for n in sizes[1:]:
        print(json.dumps({"metric": "weak_scaling_efficiency",
                          "devices": n,
                          "value": round(times[sizes[0]] / times[n], 3)}))


if __name__ == "__main__":
    main()
