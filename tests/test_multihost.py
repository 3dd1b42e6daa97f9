"""2-process jax.distributed loopback: multi-host sharded build == sequential.

This is the BASELINE config-4 path (per-host stream shards, one global mesh,
DCN collectives) exercised without hardware: two CPU processes with 4
virtual devices each form an 8-device mesh over the loopback coordinator.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); coord = sys.argv[2]; outdir = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
sys.path.insert(0, %(repo)r)
import numpy as np
import modimizer
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=pid)
assert jax.device_count() == 8 and len(jax.local_devices()) == 4
from modimizer.core.seqhash import Seqhash
from modimizer.parallel.multihost import MultiHostModsetBuilder
from modimizer.parallel.sharded import build_mesh

sh = Seqhash.create(16, 16, 17)
rng = np.random.default_rng(77)   # same stream on both hosts
lens = rng.integers(60, 400, size=120)
codes = rng.integers(0, 4, size=int(lens.sum())).astype(np.uint8)
offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
# split the global stream at a read boundary; SPLIT_READ controls how
# unevenly (uneven shards exercise the global step agreement)
SPLIT_READ = int(os.environ.get("MH_SPLIT_READ", "60"))
half = int(offsets[SPLIT_READ])
if pid == 0:
    my_codes, my_off, base = codes[:half], offsets[:SPLIT_READ + 1], 0
else:
    my_codes, my_off, base = (codes[half:], offsets[SPLIT_READ:] - half,
                              half)

mesh = build_mesh()
b = MultiHostModsetBuilder(sh, mesh, chunk_per_dev=1 << 11,
                           state_size=1 << 12)
if os.environ.get("MH_SNAPSHOT") == "1":
    # preemption drill: snapshot mid-stream (collective), restore into a
    # fresh builder in the same processes, finish the stream.  Each host
    # keeps its own local cursor; the snapshot file is on shared storage.
    from jax.experimental import multihost_utils
    cutr = (len(my_off) - 1) // 2
    cut = int(my_off[cutr])
    b.feed_stream(my_codes[:cut], my_off[:cutr + 1], base=base)
    snap = os.path.join(outdir, "build.snap")
    b.save(snap, cursor=base + cut)
    multihost_utils.sync_global_devices("snapshot written")
    b, _cur = MultiHostModsetBuilder.restore(snap, sh, mesh)
    b.feed_stream(my_codes[cut:], my_off[cutr:] - cut, base=base + cut)
else:
    b.feed_stream(my_codes, my_off, base=base)
ks, ds = b.finalize()
if pid == 0:
    np.savez(os.path.join(outdir, "mh.npz"), ks=ks, ds=ds)
print("WORKER", pid, "OK", len(ks))
"""


@pytest.mark.skipif(os.environ.get("MODIMIZER_SKIP_MULTIHOST") == "1",
                    reason="multihost test disabled")
@pytest.mark.parametrize("split_read,snapshot", [(60, False), (104, False),
                                                 (60, True)])
def test_two_process_build_matches_sequential(tmp_path, split_read, snapshot):
    """split 60 = even halves; split 104 = uneven shards with different
    per-host step counts (exercises the global step agreement); snapshot =
    mid-stream save + restore in both processes (SURVEY §5 device-state
    snapshotting for long multi-host runs)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER % {"repo": REPO})
    env = {**os.environ, "MH_SPLIT_READ": str(split_read),
           "MH_SNAPSHOT": "1" if snapshot else "0"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), coord, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for pid in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, (o.decode()[-500:], e.decode()[-1500:])

    got = np.load(tmp_path / "mh.npz")

    # sequential oracle over the SAME global stream
    from modimizer.core.seqhash import Seqhash
    from modimizer.ops.seqhash import (ModimizerScanner,
                                           first_encounter_unique)
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(77)
    lens = rng.integers(60, 400, size=120)
    codes = rng.integers(0, 4, size=int(lens.sum())).astype(np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    sc = ModimizerScanner(sh, chunk=1 << 12)
    kmers, _g, _f = sc.scan_stream(codes, offsets)
    uniq, counts = first_encounter_unique(kmers)
    assert np.array_equal(got["ks"], uniq)
    assert np.array_equal(got["ds"], counts)
