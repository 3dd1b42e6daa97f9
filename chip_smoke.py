#!/usr/bin/env python3
"""GPU smoke test: run modutils, modmap and modasm on one NVIDIA GPU through
their normal entry points and prove every device result equal to the native
host path, the repository's plain reference (tolerance 0: integer equality
of k-mers, positions and output bytes).

    python chip_smoke.py            # one GPU: steps, A/B, CLI phases, pytest -m gpu
    python chip_smoke.py --four     # four GPUs: sharded build, merge, lookup

Phases run one at a time in child processes (``--phase NAME``), so the
parent never holds a JAX client while a CLI child uses the card.  The last
line of stdout, on success only, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the preflight fails and the script exits non-zero.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# step shapes: (k, w) x chunk positions; (19, 31) is the reference's
# default and takes the u64 wide-k compaction path
STEP_KW = ((16, 16), (19, 31))
STEP_CLOG = (23, 25)
AB_BACKENDS = ("fusedd", "onehot_i8", "gather")
AB_DENSIFY = ("search", "roll2")
# CLI data sizes in bases (BASELINE.json configs 1, 3 and 5, shapes kept)
SIZES = {
    "reads_bp": 200_000_000,     # 1 kb reads, config 1
    "stream_bp": 24_000_000,     # under the device-count threshold
    "ref_bp": 64_000_000,        # chr20 length, config 3
    "query_bp": 20_000_000,      # 10 kb queries, 1% substitutions
    "genome5_bp": 5_000_000,     # config 5 genome
    "lr_bp": 150_000_000,        # 20 kb reads at 30x
}
RESULT_TAG = "SMOKE-PHASE-RESULT "


def say(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- helpers
# (imported by tests/test_chip_smoke.py; jax is imported lazily)

def random_stream(n, read_len, seed):
    """(codes u8 [n], offsets i64): random bases cut into read_len reads."""
    import numpy as np
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    offsets = np.arange(0, n, read_len, dtype=np.int64)
    offsets = np.append(offsets, np.int64(n))
    return codes, offsets


def host_scan(sh, codes, offsets):
    """The plain reference: native host scan (kmers, positions, isF)."""
    from modimizer.ops.seqhash import ModimizerScanner
    return ModimizerScanner(sh, host_threshold=1 << 62)._scan_host(
        codes, offsets)


def check_scanner_paths(sh, codes, offsets, chunk, oracle=None):
    """Run the three production scan programs at `chunk` positions through
    ModimizerScanner and require equality with the host oracle:
    scan_kmers_batches (streamed modutils -a: _scan_chunk_kmers_sparse_scan),
    scan_kmers (whole-file modutils -a: _scan_chunk_kmers[_sparse]) and
    scan_stream (modmap / modasm: _scan_chunk).  Returns counters."""
    import numpy as np
    from modimizer.ops.seqhash import ModimizerScanner
    km_h, pos_h, isf_h = oracle if oracle is not None else host_scan(
        sh, codes, offsets)
    sc = ModimizerScanner(sh, chunk=chunk, host_threshold=0)
    t0 = time.perf_counter()
    a = sc.scan_kmers_batches([(codes, offsets)])
    t1 = time.perf_counter()
    b = sc.scan_kmers(codes, offsets)
    t2 = time.perf_counter()
    km, pos, isf = sc.scan_stream(codes, offsets)
    t3 = time.perf_counter()
    assert sc.used_device
    assert np.array_equal(a, km_h), "scan_kmers_batches != host oracle"
    assert np.array_equal(b, km_h), "scan_kmers != host oracle"
    assert np.array_equal(km, km_h), "scan_stream kmers != host oracle"
    assert np.array_equal(pos, pos_h), "scan_stream positions != host oracle"
    assert np.array_equal(isf, isf_h), "scan_stream isF != host oracle"
    return {"emits": int(len(km_h)), "n_wide": sc.n_wide,
            "n_fallback": sc.n_fallback, "bo": sc.bo, "cap": sc.cap,
            "wall_s": {"scan_kmers_batches": t1 - t0, "scan_kmers": t2 - t1,
                       "scan_stream": t3 - t2}}


def check_builder(sh, codes, offsets, mesh, oracle_kmers, **kw):
    """ShardedModsetBuilder feed + finalize == first-encounter unique of the
    host oracle's k-mer stream (kmers and saturating depths)."""
    import numpy as np
    from modimizer.ops.seqhash import first_encounter_unique
    from modimizer.parallel.sharded import ShardedModsetBuilder
    b = ShardedModsetBuilder(sh, mesh, **kw)
    t0 = time.perf_counter()
    b.feed_stream(codes, offsets)
    t1 = time.perf_counter()
    ks, ds = b.finalize()
    t2 = time.perf_counter()
    uq, ct = first_encounter_unique(oracle_kmers)
    assert np.array_equal(ks, uq), "builder kmers != host oracle"
    assert np.array_equal(ds, np.minimum(ct, 0xFFFF)), \
        "builder depths != host oracle"
    assert b.total_emitted == len(oracle_kmers)
    return {"unique": int(len(ks)), "n_replay": b.n_replay,
            "chunk": b.chunk, "feed_s": t1 - t0, "finalize_s": t2 - t1}


def chunk_inputs(sh, codes, offsets, chunk):
    """Packed words and dense validity words of the first chunk."""
    import numpy as np
    from modimizer.native import lib as native_lib
    from modimizer.ops.seqhash import ModimizerScanner
    k = sh.k
    seg = codes[:chunk + k - 1]
    sw = ModimizerScanner._pack_native(seg, chunk // 32 + 2)
    m = min(chunk, len(codes))
    oo = np.ascontiguousarray(np.clip(offsets, 0, len(seg)))
    nwb = (chunk + k - 1 + 63) // 64
    vw = np.zeros(nwb, np.uint64)
    native_lib().pk_valid_words(oo, len(oo) - 1, len(seg), k, vw, nwb)
    return sw, vw[:chunk // 64], m


@contextlib.contextmanager
def env_set(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: v for k, v in kv.items() if v is not None})
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def kmers_step(sh, chunk, backend=None, densify=None):
    """A freshly traced copy of the kmers-only chunk program
    (device_scan._scan_kmers_body) under one compaction backend and densify
    mode; returns (compiled, compile seconds) for inputs (sw, vbits)."""
    import functools
    import jax
    import numpy as np
    from modimizer.ops.device_scan import _scan_kmers_body
    from modimizer.ops.seqhash import ModimizerScanner
    sc = ModimizerScanner(sh, chunk=chunk)
    fn = jax.jit(functools.partial(
        _scan_kmers_body, k=sh.k, w=sh.w, factor1=sh.factor1, bo=sc.bo,
        cap=sc.cap))
    sw = jax.ShapeDtypeStruct((chunk // 32 + 2,), np.uint64)
    vw = jax.ShapeDtypeStruct((chunk // 64,), np.uint64)
    with env_set(MODIMIZER_COMPACT=backend, MODIMIZER_DENSIFY=densify):
        t0 = time.perf_counter()
        compiled = fn.lower(sw, vw).compile()
        return compiled, time.perf_counter() - t0


def time_compiled(compiled, args, reps):
    """Per-call milliseconds of `compiled` (each call ends in
    block_until_ready; one untimed warm call first)."""
    import jax
    jax.block_until_ready(compiled(*args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def check_kmers_step(compiled, args, oracle_kmers, m):
    """The chunk program's rows equal the oracle's emits below m."""
    import numpy as np
    km, tot = compiled(*args)
    tot = int(tot)
    assert tot >= 0, "chunk overflowed on random data"
    got = np.asarray(km)[:tot].astype(np.uint64)
    assert np.array_equal(got, oracle_kmers), "kmers step != host oracle"
    return tot


def mem_analysis(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {f: getattr(ma, f) for f in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, f)}


def peak_bytes(dev):
    st = dev.memory_stats()
    return None if not st else st.get("peak_bytes_in_use")


# ----------------------------------------------------------------- phases

def phase_preflight(args):
    import modimizer
    modimizer.configure_jax()
    import jax
    devs = jax.devices()
    plat = devs[0].platform
    say(f"jax {jax.__version__}  platform {plat}  device_kind "
        f"{devs[0].device_kind!r}  count {len(devs)}")
    say(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}  "
        f"compile cache {modimizer.jax_cache_dir()}")
    if plat != "gpu":
        raise SystemExit(f"preflight: JAX found no GPU (platform {plat!r})")
    need = 4 if args.four else 1
    if len(devs) < need:
        raise SystemExit(f"preflight: {need} devices needed, {len(devs)}")
    return {"platform": plat, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_steps(args):
    """Per-chunk programs at real widths vs the host oracle, with compile
    seconds, memory analysis, peak device memory and step ms."""
    import modimizer
    modimizer.configure_jax()
    import jax
    import jax.numpy as jnp
    from modimizer.core.seqhash import Seqhash
    from modimizer.ops.device_scan import _scan_chunk_kmers
    from modimizer.ops.seqhash import ModimizerScanner
    from modimizer.parallel.sharded import build_mesh
    dev = jax.devices()[0]
    clogs = STEP_CLOG
    reps = 10
    res = {}
    for k, w in STEP_KW:
        sh = Seqhash.create(k, w, 17)
        n = (1 << max(clogs)) + 12345
        codes, offsets = random_stream(n, 1000, seed=k * 100 + w)
        oracle = host_scan(sh, codes, offsets)
        for clog in clogs:
            C = 1 << clog
            tag = f"k={k} w={w} C=2^{clog}"
            r = check_scanner_paths(sh, codes, offsets, C, oracle)
            assert r["n_fallback"] == 0, (tag, r)
            # the production kmers step, timed alone on resident inputs
            sc = ModimizerScanner(sh, chunk=C)
            sw, vw, m = chunk_inputs(sh, codes, offsets, C)
            dargs = (jnp.asarray(sw), jnp.asarray(vw))
            kw = dict(k=k, w=w, factor1=sh.factor1, bo=sc.bo, cap=sc.cap)
            t0 = time.perf_counter()
            compiled = _scan_chunk_kmers.lower(*dargs, **kw).compile()
            comp_s = time.perf_counter() - t0
            ok_m = oracle[1] < m
            check_kmers_step(compiled, dargs, oracle[0][ok_m], m)
            ms = time_compiled(compiled, dargs, reps)
            r.update(compile_s=comp_s, memory=mem_analysis(compiled),
                     step_ms_min=min(ms), step_ms_mean=sum(ms) / len(ms),
                     peak_bytes=peak_bytes(dev))
            say(f"[steps] {tag}: equal to host oracle on "
                f"{r['emits']} emits (n_wide {r['n_wide']}, n_fallback "
                f"{r['n_fallback']}); kmers step compile {comp_s:.2f} s, "
                f"{min(ms):.3f} ms min / {r['step_ms_mean']:.3f} ms mean "
                f"over {reps}; memory {r['memory']}; peak_bytes_in_use "
                f"{r['peak_bytes']}; feed walls "
                + ", ".join(f"{a} {b:.2f} s" for a, b in r["wall_s"].items()))
            res[tag] = r
        # builder n=1 feed + finalize on the same stream
        t0 = time.perf_counter()
        br = check_builder(sh, codes, offsets, build_mesh(1), oracle[0])
        say(f"[steps] builder k={k} w={w} n=1: {br['unique']} unique equal "
            f"to host oracle (n_replay {br['n_replay']}); feed "
            f"{br['feed_s']:.2f} s, finalize {br['finalize_s']:.2f} s, "
            f"wall {time.perf_counter() - t0:.2f} s; peak_bytes_in_use "
            f"{peak_bytes(dev)}")
        res[f"builder k={k} w={w}"] = br
    return res


def phase_ab(args):
    """Compaction backend and densify A/B on the kmers step: every
    candidate must equal the host oracle before it is timed; candidates are
    timed one after another in this process."""
    import modimizer
    modimizer.configure_jax()
    import jax.numpy as jnp
    from modimizer.core.seqhash import Seqhash
    from modimizer.ops.device_scan import densify_default
    from modimizer.parallel.sharded import compact_backend_default
    clogs = STEP_CLOG
    reps = 10
    res = {}
    for k, w in STEP_KW:
        sh = Seqhash.create(k, w, 17)
        for clog in clogs:
            C = 1 << clog
            codes, offsets = random_stream(C, 1000, seed=k * 100 + w)
            km_h, pos_h, _ = host_scan(sh, codes, offsets)
            sw, vw, m = chunk_inputs(sh, codes, offsets, C)
            dargs = (jnp.asarray(sw), jnp.asarray(vw))
            want = km_h[pos_h < m]
            cands = [(be, densify_default()) for be in AB_BACKENDS]
            cands += [(compact_backend_default(), d) for d in AB_DENSIFY
                      if d != densify_default()]
            for be, dn in cands:
                compiled, comp_s = kmers_step(sh, C, be, dn)
                check_kmers_step(compiled, dargs, want, m)
                ms = time_compiled(compiled, dargs, reps)
                tag = f"k={k} w={w} C=2^{clog} {be}/{dn}"
                res[tag] = {"compile_s": comp_s, "ms_min": min(ms),
                            "ms_mean": sum(ms) / len(ms)}
                say(f"[ab] {tag}: equal to host oracle; compile "
                    f"{comp_s:.2f} s; {min(ms):.3f} ms min / "
                    f"{sum(ms) / len(ms):.3f} ms mean over {reps}")
    return res


def phase_pytest(args):
    env = dict(os.environ, MODIMIZER_TEST_GPU="1")
    cmd = [sys.executable, "-m", "pytest", "tests/", "-m", "gpu", "-q",
           "-p", "no:cacheprovider", "-rs"]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True)
    tail = r.stdout[-3000:]
    say(tail)
    assert r.returncode == 0, f"pytest -m gpu rc {r.returncode}"
    assert " skipped" not in tail.splitlines()[-1], \
        "gpu tests skipped on the card"
    return {"rc": r.returncode, "summary": tail.splitlines()[-1]}


def phase_four(args):
    """Four-GPU path only: sharded build over build_mesh(4), sharded merge
    and sharded DeviceTable.find, each exact against the host oracle."""
    import modimizer
    modimizer.configure_jax()
    import jax
    import numpy as np
    from modimizer.core.modset import Modset
    from modimizer.core.seqhash import Seqhash
    from modimizer.parallel.lookup import DeviceTable
    from modimizer.parallel.sharded import build_mesh, sharded_merge
    n_bp = SIZES["reads_bp"]
    mesh = build_mesh(4)
    sh = Seqhash.create(16, 16, 17)
    codes, offsets = random_stream(n_bp, 1000, seed=4)
    t0 = time.perf_counter()
    oracle = host_scan(sh, codes, offsets)[0]
    say(f"[four] host oracle: {len(oracle)} emits in "
        f"{time.perf_counter() - t0:.2f} s")
    from modimizer.ops.seqhash import first_encounter_unique
    from modimizer.parallel.sharded import ShardedModsetBuilder
    b = ShardedModsetBuilder(sh, mesh)
    t0 = time.perf_counter()
    b.feed_stream(codes, offsets)
    b._compact()
    jax.block_until_ready(b.state_k)
    t_feed = time.perf_counter() - t0
    per_dev = []
    for shard in b.state_k.addressable_shards:
        rows = int(np.sum(np.asarray(shard.data) != 0xFFFFFFFFFFFFFFFF))
        st = shard.device.memory_stats() or {}
        per_dev.append((str(shard.device), rows, st.get("bytes_in_use"),
                        st.get("peak_bytes_in_use")))
        say(f"[four] {shard.device}: {rows} state rows, bytes_in_use "
            f"{st.get('bytes_in_use')}, peak_bytes_in_use "
            f"{st.get('peak_bytes_in_use')}")
    assert len({d for d, *_ in per_dev}) == 4, "state not on four devices"
    assert all(r > 0 for _, r, *_ in per_dev), "a device holds no state"
    ks, ds = b.finalize()
    uq, ct = first_encounter_unique(oracle)
    assert np.array_equal(ks, uq), "4-GPU build kmers != host oracle"
    assert np.array_equal(ds, np.minimum(ct, 0xFFFF)), \
        "4-GPU build depths != host oracle"
    say(f"[four] sharded build: {len(ks)} unique equal to host oracle; feed "
        f"+ compact {t_feed:.2f} s; n_replay {b.n_replay}")
    ms_a = Modset(sh, 28)
    ms_a.add_batch(ks, ds)
    ms_b = Modset(Seqhash.create(16, 16, 17), 28)
    ms_b.add_batch(ks[::2].copy(), ds[::2].copy())
    t0 = time.perf_counter()
    mk, md, mi = sharded_merge(ms_a, ms_b, mesh)
    t_merge = time.perf_counter() - t0
    assert ms_a.merge(ms_b)
    assert np.array_equal(mk, ms_a.value[1:ms_a.max + 1]), "merge kmers"
    assert np.array_equal(md, ms_a.depth[1:ms_a.max + 1]), "merge depths"
    assert np.array_equal(mi, ms_a.info[1:ms_a.max + 1]), "merge info"
    say(f"[four] sharded merge: {len(mk)} entries equal to the host merge; "
        f"{t_merge:.2f} s")
    t0 = time.perf_counter()
    table = DeviceTable(ms_a.value[1:ms_a.max + 1],
                        np.arange(1, ms_a.max + 1, dtype=np.uint32),
                        ms_a.hasher, mesh)
    q = np.concatenate([ks[::3], ks[:100000] ^ np.uint64(0x5A5A5A5)])
    got = table.find(q)
    t_find = time.perf_counter() - t0
    assert np.array_equal(got, ms_a.find_batch(q)), "sharded find"
    say(f"[four] sharded DeviceTable.find: {len(q)} queries equal to the "
        f"host table; {t_find:.2f} s")
    return {"unique": int(len(ks)), "per_device": per_dev,
            "feed_s": t_feed, "merge_s": t_merge, "find_s": t_find}


PHASES = {"preflight": phase_preflight, "steps": phase_steps,
          "ab": phase_ab, "pytest": phase_pytest, "four": phase_four}


# ------------------------------------------------------------- CLI phases

def _fasta_lines(codes2d, start_id, prefix):
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = acgt[codes2d]
    rows = []
    for i in range(len(seqs)):
        rows.append(b">%s%d\n" % (prefix.encode(), start_id + i))
        rows.append(seqs[i].tobytes())
        rows.append(b"\n")
    return b"".join(rows)


def write_random_reads(path, n_bp, read_len, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    n = n_bp // read_len
    with open(path, "wb") as f:
        for s in range(0, n, 10000):
            m = min(10000, n - s)
            f.write(_fasta_lines(
                rng.integers(0, 4, (m, read_len), dtype=np.uint8), s, "r"))


def write_sampled_reads(path, genome, n_bp, read_len, err, seed):
    """Reads drawn from `genome` (u8 codes), both strands, with `err`
    substitutions per base."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = n_bp // read_len
    starts = rng.integers(0, len(genome) - read_len, n)
    with open(path, "wb") as f:
        for s in range(0, n, 1000):
            m = min(1000, n - s)
            idx = starts[s:s + m, None] + np.arange(read_len)
            r = genome[idx]
            sub = rng.random(r.shape) < err
            r = np.where(sub, (r + rng.integers(1, 4, r.shape,
                                                dtype=np.uint8)) % 4, r)
            flip = rng.random(m) < 0.5
            r[flip] = 3 - r[flip, ::-1]
            f.write(_fasta_lines(r.astype(np.uint8), s, "q"))


def make_data(work, sizes):
    import numpy as np
    t0 = time.perf_counter()
    write_random_reads(f"{work}/reads.fa", sizes["reads_bp"], 1000, 1)
    write_random_reads(f"{work}/stream.fa", sizes["stream_bp"], 1000, 2)
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, sizes["ref_bp"], dtype=np.uint8)
    with open(f"{work}/ref.fa", "wb") as f:
        f.write(b">chr20\n" + np.frombuffer(b"ACGT", np.uint8)[ref].tobytes()
                + b"\n")
    write_sampled_reads(f"{work}/q.fa", ref, sizes["query_bp"], 10000,
                        0.01, 4)
    g5 = rng.integers(0, 4, sizes["genome5_bp"], dtype=np.uint8)
    write_sampled_reads(f"{work}/lr.fa", g5, sizes["lr_bp"], 20000, 0.001, 5)
    say(f"[data] generated from seeds in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v}" for k, v in sizes.items()))


def strip_timing(text):
    return "".join(ln for ln in text.splitlines(keepends=True)
                   if not ln.startswith(("user\t", "total resources used: ")))


CLI_PHASES = [
    # name, [(tool, argv)], output files compared, route lines required
    # (a tuple: any one of them)
    ("modutils k16 200M device-count",
     [("modutils", ["-c", "28", "16", "16", "17", "-a", "reads.fa",
                    "-w", "X.mod"])], ["X.mod"], ["modset_build device"]),
    ("modutils k16 streamed",
     [("modutils", ["-c", "28", "16", "16", "17", "-a", "stream.fa",
                    "-w", "S.mod"])], ["S.mod"], ["scan_kmers_batches device"]),
    ("modutils k19 w31 200M device-count",
     [("modutils", ["-c", "30", "19", "31", "17", "-a", "reads.fa",
                    "-w", "Z.mod"])], ["Z.mod"], ["modset_build device"]),
    ("modmap -K 24 -q",
     [("modmap", ["-K", "24", "-f", "ref.fa", "-q", "q.fa"])], [],
     ["scan_stream device", "lookup device"]),
    ("modutils + modasm -S -b -c",
     [("modutils", ["-c", "24", "16", "16", "17", "-a", "lr.fa",
                    "-s", "12", "45", "68", "-w", "L.mod"]),
      ("modasm", ["-m", "L.mod", "-f", "lr.fa", "-S", "-b", "-c"])],
     ["L.mod"], [("modset_build device", "scan_kmers_batches device"),
                 "scan_stream device", "overlaps device"]),
]


def run_cli_phase(name, cmds, files, need, data, work, card):
    """Each command twice — device route (default policy, route log on)
    and MODIMIZER_SCAN=host / MODIMIZER_OVERLAPS=host — in its own work
    directory; stdout (timing lines dropped) and files must be identical."""
    outs = {}
    walls = {}
    logs = ""
    for side in ("device", "host"):
        d = os.path.join(work, side)
        os.makedirs(d, exist_ok=True)
        env = dict(os.environ, MODIMIZER_ROUTE_LOG="1")
        if side == "host":
            env.update(MODIMIZER_SCAN="host", MODIMIZER_OVERLAPS="host")
        text = ""
        t0 = time.perf_counter()
        for tool, argv in cmds:
            argv = [os.path.join(data, a) if a.endswith(".fa") else a
                    for a in argv]
            r = subprocess.run([sys.executable,
                                os.path.join(REPO, "bin", tool)] + argv,
                               cwd=d, env=env, capture_output=True, text=True)
            if r.returncode != 0:
                raise AssertionError(f"{name}: {side} {tool} rc "
                                     f"{r.returncode}: {r.stderr[-2000:]}")
            text += r.stdout
            if side == "device":
                logs += r.stderr
        walls[side] = time.perf_counter() - t0
        outs[side] = strip_timing(text)
    assert outs["device"] == outs["host"], f"{name}: stdout differs"
    for fn in files:
        a = open(os.path.join(work, "device", fn), "rb").read()
        b = open(os.path.join(work, "host", fn), "rb").read()
        assert a == b, f"{name}: {fn} differs ({len(a)} vs {len(b)} bytes)"
    route = [ln for ln in logs.splitlines()
             if ln.startswith("modimizer-route:")]
    for key in need:
        keys = key if isinstance(key, tuple) else (key,)
        assert any(k in ln for ln in route for k in keys), \
            f"{name}: device path {keys} did not run: {route}"
    for ln in route:
        assert "n_fallback=0" in ln or "n_fallback" not in ln, \
            f"{name}: host fallback on random data: {ln}"
    say(f"[cli] {name}: device == host ({len(outs['host'])} stdout bytes"
        + "".join(f", {fn} {os.path.getsize(os.path.join(work, 'host', fn))}"
                  f" bytes" for fn in files)
        + f"); wall device {walls['device']:.1f} s, host "
        f"{walls['host']:.1f} s on {card}")
    for ln in route:
        say(f"    {ln}")
    return {"walls": walls, "route": route}


# ------------------------------------------------------------ orchestration

def run_phase_child(name, args):
    """Run one phase in a child process; returns its result dict."""
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", name]
    if args.four:
        cmd.append("--four")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    res = None
    for ln in r.stdout.splitlines():
        if ln.startswith(RESULT_TAG):
            res = json.loads(ln[len(RESULT_TAG):])
        else:
            say(ln)
    if r.returncode != 0 or res is None:
        sys.stdout.write(r.stderr[-6000:])
        raise SystemExit(f"phase {name} failed (rc {r.returncode})")
    say(f"[{name}] phase wall {time.perf_counter() - t0:.1f} s")
    return res


def card_line():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"nvidia-smi unavailable: {e}"
    if r.returncode != 0:
        return None, f"nvidia-smi rc {r.returncode}: {r.stderr.strip()}"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip(), r.stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded path")
    ap.add_argument("--phase", choices=sorted(PHASES), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "modimizer")):
        raise SystemExit("chip_smoke.py must run from a modimizer checkout")
    sys.path.insert(0, REPO)
    if args.phase:
        res = PHASES[args.phase](args)
        print(RESULT_TAG + json.dumps(res, default=str), flush=True)
        return 0

    t_start = time.perf_counter()
    dev = run_phase_child("preflight", args)
    card, smi = card_line()
    say(f"card: {smi}")
    if card is None:
        raise SystemExit("no nvidia-smi reading of the card")
    if args.four:
        run_phase_child("four", args)
    else:
        run_phase_child("steps", args)
        run_phase_child("ab", args)
        work = os.path.join(REPO, ".smoke_work")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            make_data(work, SIZES)
            for name, cmds, files, need in CLI_PHASES:
                pw = os.path.join(work, "run")
                run_cli_phase(name, cmds, files, need, work, pw, card)
                shutil.rmtree(pw, ignore_errors=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        run_phase_child("pytest", args)
    say(f"card: {card}; all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
