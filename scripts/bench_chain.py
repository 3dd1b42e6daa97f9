"""Measure modmap -q chaining: batched device lax.scan (parallel/chain.py)
vs the native automaton + text emission (mm_query_emit) at 100k+ reads
(the earlier accelerator's result is summarised in docs/PERF.md; not
yet timed on the GPU).

Usage: python scripts/bench_chain.py [n_reads=100000] [seeds_per_read=30]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_case(n_reads, spr, n_mods=200000, n_refs=24, seed=1):
    rng = np.random.default_rng(seed)
    info = np.zeros(n_mods + 1, np.uint8)
    info[1:] = rng.choice([1, 1, 1, 2, 3], n_mods).astype(np.uint8)
    n_occ = np.where((info & 3) == 2, 2, 1)
    n_occ[0] = 1
    loc = np.concatenate([[0], np.cumsum(n_occ[:-1])]).astype(np.uint32)
    total = int(n_occ.sum())
    # colinear-ish occupancy so real blocks form: occurrence o sits near o
    rev = (np.arange(total, dtype=np.uint32)
           + rng.integers(-3, 4, total).astype(np.int64)).clip(
               0, total - 1).astype(np.uint32)
    bounds = np.sort(rng.choice(total, n_refs - 1, replace=False))
    rid = np.searchsorted(bounds, np.arange(total),
                          side="right").astype(np.uint32)
    offs = (np.arange(total, dtype=np.uint32) * 13) & 0xFFFFFF
    ns = rng.integers(max(1, spr - 10), spr + 10, n_reads)
    seed_off = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    S = int(seed_off[-1])
    # runs of consecutive mods (blocks) with occasional jumps
    base = rng.integers(1, n_mods - 200, n_reads)
    within = np.arange(S) - np.repeat(seed_off[:-1], ns)
    sidx = (np.repeat(base, ns) + within // 2).astype(np.uint32)
    miss = rng.random(S) < 0.1
    sidx[miss] = 0
    spos = (within * 16).astype(np.int64)
    return info, loc, rev, rid, offs, sidx, spos, seed_off


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    spr = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    info, loc, rev, rid, offs, sidx, spos, seed_off = make_case(n_reads, spr)
    print(f"{n_reads} reads, {len(sidx)} seeds", file=sys.stderr)

    # ---- native automaton + text emission to /dev/null ----
    from modimizer.native import lib as native_lib
    L = native_lib()
    n_names = int(rid.max()) + 1
    names = b"".join(b"ref%d\0" % i for i in range(n_names))
    name_off = np.zeros(n_names + 1, np.int64)
    p = 0
    for i in range(n_names):
        name_off[i] = p
        p += len(b"ref%d\0" % i)
    name_off[-1] = p
    qids = b"".join(b"q%d\0" % i for i in range(n_reads))
    qid_off = np.zeros(n_reads + 1, np.int64)
    p = 0
    for i in range(n_reads):
        qid_off[i] = p
        p += len(b"q%d\0" % i)
    qid_off[-1] = p
    qlen = np.full(n_reads, spr * 16 + 50, np.int64)
    devnull = os.open(os.devnull, os.O_WRONLY)
    t0 = time.perf_counter()
    L.mm_query_emit(seed_off, sidx, spos,
                    np.ascontiguousarray(info, np.uint8),
                    np.ascontiguousarray(rev, np.uint32),
                    np.ascontiguousarray(loc, np.uint32),
                    np.ascontiguousarray(offs, np.uint32),
                    np.ascontiguousarray(rid, np.uint32),
                    len(rev), names, name_off, qids, qid_off, qlen,
                    n_reads, 0, devnull, devnull)
    t_native = time.perf_counter() - t0
    os.close(devnull)
    print(f"native mm_query_emit (chain + Q/M text): {t_native:.3f}s "
          f"= {len(sidx) / t_native / 1e6:.1f} Mseeds/s", file=sys.stderr)

    # ---- device lax.scan ----
    class FakeRef:
        pass
    ref = FakeRef()
    ref.rev, ref.loc, ref.id = rev, loc, rid

    class MS:
        pass
    ref.ms = MS()
    ref.ms.info = info
    from modimizer.parallel.chain import chain_records
    t0 = time.perf_counter()
    out = chain_records(ref, sidx, spos, seed_off)
    t_first = time.perf_counter() - t0   # includes compile
    t0 = time.perf_counter()
    out = chain_records(ref, sidx, spos, seed_off)
    t_dev = time.perf_counter() - t0
    n_m = sum(len(o) for o in out)
    print(f"device chain_records: {t_dev:.3f}s warm ({t_first:.3f}s cold) "
          f"= {len(sidx) / t_dev / 1e6:.1f} Mseeds/s; {n_m} M records "
          f"(no text formatting)", file=sys.stderr)
    print(f"RESULT native {t_native:.3f} device {t_dev:.3f} "
          f"ratio {t_dev / t_native:.2f}x")


if __name__ == "__main__":
    main()
