"""AVX-512 host scan (scan_simd_stream dispatch in sh_scan_emit_reads) vs a
pure-python rolling-hash oracle (seqhash.c:60-79,154-196 semantics).

The SIMD path is boundary-oblivious over 8 halo'd stream segments with a
two-pointer read-span filter; these trials cover lane boundaries, the
scalar tail, the w=1 overflow-retry path, and dispatch thresholds.  On
hosts whose build lacks AVX-512 the same trials exercise the scalar
kernel, so the test is meaningful everywhere.
"""

import numpy as np

from modimizer.native import lib as native_lib


def _oracle(codes, offsets, k, w, f1, s1):
    em = []
    mask = (1 << (2 * k)) - 1 if k < 32 else (1 << 64) - 1
    for r in range(len(offsets) - 1):
        s0, e0 = int(offsets[r]), int(offsets[r + 1])
        if e0 - s0 < k:
            continue
        h = hrc = 0
        cl = codes[s0:e0].tolist()
        for j in range(k):
            b = cl[j]
            h = ((h << 2) & mask) | b
            hrc = (hrc >> 2) | ((3 - b) << (2 * (k - 1)))
        p = s0
        while True:
            hf = ((h * f1) & 0xFFFFFFFFFFFFFFFF) >> s1
            hr = ((hrc * f1) & 0xFFFFFFFFFFFFFFFF) >> s1
            if min(hf, hr) % w == 0:
                em.append((h if hf < hr else hrc, p, 1 if hf < hr else 0))
            if p - s0 + k >= e0 - s0:
                break
            b = cl[p - s0 + k]
            p += 1
            h = ((h << 2) & mask) | b
            hrc = (hrc >> 2) | ((3 - b) << (2 * (k - 1)))
    return em


def _run(codes, offsets, k, w, f1, s1, cap):
    L = native_lib()
    while True:
        ok = np.empty(cap, np.uint64)
        op = np.empty(cap, np.int64)
        of = np.empty(cap, np.uint8)
        cnt = L.sh_scan_emit_reads(codes, offsets, len(offsets) - 1, k, w,
                                   f1, s1, ok, op, of, cap)
        if cnt >= 0:
            return [(int(ok[i]), int(op[i]), int(of[i])) for i in range(cnt)]
        cap = -cnt


def test_simd_scan_matches_oracle():
    rng = np.random.default_rng(77)
    for trial in range(12):
        k = int(rng.integers(4, 31))
        w = int(rng.choice([1, 2, 3, 4, 5, 8, 16, 31, 32, 100, 1000]))
        nr = int(rng.integers(1, 120))
        lens = rng.integers(1, 4000, nr)
        offsets = np.zeros(nr + 1, np.int64)
        offsets[1:] = np.cumsum(lens)
        n = int(offsets[-1])
        codes = rng.integers(0, 4, n, dtype=np.int8).view(np.uint8)
        f1 = int(rng.integers(1, 2 ** 63)) | 1
        s1 = 64 - 2 * k
        cap = max(n // w * 4 + 1024, 8192)
        got = _run(codes, offsets, k, w, f1, s1, cap)
        exp = _oracle(codes, offsets, k, w, f1, s1)
        assert got == exp, (trial, k, w, n, len(got), len(exp))


def test_simd_scan_big_stream_hits_dispatch():
    # one read big enough for the vector path (>= 2^16 positions), plus a
    # tiny undersized cap forcing the overflow-grow handshake
    rng = np.random.default_rng(5)
    n = 300000
    codes = rng.integers(0, 4, n, dtype=np.int8).view(np.uint8)
    offsets = np.array([0, n], np.int64)
    f1 = 0x9E3779B97F4A7C15 | 1
    got = _run(codes, offsets, 16, 16, f1, 32, 256)
    exp = _oracle(codes, offsets, 16, 16, f1, 32)
    assert got == exp


def test_simd_scan_multithread_slices():
    """The OpenMP-sliced SIMD branch (nThreads>1) must emit the identical
    stream; forced via OMP_NUM_THREADS=2 in a subprocess (thread count is
    read at library load)."""
    import os
    import subprocess
    import sys
    code = r"""
import numpy as np
from modimizer.native import lib as native_lib
L = native_lib()
rng = np.random.default_rng(13)
n = 1 << 20
codes = rng.integers(0, 4, n, dtype=np.int8).view(np.uint8)
nr = 700
cuts = np.sort(rng.choice(np.arange(1, n), nr - 1, replace=False))
offsets = np.zeros(nr + 1, np.int64)
offsets[1:-1] = cuts
offsets[-1] = n
f1 = 0x9E3779B97F4A7C15 | 1
cap = n // 16 * 4 + 8192
ok = np.empty(cap, np.uint64); op = np.empty(cap, np.int64)
of = np.empty(cap, np.uint8)
cnt = L.sh_scan_emit_reads(codes, offsets, nr, 16, 16, f1, 32, ok, op, of,
                           cap)
np.save("OUT", np.concatenate([ok[:cnt], op[:cnt].view(np.uint64),
                               of[:cnt].astype(np.uint64)]))
"""
    import tempfile
    outs = []
    with tempfile.TemporaryDirectory() as d:
        for t in ("1", "2"):
            env = {**os.environ, "OMP_NUM_THREADS": t,
                   "JAX_PLATFORMS": "cpu"}
            r = subprocess.run([sys.executable, "-c",
                                code.replace("OUT", f"{d}/o{t}.npy")],
                               env=env, capture_output=True, text=True,
                               cwd=os.path.dirname(os.path.dirname(
                                   os.path.abspath(__file__))))
            assert r.returncode == 0, r.stderr[-800:]
            outs.append(np.load(f"{d}/o{t}.npy"))
    assert np.array_equal(outs[0], outs[1])
