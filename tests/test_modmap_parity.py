"""Golden parity: our modmap vs the reference C binary."""

import gzip
import io
import sys

import numpy as np
import pytest

from tests.golden import harness
from tests.util import random_fasta, strip_timing

pytestmark = pytest.mark.skipif(not harness.reference_available(),
                                reason="reference not mounted")


def run_ours(args, cwd=None):
    from modimizer.cli import modmap
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdout, sys.stderr
    code = 0
    import os
    oldcwd = os.getcwd()
    if cwd:
        os.chdir(cwd)
    try:
        sys.stdout, sys.stderr = out, err
        modmap.main([str(a) for a in args])
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.stdout, sys.stderr = old
        os.chdir(oldcwd)
    return code, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("modmap")
    rng = np.random.default_rng(33)
    bases = np.array(list("ACGT"))
    # a reference with 3 "chromosomes", one containing a duplicated segment
    # (so copy2 mods exist)
    chr1 = "".join(bases[rng.integers(0, 4, size=20000)])
    seg = chr1[2000:3500]
    chr2 = ("".join(bases[rng.integers(0, 4, size=5000)]) + seg
            + "".join(bases[rng.integers(0, 4, size=5000)]))
    chr3 = "".join(bases[rng.integers(0, 4, size=8000)])
    with open(d / "ref.fa", "w") as f:
        f.write(f">chr1\n{chr1}\n>chr2\n{chr2}\n>chr3 third\n{chr3}\n")

    # queries: substrings of the reference (some reverse-complemented),
    # plus random junk
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    def rc(s):
        return "".join(comp[c] for c in reversed(s))
    chrs = [chr1, chr2, chr3]
    with open(d / "query.fa", "w") as f:
        for i in range(30):
            src = chrs[int(rng.integers(0, 3))]
            s = int(rng.integers(0, len(src) - 2000))
            q = src[s:s + 2000]
            if rng.random() < 0.4:
                q = rc(q)
            f.write(f">q{i}\n{q}\n")
        for i in range(5):
            f.write(f">junk{i}\n" +
                    "".join(bases[rng.integers(0, 4, size=1500)]) + "\n")
    return d


def test_build_and_query(data):
    d = data
    argv = ["-K", "16", "-W", "13", "-S", "7", "-B", "20",
            "-f", d / "ref.fa", "-q", d / "query.fa"]
    r = harness.run_tool("modmap", argv)
    code, out, err = run_ours(argv)
    assert code == 0
    assert strip_timing(r.stdout.decode()) == strip_timing(out)


def test_write_read_query(data):
    d = data
    (d / "cdir").mkdir(exist_ok=True)
    (d / "pydir").mkdir(exist_ok=True)
    argv_w = ["-K", "16", "-W", "13", "-S", "7", "-B", "20",
              "-f", d / "ref.fa", "-w", "refidx"]
    r = harness.run_tool("modmap", argv_w, cwd=str(d / "cdir"))
    code, out, err = run_ours(argv_w, cwd=str(d / "pydir"))
    assert code == 0
    # .mod must be byte-identical
    assert ((d / "cdir/refidx.mod").read_bytes()
            == (d / "pydir/refidx.mod").read_bytes())
    # .ref contains raw heap pointers (array/dict headers): compare
    # decompressed with pointer fields zeroed
    cref = gzip.decompress((d / "cdir/refidx.ref").read_bytes())
    pref = gzip.decompress((d / "pydir/refidx.ref").read_bytes())
    assert len(cref) == len(pref)
    ca, pa = bytearray(cref), bytearray(pref)

    def zero_ptrs(buf):
        # array header at a known offset: find the ArrayStruct magic and zero
        # its base pointer; the dict names pointer array is zeroed by length
        import struct
        # locate CArray header (magic 8918274) occurrences
        off = 0
        magic = struct.pack("<i", 8918274)
        while True:
            i = buf.find(magic, off)
            if i < 0:
                break
            buf[i + 8:i + 16] = b"\x00" * 8
            off = i + 4
        return buf

    ca = zero_ptrs(ca)
    pa = zero_ptrs(pa)
    # dict names pointer array: locate from the end structure — instead
    # compare all but any remaining differing 8-byte-aligned pointer runs
    diff = [i for i in range(len(ca)) if ca[i] != pa[i]]
    # remaining diffs must lie in the dict's names pointer block (3 names + 1
    # -> 32 bytes); anything more is a real mismatch
    assert len(diff) <= 32, f"{len(diff)} differing bytes"

    # reference must load our files and query identically, and vice versa
    argv_q = ["-r", "refidx", "-q", str(d / "query.fa")]
    r1 = harness.run_tool("modmap", argv_q, cwd=str(d / "pydir"))
    r2 = harness.run_tool("modmap", argv_q, cwd=str(d / "cdir"))
    assert strip_timing(r1.stdout.decode()) == strip_timing(r2.stdout.decode())
    code, out1, _ = run_ours(argv_q, cwd=str(d / "cdir"))
    code2, out2, _ = run_ours(argv_q, cwd=str(d / "pydir"))
    assert code == 0 and code2 == 0
    assert strip_timing(out1) == strip_timing(out2)
    assert strip_timing(out1) == strip_timing(r2.stdout.decode())


def test_verbose_query(data):
    d = data
    argv = ["-K", "16", "-W", "13", "-S", "7", "-B", "20",
            "-f", d / "ref.fa", "-v", "-q", d / "query.fa"]
    r = harness.run_tool("modmap", argv)
    code, out, err = run_ours(argv)
    assert code == 0
    assert strip_timing(r.stdout.decode()) == strip_timing(out)


def test_query_device_path(data, monkeypatch):
    """-q with the device scan + device sorted-table lookup forced: Q/M
    lines byte-identical to the reference (modmap.c:188-281)."""
    d = data
    monkeypatch.setenv("MODIMIZER_SCAN", "device")
    argv = ["-K", "16", "-W", "13", "-S", "7", "-B", "20",
            "-f", d / "ref.fa", "-q", d / "query.fa"]
    r = harness.run_tool("modmap", argv)
    code, out, err = run_ours(argv)
    assert code == 0
    assert strip_timing(r.stdout.decode()) == strip_timing(out)
