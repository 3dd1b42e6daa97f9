"""Golden parity tests for modasm vs the compiled reference binary."""

import difflib
import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from tests.golden import harness
from tests.util import strip_timing

pytestmark = pytest.mark.skipif(not harness.reference_available(),
                                reason="reference not available")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.array(list("ACGT"))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Genome-sampled overlapping reads + a ref segment + a modset."""
    d = tmp_path_factory.mktemp("modasm")
    rng = np.random.default_rng(7)
    genome = "".join(BASES[rng.integers(0, 4, size=30000)])
    reads = d / "reads.fa"
    with open(reads, "w") as f:
        for i in range(120):
            s = int(rng.integers(0, 27500))
            f.write(f">r{i}\n{genome[s:s + 2500]}\n")
    ref = d / "ref.fa"
    with open(ref, "w") as f:
        f.write(">ref\n" + genome[:8000] + "\n")
    mod = d / "X.mod"
    mu = harness.build_tool("modutils")
    subprocess.run([str(mu), "-c", "20", "16", "16", "17", "-a", str(reads),
                    "-s", "4", "18", "40", "-w", str(mod)],
                   check=True, capture_output=True)
    return d


def run_pair(args, cwd_c=None, cwd_p=None):
    ma = harness.build_tool("modasm")
    r_c = subprocess.run([str(ma)] + args, capture_output=True, text=True,
                         cwd=cwd_c)
    r_p = subprocess.run([sys.executable, os.path.join(REPO, "bin", "modasm")]
                         + args, capture_output=True, text=True, cwd=cwd_p)
    assert r_c.returncode == r_p.returncode, (r_c.stderr, r_p.stderr)
    a, b = strip_timing(r_c.stdout), strip_timing(r_p.stdout)
    assert a == b, "".join(difflib.unified_diff(
        a.splitlines(True), b.splitlines(True)))[:4000]
    return r_c, r_p


def normalize_readset(raw: bytes) -> bytes:
    """Zero the live heap pointers the reference dumps (ArrayStruct.base and
    each Read's hit/dx pointers, modasm.c:118-123)."""
    b = bytearray(raw)
    hdr = 16  # after magic + totHit
    b[hdr + 8:hdr + 16] = b"\0" * 8
    _m, _b, dim, size, _mx = struct.unpack_from("<i4xQiii4x", bytes(b), hdr)
    assert size == 72
    recs = hdr + 32
    for i in range(dim):
        off = recs + i * 72 + 8
        b[off:off + 16] = b"\0" * 16
    return bytes(b)


def test_overlap_triage(dataset):
    d = dataset
    run_pair(["-m", str(d / "X.mod"), "-f", str(d / "reads.fa"),
              "-S", "-b", "-S", "-c", "-u", "-C", "-P",
              "-o1", "5", "-o2", "17", "-o3", "3", "7"])


def test_write_read_roundtrip(dataset, tmp_path):
    d = dataset
    ma = harness.build_tool("modasm")
    subprocess.run([str(ma), "-m", str(d / "X.mod"), "-f", str(d / "reads.fa"),
                    "-b", "-c", "-w", str(tmp_path / "c")],
                   check=True, capture_output=True)
    subprocess.run([sys.executable, os.path.join(REPO, "bin", "modasm"),
                    "-m", str(d / "X.mod"), "-f", str(d / "reads.fa"),
                    "-b", "-c", "-w", str(tmp_path / "p")],
                   check=True, capture_output=True)
    cm = gzip.decompress((tmp_path / "c.mod").read_bytes())
    pm = gzip.decompress((tmp_path / "p.mod").read_bytes())
    assert cm == pm
    assert (tmp_path / "c.mod").read_bytes() == (tmp_path / "p.mod").read_bytes()
    cr = gzip.decompress((tmp_path / "c.readset").read_bytes())
    pr = gzip.decompress((tmp_path / "p.readset").read_bytes())
    assert normalize_readset(cr) == normalize_readset(pr)
    # -r roundtrip: stats from the written files must match
    run_pair(["-r", str(tmp_path / "c"), "-S"])


def test_assembly_and_testmods(dataset, tmp_path):
    d = dataset
    from modimizer.core.modset import Modset
    ms = Modset.read(str(d / "X.mod"))
    cand = [i for i in range(1, ms.max + 1)
            if (ms.info[i] & 3) == 1 and 5 <= ms.depth[i] <= 30]
    seed = cand[len(cand) // 2]
    cw, pw = tmp_path / "cw", tmp_path / "pw"
    cw.mkdir()
    pw.mkdir()
    run_pair(["-m", str(d / "X.mod"), "-f", str(d / "reads.fa"),
              "-R", str(d / "ref.fa"), "-T", "2", "50", "-T", "2", "50",
              "-a1", "5", "-a2", str(seed), "0", "-rb", "1"],
             cwd_c=str(cw), cwd_p=str(pw))
    for t in ("YY-TEST1", "ZZ-TEST1", "YY-TEST2", "ZZ-TEST2"):
        assert (cw / t).read_text() == (pw / t).read_text(), t


def test_tandem_repeat_core_flags(tmp_path):
    """Deep tandem-repeat reads exercise the core/multi rDNA depth bands
    (modasm.c:770-771) and resetBits."""
    rng = np.random.default_rng(11)
    unit = "".join(BASES[rng.integers(0, 4, size=400)])
    reads = tmp_path / "rep.fa"
    with open(reads, "w") as f:
        for i in range(320):
            f.write(f">t{i}\n{unit * 10}\n")
    ref = tmp_path / "unit.fa"
    with open(ref, "w") as f:
        f.write(">unit\n" + unit + "\n")
    mod = tmp_path / "R.mod"
    mu = harness.build_tool("modutils")
    subprocess.run([str(mu), "-c", "20", "16", "16", "17", "-a", str(reads),
                    "-s", "4", "18", "40", "-w", str(mod)],
                   check=True, capture_output=True)
    run_pair(["-m", str(mod), "-f", str(reads), "-R", str(ref),
              "-rb", "1", "-rb", "2", "-S"])


def test_cleanmods_last_read_off_by_one(tmp_path):
    """modasm.c:522-523 starts r at read 0 but i at 1, so cleanMods never
    visits the LAST read; mods internal only there must stay unflagged.
    Overlapping reads make the final read carry unique tail mods."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, size=50000).astype(np.uint8)
    reads = tmp_path / "r.fa"
    with open(reads, "w") as f:
        for i, r in enumerate([g[:20000], g[5000:25000], g[10000:30000]]):
            f.write(f">r{i}\n{''.join(BASES[r])}\n")
    mod = tmp_path / "T.mod"
    mu = harness.build_tool("modutils")
    subprocess.run([str(mu), "-c", "20", "16", "16", "17", "-a", str(reads),
                    "-s", "2", "5", "10", "-w", str(mod)],
                   check=True, capture_output=True)
    run_pair(["-m", str(mod), "-f", str(reads), "-C", "-S"])


def test_assemble_from_read_hash_double_quirk(tmp_path):
    """assembleFromRead's hitHash doubles once >512 distinct hits collect;
    the reference's hashDouble reuses a stale probe delta across relocated
    keys (hash.c:126-155), so re-added keys duplicate and 'AR %d total
    hits' over-reports.  Replicated in IHash::hDouble."""
    rng = np.random.default_rng(55)
    g = rng.integers(0, 4, size=120000).astype(np.uint8)
    reads = tmp_path / "r.fa"
    with open(reads, "w") as f:
        for i in range(150):
            st = int(rng.integers(0, 110000))
            L = int(rng.integers(2000, 9000))
            r = g[st:st + L]
            if rng.integers(0, 2):
                r = (r[::-1] ^ np.uint8(3))
            f.write(f">q{i}\n{''.join(BASES[r])}\n")
    ref = tmp_path / "ref.fa"
    with open(ref, "w") as f:
        f.write(">g\n" + "".join(BASES[g[:30000]]) + "\n")
    mod = tmp_path / "A.mod"
    mu = harness.build_tool("modutils")
    subprocess.run([str(mu), "-c", "20", "16", "16", "17", "-a", str(reads),
                    "-s", "4", "18", "40", "-w", str(mod)],
                   check=True, capture_output=True)
    r_c, _ = run_pair(["-m", str(mod), "-f", str(reads), "-R", str(ref),
                       "-a1", "2"])
    assert "AR  " in r_c.stdout  # the hash actually exercised


def test_testmods_without_ref_creates_side_files(dataset, tmp_path):
    """-T before -R: the reference opens YY/ZZ side files BEFORE the
    modInfo check (modasm.c:604-609), leaving empty files next to the
    'need to run -R first' fatal error."""
    d = dataset
    ma = harness.build_tool("modasm")
    cw, pw = tmp_path / "cw", tmp_path / "pw"
    cw.mkdir(); pw.mkdir()
    r_c = subprocess.run([str(ma), "-m", str(d / "X.mod"),
                          "-f", str(d / "reads.fa"), "-T", "2", "50"],
                         capture_output=True, text=True, cwd=str(cw))
    r_p = subprocess.run([sys.executable, os.path.join(REPO, "bin", "modasm"),
                          "-m", str(d / "X.mod"), "-f", str(d / "reads.fa"),
                          "-T", "2", "50"],
                         capture_output=True, text=True, cwd=str(pw))
    assert r_c.returncode == r_p.returncode == 255
    for w in (cw, pw):
        assert (w / "YY-TEST1").read_bytes() == b""
        assert (w / "ZZ-TEST1").read_bytes() == b""
    assert strip_timing(r_c.stderr) == strip_timing(r_p.stderr)
