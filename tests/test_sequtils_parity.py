"""Golden parity for composition / seqconvert / seqhoco."""

import io
import os
import sys

import pytest

from tests.golden import harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
from tests.util import random_fasta, random_fastq, strip_timing

pytestmark = pytest.mark.skipif(not harness.reference_available(),
                                reason="reference not mounted")


def run_cli(tool, args, stdout_bytes=False):
    import importlib
    mod = importlib.import_module(f"modimizer.cli.{tool}")
    out = io.BytesIO()
    err = io.StringIO()
    old = sys.stdout, sys.stderr

    class W:
        def __init__(self, b):
            self.buffer = b
        def write(self, s):
            self.buffer.write(s.encode() if isinstance(s, str) else s)
        def flush(self):
            pass

    code = 0
    try:
        sys.stdout, sys.stderr = W(out), err
        mod.main([str(a) for a in args])
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.stdout, sys.stderr = old
    return code, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("sequtils")
    random_fasta(d / "r.fa", 40, 350, seed=5, genome_len=4000)
    random_fastq(d / "r.fq", 25, 150, seed=6)
    # a fasta with homopolymer runs and mixed case
    with open(d / "homo.fa", "w") as f:
        f.write(">h1 some desc\nAAAACCCgggTTTTAcgtACGT\n>h2\nGGGGGGGGGGAAAAA\n")
    return d


def test_composition_fasta(data):
    r = harness.run_tool("composition", ["-b", "-l", data / "r.fa"])
    code, out, err = run_cli("composition", ["-b", "-l", data / "r.fa"])
    assert code == 0
    assert r.stdout.decode() == out.decode()


def test_composition_fastq_quals(data):
    r = harness.run_tool("composition", ["-b", "-q", data / "r.fq"])
    code, out, err = run_cli("composition", ["-b", "-q", data / "r.fq"])
    assert code == 0
    assert r.stdout.decode() == out.decode()


def test_seqconvert_fa_to_fq_to_fa(data):
    d = data
    r = harness.run_tool("seqconvert", ["-S", "-fq", "-o", d / "c.fq", d / "r.fa"])
    code, out, err = run_cli("seqconvert", ["-fq", "-o", d / "py.fq", d / "r.fa"])
    assert code == 0
    assert (d / "c.fq").read_bytes() == (d / "py.fq").read_bytes()
    r = harness.run_tool("seqconvert", ["-S", "-fa", "-o", d / "c.fa", d / "r.fq"])
    code, out, err = run_cli("seqconvert", ["-fa", "-o", d / "py.fa", d / "r.fq"])
    assert (d / "c.fa").read_bytes() == (d / "py.fa").read_bytes()


def test_seqconvert_binary_write(data):
    d = data
    r = harness.run_tool("seqconvert", ["-S", "-b", "-o", d / "c.bin", d / "r.fa"])
    code, out, err = run_cli("seqconvert", ["-b", "-o", d / "py.bin", d / "r.fa"])
    assert code == 0
    assert (d / "c.bin").read_bytes() == (d / "py.bin").read_bytes()
    # our reader must roundtrip our/reference binary back to fasta
    code, out, err = run_cli("seqconvert", ["-fa", "-o", d / "rt.fa", d / "py.bin"])
    assert code == 0
    # ids survive; sequence is uppercased text of the original
    orig = (d / "r.fa").read_text()
    assert (d / "rt.fa").read_text() == orig


def test_seqconvert_binary_quals(data):
    d = data
    r = harness.run_tool("seqconvert", ["-S", "-b", "-Q", "20", "-o", d / "cq.bin",
                                        data / "r.fq"])
    code, out, err = run_cli("seqconvert", ["-b", "-Q", "20", "-o", d / "pyq.bin",
                                            data / "r.fq"])
    assert code == 0
    assert (d / "cq.bin").read_bytes() == (d / "pyq.bin").read_bytes()


def test_seqhoco(data):
    """Byte-identical incl. the reference's one-past-the-end trailing byte
    (deterministically 0xfe for FASTA/FASTQ input: seqio's in-place
    conversion leaves convert['\\n'] = -2 at seq[seqLen]; seqhoco.c:30)."""
    import gzip
    r = harness.run_tool("seqhoco", [data / "homo.fa"])
    code, out, err = run_cli("seqhoco", [data / "homo.fa"])
    assert code == 0
    assert r.stdout == out
    assert gzip.decompress(out).decode("latin1") == \
        ">h1\nACgTAcgtACGT\xfe\n>h2\nGA\xfe\n"


def test_native_parsers_match_numpy_twins():
    """The native FASTA/FASTQ parsers reproduce the numpy oracles exactly."""
    import numpy as np
    from modimizer.io import seqio as sq
    rng = np.random.default_rng(17)
    B = "ACGTNacgtn"
    fa = []
    for i in range(30):
        seq = "".join(B[j] for j in rng.integers(0, len(B),
                                                 rng.integers(0, 300)))
        # multi-line bodies + descriptions
        body = "\n".join(seq[k:k + 37] for k in range(0, max(len(seq), 1), 37))
        fa.append(f">id{i} some desc {i}\n{body}")
    data = ("\n".join(fa) + "\n").encode()
    for conv in (sq.dna2textConv, sq.dna2index_n0()):
        a = sq._parse_fasta(data, conv, True)
        b = sq._parse_fasta_np(data, conv, True)
        assert np.array_equal(a.codes, b.codes)
        assert np.array_equal(a.offsets, b.offsets)
        assert a.ids == b.ids and a.descs == b.descs
    # fastq
    fq = []
    for i in range(25):
        n = int(rng.integers(1, 200))
        seq = "".join("ACGT"[j] for j in rng.integers(0, 4, n))
        q = "".join(chr(33 + int(x)) for x in rng.integers(0, 40, n))
        fq.append(f"@q{i} d{i}\n{seq}\n+\n{q}\n")
    data = "".join(fq).encode()
    for conv in (None, sq.dna2index_n0()):
        for isq in (False, True):
            a = sq._parse_fastq(data, conv, isq, True)
            b = sq._parse_fastq_np(data, conv, isq, True)
            assert np.array_equal(a.codes, b.codes)
            assert np.array_equal(a.offsets, b.offsets)
            assert a.ids == b.ids and a.descs == b.descs
            if isq:
                assert np.array_equal(a.quals, b.quals)


def test_native_histograms_match_bincount():
    """byte_hist256 / u16_hist replace np.bincount on whole-file arrays
    (which casts to int64, an 8x temporary); exactness check."""
    import numpy as np
    from modimizer.native import byte_hist256, u16_hist
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, size=1_000_003).astype(np.uint8)
    assert np.array_equal(byte_hist256(a),
                          np.bincount(a, minlength=256).astype(np.uint64))
    s = rng.integers(0, 300, size=500_001).astype(np.int8)  # signed view path
    assert np.array_equal(byte_hist256(s),
                          np.bincount(s.view(np.uint8),
                                      minlength=256).astype(np.uint64))
    d = rng.integers(0, 5000, size=750_000).astype(np.uint16)
    nb = int(d.max()) + 1
    assert np.array_equal(u16_hist(d, nb),
                          np.bincount(d, minlength=nb).astype(np.uint64))
    # bins smaller than max: out-of-range values are dropped
    h = u16_hist(d, 100)
    assert np.array_equal(h, np.bincount(d[d < 100],
                                         minlength=100).astype(np.uint64))


def test_memory_column_nonzero_monotone(tmp_path):
    """The rusage lines' memory column reports the framework's cumulative
    allocation counter (reference utils.c:59-75,195: running total)."""
    import re
    import subprocess
    import sys
    fa = tmp_path / "m.fa"
    random_fasta(fa, 40, 300, seed=3)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "modutils"),
         "-c", "20", "16", "16", "17", "-a", str(fa),
         "-H", str(tmp_path / "h.txt")],
        capture_output=True, text=True, env=env, check=True)
    mems = [int(m) for m in re.findall(r"memory\t(\d+)", r.stdout)]
    assert len(mems) >= 3
    assert mems[0] > 0
    assert all(b >= a for a, b in zip(mems, mems[1:]))


def test_incomplete_final_record_quirk(tmp_path):
    """EOF mid-record drops the final partial record with `incomplete
    sequence record line N` on stderr (seqio.c:216-219; N = completed
    newlines + 1) — stdout AND stderr byte-compared vs the reference
    binary across FASTA/FASTQ tail shapes."""
    cases = {
        "fa_noeol_seq.fa": b">a\nACGT\nACGT",
        "fa_noeol_hdr.fa": b">a\nACGT\n>b desc",
        "fa_hdr_only.fa": b">a\nACGT\n>b\n",
        "fa_single_noeol.fa": b">a\nACGTACGT",
        "fq_noeol2.fq": b"@a\nACGT\n+\nIIII\n@b\nACGT",
        "fq_2lines.fq": b"@a\nACGT\n+\nIIII\n@b\nACGT\n",
        "fq_noeol_qual.fq": b"@a\nACGT\n+\nIIII\n@b\nACGT\n+\nIII",
        "fq_dangling_hdr.fq": b"@a\nACGT\n+\nIIII\n@b",
    }
    for name, payload in cases.items():
        p = tmp_path / name
        p.write_bytes(payload)
        r = harness.run_tool("composition", [p])
        code, out, err = run_cli("composition", [p])
        assert code == r.returncode == 0, (name, code, r.returncode)
        assert strip_timing(r.stdout.decode()) == \
            strip_timing(out.decode()), (name, "stdout")
        assert strip_timing(r.stderr.decode()) == strip_timing(err), (
            name, "stderr", r.stderr, err)


def test_incomplete_record_streaming_matches_whole(tmp_path):
    """The parse-ahead streaming producer applies the same drop+message."""
    import numpy as np
    from modimizer.io import seqio as sio
    from modimizer.io.stream_seq import iter_seq_batches
    p = tmp_path / "t.fa"
    p.write_bytes(b">a\nACGT\nGGTT\n>b\nCCCC\n>c\nAAAA")  # c incomplete
    conv = sio.dna2index_n0()
    batch, _ = sio.read_seq_file(str(p), conv, want_ids=False)
    got_c, got_n = [], 0
    for cb, ob in iter_seq_batches(str(p), conv, seg_bytes=8):
        got_c.append(cb)
        got_n += len(ob) - 1
    assert got_n == len(batch.offsets) - 1 == 2
    assert np.array_equal(np.concatenate(got_c).view(np.int8), batch.codes)
