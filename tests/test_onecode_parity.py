"""ONE-code subsystem: golden parity (seqconvert -1, modtype) + unit tests."""

import io
import os
import re
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest

from tests.golden import harness
from tests.util import random_fasta, random_fastq

pytestmark = pytest.mark.skipif(not harness.reference_available(),
                                reason="reference not available")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mask_timestamp(b: bytes) -> bytes:
    """The provenance timestamp is fixed-width (19 bytes after ' 19 '), so
    masking it preserves all offsets."""
    i = b.find(b" 19 ", 0, 500)
    assert i > 0
    return b[:i + 4] + b"T" * 19 + b[i + 23:]


@pytest.fixture(scope="module")
def pair_dirs(tmp_path_factory):
    """Two dirs with identical ./seqconvert entry points (same argv[0], so
    the provenance command line matches byte-for-byte)."""
    d = tmp_path_factory.mktemp("onecode")
    cdir, pdir = d / "c", d / "p"
    cdir.mkdir()
    pdir.mkdir()
    os.symlink(harness.build_tool("seqconvert"), cdir / "seqconvert")
    src = open(os.path.join(REPO, "bin", "seqconvert")).read().replace(
        "sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))",
        "sys.path.insert(0, %r)" % os.path.join(REPO, "bin"))
    (pdir / "seqconvert").write_text(src)
    os.chmod(pdir / "seqconvert",
             os.stat(pdir / "seqconvert").st_mode | stat.S_IEXEC)
    random_fastq(str(d / "t.fq"), 50, 300, seed=2)
    random_fastq(str(d / "big.fq"), 600, 400, seed=9)  # trains the Q codec
    return d


@pytest.mark.parametrize("args,src", [
    (["-1", "-o", "out.1seq"], "t.fq"),
    (["-Q", "20", "-1", "-o", "out.1seq"], "t.fq"),
    (["-Q", "20", "-1", "-o", "out.1seq"], "big.fq"),  # Huffman-trained
])
def test_1seq_write_parity(pair_dirs, args, src):
    d = pair_dirs
    full = args + ["../" + src]
    # NB reference seqconvert use-after-frees its SeqIO on exit
    # (seqconvert.c:78-81) and dies with SIGSEGV after a complete write
    subprocess.run(["./seqconvert"] + full, cwd=d / "c", capture_output=True)
    rp = subprocess.run(["./seqconvert"] + full, cwd=d / "p",
                        capture_output=True)
    assert rp.returncode == 0, rp.stderr
    cb = (d / "c" / "out.1seq").read_bytes()
    pb = (d / "p" / "out.1seq").read_bytes()
    assert mask_timestamp(cb) == mask_timestamp(pb)


def test_1seq_readback(pair_dirs):
    """Our reader decodes reference-written binary .1seq.  (The reference
    as-vendored cannot re-read its own output: its embedded seq schema has
    no object type, so oneFileOpenRead fails, seqio.c:110-131.)"""
    d = pair_dirs
    subprocess.run(["./seqconvert", "-Q", "20", "-1", "-o", "rb.1seq",
                    "../big.fq"], cwd=d / "c", capture_output=True)
    r1 = subprocess.run(["./seqconvert", "-fa", "-o", "own.fa", "rb.1seq"],
                        cwd=d / "p", capture_output=True)
    subprocess.run(["./seqconvert", "-Q", "20", "-1", "-o", "rb.1seq",
                    "../big.fq"], cwd=d / "p", capture_output=True)
    r2 = subprocess.run(["./seqconvert", "-fa", "-o", "own2.fa", "rb.1seq"],
                        cwd=d / "p", capture_output=True)
    assert r2.returncode == 0, r2.stderr
    # reading the C-written file and our own file gives identical sequences
    subprocess.run(["./seqconvert", "-fa", "-o", "cross.fa", "../c/rb.1seq"],
                   cwd=d / "p", capture_output=True)
    assert (d / "p" / "own2.fa").read_bytes() == \
        (d / "p" / "cross.fa").read_bytes()


def _norm(t):
    return re.sub(r"user\t[^\n]*", "<R>", t)


def test_modtype_parity(tmp_path):
    random_fasta(str(tmp_path / "ref.fa"), 3, 4000, seed=4)
    (tmp_path / "sites.1ins").write_text(
        "1 3 ins 1 1\nc 0 5 read0\nI 100 200\nI 300 420\n"
        "c 0 5 read2\nI 10 50\n")
    (tmp_path / "samples.1smp").write_text(
        "1 3 smp 1 1\nN 2 s1\nF 7 a.fq.gz\nC 30.000000\n"
        "N 5 samp2\nF 7 b.fq.gz\nC 12.500000\n")
    mt = harness.build_tool("modtype")
    args = [str(tmp_path / f) for f in ("ref.fa", "sites.1ins",
                                        "samples.1smp")]
    r_c = subprocess.run([str(mt)] + args, capture_output=True, text=True)
    r_p = subprocess.run([sys.executable, os.path.join(REPO, "bin",
                                                       "modtype")] + args,
                         capture_output=True, text=True)
    assert r_c.returncode == r_p.returncode == 0
    assert _norm(r_c.stdout) == _norm(r_p.stdout)
    assert _norm(r_c.stderr) == _norm(r_p.stderr)

    (tmp_path / "bad.1ins").write_text("1 3 ins 1 1\nc 0 5 nope1\nI 1 2\n")
    bargs = [args[0], str(tmp_path / "bad.1ins"), args[2]]
    b_c = subprocess.run([str(mt)] + bargs, capture_output=True, text=True)
    b_p = subprocess.run([sys.executable, os.path.join(REPO, "bin",
                                                       "modtype")] + bargs,
                         capture_output=True, text=True)
    assert b_c.returncode == b_p.returncode == 255
    assert b_c.stderr.splitlines()[-1] == b_p.stderr.splitlines()[-1]


def test_varint_roundtrip():
    from modimizer.io.onecode import int_put, ltf_read
    rng = np.random.default_rng(0)
    vals = ([0, 1, 63, 64, 8191, 8192, -1, -64, -65, 2 ** 32, -2 ** 40,
             2 ** 62, -2 ** 62]
            + [int(v) for v in rng.integers(-2 ** 60, 2 ** 60, 50)])
    for v in vals:
        buf = io.BytesIO(int_put(v))
        assert ltf_read(buf) == v, v


def test_huffman_roundtrip():
    from modimizer.io.onecode import HuffCodec
    rng = np.random.default_rng(1)
    train = rng.integers(33, 73, size=200000).astype(np.uint8).tobytes()
    vc = HuffCodec()
    vc.add(train)
    vc.create_codec(1)
    for n in (1, 7, 8, 63, 64, 1000):
        data = rng.integers(33, 80, size=n).astype(np.uint8).tobytes()
        nbits, enc = vc.encode(data)
        assert vc.decode(nbits, enc) == data
    # serialize/deserialize preserves the codec
    vc2 = HuffCodec.deserialize(vc.serialize())
    data = rng.integers(33, 73, size=500).astype(np.uint8).tobytes()
    nbits, enc = vc.encode(data)
    assert vc2.decode(nbits, enc) == data


def test_int_list_binary_roundtrip(tmp_path):
    from modimizer.io.onecode import OneFile, OneSchema
    schema = OneSchema.from_text(
        "P 3 tst\nO X 1 3 INT\nD L 1 8 INT_LIST\n")
    path = str(tmp_path / "t.1tst")
    vf = OneFile.open_write_new(path, schema, "tst", is_binary=True)
    vf.write_header()
    lists = [[5], [1, 2, 3], [10, 10, 10, 4000000, -7], list(range(100))]
    for i, l in enumerate(lists):
        vf.write_line("X", [i])
        vf.write_line("L", [], l)
    vf.close()
    vf = OneFile.open_read(path, schema, "tst")
    got = []
    while vf.read_line() is not None:
        if vf.lineType == "L":
            got.append(list(vf.one_int_list()))
    assert got == lists
    assert vf.object_index and len(vf.object_index) == len(lists)


def test_goto_object_and_group(tmp_path):
    """oneGotoObject/oneGotoGroup random access (ONElib.c:1491-1509) on a
    binary file with groups: seek to object/group i, re-read, compare with a
    sequential pass.  (User linetypes avoid o/q/s/u/w: their reference pack
    codes collide with the universal ;&*/. codes, ONElib.c:159-165.)"""
    import io as _io
    import numpy as np
    from modimizer.io.onecode import OneFile, OneSchema

    schema = OneSchema.from_text(
        "P 3 tst\nG g 1 3 INT\nO x 1 3 DNA\nD d 1 6 STRING\n")
    buf = _io.BytesIO()
    vf = OneFile.open_write_new(buf, schema, "tst", is_binary=True)
    vf.add_provenance("t", "1", "cmd", "2026-01-01_00:00:00")
    vf.write_header()
    rng = np.random.default_rng(5)
    seqs = []
    per_group = [3, 1, 4, 2]
    gi = 0
    for g, n in enumerate(per_group):
        vf.write_line("g", [n])
        for _ in range(n):
            sq = bytes(rng.choice(np.frombuffer(b"acgt", np.uint8),
                                  int(rng.integers(4, 40))))
            seqs.append(sq)
            vf.write_line("x", [], sq)
            vf.write_line("d", [], b"y%d" % gi)
            gi += 1
    vf.f.write(b"\n")
    vf._write_footer()
    raw = buf.getvalue()

    rf = OneFile.open_read(_io.BytesIO(raw), schema, "tst")
    assert rf is not None and rf.is_index_in
    seq_read = []
    while rf.read_line() is not None:
        if rf.lineType == "x":
            seq_read.append(bytes(rf.one_string_bytes()))
    assert seq_read == seqs

    rf2 = OneFile.open_read(_io.BytesIO(raw), schema, "tst")
    for i in [5, 0, 9, 3, 7]:
        assert rf2.goto_object(i)
        assert rf2.read_line() == "x"
        assert bytes(rf2.one_string_bytes()) == seqs[i]
    assert not rf2.goto_object(len(seqs))
    assert not rf2.goto_object(-1)
    first = 0
    for g, n in enumerate(per_group):
        assert rf2.goto_group(g) == n
        assert rf2.read_line() == "x"
        assert bytes(rf2.one_string_bytes()) == seqs[first]
        first += n
    assert rf2.goto_group(len(per_group)) == 0


def test_singleton_int_list_binary():
    """1-element INT_LISTs in binary mode: the reference dies on these
    before codec training (ONElib.c:2053-2080 writes the first element,
    decrements listLen, then fwrite(0 bytes) != 1 -> die).  Our writer and
    reader round-trip them."""
    import io as _io
    from modimizer.io.onecode import OneFile, OneSchema

    schema = OneSchema.from_text("P 3 tst\nO x 1 8 INT_LIST\n")
    buf = _io.BytesIO()
    vf = OneFile.open_write_new(buf, schema, "tst", is_binary=True)
    vf.write_header()
    vf.write_line("x", [], [42])
    vf.write_line("x", [], [7, -9])
    vf.write_line("x", [], [123456789])
    vf.f.write(b"\n")
    vf._write_footer()
    rf = OneFile.open_read(_io.BytesIO(buf.getvalue()), schema, "tst")
    got = []
    while rf.read_line() is not None:
        got.append(list(rf.one_int_list()))
    assert got == [[42], [7, -9], [123456789]]


def test_foreign_schema_fuzz():
    """Arbitrary user schemas (REAL_LIST/STRING_LIST-heavy) byte-compared
    against the compiled ONElib oracle driver, ASCII + binary, write and
    read directions (scripts/fuzz_onecode_schema.py)."""
    import tempfile
    from tests.golden import harness
    if not harness.reference_available():
        import pytest
        pytest.skip("reference not mounted")
    import scripts.fuzz_onecode_schema as F
    driver = harness.build_one_driver()
    for seed in (5000, 5001, 5002, 5003):
        with tempfile.TemporaryDirectory() as td:
            msg = F.run_case(seed, driver, td)
        assert msg is None, msg


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_parallel_one_seq_writer(n_threads, tmp_path):
    """ParallelOneSeqWriter output is byte-identical to the sequential
    OneSeqWriter for any worker count (deterministic codec training on the
    file-order prefix; >100 KB of id+qual data so Huffman training fires),
    unlike the reference's timing-dependent threaded handles
    (ONElib.c:1394-1412)."""
    import numpy as np
    from modimizer.io.onecode import OneSeqWriter, ParallelOneSeqWriter

    rng = np.random.default_rng(77)
    records = []
    for i in range(900):
        L = int(rng.integers(50, 400))
        seq = bytes(rng.choice(np.frombuffer(b"acgt", np.uint8), L))
        qual = rng.integers(0, 60, L).astype(np.int16)
        records.append((f"read-{i}-{'x' * int(rng.integers(0, 30))}",
                        "desc %d" % i if i % 3 == 0 else None, seq, qual))

    seq_path = tmp_path / "seq.1seq"
    with open(seq_path, "wb") as f:
        w = OneSeqWriter(f, is_qual=True)
        # pin provenance so both writers embed the same command string
        w.vf.provenance[-1] = ("seqio", "1.0", "cmd", "2026-01-01_00:00:00")
        w.vf.is_header_out = False
        # rewrite header with pinned provenance
        f.seek(0)
        w.vf.f = f
        w.vf.line = 0
        w.vf.write_header()
        for r in records:
            w.write(r[0], r[1], r[2], r[3])
        w.close()

    par_path = tmp_path / "par.1seq"
    class _W(ParallelOneSeqWriter):
        pass
    ParallelOneSeqWriter.write(str(par_path), records, is_qual=True,
                               n_threads=n_threads, provenance_cmd="cmd")
    # align provenance dates: pinning above vs live date — compare after
    # normalizing the single date field in the '!' line
    a = seq_path.read_bytes()
    b = par_path.read_bytes()
    assert len(a) == len(b)
    ia, ib = a.find(b"! 4"), b.find(b"! 4")
    assert ia == ib and ia > 0
    ea = a.index(b"\n", ia)
    assert a[:ia] == b[:ib] and a[ea:] == b[ea:]
