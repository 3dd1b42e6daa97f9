"""Golden parity: our modutils vs the reference C binary, byte-for-byte."""

import gzip
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.golden import harness
from tests.util import random_fasta, random_fastq, strip_timing

pytestmark = pytest.mark.skipif(not harness.reference_available(),
                                reason="reference not mounted")


def run_ours(args, cwd=None):
    """Run our modutils CLI in-process, capturing stdout/stderr."""
    from modimizer.cli import modutils
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdout, sys.stderr
    code = 0
    import os
    if cwd:
        oldcwd = os.getcwd()
        os.chdir(cwd)
    try:
        sys.stdout, sys.stderr = out, err
        modutils.main([str(a) for a in args])
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.stdout, sys.stderr = old
        if cwd:
            os.chdir(oldcwd)
    return code, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("modutils")
    random_fasta(d / "reads.fa", 50, 400, seed=1, genome_len=5000)
    random_fasta(d / "reads2.fa", 40, 300, seed=2, genome_len=5000)
    random_fastq(d / "reads.fq", 30, 200, seed=3)
    return d


def test_build_write_text_hist(data):
    """-c -a -a -w -wt -H : .mod bytes, text, histogram all identical."""
    d = data
    argv = ["-c", "20", "16", "16", "17", "-a", d / "reads.fa",
            "-a", d / "reads.fq", "-w", d / "c.mod", "-wt", d / "c.txt",
            "-H", d / "c.his"]
    r = harness.run_tool("modutils", argv)
    argv2 = ["-c", "20", "16", "16", "17", "-a", d / "reads.fa",
             "-a", d / "reads.fq", "-w", d / "py.mod", "-wt", d / "py.txt",
             "-H", d / "py.his"]
    code, out, err = run_ours(argv2)
    assert code == 0
    assert (d / "c.mod").read_bytes() == (d / "py.mod").read_bytes()
    assert (d / "c.txt").read_text() == (d / "py.txt").read_text()
    assert (d / "c.his").read_text() == (d / "py.his").read_text()
    assert strip_timing(r.stdout.decode()) == strip_timing(out)


def test_read_prune_setcopy(data):
    d = data
    harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                  "-a", d / "reads.fa", "-w", d / "p0.mod"])
    argv = ["-r", d / "p0.mod", "-p", "2", "9", "-s", "2", "4", "6",
            "-sM", "8", "-w", "out.mod", "-wt", "out.txt"]
    (d / "cdir").mkdir(exist_ok=True)
    r = harness.run_tool("modutils", argv, cwd=str(d / "cdir"))
    (d / "pydir").mkdir(exist_ok=True)
    code, out, err = run_ours(argv, cwd=str(d / "pydir"))
    assert code == 0
    assert (d / "cdir/out.mod").read_bytes() == (d / "pydir/out.mod").read_bytes()
    assert (d / "cdir/out.txt").read_text() == (d / "pydir/out.txt").read_text()
    assert strip_timing(r.stdout.decode()) == strip_timing(out)


def test_merge_and_depths(data):
    """Merge: reference needs gunzipped input (-m uses fopen).  With >=64k
    entries the reference's uninitialized-depth quirk disappears (mmap zeroes);
    here we use small sets and compare only the deterministic outputs of the
    -d report against our own merge of identical semantics, plus the reference
    where depth garbage doesn't apply (entries present in ms1)."""
    d = data
    harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                  "-a", d / "reads.fa", "-w", d / "x.mod"])
    harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                  "-a", d / "reads2.fa", "-w", d / "y.mod"])
    # gunzip y.mod so reference -m (plain fopen) can read it
    (d / "y_plain.mod").write_bytes(gzip.decompress((d / "y.mod").read_bytes()))
    argv_c = ["-r", d / "x.mod", "-m", d / "y_plain.mod", "-w", d / "cm.mod"]
    argv_py = ["-r", d / "x.mod", "-m", d / "y_plain.mod", "-w", d / "pym.mod"]
    rc = harness.run_tool("modutils", argv_c)
    code, out, err = run_ours(argv_py)
    assert code == 0
    from modimizer.core.modset import Modset
    mc = Modset.read(d / "cm.mod")
    mp = Modset.read(d / "pym.mod")
    # deterministic fields: ids/values/table layout and info
    assert mc.max == mp.max
    assert np.array_equal(mc.value[:mc.max + 1], mp.value[:mp.max + 1])
    assert np.array_equal(mc.index, mp.index)
    # depth AND info of freshly-added entries read uninitialized memory in
    # the reference (resize garbage, modset.c:115-125); only entries that
    # already existed in ms1 are deterministic.
    mx = Modset.read(d / "x.mod")
    pre = mx.find_batch(mc.value[1:mc.max + 1]) != 0
    assert np.array_equal(mc.depth[1:mc.max + 1][pre],
                          mp.depth[1:mp.max + 1][pre])
    assert np.array_equal(mc.info[1:mc.max + 1][pre],
                          mp.info[1:mp.max + 1][pre])


def test_depths_report(data):
    d = data
    harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                  "-a", d / "reads.fa", "-w", d / "dx.mod"])
    harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                  "-a", d / "reads2.fa", "-w", d / "dy.mod"])
    # -d reads the extra mod files with plain fopen (modutils.c:250), so the
    # reference needs them gunzipped
    (d / "dxp.mod").write_bytes(gzip.decompress((d / "dx.mod").read_bytes()))
    (d / "dyp.mod").write_bytes(gzip.decompress((d / "dy.mod").read_bytes()))
    argv = ["-r", d / "dx.mod", "-d", d / "c.depths", d / "dxp.mod", d / "dyp.mod"]
    r = harness.run_tool("modutils", argv)
    argv2 = ["-r", d / "dx.mod", "-d", d / "py.depths", d / "dxp.mod", d / "dyp.mod"]
    code, out, err = run_ours(argv2)
    assert code == 0
    assert (d / "c.depths").read_text() == (d / "py.depths").read_text()
    assert strip_timing(r.stdout.decode()) == strip_timing(out)


def test_refpaint(data):
    d = data
    harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                  "-a", d / "reads.fa", "-w", d / "rp.mod"])
    argv = ["-r", d / "rp.mod", "-P", d / "reads2.fa"]
    r = harness.run_tool("modutils", argv)
    code, out, err = run_ours(argv)
    assert code == 0
    assert strip_timing(r.stdout.decode()) == strip_timing(out)


def test_readtext_roundtrip(data):
    d = data
    harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                  "-a", d / "reads.fa", "-wt", d / "rt.txt"])
    argv = ["-rt", d / "rt.txt", "-w", "rt.mod"]
    (d / "cdir2").mkdir(exist_ok=True)
    (d / "pydir2").mkdir(exist_ok=True)
    r = harness.run_tool("modutils", argv, cwd=str(d / "cdir2"))
    code, out, err = run_ours(argv, cwd=str(d / "pydir2"))
    assert code == 0
    assert (d / "cdir2/rt.mod").read_bytes() == (d / "pydir2/rt.mod").read_bytes()
    assert strip_timing(r.stdout.decode()) == strip_timing(out)


def test_10x_barcode_skip(tmp_path):
    """-x: odd records skip a 23bp barcode (modutils.c:44)."""
    import numpy as np
    rng = np.random.default_rng(9)
    B = np.array(list("ACGT"))
    fq = tmp_path / "x.fq"
    with open(fq, "w") as f:
        for i in range(30):
            n = int(rng.integers(40, 200))
            seq = "".join(B[rng.integers(0, 4, n)])
            q = "I" * n
            f.write(f"@x{i}\n{seq}\n+\n{q}\n")
    r = harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                      "-x", str(fq), "-w",
                                      str(tmp_path / "c.mod")])
    code, out, err = run_ours(["-c", "20", "16", "16", "17",
                               "-x", str(fq), "-w", str(tmp_path / "p.mod")])
    assert code == 0
    assert strip_timing(r.stdout.decode()) == strip_timing(out)
    assert (tmp_path / "c.mod").read_bytes() == (tmp_path / "p.mod").read_bytes()


def test_documented_workflow(tmp_path):
    """The canonical workflow from the reference usage text
    (modutils.c:100-107): build two modsets, merge, histogram, prune,
    set copy thresholds, cross-depth report.

    NB data is sized so each modset exceeds 128K entries: the reference's
    modsetMerge reads uninitialized depth/info for newly-added entries
    (modset.c:117-125 after resize), deterministic only when the resized
    arrays are fresh mmaps (>= 128KB each)."""
    d = tmp_path
    random_fasta(str(d / "a.fa"), 400, 7000, seed=41, genome_len=2_500_000)
    random_fasta(str(d / "b.fa"), 400, 7000, seed=42, genome_len=2_500_000)
    for src, stem in (("a.fa", "wa"), ("b.fa", "wb")):
        harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                      "-a", str(d / src),
                                      "-w", str(d / (stem + ".mod"))])
    import gzip
    for stem in ("wa", "wb"):
        (d / (stem + "_plain.mod")).write_bytes(
            gzip.decompress((d / (stem + ".mod")).read_bytes()))
    argv = ["-r", str(d / "wa.mod"), "-m", str(d / "wb_plain.mod"),
            "-H", str(d / "{}.his"), "-p", "2", "80",
            "-s", "2", "5", "40", "-d", str(d / "{}.dep"),
            str(d / "wa_plain.mod"), str(d / "wb_plain.mod"),
            "-w", str(d / "{}.out.mod")]
    r = harness.run_tool("modutils",
                         [a.replace("{}", "c") for a in argv])
    code, out, err = run_ours([a.replace("{}", "p") for a in argv])
    assert code == 0
    assert strip_timing(r.stdout.decode()) == strip_timing(out)
    for suffix in (".his", ".dep", ".out.mod"):
        assert (d / ("c" + suffix)).read_bytes() == \
            (d / ("p" + suffix)).read_bytes(), suffix


def test_streaming_device_build(data, tmp_path, monkeypatch):
    """-a via the parse-ahead streaming + device scan route
    (MODIMIZER_SCAN=device): .mod bytes and stdout identical for FASTA,
    gzipped FASTA, and FASTQ inputs."""
    d = data
    gz = tmp_path / "reads.fa.gz"
    gz.write_bytes(gzip.compress((d / "reads.fa").read_bytes()))
    monkeypatch.setenv("MODIMIZER_SCAN", "device")
    for src in (d / "reads.fa", gz, d / "reads.fq"):
        stem = tmp_path / src.name
        r = harness.run_tool("modutils", ["-c", "20", "16", "16", "17",
                                          "-a", str(src),
                                          "-w", f"{stem}.c.mod"])
        code, out, err = run_ours(["-c", "20", "16", "16", "17",
                                   "-a", str(src), "-w", f"{stem}.p.mod"])
        assert code == 0
        assert strip_timing(r.stdout.decode()) == strip_timing(out)
        assert (Path(f"{stem}.c.mod").read_bytes()
                == Path(f"{stem}.p.mod").read_bytes())
