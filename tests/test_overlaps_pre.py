"""Device overlap discovery wired into the modasm CLI: the *_pre phase-2
engines fed by parallel/overlaps.py must reproduce the serial native walk
byte-for-byte on -b / -c / -o2 (and, when the reference toolchain is
present, the reference binary too — run_pair already covers that half)."""

import difflib
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.array(list("ACGT"))

RC = {"A": "T", "C": "G", "G": "C", "T": "A"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Overlapping reads incl. reverse-complement reads and a repeated
    genome block, so BAD_REPEAT / orientation / containment paths all
    fire."""
    d = tmp_path_factory.mktemp("ovpre")
    rng = np.random.default_rng(11)
    core = "".join(BASES[rng.integers(0, 4, size=12000)])
    # tandem repeat: the middle 2k block appears twice
    genome = core[:6000] + core[2000:4000] + core[6000:]
    reads = d / "reads.fa"
    with open(reads, "w") as f:
        for i in range(150):
            s = int(rng.integers(0, len(genome) - 2600))
            seq = genome[s:s + 2500]
            if i % 3 == 2:
                seq = "".join(RC[c] for c in reversed(seq))
            f.write(f">r{i}\n{seq}\n")
        # a short read fully contained in the coverage
        f.write(f">contained\n{genome[500:1300]}\n")
    mod = d / "X.mod"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "modutils"),
         "-c", "20", "16", "16", "17", "-a", str(reads),
         "-s", "4", "18", "40", "-w", str(mod)],
        check=True, capture_output=True, env=env)
    return d


def _run(d, mode, args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "MODIMIZER_OVERLAPS": mode}
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "modasm"),
         "-m", str(d / "X.mod"), "-f", str(d / "reads.fa")] + args,
        capture_output=True, text=True, env=env)


@pytest.mark.parametrize("args", [
    ["-b", "-S", "-c", "-S"],          # triage then containment, with stats
    ["-o2", "7"],                      # RR lines for every 7th read
    ["-b", "-o2", "3"],                # RR lines after bad-marking
    ["-u"],                            # single-linkage clustering
    ["-b", "-u"],                      # clustering after bad-marking
])
def test_device_overlaps_match_serial(dataset, args):
    h = _run(dataset, "host", args)
    v = _run(dataset, "device", args)
    assert h.returncode == 0 and v.returncode == 0, (h.stderr, v.stderr)
    from tests.util import strip_timing
    a, b = strip_timing(h.stdout), strip_timing(v.stdout)
    assert a == b, "".join(difflib.unified_diff(
        a.splitlines(True), b.splitlines(True)))[:4000]


def test_candidates_match_serial_state(dataset):
    """bad[] and contained[] state arrays agree between backends."""
    sys.path.insert(0, REPO)
    from modimizer.core.modset import Modset
    from modimizer.core.readset import Readset
    ms = Modset.read(str(dataset / "X.mod"))
    rs_h = Readset(ms)
    rs_h.file_read(str(dataset / "reads.fa"))
    ms2 = Modset.read(str(dataset / "X.mod"))
    rs_d = Readset(ms2)
    rs_d.file_read(str(dataset / "reads.fa"))
    devnull = open(os.devnull, "w")
    rs_h.native_call("rs_mark_bad", devnull)
    cy, ch, co = rs_d.device_overlap_candidates()
    assert co[-1] > 0  # the dataset actually produces candidates
    rs_d.native_call("rs_mark_bad_pre", devnull, cy, ch, co)
    assert np.array_equal(rs_h.bad, rs_d.bad)
    rs_h.native_call("rs_mark_contained", devnull)
    cy, ch, co = rs_d.device_overlap_candidates()
    rs_d.native_call("rs_mark_contained_pre", devnull, cy, ch, co)
    assert np.array_equal(rs_h.contained, rs_d.contained)
    devnull.close()
