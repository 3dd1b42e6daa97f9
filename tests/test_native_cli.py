"""Parity tests for the C++ modutils fast path (native/modutils_cli.cpp).

The native binary must be byte-identical to the Python CLI (itself
golden-proven against the reference) on the command subset it executes
itself — .mod output, stdout (minus rusage lines' volatile fields — but
the memory column must match exactly), stderr — and must DELEGATE every
other invocation to the Python CLI unchanged."""

import gzip
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
NATIVE = REPO / "bin" / "modutils-native"


def _build():
    import sys as _sys
    _sys.path.insert(0, str(REPO))
    from modimizer.native import build_cli
    return build_cli() is not None


pytestmark = pytest.mark.skipif(not _build(), reason="native CLI build failed")


def _env():
    env = dict(os.environ)
    env["MODIMIZER_SCAN"] = "host"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["MODIMIZER_PYTHON"] = sys.executable   # delegation interpreter
    return env


def _run(cmd, cwd):
    return subprocess.run(cmd, cwd=cwd, capture_output=True, env=_env())


def _py(args, cwd):
    return _run([sys.executable, str(REPO / "bin" / "modutils")] + args, cwd)


def _nat(args, cwd):
    return _run([str(NATIVE)] + args, cwd)


def _strip_rusage(out: bytes):
    """Drop the volatile fields but KEEP the memory column (it must match:
    the native binary replicates the allocation-counter semantics)."""
    lines = []
    for ln in out.decode().splitlines():
        m = re.match(r"(total resources used: )?user\t.*\tmemory\t(\d+)$", ln)
        if m:
            lines.append(f"{m.group(1) or ''}rusage memory={m.group(2)}")
        else:
            lines.append(ln)
    return "\n".join(lines)


@pytest.fixture(scope="module")
def mods(tmp_path_factory):
    d = tmp_path_factory.mktemp("natcli")
    rng = np.random.default_rng(5)
    B = np.frombuffer(b"ACGT", np.uint8)
    for name, seed in (("a.fa", 1), ("b.fa", 2)):
        r = np.random.default_rng(seed)
        with open(d / name, "w") as f:
            for i in range(120):
                codes = r.integers(0, 4, int(r.integers(100, 700)))
                f.write(f">r{i}\n{B[codes].tobytes().decode()}\n")
    for fa, mod in (("a.fa", "A.mod"), ("b.fa", "B.mod")):
        r = _py(["-c", "22", "16", "16", "17", "-a", fa, "-w", mod], d)
        assert r.returncode == 0, r.stderr
    # plain (non-gzip) twin of B.mod, like the reference merge fixture
    (d / "B_plain.mod").write_bytes(gzip.open(d / "B.mod", "rb").read())
    return d


CASES = [
    ["-r", "A.mod", "-p", "1", "200", "-s", "4", "18", "40", "-w", "o.mod"],
    ["-r", "A.mod", "-m", "B_plain.mod", "-w", "o.mod"],
    ["-r", "A.mod", "-m", "B.mod", "-sM", "9", "-w", "o.mod"],
    ["-v", "-r", "A.mod", "-p", "2", "0", "-w", "o.mod"],
    # double merge: value/depth/info alias value_v/... after the first -m;
    # the regrow must not zero/free the source it copies from (round-5
    # review finding — corrupted silently before the fresh-vector fix)
    ["-r", "A.mod", "-m", "B_plain.mod", "-m", "B.mod", "-w", "o.mod"],
    ["-r", "A.mod", "-m", "B.mod", "-m", "B.mod", "-m", "B_plain.mod",
     "-s", "4", "18", "40", "-w", "o.mod"],
]


@pytest.mark.parametrize("args", CASES)
def test_subset_parity(mods, args, tmp_path):
    dn, dp = tmp_path / "n", tmp_path / "p"
    for d in (dn, dp):
        d.mkdir()
        for f in ("A.mod", "B.mod", "B_plain.mod"):
            (d / f).write_bytes((mods / f).read_bytes())
    rn = _nat(args, dn)
    rp = _py(args, dp)
    assert rn.returncode == rp.returncode == 0
    assert _strip_rusage(rn.stdout) == _strip_rusage(rp.stdout)
    assert rn.stderr == rp.stderr
    assert (dn / "o.mod").read_bytes() == (dp / "o.mod").read_bytes()


@pytest.mark.parametrize("args", [
    ["-r", "missing.mod"],                      # open failure die()
    ["-r", "A.mod", "-r", "A.mod"],             # second -r: unknown command
    ["-r", "A.mod", "-H", "h.txt"],             # flag outside the subset
    ["-r", "corrupt.mod"],                      # bad magic: ValueError path
    ["-w", "o.mod"],                            # -w before -r
    ["-r", "A.mod", "-p", "1"],                 # missing operand
])
def test_delegation_parity(mods, args, tmp_path):
    dn, dp = tmp_path / "n", tmp_path / "p"
    for d in (dn, dp):
        d.mkdir()
        (d / "A.mod").write_bytes((mods / "A.mod").read_bytes())
        (d / "corrupt.mod").write_bytes(b"garbage not a modset")
    rn = _nat(args, dn)
    rp = _py(args, dp)
    assert rn.returncode == rp.returncode
    assert _strip_rusage(rn.stdout) == _strip_rusage(rp.stdout)
    # tracebacks contain the interpreter path; compare the tail lines
    tail = lambda r: r.stderr.decode().strip().splitlines()[-1:]
    assert tail(rn) == tail(rp)


def test_delegated_build_matches(mods, tmp_path):
    """A full -c/-a build (not in the subset) through the native front door
    must produce the Python CLI's bytes exactly (it execs it)."""
    dn, dp = tmp_path / "n", tmp_path / "p"
    for d in (dn, dp):
        d.mkdir()
        (d / "a.fa").write_bytes((mods / "a.fa").read_bytes())
    args = ["-c", "22", "16", "16", "17", "-a", "a.fa", "-w", "o.mod"]
    rn = _nat(args, dn)
    rp = _py(args, dp)
    assert rn.returncode == rp.returncode == 0
    assert (dn / "o.mod").read_bytes() == (dp / "o.mod").read_bytes()
