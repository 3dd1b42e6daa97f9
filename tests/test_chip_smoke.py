"""The GPU bring-up surface on the CPU: host/device routing policy, the
compile-cache location, the smoke's device-vs-oracle helpers at tiny
sizes, and that chip_smoke.py / bench.py refuse to run without a GPU.
The same helpers at real widths are marked ``gpu`` and run on the card
(``python chip_smoke.py``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from modimizer.core.seqhash import Seqhash  # noqa: E402
from modimizer.ops import route  # noqa: E402


def _env(**kv):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "MODIMIZER_SCAN",
                        "MODIMIZER_OVERLAPS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(kv)
    return env


# ---------------------------------------------------------------- routing

BIG, SMALL, TH = 1 << 24, 1 << 10, 1 << 21


@pytest.mark.parametrize("platforms,mode,n,backend,want", [
    ("cpu", "auto", BIG, None, False),        # explicit non-GPU: no jax
    ("cpu", "auto", SMALL, None, False),
    ("", "auto", SMALL, None, False),         # below threshold: no jax
    ("", "auto", BIG, "gpu", True),
    ("", "auto", BIG, "cpu", False),
    ("cuda", "auto", BIG, "gpu", True),
    ("cuda", "auto", SMALL, None, False),
    ("", "host", BIG, None, False),
    ("cuda", "host", BIG, None, False),
    ("cpu", "device", SMALL, "cpu", True),    # CPU rehearsal of the programs
    ("", "device", SMALL, "gpu", True),
    ("", "device", SMALL, "cpu", RuntimeError),   # forced, no GPU: raise
    ("", "bogus", BIG, None, ValueError),
])
def test_route_policy(monkeypatch, platforms, mode, n, backend, want):
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    monkeypatch.setenv("MODIMIZER_SCAN", mode)
    calls = []

    def fake_backend():
        calls.append(1)
        assert backend is not None, "policy initialized jax needlessly"
        return backend

    monkeypatch.setattr(route, "backend_platform", fake_backend)
    if isinstance(want, type):
        with pytest.raises(want):
            route.use_device(n, TH)
    else:
        assert route.use_device(n, TH) is want
    if backend is None:
        assert not calls


def test_route_overlaps_knob(monkeypatch):
    """modasm's overlap gate reads MODIMIZER_OVERLAPS, not MODIMIZER_SCAN."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("MODIMIZER_SCAN", "host")
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "device")
    monkeypatch.setattr(route, "backend_platform", lambda: "cpu")
    from modimizer.cli.modasm import _use_device_overlaps

    class RS:
        tot_hit = 5
    assert _use_device_overlaps(RS())
    monkeypatch.setenv("MODIMIZER_OVERLAPS", "auto")
    assert not _use_device_overlaps(RS())


_NO_JAX = r"""
import sys
sys.path.insert(0, REPO)
sys.argv = ["TOOL"] + ARGS
from modimizer.cli import TOOL as cli
try:
    cli.main()
except SystemExit as e:
    assert not e.code, e.code
assert "jax" not in sys.modules, "host-only run imported jax"
"""


@pytest.mark.parametrize("tool,args", [
    ("modutils", ["-c", "20", "16", "16", "17", "-a", "R", "-w", "x.mod"]),
    ("modmap", ["-K", "16", "-W", "13", "-B", "20", "-f", "R", "-q", "R"]),
])
def test_small_cli_run_never_imports_jax(tmp_path, tool, args):
    from tests.util import random_fasta
    reads = random_fasta(tmp_path / "r.fa", 50, 400, seed=3)
    code = (_NO_JAX.replace("REPO", repr(REPO)).replace("TOOL", tool)
            .replace("ARGS", repr([str(reads) if a == "R" else a
                                   for a in args])))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]


# ---------------------------------------------------------- compile cache

_CACHE = r"""
import os, sys
sys.path.insert(0, REPO)
import modimizer
before = dict(os.environ)
modimizer.configure_jax()
import jax
print(jax.config.jax_compilation_cache_dir)
print(modimizer.jax_cache_dir())
print(dict(os.environ) == before)   # no runtime flag set in the env
"""


@pytest.mark.parametrize("preset", [False, True])
def test_compile_cache_dir(tmp_path, preset):
    env = _env(JAX_PLATFORMS="cpu")
    want = os.path.join(REPO, ".jax_cache")
    if preset:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run([sys.executable, "-c",
                        _CACHE.replace("REPO", repr(REPO))], env=env,
                       capture_output=True, text=True, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    cfg, ours, env_same = r.stdout.splitlines()[-3:]
    assert cfg == want and ours == want
    assert env_same == "True"


# ------------------------------------------------- no GPU, no result

def test_chip_smoke_fails_without_gpu(tmp_path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                       text=True, cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stdout + r.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                       env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                       text=True, cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_fails_without_gpu(tmp_path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       env=_env(JAX_PLATFORMS="cpu",
                                MODIMIZER_BENCH_DIR=str(tmp_path / "d")),
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert r.returncode != 0
    assert not any(ln.startswith("{") for ln in r.stdout.splitlines())
    assert not (tmp_path / "d").exists(), "generated data before the check"


# ------------------------------------------- smoke helpers, CPU at tiny C

KW = [(16, 16), (19, 31)]


@pytest.mark.parametrize("k,w", KW)
def test_smoke_helpers_cpu(k, w):
    """The step phase's device-vs-oracle checks at C = 2^15 on a
    multi-chunk stream with ragged read ends (scanner paths + n=1
    builder)."""
    from modimizer.parallel.sharded import build_mesh
    sh = Seqhash.create(k, w, 17)
    codes, offsets = chip_smoke.random_stream((1 << 16) + 777, 1000, k + w)
    oracle = chip_smoke.host_scan(sh, codes, offsets)
    r = chip_smoke.check_scanner_paths(sh, codes, offsets, 1 << 15, oracle)
    assert r["n_fallback"] == 0 and r["emits"] == len(oracle[0])
    b = chip_smoke.check_builder(sh, codes, offsets, build_mesh(1),
                                 oracle[0], chunk_per_dev=1 << 14)
    assert b["unique"] > 0


@pytest.mark.parametrize("backend", chip_smoke.AB_BACKENDS)
@pytest.mark.parametrize("k,w", KW)
def test_ab_candidate_matches_oracle(k, w, backend):
    """Every compaction backend in the A/B gives the oracle's rows."""
    import jax.numpy as jnp
    sh = Seqhash.create(k, w, 17)
    C = 1 << 15
    codes, offsets = chip_smoke.random_stream(C, 1000, 7)
    km_h, pos_h, _ = chip_smoke.host_scan(sh, codes, offsets)
    sw, vw, m = chip_smoke.chunk_inputs(sh, codes, offsets, C)
    compiled, _ = chip_smoke.kmers_step(sh, C, backend)
    tot = chip_smoke.check_kmers_step(
        compiled, (jnp.asarray(sw), jnp.asarray(vw)), km_h[pos_h < m], m)
    assert tot == int(np.sum(pos_h < m))


@pytest.mark.parametrize("k,w", KW)
def test_chosen_densify_equals_other(k, w):
    """The default densify and the other A/B candidate are bit-identical
    on the whole kmers-step output, sentinel padding included."""
    import jax.numpy as jnp
    from modimizer.ops.device_scan import densify_default
    sh = Seqhash.create(k, w, 17)
    C = 1 << 15
    codes, offsets = chip_smoke.random_stream(C, 700, 11)
    sw, vw, _m = chip_smoke.chunk_inputs(sh, codes, offsets, C)
    args = (jnp.asarray(sw), jnp.asarray(vw))
    outs = []
    chosen = densify_default()
    other = [d for d in chip_smoke.AB_DENSIFY if d != chosen]
    for mode in [chosen] + other:
        compiled, _ = chip_smoke.kmers_step(sh, C, densify=mode)
        outs.append([np.asarray(x) for x in compiled(*args)])
    assert len(outs) == 2
    for a, b in zip(outs[0], outs[1]):
        assert np.array_equal(a, b)


# ---------------------------------------------- the same, on the card

@pytest.mark.gpu
@pytest.mark.parametrize("k,w", KW)
def test_smoke_helpers_gpu(gpu, k, w):
    """Scanner paths and the n=1 builder at C = 2^23 on the GPU, exact."""
    from modimizer.parallel.sharded import build_mesh
    sh = Seqhash.create(k, w, 17)
    codes, offsets = chip_smoke.random_stream(3 << 23, 1000, k + w)
    oracle = chip_smoke.host_scan(sh, codes, offsets)
    r = chip_smoke.check_scanner_paths(sh, codes, offsets, 1 << 23, oracle)
    assert r["n_fallback"] == 0
    chip_smoke.check_builder(sh, codes, offsets, build_mesh(1), oracle[0])
    print(json.dumps(r))
