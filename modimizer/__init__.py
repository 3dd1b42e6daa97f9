"""modimizer — the modimizer toolkit on JAX/XLA with a native C++ host runtime.

A re-design of the capabilities of richarddurbin/modimizer for an accelerator
(one NVIDIA GPU, or a mesh of them):

- the rolling canonical k-mer hash + ``hash % d == 0`` modimizer filter runs as
  a vectorized XLA scan over 2-bit-packed base batches (ops/seqhash.py),
- the modset k-mer dictionary is built with device-side compaction plus an exact
  host-side open-addressed-table replay (core/modset.py + native/), preserving the
  reference's first-encounter-order ids and on-disk ``MSHSTv2`` byte layout
  (reference: modset.c:45-104),
- multi-device scaling shards the k-mer stream across a jax.sharding.Mesh with
  all_to_all routing by hash prefix and saturating-add merges (parallel/).

The CLI programs (cli/) mirror the reference's ordered-command surface
(modutils, modmap, modasm, composition, seqconvert, seqhoco, modrep, modtype).
"""

import os

# This container's (virtualized) host CPU executes some AVX512 code paths
# pathologically slowly; disable them for numpy when we're imported before
# numpy is.  Harmless elsewhere.
os.environ.setdefault(
    "NPY_DISABLE_CPU_FEATURES",
    "AVX512F AVX512CD AVX512_SKX AVX512_CLX AVX512_CNL AVX512_ICL")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# XLA's persistent compilation cache when JAX_COMPILATION_CACHE_DIR is unset:
# one fixed path (the path is part of the cache key, so it must not move)
DEFAULT_JAX_CACHE = os.path.join(REPO_ROOT, ".jax_cache")

_jax_configured = False


def jax_cache_dir() -> str:
    """Where compiled XLA programs are kept: JAX_COMPILATION_CACHE_DIR if
    set (JAX reads it itself), else DEFAULT_JAX_CACHE."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_JAX_CACHE


def configure_jax():
    """Configure jax for this framework; called by every module that uses
    the device path.  Importing jax costs ~2 s, so host-only CLI paths
    never trigger it.

    - x64: the seqhash math is 64-bit (kmer * factor1 mod 2^64; reference
      seqhash.h:58).  Must run before tracing.
    - persistent compilation cache: CLI invocations are separate processes,
      so only the first run pays the XLA compile cost.
    """
    global _jax_configured
    if _jax_configured:
        return
    import jax
    jax.config.update("jax_enable_x64", True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(DEFAULT_JAX_CACHE, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", DEFAULT_JAX_CACHE)
        except OSError:  # pragma: no cover - read-only checkout
            pass
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _jax_configured = True


def _enable_bytecode_cache():
    """This image sets PYTHONDONTWRITEBYTECODE=1, so every CLI run
    re-compiles every .py it imports — ours AND the venv's 300+
    non-precompiled numpy modules (~0.2 s of the ~0.33 s interpreter
    start the C binaries don't pay).  The venv is not ours to write, so
    redirect the bytecode cache into the repo (sys.pycache_prefix) and
    re-enable writing for everything imported after this point: the
    first run pays the compiles, every later start skips them.
    Writes are atomic (importlib _write_atomic), so concurrent CLI
    processes can prime the same cache safely."""
    import sys
    try:
        if sys.pycache_prefix is None and sys.dont_write_bytecode:
            d = os.path.join(REPO_ROOT, ".pycache")
            os.makedirs(d, exist_ok=True)
            sys.pycache_prefix = d
            sys.dont_write_bytecode = False
    except Exception:  # pragma: no cover - read-only checkout etc.
        pass


_enable_bytecode_cache()

# numpy madvises THP hugepages on every >=4 MB allocation; with this
# kernel's defrag policy ([madvise]) the first touch of such a region does
# DIRECT memory compaction — measured 2.1 s of system time for one scan's
# output buffers on this (fragmented) VM, vs 0.07 s of plain 4 KB faults.
# One-shot CLI processes never amortize that, so default it off.
# MODIMIZER_HUGEPAGES=1 restores numpy's default for long-running
# resident pipelines.  Runs AFTER _enable_bytecode_cache so the numpy
# import this triggers gets cached bytecode; the env knob is set before
# the import for numpy versions without the runtime setter (they read it
# once at import).
if os.environ.get("MODIMIZER_HUGEPAGES") != "1":
    os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    try:
        from numpy._core import multiarray as _np_ma
        _np_ma._set_madvise_hugepage(False)
    except (ImportError, AttributeError):  # older numpy: env knob above
        pass

__version__ = "0.1.0"
