"""Per-stage profiling for the device pipelines (SURVEY §5: "per-stage
wall/device timers + jax profiler traces").

Two layers, both default-off so the hot paths stay clean:

- MODIMIZER_STAGES=1: lightweight wall-clock stage accumulators printed to
  stderr at process exit (and on demand via report()).  Stages are nested
  ("scan.pack", "scan.drain", ...); each records total seconds and count.
- MODIMIZER_TRACE=<dir>: wraps the stage region of the FIRST top-level
  pipeline call in a jax.profiler trace written to <dir> (inspect with
  tensorboard or xprof), which splits transfer time from compute.
"""

import atexit
import os
import time
from contextlib import contextmanager

_stages = {}
_enabled = os.environ.get("MODIMIZER_STAGES") == "1"
_trace_dir = os.environ.get("MODIMIZER_TRACE")
_trace_active = [False]
_printed = [False]


def enabled() -> bool:
    return _enabled


@contextmanager
def stage(name):
    """Accumulate wall time under `name` (no-op unless MODIMIZER_STAGES=1)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        tot, cnt = _stages.get(name, (0.0, 0))
        _stages[name] = (tot + dt, cnt + 1)


@contextmanager
def trace_region():
    """jax profiler trace around a top-level pipeline call (first call only,
    no-op unless MODIMIZER_TRACE=<dir>)."""
    if not _trace_dir or _trace_active[0]:
        yield
        return
    import jax
    _trace_active[0] = True
    with jax.profiler.trace(_trace_dir):
        yield


def report(f=None):
    if not _stages:
        return
    import sys
    f = f or sys.stderr
    f.write("── stage timers (MODIMIZER_STAGES) ──\n")
    for name in sorted(_stages):
        tot, cnt = _stages[name]
        f.write("  %-24s %8.3f s  x%d\n" % (name, tot, cnt))
    f.flush()


def _exit_report():
    if _enabled and not _printed[0]:
        _printed[0] = True
        report()


atexit.register(_exit_report)
