"""Host-or-device routing: the one policy the scanner, modutils, modmap and
modasm share.

A job of ``n`` units (stream positions, or readset hits for the overlap
engines) runs on the device when its knob says so, or, by default, when it
is at least ``threshold`` units and JAX's backend is a GPU.  Below the
threshold, or when JAX_PLATFORMS names no GPU platform, the decision is
made without importing jax (~2 s), so small CLI runs stay host-only.

Knob values (``MODIMIZER_SCAN`` for scans and lookups,
``MODIMIZER_OVERLAPS`` for modasm's overlap discovery):

- ``host``: never the device;
- ``device``: always the device.  Raises when JAX finds no GPU, unless
  JAX_PLATFORMS names ``cpu`` explicitly — that runs the device programs
  on XLA's CPU backend, which is how the CPU test suite exercises them;
- ``auto`` (default): ``n >= threshold`` and a GPU backend.

With ``MODIMIZER_ROUTE_LOG=1`` every decision and the device path's
counters are written to stderr as ``modimizer-route: ...`` lines.
"""

import functools
import os
import sys

_GPU_PLATFORMS = ("cuda", "gpu")


def _platforms():
    return [p.strip().lower()
            for p in os.environ.get("JAX_PLATFORMS", "").split(",")
            if p.strip()]


@functools.lru_cache(maxsize=None)
def backend_platform() -> str:
    """JAX's default backend ('gpu', 'cpu', ...); initializes jax."""
    import modimizer
    modimizer.configure_jax()
    import jax
    return jax.default_backend()


def log(msg: str) -> None:
    """One ``modimizer-route:`` stderr line when MODIMIZER_ROUTE_LOG is set."""
    if os.environ.get("MODIMIZER_ROUTE_LOG"):
        sys.stderr.write("modimizer-route: %s\n" % msg)
        sys.stderr.flush()


def use_device(n: int, threshold: int, knob: str = "MODIMIZER_SCAN") -> bool:
    """Whether a job of n units takes the device path (see module doc)."""
    mode = os.environ.get(knob, "auto")
    if mode == "host":
        return False
    if mode == "device":
        plat = backend_platform()
        if plat != "gpu" and "cpu" not in _platforms():
            raise RuntimeError(
                f"{knob}=device but JAX found no GPU (backend {plat!r}); "
                "set JAX_PLATFORMS=cpu to run the device programs on the CPU")
        log(f"{knob} n={n} -> device ({plat}, forced)")
        return True
    if mode != "auto":
        raise ValueError(f"{knob} must be host, device or auto, not {mode!r}")
    if n < threshold:
        return False
    plats = _platforms()
    if plats and not any(p in _GPU_PLATFORMS for p in plats):
        return False
    on = backend_platform() == "gpu"
    log(f"{knob} n={n} -> {'device (gpu)' if on else 'host'}")
    return on
