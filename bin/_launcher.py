"""Shared launcher: put the repo on sys.path and dispatch to a CLI module."""
import os
import signal
import sys


def launch(tool):
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)  # die silently like C tools
    os.environ.setdefault(
        "NPY_DISABLE_CPU_FEATURES",
        "AVX512F AVX512CD AVX512_SKX AVX512_CLX AVX512_CNL AVX512_ICL")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import importlib
    mod = importlib.import_module(f"modimizer.cli.{tool}")
    mod.main()
