"""Device k-mer table lookup (parallel/lookup.py) vs the native
open-addressed probe oracle (modsetIndexFind semantics)."""

import numpy as np
import pytest

from modimizer.core.modset import Modset
from modimizer.core.seqhash import Seqhash
from modimizer.parallel.lookup import DeviceTable
from modimizer.parallel.sharded import build_mesh


@pytest.fixture(scope="module")
def table():
    sh = Seqhash.create(16, 16, 17)
    rng = np.random.default_rng(9)
    kmers = np.unique(rng.integers(0, 1 << 32, 60000, dtype=np.uint64))
    rng.shuffle(kmers)
    ms = Modset(sh, 20)
    ms.add_batch(kmers)
    return sh, ms, kmers


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_device_lookup_matches_native(table, n_dev):
    import jax
    if jax.device_count() < n_dev:
        pytest.skip("not enough devices")
    sh, ms, kmers = table
    mesh = build_mesh(n_dev)
    dt = DeviceTable(ms.value[1:ms.max + 1],
                     np.arange(1, ms.max + 1, dtype=np.uint32), sh, mesh)
    rng = np.random.default_rng(10)
    # half present, half absent, plus a sentinel-valued query
    present = rng.choice(kmers, 5000)
    absent = rng.integers(1 << 33, 1 << 40, 5000).astype(np.uint64)
    q = np.concatenate([present, absent,
                        np.array([0xFFFFFFFFFFFFFFFF], np.uint64)])
    rng.shuffle(q)
    got = dt.find(q)
    want = ms.find_batch(q)
    assert np.array_equal(got, want)


def test_device_lookup_empty(table):
    sh, ms, _ = table
    dt = DeviceTable(ms.value[1:ms.max + 1],
                     np.arange(1, ms.max + 1, dtype=np.uint32), sh,
                     build_mesh(1))
    assert len(dt.find(np.zeros(0, np.uint64))) == 0
