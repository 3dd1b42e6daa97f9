"""Minimizer scan: host oracle vs the reference iterator, device vs spec."""

import subprocess

import numpy as np
import pytest

from tests.golden import harness

pytestmark = pytest.mark.skipif(not harness.reference_available(),
                                reason="reference not available")

DRIVER_SRC = r"""
/* golden driver: print reference minimizer emissions for one 0..3-coded
   sequence; links the unmodified reference seqhash. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "seqhash.h"
int main(int argc, char **argv) {
  int k = atoi(argv[1]), w = atoi(argv[2]), seed = atoi(argv[3]);
  char *txt = argv[4];
  int len = strlen(txt);
  char *s = malloc(len);
  for (int i = 0; i < len; ++i) s[i] = txt[i] - '0';
  Seqhash *sh = seqhashCreate(k, w, seed);
  SeqhashRCiterator *mi = minimizerRCiterator(sh, s, len);
  U64 u; int pos; bool isF;
  while (minimizerRCnext(mi, &u, &pos, &isF))
    printf("%llu %d %d\n", (unsigned long long)u, pos, (int)isF);
  return 0;
}
"""


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    d = tmp_path_factory.mktemp("minim")
    src = d / "driver.c"
    src.write_text(DRIVER_SRC)
    exe = d / "driver"
    subprocess.run(
        ["gcc", "-O2", "-w", "-I", str(harness.REF), "-o", str(exe),
         str(src), str(harness.REF / "seqhash.c"),
         str(harness.REF / "utils.c"), str(harness.SHIM), "-lz", "-lm"],
        check=True, capture_output=True)
    return exe


def test_minimizer_host_oracle_matches_reference(driver):
    from modimizer.core.seqhash import Seqhash
    from modimizer.ops.minimizer import minimizer_scan_host
    rng = np.random.default_rng(3)
    for _ in range(25):
        k = int(rng.integers(8, 24))
        w = int(rng.integers(3, 40))
        n = int(rng.integers(k, 2500))
        codes = rng.integers(0, 4, size=n).astype(np.uint8)
        txt = "".join(str(c) for c in codes)
        r = subprocess.run([str(driver), str(k), str(w), "17", txt],
                           capture_output=True, text=True, check=True)
        ref = [tuple(map(int, l.split())) for l in r.stdout.splitlines()]
        sh = Seqhash.create(k, w, 17)
        hu, hp, hf = minimizer_scan_host(sh, codes)
        mine = list(zip(hu.tolist(), hp.tolist(), [int(x) for x in hf]))
        assert ref == mine, (k, w, n)


def test_minimizer_device_all_window_set():
    """The device variant computes the exact all-window minimizer set."""
    from modimizer.core.seqhash import Seqhash
    from modimizer.ops.minimizer import minimizer_scan
    rng = np.random.default_rng(5)
    for _ in range(8):
        k = int(rng.integers(8, 24))
        w = int(rng.integers(3, 30))
        n = int(rng.integers(k + w + 2, 4000))
        codes = rng.integers(0, 4, size=n).astype(np.uint8)
        sh = Seqhash.create(k, w, 17)
        _km, hashes, _f = sh.scan(codes)
        npos = len(hashes)
        want = set()
        for s0 in range(npos - w + 1):
            wnd = hashes[s0:s0 + w]
            m = wnd.min()
            for j in np.nonzero(wnd == m)[0]:
                want.add(s0 + int(j))
        _du, dp, _df = minimizer_scan(sh, codes, chunk=512)
        assert set(dp.tolist()) == want, (k, w, n)
