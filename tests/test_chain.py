"""Batched device chaining (parallel/chain.py) vs a literal python oracle
of the reference automaton (queryProcess, modmap.c:216-280)."""

import numpy as np
import pytest


class FakeRef:
    def __init__(self, rev, loc, rid, info):
        self.rev = rev
        self.loc = loc
        self.id = rid

        class MS:
            pass
        self.ms = MS()
        self.ms.info = info


def oracle(ref, sidx, spos, seed_off):
    """Literal transcription of modmap.c:216-280 (incl. the loc0==0 "no
    block" quirk, the copy2 retry, and the final n2>2 gate)."""
    info = ref.ms.info
    out_all = []
    for rd in range(len(seed_off) - 1):
        out = []
        loc0 = locN = i0 = iN = 0
        p0 = pN = 0
        n1 = n2 = 0
        for t in range(seed_off[rd], seed_off[rd + 1]):
            idx = sidx[t]
            if idx == 0 or (info[idx] & 3) == 3:
                continue
            loc = int(ref.rev[ref.loc[idx]])
            is1 = (info[idx] & 3) == 1

            def end_block(loc):
                if ref.id[loc] != ref.id[loc0]:
                    return True
                if loc0 < locN:
                    if loc < locN:
                        return True
                    d = locN - loc0 - iN + i0
                    if d > 50 or d < -50:
                        return True
                elif loc0 > locN:
                    if loc > locN:
                        return True
                    d = loc0 - locN - iN + i0
                    if d > 50 or d < -50:
                        return True
                return False

            end = (loc0 == 0) or end_block(loc)
            if end and loc0 and not is1:
                loc = int(ref.rev[ref.loc[idx] + 1])
                end = end_block(loc)
            if end:
                if n1 > 2:
                    out.append((p0, pN, loc0, locN, n1, n2, 0))
                n1 = n2 = 0
                loc0 = loc
                i0 = t - seed_off[rd]
                p0 = int(spos[t])
            if is1:
                n1 += 1
            else:
                n2 += 1
            locN = loc
            iN = t - seed_off[rd]
            pN = int(spos[t])
        if n2 > 2:
            out.append((p0, pN, loc0, locN, n1, n2, 1))
        out_all.append(out)
    return out_all


def make_case(seed, n_reads=40, n_mods=300, n_refs=3):
    """Random reference occurrence structure + seed lists: each mod copy1
    (1 occurrence) or copy2 (2) or copyM/absent; reads sample runs of
    nearby occurrences (so real blocks form) plus noise."""
    rng = np.random.default_rng(seed)
    info = np.zeros(n_mods + 1, np.uint8)
    # copy in {1,2,M}: a FOUND seed always has copy >= 1 in a real
    # reference (copy assigned from occurrence counts, modmap.c:125-130)
    info[1:] = rng.choice([1, 1, 2, 2, 3], n_mods).astype(np.uint8)
    n_occ = np.where((info & 3) == 1, 1, np.where((info & 3) == 2, 2, 1))
    n_occ[0] = 1
    loc = np.concatenate([[0], np.cumsum(n_occ[:-1])]).astype(np.uint32)
    total = int(n_occ.sum())
    rev = rng.permutation(total).astype(np.uint32)
    bounds = np.sort(rng.choice(total, n_refs - 1, replace=False))
    rid = np.searchsorted(bounds, np.arange(total), side="right"
                          ).astype(np.uint32)
    sidx, spos, off = [], [], [0]
    for _ in range(n_reads):
        ns = int(rng.integers(0, 60))
        p = 0
        for _ in range(ns):
            p += int(rng.integers(1, 40))
            spos.append(p)
            if rng.random() < 0.15:
                sidx.append(0)
            else:
                sidx.append(int(rng.integers(1, n_mods + 1)))
        off.append(len(sidx))
    return (FakeRef(rev, loc, rid, info),
            np.array(sidx, np.uint32), np.array(spos, np.int64),
            np.array(off, np.int64))


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_chain_scan_matches_oracle(seed):
    from modimizer.parallel.chain import chain_records
    ref, sidx, spos, off = make_case(seed)
    want = oracle(ref, sidx, spos, off)
    got = chain_records(ref, sidx, spos, off, cap=2)  # force widen path
    for rd in range(len(off) - 1):
        got_rd = [tuple(int(v) for v in r) for r in got[rd]]
        assert got_rd == want[rd], (seed, rd)
