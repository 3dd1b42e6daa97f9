"""Minimizer (window-minimum) scan — the reference's second sampling mode
(minimizerRCiterator/minimizerRCnext, seqhash.c:83-152).

``minimizer_scan_host`` is an exact transliteration of the reference's
circular-buffer winnowing loop (the parity oracle), including:
 - ties resolved by circular buffer index, not stream position,
 - past-the-end advances returning U64MAX with the orientation flag left
   stale (advanceHashRC, seqhash.c:70-79),
 - the end-of-sequence rule that only values strictly smaller than the last
   emitted minimum keep being emitted (seqhash.c:142-149).

``minimizer_scan`` is the device-native sampling variant: the classic
*all-window* minimizer set (a position is kept iff its canonical hash is
the minimum of some full w-window covering it), computable with two sliding
passes (window-min then covering window-max) — position-exact and
order-free, so chromosome-scale sequences tile across chunks/devices with a
(w-1)+(k-1) halo (the "context parallel" design from SURVEY.md section 5).
NB this is deliberately NOT the reference's emission set: the reference
iterator *jumps* — each next window starts right after the previous minimum
(seqhash.c:128-139) — which skips some all-window minima and is inherently
sequential; the guaranteed-match property of sampling (any window-min shared
by two sequences is sampled in both) holds for the superset too.
"""

import functools

import modimizer

modimizer.configure_jax()

import jax
import jax.numpy as jnp
import numpy as np

from ..core.seqhash import Seqhash
from .packed import canonical_hashes, derive_tw, extract_kmers, pack_sw

U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def minimizer_scan_host(sh: Seqhash, codes: np.ndarray):
    """Exact port of the reference iterator over one sequence.

    Returns (hashes u64, positions int64, isF bool) in emission order."""
    codes = np.ascontiguousarray(codes).view(np.uint8)
    n = len(codes)
    k, w = sh.k, sh.w
    if n < k:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(0, bool))
    _kms, hashes, isF = sh.scan(codes)
    npos = len(hashes)

    hb = np.zeros(w, np.uint64)
    fb = np.zeros(w, bool)
    t = 0  # advances made so far; advance t produces hashes[t] or U64MAX

    def adv(i):
        nonlocal t
        t += 1
        if t < npos:
            hb[i] = hashes[t]
            fb[i] = isF[t]
        else:
            hb[i] = U64MAX  # fb stays stale, like the reference

    # NB reference bug kept: minimizerRCiterator never stores the first
    # hash into hashBuf[0] (seqhash.c:100), so a first-window minimum at
    # buffer slot 0 is emitted as 0
    fb[0] = isF[0]
    mn = hashes[0]
    i_min = 0
    for i in range(1, w):
        adv(i)
        if hb[i] < mn:
            mn = hb[i]
            i_min = i
    i_start = 0
    base = 0
    out_u, out_p, out_f = [], [], []

    while True:
        u = hb[i_min]
        pos = base + i_min + (w if i_min < i_start else 0)
        out_u.append(u)
        out_p.append(pos)
        out_f.append(bool(fb[i_min]))
        if t >= npos - 1:  # si->s >= si->sEnd (seqhash.c:124)
            break
        if i_min >= i_start:
            for i in range(i_start, i_min + 1):
                adv(i)
        else:
            for i in range(i_start, w):
                adv(i)
            base += w
            for i in range(0, i_min + 1):
                adv(i)
        old = i_min
        i_start = i_min + 1
        if i_start == w:
            i_start = 0
            base += w
        if hb[old] != U64MAX:  # a full new window exists
            mn = U64MAX
            found = -2  # any slot < U64MAX will win
        else:  # keep the last min; only strictly smaller values count
            mn = u
            found = -1
        for i in range(w):
            if hb[i] < mn:
                mn = hb[i]
                found = i
        if found == -1:
            break  # old min not beaten - done
        i_min = found if found >= 0 else i_min

    return (np.array(out_u, np.uint64), np.array(out_p, np.int64),
            np.array(out_f, bool))


def _sliding(op, x, w, pad):
    """w-wide sliding op via log-step shifts: out[i] = op(x[i..i+w-1])."""
    out = x
    done = 1
    while done < w:
        step = min(done, w - done)
        shifted = jnp.concatenate(
            [out[step:], jnp.full(step, pad, x.dtype)])
        out = op(out, shifted)
        done += step
    return out


@functools.partial(jax.jit, static_argnames=("k", "w", "factor1", "C"))
def _minimizer_chunk(sw, m_ext, n_win, base, *, k, w, factor1, C):
    """Device pass over a block of C hash positions (32-aligned, with
    backward+forward w-1 halos included by the caller).

    m_ext: live hash positions in the block; n_win: global number of FULL
    windows; base: global position of the block's first hash."""
    Cext = C
    tw = derive_tw(sw)
    h, hrc = extract_kmers(sw, tw, k, Cext)
    hashes, _kmers, isF = canonical_hashes(h, hrc, k, factor1)
    pos = jax.lax.broadcasted_iota(jnp.int32, (Cext, 1), 0)[:, 0]
    hh = jnp.where(pos < m_ext, hashes, jnp.uint64(U64MAX))
    # A[s] = min over the w hashes starting at s
    A = _sliding(jnp.minimum, hh, w, U64MAX)
    # only full windows count: s + base <= n_win - 1 (global)
    valid = (pos + base) < n_win
    A_masked = jnp.where(valid, A, jnp.uint64(0))
    # M[p] = max of A over window starts covering p (s in [p-w+1, p])
    Arev = A_masked[::-1]
    M = _sliding(jnp.maximum, Arev, w, jnp.uint64(0))[::-1]
    covered = _sliding(jnp.maximum, valid[::-1].astype(jnp.uint32), w,
                       jnp.uint32(0))[::-1] > 0
    emitted = (M == hh) & (pos < m_ext) & covered
    return hashes, isF, emitted


def minimizer_scan(sh: Seqhash, codes: np.ndarray, chunk: int = 1 << 22):
    """Device all-window minimizer scan of one sequence (see module doc:
    a superset of the reference's jump-chain emissions)."""
    codes = np.ascontiguousarray(codes).view(np.uint8)
    n = len(codes)
    k, w = sh.k, sh.w
    if n < k:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(0, bool))
    npos = n - k + 1
    if npos < w:  # no full windows
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(0, bool))
    n_win = npos - w + 1  # number of full windows

    out_h, out_p, out_f = [], [], []
    C = min(chunk, ((npos + 63) // 64) * 64)
    # backward halo of w-1 positions: windows covering a chunk's first
    # positions start in the previous chunk
    Cext = ((C + 2 * (w - 1) + 31) // 32) * 32
    for s in range(0, npos, C):
        lo = min(w - 1, s)
        base_pos = s - lo
        m_ext = min(Cext, npos - base_pos)
        seg = codes[base_pos:base_pos + Cext + k - 1]
        sw = pack_sw(seg, Cext // 32 + 1)
        hh, ff, em = _minimizer_chunk(
            jnp.asarray(sw), jnp.int32(m_ext), jnp.int32(n_win),
            jnp.int32(base_pos), k=k, w=w, factor1=sh.factor1, C=Cext)
        m = min(C, npos - s)
        em = np.asarray(em[lo:lo + m])
        idx = np.nonzero(em)[0]
        out_h.append(np.asarray(hh[lo:lo + m])[idx])
        out_p.append(idx + s)
        out_f.append(np.asarray(ff[lo:lo + m])[idx])
    return (np.concatenate(out_h), np.concatenate(out_p).astype(np.int64),
            np.concatenate(out_f))
