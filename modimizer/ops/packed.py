"""Packed 2-bit stream helpers shared by the single-device scanner and the
sharded multi-device builder.

Host→device traffic is kept small: only ONE u64 word stream crosses the
link (0.25 B/base): the
forward stream ``sw`` packed big-endian-per-word.  The reverse-complement
stream ``tw`` is derived on device (2-bit-group reversal + complement), and
read-boundary validity crosses as packed bits (1/8 B/base).
"""

import modimizer

modimizer.configure_jax()

import jax.numpy as jnp
import numpy as np


def pack_sw(codes: np.ndarray, n_words: int) -> np.ndarray:
    """Host: sw[i] = sum_b codes[32i+b] << 2*(31-b) (big-endian per word)."""
    n = len(codes)
    c = np.zeros(n_words * 32, np.uint8)
    c[:n] = codes
    q = c.reshape(-1, 4)
    sb = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    return sb.reshape(-1, 8).view(">u8").astype(np.uint64).reshape(-1)


def pack_bits(mask: np.ndarray, n_words: int) -> np.ndarray:
    """Host: bit p of word p//64 = mask[p] (little-endian bit order)."""
    m = np.zeros(n_words * 64, bool)
    m[:len(mask)] = mask
    b = np.packbits(m, bitorder="little")
    return b.reshape(-1, 8).view("<u8").astype(np.uint64).reshape(-1)


def expand_sparse_valid(sv_idx, sv_val, m, NV: int):
    """Device: rebuild [NV] u64 validity words from a sorted sparse
    exception list — word i = sv_val[j] where sv_idx[j] == i, else
    all-ones — then clear every bit at position >= m (the chunk's live
    count).  Validity words are almost all ones (exceptions only where a
    read ends), so shipping (idx, val) pairs instead of the dense plane
    cuts the host->device bytes ~8x; this expansion is log2(P) gather
    rounds over [NV], trivially cheap next to the scan itself.

    sv_idx: i32 [P] sorted, padded with a value >= NV.  sv_val: u64 [P]."""
    P = sv_idx.shape[0]
    base = jnp.arange(NV, dtype=jnp.int32)
    lo = jnp.zeros(NV, jnp.int32)
    hi = jnp.full(NV, P - 1, jnp.int32)
    for _ in range(max(1, (P - 1).bit_length())):   # smallest j with
        mid = (lo + hi) >> 1                        # sv_idx[j] >= base
        ge = sv_idx[mid] >= base
        hi = jnp.where(ge, mid, hi)
        lo = jnp.where(ge, lo, mid + 1)
    full = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    v = jnp.where(sv_idx[hi] == base, sv_val[hi], full)
    m = m.astype(jnp.int32)
    nfull = m >> 5 >> 1                             # m // 64
    rem = (m & 63).astype(jnp.uint64)
    tail = jnp.where(base < nfull, full,
                     jnp.where(base == nfull,
                               (jnp.uint64(1) << rem) - jnp.uint64(1),
                               jnp.uint64(0)))
    return v & tail


def grev64(x):
    """Device: reverse the order of the 32 2-bit groups in each u64."""
    m2 = jnp.uint64(0x3333333333333333)
    m4 = jnp.uint64(0x0F0F0F0F0F0F0F0F)
    m8 = jnp.uint64(0x00FF00FF00FF00FF)
    m16 = jnp.uint64(0x0000FFFF0000FFFF)
    x = ((x & m2) << jnp.uint64(2)) | ((x >> jnp.uint64(2)) & m2)
    x = ((x & m4) << jnp.uint64(4)) | ((x >> jnp.uint64(4)) & m4)
    x = ((x & m8) << jnp.uint64(8)) | ((x >> jnp.uint64(8)) & m8)
    x = ((x & m16) << jnp.uint64(16)) | ((x >> jnp.uint64(16)) & m16)
    return (x << jnp.uint64(32)) | (x >> jnp.uint64(32))


def derive_tw(sw):
    """Device: tw[i] = complement of 2-bit-group-reversed sw[i].

    sw is big-endian per word (base b at bits 62-2b..63-2b); tw is the
    complemented stream little-endian per word (base b at bits 2b..2b+1).
    Reversing the order of the 32 2-bit groups maps one to the other, and
    3-v == ~v in 2 bits, so: tw = ~group_reverse(sw)."""
    return ~grev64(sw)


def expand_bits(words, C: int):
    """Device: unpack u64 bit-words into a bool vector of length C."""
    nw = words.shape[0]
    shifts = jnp.arange(64, dtype=jnp.uint64)[None, :]
    bits = (words[:, None] >> shifts) & jnp.uint64(1)
    return bits.reshape(-1)[:C].astype(jnp.bool_)


def extract_kmers(sw, tw, k: int, C: int):
    """Device: (h, hrc) canonical k-mer halves for C positions.

    sw/tw must have C//32 + 1 words (one halo word).  Position p = 32i + r is
    extracted with a constant-shift two-word funnel per phase r — O(1) work
    per position, no gathers."""
    NW = C // 32
    shift1 = jnp.uint64(64 - 2 * k)
    mask2k = jnp.uint64((1 << (2 * k)) - 1)
    w0s, w1s = sw[:NW], sw[1:NW + 1]
    w0t, w1t = tw[:NW], tw[1:NW + 1]
    h_cols, r_cols = [], []
    for r in range(32):
        if r == 0:
            hs, ht = w0s, w0t
        else:
            hs = (w0s << jnp.uint64(2 * r)) | (w1s >> jnp.uint64(64 - 2 * r))
            ht = (w0t >> jnp.uint64(2 * r)) | (w1t << jnp.uint64(64 - 2 * r))
        h_cols.append(hs >> shift1)
        r_cols.append(ht & mask2k)
    h = jnp.stack(h_cols, axis=1).reshape(-1)
    hrc = jnp.stack(r_cols, axis=1).reshape(-1)
    return h, hrc


def canonical_hashes(h, hrc, k: int, factor1: int):
    """Device: seqhash.h:58 hashes + canonical selection."""
    f1 = jnp.uint64(factor1)
    shift1 = jnp.uint64(64 - 2 * k)
    hf = (h * f1) >> shift1
    hr = (hrc * f1) >> shift1
    isF = hf < hr
    return jnp.where(isF, hf, hr), jnp.where(isF, h, hrc), isF


def _is_pow2(x):
    return x > 0 and (x & (x - 1)) == 0


def _inv_odd(m, bits):
    """Modular inverse of odd m mod 2^bits (Newton, exact Python ints)."""
    x = m
    for _ in range(6):
        x = (x * (2 - m * x)) % (1 << bits)
    return x


def mod_is_zero(hashes, w):
    """hashes % w == 0 without division.

    Power-of-two w (the headline-bench w=16) is a mask test.  Any other w
    (incl. the reference DEFAULT w=31, modutils.c:140) uses the
    Lemire-Kaser divisibility test: for w = m * 2^t (m odd),
    n % w == 0  <=>  ror(n * inv(m), t) <= (2^bits - 1) // w — one mullo,
    a rotate, a compare, instead of an emulated u64 modulo; a u64 mullo is
    3-4 u32 mullos."""
    if hashes.dtype == jnp.uint32:      # u32 front (k <= 16): hash < 2^32
        if _is_pow2(w):
            return (hashes & jnp.uint32(w - 1)) == jnp.uint32(0)
        t = (w & -w).bit_length() - 1
        prod = hashes * jnp.uint32(_inv_odd(w >> t, 32))
        if t:
            prod = (prod >> jnp.uint32(t)) | (prod << jnp.uint32(32 - t))
        return prod <= jnp.uint32(((1 << 32) - 1) // w)
    if _is_pow2(w) and w <= (1 << 32):
        lo = (hashes & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        return (lo & jnp.uint32(w - 1)) == jnp.uint32(0)
    t = (w & -w).bit_length() - 1
    prod = hashes * jnp.uint64(_inv_odd(w >> t, 64))
    if t:
        prod = (prod >> jnp.uint64(t)) | (prod << jnp.uint64(64 - t))
    return prod <= jnp.uint64(((1 << 64) - 1) // w)


def div_mod_owner(hashes, w, n):
    """(hashes // w) % n as u32, with pow2 fast paths."""
    if _is_pow2(w):
        q = hashes >> jnp.uint64(w.bit_length() - 1)
    else:
        q = hashes // jnp.uint64(w)
    if _is_pow2(n) and n <= (1 << 31):
        return ((q & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
                & jnp.uint32(n - 1))
    return (q % jnp.uint64(n)).astype(jnp.uint32)
