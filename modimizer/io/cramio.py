"""CRAM 3.0 reader (+ a spec-valid writer used by tests and seqconvert).

The reference ingests CRAM through htslib (seqio.c:722-835, `-DBAMIO`,
Makefile:26-29); this module reimplements the read path natively for the
default samtools codec set: raw/gzip/bzip2/lzma/rANS-4x8 block compression,
EXTERNAL / HUFFMAN / BETA / GAMMA / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP record
encodings, unmapped records (BA series) and mapped records reconstructed
against an EMBEDDED reference (substitutions via the SM matrix, insertions,
deletions, clips).  CRAM files that require an external reference resolve
it the way htslib does (cram/cram_io.c cram_populate_ref): the SAM header's
@SQ M5 tag expanded through the REF_CACHE / REF_PATH templates first, then
the @SQ UR tag as a local file (file:// or plain path, relative to the CRAM
file's directory); loaded references are whitespace-stripped + uppercased
(the REF_CACHE normal form) and verified against the @SQ M5 and the slice
header's reference-span MD5.  When nothing resolves, the decode dies with
an explicit message listing what was tried (no egress here, so htslib's
final EBI-server fallback is not replicated).

No htslib/samtools/pysam exists in this environment to produce golden
files, so the writer below doubles as the test generator: it emits
spec-section-accurate containers (itf8/ltf8 headers, CRC32s, slice +
compression-header maps) exercising every decoder path; BAM/CRAM twins of
the same reads must parse identically through the modset pipeline.

Layout follows the CRAM 3.0 specification (samtools/hts-specs CRAMv3.pdf):
  file definition / containers (sec 9), blocks (sec 8), compression header
  maps (sec 8.1), slice header (sec 8.5), record series (sec 10),
  rANS 4x8 (sec 13).
"""

import struct
import zlib

import numpy as np

# ------------------------------------------------------------------
# varint codecs (spec sec 2.3): ITF8 (32-bit) and LTF8 (64-bit)
# ------------------------------------------------------------------


def itf8_put(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    # 5 bytes: the LAST byte contributes only its low 4 bits (spec quirk)
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def itf8_get(buf, p):
    b0 = buf[p]
    if b0 < 0x80:
        return b0, p + 1
    if b0 < 0xC0:
        return ((b0 << 8) | buf[p + 1]) & 0x3FFF, p + 2
    if b0 < 0xE0:
        return ((b0 << 16) | (buf[p + 1] << 8) | buf[p + 2]) & 0x1FFFFF, p + 3
    if b0 < 0xF0:
        v = ((b0 << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8)
             | buf[p + 3]) & 0x0FFFFFFF
        return v, p + 4
    v = (((b0 & 0x0F) << 28) | (buf[p + 1] << 20) | (buf[p + 2] << 12)
         | (buf[p + 3] << 4) | (buf[p + 4] & 0x0F))
    return v, p + 5


def itf8_signed(v: int) -> int:
    return v - 0x100000000 if v >= 0x80000000 else v


def ltf8_put(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24)]) + v.to_bytes(4, "big")[1:]
    if v < 0x800000000:
        return bytes([0xF0 | (v >> 32)]) + (v & 0xFFFFFFFF).to_bytes(4, "big")
    if v < 0x40000000000:
        return bytes([0xF8 | (v >> 40)]) + (v & 0xFFFFFFFFFF).to_bytes(5, "big")
    if v < 0x2000000000000:
        return bytes([0xFC | (v >> 48)]) + (v & 0xFFFFFFFFFFFF).to_bytes(6, "big")
    if v < 0x100000000000000:
        return bytes([0xFE]) + v.to_bytes(7, "big")
    return bytes([0xFF]) + v.to_bytes(8, "big")


def ltf8_get(buf, p):
    b0 = buf[p]
    if b0 < 0x80:
        return b0, p + 1
    if b0 < 0xC0:
        return ((b0 << 8) | buf[p + 1]) & 0x3FFF, p + 2
    if b0 < 0xE0:
        return ((b0 << 16) | (buf[p + 1] << 8) | buf[p + 2]) & 0x1FFFFF, p + 3
    if b0 < 0xF0:
        return (((b0 & 0x0F) << 24)
                | int.from_bytes(buf[p + 1:p + 4], "big")), p + 4
    if b0 < 0xF8:
        return (((b0 & 0x07) << 32)
                | int.from_bytes(buf[p + 1:p + 5], "big")), p + 5
    if b0 < 0xFC:
        return (((b0 & 0x03) << 40)
                | int.from_bytes(buf[p + 1:p + 6], "big")), p + 6
    if b0 < 0xFE:
        return (((b0 & 0x01) << 48)
                | int.from_bytes(buf[p + 1:p + 7], "big")), p + 7
    if b0 == 0xFE:
        return int.from_bytes(buf[p + 1:p + 8], "big"), p + 8
    return int.from_bytes(buf[p + 1:p + 9], "big"), p + 9


# ------------------------------------------------------------------
# rANS 4x8 (spec sec 13): 12-bit frequencies, 4 interleaved states,
# byte-wise renormalisation at L = 1 << 23
# ------------------------------------------------------------------

RANS_L = 1 << 23
TOTFREQ = 4096


def _norm_freqs(counts):
    """Normalise symbol counts to sum TOTFREQ, keeping nonzero symbols
    nonzero (spec sec 13.4)."""
    tot = counts.sum()
    if tot == 0:
        return counts
    f = (counts.astype(np.float64) * TOTFREQ / tot).astype(np.int64)
    f[(counts > 0) & (f == 0)] = 1
    # fix rounding drift on the most frequent symbol
    diff = TOTFREQ - f.sum()
    f[int(np.argmax(f))] += diff
    if f[int(np.argmax(f))] <= 0:
        raise ValueError("rans frequency normalisation failed")
    return f


def _rle_sym_bytes(present):
    """The spec's ascending-symbol run-length scheme (sec 13.6): a symbol
    is written plainly; when it directly follows another present symbol, a
    run byte counting the remaining consecutive present symbols follows
    it, and those symbols are implied.  Yields (sym, head_bytes) per
    present symbol — head_bytes is b'' for implied run members."""
    out = []
    rle = 0
    for s in range(256):
        if not present[s]:
            continue
        if rle:
            rle -= 1
            out.append((s, b""))
            continue
        head = bytes([s])
        if s and present[s - 1]:
            r = s + 1
            while r < 256 and present[r]:
                r += 1
            rle = r - (s + 1)
            head += bytes([rle])
        out.append((s, head))
    return out


def _write_freqs0(f):
    """Order-0 frequency table serialisation (spec 13.6)."""
    out = bytearray()
    for s, head in _rle_sym_bytes(f > 0):
        out += head
        fv = int(f[s])
        if fv < 0x80:
            out.append(fv)
        else:
            out.append(0x80 | (fv >> 8))
            out.append(fv & 0xFF)
    out.append(0)
    return bytes(out)


def _read_freqs0(buf, p):
    f = np.zeros(256, np.int64)
    rle = 0
    j = buf[p]
    p += 1
    while True:
        fv = buf[p]
        p += 1
        if fv & 0x80:
            fv = ((fv & 0x7F) << 8) | buf[p]
            p += 1
        f[j] = fv
        if rle:
            rle -= 1
            j += 1
        elif p < len(buf) and buf[p] == j + 1:
            j = buf[p]
            p += 1
            rle = buf[p]
            p += 1
        else:
            j = buf[p]
            p += 1
            if j == 0:
                break
    return f, p


def rans_encode(data: bytes, order: int = 0) -> bytes:
    """rANS 4x8 compress (order 0 or 1) — spec sec 13."""
    data = bytes(data)
    n = len(data)
    if n == 0:
        comp = b""
        if order == 0:
            comp = _write_freqs0(np.zeros(256, np.int64))
        return (bytes([order]) + struct.pack("<II", len(comp) + 16, 0)
                + comp + struct.pack("<IIII", RANS_L, RANS_L, RANS_L, RANS_L))
    arr = np.frombuffer(data, np.uint8)
    if order == 0:
        f = _norm_freqs(np.bincount(arr, minlength=256))
        cum = np.zeros(257, np.int64)
        np.cumsum(f, out=cum[1:])
        tab = _write_freqs0(f)
        # encode in reverse, 4 interleaved states; renorm bytes are emitted
        # in reverse time so the final reversal matches the decoder's
        # forward consumption; states land LE after the table (sec 13.3)
        states = [RANS_L] * 4
        out = bytearray()
        for i in range(n - 1, -1, -1):
            j = i & 3
            s = arr[i]
            x = states[j]
            freq = int(f[s])
            x_max = ((RANS_L >> 12) << 8) * freq
            while x >= x_max:
                out.append(x & 0xFF)
                x >>= 8
            states[j] = ((x // freq) << 12) + (x % freq) + int(cum[s])
        payload = tab + struct.pack("<IIII", *states) + bytes(reversed(out))
    else:
        # order-1: one table per previous-byte context; stream split in 4
        # quarters, each decoded by one state with ctx 0 at quarter start
        isz4 = n >> 2
        f = np.zeros((256, 256), np.int64)
        starts = [0, isz4, 2 * isz4, 3 * isz4]
        for q in range(4):
            lo = starts[q]
            hi = starts[q + 1] if q < 3 else n
            if lo < hi:
                f[0, arr[lo]] += 1
        ctx = arr[:-1]
        nxt = arr[1:]
        np.add.at(f, (ctx, nxt), 1)
        # remove cross-quarter transitions (each quarter restarts at ctx 0)
        for q in range(1, 4):
            if starts[q] > 0 and starts[q] < n:
                f[arr[starts[q] - 1], arr[starts[q]]] -= 1
        fn = np.zeros_like(f)
        for c in range(256):
            if f[c].sum():
                fn[c] = _norm_freqs(f[c])
        cum = np.zeros((256, 257), np.int64)
        np.cumsum(fn, axis=1, out=cum[:, 1:])
        # context table serialisation: the outer context list uses the same
        # run-length scheme, each context followed by its inner table
        out_tab = bytearray()
        present = f.sum(axis=1) > 0
        for c, head in _rle_sym_bytes(present):
            out_tab += head
            out_tab += _write_freqs0(fn[c])
        out_tab.append(0)
        states = [RANS_L] * 4
        out = bytearray()

        def enc1(j, i, lo):
            s = int(arr[i])
            c = int(arr[i - 1]) if i > lo else 0
            freq = int(fn[c, s])
            x = states[j]
            x_max = ((RANS_L >> 12) << 8) * freq
            while x >= x_max:
                out.append(x & 0xFF)
                x >>= 8
            states[j] = ((x // freq) << 12) + (x % freq) + int(cum[c, s])

        # reverse of the decoder's time order: the state-3 remainder tail
        # first, then rounds isz4-1..0 each with states 3,2,1,0
        for i in range(n - 1, 4 * isz4 - 1, -1):
            enc1(3, i, starts[3])
        for r in range(isz4 - 1, -1, -1):
            for j in (3, 2, 1, 0):
                enc1(j, starts[j] + r, starts[j])
        payload = (bytes(out_tab) + struct.pack("<IIII", *states)
                   + bytes(reversed(out)))
    return bytes([order]) + struct.pack("<II", len(payload), n) + payload


def rans_decode(comp: bytes, expect: int = None) -> bytes:
    """rANS 4x8 decompress.  Dispatches to the native decoder (the whole
    BA/QS byte volume of a real CRAM rides this path); the Python body
    below is the bit-exact reference oracle (tests cross-check them)."""
    rsize = struct.unpack_from("<I", comp, 5)[0]
    if expect is not None and rsize != expect:
        raise ValueError("rans stream size mismatch")
    try:
        from ..native import lib as _native_lib
        L = _native_lib()
    except Exception:   # pragma: no cover — no compiler: python fallback
        L = None
    if L is not None:
        buf = np.frombuffer(bytes(comp), np.uint8)
        out = np.empty(rsize, np.uint8)
        rc = L.cram_rans_decode(buf, len(buf), out, rsize)
        if rc < 0:
            raise ValueError(f"corrupt rANS stream (native rc {rc})")
        return out.tobytes()
    return _rans_decode_py(comp, expect)


def _rans_decode_py(comp: bytes, expect: int = None) -> bytes:
    order = comp[0]
    _csize, rsize = struct.unpack_from("<II", comp, 1)
    if expect is not None and rsize != expect:
        raise ValueError("rans stream size mismatch")
    p = 9
    n = rsize
    if n == 0:
        return b""
    if order == 0:
        f, p = _read_freqs0(comp, p)
        cum = np.zeros(257, np.int64)
        np.cumsum(f, out=cum[1:])
        # symbol lookup table over the 12-bit space
        syms = np.repeat(np.arange(256, dtype=np.uint8), f)
        if len(syms) != TOTFREQ:
            raise ValueError("rans order-0 frequencies do not sum to 4096")
        states = list(struct.unpack_from("<IIII", comp, p))
        p += 16
        out = np.empty(n, np.uint8)
        cumf = cum[:256]
        buf = comp
        m = len(buf)
        for i in range(n):
            j = i & 3
            x = states[j]
            mm = x & 0xFFF
            s = syms[mm]
            out[i] = s
            x = int(f[s]) * (x >> 12) + mm - int(cumf[s])
            while x < RANS_L and p < m:
                x = (x << 8) | buf[p]
                p += 1
            states[j] = x
        return out.tobytes()
    if order != 1:
        raise ValueError(f"unsupported rans order {order}")
    # order-1
    ftab = {}
    rle = 0
    c = comp[p]
    p += 1
    while True:
        f, p = _read_freqs0(comp, p)
        ftab[c] = f
        if rle:
            rle -= 1
            c += 1
        elif p < len(comp) and comp[p] == c + 1:
            c = comp[p]
            p += 1
            rle = comp[p]
            p += 1
        else:
            c = comp[p]
            p += 1
            if c == 0:
                break
    cumtab = {}
    symtab = {}
    for c, f in ftab.items():
        cum = np.zeros(257, np.int64)
        np.cumsum(f, out=cum[1:])
        cumtab[c] = cum
        syms = np.repeat(np.arange(256, dtype=np.uint8), f)
        if len(syms) != TOTFREQ:
            raise ValueError("rans order-1 frequencies do not sum to 4096")
        symtab[c] = syms
    states = list(struct.unpack_from("<IIII", comp, p))
    p += 16
    out = np.empty(n, np.uint8)
    isz4 = n >> 2
    starts = [0, isz4, 2 * isz4, 3 * isz4, n]
    buf = comp
    m = len(buf)
    # interleaved decode: one step per state per round, remainder on state 3
    ptrs = list(starts[:4])
    ctxs = [0, 0, 0, 0]
    for _ in range(isz4):
        for j in range(4):
            x = states[j]
            c = ctxs[j]
            mm = x & 0xFFF
            s = int(symtab[c][mm])
            out[ptrs[j]] = s
            ptrs[j] += 1
            x = int(ftab[c][s]) * (x >> 12) + mm - int(cumtab[c][s])
            while x < RANS_L and p < m:
                x = (x << 8) | buf[p]
                p += 1
            states[j] = x
            ctxs[j] = s
    x = states[3]
    c = ctxs[3]
    for i in range(4 * isz4, n):
        mm = x & 0xFFF
        s = int(symtab[c][mm])
        out[i] = s
        x = int(ftab[c][s]) * (x >> 12) + mm - int(cumtab[c][s])
        while x < RANS_L and p < m:
            x = (x << 8) | buf[p]
            p += 1
        c = s
    return out.tobytes()


# ------------------------------------------------------------------
# blocks (spec sec 8) and containers (sec 9)
# ------------------------------------------------------------------

RAW, GZIP, BZIP2, LZMA, RANS = 0, 1, 2, 3, 4
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_MAPPED_SLICE = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5


def _decompress(method, data, rsize):
    if method == RAW:
        return bytes(data)
    if method == GZIP:
        return zlib.decompress(data, 15 + 32)
    if method == BZIP2:
        import bz2
        return bz2.decompress(data)
    if method == LZMA:
        import lzma
        return lzma.decompress(data)
    if method == RANS:
        return rans_decode(data, rsize)
    raise ValueError(f"unsupported CRAM block compression method {method}")


def _compress(data, method, order=0):
    if method == RAW:
        return bytes(data)
    if method == GZIP:
        co = zlib.compressobj(6, zlib.DEFLATED, 15 + 16)
        return co.compress(data) + co.flush()
    if method == BZIP2:
        import bz2
        return bz2.compress(data)
    if method == LZMA:
        import lzma
        return lzma.compress(data)
    if method == RANS:
        return rans_encode(data, order)
    raise ValueError(f"bad method {method}")


class Block:
    __slots__ = ("method", "ctype", "cid", "data")

    def __init__(self, method, ctype, cid, data):
        self.method, self.ctype, self.cid, self.data = method, ctype, cid, data


def read_block(buf, p):
    start = p
    method = buf[p]
    ctype = buf[p + 1]
    p += 2
    cid, p = itf8_get(buf, p)
    csize, p = itf8_get(buf, p)
    rsize, p = itf8_get(buf, p)
    data = bytes(buf[p:p + csize])
    p += csize
    crc = struct.unpack_from("<I", buf, p)[0]
    if crc != (zlib.crc32(bytes(buf[start:p])) & 0xFFFFFFFF):
        raise ValueError("CRAM block CRC mismatch")
    p += 4
    raw = _decompress(method, data, rsize)
    if len(raw) != rsize:
        raise ValueError("CRAM block raw size mismatch")
    return Block(method, ctype, cid, raw), p


def write_block(method, ctype, cid, raw, order=0):
    comp = _compress(raw, method, order)
    if method != RAW and len(comp) >= len(raw):
        method, comp = RAW, bytes(raw)
    body = (bytes([method, ctype]) + itf8_put(cid)
            + itf8_put(len(comp)) + itf8_put(len(raw)) + comp)
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def read_container_header(buf, p):
    h = {}
    h["length"] = struct.unpack_from("<i", buf, p)[0]
    start = p
    p += 4
    v, p = itf8_get(buf, p)
    h["ref_id"] = itf8_signed(v)
    h["start"], p = itf8_get(buf, p)
    h["span"], p = itf8_get(buf, p)
    h["n_records"], p = itf8_get(buf, p)
    h["counter"], p = ltf8_get(buf, p)
    h["bases"], p = ltf8_get(buf, p)
    h["n_blocks"], p = itf8_get(buf, p)
    nl, p = itf8_get(buf, p)
    lm = []
    for _ in range(nl):
        v, p = itf8_get(buf, p)
        lm.append(v)
    h["landmarks"] = lm
    crc = struct.unpack_from("<I", buf, p)[0]
    if crc != (zlib.crc32(bytes(buf[start:p])) & 0xFFFFFFFF):
        raise ValueError("CRAM container header CRC mismatch")
    p += 4
    return h, p


def write_container_header(length, ref_id, start, span, n_records, counter,
                           bases, n_blocks, landmarks):
    b = (itf8_put(ref_id & 0xFFFFFFFF) + itf8_put(start) + itf8_put(span)
         + itf8_put(n_records) + ltf8_put(counter) + ltf8_put(bases)
         + itf8_put(n_blocks) + itf8_put(len(landmarks))
         + b"".join(itf8_put(x) for x in landmarks))
    hdr = struct.pack("<i", length) + b
    return hdr + struct.pack("<I", zlib.crc32(hdr) & 0xFFFFFFFF)


# ------------------------------------------------------------------
# record encodings (spec sec 12)
# ------------------------------------------------------------------

E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN = 0, 1, 2, 3
E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA = 4, 5, 6
E_SUBEXP, E_GOLOMB_RICE, E_GAMMA = 7, 8, 9


class BitReader:
    """MSB-first bit reader over the core block."""

    __slots__ = ("buf", "pos", "bit")

    def __init__(self, buf):
        self.buf = buf
        self.pos = 0
        self.bit = 0

    def read(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.buf[self.pos] >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, v, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.acc)
                self.acc = 0
                self.nbits = 0

    def bytes(self):
        if self.nbits:
            return bytes(self.out) + bytes([self.acc << (8 - self.nbits)])
        return bytes(self.out)


def parse_encoding(buf, p):
    codec, p = itf8_get(buf, p)
    plen, p = itf8_get(buf, p)
    params = bytes(buf[p:p + plen])
    return (codec, params), p + plen


def encode_encoding(codec, params):
    return itf8_put(codec) + itf8_put(len(params)) + params


class Codec:
    """Decoder for one data series, bound to the slice's streams."""

    def __init__(self, enc, streams):
        self.codec, params = enc
        self.streams = streams
        p = 0
        if self.codec == E_EXTERNAL:
            self.cid, _ = itf8_get(params, 0)
        elif self.codec == E_HUFFMAN:
            n, p = itf8_get(params, p)
            alpha = []
            for _ in range(n):
                v, p = itf8_get(params, p)
                alpha.append(itf8_signed(v))
            n2, p = itf8_get(params, p)
            lens = []
            for _ in range(n2):
                v, p = itf8_get(params, p)
                lens.append(v)
            self.alpha, self.lens = alpha, lens
            # canonical codes: ascending (len, symbol-order-as-given)
            order = sorted(range(len(alpha)), key=lambda i: (lens[i], i))
            code = 0
            prev_len = lens[order[0]] if alpha else 0
            self.table = {}   # (len, code) -> symbol
            for i in order:
                code <<= (lens[i] - prev_len)
                prev_len = lens[i]
                self.table[(lens[i], code)] = alpha[i]
                code += 1
            self.zero_bit = (len(alpha) == 1 and lens[0] == 0)
            self.single = alpha[0] if alpha else 0
        elif self.codec == E_BETA:
            v, p = itf8_get(params, p)
            self.offset = itf8_signed(v)
            self.nbits, p = itf8_get(params, p)
        elif self.codec == E_GAMMA:
            v, p = itf8_get(params, p)
            self.offset = itf8_signed(v)
        elif self.codec == E_BYTE_ARRAY_LEN:
            lenc, p = parse_encoding(params, p)
            venc, p = parse_encoding(params, p)
            self.len_codec = Codec(lenc, streams)
            self.val_codec = Codec(venc, streams)
        elif self.codec == E_BYTE_ARRAY_STOP:
            self.stop = params[0]
            self.cid, _ = itf8_get(params, 1)
        elif self.codec == E_NULL:
            pass
        else:
            raise ValueError(f"unsupported CRAM encoding codec {self.codec}")

    # streams: dict cid -> [bytearray-like, pos]; core: BitReader

    def read_int(self, core):
        c = self.codec
        if c == E_EXTERNAL:
            st = self.streams[self.cid]
            v, st[1] = itf8_get(st[0], st[1])
            return itf8_signed(v)
        if c == E_HUFFMAN:
            if self.zero_bit:
                return self.single
            length = 0
            code = 0
            while True:
                code = (code << 1) | core.read(1)
                length += 1
                if (length, code) in self.table:
                    return self.table[(length, code)]
                if length > 31:
                    raise ValueError("bad huffman stream")
        if c == E_BETA:
            return core.read(self.nbits) - self.offset
        if c == E_GAMMA:
            n = 0
            while core.read(1) == 0:
                n += 1
            v = 1
            for _ in range(n):
                v = (v << 1) | core.read(1)
            return v - self.offset
        raise ValueError(f"codec {c} cannot read ints")

    def read_byte(self, core):
        if self.codec == E_EXTERNAL:
            st = self.streams[self.cid]
            b = st[0][st[1]]
            st[1] += 1
            return b
        return self.read_int(core) & 0xFF

    def read_bytes(self, core, n=None):
        c = self.codec
        if c == E_BYTE_ARRAY_LEN:
            ln = self.len_codec.read_int(core)
            vc = self.val_codec
            if vc.codec == E_EXTERNAL:   # bulk slice, not per-byte reads
                st = vc.streams[vc.cid]
                out = bytes(st[0][st[1]:st[1] + ln])
                st[1] += ln
                return out
            return bytes(vc.read_byte(core) for _ in range(ln))
        if c == E_BYTE_ARRAY_STOP:
            st = self.streams[self.cid]
            buf, p0 = st[0], st[1]
            e = buf.find(self.stop, p0) if hasattr(buf, "find") else -1
            if e < 0:
                e = len(buf)
            st[1] = e + 1
            return bytes(buf[p0:e])
        if c == E_EXTERNAL and n is not None:
            st = self.streams[self.cid]
            out = bytes(st[0][st[1]:st[1] + n])
            st[1] += n
            return out
        raise ValueError(f"codec {c} cannot read byte arrays")


# ------------------------------------------------------------------
# compression header (spec sec 8.4) and slices (sec 8.5)
# ------------------------------------------------------------------


def _read_map(buf, p, read_entry):
    _size, p = itf8_get(buf, p)
    n, p = itf8_get(buf, p)
    out = {}
    for _ in range(n):
        p = read_entry(buf, p, out)
    return out, p


def parse_compression_header(raw):
    p = 0
    pres = {"RN": True, "AP": True, "RR": True,
            "SM": bytes([0x1B, 0x1B, 0x1B, 0x1B, 0x1B]), "TD": [[]]}

    def pres_entry(buf, p, out):
        key = bytes(buf[p:p + 2]).decode("latin-1")
        p += 2
        if key in ("RN", "AP", "RR"):
            out[key] = buf[p] != 0
            p += 1
        elif key == "SM":
            out[key] = bytes(buf[p:p + 5])
            p += 5
        elif key == "TD":
            ln, p = itf8_get(buf, p)
            blob = bytes(buf[p:p + ln])
            p += ln
            lines = blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") \
                else blob.split(b"\x00")
            td = []
            for line in lines:
                tags = [(line[i:i + 2].decode("latin-1"),
                         chr(line[i + 2])) for i in range(0, len(line), 3)]
                td.append(tags)
            out[key] = td or [[]]
        else:
            raise ValueError(f"unknown preservation map key {key}")
        return p

    got, p = _read_map(raw, p, pres_entry)
    pres.update(got)

    def ds_entry(buf, p, out):
        key = bytes(buf[p:p + 2]).decode("latin-1")
        p += 2
        enc, p = parse_encoding(buf, p)
        out[key] = enc
        return p

    dsm, p = _read_map(raw, p, ds_entry)

    def tag_entry(buf, p, out):
        key, p = itf8_get(buf, p)
        enc, p = parse_encoding(buf, p)
        out[key] = enc
        return p

    tags, p = _read_map(raw, p, tag_entry)
    return pres, dsm, tags


def parse_slice_header(raw):
    p = 0
    h = {}
    v, p = itf8_get(raw, p)
    h["ref_id"] = itf8_signed(v)
    h["start"], p = itf8_get(raw, p)
    h["span"], p = itf8_get(raw, p)
    h["n_records"], p = itf8_get(raw, p)
    h["counter"], p = ltf8_get(raw, p)
    h["n_blocks"], p = itf8_get(raw, p)
    nc, p = itf8_get(raw, p)
    ids = []
    for _ in range(nc):
        v, p = itf8_get(raw, p)
        ids.append(v)
    h["content_ids"] = ids
    v, p = itf8_get(raw, p)
    h["embedded_ref_id"] = itf8_signed(v)
    h["md5"] = bytes(raw[p:p + 16])
    return h


# data series an int/byte/bytes reader consumes (spec sec 10.2-10.7)
_SERIES_INT = ("BF CF RI RL AP RG MF NS NP TS NF TL FN FP DL PD HC RS MQ"
               .split())


class SliceDecoder:
    """Decodes one slice's records (spec sec 10)."""

    def __init__(self, pres, dsm, tagenc, blocks, sheader, sam_flags=None,
                 resolver=None):
        self.pres = pres
        self.resolver = resolver
        core = None
        streams = {}
        self.embedded_ref = None
        for b in blocks:
            if b.ctype == CT_CORE:
                core = b.data
            else:
                streams[b.cid] = [b.data, 0]
        if sheader["embedded_ref_id"] >= 0:
            self.embedded_ref = bytes(
                streams[sheader["embedded_ref_id"]][0])
        self.core = BitReader(core or b"")
        self.codecs = {k: Codec(enc, streams) for k, enc in dsm.items()}
        self.tagcodecs = {k: Codec(enc, streams) for k, enc in tagenc.items()}
        self.h = sheader

    def _int(self, key):
        return self.codecs[key].read_int(self.core)

    def _byte(self, key):
        return self.codecs[key].read_byte(self.core)

    def _bytes(self, key, n=None):
        return self.codecs[key].read_bytes(self.core, n)

    def decode_records(self, filename="<cram>"):
        """Returns list of (bam_flag, seq_letters bytes, quals bytes|None,
        name str|None) in alignment orientation."""
        h = self.h
        pres = self.pres
        out = []
        sm = pres["SM"]
        # substitution matrix: for ref base r (ACGTN), 2-bit code per
        # alternative base in ACGTN order (spec sec 10.6.2)
        bases = b"ACGTN"
        sub = {}
        for ri, r in enumerate(bases):
            alts = [b for b in bases if b != r]
            byte = sm[ri]
            for pos, a in enumerate(alts):
                code = (byte >> (6 - 2 * pos)) & 3
                sub[(r, code)] = a
        last_ap = h["start"]
        for _ in range(h["n_records"]):
            bf = self._int("BF")
            cf = self._int("CF")
            ref_id = h["ref_id"]
            if ref_id == -2:
                ref_id = self._int("RI")
            rl = self._int("RL")
            ap = self._int("AP")
            if pres["AP"]:
                ap = last_ap + ap
                last_ap = ap
            self._int("RG")
            name = None
            if pres["RN"]:
                name = self._bytes("RN").decode("latin-1")
            if cf & 2:  # detached
                self._int("MF")
                if not pres["RN"]:
                    name = self._bytes("RN").decode("latin-1")
                self._int("NS")
                self._int("NP")
                self._int("TS")
            elif cf & 4:  # mate downstream
                self._int("NF")
            tl = self._int("TL")
            for tag, typ in pres["TD"][tl]:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                self.tagcodecs[key].read_bytes(self.core)
            if bf & 4 or ref_id < 0:   # unmapped
                if cf & 8:
                    seq = b"N" * rl
                else:
                    ba = self.codecs["BA"]
                    seq = bytes(ba.read_byte(self.core) for _ in range(rl)) \
                        if ba.codec != E_EXTERNAL \
                        else ba.read_bytes(self.core, rl)
                quals = None
                if cf & 1:
                    quals = self._bytes("QS", rl)
            else:               # mapped: reconstruct against the reference
                nf = self._int("FN")
                feats = []
                fpos = 0
                for _ in range(nf):
                    fc = chr(self._byte("FC"))
                    fpos += self._int("FP")
                    if fc == "B":
                        feats.append((fpos, fc, (self._byte("BA"),
                                                 self._byte("QS"))))
                    elif fc == "X":
                        feats.append((fpos, fc, self._byte("BS")))
                    elif fc == "I":
                        feats.append((fpos, fc, self._bytes("IN")))
                    elif fc == "S":
                        feats.append((fpos, fc, self._bytes("SC")))
                    elif fc == "b":
                        feats.append((fpos, fc, self._bytes("BB")))
                    elif fc == "q":
                        feats.append((fpos, fc, self._bytes("QQ", None)))
                    elif fc == "i":
                        feats.append((fpos, fc, bytes([self._byte("BA")])))
                    elif fc == "D":
                        feats.append((fpos, fc, self._int("DL")))
                    elif fc == "N":
                        feats.append((fpos, fc, self._int("RS")))
                    elif fc == "P":
                        feats.append((fpos, fc, self._int("PD")))
                    elif fc == "H":
                        feats.append((fpos, fc, self._int("HC")))
                    elif fc == "Q":
                        feats.append((fpos, fc, self._byte("QS")))
                    else:
                        raise ValueError(f"unknown CRAM feature {fc!r}")
                self._int("MQ")
                quals = None
                if cf & 1:
                    quals = self._bytes("QS", rl)
                if cf & 8:
                    # sequence-unknown flag: bases were not stored (SEQ '*');
                    # decode as N's like the unmapped branch — never fabricate
                    # reference bases for a record whose sequence is unknown
                    seq = b"N" * rl
                else:
                    # reference bases are only required where a feature gap
                    # actually copies from the reference — no_ref=1 encodes
                    # (whole-read 'b'/BB base runs) decode without one, so
                    # the missing-reference error is raised inside
                    # _build_seq at the first real dereference
                    seq = self._build_seq(rl, ap, feats, sub, filename,
                                          ref_id)
            out.append((bf, seq, quals, name))
        return out

    def _external_ref(self, ref_id, filename):
        """Resolve + verify the slice's external reference lazily (only a
        record that actually dereferences the reference pays for it)."""
        ref = self.resolver.get(ref_id, filename)
        md5 = self.h["md5"]
        # slice header carries the MD5 of the reference span it covers
        # (spec sec 8.5); all-zero means the writer skipped it
        if any(md5) and self.h["ref_id"] == ref_id:
            import hashlib
            span = ref[self.h["start"] - 1:
                       self.h["start"] - 1 + self.h["span"]]
            if hashlib.md5(span).digest() != md5:
                raise ValueError(
                    f"{filename}: reference span fails the slice MD5 check "
                    f"(start {self.h['start']} span {self.h['span']}): "
                    f"expected {md5.hex()}, got "
                    f"{hashlib.md5(span).hexdigest()} — wrong reference?")
        return ref

    def _build_seq(self, rl, ap, feats, sub, filename, ref_id=-1):
        if self.embedded_ref is not None:
            ref = self.embedded_ref
            rbase = self.h["start"]    # embedded block covers [start, span)
        else:
            ref = None                 # external: fetched on first deref
            rbase = 1                  # full sequence, AP is 1-based
        seq = bytearray(rl)
        rpos = ap - rbase
        spos = 0                   # position in read

        def need_ref():
            nonlocal ref
            if ref is None:
                if self.resolver is not None and ref_id >= 0:
                    ref = self._external_ref(ref_id, filename)
                    return
                raise ValueError(
                    f"{filename}: CRAM slice requires an external reference "
                    f"(md5 {self.h['md5'].hex()}) — supply the reference or "
                    f"re-encode with --output-fmt-option embed_ref=1 / "
                    f"no_ref=1")

        def copy_ref(n):
            # slice copy (was a per-base Python loop — the decode hot path)
            nonlocal spos, rpos
            if n <= 0:
                return
            need_ref()
            seq[spos:spos + n] = ref[rpos:rpos + n]
            spos += n
            rpos += n

        for fpos, fc, val in feats:
            # copy reference up to the feature position (1-based in read)
            copy_ref(fpos - 1 - spos)
            if fc == "B":
                seq[spos] = val[0]
                spos += 1
                rpos += 1
            elif fc == "X":
                need_ref()
                r = ref[rpos]
                seq[spos] = sub[(r if r in b"ACGTN" else ord("N"), val)]
                spos += 1
                rpos += 1
            elif fc in ("I", "S", "b"):
                seq[spos:spos + len(val)] = val
                spos += len(val)
                if fc == "b":
                    rpos += len(val)
            elif fc == "i":
                seq[spos] = val[0]
                spos += 1
            elif fc == "D" or fc == "N":
                rpos += val
            elif fc in ("P", "H", "Q", "q"):
                pass
            else:
                raise ValueError(f"unhandled feature {fc}")
        copy_ref(rl - spos)
        return bytes(seq)


# ------------------------------------------------------------------
# whole-file reader
# ------------------------------------------------------------------

EOF_START = 4542278  # spec: the EOF container's alignment start ("EOF")


def parse_sq_lines(sam_text):
    """@SQ entries (SN/LN/M5/UR) from SAM header text, in file order — the
    order defines CRAM's ref_id numbering (spec sec 8.5)."""
    sq = []
    for line in sam_text.split("\n"):
        if not line.startswith("@SQ"):
            continue
        ent = {}
        for field in line.rstrip("\r").split("\t")[1:]:
            if len(field) >= 3 and field[2] == ":":
                ent[field[:2]] = field[3:]
        sq.append(ent)
    return sq


def _m5_expand(template, m5):
    """htslib's %Ns/%s template expansion (cram_io.c expand_cache_path):
    %Ns consumes the next N hex chars, %s the remainder; an entry with no
    %-token gets '/%s' appended."""
    if "%" not in template:
        template = template.rstrip("/") + "/%s"
    out, rest, i = [], m5, 0
    while i < len(template):
        c = template[i]
        if c == "%" and i + 1 < len(template):
            j = i + 1
            while j < len(template) and template[j].isdigit():
                j += 1
            if j < len(template) and template[j] == "s":
                n = int(template[i + 1:j]) if j > i + 1 else None
                if n is None:
                    out.append(rest)
                    rest = ""
                else:
                    out.append(rest[:n])
                    rest = rest[n:]
                i = j + 1
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _load_ref_file(path, name=None):
    """Load one reference sequence from a file: FASTA (selected by name when
    given, else the first/only record) or a raw REF_CACHE-format file.
    Returns whitespace-stripped uppercased bytes, or None."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data[:1] == b">":
        want = name.encode() if name is not None else None
        seq, found = [], False
        for line in data.split(b"\n"):
            if line[:1] == b">":
                if found:
                    break
                hdr = line[1:].split()
                found = want is None or (hdr and hdr[0] == want)
            elif found:
                seq.append(line.strip())
        if not found:
            return None
        return b"".join(seq).upper()
    return b"".join(data.split()).upper()


class RefResolver:
    """Resolves a CRAM ref_id to its reference sequence like htslib's
    cram_populate_ref (cram/cram_io.c): REF_CACHE then each REF_PATH entry
    expanded with the @SQ M5 digest, then the @SQ UR tag as a local file.
    Loaded sequences are MD5-verified against M5 when present."""

    def __init__(self, sq, base_dir=""):
        self.sq = sq
        self.base_dir = base_dir
        self._cache = {}

    def get(self, ref_id, filename="<cram>"):
        if ref_id in self._cache:
            return self._cache[ref_id]
        import hashlib
        import os
        if not 0 <= ref_id < len(self.sq):
            raise ValueError(
                f"{filename}: CRAM record references sequence {ref_id} but "
                f"the SAM header has {len(self.sq)} @SQ lines")
        ent = self.sq[ref_id]
        m5 = ent.get("M5", "").lower()
        tried = []
        ref = None
        if m5:
            templates = []
            if os.environ.get("REF_CACHE"):
                templates.append(os.environ["REF_CACHE"])
            for part in os.environ.get("REF_PATH", "").split(":"):
                # ':' also appears in URL schemes; no egress here, so only
                # local templates are meaningful — skip scheme fragments
                if part and "//" not in part:
                    templates.append(part)
            for t in templates:
                path = _m5_expand(t, m5)
                tried.append(path)
                ref = _load_ref_file(path)
                if ref is not None:
                    break
        if ref is None and ent.get("UR"):
            ur = ent["UR"]
            if ur.startswith("file://"):
                ur = ur[7:]
            if "://" not in ur:
                import os.path
                if not os.path.isabs(ur) and self.base_dir:
                    ur = os.path.join(self.base_dir, ur)
                tried.append(ur)
                ref = _load_ref_file(ur, name=ent.get("SN"))
        if ref is None:
            raise ValueError(
                f"{filename}: cannot resolve the external reference for "
                f"@SQ SN:{ent.get('SN', '?')}"
                + (f" M5:{m5}" if m5 else "")
                + (" — tried " + ", ".join(tried) if tried
                   else " — no M5/UR tags and REF_PATH/REF_CACHE unset")
                + "; supply REF_PATH/REF_CACHE or a local UR, or re-encode "
                  "with embed_ref=1 / no_ref=1")
        if m5 and hashlib.md5(ref).hexdigest() != m5:
            raise ValueError(
                f"{filename}: reference for @SQ SN:{ent.get('SN', '?')} "
                f"(from {tried[-1]}) fails its M5 check: expected {m5}, "
                f"got {hashlib.md5(ref).hexdigest()}")
        self._cache[ref_id] = ref
        return ref


def is_cram(data) -> bool:
    return bytes(data[:4]) == b"CRAM"


def parse_cram(data, convert, is_qual, want_ids, filename="<cram>"):
    """Parse a whole CRAM file into a SeqBatch, with the reference's BAM
    record semantics (seqio.c:764-800): reverse-flag records are restored to
    read orientation, quals ride raw, absent quals decode as zeros."""
    from .seqio import SeqBatch
    if not is_cram(data):
        raise ValueError(f"{filename} is not a CRAM file")
    major = data[4]
    if major != 3:
        raise ValueError(
            f"{filename}: unsupported CRAM version {major}.{data[5]}")
    p = 26
    n = len(data)
    first = True
    recs = []
    resolver = None
    while p < n:
        h, p = read_container_header(data, p)
        end = p + h["length"]
        if first:
            first = False
            # SAM header container: int32 text length + header text (spec
            # sec 8.2) — its @SQ order defines ref_id; M5/UR drive external
            # reference resolution for slices with no embedded reference
            try:
                b, _ = read_block(data, p)
                tlen = struct.unpack("<i", bytes(b.data[:4]))[0]
                text = bytes(b.data[4:4 + tlen]).decode("latin-1")
                import os.path
                base = os.path.dirname(filename) \
                    if filename not in ("<cram>", "") else ""
                resolver = RefResolver(parse_sq_lines(text), base)
            except Exception:
                resolver = None    # malformed header: error only if needed
            p = end
            continue
        if h["n_records"] == 0 and (h["start"] == EOF_START
                                    or h["n_blocks"] <= 1):
            break
        blocks = []
        while p < end:
            b, p = read_block(data, p)
            blocks.append(b)
        pres, dsm, tagenc = parse_compression_header(blocks[0].data)
        i = 1
        while i < len(blocks):
            if blocks[i].ctype != CT_MAPPED_SLICE:
                raise ValueError(f"{filename}: expected slice header block")
            sh = parse_slice_header(blocks[i].data)
            sblocks = blocks[i + 1:i + 1 + sh["n_blocks"]]
            i += 1 + sh["n_blocks"]
            dec = SliceDecoder(pres, dsm, tagenc, sblocks, sh,
                               resolver=resolver)
            recs.extend(dec.decode_records(filename))
    # finish: alignment orientation -> read orientation (flag 0x10),
    # charset conversion, qual assembly — the BAM/SAM record semantics
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"=ACMGRSVTWYHKDBNacmgrsvtwyhkdbn",
                    b"=TGKCYSBAWRDMHVNtgkcysbawrdmhvn"):
        comp[a] = b
    seqs, lens, quals, ids = [], [], [], []
    for bf, seq, q, name in recs:
        arr = np.frombuffer(seq, np.uint8)
        if bf & 0x10:
            arr = comp[arr][::-1]
        seqs.append(arr)
        lens.append(len(arr))
        if is_qual:
            if q is None:
                quals.append(np.zeros(len(arr), np.int8))
            else:
                qarr = np.frombuffer(q, np.uint8)
                if bf & 0x10:
                    qarr = qarr[::-1]
                quals.append(qarr.astype(np.int8))
        if want_ids:
            ids.append(name or "")
    letters = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    if convert is not None:
        conv = np.full(256, -2, np.int16)
        conv[:128] = convert
        codes = conv[letters]
        if (codes < 0).any():
            bad = letters[np.nonzero(codes < 0)[0][0]]
            raise ValueError(
                f"bad character {chr(bad)!r} in CRAM sequence from "
                f"{filename}")
        codes = codes.astype(np.int8)
    else:
        codes = letters.astype(np.int8)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(np.asarray(lens, np.int64), out=offsets[1:])
    q = np.concatenate(quals) if (is_qual and quals) else None
    return SeqBatch(codes, offsets, ids if want_ids else None, None, q)


# ------------------------------------------------------------------
# writer (test generator + seqconvert target): spec-valid CRAM 3.0
# ------------------------------------------------------------------

# external stream content ids used by the writer ("Bl" = BB length stream)
_CID = {"BF": 1, "CF": 2, "RL": 3, "RN": 4, "BA": 5, "QS": 6, "MF": 7,
        "AP": 8, "FN": 9, "FC": 10, "FP": 11, "BS": 12, "MQ": 13,
        "Bl": 14, "BB": 15}


def _huff_single(v):
    return encode_encoding(
        E_HUFFMAN, itf8_put(1) + itf8_put(v & 0xFFFFFFFF)
        + itf8_put(1) + itf8_put(0))


def _ext(cid):
    return encode_encoding(E_EXTERNAL, itf8_put(cid))


def _map_bytes(entries):
    body = itf8_put(len(entries)) + b"".join(entries)
    return itf8_put(len(body)) + body


def write_cram(path, names, seqs, quals=None, embed_ref=None, positions=None,
               per_container=10000, no_ref=False, seq_unknown=None,
               ref_external=False, ref_ur=None):
    """Write CRAM 3.0.  Default: unmapped records (BA series, rANS blocks).
    With embed_ref + positions: mapped records against an EMBEDDED
    reference, emitting substitution (X/BS) features where read and ref
    disagree — exercises the mapped decode path end to end.
    With additionally ref_external=True: the reference is NOT embedded (the
    default samtools CRAM layout); the @SQ line carries its M5 digest and,
    when ref_ur is given, a UR path — the reader must resolve it through
    RefResolver (REF_CACHE/REF_PATH/UR), and the slice header carries the
    real reference-span MD5 so the resolution is verified.
    With no_ref=True: mapped records with NO reference at all, each read's
    bases stored as a whole-read 'b'/BB feature (the layout samtools
    --output-fmt-option no_ref=1 produces).
    seq_unknown: optional per-read bool list; marked reads set the CF
    'sequence unknown' flag (0x8) and store no bases (SEQ '*')."""
    out = [b"CRAM\x03\x00" + b"modimizer.cram".ljust(20, b"\0")]
    assert len(out[0]) == 26
    mapped = embed_ref is not None
    featmode = mapped or no_ref          # records take the mapped branch
    # SAM header container
    sam = b"@HD\tVN:1.6\tSO:unknown\n"
    if featmode:
        ln = len(embed_ref) if mapped else max(map(len, seqs), default=1)
        sam += b"@SQ\tSN:ref\tLN:" + str(ln).encode()
        if mapped and ref_external:
            import hashlib
            sam += b"\tM5:" + hashlib.md5(embed_ref).hexdigest().encode()
            if ref_ur is not None:
                sam += b"\tUR:" + str(ref_ur).encode()
        sam += b"\n"
    hb = struct.pack("<i", len(sam)) + sam
    blk = write_block(RAW, CT_FILE_HEADER, 0, hb)
    out.append(write_container_header(len(blk), -1, 0, 0, 0, 0, 0, 1, [0])
               + blk)
    counter = 0
    for s0 in range(0, len(seqs), per_container):
        batch = list(range(s0, min(s0 + per_container, len(seqs))))
        # ---- per-container streams ----
        st = {k: bytearray() for k in _CID}
        core = BitWriter()
        n_bases = 0
        ap_prev = None
        for i in batch:
            seq = seqs[i].upper()
            rl = len(seq)
            n_bases += rl
            qp = quals[i] if quals is not None else None
            unk = bool(seq_unknown[i]) if seq_unknown is not None else False
            cf = 2 | (1 if qp is not None else 0)   # detached (+QS)
            if unk:
                cf |= 8
            st["BF"] += itf8_put(0 if featmode else 4)
            st["CF"] += itf8_put(cf)
            st["RL"] += itf8_put(rl)
            pos = (positions[i] + 1) if mapped else 0
            st["AP"] += itf8_put(pos)
            st["RN"] += names[i].encode() + b"\t"
            st["MF"] += itf8_put(0)
            # NS/NP/TS ride zero-bit huffman; TL likewise (line 0: no tags)
            if featmode:
                if unk:
                    st["FN"] += itf8_put(0)
                elif no_ref:
                    # whole read as one 'b' (BB) base run at read pos 1
                    st["FN"] += itf8_put(1)
                    st["FC"].append(ord("b"))
                    st["FP"] += itf8_put(1)
                    st["Bl"] += itf8_put(rl)
                    st["BB"] += seq
                else:
                    p0 = positions[i]
                    ref = embed_ref[p0:p0 + rl]
                    mism = [j for j in range(rl)
                            if seq[j:j + 1] != ref[j:j + 1]]
                    st["FN"] += itf8_put(len(mism))
                    prev = 0
                    for j in mism:
                        st["FC"].append(ord("X"))
                        st["FP"] += itf8_put(j + 1 - prev)
                        prev = j + 1
                        code = _sm_code(ref[j], seq[j])
                        st["BS"].append(code)
                st["MQ"] += itf8_put(60)
            elif not unk:
                st["BA"] += seq
            if qp is not None:
                st["QS"] += bytes(qp)
        counter += len(batch)
        # ---- compression header ----
        pres = _map_bytes([
            b"RN\x01", b"AP\x00", b"RR" + (b"\x01" if mapped else b"\x00"),
            b"SM" + _SM_BYTES, b"TD" + itf8_put(1) + b"\x00",
        ])
        ds = [
            b"BF" + _ext(_CID["BF"]), b"CF" + _ext(_CID["CF"]),
            b"RL" + _ext(_CID["RL"]),
            b"AP" + _ext(_CID["AP"]),
            b"RG" + _huff_single(-1),
            b"RN" + encode_encoding(E_BYTE_ARRAY_STOP,
                                    b"\t" + itf8_put(_CID["RN"])),
            b"MF" + _ext(_CID["MF"]),
            b"NS" + _huff_single(-1), b"NP" + _huff_single(0),
            b"TS" + _huff_single(0), b"TL" + _huff_single(0),
            b"BA" + _ext(_CID["BA"]), b"QS" + _ext(_CID["QS"]),
        ]
        if featmode:
            ds += [b"FN" + _ext(_CID["FN"]), b"FC" + _ext(_CID["FC"]),
                   b"FP" + _ext(_CID["FP"]), b"BS" + _ext(_CID["BS"]),
                   b"MQ" + _ext(_CID["MQ"]),
                   b"BB" + encode_encoding(
                       E_BYTE_ARRAY_LEN,
                       _ext(_CID["Bl"]) + _ext(_CID["BB"]))]
        comp_hdr = (pres + _map_bytes(sorted(ds)) + _map_bytes([]))
        # ---- slice ----
        eref_id = -1
        sblocks = []
        if mapped and not ref_external:
            eref_id = 100
            sblocks.append(write_block(GZIP, CT_EXTERNAL, 100, embed_ref))
        sblocks.append(write_block(RAW, CT_CORE, 0, core.bytes()))
        methods = {"BA": (RANS, 1), "QS": (RANS, 1), "RN": (GZIP, 0),
                   "FN": (BZIP2, 0), "FP": (LZMA, 0), "BB": (RANS, 1)}
        for k, cid in sorted(_CID.items(), key=lambda kv: kv[1]):
            if not st[k]:
                continue
            m, o = methods.get(k, (RANS, 0))
            sblocks.append(write_block(m, CT_EXTERNAL, cid, bytes(st[k]), o))
        span = len(embed_ref) if mapped else 0
        # content ids of the slice's external blocks
        cids = [100] if mapped and not ref_external else []
        cids += [cid for k, cid in sorted(_CID.items(), key=lambda kv: kv[1])
                 if st[k]]
        if mapped and ref_external:
            # reference-span MD5 (start=1, span=len(ref)) so the reader's
            # external resolution is end-to-end verified
            import hashlib
            slice_md5 = hashlib.md5(embed_ref).digest()
        else:
            slice_md5 = b"\x00" * 16
        shdr = (itf8_put((0 if featmode else -1) & 0xFFFFFFFF)
                + itf8_put(1 if mapped else 0) + itf8_put(span)
                + itf8_put(len(batch)) + ltf8_put(counter - len(batch))
                + itf8_put(len(sblocks))
                + itf8_put(len(cids))
                + b"".join(itf8_put(c) for c in cids)
                + itf8_put(eref_id & 0xFFFFFFFF)
                + slice_md5)
        slice_hblk = write_block(RAW, CT_MAPPED_SLICE, 0, shdr)
        chdr_blk = write_block(GZIP, CT_COMPRESSION_HEADER, 0, comp_hdr)
        body = chdr_blk + slice_hblk + b"".join(sblocks)
        landmarks = [len(chdr_blk)]
        out.append(write_container_header(
            len(body), 0 if featmode else -1, 1 if mapped else 0, span,
            len(batch), counter - len(batch), n_bases,
            1 + 1 + len(sblocks), landmarks) + body)
    # EOF container (spec-valid empty container marked by start = "EOF")
    eof_blk = write_block(RAW, CT_COMPRESSION_HEADER, 0, itf8_put(0) * 3)
    out.append(write_container_header(len(eof_blk), -1, EOF_START, 0, 0, 0,
                                      0, 1, [0]) + eof_blk)
    with open(path, "wb") as f:
        f.write(b"".join(out))


# writer's substitution matrix: for each ref base, alternates in ACGTN
# order get codes 0..3 ("default" matrix)
_SM_BYTES = bytes([0x1B, 0x1B, 0x1B, 0x1B, 0x1B])


def _sm_code(ref_b, alt_b):
    bases = b"ACGTN"
    r = ref_b if ref_b in bases else ord("N")
    alts = [b for b in bases if b != r]
    pos = alts.index(alt_b)
    byte = _SM_BYTES[bases.index(r)]
    return (byte >> (6 - 2 * pos)) & 3
