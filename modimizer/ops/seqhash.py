"""Device modimizer scan: the framework's flagship compute path.

Re-design of the reference's sequential rolling iterator (seqhash.c:154-196)
as a position-parallel XLA computation:

- Only the 2-bit-packed forward stream crosses the host->device link
  (0.25 B/base); the reverse-complement stream is derived on device
  (ops/packed.py) and each k-mer is extracted with an O(1) two-word funnel
  shift, 32 constant-shift phases, no gathers.
- Hashes follow seqhash.h:58 exactly: (kmer * factor1 mod 2^64) >> (64-2k),
  canonical = min(forward, reverse-complement) with direction flag.
- Matches (canonical hash % w == 0) are compacted ON DEVICE per block of
  positions and densified in stream order, so device->host traffic is
  proportional to matches (~1/w of positions), not positions.
- Read-boundary validity rides up as packed bits (kmers path) or is
  filtered on the host afterwards (meta path; it only touches the matches).

The host assembles exact stream-order (kmers, positions, isF) — identical to
the reference iterator's emission order.  Which inputs take the device is
decided by ops/route.use_device.
"""

import functools
import os as _os

import numpy as np

from ..core.seqhash import Seqhash
from ..utils import profiling
from . import route

# 32 Mbase per device dispatch (MODIMIZER_CHUNK overrides).  Inherited
# value, not measured on the GPU yet: the per-(k, w) chunk sweep is open.
DEFAULT_CHUNK = int(_os.environ.get("MODIMIZER_CHUNK", str(1 << 25)))
BLOCK = 4096             # positions per compaction block
BLK_COMPACT = int(_os.environ.get("MODIMIZER_BLK", "512"))
                         # parallel.sharded.BLK (mirrored here so host-only
                         # CLI paths never import jax just to size buffers)
if BLK_COMPACT < 128 or (BLK_COMPACT & (BLK_COMPACT - 1)):
    raise ValueError("MODIMIZER_BLK must be a power of two >= 128")


def scan_bo(w: int) -> int:
    """Output rows per BLK-position compaction block: mean + 6 sigma of the
    Binomial(BLK, 1/w) emit count (overflow is flagged and the caller
    rescans)."""
    import math
    forced = _os.environ.get("MODIMIZER_BO")
    if forced:                     # ablation override (8-row granules)
        return int(min(BLK_COMPACT, max(8, (int(forced) + 7) // 8 * 8)))
    mean = max(1, BLK_COMPACT // w)
    # ceil the sigma so the margin stays >= 6 sigma at small BLK (isqrt
    # floors: at BLK=512 w=16 that would be ~5.8 sigma and 2x more blocks
    # per chunk to trip it; overflow still only costs a flagged replay)
    want = mean + 6 * max(1, math.isqrt(mean - 1) + 1)
    return int(min(BLK_COMPACT, max(8, ((want + 7) // 8) * 8)))

U64 = np.uint64


def _validity(offsets: np.ndarray, n: int, k: int) -> np.ndarray:
    """Dense mask: valid[p] = True iff the k-mer starting at stream position p
    lies fully inside one read (used by the sharded device path, which masks
    on device rather than filtering matches on host)."""
    valid = np.ones(n, bool)
    ends = np.minimum(offsets[1:], n)
    lo = np.minimum(np.maximum(ends - (k - 1), offsets[:-1]), ends)
    # the per-read invalid ranges [lo, end) are disjoint and short (< k),
    # so enumerate them outright (np.add.at's buffered scatter costs ~5 s
    # per 32 M positions on this host; this is ~30 ms)
    lens = (ends - lo).astype(np.int64)
    tot = int(lens.sum())
    if tot:
        cs = np.cumsum(lens)
        idx = (np.arange(tot, dtype=np.int64)
               + np.repeat(lo - (cs - lens), lens))
        valid[idx] = False
    return valid


def _validity_filter(gpos: np.ndarray, offsets: np.ndarray, k: int):
    """Keep emitted positions whose k-mer lies inside one read."""
    rid = np.searchsorted(offsets, gpos, side="right") - 1
    ok = (rid >= 0) & (gpos + k <= offsets[np.minimum(rid + 1,
                                                      len(offsets) - 1)])
    ok &= rid < len(offsets) - 1
    return ok, rid


class ModimizerScanner:
    """Streams a flat base-code stream through the device scan.

    Produces (kmers, global positions, isF) in exact stream order — the
    same order the reference's per-read iterator emits."""

    # below this many positions the native host scan is used; inherited
    # value, not measured on the card (route.use_device applies it)
    HOST_THRESHOLD = 1 << 21

    def __init__(self, sh: Seqhash, chunk: int = DEFAULT_CHUNK,
                 want_isf: bool = True, host_threshold: int = None):
        self.sh = sh
        chunk = max(BLOCK, (chunk // BLOCK) * BLOCK)
        self.chunk = chunk
        self.bo = scan_bo(sh.w)
        # dense download rows: expected emits (chunk/w) + 12.5% (min 64K)
        # margin for skewed composition; overflow falls back to host rescan
        self.cap = int(min((chunk // BLK_COMPACT) * self.bo,
                           max(4096, chunk // sh.w
                               + max(chunk // (8 * sh.w), 65536))))
        self.want_isf = want_isf
        self.max_inflight = 4
        self.used_device = False   # set per scan_stream call
        self.n_wide = 0            # chunks retried at 4x bo on device
        self.n_fallback = 0        # chunks that hit the native host rescan
        # None: route.use_device decides per call; an int forces the
        # device for n >= host_threshold (tests: 0 = always device)
        self.host_threshold = host_threshold
        # scan-front policy (MODIMIZER_FRONT), captured here so tests can
        # force a front per scanner instance instead of per process
        import os
        self.front = os.environ.get("MODIMIZER_FRONT") or None
        # sparse-validity upload: validity words are ~all-ones except at
        # read ends, so ship (idx, val) exceptions + the live count and
        # expand on device — ~8x fewer validity bytes up the link.  Dense
        # fallback when exceptions overflow the pad budget (short-read-
        # dominated chunks) or MODIMIZER_DENSE_VALID=1.
        self.sparse_cap = max(4096, self.chunk // 512)
        self.dense_valid = bool(os.environ.get("MODIMIZER_DENSE_VALID"))
        # chunks per chained dispatch in scan_kmers_batches (ONE lax.scan
        # program consumes the whole group: stacked upload, one launch,
        # stacked download).  Default 1, inherited and not measured on the
        # GPU yet; MODIMIZER_FEED_GROUP raises it.
        self.feed_group = max(1, int(os.environ.get("MODIMIZER_FEED_GROUP",
                                                    "1")))
        self.max_inflight_groups = max(1, int(os.environ.get(
            "MODIMIZER_FEED_INFLIGHT", "3")))

    def on_device(self, n: int) -> bool:
        """Whether a stream of n positions takes the device path."""
        if self.host_threshold is not None:
            return n >= self.host_threshold
        return route.use_device(n, self.HOST_THRESHOLD)

    def _log_counters(self, what: str, n: int):
        route.log(f"{what} device n={n} chunk={self.chunk} "
                  f"n_wide={self.n_wide} n_fallback={self.n_fallback}")

    def _dispatch(self, codes: np.ndarray, s: int, m: int,
                  wide: bool = False):
        import jax.numpy as jnp
        from .device_scan import _scan_chunk
        from .packed import pack_sw
        k = self.sh.k
        C = self.chunk
        NW = C // 32
        bo, cap = self._wide() if wide else (self.bo, self.cap)
        seg = codes[s:s + C + k - 1]
        sw = self._pack_native(seg, NW + 2)
        return _scan_chunk(
            jnp.asarray(sw), jnp.int32(m),
            k=k, w=self.sh.w, factor1=self.sh.factor1, bo=bo,
            cap=cap, front=self.front)

    @staticmethod
    def _pack_native(seg: np.ndarray, n_words: int) -> np.ndarray:
        """Single-pass native 2-bit pack (pack_sw layout); the numpy
        multi-pass pack costs ~0.16 s per 32 M-base chunk on this host —
        real money when the e2e budget is ~2.8 s for 200 Mbp."""
        from ..native import lib as native_lib
        out = np.empty(n_words, np.uint64)
        native_lib().pk_pack2(np.ascontiguousarray(seg).view(np.uint8),
                              len(seg), out, n_words)
        return out

    def _wide(self):
        """bo/cap for the device-side overflow retry: 4x capacity handles
        emit bursts (e.g. poly-A runs, which emit at EVERY position since
        kmer 0 hashes to 0) up to ~4x the 6-sigma margin without abandoning
        the chunk to the ~50x-slower host fallback.  Compiled lazily on the
        first overflow only."""
        bo = int(min(BLK_COMPACT, self.bo * 4))
        cap = int(min((self.chunk // BLK_COMPACT) * bo, self.cap * 4))
        return bo, cap

    def _dispatch_sw(self, sw: np.ndarray, vw: np.ndarray, m: int,
                     wide: bool = False):
        """Dispatch one packed chunk (sw incl. halo words, vw = [C/64]
        validity words, m = live positions <= C), shipping validity as a
        sparse exception list when it fits the pad budget."""
        import jax.numpy as jnp
        from .device_scan import _scan_chunk_kmers, _scan_chunk_kmers_sparse
        bo, cap = self._wide() if wide else (self.bo, self.cap)
        kw = dict(k=self.sh.k, w=self.sh.w, factor1=self.sh.factor1,
                  bo=bo, cap=cap, front=self.front)
        if not self.dense_valid:
            nv_m = (m + 63) // 64
            head = vw[:nv_m]
            nz = np.flatnonzero(head != np.uint64(0xFFFFFFFFFFFFFFFF))
            P = self.sparse_cap
            if len(nz) <= P:
                sv_idx = np.full(P, len(vw), np.int32)
                sv_idx[:len(nz)] = nz
                sv_val = np.zeros(P, np.uint64)
                sv_val[:len(nz)] = head[nz]
                return _scan_chunk_kmers_sparse(
                    jnp.asarray(sw), jnp.asarray(sv_idx),
                    jnp.asarray(sv_val), jnp.int32(m), **kw)
        return _scan_chunk_kmers(jnp.asarray(sw), jnp.asarray(vw), **kw)

    def _dispatch_kmers(self, codes: np.ndarray, s: int, vwords: np.ndarray,
                        wide: bool = False):
        k = self.sh.k
        C = self.chunk
        with profiling.stage("scan.pack"):
            seg = codes[s:s + C + k - 1]
            sw = self._pack_native(seg, C // 32 + 2)
        with profiling.stage("scan.dispatch"):
            return self._dispatch_sw(sw, vwords[s // 64:s // 64 + C // 64],
                                     min(C, len(codes) - s), wide)

    def scan_kmers(self, codes: np.ndarray, offsets: np.ndarray,
                   consumer=None):
        """Kmers-only scan in exact stream order, pipelined: while chunk N
        computes on device, chunk N+1..N+4 upload and chunk N-1 downloads,
        and the host runs ``consumer(kmers)`` (e.g. the native table
        replay) under the wire time.  Validity is masked ON DEVICE (packed
        bits ride up with the stream), so the download is just the dense
        kmer rows — the modutils -a inner loop (modutils.c:19-31) as a
        host/device pipeline.

        Returns the concatenated kmers array if consumer is None, else the
        total emit count."""
        sh = self.sh
        n = len(codes)
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.asarray(offsets, np.int64)
        if not self.on_device(n):
            self.used_device = False
            kms, _gpos, _isF = self._scan_host(codes, offsets)
            if consumer is None:
                return kms
            consumer(kms)
            return len(kms)
        self.used_device = True
        C = self.chunk
        n_chunks = max(1, -(-n // C))
        # one packed global validity plane, zero-padded to whole chunks so
        # the tail positions past n are invalid for free
        from ..native import lib as native_lib
        with profiling.stage("scan.validity"):
            vwords = np.empty(n_chunks * C // 64, np.uint64)
            native_lib().pk_valid_words(offsets, len(offsets) - 1, n, sh.k,
                                        vwords, len(vwords))
        out = [] if consumer is None else None
        total = 0

        def drain(entry):
            nonlocal total
            s, fut = entry
            km, tot = fut
            with profiling.stage("scan.download"):
                tot = int(tot)
                if tot < 0:  # cap/block overflow: retry wide on device
                    self.n_wide += 1
                    km, tot = self._dispatch_kmers(codes, s, vwords,
                                                   wide=True)
                    tot = int(tot)
                if tot < 0:  # still overflowing: exact native host rescan
                    self.n_fallback += 1
                    kms = self._rescan_rows(s, min(C, n - s), codes,
                                            offsets)[0]
                else:
                    kms = np.asarray(km)[:tot]
                    if kms.dtype != np.uint64:
                        kms = kms.astype(np.uint64)
            total += len(kms)
            if consumer is None:
                out.append(kms)
            else:
                with profiling.stage("scan.consumer"):
                    consumer(kms)

        def prefetch(fut):
            # queue the device->host copy right behind the compute so the
            # transfer of chunk N-1 rides under chunk N's step instead of
            # serializing at np.asarray
            for a in fut:
                try:
                    a.copy_to_host_async()
                except (AttributeError, RuntimeError):  # pragma: no cover
                    break
            return fut

        with profiling.trace_region():
            pending = []
            for s in range(0, max(n, 1), C):
                if n - s <= 0:
                    break
                pending.append(
                    (s, prefetch(self._dispatch_kmers(codes, s, vwords))))
                if len(pending) > self.max_inflight:
                    drain(pending.pop(0))
            for entry in pending:
                drain(entry)
        self._log_counters("scan_kmers", n)
        if consumer is None:
            return (np.concatenate(out) if out
                    else np.zeros(0, np.uint64))
        return total

    def scan_kmers_batches(self, batches, consumer=None):
        """Streaming variant of scan_kmers: consume (codes, offsets)
        batches from an iterator (e.g. io.stream_seq.iter_fasta_batches'
        parse-ahead thread) and dispatch full chunks as data arrives, so
        file parsing, the device scan, transfers, and the host table
        replay all overlap.  Chunks ride a carry buffer across batches —
        identical chunk boundaries, rows, and stream order to one
        scan_kmers call on the concatenated stream (tests pin equality).

        Each batch must be whole reads (offsets[0] == 0, offsets[-1] ==
        len(codes)).  Validity is computed per chunk from a clipped
        offsets window — exact for every in-chunk position (a read
        continuing past the window clears only halo bits the chunk never
        uses).  Returns total emits (consumer mode) or the concatenated
        kmers array."""
        from ..native import lib as native_lib
        sh = self.sh
        k = sh.k
        C = self.chunk
        halo = k - 1
        self.used_device = True
        L = native_lib()
        NWV = C // 64                    # validity words the device reads
        NWB = (C + halo + 63) // 64      # buffer incl. halo positions
        SG = self.feed_group             # chunks per chained dispatch

        out = [] if consumer is None else None
        total = 0
        pending = []
        buf = np.zeros(0, np.uint8)
        base = 0          # absolute stream position of buf[0]
        offs = np.zeros(1, np.int64)   # absolute read offsets (leading 0)
        n_in = 0          # absolute codes ingested
        eof = False
        s = 0             # next chunk start (absolute)

        def win_valid(sa, m_win):
            j0 = max(int(np.searchsorted(offs, sa, side="right")) - 1, 0)
            j1 = int(np.searchsorted(offs, sa + m_win, side="left"))
            oo = np.ascontiguousarray(
                np.clip(offs[j0:j1 + 1], sa, sa + m_win) - sa)
            vw = np.zeros(NWB, np.uint64)
            L.pk_valid_words(oo, len(oo) - 1, m_win, k, vw, NWB)
            return vw[:NWV]

        def dispatch(sa, wide=False):
            rel = sa - base
            seg = buf[rel:rel + C + halo]
            with profiling.stage("scan.pack"):
                sw = self._pack_native(seg, C // 32 + 2)
                vb = win_valid(sa, len(seg))
            with profiling.stage("scan.dispatch"):
                return self._dispatch_sw(sw, vb, min(C, len(seg)), wide)

        def rescan_window(sa):
            # exact host fallback on the chunk window (clipping argument:
            # see _rescan_rows)
            rel = sa - base
            m = min(C, n_in - sa)
            seg = np.ascontiguousarray(buf[rel:rel + m + halo])
            lo = np.clip(offs, sa, sa + len(seg)) - sa
            kms, pos, _ = self._scan_host(seg.view(np.int8), lo)
            return kms[pos < m]

        def dispatch_group(starts):
            """One chained program for len(starts) <= SG chunks (padded to
            SG with m=0 rows): stacked upload, one dispatch, stacked
            download — see device_scan._scan_chunk_kmers_sparse_scan.
            Chunks whose validity exceptions overflow the sparse budget
            are dispatched solo on the dense path (slot masked to m=0)."""
            from .device_scan import _scan_chunk_kmers_sparse_scan
            P = self.sparse_cap
            sws = np.zeros((SG, C // 32 + 2), np.uint64)
            svi = np.full((SG, P), NWB, np.int32)
            svv = np.zeros((SG, P), np.uint64)
            ms_arr = np.zeros(SG, np.int32)
            solos = {}
            with profiling.stage("scan.pack"):
                for gi, sa in enumerate(starts):
                    rel = sa - base
                    seg = buf[rel:rel + C + halo]
                    L.pk_pack2(np.ascontiguousarray(seg).view(np.uint8),
                               len(seg), sws[gi], C // 32 + 2)
                    vw = win_valid(sa, len(seg))
                    m = min(C, len(seg))
                    nv_m = (m + 63) // 64
                    head = vw[:nv_m]
                    nz = np.flatnonzero(
                        head != np.uint64(0xFFFFFFFFFFFFFFFF))
                    if len(nz) > P:     # dense fallback, solo dispatch
                        solos[gi] = self._dispatch_sw(sws[gi], vw, m)
                        continue
                    svi[gi, :len(nz)] = nz
                    svv[gi, :len(nz)] = head[nz]
                    ms_arr[gi] = m
            with profiling.stage("scan.dispatch"):
                import jax.numpy as jnp
                fut = _scan_chunk_kmers_sparse_scan(
                    jnp.asarray(sws), jnp.asarray(svi), jnp.asarray(svv),
                    jnp.asarray(ms_arr), k=k, w=sh.w, factor1=sh.factor1,
                    bo=self.bo, cap=self.cap, front=self.front)
            return fut, solos

        def drain_one(sa, km, tot):
            nonlocal total
            with profiling.stage("scan.download"):
                tot = int(tot)
                if tot < 0:      # cap/block overflow: retry wide on device
                    self.n_wide += 1
                    km, tot = dispatch(sa, wide=True)
                    tot = int(tot)
                if tot < 0:      # still overflowing: exact host rescan
                    self.n_fallback += 1
                    kms = rescan_window(sa)
                else:
                    kms = np.asarray(km)[:tot]
                    if kms.dtype != np.uint64:
                        kms = kms.astype(np.uint64)
            total += len(kms)
            if consumer is None:
                out.append(kms)
            else:
                with profiling.stage("scan.consumer"):
                    consumer(kms)

        def drain(entry):
            starts, (fut, solos) = entry
            oks, tots = fut
            if len(solos) < len(starts):
                with profiling.stage("scan.download"):
                    oks = np.asarray(oks)
                    tots = np.asarray(tots)
            for gi, sa in enumerate(starts):
                if gi in solos:
                    km, tot = solos[gi]
                    drain_one(sa, km, tot)
                else:
                    drain_one(sa, oks[gi], tots[gi])

        def prefetch(gfut):
            fut, _solos = gfut
            for a in fut:
                try:
                    a.copy_to_host_async()
                except (AttributeError, RuntimeError):  # pragma: no cover
                    break
            return gfut

        it = iter(batches)
        with profiling.trace_region():
            while True:
                while not eof and n_in - s < SG * C + halo:
                    try:
                        codes_b, offs_b = next(it)
                    except StopIteration:
                        eof = True
                        break
                    cb = np.ascontiguousarray(codes_b).view(np.uint8)
                    ob = np.asarray(offs_b, np.int64)
                    if len(ob) == 0 or ob[-1] != len(cb):
                        raise ValueError(
                            "scan_kmers_batches: batch offsets must cover "
                            "whole reads")
                    offs = np.concatenate([offs, ob[1:] + n_in])
                    buf = np.concatenate([buf, cb])
                    n_in += len(cb)
                if s >= n_in:
                    break
                starts = []
                while len(starts) < SG and s < n_in:
                    starts.append(s)
                    s += C
                pending.append((starts, prefetch(dispatch_group(starts))))
                if len(pending) > self.max_inflight_groups:
                    drain(pending.pop(0))
                    # trim consumed bytes; the oldest pending group's
                    # first window must stay resident for its wide retry
                    done = pending[0][0][0] if pending else s
                    cut = done - base
                    if cut > (64 << 20):
                        buf = buf[cut:]
                        base += cut
                        j = max(int(np.searchsorted(offs, base,
                                                    side="right")) - 1, 0)
                        offs = offs[j:]
            for entry in pending:
                drain(entry)
        self._log_counters("scan_kmers_batches", n_in)
        if consumer is None:
            return (np.concatenate(out) if out else np.zeros(0, np.uint64))
        return total

    def _rescan_rows(self, s, m, codes, offsets):
        """Exact per-chunk overflow fallback on the native OpenMP kernel.

        Read-boundary semantics match the device path's validity mask: a
        kmer at global pos p < s+m is emitted iff it lies fully inside one
        read.  Clipping offsets to the segment preserves that — clipped
        read *starts* can only move to s (every kmer here starts at >= s
        anyway) and clipped *ends* only cut kmers ending past s+m+k-2,
        which no kmer with pos < s+m does.  Returns (kmers, gpos, isF)."""
        k = self.sh.k
        seg = np.ascontiguousarray(codes[s:s + m + k - 1])
        lo = np.clip(offsets, s, s + len(seg)) - s
        kms, pos, isF = self._scan_host(seg, lo)
        keep = pos < m
        return kms[keep], pos[keep] + s, isF[keep]

    def scan_stream(self, codes: np.ndarray, offsets: np.ndarray):
        """codes: uint8/int8 [N] (values 0..3), offsets: int64 [n_reads+1]."""
        sh = self.sh
        k = sh.k
        n = len(codes)
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.asarray(offsets, np.int64)
        if not self.on_device(n):
            self.used_device = False
            return self._scan_host(codes, offsets)
        self.used_device = True
        C = self.chunk
        pending = []
        out_k, out_p, out_f = [], [], []

        def drain(entry):
            s, m, (km, meta, total) = entry
            total = int(total)
            if total < 0:  # block-bo overflow: retry wide on device
                self.n_wide += 1
                km, meta, total = self._dispatch(codes, s, m, wide=True)
                total = int(total)
            if total < 0:  # still overflowing: exact native host rescan
                self.n_fallback += 1
                kms, gpos, isF = self._rescan_rows(s, m, codes, offsets)
                out_k.append(kms)
                out_p.append(gpos)
                out_f.append(isF)
                return
            # rows arrive dense in exact stream order (position-major
            # compaction blocks + order-preserving densify); the argsort is
            # a belt-and-braces fallback only
            km = np.asarray(km)[:total].astype(np.uint64)
            meta = np.asarray(meta)[:total]
            if total and np.any(np.diff(meta.astype(np.int64)) < 0):
                order = np.argsort(meta, kind="stable")  # pragma: no cover
                km, meta = km[order], meta[order]
            gpos = s + (meta >> 1).astype(np.int64)
            isF = (meta & 1).astype(bool)
            ok, _rid = _validity_filter(gpos, offsets, k)
            out_k.append(km[ok])
            out_p.append(gpos[ok])
            out_f.append(isF[ok])

        for s in range(0, max(n, 1), C):
            m = min(C, n - s)
            if m <= 0:
                break
            pending.append((s, m, self._dispatch(codes, s, m)))
            if len(pending) > self.max_inflight:
                drain(pending.pop(0))
        for entry in pending:
            drain(entry)
        self._log_counters("scan_stream", n)

        if not out_k:
            z = np.zeros(0, np.uint64)
            return z, np.zeros(0, np.int64), np.zeros(0, bool)
        return (np.concatenate(out_k), np.concatenate(out_p),
                np.concatenate(out_f))

    def _scan_host(self, codes, offsets):
        """Whole-stream host scan via the native OpenMP rolling-hash kernel
        (native/modasm_native.cpp sh_scan_emit_reads) — read-boundary-aware,
        so no separate validity pass is needed."""
        from ..native import lib as native_lib
        sh = self.sh
        n = len(codes)
        if n < sh.k:
            return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                    np.zeros(0, bool))
        cap = max(4096, (n // sh.w) * 4 + 1024)
        L = native_lib()
        codes = np.ascontiguousarray(codes).view(np.uint8)
        offsets = np.ascontiguousarray(offsets, np.int64)
        while True:
            out_k = np.empty(cap, np.uint64)
            out_p = np.empty(cap, np.int64)
            out_f = np.empty(cap, np.uint8)
            cnt = L.sh_scan_emit_reads(codes, offsets, len(offsets) - 1,
                                       sh.k, sh.w, sh.factor1, sh.shift1,
                                       out_k, out_p, out_f, cap)
            if cnt >= 0:
                break
            cap = -cnt
        return (out_k[:cnt], out_p[:cnt], out_f[:cnt].astype(bool))

    def scan_batch(self, batch):
        """Scan a SeqBatch; returns (kmers, read_ids, read_pos, isF)."""
        from ..native import lib as native_lib
        offsets = np.ascontiguousarray(batch.offsets, np.int64)
        kmers, gpos, isF = self.scan_stream(batch.codes, offsets)
        # gpos is ascending (stream order): one native walk beats
        # searchsorted + two np.repeat temporaries
        gpos = np.ascontiguousarray(gpos, np.int64)
        rid = np.empty(len(gpos), np.int64)
        rpos = np.empty(len(gpos), np.int64)
        native_lib().sh_rid_rpos(gpos, len(gpos), offsets,
                                 len(offsets) - 1, rid, rpos)
        return kmers, rid, rpos, isF


def first_encounter_unique(kmers: np.ndarray):
    """(unique kmers in first-encounter stream order, counts) — the exact
    insertion stream the reference's sequential table build would produce."""
    if len(kmers) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    uniq, first_idx, counts = np.unique(kmers, return_index=True,
                                        return_counts=True)
    order = np.argsort(first_idx, kind="stable")
    return uniq[order], counts[order].astype(np.uint32)
