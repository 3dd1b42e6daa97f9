// Native host runtime for modasm-family analyses (reference: modasm.c).
//
// Data model: the Python Readset owns flat CSR numpy buffers (hits/dx with
// row offsets, the CSR inverse, per-read flag arrays); this module runs the
// irregular per-read algorithms over them — overlap discovery, bad-read
// triage, containment, clustering, LD testing, rDNA flagging, and the greedy
// assembly walks — writing reference-identical text through FILE* sinks.
//
// Determinism notes (behaviors the reference's output depends on):
//  - arraySort is glibc qsort (array.h:92); on glibc <= 2.36 that is a
//    stable mergesort for in-memory arrays, and the reference's tie order
//    (e.g. compareOverlap, modasm.c:300-304) depends on it.  glibc >= 2.37
//    switched qsort to an unstable introsort, so we use std::stable_sort
//    with equivalent less-than predicates: tie order is then guaranteed by
//    the C++ standard on every host, matching the reference's behavior on
//    the platforms its goldens were produced on.
//  - the assembly walk's active-read set is the reference's open-addressed
//    int HASH (hash.c): table-slot iteration order, LIFO free-list reuse of
//    dense value slots, and doubling at a half-full guard all shape the
//    output, so IHash below reproduces those semantics (hash.c:43-284),
//    including the process-global probe counters printed by hashStats.
//
// Exposed as a plain-C ABI consumed via ctypes.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unistd.h>
#include <algorithm>
#include <utility>
#include <vector>

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;
typedef int64_t I64;

static const U32 TOPBIT = 0x80000000u;
static const U32 TOPMASK = 0x7fffffffu;
static const int U16MAXV = 0xFFFF;

// read->bad bits (modasm.c:36-46, bitfield order = low bit first)
static const U8 BAD_REPEAT = 1, BAD_ORDER10 = 2, BAD_ORDER1 = 4;
static const U8 BAD_NOMATCH = 8, BAD_LOWHIT = 16, BAD_LOWCOPY1 = 32;
// modset info bits (modset.h:44-69)
static const U8 MS_MINOR = 4, MS_REPEAT = 8, MS_INTERNAL = 0x10,
                MS_RDNA = 0x20;
// modInfo flag bits (modasm.c:61-70, bitfield order)
static const U8 MI_REF = 1, MI_CORE = 2, MI_VAR = 4, MI_MULTI = 8;

extern "C" {

struct RSView {
  int32_t *rlen;
  int32_t *nHit;
  int32_t *nMiss;
  U8 *bad;
  U8 *oflags;
  int32_t *contained;
  int32_t *nCopy;  // [nReads][4]
  I64 *hitOff;     // [nReads+1]
  U32 *hits;
  U16 *dx;
  U16 *depth;  // [msMax+1]
  U8 *info;    // [msMax+1]
  I64 *invOff; // [msMax+2]
  U32 *invReads;
  U8 *miFlags;  // modInfo arrays, may be NULL
  int32_t *miPos;
  int32_t *miGood;
  int32_t *miMod2;
  int32_t *miBadLD;
  int32_t *miSplit;
  int32_t *miSplitLD;
  I64 nReads;
  I64 msMax;
  I64 totHit;
  int32_t hasherW;
  int32_t fdOut;
  int32_t fdStdout;
  int32_t pad_;
};

}  // extern "C"

static void die(const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  fprintf(stderr, "FATAL ERROR: ");
  vfprintf(stderr, fmt, ap);
  fprintf(stderr, "\n");
  va_end(ap);
  exit(255);  // exit(-1) in the reference (utils.c:19-30)
}

static inline int msCopy(const RSView *v, U32 m) { return v->info[m] & 3; }
static inline bool msIsCopy0(const RSView *v, U32 m) { return msCopy(v, m) == 0; }
static inline bool msIsCopy1(const RSView *v, U32 m) { return msCopy(v, m) == 1; }
static inline void msSetCopy0(RSView *v, U32 m) { v->info[m] &= 0xFC; }
static inline void msSetCopy1(RSView *v, U32 m) {
  v->info[m] = (U8)((v->info[m] & 0xFC) | 1);
}

// ------------------------------------------------------------------
// output sinks: outFile + stdout, sharing one FILE* when they are the
// same fd so interleaving matches the reference's single stream
// ------------------------------------------------------------------

struct Sinks {
  FILE *out;  // fprintf(outFile, ...) target
  FILE *so;   // printf(...) target
  bool same;
};

static Sinks sinksOpen(const RSView *v) {
  Sinks s;
  s.same = (v->fdOut == v->fdStdout) || v->fdOut < 0;
  s.so = fdopen(dup(v->fdStdout), "w");
  s.out = s.same ? s.so : fdopen(dup(v->fdOut), "w");
  if (!s.so || !s.out) die("modasm native: cannot open output stream");
  return s;
}

static void sinksClose(Sinks &s) {
  if (!s.same) fclose(s.out);
  fclose(s.so);
}

// ------------------------------------------------------------------
// IHash: faithful int-key open-addressed hash (hash.c semantics)
// ------------------------------------------------------------------

static long g_hAdded = 0, g_hBounced = 0, g_hFound = 0, g_hNotFound = 0;
static int g_hCreated = 0, g_hDestroyed = 0;
static const long H_REMOVED = 1;  // (INT_MAX-1)^INT_MAX (hash.c:68)

static inline long keyInt(U32 x) {  // HASH_INT (hash.h:43)
  return (long)(U32)(x ^ 0x7fffffffu);
}

struct IHash {
  int nbits;
  unsigned mask;
  int n;
  int guard;
  int iter;
  std::vector<long> keys;
  std::vector<int> values;
  std::vector<int> fl;  // LIFO free list of removed dense values
};

static inline long hSlot(long key, unsigned mask) {
  int z = 12;  // (64 bits)/5 (hash.c:55)
  int x = (int)key;
  long h = (long)x;
  x >>= 5;
  while (z--) { h ^= x; x >>= 5; }
  return h & (long)mask;
}

static inline long hDelta(long key, unsigned mask) {
  int z = 9;  // (64 bits)/7
  int x = (int)key;
  long d = (long)x;
  x >>= 7;
  while (z--) { d ^= x; x >>= 7; }
  return (d & (long)mask) | 1;
}

static void hCreate(IHash &h, int n) {
  if (n < 64) n = 64;
  --n;
  h.nbits = 1;
  while (n >>= 1) ++h.nbits;
  h.mask = (1u << h.nbits) - 1;
  h.guard = 1 << (h.nbits - 1);
  h.keys.assign((size_t)1 << h.nbits, 0);
  h.values.assign((size_t)1 << h.nbits, 0);
  h.n = 0;
  h.fl.clear();
  h.iter = -1;
  ++g_hCreated;
}

static void hDestroyCount() { ++g_hDestroyed; }

static void hDouble(IHash &h) {
  int oldsize = 1 << h.nbits;
  ++h.nbits;
  h.mask = (1u << h.nbits) - 1;
  h.guard = 1 << (h.nbits - 1);
  std::vector<long> ok;
  std::vector<int> ov;
  ok.swap(h.keys);
  ov.swap(h.values);
  h.keys.assign((size_t)1 << h.nbits, 0);
  h.values.assign((size_t)1 << h.nbits, 0);
  // reference bug replicated (hash.c:126-155): `delta` is FUNCTION-scoped
  // in hashDouble, so it is computed for the first key that bounces and
  // then reused, stale, for every later relocated key.  Mis-placed entries
  // are invisible to hashAdd's (correct, per-key) probe, so re-added keys
  // become duplicates and hashCount over-reports — observable in
  // assembleFromRead's "AR %d total hits" once the table has doubled.
  long delta = 0;
  for (int i = 0; i < oldsize; ++i)
    if (ok[i] && ok[i] != H_REMOVED) {
      long hash = hSlot(ok[i], h.mask);
      while (true) {
        if (!h.keys[hash]) {
          h.keys[hash] = ok[i];
          h.values[hash] = ov[i];
          --h.guard;
          ++g_hAdded;
          break;
        }
        ++g_hBounced;
        if (!delta) delta = hDelta(ok[i], h.mask);
        hash = (hash + delta) & h.mask;
      }
    }
}

static bool hAdd(IHash &h, long key, int *index) {
  if (!h.guard) hDouble(h);
  long hash = hSlot(key, h.mask), delta = 0;
  while (true) {
    if (!h.keys[hash] || h.keys[hash] == H_REMOVED) {
      if (!h.keys[hash]) --h.guard;
      h.keys[hash] = key;
      if (!h.fl.empty()) {
        h.values[hash] = h.fl.back();
        h.fl.pop_back();
      } else
        h.values[hash] = ++h.n;
      ++g_hAdded;
      if (index) *index = h.values[hash] - 1;
      return true;
    } else if (h.keys[hash] == key) {
      ++g_hFound;
      if (index) *index = h.values[hash] - 1;
      return false;
    } else {
      ++g_hBounced;
      if (!delta) delta = hDelta(key, h.mask);
      hash = (hash + delta) & h.mask;
    }
  }
}

static bool hFind(IHash &h, long key, int *index) {
  long hash = hSlot(key, h.mask), delta = 0;
  while (true) {
    if (h.keys[hash] == key) {
      ++g_hFound;
      if (index) *index = h.values[hash] - 1;
      return true;
    } else if (!h.keys[hash]) {
      ++g_hNotFound;
      return false;
    } else {
      ++g_hBounced;
      if (!delta) delta = hDelta(key, h.mask);
      hash = (hash + delta) & h.mask;
    }
  }
}

static bool hRemove(IHash &h, long key) {
  long hash = hSlot(key, h.mask), delta = 0;
  while (true) {
    if (h.keys[hash] == key) {
      h.keys[hash] = H_REMOVED;
      h.fl.push_back(h.values[hash]);
      ++g_hFound;
      return true;
    } else if (!h.keys[hash]) {
      ++g_hNotFound;
      return false;
    } else {
      ++g_hBounced;
      if (!delta) delta = hDelta(key, h.mask);
      hash = (hash + delta) & h.mask;
    }
  }
}

static bool hNext(IHash &h, long *kp, int *ip) {
  int size = 1 << h.nbits;
  while (++h.iter < size)
    if (h.keys[h.iter] && h.keys[h.iter] != H_REMOVED) {
      *kp = h.keys[h.iter];
      if (ip) *ip = h.values[h.iter] - 1;
      return true;
    }
  return false;
}

static inline int hCount(const IHash &h) { return h.n - (int)h.fl.size(); }

static void hashStats(FILE *so) {  // hash.c:278-284, printf -> stdout
  fprintf(so, "%d hashes (%d created, %d destroyed)\n",
          g_hCreated - g_hDestroyed, g_hCreated, g_hDestroyed);
  fprintf(so, "%ld added, %ld found, %ld bounced, %ld not found\n", g_hAdded,
          g_hFound, g_hBounced, g_hNotFound);
}

// ------------------------------------------------------------------
// CSR accessors
// ------------------------------------------------------------------

static inline const U32 *readHits(const RSView *v, I64 i) {
  return v->hits + v->hitOff[i];
}
static inline const U16 *readDx(const RSView *v, I64 i) {
  return v->dx + v->hitOff[i];
}
static inline int *readNCopy(const RSView *v, I64 i) {
  return v->nCopy + 4 * i;
}

// ------------------------------------------------------------------
// readsetFileRead hit assembly (modasm.c:158-177): one pass over the
// scan's (global pos, isF) stream + the table lookup results, producing
// hits (idx | TOPBIT*isF), dx (U16 gap to the previous found hit in the
// read; first hit's dx is its read position), per-read hit/miss counts,
// and the rebuilt saturating U16 depth.  Replaces a pile of numpy
// temporaries (searchsorted + repeats + bincounts) that dominated
// modasm -f's runtime.  Returns the number of found hits.
// ------------------------------------------------------------------

extern "C" I64 rs_hits_from_scan(const I64 *gpos, const U8 *isF,
                                 const U32 *sidx, I64 n, const I64 *offsets,
                                 I64 nReads, U32 *hits, U16 *dx,
                                 int *nHit, int *nMiss, U16 *depth) {
  I64 o = 0, r = 0, lastPos = 0;
  for (I64 i = 0; i < n; ++i) {
    while (r < nReads && gpos[i] >= offsets[r + 1]) {
      ++r;
      lastPos = 0;
    }
    I64 rpos = gpos[i] - offsets[r];
    U32 idx = sidx[i];
    if (idx) {
      hits[o] = idx | (isF[i] ? 0x80000000u : 0u);
      dx[o] = (U16)(rpos - lastPos);
      lastPos = rpos;
      ++o;
      ++nHit[r + 1];
      U32 d = (U32)depth[idx] + 1u;
      depth[idx] = d > 0xFFFFu ? (U16)0xFFFF : (U16)d;
    } else {
      ++nMiss[r + 1];
    }
  }
  return o;
}

// Map ascending global emit positions to (read id, read-relative pos) in
// one walk — replaces numpy searchsorted + two np.repeat temporaries in
// ModimizerScanner.scan_batch.
extern "C" void sh_rid_rpos(const I64 *gpos, I64 n, const I64 *offsets,
                            I64 nReads, I64 *rid, I64 *rpos) {
  I64 r = 0;
  for (I64 i = 0; i < n; ++i) {
    while (r < nReads && gpos[i] >= offsets[r + 1]) ++r;
    rid[i] = r;
    rpos[i] = gpos[i] - offsets[r];
  }
}

// ------------------------------------------------------------------
// invBuild (modasm.c:258-287)
// ------------------------------------------------------------------

extern "C" void rs_inv_build(RSView *v) {
  I64 off = 0;
  std::vector<I64> cur((size_t)v->msMax + 1, 0);
  for (I64 m = 1; m <= v->msMax; ++m) {
    v->invOff[m] = off;
    cur[m] = off;
    if (v->depth[m] && v->depth[m] < U16MAXV) off += v->depth[m];
  }
  v->invOff[0] = 0;
  v->invOff[v->msMax + 1] = off;
  for (I64 i = 1; i < v->nReads; ++i) {
    int *nc = readNCopy(v, i);
    nc[0] = nc[1] = nc[2] = nc[3] = 0;
    const U32 *h = readHits(v, i);
    int nh = v->nHit[i];
    for (int j = 0; j < nh; ++j) {
      U32 y = h[j] & TOPMASK;
      ++nc[msCopy(v, y)];
      if (v->depth[y] < U16MAXV) v->invReads[cur[y]++] = (U32)i;
    }
  }
}

// ------------------------------------------------------------------
// findOverlaps (modasm.c:291-418)
// ------------------------------------------------------------------

struct Olap {
  U32 iy;
  U16 nHit;
  U8 isPlus;
  U8 isContained;
  U16 nBadOrder;
  U16 nBadFlip;
};

extern "C" int olapCmp(const void *a, const void *b) {
  return (int)((const Olap *)b)->nHit - (int)((const Olap *)a)->nHit;
}

static std::vector<int> s_omap;
static std::vector<U16> s_hmap;
static std::vector<U32> s_xPos;

static void foPhase2(RSView *v, I64 ix, int level, FILE *fo,
                     std::vector<Olap> &olap, int nRepeat);

static void findOverlaps(RSView *v, I64 ix, int level, FILE *fo,
                         std::vector<Olap> &olap) {
  s_omap.assign((size_t)v->nReads, 0);
  s_hmap.assign((size_t)v->msMax + 1, 0);
  int nHitX = v->nHit[ix];
  int xLen = v->rlen[ix];
  const U32 *hx = readHits(v, ix);
  const U16 *dxx = readDx(v, ix);
  s_xPos.assign((size_t)nHitX + 1, 0);

  int nRepeat = 0;
  olap.clear();
  olap.push_back(Olap{0, 0, 0, 0, 0, 0});  // burn slot 0 (modasm.c:328)

  for (int j = 0; j < nHitX; ++j) {
    U32 hxx = hx[j] & TOPMASK;
    s_xPos[j + 1] = s_xPos[j] + dxx[j];
    if (!msIsCopy1(v, hxx)) continue;
    if (s_hmap[hxx]) {
      ++nRepeat;
      v->bad[ix] |= BAD_REPEAT;
      continue;
    }
    s_hmap[hxx] = (U16)(j + 1);
    if (v->depth[hxx] >= U16MAXV) continue;  // reference would deref NULL
    const U32 *r2 = v->invReads + v->invOff[hxx];
    int dep = v->depth[hxx];
    for (int k = 0; k < dep; ++k) {
      U32 y = r2[k];
      Olap *o;
      if (!s_omap[y]) {
        s_omap[y] = (int)olap.size();
        olap.push_back(Olap{y, 0, 0, 0, 0, 0});
        o = &olap.back();
      } else
        o = &olap[s_omap[y]];
      ++o->nHit;  // U16, wraps like the reference
    }
  }

  std::stable_sort(olap.begin(), olap.end(),
                   [](const Olap &a, const Olap &b) {
                     return olapCmp(&a, &b) < 0;
                   });
  foPhase2(v, ix, level, fo, olap, nRepeat);
}

// phase 2 of findOverlaps (modasm.c:353-418): per-candidate orientation
// vote, order-violation scan, containment, flags and RR/RH prints.  Shared
// verbatim by the serial walk above and the device-phase-1 path below;
// expects olap = candidates sorted by descending (U16) nHit with the
// burned slot 0 at the END, and s_hmap/s_xPos primed for read ix.
static void foPhase2(RSView *v, I64 ix, int level, FILE *fo,
                     std::vector<Olap> &olap, int nRepeat) {
  int nHitX = v->nHit[ix];
  int xLen = v->rlen[ix];
  const U32 *hx = readHits(v, ix);
  int nGood = 0, nBad = 0;
  size_t k = 1;
  // NB the reference walks o from element 0 while k counts from 1, so the
  // last element (the burned slot, sorted to the end) is never examined
  for (Olap *o = olap.data(); k < olap.size(); ++k, ++o) {
    if (o->nHit < 3) break;
    U32 iy = o->iy;
    if (v->bad[iy]) continue;
    int nHitY = v->nHit[iy];
    int yLen = v->rlen[iy];
    const U32 *hy = readHits(v, iy);
    const U16 *dy = readDx(v, iy);
    int nPlus = 0, nMinus = 0;
    U16 ihx;
    for (int j = 0; j < nHitY; ++j)
      if ((ihx = s_hmap[hy[j] & TOPMASK])) {
        if ((hy[j] & TOPBIT) == (hx[ihx - 1] & TOPBIT)) ++nPlus;
        else ++nMinus;
      }
    double yPos = dy[0];
    if (nPlus > nMinus) {
      o->isPlus = 1;
      o->nBadFlip = (U16)nMinus;
      int last = 0, lastDiff = 0;
      for (int j = 0; j < nHitY; ++j) {
        if ((ihx = s_hmap[hy[j] & TOPMASK])) {
          lastDiff = (int)((double)s_xPos[ihx] - yPos);
          if (!last && lastDiff < 0) o->isContained = 1;  // x starts in y
          if (ihx < last) { ++o->nBadOrder; --nPlus; }
          last = ihx;
        }
        if (j + 1 < nHitY) yPos += dy[j + 1];
      }
      if (o->isContained && xLen - lastDiff > yLen) o->isContained = 0;
    } else if (nMinus && !nPlus) {
      o->isPlus = 0;
      o->nBadFlip = (U16)nPlus;
      int last = nHitX, lastDiff = 0;
      for (int j = 0; j < nHitY; ++j) {
        if ((ihx = s_hmap[hy[j] & TOPMASK])) {
          // x->len - xPos[ihx] promotes to unsigned in the reference
          lastDiff = (int)((double)(U32)((U32)xLen - s_xPos[ihx]) - yPos);
          if (!last && lastDiff < 0) o->isContained = 1;
          if (ihx > last) { ++o->nBadOrder; --nMinus; }
          last = ihx;
        }
        if (j + 1 < nHitY) yPos += dy[j + 1];
      }
      if (o->isContained && xLen - lastDiff > yLen) o->isContained = 0;
    }
    if (o->nBadOrder || o->nBadFlip) ++nBad;
    else ++nGood;

    if (level > 1) {
      fprintf(fo, "RH\t%u\tlen %d\t%s\t+ %d\t- %d\tbadOrder %d", o->iy, yLen,
              (o->nBadOrder + o->nBadFlip) ? "BAD" : "GOOD", nPlus, nMinus,
              o->nBadOrder);
      fprintf(fo, "\t%s\n", o->isContained ? "CONTAINED" : "OVERLAP");
    }
  }
  olap.resize(k);

  if (!nGood && !nBad) {
    v->bad[ix] |= BAD_NOMATCH;
    if (nHitX < 10) v->bad[ix] |= BAD_LOWHIT;
    else if (readNCopy(v, ix)[1] < 10) v->bad[ix] |= BAD_LOWCOPY1;
  }

  if (level > 0) {
    fprintf(fo, "RR %6u\tlen %d\tnHit %3d\tnMiss %3d\t", (U32)ix, xLen, nHitX,
            v->nMiss[ix]);
    const int *nc = readNCopy(v, ix);
    fprintf(fo, "nCpy %d %d %d %d\t", nc[0], nc[1], nc[2], nc[3]);
    fprintf(fo, "nRepeatMod %d\tnGood %4d\tnBad %4d\n", nRepeat, nGood, nBad);
  }
}

extern "C" void rs_find_overlaps(RSView *v, I64 ix, int level) {
  Sinks s = sinksOpen(v);
  std::vector<Olap> olap;
  findOverlaps(v, ix, level, s.out, olap);
  sinksClose(s);
}

extern "C" void rs_overlaps_every(RSView *v, I64 d) {
  Sinks s = sinksOpen(v);
  std::vector<Olap> olap;
  for (I64 ix = d; ix < v->nReads; ix += d)
    findOverlaps(v, ix, 1, s.out, olap);
  sinksClose(s);
}

// ------------------------------------------------------------------
// device-phase-1 variants: candidate discovery + counting runs batched on
// the device (parallel/overlaps.py self-join) and arrives here as per-read
// CSR candidate lists ALREADY in reference order (descending wrapped-U16
// nHit over first-encounter order, the stable_sort result at
// modasm.c:353); this side re-primes s_hmap/s_xPos (O(nHitX)) and runs
// the identical phase 2, so the sequential cross-read bad-flag semantics
// (bad[iy] checks see exactly the flags set by lower ix) are preserved.
// ------------------------------------------------------------------

static void findOverlapsPre(RSView *v, I64 ix, int level, FILE *fo,
                            std::vector<Olap> &olap, const U32 *candY,
                            const U16 *candHit, I64 nCand) {
  s_hmap.assign((size_t)v->msMax + 1, 0);
  int nHitX = v->nHit[ix];
  const U32 *hx = readHits(v, ix);
  const U16 *dxx = readDx(v, ix);
  s_xPos.assign((size_t)nHitX + 1, 0);

  int nRepeat = 0;
  for (int j = 0; j < nHitX; ++j) {
    U32 hxx = hx[j] & TOPMASK;
    s_xPos[j + 1] = s_xPos[j] + dxx[j];
    if (!msIsCopy1(v, hxx)) continue;
    if (s_hmap[hxx]) {
      ++nRepeat;
      v->bad[ix] |= BAD_REPEAT;
      continue;
    }
    s_hmap[hxx] = (U16)(j + 1);
  }

  olap.clear();
  olap.reserve((size_t)nCand + 1);
  for (I64 i = 0; i < nCand; ++i)
    olap.push_back(Olap{candY[i], candHit[i], 0, 0, 0, 0});
  olap.push_back(Olap{0, 0, 0, 0, 0, 0});  // burned slot, sorted-to-end
  foPhase2(v, ix, level, fo, olap, nRepeat);
}

extern "C" void rs_mark_bad_pre(RSView *v, const U32 *candY,
                                const U16 *candHit, const I64 *candOff) {
  Sinks s = sinksOpen(v);
  I64 nr = v->nReads;
  for (I64 ix = 1; ix < nr; ++ix) v->bad[ix] = 0;

  std::vector<int> badList((size_t)nr * 10, 0);
  std::vector<int> nBadArr((size_t)nr, 0), lBad((size_t)nr, 0);
  std::vector<Olap> olap;

  for (I64 ix = 1; ix < nr; ++ix) {
    findOverlapsPre(v, ix, 0, s.out, olap, candY + candOff[ix],
                    candHit + candOff[ix], candOff[ix + 1] - candOff[ix]);
    for (size_t i = 0; i < olap.size(); ++i) {
      Olap *o = &olap[i];
      if (o->nBadFlip || o->nBadOrder) {
        int iy = (int)o->iy;
        ++nBadArr[iy];
        if (nBadArr[iy] < 10 && lBad[ix] < 10)
          badList[10 * ix + lBad[ix]++] = iy;
      }
    }
  }

  int N = 0;
  for (I64 ix = 1; ix < nr; ++ix)
    if (nBadArr[ix] >= 10) { v->bad[ix] |= BAD_ORDER10; ++N; lBad[ix] = 0; }
  fprintf(s.so, "MB  %d with >=10 bad overlaps\n", N);

  for (I64 ix = 1; ix < nr; ++ix)
    for (int i = lBad[ix]; i--;)
      if (v->bad[badList[10 * ix + i]])
        badList[10 * ix + i] = badList[10 * ix + --lBad[ix]];

  N = 0;
  for (I64 ix = 1; ix < nr; ++ix)
    if (lBad[ix] >= 2) { v->bad[ix] |= BAD_ORDER1; ++N; lBad[ix] = 0; }
  fprintf(s.so, "MB  %d with multiple bad overlaps\n", N);

  for (I64 ix = 1; ix < nr; ++ix)
    for (int i = lBad[ix]; i--;)
      if (v->bad[badList[10 * ix + i]])
        badList[10 * ix + i] = badList[10 * ix + --lBad[ix]];

  N = 0;
  for (I64 ix = 1; ix < nr; ++ix)
    if (lBad[ix] > 0) { v->bad[ix] |= BAD_ORDER1; ++N; lBad[ix] = 0; }
  fprintf(s.so, "MB  %d with single bad overlaps\n", N);
  sinksClose(s);
}

extern "C" void rs_mark_contained_pre(RSView *v, const U32 *candY,
                                      const U16 *candHit,
                                      const I64 *candOff) {
  Sinks s = sinksOpen(v);
  int nContained = 0, nNotContained = 0;
  U64 totLen = 0;
  std::vector<Olap> olap;
  for (I64 ix = 1; ix < v->nReads; ++ix) {
    if (v->bad[ix]) continue;
    findOverlapsPre(v, ix, 0, s.out, olap, candY + candOff[ix],
                    candHit + candOff[ix], candOff[ix + 1] - candOff[ix]);
    int maxHit = 0;
    for (size_t io = 0; io < olap.size(); ++io) {
      Olap *o = &olap[io];
      if (o->iy == (U32)ix) continue;  // no self-containment
      if (!o->isContained || o->nHit <= maxHit) continue;
      v->contained[ix] = (int)o->iy;
      maxHit = o->nHit;
    }
    if (v->contained[ix]) ++nContained;
    else { ++nNotContained; totLen += (U64)v->rlen[ix]; }
  }
  fprintf(s.so,
          "MC  found %d contained reads, leaving %d not contained, av length "
          "%.1f\n",
          nContained, nNotContained,
          nNotContained ? totLen / (double)nNotContained : 0.);
  sinksClose(s);
}

extern "C" void rs_overlaps_every_pre(RSView *v, I64 d, const U32 *candY,
                                      const U16 *candHit,
                                      const I64 *candOff) {
  Sinks s = sinksOpen(v);
  std::vector<Olap> olap;
  for (I64 ix = d; ix < v->nReads; ix += d)
    findOverlapsPre(v, ix, 1, s.out, olap, candY + candOff[ix],
                    candHit + candOff[ix], candOff[ix + 1] - candOff[ix]);
  sinksClose(s);
}

extern "C" void rs_cluster_pre(RSView *v, const U32 *candY,
                               const U16 *candHit, const I64 *candOff) {
  // rs_cluster with device-precomputed candidates: kills the per-read inv
  // walks that make low-coverage clustering minutes-quadratic
  // (modasm.c:461-510); output identical.
  Sinks s = sinksOpen(v);
  I64 nr = v->nReads;
  std::vector<int> link((size_t)nr, 0);
  int nOverlapMade = 0, nNonEmpty = 0;
  std::vector<Olap> olap;
  for (I64 i = 1; i < nr; ++i)
    if (!link[i]) {
      findOverlapsPre(v, i, 0, s.out, olap, candY + candOff[i],
                      candHit + candOff[i], candOff[i + 1] - candOff[i]);
      int iLink = (int)i;
      size_t j = 1;
      for (Olap *o = olap.data(); j < olap.size(); ++j, ++o) {
        if (o->iy == (U32)i) continue;
        U32 z = o->iy;
        while (link[z]) {
          if (link[z] == iLink) break;
          z = link[z];
        }
        if (!link[z]) {
          if ((int)(z + 1) > iLink) link[z] = iLink;
          else link[iLink - 1] = z;  // reference writes here (modasm.c:480)
        }
      }
      ++nOverlapMade;
      if (olap.size() > 1) ++nNonEmpty;
    }
  fprintf(s.so, "made %d overlap arrays, of which %d nonEmpty\n", nOverlapMade,
          nNonEmpty);
  int nClus = 0;
  std::vector<int> clus((size_t)nr, 0);
  for (I64 i = 1; i < nr; ++i)
    if (link[i]) clus[i] = clus[link[i]];
    else clus[i] = ++nClus;
  std::vector<int> clusSize((size_t)nClus + 1, 0);
  for (I64 i = 1; i < nr; ++i) ++clusSize[clus[i]];
  int nProperCluster = 0;
  std::vector<int> properClus((size_t)nClus + 1, 0);
  for (int i = 0; i < nClus; ++i)
    if (clusSize[i] > 1) {
      properClus[i] = ++nProperCluster;
      fprintf(s.so, "proper cluster %d size %d\n", nProperCluster,
              clusSize[i]);
      clusSize[nProperCluster] = clusSize[i];  // reference clobber, kept
    }
  fprintf(s.so, "found %d clusters of which %d are proper\n", nClus,
          nProperCluster);
  sinksClose(s);
}

// ------------------------------------------------------------------
// markBadReads (modasm.c:1266-1322)
// ------------------------------------------------------------------

extern "C" void rs_mark_bad(RSView *v) {
  Sinks s = sinksOpen(v);
  I64 nr = v->nReads;
  for (I64 ix = 1; ix < nr; ++ix) v->bad[ix] = 0;

  std::vector<int> badList((size_t)nr * 10, 0);
  std::vector<int> nBadArr((size_t)nr, 0), lBad((size_t)nr, 0);
  std::vector<Olap> olap;

  for (I64 ix = 1; ix < nr; ++ix) {
    findOverlaps(v, ix, 0, s.out, olap);
    for (size_t i = 0; i < olap.size(); ++i) {
      Olap *o = &olap[i];
      if (o->nBadFlip || o->nBadOrder) {
        int iy = (int)o->iy;
        ++nBadArr[iy];
        if (nBadArr[iy] < 10 && lBad[ix] < 10)
          badList[10 * ix + lBad[ix]++] = iy;
      }
    }
  }

  int N = 0;
  for (I64 ix = 1; ix < nr; ++ix)
    if (nBadArr[ix] >= 10) { v->bad[ix] |= BAD_ORDER10; ++N; lBad[ix] = 0; }
  fprintf(s.so, "MB  %d with >=10 bad overlaps\n", N);

  for (I64 ix = 1; ix < nr; ++ix)
    for (int i = lBad[ix]; i--;)
      if (v->bad[badList[10 * ix + i]])
        badList[10 * ix + i] = badList[10 * ix + --lBad[ix]];

  N = 0;
  for (I64 ix = 1; ix < nr; ++ix)
    if (lBad[ix] >= 2) { v->bad[ix] |= BAD_ORDER1; ++N; lBad[ix] = 0; }
  fprintf(s.so, "MB  %d with multiple bad overlaps\n", N);

  for (I64 ix = 1; ix < nr; ++ix)
    for (int i = lBad[ix]; i--;)
      if (v->bad[badList[10 * ix + i]])
        badList[10 * ix + i] = badList[10 * ix + --lBad[ix]];

  N = 0;
  for (I64 ix = 1; ix < nr; ++ix)
    if (lBad[ix] > 0) { v->bad[ix] |= BAD_ORDER1; ++N; lBad[ix] = 0; }
  fprintf(s.so, "MB  %d with single bad overlaps\n", N);
  sinksClose(s);
}

// ------------------------------------------------------------------
// markContained (modasm.c:1370-1394)
// ------------------------------------------------------------------

extern "C" void rs_mark_contained(RSView *v) {
  Sinks s = sinksOpen(v);
  int nContained = 0, nNotContained = 0;
  U64 totLen = 0;
  std::vector<Olap> olap;
  for (I64 ix = 1; ix < v->nReads; ++ix) {
    if (v->bad[ix]) continue;
    findOverlaps(v, ix, 0, s.out, olap);
    int maxHit = 0;
    for (size_t io = 0; io < olap.size(); ++io) {
      Olap *o = &olap[io];
      if (o->iy == (U32)ix) continue;  // no self-containment
      if (!o->isContained || o->nHit <= maxHit) continue;
      v->contained[ix] = (int)o->iy;
      maxHit = o->nHit;
    }
    if (v->contained[ix]) ++nContained;
    else { ++nNotContained; totLen += (U64)v->rlen[ix]; }
  }
  fprintf(s.so,
          "MC  found %d contained reads, leaving %d not contained, av length "
          "%.1f\n",
          nContained, nNotContained,
          nNotContained ? totLen / (double)nNotContained : 0.);
  sinksClose(s);
}

// ------------------------------------------------------------------
// cluster (modasm.c:461-510) — replicated literally, quirks included
// ------------------------------------------------------------------

extern "C" void rs_cluster(RSView *v) {
  Sinks s = sinksOpen(v);
  I64 nr = v->nReads;
  std::vector<int> link((size_t)nr, 0);
  int nOverlapMade = 0, nNonEmpty = 0;
  std::vector<Olap> olap;
  for (I64 i = 1; i < nr; ++i)
    if (!link[i]) {
      findOverlaps(v, i, 0, s.out, olap);
      int iLink = (int)i;
      size_t j = 1;
      for (Olap *o = olap.data(); j < olap.size(); ++j, ++o) {
        if (o->iy == (U32)i) continue;
        U32 z = o->iy;
        while (link[z]) {
          if (link[z] == iLink) break;
          z = link[z];
        }
        if (!link[z]) {
          if ((int)(z + 1) > iLink) link[z] = iLink;
          else link[iLink - 1] = z;  // reference writes here (modasm.c:480)
        }
      }
      ++nOverlapMade;
      if (olap.size() > 1) ++nNonEmpty;
    }
  fprintf(s.so, "made %d overlap arrays, of which %d nonEmpty\n", nOverlapMade,
          nNonEmpty);
  int nClus = 0;
  std::vector<int> clus((size_t)nr, 0);
  for (I64 i = 1; i < nr; ++i)
    if (link[i]) clus[i] = clus[link[i]];
    else clus[i] = ++nClus;
  std::vector<int> clusSize((size_t)nClus + 1, 0);  // reference is new0(nClus)
  for (I64 i = 1; i < nr; ++i) ++clusSize[clus[i]];
  int nProperCluster = 0;
  std::vector<int> properClus((size_t)nClus + 1, 0);
  for (int i = 0; i < nClus; ++i)
    if (clusSize[i] > 1) {
      properClus[i] = ++nProperCluster;
      fprintf(s.so, "proper cluster %d size %d\n", nProperCluster,
              clusSize[i]);
      clusSize[nProperCluster] = clusSize[i];  // reference clobber, kept
    }
  fprintf(s.so, "found %d clusters of which %d are proper\n", nClus,
          nProperCluster);
  sinksClose(s);
}

// ------------------------------------------------------------------
// cleanMods (modasm.c:514-555)
// ------------------------------------------------------------------

extern "C" void rs_clean_mods(RSView *v) {
  Sinks s = sinksOpen(v);
  int w = v->hasherW;
  // generation stamps replace the reference's per-read bzero'd bool map
  std::vector<I64> seenAt((size_t)v->msMax + 1, 0);
  // reference off-by-one (modasm.c:522-523): r starts at index 0 while i
  // starts at 1, so cleanMods scans reads 0..n-1 — the LAST read is never
  // processed (read 0 is the burned null read, a no-op).  Replicated for
  // output parity.
  for (I64 i = 1; i < v->nReads; ++i) {
    const U32 *h = readHits(v, i - 1);
    const U16 *dxr = readDx(v, i - 1);
    int nh = v->nHit[i - 1];
    int lastDepth = 0;
    U32 hhLast = 0;
    for (int j = 0; j < nh; ++j) {
      U32 hh = h[j] & TOPMASK;
      if (seenAt[hh] == i) v->info[hh] |= MS_REPEAT;
      seenAt[hh] = i;
      if (j && dxr[j] < w && j + 1 < nh && dxr[j + 1] < w)
        v->info[hh] |= MS_INTERNAL;
      int thisDepth = v->depth[hh];
      if (j) {
        if (lastDepth > 2 * thisDepth) v->info[hh] |= MS_MINOR;
        if (thisDepth > 2 * lastDepth) v->info[hhLast] |= MS_MINOR;
      }
      lastDepth = thisDepth;
      hhLast = hh;
    }
  }
  int nRep = 0, nInt = 0, nMinor = 0;
  for (I64 i = 0; i < v->msMax + 1; ++i) {
    if (v->info[i] & MS_REPEAT) ++nRep;
    if (v->info[i] & MS_INTERNAL) ++nInt;
    if (v->info[i] & MS_MINOR) ++nMinor;
  }
  rs_inv_build(v);
  fprintf(s.so, "set %d repeated, %d internal, %d minor_variant mods\n", nRep,
          nInt, nMinor);
  sinksClose(s);
}

// ------------------------------------------------------------------
// testMods (modasm.c:559-748)
// ------------------------------------------------------------------

struct Test {
  U32 mod;
  int dx;
};

extern "C" int testCmp(const void *a, const void *b) {
  const Test *ta = (const Test *)a, *tb = (const Test *)b;
  if (ta->mod < tb->mod) return -1;
  if (ta->mod > tb->mod) return 1;
  if (ta->dx < tb->dx) return -1;
  if (ta->dx > tb->dx) return 1;
  return 0;
}

// CIntArr: the reference's Array-of-int with its exact growth schedule
// (array.c:143-160) so unchecked arr() reads beyond max (but within dim)
// return the same zeros the reference reads
struct CIntArr {
  std::vector<int> buf;
  int dim = 0;
  int max = 0;
  void recreate(int n) {  // arrayReCreate semantics (array.c:88-107)
    if (n < 1) n = 1;
    if (dim < n || (I64)(dim - n) * 4 > (1 << 19)) {
      buf.assign((size_t)n, 0);
      dim = n;
    } else
      memset(buf.data(), 0, (size_t)n * 4);
    max = 0;
  }
  void bump(int i) {  // ++array(a, i, int)
    if (i < 0) return;  // reference UB (heap underwrite); no-op here
    if (i >= max) {
      if (i >= dim) {
        int nd = dim;
        while (i >= nd) {
          if ((I64)nd * 4 < (1 << 23)) nd *= 2;
          else nd += 1024 + ((1 << 23) / 4);
          if (i >= nd) nd = i + 1;
        }
        buf.resize((size_t)nd, 0);
        // arrayExtend copies only max elements; the rest was fresh calloc
        std::fill(buf.begin() + max, buf.begin() + dim, 0);
        dim = nd;
      }
      max = i + 1;
    }
    ++buf[i];
  }
  int rd(int i) const {  // arr() unchecked read
    if (i < 0 || i >= dim) return 0;  // reference UB; deterministic 0 here
    return buf[i];
  }
  void suffixSum() {  // for (kk = max-1; kk--;) a[kk] += a[kk+1]
    if (max > 1)
      for (int kk = max - 1; kk--;) buf[kk] += buf[kk + 1];
  }
};

static inline bool checkMod(const RSView *v, U32 h) {  // modasm.c:564-567
  return !msIsCopy0(v, h) &&
         (v->info[h] & (MS_REPEAT | MS_RDNA)) == MS_RDNA;
}

static int g_testRun = 0;  // static RUN counter (modasm.c:602)

extern "C" void rs_test_mods(RSView *v, int minDepth, int maxDepth) {
  Sinks s = sinksOpen(v);
  int RUN = ++g_testRun;
  char yName[24], zName[24];
  snprintf(yName, sizeof yName, "YY-TEST%d", RUN);
  snprintf(zName, sizeof zName, "ZZ-TEST%d", RUN);
  // the reference creates (truncates) the side files BEFORE the modInfo
  // check (modasm.c:604-609), so -T without -R leaves empty YY/ZZ files
  FILE *yFile = fopen(yName, "w");
  FILE *zFile = fopen(zName, "w");
  if (!v->miFlags) {
    fclose(yFile);
    fclose(zFile);
    die("need to run -R first");
  }

  for (I64 i = 0; i < v->msMax + 1; ++i)
    v->miGood[i] = v->miMod2[i] = v->miBadLD[i] = v->miSplit[i] =
        v->miSplitLD[i] = 0;

  std::vector<Test> test;
  CIntArr start, end;
  int w = v->hasherW;
  int nTested = 0;

  for (I64 i = 0; i < v->msMax + 1; ++i) {
    if (!(v->depth[i] >= minDepth && v->depth[i] < maxDepth &&
          checkMod(v, (U32)i)))
      continue;
    ++nTested;
    test.clear();
    start.recreate(20000);
    end.recreate(20000);
    const U32 *rj = v->invReads + v->invOff[i];
    int dep = v->depth[i] < U16MAXV ? v->depth[i] : 0;
    for (int j = 0; j < dep; ++j) {
      I64 r = rj[j];
      const U32 *h = readHits(v, r);
      const U16 *dxr = readDx(v, r);
      int nh = v->nHit[r];
      int rl = v->rlen[r];
      int x = 0;
      size_t it = test.size();
      for (int k = 0; k < nh; ++k) {
        x += dxr[k];
        if ((h[k] & TOPMASK) == (U32)i) {
          if (h[k] & TOPBIT) {  // forward
            start.bump(x);
            end.bump(rl - x - w);
            while (it < test.size()) { test[it].dx -= x; ++it; }
            x = 0;
            while (++k < nh) {
              x += dxr[k];
              U32 hh = h[k] & TOPMASK;
              if (checkMod(v, hh)) test.push_back(Test{hh, x});
            }
          } else {  // reversed
            start.bump(rl - x - w);
            end.bump(x);
            while (it < test.size()) {
              test[it].dx = x - test[it].dx;
              ++it;
            }
            x = 0;
            while (++k < nh) {
              x -= dxr[k];
              U32 hh = h[k] & TOPMASK;
              if (checkMod(v, hh)) test.push_back(Test{hh, x});
            }
          }
        } else {
          U32 hh = h[k] & TOPMASK;
          if (checkMod(v, hh)) test.push_back(Test{hh, x});
        }
      }
    }
    if (!(end.rd(end.max - 1) > 0)) die("assert failed: end last > 0");
    if (!(start.rd(start.max - 1) > 0)) die("assert failed: start last > 0");
    end.suffixSum();
    start.suffixSum();
    std::stable_sort(test.begin(), test.end(),
                     [](const Test &a, const Test &b) {
                       return testCmp(&a, &b) < 0;
                     });

    Test *t = test.data();
    int nMod = 0, nMod2 = 0, nGood = 0, nSplit = 0;
    int k = 0, aMax = (int)test.size();
    while (k < aMax) {
      ++nMod;
      int n0 = k, xmin, xmax, n;
      U32 m = t->mod;
      if (t->dx > 0) {
        xmin = t->dx;
        if (!(xmin < end.max)) die("assert failed: xmin < end max");
        while (k < aMax && t->mod == m) { ++k; ++t; }
        n = k - n0;
        xmax = (t - 1)->dx;
        if (n < v->depth[m] && n * 2 < end.rd(xmin)) {
          ++nMod2;
          if (RUN > 3) ++v->miBadLD[m];
        }
        if (n == v->depth[m] || n >= 0.8 * end.rd(xmin)) ++nGood;
        if (n == 1 && end.rd(xmin) >= 10) ++v->miBadLD[i];
        fprintf(zFile,
                "i %d depth %d m %d depth %d + count %d min %d at %d max %d "
                "at %d\n",
                (int)i, (int)v->depth[i], (int)m, (int)v->depth[m], n,
                end.rd(xmin), xmin, end.rd(xmax), xmax);
      } else {
        xmax = -t->dx;
        while (k < aMax && t->mod == m) { ++k; ++t; }
        n = k - n0;
        xmin = -(t - 1)->dx;
        if (xmin < 0) {  // shouldn't happen - repeat?
          ++nSplit;
          ++v->miSplitLD[m];
          xmin = xmax;
        }
        if (!(xmin < start.max)) die("assert failed: xmin < start max");
        if (xmin < 0) { n = 0; xmin = 0; }
        if (n < v->depth[m] && n * 2 < start.rd(xmin)) {
          ++nMod2;
          if (RUN > 3) ++v->miBadLD[m];
        } else if (n == 1 && start.rd(xmin) >= 10)
          ++v->miBadLD[m];
        if (n == v->depth[m] || n >= 0.8 * start.rd(xmin)) ++nGood;
        fprintf(zFile,
                "i %d depth %d m %d depth %d - count %d min %d at %d max %d "
                "at %d\n",
                (int)i, (int)v->depth[i], (int)m, (int)v->depth[m], n,
                start.rd(xmin), xmin, start.rd(xmax), xmax);
      }
    }
    v->miGood[i] = nGood;
    v->miMod2[i] = nMod2;
    v->miSplit[i] = nSplit;
  }

  int nZero1 = 0, nZero2 = 0, nZero3 = 0;
  for (I64 i = 0; i < v->msMax + 1; ++i) {
    if (v->miGood[i] || v->miMod2[i])
      fprintf(yFile, "TEST %d depth %d nGood %d nMod2 %d nBadLD %d nSplit %d\n",
              (int)i, (int)v->depth[i], v->miGood[i], v->miMod2[i],
              v->miBadLD[i], v->miSplit[i]);
    if (v->miGood[i] < v->miMod2[i]) { msSetCopy0(v, (U32)i); ++nZero1; }
    if (v->miSplit[i] > 10) { msSetCopy0(v, (U32)i); ++nZero2; }
    if (RUN == 2 || RUN == 6) {
      if (v->miBadLD[i] > 20 || v->miSplitLD[i] > 10) {
        fprintf(yFile, "BADLD %d depth %d nBadLD %d nSplitLD %d\n", (int)i,
                (int)v->depth[i], v->miBadLD[i], v->miSplitLD[i]);
        msSetCopy0(v, (U32)i);
        ++nZero3;
      }
    }
    if (RUN == 3 || RUN == 7) {
      if (v->miMod2[i] > 25) { msSetCopy0(v, (U32)i); ++nZero1; }
      if (v->miSplit[i]) { msSetCopy0(v, (U32)i); ++nZero2; }
      if (v->miBadLD[i] > 10) {
        fprintf(yFile, "BADLD %d depth %d nBadLD %d nSplitLD %d\n", (int)i,
                (int)v->depth[i], v->miBadLD[i], v->miSplitLD[i]);
        msSetCopy0(v, (U32)i);
        ++nZero3;
      }
    }
    if (RUN == 4 || RUN == 8) {
      // NB dangling-brace in the reference (modasm.c:732-738): the BADLD
      // block is unconditional; the nSplit test only gates nZero2
      if (v->miBadLD[i] > 6)
        if (v->miSplit[i]) { msSetCopy0(v, (U32)i); ++nZero2; }
      {
        fprintf(yFile, "BADLD %d depth %d nBadLD %d nSplitLD %d\n", (int)i,
                (int)v->depth[i], v->miBadLD[i], v->miSplitLD[i]);
        msSetCopy0(v, (U32)i);
        ++nZero3;
      }
    }
  }
  fprintf(s.so, "RUN %d tested %d mods and zeroed %d bad>good %d split %d LD\n",
          RUN, nTested, nZero1, nZero2, nZero3);
  rs_inv_build(v);
  fclose(yFile);
  fclose(zFile);
  sinksClose(s);
}

// ------------------------------------------------------------------
// refFlag (modasm.c:752-860): the sequence scan runs in Python;
// this applies the found (index, pos) stream and the per-read passes
// ------------------------------------------------------------------

extern "C" void rs_ref_flag(RSView *v, const U32 *idx, const int32_t *pos,
                            I64 nFound) {
  Sinks s = sinksOpen(v);
  std::vector<int> rCount((size_t)v->msMax + 1, 0);

  for (I64 t = 0; t < nFound; ++t) {
    U32 ind = idx[t];
    v->info[ind] |= MS_RDNA;
    v->miFlags[ind] |= MI_REF;
    v->miPos[ind] = pos[t];
    if (v->depth[ind] > 4750) v->miFlags[ind] |= MI_MULTI;
    else if (v->depth[ind] > 2750) v->miFlags[ind] |= MI_CORE;
    else v->miFlags[ind] |= MI_VAR;
  }

  int nRDNAreads = 0;
  for (I64 i = 1; i < v->nReads; ++i) {
    const U32 *h = readHits(v, i);
    int nh = v->nHit[i];
    int n = 0, n200 = 0, m200 = 0;
    for (int j = 0; j < nh; ++j) {
      U8 f = v->miFlags[h[j] & TOPMASK];
      if ((f & MI_CORE) && (f & MI_REF)) {
        ++n;
        if (n == 200) { n200 = j; break; }
      }
    }
    if (n200) {
      n = 0;
      for (int j = nh; --j;) {
        U8 f = v->miFlags[h[j] & TOPMASK];
        if ((f & MI_CORE) && (f & MI_REF)) {
          ++n;
          if (n == 200) { m200 = j; break; }
        }
      }
    }
    if (m200 > n200) {
      int lastPos = 0;
      for (int j = n200; j < m200; ++j) {
        U32 hh = h[j] & TOPMASK;
        if (v->info[hh] & MS_RDNA) {
          int p = v->miPos[hh];
          if (v->miFlags[hh] & MI_REF) lastPos = p;
          else if (p > 0 && p < lastPos + 50 && p > lastPos - 50) {
            v->miPos[hh] = (rCount[hh] * p + lastPos) / (rCount[hh] + 1);
            ++rCount[hh];
          } else
            v->miPos[hh] = -1;
        } else {
          v->info[hh] |= MS_RDNA;
          if (v->depth[hh] > 4750) v->miFlags[hh] |= MI_MULTI;
          else if (v->depth[hh] > 2750) v->miFlags[hh] |= MI_CORE;
          else v->miFlags[hh] |= MI_VAR;
          v->miPos[hh] = lastPos;
          rCount[hh] = 1;
        }
      }
      v->oflags[i] |= 1;  // r->isRDNA
      ++nRDNAreads;
    }
  }

  int nRDNA = 0, nRef = 0, nGoodPos = 0;
  int nRefC = 0, nRefV0 = 0, nRefV1 = 0, nRefM = 0;
  int nOthC = 0, nOthV0 = 0, nOthV1 = 0, nOthM = 0;
  for (I64 i = 0; i < v->msMax + 1; ++i) {
    if (!v->miFlags[i]) continue;  // mi->isRDNA: union of the four bits
    ++nRDNA;
    if (v->miFlags[i] & MI_REF) {
      ++nRef;
      if (v->miFlags[i] & MI_CORE) ++nRefC;
      else if (v->miFlags[i] & MI_MULTI) ++nRefM;
      else if (msIsCopy0(v, (U32)i)) ++nRefV0;
      else ++nRefV1;
    } else {
      if (v->miFlags[i] & MI_CORE) ++nOthC;
      else if (v->miFlags[i] & MI_MULTI) ++nOthM;
      else if (msIsCopy0(v, (U32)i)) ++nOthV0;
      else ++nOthV1;
      if (v->miPos[i] > 0) ++nGoodPos;
    }
  }
  fprintf(s.so, "total nRDNAreads %d other reads %d\n", nRDNAreads,
          (int)(v->nReads - 1 - nRDNAreads));
  fprintf(s.so, "total nRDNAmods %d nRDNAref %d other mods %d\n", nRDNA, nRef,
          (int)(v->msMax + 1 - nRDNA));
  fprintf(s.so, "  nRefC %d nRefM %d nRefVcopy>0 %d nRefVcopy0 %d\n", nRefC,
          nRefM, nRefV1, nRefV0);
  fprintf(s.so, "  nOthC %d nOthM %d nOthVcopy>0 %d nOthVcopy0 %d", nOthC,
          nOthM, nOthV1, nOthV0);
  fprintf(s.so, " nGoodPos %d\n", nGoodPos);
  sinksClose(s);
}

// ------------------------------------------------------------------
// resetBits (modasm.c:864-908)
// ------------------------------------------------------------------

extern "C" void rs_reset_bits(RSView *v, int op) {
  Sinks s = sinksOpen(v);
  int n = 0;
  switch (op) {
  case 1:
    fprintf(s.so, "resetting rDNA core kmers to copy1, rest to copy0:");
    for (I64 i = 0; i < v->msMax + 1; ++i)
      if (v->miFlags[i] & MI_CORE) { msSetCopy1(v, (U32)i); ++n; }
      else msSetCopy0(v, (U32)i);
    fprintf(s.so, " %d kept\n", n);
    break;
  case 2:
    fprintf(s.so,
            "resetting non-repetitive rDNA core kmers to copy1, rest to "
            "copy0:");
    for (I64 i = 0; i < v->msMax + 1; ++i)
      if ((v->miFlags[i] & MI_CORE) && !(v->info[i] & MS_REPEAT)) {
        msSetCopy1(v, (U32)i);
        ++n;
      } else
        msSetCopy0(v, (U32)i);
    fprintf(s.so, " %d kept\n", n);
    break;
  case 3: {
    fprintf(s.so, "resetting rDNA core kmers not repeated in read 1 to "
                  "copy1: ");
    for (I64 i = 0; i < v->msMax + 1; ++i)
      if (v->miFlags[i] & MI_CORE) { msSetCopy1(v, (U32)i); ++n; }
      else msSetCopy0(v, (U32)i);
    std::vector<U8> z((size_t)v->msMax + 1, 0);
    const U32 *h1 = readHits(v, 1);
    int nh1 = v->nReads > 1 ? v->nHit[1] : 0;
    for (int i = 0; i < nh1; ++i) {
      U32 hh = h1[i] & TOPMASK;
      if (!msIsCopy1(v, hh)) continue;
      if (z[hh]) { msSetCopy0(v, hh); --n; }
      else z[hh] = 1;
    }
    fprintf(s.so, " %d kept\n", n);
    break;
  }
  }
  rs_inv_build(v);
  sinksClose(s);
}

// ------------------------------------------------------------------
// readProperties (modasm.c:912-952) — sparse per-read maps; output
// iterates mods in ascending id order exactly like the dense loops
// ------------------------------------------------------------------

extern "C" void rs_read_properties(RSView *v) {
  Sinks s = sinksOpen(v);
  std::vector<std::pair<U32, U32>> fr;  // (mod, isF)
  for (I64 i = 1; i < v->nReads; ++i) {
    const U32 *h = readHits(v, i);
    int nh = v->nHit[i];
    fr.clear();
    for (int j = 0; j < nh; ++j) {
      U32 hh = h[j] & TOPMASK;
      if (!msIsCopy1(v, hh)) continue;
      fr.push_back({hh, (h[j] & TOPBIT) ? 1u : 0u});
    }
    std::sort(fr.begin(), fr.end());
    int n = 0, n2Rev = 0, n2Tan = 0, nMoreTan = 0, nMoreRev = 0;
    std::vector<std::pair<U32, int>> big;  // (mod, f+r) with f+r > 2
    for (size_t a = 0; a < fr.size();) {
      size_t b = a;
      int f = 0, r = 0;
      U32 hh = fr[a].first;
      while (b < fr.size() && fr[b].first == hh) {
        if (fr[b].second) ++f;
        else ++r;
        ++b;
      }
      ++n;
      if (f + r > 2) big.push_back({hh, f + r});
      if (f + r == 1) { a = b; continue; }
      if (f == 1 && r == 1) ++n2Rev;
      else if ((f == 2 && r == 0) || (f == 0 && r == 2)) ++n2Tan;
      else if (f > 0 && r > 0) ++nMoreRev;
      else {
        ++nMoreTan;
        fprintf(s.so, "MT i %d h %d count %d\n", (int)i, (int)hh, f + r);
      }
      a = b;
    }
    fprintf(s.so, "READ %d n %d n2Tan %d n2Rev %d nMoreTan %d nMoreRev %d\n",
            (int)i, n, n2Tan, n2Rev, nMoreTan, nMoreRev);
    if (nMoreTan > 5) {
      fprintf(s.so, "RM %d nMoreTan %d", (int)i, nMoreTan);
      for (auto &p : big) fprintf(s.so, " %d", (int)p.first);
      fputc('\n', s.so);
    }
  }
  sinksClose(s);
}

// ------------------------------------------------------------------
// printOverlap (modasm.c:420-459) — the -o3 report
// ------------------------------------------------------------------

extern "C" void rs_print_overlap(RSView *v, I64 ix, I64 iy) {
  Sinks s = sinksOpen(v);
  const int *ncx = readNCopy(v, ix), *ncy = readNCopy(v, iy);
  fprintf(s.out, "RR overlaps_for %u\tlen %d\tnHit %d\tnMiss %d\tnCopy %d %d "
                 "%d %d\n",
          (U32)ix, v->rlen[ix], v->nHit[ix], v->nMiss[ix], ncx[0], ncx[1],
          ncx[2], ncx[3]);
  fprintf(s.out, "RR overlaps_for %u\tlen %d\tnHit %d\tnMiss %d\tnCopy %d %d "
                 "%d %d\n",
          (U32)iy, v->rlen[iy], v->nHit[iy], v->nMiss[iy], ncy[0], ncy[1],
          ncy[2], ncy[3]);
  const U32 *hx = readHits(v, ix), *hy = readHits(v, iy);
  const U16 *dxx = readDx(v, ix), *dxy = readDx(v, iy);
  int xPos = 0, xLast = -1, yLast = -1;
  for (int j = 0; j < v->nHit[ix]; ++j) {
    U32 hxx = hx[j] & TOPMASK;
    xPos += dxx[j];
    if (!msIsCopy1(v, hxx)) continue;
    int yPos = 0;
    for (int k = 0; k < v->nHit[iy]; ++k) {
      U32 hyy = hy[k] & TOPMASK;
      yPos += dxy[k];
      if (hxx != hyy) continue;
      bool isSame = ((hx[j] & TOPBIT) == (hy[k] & TOPBIT));
      fprintf(s.out, "RO\t%8x %5d %c\t", hxx, (int)v->depth[hxx],
              isSame ? '+' : '-');
      fprintf(s.out, "%u %u %c\t", (U32)ix, xPos,
              (hx[j] & TOPBIT) ? 'F' : 'R');
      fprintf(s.out, "%u %u %c", (U32)iy, yPos, (hy[k] & TOPBIT) ? 'F' : 'R');
      if (xLast >= 0) {
        // int multiply then widen, as the reference does (modasm.c:449)
        I64 dirn = (I64)(int)((unsigned)(xPos - xLast) * (unsigned)(yPos - yLast));
        if ((isSame && dirn < 0) || (!isSame && dirn > 0))
          fprintf(s.so, "\tX xLast %d yLast %d yLen %d", xLast, yLast,
                  v->rlen[iy]);
      }
      xLast = xPos;
      yLast = yPos;
      fputc('\n', s.out);
    }
  }
  sinksClose(s);
}

// ------------------------------------------------------------------
// greedy assembly from a seed mod (modasm.c:956-1255)
// ------------------------------------------------------------------

struct Link {
  U32 from, to;  // hits (TOPBIT = forward); to == 0 marks end of read
  U32 i, x;      // read index, position of `to` in it
};

extern "C" int linkCmp(const void *a, const void *b) {
  const Link *la = (const Link *)a, *lb = (const Link *)b;
  if (la->from < lb->from) return -1;
  if (la->from > lb->from) return 1;
  if (la->to < lb->to) return -1;
  if (la->to > lb->to) return 1;
  if (la->i < lb->i) return -1;
  if (la->i > lb->i) return 1;
  if (la->x < lb->x) return -1;
  if (la->x > lb->x) return 1;
  die("problem in compareLink");  // total order expected (modasm.c:973)
  return 0;
}

extern "C" int intCmp(const void *a, const void *b) {
  return *(const int *)a - *(const int *)b;
}

static char s_modTextBuf[64];
static const char *modText(const RSView *v, U32 h, bool isReverse) {
  int m = (int)(h & TOPMASK);
  bool rev = isReverse;
  if (!(h & TOPBIT)) rev = !rev;
  // 'P' for reference-rDNA positions, 'p' for inferred ones (modasm.c:983-988)
  snprintf(s_modTextBuf, sizeof s_modTextBuf, "%d %c d %d C%d %c %d", m,
           rev ? 'R' : 'F', (int)v->depth[m], msCopy(v, (U32)m),
           (v->miFlags[m] & MI_REF) ? 'P' : 'p', v->miPos[m]);
  return s_modTextBuf;
}

struct ALayout {
  int read;
  int start, end;
  int nHit;
};

extern "C" int layoutCmp(const void *a, const void *b) {
  return ((const ALayout *)a)->start - ((const ALayout *)b)->start;
}

struct Active {
  int iRead, iLayout;
  int x, dx;
};

static void assembleFrom(RSView *v, std::vector<Link> &links, U32 from,
                         int offset, bool isReverse,
                         const std::vector<int> &iForward,
                         const std::vector<int> &iReverse, int isVerbose,
                         FILE *so) {
  std::vector<ALayout> layout;
  std::vector<Active> active;
  IHash hActive;
  hCreate(hActive, 4096);
  // dd keeps its physical buffer across iterations so reads past the
  // logical count return the reference's stale values
  std::vector<int> dd;
  int ddMax = 0;
  int staleI = 0;  // the reference prints a stale loop variable (modasm.c:1147)

  auto lStart = [&](U32 h) -> Link * {
    return links.data() +
           ((h & TOPBIT) ? iForward[h & TOPMASK] : iReverse[h]);
  };
  auto addActive = [&](int i, int x) {
    int n;
    hAdd(hActive, keyInt((U32)i), &n);
    if ((size_t)n >= active.size()) active.resize(n + 1, Active{0, 0, 0, 0});
    Active &a = active[n];
    a.iRead = i;
    a.iLayout = (int)layout.size();
    a.x = x;
    fprintf(so, "  added %d x %d\n", i, x);
    layout.push_back(ALayout{i, offset - x, 0, 0});
  };

  hashStats(so);
  IHash hash;
  hCreate(hash, 64);
  int ia;
  for (Link *l = lStart(from); l->from == from; ++l)
    if (l->to)  // almost always
      hAdd(hash, keyInt(l->to), &ia);
    else {  // look for `from` in the read
      I64 r = l->i;
      const U32 *h = readHits(v, r);
      const U16 *dxr = readDx(v, r);
      int x = 0;
      for (int i = 0; i < v->nHit[r]; ++i) {
        x += dxr[i];
        if ((h[i] & TOPMASK) == (from & TOPMASK)) {
          if ((h[i] & TOPBIT) != (from & TOPBIT)) x = v->rlen[r] - x;
          addActive((int)l->i, x);
          staleI = i;
          break;
        }
      }
    }
  hashStats(so);
  hash.iter = -1;
  long hk;
  while (hNext(hash, &hk, 0)) {  // mods that follow `from`
    U32 to = (U32)(hk ^ 0x7fffffffL) ^ TOPBIT;  // HASH_INT is self-inverse
    for (Link *l = lStart(to); l->from == to; ++l)
      if (l->to == (from ^ TOPBIT))
        addActive((int)l->i, v->rlen[l->i] - (int)l->x);
  }
  hDestroyCount();

  while (true) {  // move the assembly along by one mod per iteration
    U32 bestTo = 0, lastTo = 0;
    int dBest = 0, nBest = 0;
    bool isBestUniform = false;
    int d, dMin = 0, dSum = 0, nLast = 0, iLast = -1;

    fprintf(so, "FROM %s pos %d active %d", modText(v, from, isReverse),
            offset, hCount(hActive));

    hActive.iter = -1;
    while (hNext(hActive, &hk, &ia)) active[ia].dx = 0;

    for (Link *l = lStart(from); l->from == from; ++l)
      if (hFind(hActive, keyInt(l->i), &ia)) {  // only active reads
        Active *a = &active[ia];
        d = (int)(l->x - (U32)a->x);
        if (isVerbose) {
          fprintf(so, "\n  TO %s i %d x %d dx %d", modText(v, l->to, isReverse),
                  (int)l->i, (int)l->x, d);
          if (l->to == 0) fprintf(so, " end %d", (int)l->i);
        }
        if (l->to != lastTo) {
          if (lastTo && 2 * nLast > hCount(hActive) &&
              (!dBest || dMin < dBest)) {
            dBest = dMin;
            bestTo = lastTo;
            nBest = nLast;
            isBestUniform = (dSum == nBest * dBest);
          }
          lastTo = l->to;
          nLast = 0;
          iLast = -1;
          dMin = 0;
          dSum = 0;
        }
        if (d > 0 && (int)l->i != iLast) {
          ++nLast;
          iLast = (int)l->i;
          dSum += d;
          if (dMin == 0 || d < dMin) dMin = d;
          a->dx = d;
          ALayout *y = &layout[a->iLayout];
          ++y->nHit;
          fprintf(so, " hit %d", y->nHit);
          y->end = offset - (int)l->x;  // read length added at the end
        }
      }
    if (lastTo && 2 * nLast > hCount(hActive) && (!dBest || dMin < dBest)) {
      dBest = dMin;
      bestTo = lastTo;
      nBest = nLast;
      isBestUniform = (dSum == nBest * dBest);
    }
    if (isVerbose) fputc('\n', so);

    if (!nBest) break;  // insufficient support

    if (isBestUniform) {  // all deltas agree
      hActive.iter = -1;
      while (hNext(hActive, &hk, &ia)) {
        Active *a = &active[ia];
        a->x += dBest;
        if (a->x > v->rlen[a->iRead]) {
          hRemove(hActive, hk);
          fprintf(so, "\nEND %d pos %d end %d\n", a->iRead, offset,
                  v->rlen[a->iRead] + layout[a->iLayout].end);
        }
      }
    } else {  // set dBest to the median dx
      ddMax = 0;
      hActive.iter = -1;
      while (hNext(hActive, &hk, &ia)) {
        Active *a = &active[ia];
        if (a->dx) {
          if ((size_t)ddMax >= dd.size()) dd.resize(ddMax + 1);
          dd[ddMax++] = a->dx;
        }
      }
      std::stable_sort(dd.begin(), dd.begin() + ddMax,
                       [](int a, int b) { return a < b; });
      dBest = (nBest / 2 < (int)dd.size()) ? dd[nBest / 2] : 0;

      hActive.iter = -1;
      while (hNext(hActive, &hk, &ia)) {
        Active *a = &active[ia];
        if (!a->dx || a->dx == dBest)
          a->x += dBest;
        else if (a->dx > dBest - 10 && a->dx < dBest + 10) {
          fprintf(so, " dx %d %d", staleI, a->dx - dBest);
          a->x += a->dx;
        } else {
          fprintf(so, " xx %d %d", staleI, a->dx - dBest);
          a->x += a->dx;
          --nBest;
        }
        if (a->x > v->rlen[a->iRead]) {
          hRemove(hActive, hk);
          fprintf(so, "\nEND %d pos %d end %d\n", a->iRead, offset,
                  v->rlen[a->iRead] + layout[a->iLayout].end);
        }
      }
    }
    if (msIsCopy1(v, bestTo & TOPMASK)) {  // recruit new reads at copy1 mods
      Link *l = lStart(from);
      while (l->to < bestTo) ++l;
      for (iLast = -1; l->from == from && l->to == bestTo; ++l)
        if (!hFind(hActive, keyInt(l->i), 0)) addActive((int)l->i, (int)l->x);
    }

    fprintf(so, " BEST %s nBest %d dBest %d", modText(v, bestTo, isReverse),
            nBest, dBest);
    fputc('\n', so);
    from = bestTo;
    if (isReverse) offset -= dBest;
    else offset += dBest;
  }
  fprintf(so, "\nDONE\n");

  std::stable_sort(layout.begin(), layout.end(),
                   [](const ALayout &a, const ALayout &b) {
                     return layoutCmp(&a, &b) < 0;
                   });
  for (size_t i = 0; i < layout.size(); ++i) {
    ALayout *y = &layout[i];
    y->end += v->rlen[y->read];
    fprintf(so, "LAYOUT %d start %d end %d n %d / %d\n", y->read, y->start,
            y->end, y->nHit, v->nHit[y->read]);
  }
  hDestroyCount();  // hActive
}

extern "C" void rs_assemble_from_mod(RSView *v, U32 seed, int offset,
                                     int isVerbose) {
  Sinks s = sinksOpen(v);
  if (!v->miFlags) die("modasm -a2 needs -R first (reference dereferences "
                       "null modInfo)");
  fprintf(s.so, "assembling mod %d depth %d\n", seed, (int)v->depth[seed]);
  fflush(s.so);
  if (!msIsCopy1(v, seed)) die("seed copy number %d != 1", msCopy(v, seed));

  int dep = v->depth[seed] < U16MAXV ? v->depth[seed] : 0;
  const U32 *seedReads = v->invReads + v->invOff[seed];

  std::vector<Link> links;
  for (int i = 0; i < dep; ++i) {
    U32 ir = seedReads[i];
    const U32 *h = readHits(v, ir);
    const U16 *dxr = readDx(v, ir);
    int nh = v->nHit[ir];
    int len = v->rlen[ir];
    int x = 0, xLast = 0;
    U32 last = 0;
    int j = 0;
    for (; j < nh; ++j) {
      x += dxr[j];
      if (!msIsCopy0(v, h[j] & TOPMASK)) {
        links.push_back(Link{h[j] ^ TOPBIT, 0, ir, (U32)len});
        last = h[j];
        xLast = x;
        break;
      }
    }
    for (++j; j < nh; ++j) {
      x += dxr[j];
      if (!msIsCopy0(v, h[j] & TOPMASK)) {
        links.push_back(Link{last, h[j], ir, (U32)x});
        links.push_back(Link{h[j] ^ TOPBIT, last ^ TOPBIT, ir,
                             (U32)(len - xLast)});
        last = h[j];
        xLast = x;
      }
    }
    if (last) links.push_back(Link{last, 0, ir, (U32)len});
  }
  std::stable_sort(links.begin(), links.end(),
                   [](const Link &a, const Link &b) {
                     return linkCmp(&a, &b) < 0;
                   });

  std::vector<int> iForward((size_t)v->msMax + 1, 0),
      iReverse((size_t)v->msMax + 1, 0);
  U32 last = 0;
  for (size_t i = 0; i < links.size(); ++i)
    if (links[i].from != last) {
      if (links[i].from & TOPBIT) iForward[links[i].from & TOPMASK] = (int)i;
      else iReverse[links[i].from] = (int)i;
      last = links[i].from;
    }
  links.push_back(Link{0xFFFFFFFFu, 0, 0, 0});  // loop terminator

  // build forwards from the seed (the reverse pass is commented out in the
  // reference, modasm.c:1251)
  assembleFrom(v, links, seed | TOPBIT, offset, false, iForward, iReverse,
               isVerbose, s.so);
  sinksClose(s);
}

// ------------------------------------------------------------------
// assembleFromRead (modasm.c:1403-1482) — incomplete in the reference
// (minus-orientation branch empty); reproduced as-is
// ------------------------------------------------------------------

extern "C" void rs_assemble_from_read(RSView *v, I64 ix) {
  Sinks s = sinksOpen(v);
  struct AHit {
    U32 hit;
    U32 count;
    int pos;
    int upCount;
  };
  std::vector<AHit> aHits;
  IHash hitHash;
  hCreate(hitHash, 1024);
  std::vector<Olap> overlaps;
  findOverlaps(v, ix, 1, s.out, overlaps);
  if (!s.same) fflush(s.out);
  for (size_t io = 0; io < overlaps.size(); ++io) {
    Olap *o = &overlaps[io];
    if (!o->isPlus) continue;  // minus branch is empty in the reference
    I64 iy = o->iy;
    const U32 *hy = readHits(v, iy);
    int nh = v->nHit[iy];
    for (int j = 0; j < nh; ++j) {
      U32 hit = hy[j] & TOPMASK;
      int ih;
      hAdd(hitHash, keyInt(hit), &ih);
      if ((size_t)ih >= aHits.size()) aHits.resize(ih + 1, AHit{0, 0, 0, 0});
      AHit &ah = aHits[ih];
      if (!ah.count) ah.hit = hit;
      ++ah.count;
      if (j) ++ah.upCount;
    }
  }

  double totCount = 0.;
  int countA[20][20], countB[20][20];
  for (int i = 20; i--;)
    for (int j = 20; j--;) { countA[i][j] = 0; countB[i][j] = 0; }
  int hc = hCount(hitHash);
  for (int ih = 0; ih < hc; ++ih) {
    AHit &ah = aHits[ih];
    ah.pos /= (int)ah.count;
    totCount += ah.count;
    if (!msIsCopy1(v, ah.hit)) continue;
    int i = (int)ah.count;
    if (i > 19) i = 19;
    int j = v->depth[ah.hit];
    if (j > 19) j = 19;
    ++countA[i][j];
    j = (int)(10 * ah.count - 1) / v->depth[ah.hit];
    if (j >= 0 && j < 20) ++countB[i][j];  // reference writes OOB if j > 19
  }
  totCount /= hc;  // -nan when empty, as the reference prints
  fprintf(s.so, "AR  %d total hits - mean count %.1f\n", hc, totCount);
  for (int i = 0; i < 20; ++i) {
    fprintf(s.so, "AH  %2d\t", i);
    for (int j = 0; j < 20; ++j)
      if (j < i) fprintf(s.so, "    ");
      else fprintf(s.so, "%4d", countA[i][j]);
    fprintf(s.so, "    ");
    for (int j = 0; j < 10; ++j) fprintf(s.so, "%4d", countB[i][j]);
    fprintf(s.so, "\n");
  }
  hDestroyCount();
  sinksClose(s);
}

// ------------------------------------------------------------------
// modmap query chaining (queryProcess, modmap.c:183-280): the greedy
// colinear block automaton + Q/M/verbose line emission.  Seeding runs on
// the device; this walks the per-read seed lists at C speed.
// ------------------------------------------------------------------

extern "C" void mm_query_emit(
    const I64 *seedOff, const U32 *sidx, const I64 *spos, const U8 *info,
    const U32 *rev, const U32 *loc, const U32 *offs, const U32 *ids,
    I64 revLen, const char *namesBlob, const I64 *nameOff,
    const char *qidsBlob, const I64 *qidOff, const I64 *qlen, I64 nReads,
    int isVerbose, int fdOut, int fdStdout) {
  bool same = (fdOut == fdStdout) || fdOut < 0;
  FILE *so = fdopen(dup(fdStdout), "w");
  FILE *fo = same ? so : fdopen(dup(fdOut), "w");
  if (!so || !fo) die("modmap native: cannot open output stream");

  for (I64 r = 0; r < nReads; ++r) {
    I64 a = seedOff[r], b = seedOff[r + 1];
    I64 nSeeds = b - a;
    int missed = 0, copy1 = 0, copy2 = 0, copyM = 0;
    for (I64 t = a; t < b; ++t) {
      U32 ix = sidx[t];
      if (!ix) { ++missed; continue; }
      switch (info[ix] & 3) {
      case 1: ++copy1; break;
      case 2: ++copy2; break;
      case 3: ++copyM; break;
      default: break;
      }
    }
    const char *qid = qidsBlob + qidOff[r];
    fprintf(fo, "Q\t%s\t%llu\t%d miss, %d copy1, %d copy2, %d multi, %.2f "
                "hit\n",
            qid, (unsigned long long)qlen[r], missed, copy1, copy2, copyM,
            (nSeeds - missed) / (double)nSeeds);

    U32 loc0 = 0, locN = 0;
    I64 i0 = 0, iN = 0;
    int n1 = 0, n2 = 0;

    auto emitM = [&]() {
      double denom = (locN > loc0) ? (double)(locN - loc0)
                                   : (double)(loc0 - locN);
      fprintf(fo, "M\t%s\t%d\t%d\t%d\t%s\t%d\t%d\t%d %d\t%.2f\t%.2f\n", qid,
              (int)spos[a + i0], (int)spos[a + iN],
              (int)(spos[a + iN] - spos[a + i0]),
              namesBlob + nameOff[ids[loc0]], (int)offs[loc0],
              (int)offs[locN], n1, n2, (n1 + n2) / denom,
              n1 / (double)copy1);
    };
    auto blockTest = [&](U32 lv) -> bool {
      if (ids[lv] != ids[loc0]) return true;
      if (loc0 < locN) {
        if (lv < locN) return true;
        int d = (int)(locN - loc0 - (U32)(iN - i0));
        if (d > 50 || d < -50) return true;
      } else if (loc0 > locN) {
        if (lv > locN) return true;
        int d = (int)(loc0 - locN - (U32)(iN - i0));
        if (d > 50 || d < -50) return true;
      }
      return false;
    };

    for (I64 i = 0; i < nSeeds; ++i) {
      U32 ix = sidx[a + i];
      if (!ix || (info[ix] & 3) == 3) continue;  // missed or copyM
      I64 l1 = loc[ix] < revLen ? loc[ix] : revLen - 1;  // clamp (see .py)
      U32 lv = rev[l1];
      bool is1 = (info[ix] & 3) == 1;
      if (isVerbose) {
        if (is1)
          fprintf(so, "  %6d\t%s %d\n", (int)spos[a + i],
                  namesBlob + nameOff[ids[lv]], (int)offs[lv]);
        else {
          I64 l2 = loc[ix] + 1 < revLen ? loc[ix] + 1 : revLen - 1;
          U32 lv2 = rev[l2];
          fprintf(so, "  %6d\t%s %d\t%s %d\n", (int)spos[a + i],
                  namesBlob + nameOff[ids[lv]], (int)offs[lv],
                  namesBlob + nameOff[ids[lv2]], (int)offs[lv2]);
        }
      }
      bool endBlock = (!loc0) || blockTest(lv);
      if (endBlock && loc0 && !is1) {  // try the second occurrence
        I64 l2 = loc[ix] + 1 < revLen ? loc[ix] + 1 : revLen - 1;
        lv = rev[l2];
        endBlock = blockTest(lv);
      }
      if (endBlock) {
        if (n1 > 2) emitM();
        n1 = 0;
        n2 = 0;
        loc0 = lv;
        i0 = i;
      }
      if (is1) ++n1;
      else ++n2;
      locN = lv;
      iN = i;
    }
    if (n2 > 2)  // final-block flush quirk (modmap.c:269)
      emitM();
  }
  if (!same) fclose(fo);
  fclose(so);
}

// ------------------------------------------------------------------
// host modimizer scan (rolling canonical hash, seqhash.c:60-79,154-196):
// the path for inputs below the device threshold (ops/route.py).
// OpenMP over (k-1)-overlapped chunks; per-chunk counts then a prefix
// pass place emissions in exact stream order.
//
// The emission test `hash % w == 0` with a runtime w compiles to a
// 64-bit hardware divide (~30 cycles) per position — the dominant cost
// of the whole loop (measured 80 -> ~400 Mpos/s removing it).  w is
// loop-invariant, so we use the Lemire-Kaser divisibility test instead:
// for w = m * 2^t (m odd),  n % w == 0  <=>
//   ror64(n * inv(m), t) <= (2^64 - 1) / w
// which is one multiply, one rotate and one compare.  Bit-exact by
// construction (and regression-tested against % over random w).
// ------------------------------------------------------------------

static inline U64 ror64(U64 x, int r) {
  return r ? (x >> r) | (x << (64 - r)) : x;
}

static inline U64 mod_inv_odd64(U64 m) {
  U64 x = m;                       // correct to 3 bits for odd m
  for (int i = 0; i < 5; ++i) x *= 2 - m * x;  // Newton doubles per step
  return x;
}

struct DivisW {
  U64 inv, thresh;
  int t;
  explicit DivisW(U64 w)
      : inv(mod_inv_odd64(w >> __builtin_ctzll(w))),
        thresh(~(U64)0 / w),
        t(__builtin_ctzll(w)) {}
  inline bool divides(U64 n) const { return ror64(n * inv, t) <= thresh; }
};

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" I64 sh_scan_emit(const U8 *codes, I64 n, int k, U64 w, U64 factor1,
                            int shift1, U64 *out_k, I64 *out_p, U8 *out_f,
                            I64 cap) {
  if (n < k) return 0;
  I64 P = n - k + 1;
  const U64 mask = (k < 32) ? ((((U64)1) << (2 * k)) - 1) : ~(U64)0;
  const int rcShift = 2 * (k - 1);
  const DivisW dw(w);

  const I64 CHUNK = 1 << 22;
  I64 nChunks = (P + CHUNK - 1) / CHUNK;
  std::vector<I64> counts(nChunks, 0);
  std::vector<std::vector<U64>> ck(nChunks);
  std::vector<std::vector<I64>> cp(nChunks);
  std::vector<std::vector<U8>> cf(nChunks);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (I64 c = 0; c < nChunks; ++c) {
    I64 p0 = c * CHUNK;
    I64 p1 = p0 + CHUNK < P ? p0 + CHUNK : P;
    U64 h = 0, hrc = 0;
    for (int j = 0; j < k; ++j) {
      U64 b = codes[p0 + j];
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
    std::vector<U64> &vk = ck[c];
    std::vector<I64> &vp = cp[c];
    std::vector<U8> &vf = cf[c];
    for (I64 p = p0;;) {
      U64 hf = (h * factor1) >> shift1;
      U64 hr = (hrc * factor1) >> shift1;
      U64 hash = hf < hr ? hf : hr;
      if (dw.divides(hash)) {
        vk.push_back(hf < hr ? h : hrc);
        vp.push_back(p);
        vf.push_back(hf < hr ? 1 : 0);
      }
      if (++p >= p1) break;
      U64 b = codes[p + k - 1];
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
    counts[c] = (I64)vk.size();
  }

  I64 total = 0;
  for (I64 c = 0; c < nChunks; ++c) total += counts[c];
  if (total > cap) return -total;
  I64 off = 0;
  for (I64 c = 0; c < nChunks; ++c) {
    if (counts[c]) {
      memcpy(out_k + off, ck[c].data(), counts[c] * sizeof(U64));
      memcpy(out_p + off, cp[c].data(), counts[c] * sizeof(I64));
      memcpy(out_f + off, cf[c].data(), counts[c] * sizeof(U8));
      off += counts[c];
    }
  }
  return total;
}

// ------------------------------------------------------------------
// sequence-file parsing (seqio.c FASTA/FASTQ semantics): single-pass
// native parsers; this host's numpy is pathologically slow on the
// byte-level ops these need.
// ------------------------------------------------------------------

typedef int8_t I8;
typedef int16_t I16;

extern "C" I64 io_fasta_count(const U8 *d, I64 n) {
  I64 cnt = 0;
  for (I64 i = 0; i < n; ++i)
    if (d[i] == '>' && (i == 0 || d[i - 1] == '\n')) ++cnt;
  return cnt;
}

// codes: out I8[n]; offsets: out I64[nrec+1]; hdr: out I64[2*nrec]
// (start,end of header text, '>' excluded).  Returns total code count.
extern "C" I64 io_parse_fasta(const U8 *d, I64 n, const I16 *conv, I8 *codes,
                              I64 *offsets, I64 *hdr) {
  I64 nc = 0, rec = 0;
  offsets[0] = 0;
  I64 i = 0;
  while (i < n) {
    // record start: '>' at 0 or after newline (callers sniffed byte 0)
    if (!(d[i] == '>' && (i == 0 || d[i - 1] == '\n'))) { ++i; continue; }
    I64 start = i;
    I64 he = start;
    while (he < n && d[he] != '\n') ++he;
    if (he > n - 1) he = n - 1;  // numpy parser clamp, kept for parity
    hdr[2 * rec] = start + 1;
    hdr[2 * rec + 1] = he;
    I64 j = he + 1;
    while (j < n && !(d[j] == '>' && d[j - 1] == '\n')) {
      I16 c = conv[d[j]];
      if (c >= 0) codes[nc++] = (I8)c;
      ++j;
    }
    ++rec;
    offsets[rec] = nc;
    i = j;
  }
  return nc;
}

extern "C" I64 io_fastq_count(const U8 *d, I64 n) {
  I64 nlines = 0;
  for (I64 i = 0; i < n; ++i)
    if (d[i] == '\n') ++nlines;
  if (n && d[n - 1] != '\n') ++nlines;
  return nlines / 4;
}

// Returns total codes, or -1 on qual length mismatch.
extern "C" I64 io_parse_fastq(const U8 *d, I64 n, const I16 *conv,
                              int isQual, I8 *codes, I64 *offsets, I64 *hdr,
                              I8 *quals) {
  I64 nc = 0, rec = 0;
  offsets[0] = 0;
  I64 ls[4], le[4];
  I64 pos = 0;
  while (pos < n) {
    int li = 0;
    I64 p = pos;
    for (; li < 4 && p < n; ++li) {
      ls[li] = p;
      while (p < n && d[p] != '\n') ++p;
      le[li] = p;
      ++p;  // skip newline (virtual at EOF)
    }
    if (li < 4) break;
    pos = p;
    hdr[2 * rec] = ls[0] + 1;  // skip '@'
    hdr[2 * rec + 1] = le[0];
    I64 slen = le[1] - ls[1];
    if (conv)
      for (I64 t = ls[1]; t < le[1]; ++t) codes[nc++] = (I8)conv[d[t]];
    else {
      memcpy(codes + nc, d + ls[1], slen);
      nc += slen;
    }
    if (isQual) {
      if (le[3] - ls[3] != slen) return -1;
      for (I64 t = 0; t < slen; ++t)
        quals[offsets[rec] + t] = (I8)(d[ls[3] + t] - 33);
    }
    ++rec;
    offsets[rec] = nc;
  }
  return nc;
}

// Boundary-aware variant: emits only k-mers fully inside one read, in
// stream order, with global positions — subsumes the host-side validity
// filter.  OpenMP over reads (guided: read lengths vary).
// ------------------------------------------------------------------
// AVX-512 scan: 8 u64 lanes over 8 equal (k-1)-halo'd stream segments.
//
// The rolling state update is a serial dependency chain per sequence, so
// scalar ILP caps out ~8 cycles/position; eight independent segments in
// zmm lanes break the chain (measured ~4x on this host's vpmullq
// throughput probe).  The scan is boundary-OBLIVIOUS (kmers spanning
// read boundaries are emitted too — their h/hrc depend only on the last
// k bases, so within-read kmers are bit-identical to the per-read scan);
// a two-pointer pass against `offsets` then drops spanning emissions,
// reproducing sh_scan_emit_reads' output exactly (oracle-tested).
// Compiled only where the build host has AVX-512 (the .so is always
// compiled -march=native on the machine that runs it).
// ------------------------------------------------------------------
#if defined(__AVX512F__) && defined(__AVX512DQ__)
#include <immintrin.h>

// emissions over positions [0, P) of `codes` (P + k - 1 readable bytes),
// split as 8 lanes of L plus a scalar tail; per-lane regions of R entries
// inside the caller buffers, compacted to stream order before returning.
// Returns total emissions or -(2*cap) if any lane region overflows.
static I64 scan_simd_stream(const U8 *codes, I64 P, int k, U64 w, U64 f1,
                            int s1, U64 *out_k, I64 *out_p, U8 *out_f,
                            I64 cap, I64 pbase) {
  const U64 mask = (k < 32) ? ((((U64)1) << (2 * k)) - 1) : ~(U64)0;
  const int rcShift = 2 * (k - 1);
  const DivisW dw(w);
  const I64 L = P / 8;
  const I64 R = cap / 8;
  // vector steps: stop 8 early so the 8-byte lookahead loads stay inside
  const I64 Lv = (L - 8) < 0 ? 0 : ((L - 8) & ~(I64)7);

  U64 hs[8], hrcs[8];
  for (int j = 0; j < 8; ++j) {
    U64 h = 0, hrc = 0;
    const U8 *c = codes + j * L;
    for (int t = 0; t < k - 1; ++t) {
      U64 b = c[t];
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
    hs[j] = h;
    hrcs[j] = hrc;
  }
  __m512i vh = _mm512_loadu_si512(hs);
  __m512i vhrc = _mm512_loadu_si512(hrcs);
  const __m512i vmask = _mm512_set1_epi64((long long)mask);
  const __m512i vf1 = _mm512_set1_epi64((long long)f1);
  const __m512i v3 = _mm512_set1_epi64(3);
  const __m512i vbyte = _mm512_set1_epi64(0xFF);
  const __m512i vinv = _mm512_set1_epi64((long long)dw.inv);
  const __m512i vthresh = _mm512_set1_epi64((long long)dw.thresh);
  const __m512i vt = _mm512_set1_epi64(dw.t);
  const __m128i cs1 = _mm_cvtsi32_si128(s1);
  const __m128i crc = _mm_cvtsi32_si128(rcShift);
  // NOT vpgatherqq: this host microcodes gathers (its XLA target even
  // carries +prefer-no-gather); 8 scalar u64 loads assemble faster
  const U8 *lane[8];
  for (int j = 0; j < 8; ++j) lane[j] = codes + j * L + k - 1;

  I64 o[8];
  for (int j = 0; j < 8; ++j) o[j] = 0;
  // Hit handling is branch-FREE: a data-dependent `if (emit)` mispredicts
  // ~40% of steps at w=16 (~100 cycles/hit measured).  Every step does an
  // unconditional vpcompressstoreu of the canonical kmers and a packed
  // (lane | pos<<1 | isF) meta word into an L1-resident staging buffer —
  // only real hits cost store bytes — and each 1024-step block then
  // distributes staged hits to the per-lane regions (short, branch-light
  // scalar pass outside the vector pipeline).
  const I64 BLK = 1024;
  U64 skmer[BLK * 8 + 8];   // absolute worst case: every lane hits every
  U64 smeta[BLK * 8 + 8];   // step (w=1); 2x64KB, stack- and L2-friendly
  __m512i vmetab = _mm512_setr_epi64(0, 1, 2, 3, 4, 5, 6, 7);
  vmetab = _mm512_slli_epi64(vmetab, 60);
  {
    __m512i lpos = _mm512_setr_epi64(0, L, 2 * L, 3 * L, 4 * L, 5 * L,
                                     6 * L, 7 * L);
    vmetab = _mm512_or_si512(vmetab, _mm512_slli_epi64(lpos, 1));
  }
  for (I64 t0 = 0; t0 < Lv; t0 += BLK) {
    const I64 t1 = t0 + BLK < Lv ? t0 + BLK : Lv;
    I64 sc = 0;  // staging cursor
    for (I64 t = t0; t < t1; t += 8) {
      U64 w0, w1, w2, w3, w4, w5, w6, w7;
      memcpy(&w0, lane[0] + t, 8); memcpy(&w1, lane[1] + t, 8);
      memcpy(&w2, lane[2] + t, 8); memcpy(&w3, lane[3] + t, 8);
      memcpy(&w4, lane[4] + t, 8); memcpy(&w5, lane[5] + t, 8);
      memcpy(&w6, lane[6] + t, 8); memcpy(&w7, lane[7] + t, 8);
      __m512i words = _mm512_set_epi64(
          (long long)w7, (long long)w6, (long long)w5, (long long)w4,
          (long long)w3, (long long)w2, (long long)w1, (long long)w0);
      for (int jj = 0; jj < 8; ++jj) {
        __m512i b = _mm512_and_si512(words, vbyte);
        words = _mm512_srli_epi64(words, 8);
        vh = _mm512_or_si512(
            _mm512_and_si512(_mm512_slli_epi64(vh, 2), vmask), b);
        vhrc = _mm512_or_si512(
            _mm512_srli_epi64(vhrc, 2),
            _mm512_sll_epi64(_mm512_sub_epi64(v3, b), crc));
        __m512i hf = _mm512_srl_epi64(_mm512_mullo_epi64(vh, vf1), cs1);
        __m512i hr = _mm512_srl_epi64(_mm512_mullo_epi64(vhrc, vf1), cs1);
        __mmask8 isF = _mm512_cmplt_epu64_mask(hf, hr);
        __m512i hash = _mm512_min_epu64(hf, hr);
        __mmask8 em = _mm512_cmple_epu64_mask(
            _mm512_rorv_epi64(_mm512_mullo_epi64(hash, vinv), vt),
            vthresh);
        _mm512_mask_compressstoreu_epi64(
            skmer + sc, em, _mm512_mask_blend_epi64(isF, vhrc, vh));
        __m512i vmeta = _mm512_or_si512(
            _mm512_add_epi64(vmetab, _mm512_set1_epi64((t + jj) << 1)),
            _mm512_maskz_set1_epi64(isF, 1));
        _mm512_mask_compressstoreu_epi64(smeta + sc, em, vmeta);
        sc += _mm_popcnt_u32(em);
      }
    }
    for (int j = 0; j < 8; ++j)
      if (o[j] + sc > R) return -(2 * cap);
    for (I64 i = 0; i < sc; ++i) {
      const U64 meta = smeta[i];
      const int j = (int)(meta >> 60);
      const I64 oj = o[j];
      out_k[j * R + oj] = skmer[i];
      out_p[j * R + oj] = pbase + (I64)((meta >> 1) & (((U64)1 << 59) - 1));
      out_f[j * R + oj] = (U8)(meta & 1);
      o[j] = oj + 1;
    }
  }
  // scalar finish: per-lane remainder [Lv, L), then the global tail [8L, P)
  _mm512_storeu_si512(hs, vh);
  _mm512_storeu_si512(hrcs, vhrc);
  for (int j = 0; j < 8; ++j) {
    U64 h = hs[j], hrc = hrcs[j];
    for (I64 t = Lv; t < L; ++t) {
      U64 b = codes[j * L + t + k - 1];
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
      U64 hf = (h * f1) >> s1;
      U64 hr = (hrc * f1) >> s1;
      if (dw.divides(hf < hr ? hf : hr)) {
        if (o[j] >= R) return -(2 * cap);
        out_k[j * R + o[j]] = hf < hr ? h : hrc;
        out_p[j * R + o[j]] = pbase + j * L + t;
        out_f[j * R + o[j]] = hf < hr ? 1 : 0;
        ++o[j];
      }
    }
  }
  // compact lane regions to stream order (regions are already sorted)
  I64 total = 0;
  for (int j = 0; j < 8; ++j) {
    if (o[j] && j * R != total) {
      memmove(out_k + total, out_k + j * R, o[j] * sizeof(U64));
      memmove(out_p + total, out_p + j * R, o[j] * sizeof(I64));
      memmove(out_f + total, out_f + j * R, o[j] * sizeof(U8));
    }
    total += o[j];
  }
  // global tail positions [8L, P) scalar, appended in place
  if (8 * L < P) {
    U64 h = 0, hrc = 0;
    const U8 *c = codes + 8 * L;
    for (int t = 0; t < k - 1; ++t) {
      U64 b = c[t];
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
    for (I64 p = 8 * L; p < P; ++p) {
      U64 b = codes[p + k - 1];
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
      U64 hf = (h * f1) >> s1;
      U64 hr = (hrc * f1) >> s1;
      if (dw.divides(hf < hr ? hf : hr)) {
        if (total >= cap) return -(2 * cap);
        out_k[total] = hf < hr ? h : hrc;
        out_p[total] = pbase + p;
        out_f[total] = hf < hr ? 1 : 0;
        ++total;
      }
    }
  }
  return total;
}

// u32 variant for k <= 16: kmers and hashes fit 32 bits, so SIXTEEN
// lanes ride one zmm.  hash = ((kmer * f1) mod 2^64) >> (64-2k)
// = hi32 >> (32-2k) with hi32 = mulhi32(kmer, f1lo) + kmer*f1hi (mod
// 2^32) — exact since kmer < 2^32 and 64-2k >= 32.  Meta packs
// (lane:4 | pos:24 | isF:1) into a u32, so this path requires lane
// length L < 2^24 (the dispatcher falls back to the 8-lane u64 kernel
// for longer streams).
static I64 scan_simd_stream32(const U8 *codes, I64 P, int k, U64 w, U64 f1,
                              int s1, U64 *out_k, I64 *out_p, U8 *out_f,
                              I64 cap, I64 pbase) {
  const U32 mask = (U32)((((U64)1) << (2 * k)) - 1);
  const int rcShift = 2 * (k - 1);
  const int hShift = 32 - 2 * k;   // hash = hi32 >> hShift
  const DivisW dw(w);
  const U32 inv32 = (U32)dw.inv;   // inverse mod 2^32 = low half of mod-2^64
  const U32 thresh32 = (U32)(~(U32)0 / (U32)w);
  const I64 L = P / 16;
  const I64 R = cap / 16;
  const I64 Lv = (L - 8) < 0 ? 0 : ((L - 8) & ~(I64)3);

  U32 hs[16], hrcs[16];
  for (int j = 0; j < 16; ++j) {
    U32 h = 0, hrc = 0;
    const U8 *c = codes + j * L;
    for (int t = 0; t < k - 1; ++t) {
      U32 b = c[t];
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
    hs[j] = h;
    hrcs[j] = hrc;
  }
  __m512i vh = _mm512_loadu_si512(hs);
  __m512i vhrc = _mm512_loadu_si512(hrcs);
  const __m512i vmask = _mm512_set1_epi32((int)mask);
  const __m512i vf1lo = _mm512_set1_epi64((long long)(U32)f1);
  const __m512i vf1hi = _mm512_set1_epi32((int)(U32)(f1 >> 32));
  const __m512i v3 = _mm512_set1_epi32(3);
  const __m512i vbyte = _mm512_set1_epi32(0xFF);
  const __m512i vinv = _mm512_set1_epi32((int)inv32);
  const __m512i vthresh = _mm512_set1_epi32((int)thresh32);
  const __m512i vt32 = _mm512_set1_epi32(dw.t);
  const __m128i crc = _mm_cvtsi32_si128(rcShift);
  const __m128i chs = _mm_cvtsi32_si128(hShift);
  __m512i vlane = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                    12, 13, 14, 15);
  vlane = _mm512_slli_epi32(vlane, 25);

  const U8 *lane[16];
  for (int j = 0; j < 16; ++j) lane[j] = codes + j * L + k - 1;

  I64 o[16];
  for (int j = 0; j < 16; ++j) o[j] = 0;
  const I64 BLK = 1024;
  U32 skmer[BLK * 16 + 16];
  U32 smeta[BLK * 16 + 16];
  for (I64 t0 = 0; t0 < Lv; t0 += BLK) {
    const I64 t1 = t0 + BLK < Lv ? t0 + BLK : Lv;
    I64 sc = 0;
    for (I64 t = t0; t < t1; t += 4) {
      U32 wd[16];
      for (int j = 0; j < 16; ++j) memcpy(&wd[j], lane[j] + t, 4);
      __m512i words = _mm512_loadu_si512(wd);
      for (int jj = 0; jj < 4; ++jj) {
        __m512i b = _mm512_and_si512(words, vbyte);
        words = _mm512_srli_epi32(words, 8);
        vh = _mm512_or_si512(
            _mm512_and_si512(_mm512_slli_epi32(vh, 2), vmask), b);
        vhrc = _mm512_or_si512(
            _mm512_srli_epi32(vhrc, 2),
            _mm512_sll_epi32(_mm512_sub_epi32(v3, b), crc));
        // hi32 of (x * f1) mod 2^64 for 16 u32 lanes
#define HI32(x)                                                           \
  _mm512_add_epi32(                                                       \
      _mm512_mask_blend_epi32(                                            \
          (__mmask16)0xAAAA,                                              \
          _mm512_srli_epi64(_mm512_mul_epu32((x), vf1lo), 32),            \
          _mm512_mul_epu32(_mm512_srli_epi64((x), 32), vf1lo)),           \
      _mm512_mullo_epi32((x), vf1hi))
        __m512i hf = _mm512_srl_epi32(HI32(vh), chs);
        __m512i hr = _mm512_srl_epi32(HI32(vhrc), chs);
#undef HI32
        __mmask16 isF = _mm512_cmplt_epu32_mask(hf, hr);
        __m512i hash = _mm512_min_epu32(hf, hr);
        __mmask16 em = _mm512_cmple_epu32_mask(
            _mm512_rorv_epi32(_mm512_mullo_epi32(hash, vinv), vt32),
            vthresh);
        _mm512_mask_compressstoreu_epi32(
            skmer + sc, em, _mm512_mask_blend_epi32(isF, vhrc, vh));
        __m512i vmeta = _mm512_or_si512(
            _mm512_or_si512(vlane,
                            _mm512_set1_epi32((int)((t + jj) << 1))),
            _mm512_maskz_set1_epi32(isF, 1));
        _mm512_mask_compressstoreu_epi32(smeta + sc, em, vmeta);
        sc += _mm_popcnt_u32(em);
      }
    }
    for (int j = 0; j < 16; ++j)
      if (o[j] + sc > R) return -(2 * cap);
    for (I64 i = 0; i < sc; ++i) {
      const U32 meta = smeta[i];
      const int j = (int)(meta >> 25);
      const I64 oj = o[j];
      out_k[j * R + oj] = (U64)skmer[i];
      out_p[j * R + oj] = pbase + j * L + (I64)((meta >> 1) & 0xFFFFFF);
      out_f[j * R + oj] = (U8)(meta & 1);
      o[j] = oj + 1;
    }
  }
  // scalar finish per lane, then compact, then the global tail [16L, P)
  _mm512_storeu_si512(hs, vh);
  _mm512_storeu_si512(hrcs, vhrc);
  for (int j = 0; j < 16; ++j) {
    U64 h = hs[j], hrc = hrcs[j];
    const U64 mask64 = (((U64)1) << (2 * k)) - 1;
    for (I64 t = Lv; t < L; ++t) {
      U64 b = codes[j * L + t + k - 1];
      h = ((h << 2) & mask64) | b;
      hrc = ((hrc >> 2) | ((3 - b) << rcShift)) & mask64;
      U64 hf = (h * f1) >> s1;
      U64 hr = (hrc * f1) >> s1;
      if (dw.divides(hf < hr ? hf : hr)) {
        if (o[j] >= R) return -(2 * cap);
        out_k[j * R + o[j]] = hf < hr ? h : hrc;
        out_p[j * R + o[j]] = pbase + j * L + t;
        out_f[j * R + o[j]] = hf < hr ? 1 : 0;
        ++o[j];
      }
    }
  }
  I64 total = 0;
  for (int j = 0; j < 16; ++j) {
    if (o[j] && j * R != total) {
      memmove(out_k + total, out_k + j * R, o[j] * sizeof(U64));
      memmove(out_p + total, out_p + j * R, o[j] * sizeof(I64));
      memmove(out_f + total, out_f + j * R, o[j] * sizeof(U8));
    }
    total += o[j];
  }
  if (16 * L < P) {
    U64 h = 0, hrc = 0;
    const U64 mask64 = (((U64)1) << (2 * k)) - 1;
    const U8 *c = codes + 16 * L;
    for (int t = 0; t < k - 1; ++t) {
      U64 b = c[t];
      h = ((h << 2) & mask64) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
    for (I64 p = 16 * L; p < P; ++p) {
      U64 b = codes[p + k - 1];
      h = ((h << 2) & mask64) | b;
      hrc = ((hrc >> 2) | ((3 - b) << rcShift)) & mask64;
      U64 hf = (h * f1) >> s1;
      U64 hr = (hrc * f1) >> s1;
      if (dw.divides(hf < hr ? hf : hr)) {
        if (total >= cap) return -(2 * cap);
        out_k[total] = hf < hr ? h : hrc;
        out_p[total] = pbase + p;
        out_f[total] = hf < hr ? 1 : 0;
        ++total;
      }
    }
  }
  return total;
}

// pick the 16-lane u32 kernel when kmers/hashes fit 32 bits, the lane
// length fits the 24-bit meta position field, AND the emission rate is
// sparse enough that the math (not the hit staging) dominates — measured
// crossover w≈32 on this host (w=16: 552 vs 615 for the u64 kernel;
// w=64: 999 vs 908; w=128: 1268 vs 936; w=256: 1339 vs 1050 Mpos/s).
static inline I64 scan_simd_any(const U8 *codes, I64 P, int k, U64 w,
                                U64 f1, int s1, U64 *out_k, I64 *out_p,
                                U8 *out_f, I64 cap, I64 pbase) {
  if (k <= 16 && w >= 32 && w <= 0xFFFFFFFFull &&
      P / 16 < (((I64)1) << 24))
    return scan_simd_stream32(codes, P, k, w, f1, s1, out_k, out_p, out_f,
                              cap, pbase);
  return scan_simd_stream(codes, P, k, w, f1, s1, out_k, out_p, out_f,
                          cap, pbase);
}

// drop emissions whose kmer spans a read boundary: keep p iff the read r
// containing p satisfies p + k <= offsets[r+1] (two-pointer, in place).
static I64 filter_read_spans(const I64 *offsets, I64 nReads, int k,
                             U64 *out_k, I64 *out_p, U8 *out_f, I64 n) {
  I64 kept = 0, r = 0;
  for (I64 i = 0; i < n; ++i) {
    I64 p = out_p[i];
    while (r < nReads && offsets[r + 1] <= p) ++r;
    if (p + k <= offsets[r + 1]) {
      out_k[kept] = out_k[i];
      out_p[kept] = p;
      out_f[kept] = out_f[i];
      ++kept;
    }
  }
  return kept;
}
#endif  // AVX512

extern "C" I64 sh_scan_emit_reads(const U8 *codes, const I64 *offsets,
                                  I64 nReads, int k, U64 w, U64 factor1,
                                  int shift1, U64 *out_k, I64 *out_p,
                                  U8 *out_f, I64 cap) {
  const U64 mask = (k < 32) ? ((((U64)1) << (2 * k)) - 1) : ~(U64)0;
  const int rcShift = 2 * (k - 1);
  const DivisW dw(w);
  int nThreads = 1;
#ifdef _OPENMP
  nThreads = omp_get_max_threads();
#endif
#if defined(__AVX512F__) && defined(__AVX512DQ__)
  if (k <= 31 && nReads > 0) {
    const I64 n = offsets[nReads];
    const I64 P = n - k + 1;
    if (nThreads == 1 && P >= (1 << 16) && cap >= 64) {
      I64 got = scan_simd_any(codes, P, k, w, factor1, shift1,
                              out_k, out_p, out_f, cap, 0);
      if (got < 0) return got;  // lane overflow: caller doubles cap
      return filter_read_spans(offsets, nReads, k, out_k, out_p, out_f,
                               got);
    }
    // multicore: OpenMP over contiguous position slices, each scanned by
    // the 8-lane SIMD core into its own region (boundary-oblivious; one
    // global read-span filter at the end).  Slice order = stream order.
    if (nThreads > 1 && P >= (I64)nThreads << 16 &&
        cap >= (I64)nThreads * 64) {
      const int T = nThreads;
      const I64 Rt = cap / T;
      const I64 Lt = P / T;
      std::vector<I64> got(T);
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1)
#endif
      for (int t = 0; t < T; ++t) {
        const I64 a = (I64)t * Lt;
        const I64 Pt = (t == T - 1) ? P - a : Lt;
        got[t] = scan_simd_any(codes + a, Pt, k, w, factor1, shift1,
                               out_k + t * Rt, out_p + t * Rt,
                               out_f + t * Rt, Rt, a);
      }
      I64 total = 0;
      for (int t = 0; t < T; ++t)
        if (got[t] < 0) return -(2 * cap);
      for (int t = 0; t < T; ++t) {
        if (got[t] && t * Rt != total) {
          memmove(out_k + total, out_k + t * Rt, got[t] * sizeof(U64));
          memmove(out_p + total, out_p + t * Rt, got[t] * sizeof(I64));
          memmove(out_f + total, out_f + t * Rt, got[t] * sizeof(U8));
        }
        total += got[t];
      }
      return filter_read_spans(offsets, nReads, k, out_k, out_p, out_f,
                               total);
    }
  }
#endif
  if (nThreads == 1) {
    // sequential: one fused pass, direct writes (on overflow keep counting
    // so the caller learns the required size from -total)
    I64 o = 0;
    for (I64 r = 0; r < nReads; ++r) {
      I64 s0 = offsets[r], s1 = offsets[r + 1];
      if (s1 - s0 < k) continue;
      U64 h = 0, hrc = 0;
      for (int j = 0; j < k; ++j) {
        U64 b = codes[s0 + j];
        h = ((h << 2) & mask) | b;
        hrc = (hrc >> 2) | ((3 - b) << rcShift);
      }
      for (I64 p = s0;;) {
        U64 hf = (h * factor1) >> shift1;
        U64 hr = (hrc * factor1) >> shift1;
        U64 hash = hf < hr ? hf : hr;
        if (dw.divides(hash)) {
          if (o < cap) {
            out_k[o] = hf < hr ? h : hrc;
            out_p[o] = p;
            out_f[o] = hf < hr ? 1 : 0;
          }
          ++o;
        }
        if (p + k >= s1) break;
        U64 b = codes[p + k];
        ++p;
        h = ((h << 2) & mask) | b;
        hrc = (hrc >> 2) | ((3 - b) << rcShift);
      }
    }
    return o > cap ? -o : o;
  }

  // Scalar multicore fallback: two passes, zero per-read allocation
  // (short-read sets page-fault-thrash with per-read vectors).  Allocated
  // only here — the SIMD paths above never pay for it.
  std::vector<I64> starts((size_t)nReads + 1, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(guided)
#endif
  for (I64 r = 0; r < nReads; ++r) {
    I64 s0 = offsets[r], s1 = offsets[r + 1];
    if (s1 - s0 < k) continue;
    U64 h = 0, hrc = 0;
    for (int j = 0; j < k; ++j) {
      U64 b = codes[s0 + j];
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
    I64 cnt = 0;
    for (I64 p = s0;;) {
      U64 hf = (h * factor1) >> shift1;
      U64 hr = (hrc * factor1) >> shift1;
      U64 hash = hf < hr ? hf : hr;
      if (dw.divides(hash)) ++cnt;
      if (p + k >= s1) break;
      U64 b = codes[p + k];
      ++p;
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
    starts[r + 1] = cnt;
  }
  for (I64 r = 0; r < nReads; ++r) starts[r + 1] += starts[r];
  I64 total = starts[nReads];
  if (total > cap) return -total;

#ifdef _OPENMP
#pragma omp parallel for schedule(guided)
#endif
  for (I64 r = 0; r < nReads; ++r) {
    I64 s0 = offsets[r], s1 = offsets[r + 1];
    if (s1 - s0 < k) continue;
    U64 h = 0, hrc = 0;
    for (int j = 0; j < k; ++j) {
      U64 b = codes[s0 + j];
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
    I64 o = starts[r];
    for (I64 p = s0;;) {
      U64 hf = (h * factor1) >> shift1;
      U64 hr = (hrc * factor1) >> shift1;
      U64 hash = hf < hr ? hf : hr;
      if (dw.divides(hash)) {
        out_k[o] = hf < hr ? h : hrc;
        out_p[o] = p;
        out_f[o] = hf < hr ? 1 : 0;
        ++o;
      }
      if (p + k >= s1) break;
      U64 b = codes[p + k];
      ++p;
      h = ((h << 2) & mask) | b;
      hrc = (hrc >> 2) | ((3 - b) << rcShift);
    }
  }
  return total;
}

// ---------------------------------------------------------------------
// byte/word histograms: numpy's bincount casts the input to int64 (a
// len(arr)*8-byte temporary), which page-fault-thrashes on whole-file
// arrays; these count in place.
extern "C" void io_byte_hist(const U8 *a, I64 n, U64 *out256) {
  memset(out256, 0, 256 * sizeof(U64));
#pragma omp parallel
  {
    U64 loc[256] = {0};
#pragma omp for nowait
    for (I64 i = 0; i < n; ++i) ++loc[a[i]];
#pragma omp critical
    for (int j = 0; j < 256; ++j) out256[j] += loc[j];
  }
}

extern "C" void io_u16_hist(const U16 *a, I64 n, U64 *out, I64 nbins) {
  memset(out, 0, nbins * sizeof(U64));
  for (I64 i = 0; i < n; ++i) {
    U16 v = a[i];
    if ((I64)v < nbins) ++out[v];
  }
}
