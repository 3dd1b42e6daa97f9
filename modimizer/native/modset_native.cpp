// Native host runtime for the modimizer framework: exact open-addressed
// k-mer table maintenance at memcpy speed.
//
// The device side produces batches of (unique kmer, count, first-stream-
// position) triples; this module replays them into the canonical modset table
// preserving the reference semantics exactly (reference modset.c:45-77):
//   - probe start  = seqhash(kmer) & tableMask, where
//     seqhash(kmer) = (kmer * factor1) >> shift1   (seqhash.h:58)
//   - double-hash step = ((hash >> tableBits) & tableMask) | 1
//   - ids are assigned in first-encounter order (index = ++max)
//   - depth is a saturating U16 counter (modutils.c:26)
//
// Exposed as a plain-C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;

static inline U64 seqhash64(U64 kmer, U64 factor1, int shift1) {
  return (kmer * factor1) >> shift1;
}

// ---------------------------------------------------------------------------
// Group-batched probe resolution.
//
// The replay loops below are memory-LATENCY bound: every probe is a random
// 4 B load into a table far larger than L2, followed by a dependent 8 B value
// load, and a naive loop keeps only ~2 misses in flight.  The probe walks of
// DIFFERENT keys are independent given a frozen table, so ms_probe_group
// resolves groups of MS_GROUP keys with many walks in flight, and a serial
// placement pass then replays mutations in exact stream order; it resumes
// the probe walk only on the rare slot claimed since the snapshot (an
// earlier in-group insertion), which is exact because placements never move
// or erase existing entries, so a snapshot chain's occupied prefix stays
// occupied and a duplicate of the same kmer lands, by determinism of the
// probe sequence, on the very slot the snapshot walk ended at.
//
// Measured on this host (bits=25, 4.2M uniq, 21M-kmer stream,
// scripts/bench_table.py): insert 21.4 -> ~27 Mk/s, find 26.5 -> ~41 Mk/s.
// That is the platform wall, not a software gap: this virtualized single
// core sustains only ~90 M random cache lines/s however the accesses are
// scheduled (prefetch rings, burst passes and 16-byte-inline-key layouts
// were all built and measured within ~10% of each other — see docs/PERF.md
// round-5), and the replay needs ~2.2 dependent lines per key.
// ---------------------------------------------------------------------------

#ifndef MS_GROUP
#define MS_GROUP 512
#endif
#ifndef MS_RING
#define MS_RING 32
#endif

// Resolve probe chains for kmers[0..g) against a frozen table, AMAC-style
// (asynchronous memory access chaining): a ring of MS_RING in-flight walks,
// each advanced one step per visit, so every load lands ~one ring revolution
// (≈ a DRAM round trip) after its prefetch and ~MS_RING misses stay in
// flight continuously.  A wider burst does NOT help: the core has only
// 10-16 line-fill buffers, and software prefetches beyond them are dropped
// (measured: 512-wide burst passes ran at 58 M lines/s, the ring at ~115).
// fidx[j] = existing entry index (value match) or 0; off[j] = the matching
// slot, or the first free slot of the chain; diff[j] = the double-hash step.
static void ms_probe_group(const U32 *table, const U64 *value, int tableBits,
                           U64 factor1, int shift1, U64 mask,
                           const U64 *kmers, int g, U64 *off, U64 *diff,
                           U32 *fidx, const U16 *depth) {
  struct Walk {
    U64 off, diff, kmer;
    U32 ix;       // candidate entry (stage VALUE), 0 in stage BUCKET
    int j;        // key slot, -1 = idle
  } w[MS_RING];
  int nseed = g < MS_RING ? g : MS_RING;
  for (int r = 0; r < nseed; ++r) {
    U64 hash = seqhash64(kmers[r], factor1, shift1);
    w[r].off = hash & mask;
    w[r].diff = ((hash >> tableBits) & mask) | 1;
    w[r].kmer = kmers[r];
    w[r].ix = 0;
    w[r].j = r;
    __builtin_prefetch(&table[w[r].off], 0, 1);
  }
  for (int r = nseed; r < MS_RING; ++r) w[r].j = -1;
  int next = nseed, live = nseed, r = 0;
  while (live) {
    struct Walk *s = &w[r];
    int done = 0;
    if (s->j >= 0) {
      if (!s->ix) {                        // stage BUCKET: read the bucket
        U32 ix = table[s->off];
        if (!ix) {
          fidx[s->j] = 0;                  // free slot found
          off[s->j] = s->off;
          diff[s->j] = s->diff;
          done = 1;
        } else {
          s->ix = ix;
          __builtin_prefetch(&value[ix], 0, 1);
        }
      } else {                             // stage VALUE: compare the entry
        if (value[s->ix] == s->kmer) {
          fidx[s->j] = s->ix;
          off[s->j] = s->off;
          diff[s->j] = s->diff;
          // the consumer's depth[fidx] update is the next dependent random
          // miss; issue it here so it rides the same MLP window
          if (depth) __builtin_prefetch(&depth[s->ix], 1, 1);
          done = 1;
        } else {
          s->off = (s->off + s->diff) & mask;
          s->ix = 0;
          __builtin_prefetch(&table[s->off], 0, 1);
        }
      }
      if (done) {
        if (next < g) {                    // refill the ring slot
          U64 hash = seqhash64(kmers[next], factor1, shift1);
          s->off = hash & mask;
          s->diff = ((hash >> tableBits) & mask) | 1;
          s->kmer = kmers[next];
          s->ix = 0;
          s->j = next++;
          __builtin_prefetch(&table[s->off], 0, 1);
        } else {
          s->j = -1;
          --live;
        }
      }
    }
    r = r + 1 == MS_RING ? 0 : r + 1;
  }
}

extern "C" {

// Look up a batch of kmers; out[i] = index (0 if absent).
void ms_find_batch(const U32 *table, const U64 *value, int tableBits,
                   U64 factor1, int shift1, const U64 *kmers, int64_t n,
                   U32 *out) {
  const U64 mask = (((U64)1) << tableBits) - 1;
  U64 off[MS_GROUP], diff[MS_GROUP];
  for (int64_t i0 = 0; i0 < n; i0 += MS_GROUP) {
    int g = (int)(n - i0 < MS_GROUP ? n - i0 : MS_GROUP);
    ms_probe_group(table, value, tableBits, factor1, shift1, mask,
                   kmers + i0, g, off, diff, out + i0, (const U16 *)0);
  }
}

// Insert/accumulate a batch of (kmer, count) pairs in order, replaying the
// reference insertion semantics (modset.c:45-62 + modutils.c:26).  Returns
// the new max, or -1 on overflow (max reached size).  counts may be NULL,
// meaning count=1 each.  If out_idx is non-NULL it receives the table index
// per kmer.
int64_t ms_insert_batch(U32 *table, U64 *value, U16 *depth, U8 *info,
                        int tableBits, U64 factor1, int shift1, int64_t maxIn,
                        int64_t size, const U64 *kmers, const U32 *counts,
                        int64_t n, U32 *out_idx) {
  const U64 mask = (((U64)1) << tableBits) - 1;
  U64 max = (U64)maxIn;
  U64 off[MS_GROUP], diff[MS_GROUP];
  U32 fidx[MS_GROUP];
  for (int64_t i0 = 0; i0 < n; i0 += MS_GROUP) {
    int g = (int)(n - i0 < MS_GROUP ? n - i0 : MS_GROUP);
    ms_probe_group(table, value, tableBits, factor1, shift1, mask,
                   kmers + i0, g, off, diff, fidx, depth);
    // serial placement in stream order (ids are first-encounter order,
    // modset.c:56-59); all offsets are known, so prefetches are perfect
    for (int j = 0; j < g; ++j) {
      if (j + 32 < g) {
        U32 fx = fidx[j + 32];
        __builtin_prefetch(fx ? (const void *)&depth[fx]
                              : (const void *)&table[off[j + 32]], 1, 1);
      }
      U32 index = fidx[j];
      if (!index) {
        U64 o = off[j];
        U32 cur = table[o];
        if (cur) {
          // slot claimed since the snapshot by an earlier in-group
          // placement: resume the exact walk from here
          U64 kmer = kmers[i0 + j], d = diff[j];
          while (cur && value[cur] != kmer) {
            o = (o + d) & mask;
            cur = table[o];
          }
        }
        if (cur) {
          index = cur;                      // in-group duplicate
        } else {
          index = table[o] = (U32)(++max);
          if ((int64_t)max >= size) return -1;
          value[index] = kmers[i0 + j];
        }
      }
      U32 c = counts ? counts[i0 + j] : 1u;
      U32 d = (U32)depth[index] + c;
      depth[index] = d > 0xFFFF ? 0xFFFF : (U16)d;
      if (out_idx) out_idx[i0 + j] = index;
    }
  }
  return (int64_t)max;
}

// Merge semantics of modsetMerge (modset.c:106-128): saturating depth add and
// the quirky copy-number update info1 = (info1 & 3) | min(copy1+copy2, 3)
// (which deliberately drops the flag bits and ORs the clamped sum into the
// old copy bits).  kmers/depths/infos come from ms2 entries 1..max2 in order.
int64_t ms_merge_batch(U32 *table, U64 *value, U16 *depth, U8 *info,
                       int tableBits, U64 factor1, int shift1, int64_t maxIn,
                       int64_t size, const U64 *kmers, const U16 *depths2,
                       const U8 *infos2, int64_t n) {
  const U64 mask = (((U64)1) << tableBits) - 1;
  U64 max = (U64)maxIn;
  U64 off[MS_GROUP], diff[MS_GROUP];
  U32 fidx[MS_GROUP];
  for (int64_t i0 = 0; i0 < n; i0 += MS_GROUP) {
    int g = (int)(n - i0 < MS_GROUP ? n - i0 : MS_GROUP);
    ms_probe_group(table, value, tableBits, factor1, shift1, mask,
                   kmers + i0, g, off, diff, fidx, depth);
    for (int j = 0; j < g; ++j) {
      if (j + 32 < g) {
        U32 fx = fidx[j + 32];
        __builtin_prefetch(fx ? (const void *)&depth[fx]
                              : (const void *)&table[off[j + 32]], 1, 1);
      }
      U32 index = fidx[j];
      if (!index) {
        U64 o = off[j];
        U32 cur = table[o];
        if (cur) {
          U64 kmer = kmers[i0 + j], d = diff[j];
          while (cur && value[cur] != kmer) {
            o = (o + d) & mask;
            cur = table[o];
          }
        }
        if (cur) {
          index = cur;
        } else {
          index = table[o] = (U32)(++max);
          if ((int64_t)max >= size) return -1;
          value[index] = kmers[i0 + j];
        }
      }
      int64_t i = i0 + j;
      U32 d = (U32)depth[index] + (U32)depths2[i];
      depth[index] = d > 0xFFFF ? 0xFFFF : (U16)d;
      int c = (info[index] & 3) + (infos2[i] & 3);
      if (c > 3) c = 3;
      info[index] = (U8)((info[index] & 0x3) | c);
    }
  }
  return (int64_t)max;
}

// Rebuild the probe table for entries whose (value, depth, info) arrays are
// already in final id order — used by depthPrune (modset.c:64-77) and by the
// device-accelerated construction path after computing global first-encounter
// order.  Entries 1..max inserted sequentially; returns -1 if a duplicate
// value is encountered (should not happen).
int64_t ms_rebuild_table(U32 *table, const U64 *value, int tableBits,
                         U64 factor1, int shift1, int64_t max) {
  const U64 mask = (((U64)1) << tableBits) - 1;
  U64 tableSize = ((U64)1) << tableBits;
  memset(table, 0, tableSize * sizeof(U32));
  U64 off[MS_GROUP], diff[MS_GROUP];
  U32 fidx[MS_GROUP];
  for (int64_t i0 = 1; i0 <= max; i0 += MS_GROUP) {
    int g = (int)(max - i0 + 1 < MS_GROUP ? max - i0 + 1 : MS_GROUP);
    ms_probe_group(table, value, tableBits, factor1, shift1, mask,
                   value + i0, g, off, diff, fidx, (const U16 *)0);
    for (int j = 0; j < g; ++j) {
      if (fidx[j]) return -1;               // duplicate value
      U64 o = off[j];
      U32 cur = table[o];
      if (cur) {
        U64 kmer = value[i0 + j], d = diff[j];
        while (cur && value[cur] != kmer) {
          o = (o + d) & mask;
          cur = table[o];
        }
        if (cur) return -1;
      }
      table[o] = (U32)(i0 + j);
    }
  }
  return max;
}

// 2-bit pack of base codes into big-endian-per-word u64s (the device scan
// stream layout, ops/packed.py pack_sw) — single pass, OpenMP over words.
// Positions past n pack as 0.
void pk_pack2(const unsigned char *codes, int64_t n, U64 *out,
              int64_t n_words) {
  int64_t full = n / 32 < n_words ? n / 32 : n_words;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t w = 0; w < full; ++w) {
    const unsigned char *c = codes + 32 * w;
    U64 v = 0;
    for (int b = 0; b < 32; ++b) v = (v << 2) | (U64)(c[b] & 3);
    out[w] = v;
  }
  for (int64_t w = full; w < n_words; ++w) {
    U64 v = 0;
    for (int b = 0; b < 32; ++b) {
      int64_t p = 32 * w + b;
      v = (v << 2) | (U64)(p < n ? (codes[p] & 3) : 0);
    }
    out[w] = v;
  }
}

// packed validity bit-plane straight from read offsets: bit p of word p/64
// (little-endian bit order) = "k-mer at stream position p lies inside one
// read".  Replaces the dense-bool + packbits host pass (ops/seqhash.py
// _validity) on the scan fast path.
void pk_valid_words(const int64_t *offsets, int64_t n_reads, int64_t n,
                    int k, U64 *out, int64_t n_words) {
  int64_t nw_full = n / 64 < n_words ? n / 64 : n_words;
  memset(out, 0xFF, (size_t)nw_full * 8);
  for (int64_t w = nw_full; w < n_words; ++w) {
    U64 v = 0;
    for (int b = 0; b < 64 && 64 * w + b < n; ++b) v |= ((U64)1) << b;
    out[w] = v;
  }
  for (int64_t i = 0; i < n_reads; ++i) {
    int64_t end = offsets[i + 1] < n ? offsets[i + 1] : n;
    int64_t lo = end - (k - 1);
    if (lo < offsets[i]) lo = offsets[i];
    for (int64_t p = lo; p < end; ++p)
      out[p / 64] &= ~(((U64)1) << (p % 64));
  }
}

}  // extern "C"
