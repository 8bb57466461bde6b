// The exact two-stage top-k.  Stage 1 (topk_blocks_kernel,
// topk_warp_kernel): (Q, D) f32 scores → for each block of block_d columns
// its top k, as (Q, n_blocks·k) values and global int32 column indices.
// Stage 2 (topk_merge_kernel): those candidates → the row's top k by
// (score desc, id asc), raw value bits and int64 ids.
//
// Stage 2 replaces the lax.top_k of src/repro/kernels/topk_blocks/ops.py
// (stage 2 there), which the port ran as two stable segmented sorts of
// every candidate.  Its input is stage 1's output, and it relies on what
// stage 1 guarantees: a row is n_blocks lists of k entries, each sorted
// by (key desc, column asc) with key_of's keys (−0.0 as +0.0, −inf and
// pads as 0), and the lists come in column order.  So among equal keys
// position order is id order, and sorting (key desc, position asc) gives
// (score desc, id asc).  The −inf entries are stage 1's pads (−inf, the
// block's first column): their position order is their id order too.
// - A bound first: with c = ⌈k / n_blocks⌉ the first c entries of every
//   list hold at least k keys, so their k-th largest key τ₀ (radix select
//   over those heads, histograms in shared memory) is at or below the
//   row's k-th key.  Every entry of the answer has a key ≥ τ₀ and lies in
//   the run of its list at or above τ₀.  Each list is walked from its head
//   (gallop, then bisect) to the end of that run; the runs (usually 1–3·k
//   entries) are gathered by a shared count and sorted (bitonic), and the
//   first k written.  Ids are read only for the k entries written.
// - Where the runs overflow the buffer (heavy ties at τ₀): radix select of
//   the row's k-th key over the entries at or above τ₀, the keys above it,
//   and of the keys equal to it the lowest positions by a block-wide
//   prefix count; then the k survivors are sorted.  Slower, same output.
// - Rows with fewer than k entries above −inf (τ₀ is then 0): the live
//   entries sorted, then the −inf entries in position order.
// The buffer holds the power of two ≥ 4k entries in shared memory, or ≥ 2k
// in a global scratch the wrapper allocates where 4k passes 8,192.  A CTA
// a query row.  A row that takes the overflow path adds 1 to ``ties`` (the
// wrapper's device counter topk_merge.tie_rows).  Bound on an H100 SXM (3.35 TB/s): reading every candidate once and writing the
// output once, (1,024 × 51,300) candidates at k = 100 take 0.126 ms; the
// bound and the runs read a few KB a row.
//
// Stage 1:
//
// Replaces src/repro/kernels/topk_blocks/kernel.py::topk_blocks_pallas
// (tile body _topk_tile_kernel).  That kernel runs k rounds of "max, then
// the lowest column holding it, then set that column to −inf".  Its output,
// which this kernel gives bit for bit:
// - the block's elements above −inf in (value desc, column asc) order,
//   −0.0 equal to +0.0 (ties between them go to the lower column);
// - once those run out, every remaining slot is (−inf, the block's first
//   column): by then the Pallas tile holds only −inf, original or set, and
//   its lowest column is the block's first.  Columns past D are −inf pads;
//   k > block_d fills the same way.
//
// Bound on an H100 SXM (3.35 TB/s): on (256, 1M) it reads 1.02 GB of
// scores, 0.31 ms.  The Pallas kernel's k rounds cost k·block_d compares a
// block; this one reads each tile once and makes a fixed number of passes
// over it whatever k is, so its cost follows the tile, not k.  Keys are
// order-preserving uint32 maps of the floats (−0.0 as +0.0; −inf and pads
// as 0, never picked), and an entry (key << 32 | ~column) orders by (value
// desc, column asc), so a sort of entries is the Pallas order.
// - A bound first: each warp's c-th largest thread maximum, c = ⌈k/warps⌉,
//   has c keys of the tile at or above it, so the smallest such bound has
//   at least k.  The keys at or above it (usually 1–3·k) are collected by a
//   warp scan and sorted (bitonic, by shuffles below a stride of 32), and
//   the first k written.  No atomics on elements, three block barriers.
// - Otherwise (k > 32·warps, or more survivors than the buffer holds, as
//   with heavy ties at the bound): radix select of the k-th key, up to four
//   8-bit histogram passes over the tile with shared-memory atomics on
//   counts only (deterministic), stopping once the bin holding the k-th key
//   is taken whole; keys above it are kept and, of the keys equal to it,
//   the lowest columns by a block-wide prefix count in column order; then
//   the k survivors are sorted.
// A (row, block) tile that takes the radix select, or the warp kernel's
// rounds below, adds 1 to ``ties`` (the wrapper's device counter
// topk_blocks.tie_tiles), one atomic a tile that takes it.
// Shapes: the main path's (block_d ≤ 1024, k ≤ 32) runs a warp per block
// with the tile in registers and no block barriers (below); 32 < k ≤ 128
// at block_d ≤ 4,096 (the exact cells' k = 100) the ring path (next
// note); other blocks a CTA per block with the tile in shared memory (16
// bytes a thread where aligned).  A tile above 32,768 columns is read from
// global memory in every pass, and a sort above 8,192 entries runs in a
// global scratch the wrapper allocates: slower, same output.
//
// Stage 1's ring path (topk_blocks_kernel<COLS>, COLS = 4,096 or 2,048).
// Bound on an H100 SXM at the exact cells' shape, (1,024 × 2.1M) scores at
// k = 100 in 513 blocks of 4,096: 8.60 GB read and 0.42 GB written, 2.69
// ms, bytes.  That is 0.65 µs of an SM a tile (525,312 tiles over 132
// SMs); the per-block CTA kernel took 2.1 µs, bound by its instructions
// and barriers (three passes over the tile, a block-wide sort of every
// key at its bound), with no later tile's bytes in flight.  Here:
// - Persistent CTAs, four an SM, each walking tiles blockIdx.x, +
//   gridDim.x, ...; thread 0 keeps the next two landing in a ring of
//   three shared-memory slots by cp.async.bulk on an mbarrier each.  A
//   tile not on 16 bytes (D % 4 ≠ 0) is read from global memory instead.
// - The bound: each 8-column group's maximum as a key, and warp 0's
//   search for the k-th largest of the 512 (256 at COLS = 2,048): a warp
//   sum of the keys at or above a point, halving a range, the point then
//   raised to one of the keys.  k groups, so k keys, lie at or above it;
//   on Gaussian tiles ~1.1·k keys do, on lattice (1-bit) tiles ~1.25·k.
// - The survivors, keys at or above it, appended by a warp scan and one
//   shared atomic a warp in a second read of the slot.  Past 256 of them
//   the tile's radix select above decides (a tie tile).
// - Exactly k, then a small sort, by warp 1 while warp 0 takes the next
//   tile's bound: up to 128 survivors are sorted in its registers (4 a
//   lane, bitonic, shuffles past stride 2); past 128 the keys above the
//   bound are kept where they are k or more, else those and the lowest
//   columns of the keys at the bound (a warp search on ~column), packed,
//   then sorted the same way (past 128 kept, 8 a lane).
// - The design budget: ≤ 2,500 warp instructions a tile (the per-block
//   kernel ~7,800).  Each CTA adds its tiles' survivors (those off the tie
//   path) to ``survivors`` (topk_blocks.bound_survivors) once, at exit.
// On an H100 80GB HBM3 at 700 W, traced in the cells: 3.6 ms a batch on
// int8 scores and 4.0 ms on 1-bit scores (75% and 67% of the bound; the
// per-block kernel 8.5 and 9.3 ms).

#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "mma_util.cuh"

namespace {

using mma_util::bulk_1d;
using mma_util::mbar_arrive;
using mma_util::mbar_done;
using mma_util::mbar_expect;
using mma_util::mbar_init;
using mma_util::smem_addr;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_TILE = 32768;  // columns held in shared memory

// order-preserving map of a NaN-free float; −inf → 0, −0.0 → +0.0's key
__device__ __forceinline__ unsigned key_of(float v) {
  if (v == -INFINITY) return 0u;
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the float whose key is ``key`` (for a key of a float: that float, ±0.0
// as +0.0)
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? key ^ 0x80000000u : ~key);
}

// an element's raw bits from its key, reading ±0.0 (whose sign the key
// drops) from s[col]
__device__ __forceinline__ float value_of(unsigned key, const float* s,
                                          int col) {
  if (key == 0x80000000u) return s[col];
  return key_value(key);
}

// the element's raw bits: from the shared tile, or from global memory
template <bool TILE>
__device__ __forceinline__ float value_at(const unsigned* tile,
                                          const float* s, int i) {
  if constexpr (TILE) return __uint_as_float(tile[i]);
  return s[i];
}

template <bool TILE>
__device__ __forceinline__ unsigned key_at(const unsigned* tile,
                                           const float* s, int i) {
  return key_of(value_at<TILE>(tile, s, i));
}

// exclusive prefix sum over the block, in thread order
template <int NT>
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* wsum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < NT / 32 ? wsum[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += o;
    }
    if (lane < NT / 32) wsum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const unsigned before = warp > 0 ? wsum[warp - 1] : 0u;
  __syncthreads();
  return before + incl - v;
}

// One bitonic compare-exchange step of a descending sort: the pair's
// lower index keeps the larger entry in a segment sorted descending.
template <typename T>
__device__ __forceinline__ T bitonic_keep(T v, T o, int i, int size,
                                          int stride) {
  const bool keep_max = ((i & stride) == 0) == ((i & size) == 0);
  return keep_max ? (v > o ? v : o) : (v < o ? v : o);
}

// the strides below 32 of a bitonic merge of segments of ``size``; entry i
// in thread i's register
template <typename T>
__device__ __forceinline__ T merge_in_warp(T v, int i, int size) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    if (stride < size)
      v = bitonic_keep(v, static_cast<T>(__shfl_xor_sync(FULL, v, stride)),
                       i, size, stride);
  return v;
}

// bitonic sort, descending, of 32 entries, one per lane of each warp
template <typename T>
__device__ __forceinline__ T warp_sort_desc(T v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) v = merge_in_warp(v, lane, size);
  return v;
}

// bitonic sort, descending, of n entries (a power of two, 64 ≤ n ≤ NT),
// entry i in thread i's register; strides ≥ 32 exchange through ``buf``
template <typename T>
__device__ T block_sort_desc(T v, int n, T* buf) {
  const int i = threadIdx.x;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) v = merge_in_warp(v, i, size);
  for (int size = 64; size <= n; size <<= 1) {
    for (int stride = size / 2; stride >= 32; stride >>= 1) {
      __syncthreads();
      if (i < n) buf[i] = v;
      __syncthreads();
      if (i < n) v = bitonic_keep(v, buf[i ^ stride], i, size, stride);
    }
    v = merge_in_warp(v, i, size);
  }
  return v;
}

// bitonic sort, descending, of n entries (a power of two) in memory
template <int NT>
__device__ void sort_desc_mem(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += NT) {
        const int lo = 2 * stride * (i / stride) + i % stride;
        const int hi = lo + stride;
        const unsigned long long x = a[lo], y = a[hi];
        if (((lo & size) == 0) == (x < y)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
}

__device__ __forceinline__ unsigned long long entry(unsigned key, int col) {
  return (static_cast<unsigned long long>(key) << 32) |
         (0xffffffffu - static_cast<unsigned>(col));
}

__device__ __forceinline__ int entry_col(unsigned long long e) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(e));
}

struct Shared {
  unsigned hist[3][256];  // radix pass p counts into hist[p % 3]
  unsigned wsum[32];
  unsigned n_live;        // elements above −inf
  unsigned n_found;       // survivors written so far
  unsigned bound;         // no more than the k-th largest key
};

// entries of the candidate buffer: the survivors' sort (p2), the block
// sort's exchange (nt), and room for the keys at or above the bound (a
// quarter of the block, at most 2048)
__host__ __device__ inline int cand_cap(int p2, int nt, int block_d) {
  int pow2 = 1;
  while (pow2 < block_d && pow2 < 8192) pow2 <<= 1;
  const int room = pow2 / 4 < 2048 ? pow2 / 4 : 2048;
  const int m = p2 > nt ? p2 : nt;
  return m > room ? m : room;
}

size_t smem_bytes(bool tile, int block_d, int cap, bool sort_in_smem) {
  size_t b = tile ? static_cast<size_t>(block_d) * 4 : 0;
  b = (b + 15) / 16 * 16;
  return b + (sort_in_smem ? static_cast<size_t>(cap) * 8 : 0);
}

// Where the kk-th largest key lies: its bits above ``shift`` are
// ``prefix``, it is the kr-th largest of the keys with that prefix, and
// ``whole``: every key with that prefix is among the kk largest (then
// ``prefix << shift`` is at or below the kk-th key; otherwise shift is 0
// and ``prefix`` the key itself).
struct Rank {
  unsigned prefix;
  int shift;
  unsigned kr;
  bool whole;
};

// Radix select of the kk-th largest of the keys that ``visit`` hands each
// thread (1 ≤ kk ≤ their number): 8-bit passes from the top, one barrier
// a pass (every warp scans the histogram itself, and the next pass counts
// into another of the three histograms, cleared while this one fills),
// stopping once the bin holding the key is taken whole.
template <int NT, typename Visit>
__device__ Rank radix_rank(Visit visit, unsigned kk, unsigned (*hist)[256]) {
  const int tid = threadIdx.x, lane = tid % 32;
  __syncthreads();  // no thread still reads hist[0]
  for (int b = tid; b < 256; b += NT) hist[0][b] = 0;
  __syncthreads();
  unsigned prefix = 0, kr = kk, cnt = 0;
  int shift = 24;
  for (int pass = 0;; ++pass, shift -= 8) {
    unsigned* h = hist[pass % 3];
    unsigned* h_next = hist[(pass + 1) % 3];
    for (int b = tid; b < 256; b += NT) h_next[b] = 0;
    visit([&](unsigned key) {
      if (shift == 24 || (key >> (shift + 8)) == prefix)
        atomicAdd(&h[(key >> shift) & 255], 1u);
    });
    __syncthreads();
    // lane l holds bins 255 − 8l … 248 − 8l; count from the top
    unsigned cb[8], local = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cb[j] = h[255 - 8 * lane - j];
      local += cb[j];
    }
    unsigned incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    unsigned above = incl - local, bin = 0, nkr = 0, ncnt = 0;
    const bool here = above < kr && kr <= incl;
    if (here) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (above + cb[j] >= kr) {
          bin = 255 - 8 * lane - j;
          nkr = kr - above;
          ncnt = cb[j];
          break;
        }
        above += cb[j];
      }
    }
    const int src = __ffs(__ballot_sync(FULL, here)) - 1;
    prefix = (prefix << 8) | __shfl_sync(FULL, bin, src);
    kr = __shfl_sync(FULL, nkr, src);
    cnt = __shfl_sync(FULL, ncnt, src);
    if (cnt == kr || shift == 0) break;
  }
  return {prefix, shift, kr, cnt == kr};
}

// Place in ``cand`` the entries of the kk largest keys of positions
// [0, n), as ``rank`` (radix_rank's, over the keys ≥ ``floor``) locates
// the kk-th: every key above it, and all of its bin when that is taken
// whole, otherwise of the keys equal to it the lowest positions.  Keys
// below ``floor`` take no part.  ``*n_found`` is 0 on entry.
template <int NT, typename KeyAt>
__device__ void take_ranked(KeyAt key_at, int n, unsigned floor,
                            const Rank& rank, unsigned long long* cand,
                            unsigned* n_found, unsigned* wsum) {
  const int tid = threadIdx.x, lane = tid % 32;
  const unsigned lane_lt = (1u << lane) - 1u;
  for (int i0 = 0; i0 < n; i0 += NT) {
    const int i = i0 + tid;
    bool keep = false;
    unsigned key = 0;
    if (i < n) {
      key = key_at(i);
      const unsigned hi = key >> rank.shift;
      keep = key >= floor &&
             (hi > rank.prefix || (rank.whole && hi == rank.prefix));
    }
    const unsigned m = __ballot_sync(FULL, keep);
    unsigned slot = 0;
    if (lane == 0 && m)
      slot = atomicAdd(n_found, static_cast<unsigned>(__popc(m)));
    slot = __shfl_sync(FULL, slot, 0) + __popc(m & lane_lt);
    if (keep) cand[slot] = entry(key, i);
  }
  if (!rank.whole) {
    // shift is 0 and prefix the kk-th key.  Contiguous positions a thread,
    // so a prefix count over threads is a count in position order.
    const int per = (n + NT - 1) / NT;
    const int lo = min(n, tid * per);
    const int hi = min(n, lo + per);
    unsigned eq = 0;
    for (int i = lo; i < hi; ++i) eq += key_at(i) == rank.prefix;
    const unsigned before = block_exclusive_scan<NT>(eq, wsum);
    unsigned quota = rank.kr > before ? min(rank.kr - before, eq) : 0u;
    for (int i = lo; i < hi && quota > 0; ++i) {
      if (key_at(i) == rank.prefix) {
        cand[atomicAdd(n_found, 1u)] = entry(rank.prefix, i);
        --quota;
      }
    }
  }
}

// Sort ``found`` entries of ``cand`` (which holds the power of two ≥ found)
// by (key desc, position asc) and hand the first kk ≤ found to
// ``emit(rank, entry)``.
template <int NT, typename Emit>
__device__ void sort_and_emit(unsigned long long* cand, int found, int kk,
                              Emit emit) {
  const int tid = threadIdx.x;
  int len = 1;
  while (len < found) len <<= 1;
  if (len <= 32) {  // one warp
    if (tid < 32) {
      const unsigned long long e =
          warp_sort_desc(tid < found ? cand[tid] : 0ull);
      if (tid < kk) emit(tid, e);
    }
  } else if (len <= NT) {
    __syncthreads();  // cand is the block sort's exchange buffer
    const unsigned long long e = tid < found ? cand[tid] : 0ull;
    const unsigned long long sorted = block_sort_desc(e, len, cand);
    if (tid < kk) emit(tid, sorted);
  } else {
    for (int i = found + tid; i < len; i += NT) cand[i] = 0ull;
    __syncthreads();
    sort_desc_mem<NT>(cand, len);
    for (int r = tid; r < kk; r += NT) emit(r, cand[r]);
  }
}

// ---------------------------------------------------------------------------
// Stage 1's ring path (the header's stage-1 note): 32 < k ≤ 128, tiles of
// at most RING_COLS columns.

constexpr int RING_K = 128;       // the largest k: one warp sorts 128
constexpr int RING_NT = 256;
constexpr int RING_SLOTS = 3;     // tiles a CTA holds: one read, two landing
constexpr int RING_CAP = 256;     // survivors kept; more: the radix select
constexpr int RING_CTAS = 4;      // CTAs an SM (≤ 64 registers a thread)
constexpr int RING_COLS = 4096;   // the widest tile
constexpr int GROUP = 8;          // columns a group maximum covers

// With at least kk of the N values of every lane (the warp's) at or above
// lo (at_lo of them) and fewer than kk at or above hi: halves [lo, hi),
// counting the values at or above its midpoint (a warp sum) each round,
// until it is at most stop + 1 wide or at most ``enough`` values lie at or
// above lo; returns lo.  With stop 0, or enough = kk over distinct values,
// every value at or above lo is among the kk largest.
template <int N>
__device__ unsigned warp_halve(const unsigned (&v)[N], unsigned kk,
                               unsigned lo, unsigned at_lo,
                               unsigned long long hi, unsigned long long stop,
                               unsigned enough) {
  while (hi - lo > stop + 1 && at_lo > enough) {
    const unsigned mid = lo + static_cast<unsigned>((hi - lo) / 2);
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) c += v[j] >= mid;
    c = __reduce_add_sync(FULL, c);
    if (c >= kk) {
      lo = mid;
      at_lo = c;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A bound on the kk-th largest (1 ≤ kk ≤ 32·N) of the N keys of every lane
// of the warp: one of the keys, with at least kk keys at or above it, and
// at most kk/16 more than kk of them or below the kk-th by 1/2,048 of the
// range searched at most.  The range starts at [the maximum − 2²⁴ (2
// binades), the maximum], or wider where fewer than kk keys lie in it;
// the point found is raised to the least key at or above it.
template <int N>
__device__ unsigned warp_bound(const unsigned (&v)[N], unsigned kk) {
  unsigned top = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) top = max(top, v[j]);
  top = __reduce_max_sync(FULL, top);
  unsigned lo = 0, at_lo = 32 * N;
  for (int w = 24; w <= 30; w += 3) {  // 2, 16 and 128 binades down
    if (top <= (1u << w)) break;
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) c += v[j] >= top - (1u << w);
    c = __reduce_add_sync(FULL, c);
    if (c >= kk) {
      lo = top - (1u << w);
      at_lo = c;
      break;
    }
  }
  const unsigned long long hi = static_cast<unsigned long long>(top) + 1;
  lo = warp_halve(v, kk, lo, at_lo, hi, (hi - lo) >> 11, kk + kk / 16);
  unsigned least = ~0u;
#pragma unroll
  for (int j = 0; j < N; ++j) least = min(least, v[j] >= lo ? v[j] : ~0u);
  return __reduce_min_sync(FULL, least);
}

// Bitonic sort, descending, of 32·R entries by one warp, entry R·lane + r
// in e[r]: every merge in one direction (its first step compares i with
// i ^ (size − 1)), strides below R within a lane, the others by shuffles.
template <int R>
__device__ __forceinline__ void warp_sort(unsigned long long (&e)[R]) {
  const int lane = threadIdx.x % 32;
  const auto keep = [](unsigned long long& hi_, unsigned long long& lo_) {
    const unsigned long long a = hi_, b = lo_;
    hi_ = a > b ? a : b;
    lo_ = a > b ? b : a;
  };
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const bool flip = stride == size / 2;
      if (stride >= R) {
        // the partner is in lane ^ m; the lower index keeps the larger
        const int m = flip ? (size - 1) / R : stride / R;
        const bool lower = (lane & (stride / R)) == 0;
        unsigned long long o[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          o[r] = __shfl_xor_sync(FULL, e[flip ? R - 1 - r : r], m);
#pragma unroll
        for (int r = 0; r < R; ++r)
          e[r] = lower == (e[r] > o[r]) ? e[r] : o[r];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int q = flip ? r ^ (size - 1) : r ^ stride;
          if (q > r) keep(e[r], e[q]);
        }
      }
    }
  }
}

// The found ≤ 32·R entries of cand sorted by one warp, and the first kk
// written as raw value bits (±0.0 read from s) and columns base + column.
template <int R>
__device__ __forceinline__ void sort_and_write(
    const unsigned long long* cand, int found, int kk, const float* s,
    int base, float* out_v, int* out_i) {
  const int lane = threadIdx.x % 32;
  unsigned long long e[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    e[r] = R * lane + r < found ? cand[R * lane + r] : 0ull;
  warp_sort<R>(e);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int at = R * lane + r;
    if (at < kk) {
      const int col = entry_col(e[r]);
      out_v[at] = value_of(static_cast<unsigned>(e[r] >> 32), s, col);
      out_i[at] = base + col;
    }
  }
}

// Of the found (RING_K < found ≤ RING_CAP) entries of cand, all at or
// above the tile's bound (one of its keys), those that hold the k largest
// and that one warp tells apart without a sort: the keys above the bound
// where they are k or more, else those and, of the keys at the bound, the
// lowest columns (the largest low words ~column) to make k.  Packed to the
// front of cand; returns their number.
__device__ __noinline__ int keep_k(unsigned long long* cand, int found,
                                   int k, unsigned bound) {
  const int lane = threadIdx.x % 32;
  constexpr int R = RING_CAP / 32;
  unsigned long long w[R];
  unsigned above = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w[r] = 32 * r + lane < found ? cand[32 * r + lane] : 0ull;
    above += static_cast<unsigned>(w[r] >> 32) > bound;
  }
  above = __reduce_add_sync(FULL, above);
  const bool take_at = above < static_cast<unsigned>(k);
  unsigned low_min = 0;  // of the keys at the bound, the low words kept
  if (take_at) {
    unsigned low[R], top = 0, least = ~0u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool at = static_cast<unsigned>(w[r] >> 32) == bound;
      low[r] = at ? static_cast<unsigned>(w[r]) : 0u;
      top = max(top, low[r]);
      least = min(least, at ? low[r] : ~0u);
    }
    top = __reduce_max_sync(FULL, top);
    least = __reduce_min_sync(FULL, least);
    low_min = warp_halve(low, k - above, least, ~0u,
                         static_cast<unsigned long long>(top) + 1, 0,
                         k - above);
  }
  __syncwarp();  // every lane has read cand
  const unsigned lane_lt = (1u << lane) - 1u;
  unsigned kept = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned key = static_cast<unsigned>(w[r] >> 32);
    const bool keep = key > bound || (take_at && key == bound &&
                                      static_cast<unsigned>(w[r]) >= low_min);
    const unsigned m = __ballot_sync(FULL, keep);
    if (keep) cand[kept + __popc(m & lane_lt)] = w[r];
    kept += __popc(m);
  }
  __syncwarp();
  return static_cast<int>(kept);
}

// shared memory of the ring path: the slots, the survivors, the group
// maxima's keys and the slots' barriers (Shared holds the rest)
template <int COLS>
struct Ring {
  static constexpr int VEC = COLS / (4 * RING_NT);  // float4 a thread
  static constexpr int GROUPS = COLS / GROUP;       // 512 or 256
  static constexpr int SLOT = COLS * 4;
  static constexpr int CAND = RING_SLOTS * SLOT;
  static constexpr int GKEYS = CAND + RING_CAP * 8;
  static constexpr int BARS = GKEYS + GROUPS * 4;
  static constexpr int BYTES = BARS + RING_SLOTS * 8;
  static_assert(VEC % 2 == 0 && GROUPS >= RING_K, "groups of two float4");
};

// thread tid's elements of a tile, −inf past n: element 4j + c is column
// 4·(tid + RING_NT·j) + c, from the shared slot (bulk) or global memory
template <int VEC>
__device__ __forceinline__ void ring_load(float (&v)[4 * VEC],
                                          const float* slot, const float* s,
                                          int n, bool bulk) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int col = 4 * (tid + RING_NT * j);
    if (bulk) {
      const float4 x = col < n ? reinterpret_cast<const float4*>(slot)[col / 4]
                               : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                             -INFINITY);
      v[4 * j] = x.x;
      v[4 * j + 1] = x.y;
      v[4 * j + 2] = x.z;
      v[4 * j + 3] = x.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[4 * j + c] = col + c < n ? __ldcs(s + col + c) : -INFINITY;
    }
  }
}

// A ring CTA's tile: (row, block), where it lies and whether a bulk copy
// takes it.  The CTA's i-th tile is first + i·step of the (row, block)
// grid; a cursor steps on without dividing.
struct RingTile {
  int row, blk;
  int base, n;
  const float* s;
  bool bulk;  // 16-byte aligned and a multiple of 16 bytes: the slot holds it
  __device__ void at(const float* scores, int n_d, int block_d) {
    base = blk * block_d;
    n = min(block_d, n_d - base);
    s = scores + static_cast<size_t>(row) * n_d + base;
    bulk = reinterpret_cast<uintptr_t>(s) % 16 == 0 && n % 4 == 0;
  }
  __device__ void next(int d_row, int d_blk, int n_blocks) {
    row += d_row;
    blk += d_blk;
    if (blk >= n_blocks) {
      blk -= n_blocks;
      ++row;
    }
  }
};

// The ring path's CTA (the header's stage-1 note): it walks tiles
// blockIdx.x, + gridDim.x, ... of the (row, block) grid.  Thread 0 keeps
// the next RING_SLOTS − 1 tiles landing in the slots by bulk copies; for
// each tile the CTA takes the bound and the survivors at or above it, and
// warp 1 writes the tile's k largest while warp 0 takes the next bound.
template <int COLS>
__device__ __forceinline__ void ring_tiles(
    const float* __restrict__ scores, float* __restrict__ vals,
    int* __restrict__ idx, unsigned long long* __restrict__ ties,
    unsigned long long* __restrict__ survivors, int n_q, int n_d, int k,
    int block_d, int n_blocks, unsigned char* smem, Shared& sh) {
  using R = Ring<COLS>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  auto* cand = reinterpret_cast<unsigned long long*>(smem + R::CAND);
  auto* gkeys = reinterpret_cast<unsigned*>(smem + R::GKEYS);
  const uint32_t bar0 = smem_addr(smem + R::BARS);
  const long long n_tiles = static_cast<long long>(n_q) * n_blocks;
  const long long first = blockIdx.x, step = gridDim.x;
  const int my_tiles =
      first < n_tiles ? static_cast<int>((n_tiles - 1 - first) / step + 1) : 0;

  const int d_row = static_cast<int>(step / n_blocks);
  const int d_blk = static_cast<int>(step % n_blocks);
  const RingTile start{static_cast<int>(first / n_blocks),
                       static_cast<int>(first % n_blocks)};
  const auto slot_of = [&](int i) {
    return reinterpret_cast<float*>(smem + (i % RING_SLOTS) * R::SLOT);
  };
  // thread 0: tile i (the cursor ``ld``) into its slot, counted on the
  // slot's barrier; a tile read from global memory completes the phase
  // with no copy
  RingTile ld = start;
  const auto load = [&](int i) {
    ld.at(scores, n_d, block_d);
    const uint32_t bar = bar0 + 8 * (i % RING_SLOTS);
    if (ld.bulk) {
      mbar_expect(bar, ld.n * 4);
      bulk_1d(smem_addr(slot_of(i)), ld.s, ld.n * 4, bar);
    } else {
      mbar_arrive(bar);
    }
    ld.next(d_row, d_blk, n_blocks);
  };

  if (tid == 0) {
    for (int b = 0; b < RING_SLOTS; ++b) mbar_init(bar0 + 8 * b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(RING_SLOTS, my_tiles); ++i) load(i);
  unsigned long long n_surv = 0, n_ties = 0;  // thread 0's, added at exit

  // warp 1: the k largest of the previous tile's found entries in cand
  // (keep_k past 128), sorted, to its output
  RingTile prev = start;
  int prev_found = 0;
  unsigned prev_bound = 0;
  const auto emit = [&]() {
    int found = prev_found;
    if (found > RING_K) found = keep_k(cand, found, k, prev_bound);
    const int kk = min(k, found);
    const size_t out =
        (static_cast<size_t>(prev.row) * n_blocks + prev.blk) * k;
    float* out_v = vals + out;
    int* out_i = idx + out;
    if (found <= RING_K)
      sort_and_write<RING_K / 32>(cand, found, kk, prev.s, prev.base, out_v,
                                  out_i);
    else
      sort_and_write<RING_CAP / 32>(cand, found, kk, prev.s, prev.base,
                                    out_v, out_i);
    for (int at = kk + lane; at < k; at += 32) {  // past the live elements
      out_v[at] = -INFINITY;
      out_i[at] = prev.base;
    }
  };

  RingTile t = start;
  for (int i = 0; i < my_tiles; ++i, t.next(d_row, d_blk, n_blocks)) {
    t.at(scores, n_d, block_d);
    const float* slot = slot_of(i);
    const float* src = t.bulk ? slot : t.s;
    while (!mbar_done(bar0 + 8 * (i % RING_SLOTS), (i / RING_SLOTS) & 1)) {
    }
    // 1. each group's maximum (8 columns), as a key
    {
      float v[4 * R::VEC];
      ring_load<R::VEC>(v, slot, t.s, t.n, t.bulk);
#pragma unroll
      for (int h = 0; h < R::VEC / 2; ++h) {
        float m = v[8 * h];
#pragma unroll
        for (int e = 1; e < 8; ++e) m = fmaxf(m, v[8 * h + e]);
        gkeys[h * RING_NT + tid] = key_of(m);
      }
    }
    __syncthreads();
    // 2. warp 0: the bound, a key at or just below the k-th largest group
    //    maximum (so k keys lie at or above it); warp 1 meanwhile writes
    //    the previous tile's output
    if (warp == 0) {
      unsigned g[R::GROUPS / 32];
#pragma unroll
      for (int j = 0; j < R::GROUPS / 128; ++j) {
        const uint4 x = reinterpret_cast<const uint4*>(gkeys)[
            lane * (R::GROUPS / 128) + j];
        g[4 * j] = x.x;
        g[4 * j + 1] = x.y;
        g[4 * j + 2] = x.z;
        g[4 * j + 3] = x.w;
      }
      const unsigned b = warp_bound(g, static_cast<unsigned>(k));
      if (lane == 0) {
        sh.bound = b;
        sh.n_found = 0;
      }
    } else if (warp == 1 && i > 0) {
      emit();
    }
    __syncthreads();
    // 3. the survivors, keys at or above the bound (the elements at or
    //    above its value; a bound of 0 keeps every element above −inf):
    //    a warp scan places them, one shared atomic a warp
    const unsigned bound = sh.bound;
    {
      const float floor_v = bound == 0 ? -FLT_MAX : key_value(bound);
      float v[4 * R::VEC];
      ring_load<R::VEC>(v, slot, t.s, t.n, t.bulk);
      unsigned bits = 0;
#pragma unroll
      for (int e = 0; e < 4 * R::VEC; ++e)
        bits |= static_cast<unsigned>(v[e] >= floor_v) << e;
      const unsigned mine = __popc(bits);
      unsigned incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned x = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += x;
      }
      unsigned wbase = 0;
      if (lane == 31 && incl) wbase = atomicAdd(&sh.n_found, incl);
      unsigned pos = __shfl_sync(FULL, wbase, 31) + incl - mine;
      while (bits) {
        const int e = __ffs(bits) - 1;
        bits &= bits - 1;
        const int col = 4 * (tid + RING_NT * (e / 4)) + e % 4;
        if (pos < static_cast<unsigned>(RING_CAP))
          cand[pos] = entry(key_of(t.bulk ? slot[col] : t.s[col]), col);
        ++pos;
      }
    }
    __syncthreads();
    int found = static_cast<int>(sh.n_found);
    if (found > RING_CAP) {
      // 4. more than the buffer holds (heavy ties at the bound; k ≤ found
      //    elements above −inf): the tile's radix select, as the per-block
      //    kernel's, leaves the k largest in cand
      if (tid == 0) ++n_ties;
      __syncthreads();  // every thread has read n_found
      if (tid == 0) sh.n_found = 0;
      const Rank rank = radix_rank<RING_NT>(
          [&](auto count) {
            for (int c = tid; c < t.n; c += RING_NT) count(key_of(src[c]));
          },
          static_cast<unsigned>(k), sh.hist);
      take_ranked<RING_NT>([&](int c) { return key_of(src[c]); }, t.n, 0u,
                           rank, cand, &sh.n_found, sh.wsum);
      __syncthreads();
      found = k;
    } else if (tid == 0) {
      n_surv += found;
    }
    // the slot is read: the tile RING_SLOTS on takes it
    if (tid == 0 && i + RING_SLOTS < my_tiles) load(i + RING_SLOTS);
    prev = t;
    prev_found = found;
    prev_bound = bound;
  }
  if (warp == 1 && my_tiles > 0) emit();
  if (tid == 0) {
    if (n_surv) atomicAdd(survivors, n_surv);
    if (n_ties) atomicAdd(ties, n_ties);
  }
}

// The ring path's kernel: a second template of the name, over tiles of at
// most COLS columns.
template <int COLS>
__global__ void __launch_bounds__(RING_NT, RING_CTAS)
topk_blocks_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                   int* __restrict__ idx,
                   unsigned long long* __restrict__ ties,
                   unsigned long long* __restrict__ survivors, int n_q,
                   int n_d, int k, int block_d, int n_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  ring_tiles<COLS>(scores, vals, idx, ties, survivors, n_q, n_d, k, block_d,
                   n_blocks, smem, sh);
}

template <int NT, bool TILE>
__global__ void __launch_bounds__(NT)
topk_blocks_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                   int* __restrict__ idx,
                   unsigned long long* __restrict__ scratch,
                   unsigned long long* __restrict__ ties, int n_d, int k,
                   int block_d, int n_blocks, int p2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  constexpr int WARPS = NT / 32;
  const int tid = threadIdx.x, lane = tid % 32;
  const unsigned cta = blockIdx.x;
  const int row = static_cast<int>(cta / n_blocks);
  const int blk = static_cast<int>(cta % n_blocks);
  const int base = blk * block_d;
  const int n = min(block_d, n_d - base);
  const float* s = scores + static_cast<size_t>(row) * n_d + base;
  const int cap = cand_cap(p2, NT, block_d);
  unsigned* tile = reinterpret_cast<unsigned*>(smem);
  unsigned long long* cand =
      scratch != nullptr
          ? scratch + static_cast<size_t>(cta) * cap
          : reinterpret_cast<unsigned long long*>(
                smem + (TILE ? (static_cast<size_t>(block_d) * 4 + 15) / 16
                                   * 16 : 0));
  float* out_v = vals + static_cast<size_t>(cta) * k;
  int* out_i = idx + static_cast<size_t>(cta) * k;

  if (tid == 0) {
    sh.n_live = 0;
    sh.n_found = 0;
    sh.bound = 0xffffffffu;
  }

  // 1. the tile (raw bits, into shared memory), the count of elements above
  //    −inf and each thread's largest key
  unsigned live = 0, top = 0;
  if constexpr (TILE) {
    const int n4 = reinterpret_cast<uintptr_t>(s) % 16 == 0 ? n / 4 : 0;
#pragma unroll 4
    for (int i = tid; i < n4; i += NT) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(s) + i);
      const unsigned a = key_of(v.x), b = key_of(v.y), c = key_of(v.z),
                     d = key_of(v.w);
      live += (a != 0) + (b != 0) + (c != 0) + (d != 0);
      top = max(top, max(max(a, b), max(c, d)));
      reinterpret_cast<float4*>(tile)[i] = v;
    }
    for (int i = 4 * n4 + tid; i < n; i += NT) {
      const float v = __ldcs(s + i);
      const unsigned a = key_of(v);
      live += a != 0;
      top = max(top, a);
      tile[i] = __float_as_uint(v);
    }
  } else {
    for (int i = tid; i < n; i += NT) {
      const unsigned a = key_of(s[i]);
      live += a != 0;
      top = max(top, a);
    }
  }
  live = __reduce_add_sync(FULL, live);
  // A bound: each warp's c-th largest thread maximum, c = ⌈k / warps⌉, has
  // c of the warp's keys at or above it, so the smallest of these bounds
  // has c·warps ≥ k keys at or above it.
  const int c = (k + WARPS - 1) / WARPS;
  const bool bounded = c <= 32;
  unsigned my_bound = 0xffffffffu;
  if (bounded) {
    const unsigned t = warp_sort_desc(top);
    if (lane == c - 1) my_bound = t;
  }
  __syncthreads();  // sh initialised
  if (lane == 0 && live) atomicAdd(&sh.n_live, live);
  if (my_bound != 0xffffffffu) atomicMin(&sh.bound, my_bound);
  __syncthreads();
  const int kk = min(k, static_cast<int>(sh.n_live));
  for (int r = kk + tid; r < k; r += NT) {  // past the live elements
    out_v[r] = -INFINITY;
    out_i[r] = base;
  }
  if (kk == 0) return;

  const auto write = [&](int r, unsigned long long e) {
    out_v[r] = value_at<TILE>(tile, s, entry_col(e));
    out_i[r] = base + entry_col(e);
  };
  if (bounded) {
    // 2a. the keys at or above the bound (usually a few times k): count,
    //     place by a warp scan, write; when they fit, sort them all
    const unsigned bound = max(1u, sh.bound);
    unsigned mine = 0;
    for (int i = tid; i < n; i += NT) mine += key_at<TILE>(tile, s, i) >= bound;
    unsigned incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    unsigned wbase = 0;
    if (lane == 31 && incl) wbase = atomicAdd(&sh.n_found, incl);
    unsigned pos = __shfl_sync(FULL, wbase, 31) + incl - mine;
    if (mine) {
      for (int i = tid; i < n; i += NT) {
        const unsigned key = key_at<TILE>(tile, s, i);
        if (key >= bound) {
          if (pos < static_cast<unsigned>(cap)) cand[pos] = entry(key, i);
          ++pos;
        }
      }
    }
    __syncthreads();
    const int found = static_cast<int>(sh.n_found);
    if (found <= cap) {
      sort_and_emit<NT>(cand, found, kk, write);
      return;
    }
    __syncthreads();  // every thread has read n_found
    if (tid == 0) sh.n_found = 0;
    __syncthreads();
  }

  // 2. radix select of the kk-th largest key
  if (tid == 0) atomicAdd(ties, 1ull);
  const Rank rank = radix_rank<NT>(
      [&](auto count) {
        for (int i = tid; i < n; i += NT) count(key_at<TILE>(tile, s, i));
      },
      kk, sh.hist);
  // 3. survivors: the kk largest keys, ties to the lowest columns
  take_ranked<NT>([&](int i) { return key_at<TILE>(tile, s, i); }, n, 0u,
                  rank, cand, &sh.n_found, sh.wsum);
  __syncthreads();
  // 4. (key desc, column asc)
  sort_and_emit<NT>(cand, kk, kk, write);
}

// The main path's shape (block_d ≤ 1024, k ≤ 32): a warp per (row, block),
// the tile in registers (32 keys a lane), no block barriers.  The bound is
// the k-th largest lane maximum; the keys at or above it (usually 1–2·k)
// are sorted by shuffles.  More than 64 of them (heavy ties at the bound):
// kk rounds of "the largest entry after the last pick", exact as well.
constexpr int WARP_TILE = 1024;
constexpr int WARP_K = 32;
constexpr int WARP_CTA = 4;  // warps (tiles) a CTA
// 10 CTAs an SM (≤ 48 registers; a few keys spill to L1): the kernel is
// bound by the tiles in flight, and unbounded it takes 91 registers, which
// leaves room for 5
constexpr int WARP_CTAS_PER_SM = 10;

__global__ void __launch_bounds__(32 * WARP_CTA, WARP_CTAS_PER_SM)
topk_warp_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                 int* __restrict__ idx,
                 unsigned long long* __restrict__ ties, int n_q, int n_d,
                 int k, int block_d, int n_blocks) {
  __shared__ unsigned long long buf[WARP_CTA][64];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long tile_id = static_cast<long long>(blockIdx.x) * WARP_CTA + warp;
  if (tile_id >= static_cast<long long>(n_q) * n_blocks) return;
  const int row = static_cast<int>(tile_id / n_blocks);
  const int blk = static_cast<int>(tile_id % n_blocks);
  const int base = blk * block_d;
  const int n = min(block_d, n_d - base);
  const float* s = scores + static_cast<size_t>(row) * n_d + base;
  float* out_v = vals + tile_id * k;
  int* out_i = idx + tile_id * k;
  unsigned long long* cand = buf[warp];

  // element (j, c) of a lane is column 128·j + 4·lane + c
  unsigned key[32];
  const bool vec = reinterpret_cast<uintptr_t>(s) % 16 == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 128 * j + 4 * lane;
    if (vec && col + 3 < n) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(s + col));
      key[4 * j] = key_of(v.x);
      key[4 * j + 1] = key_of(v.y);
      key[4 * j + 2] = key_of(v.z);
      key[4 * j + 3] = key_of(v.w);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        key[4 * j + c] = col + c < n ? key_of(__ldcs(s + col + c)) : 0u;
    }
  }
  unsigned live = 0, top = 0;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    live += key[e] != 0;
    top = max(top, key[e]);
  }
  live = __reduce_add_sync(FULL, live);
  const int kk = min(k, static_cast<int>(live));
  if (lane >= kk && lane < k) {  // past the live elements
    out_v[lane] = -INFINITY;
    out_i[lane] = base;
  }
  if (kk == 0) return;

  // k lanes hold a key ≥ the k-th largest lane maximum
  const unsigned bound =
      max(1u, __shfl_sync(FULL, warp_sort_desc(top), k - 1));
  unsigned mine = 0;
#pragma unroll
  for (int e = 0; e < 32; ++e) mine += key[e] >= bound;
  unsigned incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  const int found = static_cast<int>(__shfl_sync(FULL, incl, 31));
  unsigned long long best;
  if (found <= 64) {
    unsigned pos = incl - mine;
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if (key[e] >= bound)
        cand[pos++] = entry(key[e], 128 * (e / 4) + 4 * lane + e % 4);
    __syncwarp();
    unsigned long long v0 = lane < found ? cand[lane] : 0ull;
    if (found <= 32) {
      best = warp_sort_desc(v0);
    } else {  // 64 entries: lane and lane + 32
      unsigned long long v1 = lane + 32 < found ? cand[lane + 32] : 0ull;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
        v0 = merge_in_warp(v0, lane, size);
        v1 = merge_in_warp(v1, lane + 32, size);
      }
      v0 = v0 > v1 ? v0 : v1;  // stride 32 of the last merge; v0 the larger
      best = merge_in_warp(v0, lane, 64);
    }
  } else {
    // rounds: lane r keeps the r-th pick
    if (lane == 0) atomicAdd(ties, 1ull);
    unsigned long long last = ~0ull;
    best = 0;
    for (int r = 0; r < kk; ++r) {
      unsigned long long m = 0;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const unsigned long long x =
            entry(key[e], 128 * (e / 4) + 4 * lane + e % 4);
        if (key[e] != 0 && x < last && x > m) m = x;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(FULL, m, off);
        m = o > m ? o : m;
      }
      if (lane == r) best = m;
      last = m;
    }
  }
  if (lane < kk) {
    const int col = entry_col(best);
    out_v[lane] = value_of(static_cast<unsigned>(best >> 32), s, col);
    out_i[lane] = base + col;
  }
}

template <int NT, bool TILE>
int launch(const void* scores, void* vals, void* idx, void* scratch,
           void* ties, int n_q, int n_d, int k, int block_d, int n_blocks,
           int p2, cudaStream_t stream) {
  auto kern = topk_blocks_kernel<NT, TILE>;
  const size_t smem = smem_bytes(TILE, block_d, cand_cap(p2, NT, block_d),
                                 scratch == nullptr);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = static_cast<long long>(n_q) * n_blocks;
  if (ctas > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kern<<<static_cast<unsigned>(ctas), NT, smem, stream>>>(
      static_cast<const float*>(scores), static_cast<float*>(vals),
      static_cast<int*>(idx), static_cast<unsigned long long*>(scratch),
      static_cast<unsigned long long*>(ties), n_d, k, block_d, n_blocks, p2);
  return static_cast<int>(cudaGetLastError());
}

// the ring path: as many CTAs as the card holds at once, at most a tile
// each.  The kernel's attributes are set, and the CTAs a device holds
// found, at the first call on that device, not at every launch.
constexpr int MAX_DEVICES = 64;

template <int COLS>
int launch_ring(const void* scores, void* vals, void* idx, void* ties,
                void* survivors, int n_q, int n_d, int k, int block_d,
                int n_blocks, cudaStream_t stream) {
  void (*kern)(const float*, float*, int*, unsigned long long*,
               unsigned long long*, int, int, int, int, int) =
      topk_blocks_kernel<COLS>;
  const int smem = Ring<COLS>::BYTES;
  static std::atomic<int> resident_on[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = dev < MAX_DEVICES ? resident_on[dev].load() : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          RING_NT, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < MAX_DEVICES) resident_on[dev].store(resident);
  }
  const long long tiles = static_cast<long long>(n_q) * n_blocks;
  const long long ctas = tiles < resident ? tiles : resident;
  kern<<<static_cast<unsigned>(ctas), RING_NT, smem, stream>>>(
      static_cast<const float*>(scores), static_cast<float*>(vals),
      static_cast<int*>(idx), static_cast<unsigned long long*>(ties),
      static_cast<unsigned long long*>(survivors), n_q, n_d, k, block_d,
      n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Stage 2: topk_merge_kernel (the header's first note), a CTA a query row.

constexpr int MERGE_NT = 256;

// the length of a list's run of keys ≥ tau (keys descend along a list):
// gallop from the head, then bisect
__device__ __forceinline__ int run_at_least(const float* list, int k,
                                            unsigned tau) {
  int lo = 0, hi = k;
  for (int p = 0, step = 1; p < k; p += step, step <<= 1) {
    if (key_of(__ldg(list + p)) < tau) {
      hi = p;
      break;
    }
    lo = p + 1;
  }
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (key_of(__ldg(list + mid)) >= tau)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int NT>
__global__ void __launch_bounds__(NT)
topk_merge_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                  float* __restrict__ out_v, long long* __restrict__ out_i,
                  unsigned long long* __restrict__ scratch,
                  unsigned long long* __restrict__ ties, int n_lists, int k,
                  int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int n = n_lists * k;
  const size_t row = blockIdx.x;
  const float* v = vals + row * n;
  const int* id = ids + row * n;
  float* ov = out_v + row * k;
  long long* oi = out_i + row * k;
  unsigned long long* cand =
      scratch != nullptr ? scratch + row * cap
                         : reinterpret_cast<unsigned long long*>(smem);
  if (tid == 0) sh.n_found = 0;

  // 1. τ₀: the k-th largest of the heads, each list's first c entries
  const int c = (k + n_lists - 1) / n_lists;
  const int n_heads = n_lists * c;
  const Rank head = radix_rank<NT>(
      [&](auto count) {
        for (int h = tid; h < n_heads; h += NT)
          count(key_of(__ldg(v + static_cast<size_t>(h / c) * k + h % c)));
      },
      k, sh.hist);
  const unsigned tau = max(1u, head.prefix << head.shift);

  // 2. each list's run at or above τ, placed by a shared count
  for (int l = tid; l < n_lists; l += NT) {
    const float* list = v + static_cast<size_t>(l) * k;
    const int m = run_at_least(list, k, tau);
    if (m == 0) continue;
    const unsigned at = atomicAdd(&sh.n_found, static_cast<unsigned>(m));
    const int room = at < static_cast<unsigned>(cap)
                         ? min(m, cap - static_cast<int>(at)) : 0;
    for (int j = 0; j < room; ++j)
      cand[at + j] = entry(key_of(__ldg(list + j)), l * k + j);
  }
  __syncthreads();
  int found = static_cast<int>(sh.n_found);

  if (found > cap) {
    // 3. more than the buffer holds: the row's k largest among the entries
    //    at or above τ, ties to the lowest positions
    if (tid == 0) atomicAdd(ties, 1ull);
    const Rank kth = radix_rank<NT>(
        [&](auto count) {
          for (int p = tid; p < n; p += NT) {
            const unsigned key = key_of(__ldg(v + p));
            if (key >= tau) count(key);
          }
        },
        k, sh.hist);
    if (tid == 0) sh.n_found = 0;
    __syncthreads();
    take_ranked<NT>([&](int p) { return key_of(__ldg(v + p)); }, n, tau, kth,
                    cand, &sh.n_found, sh.wsum);
    __syncthreads();
    found = k;
  }

  // 4. (key desc, position asc); raw value bits, ids read for these alone
  sort_and_emit<NT>(cand, found, min(k, found),
                    [&](int r, unsigned long long e) {
                      const int p = entry_col(e);
                      ov[r] = v[p];
                      oi[r] = id[p];
                    });

  if (found < k) {
    // 5. fewer than k entries above −inf (τ₀ was 0, τ 1): the −inf entries
    //    next, in position order; contiguous lists a thread, so a prefix
    //    count over threads runs in position order
    const int per = (n_lists + NT - 1) / NT;
    const int l0 = min(n_lists, tid * per);
    const int l1 = min(n_lists, l0 + per);
    unsigned pads = 0;
    for (int l = l0; l < l1; ++l)
      pads += k - run_at_least(v + static_cast<size_t>(l) * k, k, 1u);
    unsigned r = block_exclusive_scan<NT>(pads, sh.wsum);
    const unsigned need = static_cast<unsigned>(k - found);
    for (int l = l0; l < l1 && r < need; ++l) {
      const int base = l * k;
      for (int j = run_at_least(v + base, k, 1u); j < k && r < need;
           ++j, ++r) {
        ov[found + r] = v[base + j];
        oi[found + r] = id[base + j];
      }
    }
  }
}

}  // namespace

// p2: the survivors' sort length, the power of two ≥ min(k, block_d);
// scratch: null (sort in shared memory) or n_q·n_blocks·p2 uint64 entries;
// ties: one uint64 that each tile on the tie path adds 1 to; survivors:
// one uint64 that the ring path adds its tiles' survivors at the bound to.
extern "C" int topk_blocks_launch(const void* scores, void* vals, void* idx,
                                  void* scratch, void* ties, void* survivors,
                                  int n_q, int n_d, int k, int block_d,
                                  int n_blocks, int p2, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (block_d <= WARP_TILE && k <= WARP_K) {
    const long long tiles = static_cast<long long>(n_q) * n_blocks;
    const long long ctas = (tiles + WARP_CTA - 1) / WARP_CTA;
    if (ctas > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    topk_warp_kernel<<<static_cast<unsigned>(ctas), 32 * WARP_CTA, 0, st>>>(
        static_cast<const float*>(scores), static_cast<float*>(vals),
        static_cast<int*>(idx), static_cast<unsigned long long*>(ties), n_q,
        n_d, k, block_d, n_blocks);
    return static_cast<int>(cudaGetLastError());
  }
  if (k > WARP_K && k <= RING_K && block_d <= RING_COLS) {
    if (block_d <= RING_COLS / 2)
      return launch_ring<RING_COLS / 2>(scores, vals, idx, ties, survivors,
                                        n_q, n_d, k, block_d, n_blocks, st);
    return launch_ring<RING_COLS>(scores, vals, idx, ties, survivors, n_q,
                                  n_d, k, block_d, n_blocks, st);
  }
  if (block_d > MAX_TILE)
    return launch<512, false>(scores, vals, idx, scratch, ties, n_q,
                              n_d, k, block_d, n_blocks, p2, st);
  if (block_d > 8192)
    return launch<512, true>(scores, vals, idx, scratch, ties, n_q, n_d, k,
                             block_d, n_blocks, p2, st);
  if (block_d > 2048)
    return launch<256, true>(scores, vals, idx, scratch, ties, n_q, n_d, k,
                             block_d, n_blocks, p2, st);
  return launch<128, true>(scores, vals, idx, scratch, ties, n_q, n_d, k,
                           block_d, n_blocks, p2, st);
}

// cap: the survivors' buffer, a power of two ≥ k; scratch: null (the buffer
// in shared memory) or n_q·cap uint64 entries; ties: one uint64 that each
// row on the exact path adds 1 to.
extern "C" int topk_merge_launch(const void* vals, const void* ids,
                                 void* out_v, void* out_i, void* scratch,
                                 void* ties, int n_q, int n_lists, int k,
                                 int cap, void* stream) {
  auto kern = topk_merge_kernel<MERGE_NT>;
  const size_t smem =
      scratch == nullptr ? static_cast<size_t>(cap) * 8 : 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(n_q), MERGE_NT, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(ids),
      static_cast<float*>(out_v), static_cast<long long*>(out_i),
      static_cast<unsigned long long*>(scratch),
      static_cast<unsigned long long*>(ties), n_lists, k, cap);
  return static_cast<int>(cudaGetLastError());
}
