// Fused IVF search: for each query, its nprobe probed inverted lists are
// gathered from the list-major storage, scored per backend, shifted by a
// per-(query, probe) base, pad rows masked, and ranked into a top-k in the
// strict (score desc, id asc) order.
//
// Replaces src/repro/kernels/ivf_fused/kernel.py::fused_ivf_topk_pallas
// (grid body _fused_ivf_kernel, scoring score_block, merge
// repro/retrieval/topk.py::merge_topk_block).  The Pallas kernel walks a
// (query, probe) grid and re-reads a list for every query that probes it.
// The order is strict and total and the base is per (query, slot), so the
// answer depends only on the set of (score, id) pairs that each (query,
// slot) pair contributes; here the work is reorganised around lists,
// in three stages (five launches on the wrapper's stream):
//
// (a) invert the probe table: count the pairs of each list, scan the
//     counts (and the groups of G pairs) in one CTA, scatter each pair
//     (query·nprobe + slot) into its list's segment.  A query that probes
//     a list twice gives two pairs, as the Pallas grid scores it twice.
// (b) score each list once for its pairs: a CTA takes one list and up to
//     G = 32 of its pairs (their queries and bases in shared memory) and
//     streams the list's rows through shared memory, 128 rows × 128 bytes
//     a stage, double-buffered with cp.async.  Each row is scored against
//     every query of the group:
//       int8        : bf16(q⊙scale) × u8 on the tensor cores
//                     (mma.sync.m16n8k16, int8_ip.cu's fragments: u8 →
//                     bf16 in registers, each product exact in f32);
//       float, fp16 : f32 FMAs in element order, as the plain version;
//       1-bit       : 0.25f·(32·W − 2·Σ popc(qword ⊕ xword)), bit-exact
//                     (query words packed here from the ±1 signs, padded
//                     with −1: bit 0).
//     Then score + base, then −inf (and id −1) where the row's id < 0, in
//     that order, so that 1-bit score bits match the plain version.  Each
//     pair keeps its candidates in a (Q, nprobe, m) buffer the wrapper
//     allocates: for k < L and k ≤ 32 its top-k (m = k), kept in a warp's
//     registers, a lane an entry: a tile's rows that beat the k-th entry
//     are inserted one by one (ballot and shuffles), or, when more than
//     SORT_AT of 32 do, sorted by the warp and merged as a bitonic
//     sequence; otherwise every row of the list (m = L), which holds its
//     top-min(k, L).
// (c) merge per query, a CTA each: the query's nprobe·m candidates are
//     read ROUND at a time; those that come before the running k-th entry
//     are gathered (warp-aggregated) in shared memory, and once more than
//     TILE − ROUND are waiting they are sorted (a bitonic sort of TILE
//     entries held 8 a thread in registers) and merged with the running
//     top-k by rank: each entry lands at its index plus the count of the
//     other list's entries ahead of it.  Up to MAX_K (1024, the
//     wrapper's) the running top-k sits in shared memory; above it in a
//     (Q, 2k) global scratch, read once a merge.  Slots of invalid probes
//     (outside [0, nlist)) are skipped; unfilled slots are (−inf, −1).
//
// Bound on an H100 SXM (3.35 TB/s): at Q=256, nprobe=64, 1024 lists of
// L≈1221 rows, int8 d=128, the distinct probed lists' rows and ids (at
// most 1024·1221·132 B = 0.165 GB) plus queries, probes and base take
// ~0.05 ms; the 2·Q·nprobe·L·d = 5.1 GOP of scoring take 0.005 ms at the
// bf16 tensor-core rate — the bytes bound it.  Stage (b) reads each list
// once per group of 32 of its pairs (once at nprobe 64, 2.5 times at
// nprobe 256 with Q = 256); the candidate buffer at k = 10 is
// Q·nprobe·10·8 B (1.3 MB).  What it costs instead is the selection in
// (b) (latency-bound warp shuffles) and, for k ≥ L, the merge's sorts.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma_util.cuh"

namespace {

using namespace mma_util;

constexpr int THREADS = 256;
constexpr int G = 32;         // (query, slot) pairs a scoring CTA
constexpr int TR = 128;       // list rows a tile
constexpr int CH = 128;       // bytes of a row a stage
constexpr int STS = TR + 4;   // score tile row stride (floats)
constexpr int KSEL = 32;      // a warp keeps a pair's top-m for m ≤ KSEL
constexpr int SORT_AT = 6;    // more survivors of 32 rows: sort, not insert
constexpr int TILE = 2048;    // survivors a merge takes
constexpr int ROUND = 1024;   // candidates read between merge checks
static_assert(TILE == 8 * THREADS, "the sort holds 8 entries a thread");
constexpr int SCAN = 1024;    // threads of the scan
constexpr int MAX_KP = 2048;  // int8 query width in shared memory
constexpr int MAX_W = 1024;   // float / fp16 elements, 1-bit words

enum Backend { kFloat = 0, kFp16 = 1, kInt8 = 2, kOneBit = 3 };

// (v, i) comes before (bv, bi) in the (score desc, id asc) order
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// Σ qs[e]·x[e] over the 16 bytes in u (4 f32 or 8 f16 elements)
__device__ __forceinline__ float dot16(const float* qs, uint4 u, float acc,
                                       float) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) acc = fmaf(qs[j], __uint_as_float(v[j]), acc);
  return acc;
}
__device__ __forceinline__ float dot16(const float* qs, uint4 u, float acc,
                                       __half) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&v[j]));
    acc = fmaf(qs[2 * j], f.x, acc);
    acc = fmaf(qs[2 * j + 1], f.y, acc);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// (a) invert the probe table.  work = cnt[nlist] | off[nlist + 1] |
// goff[nlist + 1] | pairs[n_pairs] | glist | gp0 | gnp [max_groups]
// ---------------------------------------------------------------------------

__global__ void ivf_invert_count(const int* __restrict__ probes, int n_pairs,
                                 int nlist, int* __restrict__ cnt) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_pairs;
       e += gridDim.x * blockDim.x) {
    const int lid = probes[e];
    if (lid >= 0 && lid < nlist) atomicAdd(cnt + lid, 1);
  }
}

// exclusive scans of the pair counts (off) and of the groups of G pairs
// (goff), with the totals at [nlist], and each group's list, first pair
// and pair count; cnt is zeroed for the scatter
__global__ void __launch_bounds__(SCAN)
ivf_invert_scan(int* __restrict__ cnt, int* __restrict__ off,
                int* __restrict__ goff, int* __restrict__ glist,
                int* __restrict__ gp0, int* __restrict__ gnp, int nlist) {
  __shared__ int sp[SCAN], sg[SCAN];
  __shared__ int carry[2];
  const int tid = threadIdx.x;
  if (tid == 0) carry[0] = carry[1] = 0;
  for (int b0 = 0; b0 < nlist; b0 += SCAN) {
    const int l = b0 + tid;
    const int c = l < nlist ? cnt[l] : 0;
    const int gc = (c + G - 1) / G;
    sp[tid] = c;
    sg[tid] = gc;
    __syncthreads();
    for (int s = 1; s < SCAN; s <<= 1) {  // inclusive, Hillis–Steele
      const int a = tid >= s ? sp[tid - s] : 0;
      const int b = tid >= s ? sg[tid - s] : 0;
      __syncthreads();
      sp[tid] += a;
      sg[tid] += b;
      __syncthreads();
    }
    if (l < nlist) {
      const int o = carry[0] + sp[tid] - c, go = carry[1] + sg[tid] - gc;
      off[l] = o;
      goff[l] = go;
      cnt[l] = 0;
      for (int j = 0; j < gc; ++j) {  // the list's groups: list, first pair
        glist[go + j] = l;
        gp0[go + j] = o + j * G;
        gnp[go + j] = min(G, c - j * G);
      }
    }
    __syncthreads();
    if (tid == SCAN - 1) {
      carry[0] += sp[tid];
      carry[1] += sg[tid];
    }
    __syncthreads();
  }
  if (tid == 0) {
    off[nlist] = carry[0];
    goff[nlist] = carry[1];
  }
}

__global__ void ivf_invert_scatter(const int* __restrict__ probes,
                                   int n_pairs, int nlist,
                                   const int* __restrict__ off,
                                   int* __restrict__ fill,
                                   int* __restrict__ pairs) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_pairs;
       e += gridDim.x * blockDim.x) {
    const int lid = probes[e];
    if (lid >= 0 && lid < nlist) pairs[off[lid] + atomicAdd(fill + lid, 1)] = e;
  }
}

// ---------------------------------------------------------------------------
// (b) score each list once for a group of its pairs
// ---------------------------------------------------------------------------

// one bitonic compare-exchange step across lanes lane and lane ^ stride:
// within runs of ``size`` lanes the better entry goes to the lower lane
// when the run sorts forward ((lane & size) == 0)
__device__ __forceinline__ void warp_cas(float& v, int& id, int size,
                                         int stride) {
  const int lane = threadIdx.x % 32;
  const float ov = __shfl_xor_sync(0xffffffffu, v, stride);
  const int oi = __shfl_xor_sync(0xffffffffu, id, stride);
  const bool want_better = ((lane & size) == 0) == ((lane & stride) == 0);
  if (want_better ? before(ov, oi, v, id) : before(v, id, ov, oi)) {
    v = ov;
    id = oi;
  }
}

// sort a warp's 32 entries in the (score desc, id asc) order, lane 0 first
__device__ __forceinline__ void warp_sort(float& v, int& id) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      warp_cas(v, id, size, stride);
}

// e (sorted, lanes < m real) ← the best m of e and the sorted c: the
// better of e[lane] and c[31 − lane] is a bitonic sequence holding the
// best 32 of both, and one bitonic merge sorts it
__device__ __forceinline__ void merge_top32(float& ev, int& ei, float cv,
                                            int ci, int m) {
  const int lane = threadIdx.x % 32;
  const float rv = __shfl_sync(0xffffffffu, cv, 31 - lane);
  const int ri = __shfl_sync(0xffffffffu, ci, 31 - lane);
  if (lane >= m || before(rv, ri, ev, ei)) {
    ev = rv;
    ei = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) warp_cas(ev, ei, 32, stride);
}

// physical 16-byte slot of logical slot s in stage row r.  Eight
// consecutive rows put one logical slot in eight distinct slots (a
// thread-per-row read), and rows 2i, 2i+1 put slots 0–3 (or 4–7) in
// opposite halves (the int8 mma's reads): no bank conflicts either way.
__device__ __forceinline__ int swz(int r, int s) {
  return s ^ (((r & 1) << 2) | ((r >> 1) & 3));
}

// [stage: 2 × TR × CH][scores: G × STS f32][row ids: 2 × TR][pair: G]
// [base: G f32][queries: int8 G × (2·kp + 8) bytes of bf16, else G × w
// f32 or words]
constexpr size_t SMEM_FIXED = 2 * TR * CH + sizeof(float) * G * STS +
                              sizeof(int) * 2 * TR + 2 * sizeof(int) * G;

size_t score_smem(int backend, int w, int kp) {
  const size_t qbytes = backend == kInt8
      ? static_cast<size_t>(G) * (2 * kp + 8)
      : static_cast<size_t>(G) * w * 4;
  return SMEM_FIXED + qbytes;
}

// the scoring launch's arguments: work is (a)'s int32 buffer, cand_v /
// cand_i the (n_q, nprobe, m) candidates, kp the int8 width padded to 64
struct ScoreArgs {
  const void* q;
  const void* storage;
  const int* list_ids;
  const float* base;
  const int* work;
  float* cand_v;
  int* cand_i;
  int n_pairs, max_groups, nprobe, nlist, L, w, m, kp;
};

template <int B, typename T, int V>
__global__ void __launch_bounds__(THREADS)
ivf_score_lists(const ScoreArgs a) {
  const void* __restrict__ q = a.q;
  const T* __restrict__ storage = static_cast<const T*>(a.storage);
  const int* __restrict__ list_ids = a.list_ids;
  float* __restrict__ cand_v = a.cand_v;
  int* __restrict__ cand_i = a.cand_i;
  const int nprobe = a.nprobe, nlist = a.nlist, L = a.L, w = a.w, m = a.m,
            kp = a.kp;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;
  float* S = reinterpret_cast<float*>(stage + 2 * TR * CH);
  int* sid = reinterpret_cast<int*>(S + G * STS);
  int* ppair = sid + 2 * TR;
  float* pbase = reinterpret_cast<float*>(ppair + G);
  unsigned char* qs = reinterpret_cast<unsigned char*>(pbase + G);

  const int* goff = a.work + 2 * nlist + 1;
  const int* pairs = goff + nlist + 1;
  const int* glist = pairs + a.n_pairs;
  const int bid = blockIdx.x;
  if (bid >= goff[nlist]) return;  // the grid is an upper bound
  const int lid = glist[bid];
  const int p0 = glist[a.max_groups + bid];
  const int np = glist[2 * a.max_groups + bid];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid < G) {
    const int pr = tid < np ? pairs[p0 + tid] : 0;
    ppair[tid] = pr;
    pbase[tid] = tid < np ? a.base[pr] : 0.f;
  }
  __syncthreads();
  // the group's queries; absent pairs and dims past w are zero
  if constexpr (B == kInt8) {
    const uint16_t* q16 = static_cast<const uint16_t*>(q);
    const int sq = 2 * kp + 8;
    for (int e = tid; e < G * kp; e += THREADS) {
      const int r = e / kp, c = e % kp;
      const uint16_t v = (r < np && c < w)
          ? q16[static_cast<size_t>(ppair[r] / nprobe) * w + c] : 0;
      *reinterpret_cast<uint16_t*>(qs + r * sq + 2 * c) = v;
    }
  } else if constexpr (B == kOneBit) {
    // ±1 int8 signs → words, bit b of word c the sign of dim 32c + b
    // (set where the sign is +1), as pack_bits packs the documents
    const uint32_t* q32 = static_cast<const uint32_t*>(q);
    for (int e = tid; e < G * w; e += THREADS) {
      const int r = e / w, c = e % w;
      uint32_t word = 0;
      if (r < np) {
        const uint32_t* src =
            q32 + (static_cast<size_t>(ppair[r] / nprobe) * w + c) * 8;
#pragma unroll
        for (int t4 = 0; t4 < 8; ++t4) {
          const uint32_t neg = src[t4] & 0x80808080u;  // sign bits of 4
#pragma unroll
          for (int j = 0; j < 4; ++j)
            word |= ((~neg >> (8 * j + 7)) & 1u) << (4 * t4 + j);
        }
      }
      reinterpret_cast<uint32_t*>(qs)[e] = word;
    }
  } else {
    const uint32_t* q32 = static_cast<const uint32_t*>(q);
    for (int e = tid; e < G * w; e += THREADS) {
      const int r = e / w, c = e % w;
      reinterpret_cast<uint32_t*>(qs)[e] =
          r < np ? q32[static_cast<size_t>(ppair[r] / nprobe) * w + c] : 0u;
    }
  }

  const int row_bytes = w * static_cast<int>(sizeof(T));
  const int n_kc = (row_bytes + CH - 1) / CH;
  const int n_tiles = (L + TR - 1) / TR;
  const int steps = n_tiles * n_kc;
  const unsigned char* list0 = reinterpret_cast<const unsigned char*>(
      storage + static_cast<size_t>(lid) * L * w);

  auto load_stage = [&](int p) {
    const int tile = p / n_kc, c = p % n_kc;
    const int rows = min(TR, L - tile * TR);
    const int per_row = min(CH, row_bytes - CH * c) / V;
    unsigned char* buf = stage + (p & 1) * TR * CH;
    const unsigned char* src0 =
        list0 + static_cast<size_t>(tile) * TR * row_bytes + CH * c;
    if (c == 0 && tid < rows)  // the tile's ids, with its first stage
      copy_async<4>(sid + (tile & 1) * TR + tid,
                    reinterpret_cast<const uint8_t*>(
                        list_ids + static_cast<size_t>(lid) * L +
                        tile * TR + tid));
    for (int e = tid; e < rows * per_row; e += THREADS) {
      const int r = e / per_row, b = (e % per_row) * V;
      copy_async<V>(buf + r * CH + swz(r, b / 16) * 16 + b % 16,
                    src0 + static_cast<size_t>(r) * row_bytes + b);
    }
  };

  // per-backend accumulators: int8 a warp's 16 queries × 32 rows in mma
  // fragments; the others a thread's row against 16 queries
  constexpr int NACC = B == kInt8 ? 16 : G / 2;
  float acc[NACC];
  int pop[B == kOneBit ? G / 2 : 1];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (B == kOneBit ? G / 2 : 1); ++i) pop[i] = 0;

  // a pair's running top-m (m ≤ KSEL): lane i holds entry i, for the
  // warp's pairs warp, warp + 8, warp + 16, warp + 24
  const bool select = m < L;
  float ev[G / 8];
  int ei[G / 8];
#pragma unroll
  for (int i = 0; i < G / 8; ++i) {
    ev[i] = -INFINITY;
    ei[i] = -1;
  }

  if (steps > 0) {
    load_stage(0);
    cp_commit();
  }
  for (int p = 0; p < steps; ++p) {
    if (p + 1 < steps) {
      load_stage(p + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    const int tile = p / n_kc, c = p % n_kc;
    const int rows = min(TR, L - tile * TR);
    __syncthreads();  // stage p (and, first, the queries) are in place
    const unsigned char* buf = stage + (p & 1) * TR * CH;

    if constexpr (B == kInt8) {
      const int wm = warp / 4, wn = warp % 4;
      const int g = lane / 4, t = lane % 4;
      const int sq = 2 * kp + 8;
      // a warp whose 16 queries are all absent skips the product
      const int groups = wm * 16 < np ? min(2, kp / 64 - 2 * c) : 0;
      for (int gi = 0; gi < groups; ++gi) {
        uint4 braw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = wn * 32 + j * 8 + g;
          braw[j] = *reinterpret_cast<const uint4*>(
              buf + row * CH + swz(row, 4 * gi + t) * 16);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int kq = 128 * c + 64 * gi + 16 * t + 4 * s;
          const unsigned char* qa = qs + (wm * 16 + g) * sq + 2 * kq;
          const uint2 qlo = *reinterpret_cast<const uint2*>(qa);
          const uint2 qhi = *reinterpret_cast<const uint2*>(qa + 8 * sq);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t wd = s == 0 ? braw[j].x : s == 1 ? braw[j].y
                              : s == 2 ? braw[j].z : braw[j].w;
            mma_bf16(acc + 4 * j, qlo.x, qhi.x, qlo.y, qhi.y,
                     u8x2_to_bf16x2(wd, 0), u8x2_to_bf16x2(wd, 2));
          }
        }
      }
      if (c == n_kc - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* s0 = S + (wm * 16 + g) * STS + wn * 32 + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(s0) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(s0 + 8 * STS) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
      }
    } else {
      // thread: row tid % TR against queries h·16 … h·16 + 15
      constexpr int PER = 16 / sizeof(T);
      const int r = tid % TR, h = tid / TR;
      const int e0 = c * (CH / static_cast<int>(sizeof(T)));
      // a thread whose 16 queries are all absent skips the product
      const int ne = h * (G / 2) < np
          ? min(CH, row_bytes - CH * c) / static_cast<int>(sizeof(T)) : 0;
      const int ns = ne / PER;
      const unsigned char* rowp = buf + r * CH;
      for (int s = 0; s < ns; ++s) {
        const uint4 u = *reinterpret_cast<const uint4*>(rowp + swz(r, s) * 16);
        const int eq = e0 + s * PER;
        if constexpr (B == kOneBit) {
          const uint32_t* qw = reinterpret_cast<const uint32_t*>(qs);
#pragma unroll
          for (int i = 0; i < G / 2; ++i) {
            const uint32_t* qq = qw + (h * (G / 2) + i) * w + eq;
            // 16-byte query loads where the query rows are 16 bytes apart
            const uint4 qv = w % 4 == 0
                ? *reinterpret_cast<const uint4*>(qq)
                : make_uint4(qq[0], qq[1], qq[2], qq[3]);
            pop[i] += __popc(qv.x ^ u.x) + __popc(qv.y ^ u.y) +
                      __popc(qv.z ^ u.z) + __popc(qv.w ^ u.w);
          }
        } else {
          const float* qf = reinterpret_cast<const float*>(qs);
#pragma unroll
          for (int i = 0; i < G / 2; ++i)
            acc[i] = dot16(qf + (h * (G / 2) + i) * w + eq, u, acc[i], T());
        }
      }
      for (int e = ns * PER; e < ne; ++e) {
        const T x = *reinterpret_cast<const T*>(
            rowp + swz(r, e / PER) * 16 + (e % PER) * sizeof(T));
        if constexpr (B == kOneBit) {
          const uint32_t* qw = reinterpret_cast<const uint32_t*>(qs);
#pragma unroll
          for (int i = 0; i < G / 2; ++i)
            pop[i] += __popc(qw[(h * (G / 2) + i) * w + e0 + e] ^ x);
        } else {
          const float* qf = reinterpret_cast<const float*>(qs);
#pragma unroll
          for (int i = 0; i < G / 2; ++i)
            acc[i] = fmaf(qf[(h * (G / 2) + i) * w + e0 + e], widen(x),
                          acc[i]);
        }
      }
      if (c == n_kc - 1) {
#pragma unroll
        for (int i = 0; i < G / 2; ++i) {
          float v;
          if constexpr (B == kOneBit) {
            // 0.25·dot is exact; the base is added as a separate rounding
            v = __fmul_rn(0.25f, static_cast<float>(32 * w - 2 * pop[i]));
            pop[i] = 0;
          } else {
            v = acc[i];
            acc[i] = 0.f;
          }
          S[(h * (G / 2) + i) * STS + r] = v;
        }
      }
    }

    if (c == n_kc - 1) {
      __syncthreads();  // the tile's scores are in place
      const int r0 = tile * TR;
      const int* tids = sid + (tile & 1) * TR;
      if (!select) {
        // every row: the candidates of pair pp are the list's L rows
        for (int e = tid; e < np * TR; e += THREADS) {
          const int pp = e / TR, r = e % TR;
          if (r >= rows) continue;
          const int id = tids[r];
          const float s = __fadd_rn(S[pp * STS + r], pbase[pp]);
          const size_t o = static_cast<size_t>(ppair[pp]) * m + r0 + r;
          cand_v[o] = id >= 0 ? s : -INFINITY;
          cand_i[o] = id >= 0 ? id : -1;
        }
      } else {
#pragma unroll
        for (int i = 0; i < G / 8; ++i) {
          const int pp = warp + 8 * i;
          if (pp >= np) continue;  // uniform across the warp
          // the tile's rows, 4 a lane, all tested against the k-th entry
          // as it stood before the tile (a superset of the survivors)
          float v[TR / 32];
          int id[TR / 32];
          unsigned surv[TR / 32];
          const float kv = __shfl_sync(0xffffffffu, ev[i], m - 1);
          const int ki = __shfl_sync(0xffffffffu, ei[i], m - 1);
#pragma unroll
          for (int u = 0; u < TR / 32; ++u) {
            const int r = 32 * u + lane;
            v[u] = -INFINITY;
            id[u] = -1;
            if (r < rows && tids[r] >= 0) {
              v[u] = __fadd_rn(S[pp * STS + r], pbase[pp]);
              id[u] = tids[r];
            }
            surv[u] = __ballot_sync(0xffffffffu, before(v[u], id[u], kv, ki));
          }
#pragma unroll
          for (int u = 0; u < TR / 32; ++u) {
            if (__popc(surv[u]) > SORT_AT) {
              // many: sort the 32 rows, then keep the best m of both
              float sv = v[u];
              int si = id[u];
              warp_sort(sv, si);
              merge_top32(ev[i], ei[i], sv, si, m);
              continue;
            }
            while (surv[u]) {  // few: insert them one at a time
              const int src = __ffs(surv[u]) - 1;
              surv[u] &= surv[u] - 1;
              const float cv = __shfl_sync(0xffffffffu, v[u], src);
              const int ci = __shfl_sync(0xffffffffu, id[u], src);
              const int pos = __popc(__ballot_sync(
                  0xffffffffu, lane < m && before(ev[i], ei[i], cv, ci)));
              const float uv = __shfl_up_sync(0xffffffffu, ev[i], 1);
              const int ui = __shfl_up_sync(0xffffffffu, ei[i], 1);
              if (pos < m) {  // uniform: pos is the warp's
                if (lane == pos) {
                  ev[i] = cv;
                  ei[i] = ci;
                } else if (lane > pos) {
                  ev[i] = uv;
                  ei[i] = ui;
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();  // stage p, the scores and ids are read
  }
  if (select) {
#pragma unroll
    for (int i = 0; i < G / 8; ++i) {
      const int pp = warp + 8 * i;
      if (pp < np && lane < m) {
        const size_t o = static_cast<size_t>(ppair[pp]) * m + lane;
        cand_v[o] = ev[i];
        cand_i[o] = ei[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (c) merge each query's nprobe·m candidates into its top-k
// ---------------------------------------------------------------------------

// one bitonic step between a thread's own entries j and j | JS (stride
// JS·THREADS); runs with (e & size) == 0 sort forward, the others backward
template <int JS>
__device__ __forceinline__ void sort_step_regs(float* v, int* id, int size,
                                               int tid) {
#pragma unroll
  for (int j = 0; j < TILE / THREADS; ++j) {
    if (j & JS) continue;
    const int jh = j | JS;
    const bool fwd = ((j * THREADS + tid) & size) == 0;
    if (fwd ? before(v[jh], id[jh], v[j], id[j])
            : before(v[j], id[j], v[jh], id[jh])) {
      const float tv = v[j];
      const int ti = id[j];
      v[j] = v[jh];
      id[j] = id[jh];
      v[jh] = tv;
      id[jh] = ti;
    }
  }
}

// Sort sv/si[0, n) in the (score desc, id asc) order: a bitonic sort of
// TILE entries, padded with (−inf, INT_MAX), which sorts after every
// candidate.  n ≤ TILE.  Thread t holds entries j·THREADS + t (j < 8) in
// registers: a partner stride ≥ THREADS is in the thread's own registers,
// one < 32 in its warp (shuffles); only strides 32–128 pass through shared
// memory, 15 of the 66 steps.
__device__ void sort_candidates(float* sv, int* si, int n) {
  constexpr int PER = TILE / THREADS;
  const int tid = threadIdx.x;
  float v[PER];
  int id[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = j * THREADS + tid;
    v[j] = e < n ? sv[e] : -INFINITY;
    id[j] = e < n ? si[e] : INT_MAX;
  }
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= THREADS) {
        const int js = stride / THREADS;
        if (js == 1) {
          sort_step_regs<1>(v, id, size, tid);
        } else if (js == 2) {
          sort_step_regs<2>(v, id, size, tid);
        } else {
          sort_step_regs<4>(v, id, size, tid);
        }
        continue;
      }
      const bool via_smem = stride >= 32;
      if (via_smem) {
        __syncthreads();  // the previous shared step's reads are done
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          sv[j * THREADS + tid] = v[j];
          si[j * THREADS + tid] = id[j];
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = j * THREADS + tid;
        float pv;
        int pi;
        if (via_smem) {
          pv = sv[e ^ stride];
          pi = si[e ^ stride];
        } else {
          pv = __shfl_xor_sync(0xffffffffu, v[j], stride);
          pi = __shfl_xor_sync(0xffffffffu, id[j], stride);
        }
        // the lower entry of a forward run keeps the better one
        const bool want_better = ((e & size) == 0) == ((e & stride) == 0);
        if (want_better ? before(pv, pi, v[j], id[j])
                        : before(v[j], id[j], pv, pi)) {
          v[j] = pv;
          id[j] = pi;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    sv[j * THREADS + tid] = v[j];
    si[j * THREADS + tid] = id[j];
  }
  __syncthreads();
}

// #sv/si[0, n) entries strictly before (v, id)
__device__ __forceinline__ int count_before(const float* sv, const int* si,
                                            int n, float v, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(sv[mid], si[mid], v, id)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge the sorted running top-k cv/ci[0, filled) (the rest (−inf, −1))
// with the n sorted candidates sv/si (shared memory) into nv/ni[0,
// min(k, filled + n)).  An entry's slot is its index plus the count of
// the other list's entries ahead of it: candidates go after equal running
// entries, so the slots are distinct.  A running entry i finds its count
// lo_i by binary search in the candidates.  A candidate j has the running
// entries with lo_i ≤ j ahead of it: where the running top-k is in shared
// memory it finds them by binary search too; in global memory (GLOBAL)
// the thread of entry i places the candidates lo_(i−1) ≤ j < lo_i, so the
// global list is read once, in order.
template <bool GLOBAL>
__device__ void merge_by_rank(const float* cv, const int* ci, int filled,
                              const float* sv, const int* si, int n, int k,
                              float* nv, int* ni) {
  const int tid = threadIdx.x;
  if constexpr (GLOBAL) {
    __shared__ int lo_s[THREADS];  // lo of this pass's running entries
    int carry = 0;                 // lo of the entry before the pass
    for (int i0 = 0; i0 < filled; i0 += THREADS) {
      const int i = i0 + tid;
      int lo = 0;
      if (i < filled) {
        const float v = cv[i];
        const int id = ci[i];
        lo = count_before(sv, si, n, v, id);
        if (i + lo < k) {
          nv[i + lo] = v;
          ni[i + lo] = id;
        }
      }
      lo_s[tid] = lo;
      __syncthreads();
      if (i < filled) {
        const int prev = tid == 0 ? carry : lo_s[tid - 1];
        for (int j = prev; j < lo && j + i < k; ++j) {
          nv[j + i] = sv[j];
          ni[j + i] = si[j];
        }
      }
      carry = lo_s[min(THREADS, filled - i0) - 1];
      __syncthreads();  // lo_s is rewritten by the next pass
    }
    // the candidates after every running entry
    for (int j = carry + tid; j < n && j + filled < k; j += THREADS) {
      nv[j + filled] = sv[j];
      ni[j + filled] = si[j];
    }
  } else {
    for (int i = tid; i < filled; i += THREADS) {
      const float v = cv[i];
      const int id = ci[i];
      const int lo = count_before(sv, si, n, v, id);
      if (i + lo < k) {
        nv[i + lo] = v;
        ni[i + lo] = id;
      }
    }
    for (int j = tid; j < n; j += THREADS) {
      const float v = sv[j];
      const int id = si[j];
      int lo = 0, hi = filled;  // running entries not after the candidate
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!before(v, id, cv[mid], ci[mid])) lo = mid + 1; else hi = mid;
      }
      if (j + lo < k) {
        nv[j + lo] = v;
        ni[j + lo] = id;
      }
    }
  }
  __syncthreads();
}

// CTA qi merges query qi's nprobe·m candidates into its top-k; candidate
// j is of slot j / m and is skipped when that probe is outside [0, nlist)
template <bool GLOBAL_TOPK>
__global__ void __launch_bounds__(THREADS)
ivf_merge_candidates(const int* __restrict__ probes,
                     const float* __restrict__ cand_v,
                     const int* __restrict__ cand_i, float* __restrict__ out_v,
                     int* __restrict__ out_i, float* scratch_v,
                     int* scratch_i, int nprobe, int nlist, int m, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count;  // survivors gathered since the last merge
  const int tid = threadIdx.x, lane = tid % 32;
  const size_t qi = blockIdx.x;

  // shared layout: survivors sv[TILE] | si[TILE], then, unless a global
  // scratch is given, the running top-k cv[k] | nv[k] | ci[k] | ni[k]
  // (the scratch holds the same per query)
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + TILE);
  float *cv, *nv;
  int *ci, *ni;
  if constexpr (GLOBAL_TOPK) {
    cv = scratch_v + qi * 2 * static_cast<size_t>(k);
    ci = scratch_i + qi * 2 * static_cast<size_t>(k);
  } else {
    cv = reinterpret_cast<float*>(si + TILE);
    ci = reinterpret_cast<int*>(cv + 2 * k);
  }
  nv = cv + k;
  ni = ci + k;
  for (int u = tid; u < 2 * k; u += THREADS) {  // both buffers
    cv[u] = -INFINITY;
    ci[u] = -1;
  }
  if (tid == 0) count = 0;
  __syncthreads();

  const int n_cand = nprobe * m;  // < 2³¹: the wrapper caps the buffer
  const float* qv = cand_v + qi * n_cand;
  const int* qid = cand_i + qi * n_cand;
  const int* qprobe = probes + qi * nprobe;
  int filled = 0;          // the running top-k's real entries
  float kv = -INFINITY;    // and its k-th entry, which a survivor beats
  int ki = -1;
  for (int t0 = 0; t0 < n_cand; t0 += ROUND) {
    const int rows = min(ROUND, n_cand - t0);
    // the round's candidates, ROUND / THREADS a thread, all loads issued
    // before any is used (a slot of an invalid probe is never written)
    float v[ROUND / THREADS];
    int id[ROUND / THREADS], lid[ROUND / THREADS];
#pragma unroll
    for (int u = 0; u < ROUND / THREADS; ++u) {
      const int r = u * THREADS + tid;
      lid[u] = -1;
      if (r < rows) {
        v[u] = qv[t0 + r];
        id[u] = qid[t0 + r];
        lid[u] = __ldg(qprobe + (t0 + r) / m);
      }
    }
#pragma unroll
    for (int u = 0; u < ROUND / THREADS; ++u) {
      const bool keep = lid[u] >= 0 && lid[u] < nlist &&
                        before(v[u], id[u], kv, ki);
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      int at = 0;
      if (lane == 0 && mask) at = atomicAdd(&count, __popc(mask));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (keep) {
        const int slot = at + __popc(mask & ((1u << lane) - 1));
        sv[slot] = v[u];
        si[slot] = id[u];
      }
    }
    __syncthreads();
    const int n = count;
    __syncthreads();  // every thread has read the count
    // merge once the next round might not fit, and at the end
    if (n > TILE - ROUND || (n > 0 && t0 + ROUND >= n_cand)) {
      sort_candidates(sv, si, n);
      merge_by_rank<GLOBAL_TOPK>(cv, ci, filled, sv, si, n, k, nv, ni);
      float* tf = cv;  // the merged buffer becomes the running one
      cv = nv;
      nv = tf;
      int* tn = ci;
      ci = ni;
      ni = tn;
      filled = min(k, filled + n);
      kv = cv[k - 1];
      ki = ci[k - 1];
      if (tid == 0) count = 0;
      __syncthreads();
    }
  }
  for (int u = tid; u < k; u += THREADS) {
    out_v[qi * k + u] = cv[u];
    out_i[qi * k + u] = cv[u] == -INFINITY ? -1 : ci[u];
  }
}

template <int B, typename T, int V>
int launch_score(int blocks, size_t smem, cudaStream_t s,
                 const ScoreArgs& args) {
  auto kern = ivf_score_lists<B, T, V>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<blocks, THREADS, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// the widest copy, down to the element size, that the row length and the
// base address both allow
template <int B, typename T>
int dispatch_score(int blocks, size_t smem, cudaStream_t s,
                   const ScoreArgs& args) {
  const size_t row_bytes = static_cast<size_t>(args.w) * sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(args.storage);
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return launch_score<B, T, 16>(blocks, smem, s, args);
  if (row_bytes % 8 == 0 && a % 8 == 0)
    return launch_score<B, T, 8>(blocks, smem, s, args);
  if constexpr (sizeof(T) == 4) {
    return launch_score<B, T, 4>(blocks, smem, s, args);
  } else {
    if (row_bytes % 4 == 0 && a % 4 == 0)
      return launch_score<B, T, 4>(blocks, smem, s, args);
    if constexpr (sizeof(T) == 2) {
      return launch_score<B, T, 2>(blocks, smem, s, args);
    } else {
      if (row_bytes % 2 == 0 && a % 2 == 0)
        return launch_score<B, T, 2>(blocks, smem, s, args);
      return launch_score<B, T, 1>(blocks, smem, s, args);
    }
  }
}

// scoring CTAs: an upper bound on Σ_lists ⌈pairs/G⌉ (CTAs past the real
// count return at once)
int max_groups(int n_pairs, int nlist) {
  return (nlist < n_pairs ? nlist : n_pairs) + (n_pairs + G - 1) / G;
}

template <int B, typename T>
int launch(const int* probes, const void* q, const void* storage,
           const void* list_ids, const void* base, float* out_v, int* out_i,
           int* work, float* cand_v, int* cand_i, float* scratch_v,
           int* scratch_i, int n_q, int nprobe, int nlist, int L, int w,
           int k, int m, cudaStream_t s) {
  const int n_pairs = n_q * nprobe;
  const int groups = max_groups(n_pairs, nlist);
  int* cnt = work;
  int* off = cnt + nlist;
  int* pairs = off + 2 * (nlist + 1);
  int* glist = pairs + n_pairs;
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * nlist, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pgrid = n_pairs < 4096 * THREADS
      ? (n_pairs + THREADS - 1) / THREADS : 4096;
  ivf_invert_count<<<pgrid, THREADS, 0, s>>>(probes, n_pairs, nlist, cnt);
  ivf_invert_scan<<<1, SCAN, 0, s>>>(cnt, off, off + nlist + 1, glist,
                                     glist + groups, glist + 2 * groups,
                                     nlist);
  ivf_invert_scatter<<<pgrid, THREADS, 0, s>>>(probes, n_pairs, nlist, off,
                                               cnt, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int kp = B == kInt8 ? (w <= 64 ? 64 : (w + 63) / 64 * 64) : 0;
  const ScoreArgs args{q, storage, static_cast<const int*>(list_ids),
                       static_cast<const float*>(base), work, cand_v, cand_i,
                       n_pairs, groups, nprobe, nlist, L, w, m, kp};
  const int rc = dispatch_score<B, T>(groups, score_smem(B, w, kp), s, args);
  if (rc != 0) return rc;

  const bool global_topk = scratch_v != nullptr;
  size_t smem = sizeof(float) * 2 * TILE;
  if (!global_topk) smem += sizeof(float) * 4 * static_cast<size_t>(k);
  auto merge = global_topk ? ivf_merge_candidates<true>
                           : ivf_merge_candidates<false>;
  err = cudaFuncSetAttribute(merge,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge<<<n_q, THREADS, smem, s>>>(probes, cand_v, cand_i, out_v, out_i,
                                   scratch_v, scratch_i, nprobe, nlist, m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int32s of the work buffer ivf_fused_launch takes
extern "C" long long ivf_fused_work_ints(int n_q, int nprobe, int nlist) {
  const int n_pairs = n_q * nprobe;
  return 3LL * nlist + 2 + n_pairs + 3LL * max_groups(n_pairs, nlist);
}

// q: (n_q, w) f32 for float/fp16, bf16 for int8; (n_q, 32·w) ±1 int8
// signs for 1-bit (4-byte aligned);
// storage: (nlist, L, w) f32 / f16 / u8 / 32-bit words; list_ids, probes
// and outputs int32; base and values f32.  work: int32 scratch of
// ivf_fused_work_ints(n_q, nprobe, nlist); cand_v / cand_i: (n_q,
// nprobe, m) f32 / int32 with m = k when k < L and k ≤ 32, else m = L;
// scratch_v / scratch_i: null, or (n_q, 2k) f32 / int32 for a running
// top-k in global memory.  w ≤ 2048 for int8, ≤ 1024 otherwise.
extern "C" int ivf_fused_launch(const void* probes, const void* q,
                                const void* storage, const void* list_ids,
                                const void* base, void* out_v, void* out_i,
                                void* work, void* cand_v, void* cand_i,
                                void* scratch_v, void* scratch_i, int n_q,
                                int nprobe, int nlist, int L, int w, int k,
                                int m, int backend, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((scratch_v == nullptr) != (scratch_i == nullptr) || L < 1 || k < 1 ||
      w < 1 || w > (backend == kInt8 ? MAX_KP : MAX_W) ||
      !(m == L || (m == k && k < L && k <= KSEL)))
    return static_cast<int>(cudaErrorInvalidValue);
#define IVF_LAUNCH(B, T)                                                    \
  return launch<B, T>(static_cast<const int*>(probes), q, storage, list_ids, \
                      base, static_cast<float*>(out_v),                     \
                      static_cast<int*>(out_i), static_cast<int*>(work),    \
                      static_cast<float*>(cand_v), static_cast<int*>(cand_i), \
                      static_cast<float*>(scratch_v),                       \
                      static_cast<int*>(scratch_i), n_q, nprobe, nlist, L, w, \
                      k, m, s)
  switch (backend) {
    case kFloat: IVF_LAUNCH(kFloat, float);
    case kFp16: IVF_LAUNCH(kFp16, __half);
    case kInt8: IVF_LAUNCH(kInt8, uint8_t);
    case kOneBit: IVF_LAUNCH(kOneBit, uint32_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVF_LAUNCH
}
