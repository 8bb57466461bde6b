// Fused IVF search: for each query, its nprobe probed inverted lists are
// gathered from the list-major storage, scored per backend, shifted by a
// per-(query, probe) base, pad rows masked, and folded into a running
// top-k in the strict (score desc, id asc) order.
//
// Replaces src/repro/kernels/ivf_fused/kernel.py::fused_ivf_topk_pallas
// (grid body _fused_ivf_kernel, scoring score_block, merge
// repro/retrieval/topk.py::merge_topk_block).  The Pallas kernel walks a
// (query, probe) grid whose probe axis runs in order and scalar-prefetches
// the probe table into its BlockSpec index maps; here one CTA owns one
// query, loads each probe slot's list id itself and loops over the slots.
//
// Numerics, per backend (the wrapper, repro_torch/kernels/ivf_fused/
// kernel.py, hands every non-1-bit query over as f32):
//   float, fp16 : f32 dot, fp16 rows widened to f32;
//   int8        : bf16(q⊙scale) (exact in f32) × u8 code — each product is
//                 exact in f32, so only the order of the sums differs;
//   1-bit       : dot = 32·W − 2·Σ popc(qword ⊕ xword) over packed words,
//                 score 0.25f·dot — bit-exact.  The query words come from
//                 the sign vector padded with −1 (bit 0), as repro pads it.
// Then score + base[i, j], then −inf (and id −1) where the row's id < 0,
// in that order, so that 1-bit score bits match the plain version.
//
// Merge: the list is scored TILE rows at a time into shared memory (any
// list length works: the merge is associative under the strict order).
// Only the tile's rows that come before the running k-th entry in that
// order can enter the top-k, so those alone are compacted into a
// candidate buffer — exact, ties kept by the id comparison — and a tile
// with none is skipped.  The candidates are sorted in that order by a
// bitonic sort in shared memory, and merged with the sorted running top-k
// by rank: each entry of either list finds its rank in the other by
// binary search, lands at the sum of its two ranks, and drops out at
// rank ≥ k.  Only the running top-k's filled prefix takes part (the rest
// is (−inf, −1), which no candidate follows), so a merged tile costs
// O(P log² P) for its P (≤ TILE) candidates plus O((filled + P) log) for
// the ranks: linear in k, where k rounds of "retire the best" were
// O(k·(k + P)).  Unreachable slots stay (−inf, −1), as merge_topk_block
// normalises them.
//
// Any k: up to the wrapper's MAX_K (1024) the running top-k (two buffers,
// current and next) sits in shared memory; above it (the wrapper passes a
// scratch of (Q, 2k) values and ids, allocated with torch.empty) it sits
// in that global scratch, one slice a query, and the same merge runs
// there.  The two are separate instantiations (GLOBAL_TOPK), so the
// shared-memory one keeps shared-memory addressing.  A segmented index
// probes its main k + #dead(main) deep, so k grows with the tombstones.
//
// Bound on an H100 SXM (3.35 TB/s): at Q=256, nprobe=64, 1024 lists of
// L≈1221 rows, int8 d=128, the distinct probed lists' rows and ids (at
// most 1024·1221·132 B = 0.165 GB) plus queries, probes and base take
// ~0.05 ms; the 2·Q·nprobe·L·d = 5.1 GOP of scoring take 0.005 ms at the
// bf16 tensor-core rate — the bytes bound it.  This version is far from
// that: a CTA re-reads every list it probes (no reuse across queries
// beyond L2) and scores on the CUDA cores, a thread per row with 16-byte
// loads where the rows are aligned.  Splitting a query's probes over CTAs,
// sharing a list across the queries that probe it, and cp.async/TMA
// double-buffering of list tiles are later work.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;  // rows scored per merge

enum Backend { kFloat = 0, kFp16 = 1, kInt8 = 2, kOneBit = 3 };

// (v, i) comes before (bv, bi) in the (score desc, id asc) order
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(uint8_t x) {
  return static_cast<float>(x);
}

// Σ qs[e]·x[e] over the 16 bytes in u (4 f32, 8 f16 or 16 u8 elements).
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
__device__ __forceinline__ float dot16(const float* qs, uint4 u, float acc,
                                       uint8_t) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // 2²³ + byte, exactly, minus 2²³: the byte as f32 in two full-rate ops
      const float x = __uint_as_float(0x4B000000u | ((v[j] >> (8 * b)) & 0xFFu))
                      - 8388608.0f;
      acc = fmaf(qs[4 * j + b], x, acc);
    }
  }
  return acc;
}

// Score of one list row against the query in shared memory: f32 for the
// float-like backends, 0.25·(32·w − 2·Σ popc(q ⊕ x)) for 1-bit words.
template <int B, typename T>
__device__ __forceinline__ float row_score(const void* qs_raw,
                                           const T* __restrict__ x, int w,
                                           bool vec16) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte load
  if constexpr (B == kOneBit) {
    const uint32_t* qw = static_cast<const uint32_t*>(qs_raw);
    int pop = 0;
    if (vec16) {
      const uint4* xv = reinterpret_cast<const uint4*>(x);
#pragma unroll 4
      for (int c = 0; c < w / PER; ++c) {
        const uint4 u = __ldg(xv + c);
        pop += __popc(qw[4 * c] ^ u.x) + __popc(qw[4 * c + 1] ^ u.y) +
               __popc(qw[4 * c + 2] ^ u.z) + __popc(qw[4 * c + 3] ^ u.w);
      }
    } else {
      for (int e = 0; e < w; ++e) pop += __popc(qw[e] ^ __ldg(x + e));
    }
    // 0.25·dot is exact; the base is added as a separate f32 rounding
    return __fmul_rn(0.25f, static_cast<float>(32 * w - 2 * pop));
  } else {
    const float* qs = static_cast<const float*>(qs_raw);
    float acc = 0.f;
    if (vec16) {
      const uint4* xv = reinterpret_cast<const uint4*>(x);
#pragma unroll 8
      for (int c = 0; c < w / PER; ++c)
        acc = dot16(qs + c * PER, __ldg(xv + c), acc, T());
    } else {
      for (int e = 0; e < w; ++e) acc = fmaf(qs[e], widen(x[e]), acc);
    }
    return acc;
  }
}

// Sort sv/si[0, n) in the (score desc, id asc) order: a bitonic sort
// over the next power of two, padded with (−inf, INT_MAX), which sorts
// after every candidate.  n ≤ TILE.
__device__ void sort_candidates(float* sv, int* si, int n) {
  const int tid = threadIdx.x;
  int p = 1;
  while (p < n) p <<= 1;
  for (int e = n + tid; e < p; e += THREADS) {
    sv[e] = -INFINITY;
    si[e] = INT_MAX;
  }
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < p / 2; t += THREADS) {
        const int lo = 2 * stride * (t / stride) + t % stride;
        const int hi = lo + stride;
        const float va = sv[lo], vb = sv[hi];
        const int ia = si[lo], ib = si[hi];
        // runs with (lo & size) == 0 sort forward, the others backward
        if ((lo & size) == 0 ? before(vb, ib, va, ia)
                             : before(va, ia, vb, ib)) {
          sv[lo] = vb;
          si[lo] = ib;
          sv[hi] = va;
          si[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
}

// Merge the sorted running top-k cv/ci[0, filled) (the rest (−inf, −1))
// with the n sorted candidates sv/si into nv/ni[0, min(k, filled + n)).
// An entry's slot is its index plus the count of the other list's entries
// ahead of it: candidates go after equal running entries, so the slots
// are distinct.
__device__ void merge_by_rank(const float* cv, const int* ci, int filled,
                              const float* sv, const int* si, int n, int k,
                              float* nv, int* ni) {
  const int tid = threadIdx.x;
  for (int i = tid; i < filled; i += THREADS) {
    const float v = cv[i];
    const int id = ci[i];
    int lo = 0, hi = n;  // candidates strictly before the entry
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(sv[mid], si[mid], v, id)) lo = mid + 1; else hi = mid;
    }
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
  __syncthreads();
}

template <int B, typename T, bool GLOBAL_TOPK>
__global__ void __launch_bounds__(THREADS)
ivf_fused_kernel(const int* __restrict__ probes, const void* __restrict__ q,
                 const T* __restrict__ storage,
                 const int* __restrict__ list_ids,
                 const float* __restrict__ base, float* __restrict__ out_v,
                 int* __restrict__ out_i, float* scratch_v, int* scratch_i,
                 int nprobe, int nlist, int L, int w, int k) {
  extern __shared__ float smem[];
  __shared__ int count[2];  // compacted candidates, by tile parity
  const int tid = threadIdx.x;
  const size_t qi = blockIdx.x;

  // shared layout: query (w words or floats) | tile tv[TILE] | ti[TILE] |
  // candidates sv[TILE] | si[TILE], then, unless a global scratch is
  // given, the running top-k cv[k] | nv[k] | ci[k] | ni[k] (the scratch
  // holds the same per query: cv | nv values, ci | ni ids)
  float* qs = smem;
  float* tv = qs + w;
  int* ti = reinterpret_cast<int*>(tv + TILE);
  float* sv = reinterpret_cast<float*>(ti + TILE);
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
  const bool vec16 = (static_cast<size_t>(w) * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(storage) % 16 == 0;

  const uint32_t* qsrc = static_cast<const uint32_t*>(q) + qi * w;
  for (int e = tid; e < w; e += THREADS)
    reinterpret_cast<uint32_t*>(qs)[e] = qsrc[e];  // f32 or word bits
  for (int u = tid; u < 2 * k; u += THREADS) {  // both buffers
    cv[u] = -INFINITY;
    ci[u] = -1;
  }
  if (tid == 0) count[0] = count[1] = 0;
  __syncthreads();

  int tile = 0, filled = 0;  // filled: the running top-k's real entries
  for (int j = 0; j < nprobe; ++j) {
    const int lid = __ldg(probes + qi * nprobe + j);
    if (lid < 0 || lid >= nlist) continue;  // outside the contract: skip
    const float b = __ldg(base + qi * nprobe + j);
    for (int r0 = 0; r0 < L; r0 += TILE, ++tile) {
      const int rows = min(TILE, L - r0);
      const size_t row0 = static_cast<size_t>(lid) * L + r0;
      for (int r = tid; r < rows; r += THREADS) {
        const int id = __ldg(list_ids + row0 + r);
        const float s = __fadd_rn(
            row_score<B>(qs, storage + (row0 + r) * static_cast<size_t>(w),
                         w, vec16),
            b);
        tv[r] = id >= 0 ? s : -INFINITY;
        ti[r] = id >= 0 ? id : -1;
      }
      __syncthreads();
      // every thread has left the previous tile: its counter is free
      if (tid == 0) count[(tile + 1) & 1] = 0;
      const float kv = cv[k - 1];
      const int ki = ci[k - 1];
      for (int r = tid; r < rows; r += THREADS) {
        if (before(tv[r], ti[r], kv, ki)) {
          const int slot = atomicAdd(&count[tile & 1], 1);
          sv[slot] = tv[r];
          si[slot] = ti[r];
        }
      }
      __syncthreads();
      const int n = count[tile & 1];
      if (n == 0) continue;
      sort_candidates(sv, si, n);
      merge_by_rank(cv, ci, filled, sv, si, n, k, nv, ni);
      float* tf = cv;  // the merged buffer becomes the running one
      cv = nv;
      nv = tf;
      int* tn = ci;
      ci = ni;
      ni = tn;
      filled = min(k, filled + n);
    }
  }
  for (int u = tid; u < k; u += THREADS) {
    out_v[qi * k + u] = cv[u];
    out_i[qi * k + u] = cv[u] == -INFINITY ? -1 : ci[u];
  }
}

template <int B, typename T>
int launch(const void* probes, const void* q, const void* storage,
           const void* list_ids, const void* base, void* out_v, void* out_i,
           void* scratch_v, void* scratch_i, int n_q, int nprobe, int nlist,
           int L, int w, int k, cudaStream_t stream) {
  const bool global_topk = scratch_v != nullptr;
  size_t smem = sizeof(float) * (static_cast<size_t>(w) + 4 * TILE);
  if (!global_topk) smem += sizeof(float) * 4 * static_cast<size_t>(k);
  auto kernel = global_topk ? ivf_fused_kernel<B, T, true>
                            : ivf_fused_kernel<B, T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_q, THREADS, smem, stream>>>(
      static_cast<const int*>(probes), q, static_cast<const T*>(storage),
      static_cast<const int*>(list_ids), static_cast<const float*>(base),
      static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<float*>(scratch_v), static_cast<int*>(scratch_i), nprobe,
      nlist, L, w, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (n_q, w) f32 for float/fp16/int8, (n_q, w) packed words for 1-bit;
// storage: (nlist, L, w) f32 / f16 / u8 / 32-bit words; list_ids, probes
// and outputs int32; base and values f32.  scratch_v / scratch_i: null, or
// (n_q, 2k) f32 / int32 for a running top-k in global memory.
extern "C" int ivf_fused_launch(const void* probes, const void* q,
                                const void* storage, const void* list_ids,
                                const void* base, void* out_v, void* out_i,
                                void* scratch_v, void* scratch_i, int n_q,
                                int nprobe, int nlist, int L, int w, int k,
                                int backend, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((scratch_v == nullptr) != (scratch_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (backend) {
    case kFloat:
      return launch<kFloat, float>(probes, q, storage, list_ids, base, out_v,
                                   out_i, scratch_v, scratch_i, n_q, nprobe,
                                   nlist, L, w, k, s);
    case kFp16:
      return launch<kFp16, __half>(probes, q, storage, list_ids, base, out_v,
                                   out_i, scratch_v, scratch_i, n_q, nprobe,
                                   nlist, L, w, k, s);
    case kInt8:
      return launch<kInt8, uint8_t>(probes, q, storage, list_ids, base,
                                    out_v, out_i, scratch_v, scratch_i, n_q,
                                    nprobe, nlist, L, w, k, s);
    case kOneBit:
      return launch<kOneBit, uint32_t>(probes, q, storage, list_ids, base,
                                       out_v, out_i, scratch_v, scratch_i,
                                       n_q, nprobe, nlist, L, w, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
