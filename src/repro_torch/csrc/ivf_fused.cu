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
// order can enter the top-k, so those alone are compacted behind the
// running top-k — exact, ties kept by the id comparison — and a tile with
// none is skipped.  The candidates are folded into the running top-k by k
// rounds of "max score, the min id among its hits, retire that pair"; a
// round whose best is −inf ends the merge: every later slot is (−inf, −1),
// as merge_topk_block normalises it.
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
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 2048;  // rows scored per merge
constexpr unsigned FULL = 0xffffffffu;

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

// Fold the n candidates cv/ci[0, n) — the running top-k in slots [0, k),
// the compacted tile entries after it — into a new running top-k in slots
// [0, k).
__device__ void merge_rounds(float* cv, int* ci, int n, int k, float* nv,
                             int* ni, float (*red_v)[WARPS],
                             int (*red_i)[WARPS]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float m = INFINITY;
  int sel = INT_MAX;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int e = tid; e < n; e += THREADS) {
      float v = cv[e];
      const int id = ci[e];
      if (v == m && id == sel) {  // retire the previous round's pick
        v = -INFINITY;
        cv[e] = v;
      }
      if (before(v, id, bv, bi)) {
        bv = v;
        bi = id;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    // two reduction buffers by round parity: one barrier a round suffices
    if (lane == 0) {
      red_v[t & 1][warp] = bv;
      red_i[t & 1][warp] = bi;
    }
    __syncthreads();
    bv = red_v[t & 1][0];
    bi = red_i[t & 1][0];
#pragma unroll
    for (int u = 1; u < WARPS; ++u) {
      if (before(red_v[t & 1][u], red_i[t & 1][u], bv, bi)) {
        bv = red_v[t & 1][u];
        bi = red_i[t & 1][u];
      }
    }
    if (bv == -INFINITY) {  // the same in every thread: uniform exit
      for (int u = t + tid; u < k; u += THREADS) {
        nv[u] = -INFINITY;
        ni[u] = -1;
      }
      break;
    }
    if (tid == 0) {
      nv[t] = bv;
      ni[t] = bi;
    }
    m = bv;
    sel = bi;
  }
  __syncthreads();
  for (int u = tid; u < k; u += THREADS) {
    cv[u] = nv[u];
    ci[u] = ni[u];
  }
  __syncthreads();
}

template <int B, typename T>
__global__ void __launch_bounds__(THREADS)
ivf_fused_kernel(const int* __restrict__ probes, const void* __restrict__ q,
                 const T* __restrict__ storage,
                 const int* __restrict__ list_ids,
                 const float* __restrict__ base, float* __restrict__ out_v,
                 int* __restrict__ out_i, int nprobe, int nlist, int L,
                 int w, int k) {
  extern __shared__ float smem[];
  __shared__ float red_v[2][WARPS];
  __shared__ int red_i[2][WARPS];
  __shared__ int count[2];  // compacted entries, by tile parity
  const int tid = threadIdx.x;
  const size_t qi = blockIdx.x;

  // layout: query (w words or floats) | tile tv[TILE] | ti[TILE] |
  //         candidates cv[k + TILE] | ci[k + TILE] | nv[k] | ni[k]
  float* qs = smem;
  float* tv = qs + w;
  int* ti = reinterpret_cast<int*>(tv + TILE);
  float* cv = reinterpret_cast<float*>(ti + TILE);
  int* ci = reinterpret_cast<int*>(cv + k + TILE);
  float* nv = reinterpret_cast<float*>(ci + k + TILE);
  int* ni = reinterpret_cast<int*>(nv + k);
  const bool vec16 = (static_cast<size_t>(w) * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(storage) % 16 == 0;

  const uint32_t* qsrc = static_cast<const uint32_t*>(q) + qi * w;
  for (int e = tid; e < w; e += THREADS)
    reinterpret_cast<uint32_t*>(qs)[e] = qsrc[e];  // f32 or word bits
  for (int u = tid; u < k; u += THREADS) {
    cv[u] = -INFINITY;
    ci[u] = -1;
  }
  if (tid == 0) count[0] = count[1] = 0;
  __syncthreads();

  int tile = 0;
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
          const int slot = k + atomicAdd(&count[tile & 1], 1);
          cv[slot] = tv[r];
          ci[slot] = ti[r];
        }
      }
      __syncthreads();
      const int n = count[tile & 1];
      if (n > 0) merge_rounds(cv, ci, k + n, k, nv, ni, red_v, red_i);
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
           int n_q, int nprobe, int nlist, int L, int w, int k,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(w) + 2 * TILE +
                                       2 * (static_cast<size_t>(k) + TILE) +
                                       2 * static_cast<size_t>(k));
  auto kernel = ivf_fused_kernel<B, T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_q, THREADS, smem, stream>>>(
      static_cast<const int*>(probes), q, static_cast<const T*>(storage),
      static_cast<const int*>(list_ids), static_cast<const float*>(base),
      static_cast<float*>(out_v), static_cast<int*>(out_i), nprobe, nlist, L,
      w, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (n_q, w) f32 for float/fp16/int8, (n_q, w) packed words for 1-bit;
// storage: (nlist, L, w) f32 / f16 / u8 / 32-bit words; list_ids, probes
// and outputs int32; base and values f32.
extern "C" int ivf_fused_launch(const void* probes, const void* q,
                                const void* storage, const void* list_ids,
                                const void* base, void* out_v, void* out_i,
                                int n_q, int nprobe, int nlist, int L, int w,
                                int k, int backend, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (backend) {
    case kFloat:
      return launch<kFloat, float>(probes, q, storage, list_ids, base, out_v,
                                   out_i, n_q, nprobe, nlist, L, w, k, s);
    case kFp16:
      return launch<kFp16, __half>(probes, q, storage, list_ids, base, out_v,
                                   out_i, n_q, nprobe, nlist, L, w, k, s);
    case kInt8:
      return launch<kInt8, uint8_t>(probes, q, storage, list_ids, base,
                                    out_v, out_i, n_q, nprobe, nlist, L, w, k,
                                    s);
    case kOneBit:
      return launch<kOneBit, uint32_t>(probes, q, storage, list_ids, base,
                                       out_v, out_i, n_q, nprobe, nlist, L, w,
                                       k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
