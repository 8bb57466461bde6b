// int8 index scoring: (Q, d) bf16 pre-scaled queries × (D, d) uint8 codes
// → (Q, D) f32 inner products.
//
// Replaces src/repro/kernels/int8_ip/kernel.py::int8_ip_pallas (tile body
// _int8_ip_kernel).  The wrapper (repro_torch/kernels/int8_ip/ops.py) adds
// the rank-1 q·zero term and, for l2, the decoded document norms.
//
// Numerics: a bf16 × u8 product has at most 16 significant bits, so it is
// exact in f32; only the order of the f32 summation differs from XLA's.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at Q=256, D=1M,
// d=128 the kernel reads 0.13 GB of codes and writes 1.02 GB of f32 scores,
// 0.34 ms; its 67 GFLOP need 0.07 ms on the tensor cores.  The (Q, D)
// output bounds it.  This first version is a plain shared-memory tiled
// product on the CUDA cores (f32 FMA): each block stages a 64-query and a
// 64-doc tile, 32 dims at a time, converted to f32 in shared memory, and
// each thread sums 4×4 outputs.  Making it fast (tensor cores, and top-k
// fused into the epilogue so (Q, D) never reaches memory) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BD = 64;       // documents per block
constexpr int BK = 32;       // dimensions staged per step
constexpr int THREADS = 256; // 16 × 16 threads, 4 × 4 outputs each

__global__ void __launch_bounds__(THREADS)
int8_ip_kernel(const __nv_bfloat16* __restrict__ q,
               const uint8_t* __restrict__ docs, float* __restrict__ out,
               int n_q, int n_docs, int d) {
  // +1 column: the transposed stores hit 32 different banks
  __shared__ float qs[BK][BQ + 1];
  __shared__ float ds[BK][BD + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * BQ;
  const int d0 = blockIdx.x * BD;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // neighbouring threads read neighbouring dimensions of one row
    for (int e = threadIdx.x; e < BQ * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gq = q0 + r, gk = k0 + c;
      qs[c][r] = (gq < n_q && gk < d)
                     ? __bfloat162float(q[(size_t)gq * d + gk])
                     : 0.f;
    }
    for (int e = threadIdx.x; e < BD * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gd = d0 + r, gk = k0 + c;
      ds[c][r] = (gd < n_docs && gk < d)
                     ? static_cast<float>(docs[(size_t)gd * d + gk])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ds[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n_q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = d0 + tx + 16 * j;
      if (col < n_docs) out[(size_t)row * n_docs + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int int8_ip_launch(const void* q, const void* docs, void* out,
                              int n_q, int n_docs, int d, void* stream) {
  const dim3 grid((n_docs + BD - 1) / BD, (n_q + BQ - 1) / BQ);
  int8_ip_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(docs),
      static_cast<float*>(out), n_q, n_docs, d);
  return static_cast<int>(cudaGetLastError());
}
