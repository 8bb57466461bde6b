// 1-bit index scoring: (Q, W) packed query sign words × (D, W) packed
// document sign words → (Q, D) int32 sign dots, d_packed − 2·Σ popc(q ⊕ x)
// with d_packed = 32·W.
//
// Replaces src/repro/kernels/binary_ip/kernel.py::binary_ip_pallas (tile
// body _binary_ip_kernel, unpack _unpack_block).  The TPU has no popcount
// feeding its matrix unit, so the Pallas kernel unpacks bits to ±1 int8 and
// multiplies; Hopper has __popc, so this kernel XORs the packed words.
// Pad bits are 0 on both sides (query pads are −1 signs, document pads are
// encoded from −1.0), agree, and count +1 each — exactly the ±1 sign dot
// over all d_packed positions that repro's kernel computes.  The wrapper
// (repro_torch/kernels/binary_ip/ops.py) scales by 0.25 and adds the α ≠ 0.5
// offset terms.
//
// Bound on an H100 SXM (3.35 TB/s): at Q=256, D=1M, W=8 it reads 0.03 GB of
// words and writes 1.02 GB of int32, 0.32 ms — the (Q, D) output bounds it.
// Design: each block stages 64 query rows and 64 document rows of words in
// shared memory, 8 words at a time, and each thread sums 4×4 outputs.
// Fusing top-k into the epilogue (so (Q, D) never reaches memory) is later
// work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;
constexpr int BD = 64;
constexpr int BW = 8;         // words staged per step
constexpr int THREADS = 256;  // 16 × 16 threads, 4 × 4 outputs each

__global__ void __launch_bounds__(THREADS)
binary_ip_kernel(const uint32_t* __restrict__ q,
                 const uint32_t* __restrict__ docs, int32_t* __restrict__ out,
                 int n_q, int n_docs, int n_words) {
  __shared__ uint32_t qs[BW][BQ + 1];
  __shared__ uint32_t ds[BW][BD + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * BQ;
  const int d0 = blockIdx.x * BD;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < n_words; w0 += BW) {
    // words past n_words load as 0 on both sides: XOR 0, popcount 0
    for (int e = threadIdx.x; e < BQ * BW; e += THREADS) {
      const int r = e / BW, c = e % BW;
      const int gq = q0 + r, gw = w0 + c;
      qs[c][r] = (gq < n_q && gw < n_words) ? q[(size_t)gq * n_words + gw] : 0u;
    }
    for (int e = threadIdx.x; e < BD * BW; e += THREADS) {
      const int r = e / BW, c = e % BW;
      const int gd = d0 + r, gw = w0 + c;
      ds[c][r] =
          (gd < n_docs && gw < n_words) ? docs[(size_t)gd * n_words + gw] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int ww = 0; ww < BW; ++ww) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[ww][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ds[ww][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(a[i] ^ b[j]);
    }
    __syncthreads();
  }

  const int d_packed = 32 * n_words;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n_q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = d0 + tx + 16 * j;
      if (col < n_docs)
        out[(size_t)row * n_docs + col] = d_packed - 2 * acc[i][j];
    }
  }
}

}  // namespace

extern "C" int binary_ip_launch(const void* q, const void* docs, void* out,
                                int n_q, int n_docs, int n_words,
                                void* stream) {
  const dim3 grid((n_docs + BD - 1) / BD, (n_q + BQ - 1) / BQ);
  binary_ip_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(docs),
      static_cast<int32_t*>(out), n_q, n_docs, n_words);
  return static_cast<int>(cudaGetLastError());
}
