// Stage 1 of the exact two-stage top-k: (Q, D) f32 scores → for each block
// of block_d columns its top k, as (Q, n_blocks·k) values and global
// column indices.  Stage 2 (repro_torch/kernels/topk_blocks/ops.py) ranks
// the candidates by (score desc, id asc).
//
// Replaces src/repro/kernels/topk_blocks/kernel.py::topk_blocks_pallas
// (tile body _topk_tile_kernel).  That kernel runs k rounds of "max, then
// the lowest column holding it, then set that column to −inf".  This one
// gives the same output without writing to the tile: round r picks the
// element that comes first in the (value desc, column asc) order among
// those after round r−1's pick.  Columns past D are −inf pads, as in the
// Pallas wrapper.  Once a round's best is −inf the Pallas kernel picks
// the lowest column now holding −inf — the lowest of the original −inf
// columns and the columns already picked — in that round and every round
// after; so does this one.
//
// Bound on an H100 SXM (3.35 TB/s): on (256, 1M) it reads 1.02 GB of
// scores, 0.31 ms.  Design: one warp per (row, block); each round every
// lane scans its block_d/32 columns (the 4 KB tile stays in L1 after the
// first round) and the warp reduces with shuffles.  The k rounds cost
// k·block_d/32 compares per lane, so a large k is slow, not wrong.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

// (v, i) before (bv, bi) in the (value desc, column asc) order
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(WARPS * 32)
topk_blocks_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                   int* __restrict__ idx, int n_q, int n_d, int k,
                   int block_d, int n_blocks) {
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= (long long)n_q * n_blocks) return;  // whole warp leaves
  const int row = static_cast<int>(warp / n_blocks);
  const int blk = static_cast<int>(warp % n_blocks);
  const float* s = scores + (size_t)row * n_d;
  const int base = blk * block_d;
  const int stop = min(base + block_d, n_d);
  float* out_v = vals + (size_t)warp * k;
  int* out_i = idx + (size_t)warp * k;

  // the previous pick; (+inf, −1) comes before every element
  float last_v = INFINITY;
  int last_i = -1;
  int min_picked = INT_MAX;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int col = base + lane; col < base + block_d; col += 32) {
      const float v = col < stop ? __ldg(s + col) : -INFINITY;
      if (before(last_v, last_i, v, col) && before(v, col, bv, bi)) {
        bv = v;
        bi = col;
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
    if (bv == -INFINITY) {
      // the Pallas tile is all −inf from here on: its lowest column repeats
      const int col = min(bi, min_picked);
      for (int t = r + lane; t < k; t += 32) {
        out_v[t] = -INFINITY;
        out_i[t] = col;
      }
      return;
    }
    if (lane == 0) {
      out_v[r] = bv;
      out_i[r] = bi;
    }
    last_v = bv;
    last_i = bi;
    min_picked = min(min_picked, bi);
  }
}

}  // namespace

extern "C" int topk_blocks_launch(const void* scores, void* vals, void* idx,
                                  int n_q, int n_d, int k, int block_d,
                                  int n_blocks, void* stream) {
  const long long warps = (long long)n_q * n_blocks;
  const dim3 grid(static_cast<unsigned>((warps + WARPS - 1) / WARPS));
  topk_blocks_kernel<<<grid, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(vals),
      static_cast<int*>(idx), n_q, n_d, k, block_d, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
