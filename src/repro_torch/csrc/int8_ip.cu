// int8 index scoring: (Q, d) bf16 pre-scaled queries × (D, d) uint8 codes
// (+ an optional per-query f32 bias) → (Q, D) f32 inner products.
//
// Replaces src/repro/kernels/int8_ip/kernel.py::int8_ip_pallas (tile body
// _int8_ip_kernel).  The wrapper (repro_torch/kernels/int8_ip/ops.py)
// passes the rank-1 q·zero term as ``bias``, added here in the epilogue;
// for l2 it adds the decoded document norms.
//
// Numerics: a bf16 × u8 product has at most 16 significant bits, so it is
// exact in f32; only the order of the f32 summation differs from XLA's.
// The bias is one f32 add of the finished sum, as ``out = acc; out += b``.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at Q=256, D=1M,
// d=128 the kernel reads 0.13 GB of codes and writes 1.02 GB of f32 scores,
// 0.34 ms; its 67 GFLOP need 0.07 ms on the tensor cores.  The (Q, D)
// output bounds it, so the design spends nothing on the product and keeps
// the stores streaming:
// - tensor cores: mma.sync.m16n8k16 bf16 × bf16 → f32.  u8 codes become
//   bf16 in registers (f32 magic-number add, then the upper half: exact
//   for 0..255).  The k order inside each 64-dim group is permuted the same
//   way for queries and codes so that a thread reads 16 contiguous code
//   bytes (one 16-byte load covers 4 k-steps) and 8 contiguous query bytes
//   a k-step; the sum is over the same products.
// - a CTA owns up to 128 queries (whole d in shared memory, zero-padded to
//   a multiple of 64) and walks doc tiles of 128 rows, 128 dims a stage,
//   double-buffered with cp.async (16-, 8- or 4-byte copies as the rows'
//   alignment allows; plain byte loads otherwise).  One wave of CTAs.
// - epilogue: each warp stages 32×32 f32 in shared memory, adds the bias
//   and writes 128-byte row segments, 16 bytes a thread, with streaming
//   (.cs) stores: the output is 20× the L2.
// d up to 2048 (MAX_DIM); wider queries do not fit shared memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_util.cuh"

namespace {

using namespace mma_util;

constexpr int BN = 128;       // documents per tile
constexpr int THREADS = 256;  // 8 warps: 2 (queries) × 4 (documents)
constexpr int STG = 40;       // staging row stride in floats (no conflicts)
constexpr int STAGE_FLOATS = 8 * 32 * STG;
constexpr int MAX_KP = 2048;

// Shared memory: [staging: 8 warps × 32 × STG f32][codes: 2 stages × BN
// rows × sw bytes][queries: BM rows × (2·kp + 8) bytes].  A code stage row
// holds 128 dims (64 when kp is 64); with 128-byte rows odd rows swap their
// two 64-byte halves, so the 8 lanes of a quarter-warp (2 rows × 64 bytes)
// hit 32 distinct banks.  Query rows are 8 bytes longer than 2·kp for the
// same reason (4 rows × 32 bytes a half-warp).
size_t smem_bytes(int mt, int kp) {
  const int sw = kp == 64 ? 64 : 128;
  return sizeof(float) * STAGE_FLOATS + 2 * BN * sw +
         static_cast<size_t>(32 * mt) * (2 * kp + 8);
}

template <int MT, int V>
__global__ void __launch_bounds__(THREADS, MT == 4 ? 2 : 1)
int8_ip_kernel(const uint16_t* __restrict__ q, const uint8_t* __restrict__ docs,
               const float* __restrict__ bias, float* __restrict__ out,
               int n_q, int n_docs, int d, int kp) {
  constexpr int BM = 32 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sw = kp == 64 ? 64 : 128;
  const int swz = sw == 128 ? 64 : 0;
  const int sq = 2 * kp + 8;
  float* stage = reinterpret_cast<float*>(smem);
  unsigned char* dstage = smem + sizeof(float) * STAGE_FLOATS;
  unsigned char* qs = dstage + 2 * BN * sw;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.y * BM;

  // queries, zero-padded to BM rows and kp dims (read once per CTA)
  for (int e = threadIdx.x; e < BM * kp; e += THREADS) {
    const int r = e / kp, c = e % kp;
    const uint16_t v =
        (q0 + r < n_q && c < d) ? q[static_cast<size_t>(q0 + r) * d + c] : 0;
    *reinterpret_cast<uint16_t*>(qs + r * sq + 2 * c) = v;
  }

  const int n_kc = (kp + 127) / 128;
  const int n_tiles = (n_docs + BN - 1) / BN;
  const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
      ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int steps = my_tiles * n_kc;

  // stage p: 128 dims (chunk p % n_kc) of the CTA's (p / n_kc)-th tile
  auto load_stage = [&](int p) {
    const int tile = blockIdx.x + (p / n_kc) * gridDim.x;
    const int c = p % n_kc;
    const int per_row = min(128, d - 128 * c) / V;
    const int rows = min(BN, n_docs - tile * BN);
    unsigned char* buf = dstage + (p & 1) * BN * sw;
    const uint8_t* src0 =
        docs + static_cast<size_t>(tile) * BN * d + 128 * c;
    for (int e = threadIdx.x; e < rows * per_row; e += THREADS) {
      const int r = e / per_row, b = (e % per_row) * V;
      copy_async<V>(buf + r * sw + (b ^ ((r & 1) ? swz : 0)),
                    src0 + static_cast<size_t>(r) * d + b);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const bool vec_out = (n_docs % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  float* wstage = stage + warp * 32 * STG;

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
    __syncthreads();  // stage p (and, first, the queries) are in place
    const unsigned char* buf = dstage + (p & 1) * BN * sw;
    const int c = p % n_kc;
    const int groups = min(2, kp / 64 - 2 * c);
    for (int gi = 0; gi < groups; ++gi) {
      uint4 braw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = wn * 32 + j * 8 + g;
        braw[j] = *reinterpret_cast<const uint4*>(
            buf + row * sw + ((gi * 64 + 16 * t) ^ ((row & 1) ? swz : 0)));
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t w = s == 0 ? braw[j].x : s == 1 ? braw[j].y
                           : s == 2 ? braw[j].z : braw[j].w;
          b[j][0] = u8x2_to_bf16x2(w, 0);
          b[j][1] = u8x2_to_bf16x2(w, 2);
        }
        const int kq = 128 * c + 64 * gi + 16 * t + 4 * s;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const unsigned char* qa =
              qs + (wm * 16 * MT + i * 16 + g) * sq + 2 * kq;
          const uint2 lo = *reinterpret_cast<const uint2*>(qa);
          const uint2 hi = *reinterpret_cast<const uint2*>(qa + 8 * sq);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], lo.x, hi.x, lo.y, hi.y, b[j][0], b[j][1]);
        }
      }
    }
    if (c == n_kc - 1) {
      // epilogue: 32 rows (two m-tiles) at a time through the warp's stage
      const int tile = blockIdx.x + (p / n_kc) * gridDim.x;
      const int col0 = tile * BN + wn * 32 + 4 * (lane % 8);
#pragma unroll
      for (int r0 = 0; r0 < MT; r0 += 2) {
        const int mts = MT - r0 < 2 ? MT - r0 : 2;
#pragma unroll
        for (int ii = 0; ii < mts; ++ii)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* p0 = wstage + (ii * 16 + g) * STG + 8 * j + 2 * t;
            *reinterpret_cast<float2*>(p0) =
                make_float2(acc[r0 + ii][j][0], acc[r0 + ii][j][1]);
            *reinterpret_cast<float2*>(p0 + 8 * STG) =
                make_float2(acc[r0 + ii][j][2], acc[r0 + ii][j][3]);
          }
        __syncwarp();
        for (int rr = lane / 8; rr < 16 * mts; rr += 4) {
          const int row = q0 + wm * 16 * MT + r0 * 16 + rr;
          float4 v = *reinterpret_cast<const float4*>(
              wstage + rr * STG + 4 * (lane % 8));
          if (row < n_q) {
            if (bias != nullptr) {
              const float bb = bias[row];
              v.x += bb;
              v.y += bb;
              v.z += bb;
              v.w += bb;
            }
            float* o = out + static_cast<size_t>(row) * n_docs + col0;
            if (vec_out && col0 + 3 < n_docs) {
              __stcs(reinterpret_cast<float4*>(o), v);
            } else {
              if (col0 < n_docs) __stcs(o, v.x);
              if (col0 + 1 < n_docs) __stcs(o + 1, v.y);
              if (col0 + 2 < n_docs) __stcs(o + 2, v.z);
              if (col0 + 3 < n_docs) __stcs(o + 3, v.w);
            }
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    __syncthreads();  // stage p is read: load_stage(p + 2) may overwrite it
  }
}

template <int MT, int V>
int launch(const void* q, const void* docs, const void* bias, void* out,
           int n_q, int n_docs, int d, int kp, cudaStream_t stream) {
  auto kern = int8_ip_kernel<MT, V>;
  const size_t smem = smem_bytes(MT, kp);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_m = (n_q + 32 * MT - 1) / (32 * MT);
  const int tiles_n = (n_docs + BN - 1) / BN;
  if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int wave = (sms * (per_sm > 0 ? per_sm : 1) + tiles_m - 1) / tiles_m;
  const dim3 grid(tiles_n < wave ? tiles_n : wave, tiles_m);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint8_t*>(docs),
      static_cast<const float*>(bias), static_cast<float*>(out), n_q, n_docs,
      d, kp);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_mt(const void* q, const void* docs, const void* bias, void* out,
              int n_q, int n_docs, int d, int kp, cudaStream_t stream) {
  // widest copy that the row length and the base address both allow
  const uintptr_t a = reinterpret_cast<uintptr_t>(docs);
  if (d % 16 == 0 && a % 16 == 0)
    return launch<MT, 16>(q, docs, bias, out, n_q, n_docs, d, kp, stream);
  if (d % 8 == 0 && a % 8 == 0)
    return launch<MT, 8>(q, docs, bias, out, n_q, n_docs, d, kp, stream);
  if (d % 4 == 0 && a % 4 == 0)
    return launch<MT, 4>(q, docs, bias, out, n_q, n_docs, d, kp, stream);
  return launch<MT, 1>(q, docs, bias, out, n_q, n_docs, d, kp, stream);
}

}  // namespace

// bias: (n_q,) f32 or null.  d ≤ 2048.
extern "C" int int8_ip_launch(const void* q, const void* docs,
                              const void* bias, void* out, int n_q,
                              int n_docs, int d, void* stream) {
  const int kp = d <= 64 ? 64 : (d + 63) / 64 * 64;
  if (kp > MAX_KP) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (kp <= 256)
    return launch_mt<4>(q, docs, bias, out, n_q, n_docs, d, kp, s);
  if (kp <= 512)
    return launch_mt<2>(q, docs, bias, out, n_q, n_docs, d, kp, s);
  return launch_mt<1>(q, docs, bias, out, n_q, n_docs, d, kp, s);
}
