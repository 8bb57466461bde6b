// 1-bit index scoring: (Q, 32·W) ±1 int8 query signs × (D, W) packed
// document sign words → (Q, D) f32 scores 0.25·dot, where dot is the ±1
// sign dot over all 32·W packed positions.
//
// Replaces src/repro/kernels/binary_ip/kernel.py::binary_ip_pallas (tile
// body _binary_ip_kernel, unpack _unpack_block) and the wrapper's ×0.25
// (repro/kernels/binary_ip/ops.py::binary_ip_scores).  Pad bits are 0 on
// the document side (encoded from −1.0) and the query pads are −1 signs,
// so they agree and count +1 each, as in repro's kernel.  The wrapper
// (repro_torch/kernels/binary_ip/ops.py) adds the α ≠ 0.5 offset terms to
// these f32 values.
//
// Numerics: with b ∈ {0, 1} a document bit and s = 2b − 1 its sign,
//   dot = Σ s_q·s = 2·Σ s_q·b − Σ s_q,
// an integer sum, exact; |dot| ≤ 32·W < 2²⁴, so 0.25f·(float)dot is the
// same f32 as int32 → f32 → ×0.25.  ``accumulate`` adds the result to the
// f32 already in ``out`` (the wrapper splits W > MAX_WORDS into chunks):
// each part is a multiple of 0.25 below 2²², so the sum is exact too.
//
// Bound on an H100 SXM (3.35 TB/s, 1,979 TOP/s int8): at Q=256, D=1M,
// W=8 it reads 0.03 GB of words and writes 1.02 GB of f32, 0.31 ms; its
// 0.13 TOP take 0.07 ms on the tensor cores.  The output bounds it, so
// the design keeps the product off the CUDA cores and the stores
// streaming:
// - tensor cores: mma.sync.m16n8k32 s8 × s8 → s32.  A = the query signs,
//   ±1 int8, in shared memory once per CTA (Σ s_q per row beside them);
//   B = the document bits as 0/1 bytes, made in registers: a k-step is one
//   word, and thread t of a quad takes its byte t (bits 0–3 → b0, 4–7 →
//   b1, by a multiply that spreads 4 bits to 4 bytes).  The query side
//   reads the same dims (8 contiguous bytes a row), so the sum is over the
//   same products.  Query rows are 32·(odd) bytes apart: no bank
//   conflicts.
// - a CTA owns up to 128 queries and walks doc tiles of 128 rows, 8 words
//   a stage, double-buffered with cp.async (16-, 8- or 4-byte copies as
//   the rows' alignment allows).  One wave of CTAs.
// - epilogue: the CTA writes its 128 × 128 tile of finished scores,
//   0.25·(2·acc − Σ s_q), to shared memory, and each of its rows goes to
//   device memory as one 512-byte bulk copy (cp.async.bulk), which the
//   copy engine runs while the CTA computes its next tile.  Tiles that
//   are partial, unaligned (D % 4 ≠ 0) or accumulated take int8_ip.cu's
//   epilogue instead: each warp stages 32×32 int32 in shared memory and
//   writes 128-byte row segments, 16 bytes a thread, with streaming (.cs)
//   stores.
// W up to MAX_WORDS (128) a launch; the queries' width sits in shared
// memory (128 queries a CTA up to 32 words, 64 up to 64, 32 above).

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_util.cuh"

namespace {

using namespace mma_util;

constexpr int BN = 128;       // documents per tile
constexpr int THREADS = 256;  // 8 warps: 2 (queries) × 4 (documents)
constexpr int KW = 8;         // words a stage: 32 bytes a document row
constexpr int STG = 40;       // staging row stride in ints (no conflicts)
constexpr int STAGE_INTS = 8 * 32 * STG;
constexpr int MAX_WORDS = 128;
constexpr int OST = BN + 4;   // output tile row stride in floats

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// bytes (a multiple of 16) from shared to global memory by the copy
// engine, asynchronously; tracked as a bulk group of the issuing thread
__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gdst), "r"(smem_addr(ssrc)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 4 bits → 4 bytes of 0/1, bit i in byte i: the shifted copies x, x<<7,
// x<<14, x<<21 do not overlap, so the product has no carries
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Shared memory: [output: the bulk path's BM × OST f32 tile, or the
// staging path's 8 warps × 32 × STG int32][words: 2 stages × BN rows × 32
// bytes][query signs: BM rows × sq bytes][Σ s_q: BM int32]
size_t out_region(int mt) {
  const size_t a = sizeof(int) * STAGE_INTS;
  const size_t b = sizeof(float) * 32 * mt * OST;
  return a > b ? a : b;
}
size_t smem_bytes(int mt, int sq) {
  return out_region(mt) + 2 * BN * KW * 4 +
         static_cast<size_t>(32 * mt) * sq + sizeof(int) * 32 * mt;
}

template <int MT, int V>
__global__ void __launch_bounds__(THREADS, MT == 4 ? 2 : 1)
binary_ip_kernel(const int8_t* __restrict__ q, int q_ld,
                 const uint32_t* __restrict__ docs, int docs_ld,
                 float* __restrict__ out, int n_q, int n_docs, int n_words,
                 int sq, int accumulate) {
  constexpr int BM = 32 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  int* stage = reinterpret_cast<int*>(smem);
  float* otile = reinterpret_cast<float*>(smem);
  constexpr size_t OUT_A = sizeof(int) * STAGE_INTS,
                   OUT_B = sizeof(float) * BM * OST;
  unsigned char* dstage = smem + (OUT_A > OUT_B ? OUT_A : OUT_B);
  unsigned char* qs = dstage + 2 * BN * KW * 4;
  int* qsum = reinterpret_cast<int*>(qs + BM * sq);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.y * BM;
  const int n_kc = (n_words + KW - 1) / KW;

  // query signs, 4 bytes at a time, zero past n_words (to n_kc·KW words)
  // and past n_q: a zero sign adds nothing to either sum
  const int row_ints = 8 * KW * n_kc;
  for (int e = threadIdx.x; e < BM * row_ints; e += THREADS) {
    const int r = e / row_ints, c = e % row_ints;
    uint32_t v = 0;
    if (q0 + r < n_q && c < 8 * n_words)
      v = *reinterpret_cast<const uint32_t*>(
          q + static_cast<size_t>(q0 + r) * q_ld + 4 * c);
    *reinterpret_cast<uint32_t*>(qs + r * sq + 4 * c) = v;
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    const unsigned char* row = qs + threadIdx.x * sq;
    int s = 0;
    for (int c = 0; c < 8 * n_words; ++c)
      s = __dp4a(*reinterpret_cast<const int*>(row + 4 * c), 0x01010101, s);
    qsum[threadIdx.x] = s;
  }

  const int n_tiles = (n_docs + BN - 1) / BN;
  const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
      ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int steps = my_tiles * n_kc;

  // stage p: words [KW·c, KW·c + KW) (c = p % n_kc) of the CTA's
  // (p / n_kc)-th tile; the words past n_words stay stale and meet zero
  // query signs
  auto load_stage = [&](int p) {
    const int tile = blockIdx.x + (p / n_kc) * gridDim.x;
    const int c = p % n_kc;
    const int per_row = min(KW, n_words - KW * c) * 4 / V;
    const int rows = min(BN, n_docs - tile * BN);
    unsigned char* buf = dstage + (p & 1) * BN * KW * 4;
    const uint32_t* src0 =
        docs + static_cast<size_t>(tile) * BN * docs_ld + KW * c;
    for (int e = threadIdx.x; e < rows * per_row; e += THREADS) {
      const int r = e / per_row, b = (e % per_row) * V;
      copy_async<V>(buf + r * KW * 4 + b,
                    reinterpret_cast<const uint8_t*>(
                        src0 + static_cast<size_t>(r) * docs_ld) + b);
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const bool vec_out = (n_docs % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int tid = threadIdx.x;
  int* wstage = stage + warp * 32 * STG;

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
    __syncthreads();  // stage p (and, first, the queries and Σ s_q)
    const unsigned char* buf = dstage + (p & 1) * BN * KW * 4;
    const int c = p % n_kc;
    const int groups = min(2, (n_words - KW * c + 3) / 4);
    for (int gi = 0; gi < groups; ++gi) {
      uint4 braw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        braw[j] = *reinterpret_cast<const uint4*>(
            buf + (wn * 32 + j * 8 + g) * KW * 4 + 16 * gi);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t w = (s == 0 ? braw[j].x : s == 1 ? braw[j].y
                              : s == 2 ? braw[j].z : braw[j].w) >> (8 * t);
          b[j][0] = spread4(w);
          b[j][1] = spread4(w >> 4);
        }
        const int word = KW * c + 4 * gi + s;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const unsigned char* qa =
              qs + (wm * 16 * MT + i * 16 + g) * sq + 32 * word + 8 * t;
          const uint2 lo = *reinterpret_cast<const uint2*>(qa);
          const uint2 hi = *reinterpret_cast<const uint2*>(qa + 8 * sq);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_s8(acc[i][j], lo.x, hi.x, lo.y, hi.y, b[j][0], b[j][1]);
        }
      }
    }
    if (c == n_kc - 1) {
      const int tile = blockIdx.x + (p / n_kc) * gridDim.x;
      // the previous tile's bulk stores have read the output region
      if (tid < BM) bulk_wait_read();
      __syncthreads();
      if (!accumulate && vec_out && (tile + 1) * BN <= n_docs) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int lr = wm * 16 * MT + i * 16 + g;
          const int s0 = qsum[lr], s1 = qsum[lr + 8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* o0 = otile + lr * OST + wn * 32 + 8 * j + 2 * t;
            *reinterpret_cast<float2*>(o0) = make_float2(
                0.25f * static_cast<float>(2 * acc[i][j][0] - s0),
                0.25f * static_cast<float>(2 * acc[i][j][1] - s0));
            *reinterpret_cast<float2*>(o0 + 8 * OST) = make_float2(
                0.25f * static_cast<float>(2 * acc[i][j][2] - s1),
                0.25f * static_cast<float>(2 * acc[i][j][3] - s1));
          }
        }
        fence_proxy_async();
        __syncthreads();
        if (tid < BM && q0 + tid < n_q)
          bulk_store(out + static_cast<size_t>(q0 + tid) * n_docs + tile * BN,
                     otile + tid * OST, BN * 4);
      } else {
        // epilogue: 32 rows (two m-tiles) at a time through the warp's stage
        const int col0 = tile * BN + wn * 32 + 4 * (lane % 8);
#pragma unroll
        for (int r0 = 0; r0 < MT; r0 += 2) {
          const int mts = MT - r0 < 2 ? MT - r0 : 2;
#pragma unroll
          for (int ii = 0; ii < mts; ++ii)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              int* p0 = wstage + (ii * 16 + g) * STG + 8 * j + 2 * t;
              *reinterpret_cast<int2*>(p0) =
                  make_int2(acc[r0 + ii][j][0], acc[r0 + ii][j][1]);
              *reinterpret_cast<int2*>(p0 + 8 * STG) =
                  make_int2(acc[r0 + ii][j][2], acc[r0 + ii][j][3]);
            }
          __syncwarp();
          for (int rr = lane / 8; rr < 16 * mts; rr += 4) {
            const int lrow = wm * 16 * MT + r0 * 16 + rr;
            const int row = q0 + lrow;
            if (row >= n_q) continue;
            const int4 a = *reinterpret_cast<const int4*>(
                wstage + rr * STG + 4 * (lane % 8));
            const int sum_q = qsum[lrow];
            float4 v = make_float4(0.25f * static_cast<float>(2 * a.x - sum_q),
                                   0.25f * static_cast<float>(2 * a.y - sum_q),
                                   0.25f * static_cast<float>(2 * a.z - sum_q),
                                   0.25f * static_cast<float>(2 * a.w - sum_q));
            float* o = out + static_cast<size_t>(row) * n_docs + col0;
            if (vec_out && col0 + 3 < n_docs) {
              if (accumulate) {
                const float4 old = *reinterpret_cast<const float4*>(o);
                v.x += old.x;
                v.y += old.y;
                v.z += old.z;
                v.w += old.w;
              }
              __stcs(reinterpret_cast<float4*>(o), v);
            } else {
              const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (col0 + e < n_docs)
                  __stcs(o + e, accumulate ? o[e] + vs[e] : vs[e]);
            }
          }
          __syncwarp();
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
    __syncthreads();  // stage p is read: load_stage(p + 2) may overwrite it
  }
  if (threadIdx.x < BM) bulk_wait_all();
}

template <int MT, int V>
int launch(const void* q, int q_ld, const void* docs, int docs_ld, void* out,
           int n_q, int n_docs, int n_words, int sq, int accumulate,
           cudaStream_t stream) {
  auto kern = binary_ip_kernel<MT, V>;
  const size_t smem = smem_bytes(MT, sq);
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
      static_cast<const int8_t*>(q), q_ld, static_cast<const uint32_t*>(docs),
      docs_ld, static_cast<float*>(out), n_q, n_docs, n_words, sq,
      accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_mt(const void* q, int q_ld, const void* docs, int docs_ld,
              void* out, int n_q, int n_docs, int n_words, int sq,
              int accumulate, cudaStream_t s) {
  // widest copy that the chunk widths, the row stride and the base allow
  const uintptr_t a = reinterpret_cast<uintptr_t>(docs);
  if (n_words % 4 == 0 && docs_ld % 4 == 0 && a % 16 == 0)
    return launch<MT, 16>(q, q_ld, docs, docs_ld, out, n_q, n_docs, n_words,
                          sq, accumulate, s);
  if (n_words % 2 == 0 && docs_ld % 2 == 0 && a % 8 == 0)
    return launch<MT, 8>(q, q_ld, docs, docs_ld, out, n_q, n_docs, n_words,
                         sq, accumulate, s);
  return launch<MT, 4>(q, q_ld, docs, docs_ld, out, n_q, n_docs, n_words, sq,
                       accumulate, s);
}

}  // namespace

// q: (n_q, ·) int8 signs, rows q_ld bytes apart (a multiple of 4, the base
// 4-byte aligned), the first 32·n_words used; docs: (n_docs, ·) 32-bit
// words, rows docs_ld words apart, the first n_words used; out: (n_q,
// n_docs) f32, overwritten, or added to when ``accumulate`` is non-zero.
// 1 ≤ n_words ≤ 128.
extern "C" int binary_ip_launch(const void* q, int q_ld, const void* docs,
                                int docs_ld, void* out, int n_q, int n_docs,
                                int n_words, int accumulate, void* stream) {
  if (n_words < 1 || n_words > MAX_WORDS || q_ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wp = (n_words + KW - 1) / KW * KW;
  const int sq = 32 * (wp + 1);  // wp is even: rows 32·odd bytes apart
  const auto s = static_cast<cudaStream_t>(stream);
  if (wp <= 32)
    return launch_mt<4>(q, q_ld, docs, docs_ld, out, n_q, n_docs, n_words,
                        sq, accumulate, s);
  if (wp <= 64)
    return launch_mt<2>(q, q_ld, docs, docs_ld, out, n_q, n_docs, n_words,
                        sq, accumulate, s);
  return launch_mt<1>(q, q_ld, docs, docs_ld, out, n_q, n_docs, n_words, sq,
                      accumulate, s);
}
