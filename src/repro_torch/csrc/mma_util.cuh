// Helpers shared by the kernels (int8_ip.cu, binary_ip.cu, ivf_fused.cu,
// fused_quantize.cu, topk_blocks.cu): cp.async copies into shared memory,
// bulk copies counted on an mbarrier (TMA), u8 → bf16 in registers, and
// the two mma.sync shapes the tensor-core kernels use.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mma_util {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V bytes from global to shared memory: cp.async for 16, 8 and 4 (the
// 16-byte form bypasses L1), a plain load and store for 2 and 1.
template <int V>
__device__ __forceinline__ void copy_async(void* dst, const uint8_t* src) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  } else if constexpr (V == 8 || V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(V));
  } else if constexpr (V == 2) {
    *static_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  } else {
    *static_cast<uint8_t*>(dst) = *src;
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A barrier that counts the bytes its bulk copies land (TMA), one arrival
// a phase.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

// the phase's arrival, with the bytes its copies will land
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// the phase's arrival, no copy: it completes at once
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// `bytes` contiguous bytes (a multiple of 16, 16-byte aligned) → shared
__device__ __forceinline__ void bulk_1d(uint32_t dst, const void* src,
                                        uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// two code bytes → bf16x2 (the lower byte in the lower half); exact: the
// byte becomes f32 by the 2²³ trick, and its upper half is the bf16
__device__ __forceinline__ uint32_t u8x2_to_bf16x2(uint32_t w, int lo) {
  const float a = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + lo))
                  - 8388608.f;
  const float b = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441 + lo))
                  - 8388608.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// c += A(16×16 bf16, row) · B(16×8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A(16×32 s8, row) · B(32×8 s8, col), s32 accumulators: exact
__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace mma_util
