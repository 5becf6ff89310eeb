// Primitives of the tensor-core attention loops on Hopper (sm_90a), shared
// by the paged prefill loop (paged_prefill_mma.cuh), the flash forward
// loop (flash_fwd_mma.cuh) and the flash dQ and dK/dV loops
// (flash_dq_mma.cuh, flash_dkv_mma.cuh):
// shared-memory addresses, cp.async copies and their groups, ldmatrix
// (plain and transposed), the bf16 mma.sync m16n8k16 product with f32
// accumulators, bf16 packing, the special-function exp2, and the rule and
// alignment test that admit a call to these loops.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "attention_common.cuh"

namespace paddle_tpu_torch {

constexpr float kLog2e = 1.4426950408889634f;

// The rule that picks the tensor-core loops (paged_prefill_mma.cuh,
// flash_fwd_mma.cuh, flash_dq_mma.cuh, flash_dkv_mma.cuh): q in bfloat16
// and a head dim the
// 16-deep products tile exactly, up to 128 (the register budget of the
// f32 accumulators).
inline bool mma_takes(int dtype, int dh) {
  return dtype == kBFloat16 && dh > 0 && dh % 16 == 0 && dh <= 128;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device to shared memory, asynchronously; with `full`
// false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i.
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a * b for a 16x16 bf16 A (row-major), a 16x8 bf16 B (column-major)
// and a 16x8 f32 accumulator.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, `lo` in the low half (the
// lower column of an mma fragment).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x on the special-function unit, flushing subnormal results to zero:
// the exponents here are (score - row max) * log2(e) <= 0, and a masked
// score gives an exponent near -1.4e30, whose power is 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16-byte copies and stores of the tensor-core loops need every
// tensor to start on a 16-byte boundary.
inline bool aligned16(const void* a, const void* b, const void* c,
                      const void* d) {
  return ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b) |
           reinterpret_cast<size_t>(c) | reinterpret_cast<size_t>(d)) &
          15) == 0;
}

}  // namespace paddle_tpu_torch
