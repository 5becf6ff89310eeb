// Device helpers shared by the row-wise kernels (fused_layernorm_fwd.cu,
// fused_layernorm_bwd.cu, rotary.cu): packed loads and stores of a few
// neighbouring elements as f32, the block-wide sum, and the choice of how
// many chunks of a row each thread holds.
//
// A row of d elements is cut into chunks of VEC neighbouring elements
// (VEC = 16 bytes of the element type where every pointer is 16-byte
// aligned and d is a multiple of VEC, else 1). Thread t of a block holds
// chunks t, t + blockDim.x, ..., NV of them, in registers, so a row is read
// from device memory once.
#pragma once

#include <cstdint>
#include <initializer_list>

#include "attention_common.cuh"

namespace paddle_tpu_torch {
namespace rowwise {

constexpr int kMaxThreads = 256;
constexpr int kMaxPerThread = 32;   // elements a thread holds: d <= 8192
constexpr int kMaxD = kMaxThreads * kMaxPerThread;

// VEC neighbouring elements, loaded or stored in one instruction where
// they span at most 16 bytes (two where they span 32: 8 floats).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC <= 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_f32(float (&out)[VEC],
                                         const T* __restrict__ p) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_float(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_f32(T* __restrict__ p,
                                          const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_float<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// Sums each of v[0..N) over the block (blockDim.x a multiple of 32, at
// most 1024); every thread ends with the same sums, added in the same
// order. `red` holds 32 * N floats of shared memory; the leading barrier
// lets a caller reuse it from one call to the next.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[w * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int j = 0; j < nw; ++j) s += red[j * N + i];
    v[i] = s;
  }
}

// True when every pointer is 16-byte aligned (null pointers pass).
__host__ inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// Chunks per thread (a power of two, at most kMaxPerThread / VEC) and
// threads per block (a multiple of 32, at most kMaxThreads) for a row of
// `chunks` chunks; -1 when the row does not fit.
__host__ inline int chunks_per_thread(int chunks, int vec, int* threads) {
  int nv = 1;
  while (nv * vec < kMaxPerThread && chunks > nv * kMaxThreads) nv *= 2;
  const int t = ((chunks + nv - 1) / nv + 31) / 32 * 32;
  if (t > kMaxThreads) return -1;
  *threads = t;
  return nv;
}

}  // namespace rowwise
}  // namespace paddle_tpu_torch
