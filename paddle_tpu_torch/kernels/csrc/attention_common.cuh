// Device helpers shared by the paged decode and paged prefill kernels:
// element conversion, warp reductions, the read of one float or int8 K/V
// pool element, and the online-softmax fold of one tile of keys into one
// query row held by a warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace paddle_tpu_torch {

constexpr float kNegInf = -1e30f;   // the masked-score value of the JAX kernels
constexpr unsigned kFullMask = 0xffffffffu;

// dtype codes passed across the C boundary (the wrappers use the same)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly reductions: every lane ends with the same value (each stage
// adds the same two operands on both partners, so the order is identical).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// One element of a K or V pool [num_pages, page_size, nh, dh] as f32:
// element `i` of the pool, whose token slot ((page * page_size + offset) *
// nh + head) is `slot`. A float pool converts; an int8 pool widens the
// value and multiplies it by its slot's f32 scale BEFORE any product, as
// the Pallas quant arm does (`k = int8.astype(f32) * ks[:, None]`), so the
// scores round as there. The pools are read-only while a kernel runs, so
// the loads take the read-only path.
template <typename P>
__device__ __forceinline__ float pool_value(const P* __restrict__ pool,
                                            const float* __restrict__ scale,
                                            size_t i, size_t slot) {
  if constexpr (std::is_same_v<P, signed char>)
    return (float)__ldg(pool + i) * __ldg(scale + slot);
  else
    return to_float(__ldg(pool + i));
}

// A prefill chunk's `start` (absolute position of its first row) and
// `valid` (its live rows), read once from device memory: a captured CUDA
// graph replays the pointers, so each replay sees the values uploaded for
// it. Clamped so that no value can index out of bounds, whatever the
// caller wrote: valid to [0, c] (the rows of q and out), start to [0, cap]
// (cap = pages_per_slot * page_size, the slot's positions; a larger start
// sees the same keys, all of them). Every later index derives from these.
struct ChunkBounds {
  int start, valid;
};
__device__ __forceinline__ ChunkBounds load_chunk_bounds(
    const int* __restrict__ start, const int* __restrict__ valid, int c,
    int cap) {
  return {min(max(__ldg(start), 0), cap), min(max(__ldg(valid), 0), c)};
}

// Folds keys [0, n) of one tile (n <= 32; the caller has already cut the
// tile at the causal limit, so every key here is visible) into the running
// softmax state (m, l, acc) of one query row. Lane `lane` holds dims
// lane + 32 * i of q and acc. key(t, d) / val(t, d) return key t's value at
// dim d as float. Scores and probabilities are f32, as in the TPU kernels:
// each tile costs one max, one exp per key and one rescale of acc.
template <int DPL, typename KeyAt, typename ValAt>
__device__ __forceinline__ void fold_tile(const float (&q)[DPL],
                                          float (&acc)[DPL], float& m,
                                          float& l, int n, int dh,
                                          KeyAt key, ValAt val) {
  const int lane = threadIdx.x & 31;
  float my_s = kNegInf;   // lane t keeps the score of key t
  for (int t = 0; t < n; ++t) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) s += q[i] * key(t, d);
    }
    s = warp_sum(s);
    if (lane == t) my_s = s;
  }
  const float m_new = fmaxf(m, warp_max(my_s));
  const float p = lane < n ? expf(my_s - m_new) : 0.f;
  const float alpha = expf(m - m_new);
  l = l * alpha + warp_sum(p);
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
  for (int t = 0; t < n; ++t) {
    const float pt = __shfl_sync(kFullMask, p, t);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) acc[i] += pt * val(t, d);
    }
  }
  m = m_new;
}

}  // namespace paddle_tpu_torch
