// Shared pieces of the batch norm kernels (batch_norm_fwd.cu,
// batch_norm_bwd.cu).
//
// A tensor is viewed as [outer, C, inner], contiguous: NCHW is [N, C, H *
// W], a channels-last tensor [N * H * W, C, 1], [N, C] is [N, C, 1]. A
// "unit" is V consecutive elements of one (outer, channel) row (the wrapper
// picks V so that inner % V == 0 and every pointer is aligned to V
// elements), loaded or stored as one vector of up to 16 bytes a tensor.
//
// The per-channel sums (the statistics of the forward, the two gradient
// sums of the backward) are deterministic: a block of kThreads threads
// takes a fixed range of one channel's units, each thread sums its units in
// order in f32, the block adds its threads by a fixed shuffle tree and then
// its warps in order, and one partial pair a (channel, split) lands in a
// scratch buffer, which a second kernel adds in split order in f64. No
// atomics: the same inputs give the same bits on every run, as a captured
// CUDA graph's replay must.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paddle_tpu_torch {
namespace bn {

constexpr int kFloat32 = 0, kBFloat16 = 1;   // kernels/cuda DTYPE_CODES
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Vec<T, V> r = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f(r.v[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Vec<T, V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.v[j] = from_f<T>(in[j]);
  *reinterpret_cast<Vec<T, V>*>(p) = r;
}

// n / d for n < 2^31 without a division instruction (the multiply-shift of
// PyTorch's IntDivider); the host fills it in `make_div`.
struct Div {
  uint32_t d, m, s;
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

inline Div make_div(uint32_t d) {
  uint32_t s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return Div{d, (uint32_t)m, s};
}

// The two sums of a block's threads, by a fixed tree: the result in
// thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float red[2 * kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sa += red[w];
      sb += red[kWarps + w];
    }
    a = sa;
    b = sb;
  }
}

// One (channel, split)'s partial sums over its units: grid (C, S). The
// forward (DY = void) sums d = x - shift and d * d, shift = the channel's
// first element (the shifted-data form of the variance: no cancellation
// while the mean stays within a few deviations of one sample); the
// backward sums dy and dy * (x - mean). Writes part[(c * S + s) * 2 + {0,
// 1}].
template <typename TX, typename TD, int V, bool kBwd>
__global__ void __launch_bounds__(kThreads)
partial_sums(const TX* __restrict__ x, const TD* __restrict__ dy,
             const float* __restrict__ mean, float* __restrict__ part,
             int C, uint32_t units_row, Div by_row, uint32_t units, int S) {
  const int c = blockIdx.x, s = blockIdx.y;
  const uint32_t u0 = (uint32_t)((uint64_t)units * s / S);
  const uint32_t u1 = (uint32_t)((uint64_t)units * (s + 1) / S);
  const int64_t inner = (int64_t)units_row * V;
  const float shift = kBwd ? mean[c] : to_f(x[(int64_t)c * inner]);
  float a = 0.f, b = 0.f;
  for (uint32_t u = u0 + threadIdx.x; u < u1; u += kThreads) {
    const uint32_t o = by_row(u);
    const int64_t off = ((int64_t)o * C + c) * inner +
                        (int64_t)(u - o * units_row) * V;
    float xv[V];
    load<TX, V>(x + off, xv);
    if constexpr (kBwd) {
      float dv[V];
      load<TD, V>(dy + off, dv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a += dv[j];
        b = fmaf(dv[j], xv[j] - shift, b);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = xv[j] - shift;
        a += d;
        b = fmaf(d, d, b);
      }
    }
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    part[((int64_t)c * S + s) * 2] = a;
    part[((int64_t)c * S + s) * 2 + 1] = b;
  }
}

// The channel of unit u of the whole tensor: its row u / units_row is
// outer * C + c.
__device__ __forceinline__ int channel_of(uint32_t u, Div by_row, Div by_c) {
  const uint32_t row = by_row(u);
  return (int)(row - by_c(row) * by_c.d);
}

inline int apply_grid(uint32_t total_units, int max_blocks) {
  const uint32_t need = (total_units + kThreads - 1) / kThreads;
  return (int)(need < (uint32_t)max_blocks ? need : (uint32_t)max_blocks);
}

}  // namespace bn
}  // namespace paddle_tpu_torch
