// Batch norm FORWARD in training for Hopper (sm_90a): the batch
// statistics and the normalized, scaled and shifted output.
//
// Replaces no TPU kernel: the JAX package computes `batch_norm`
// (paddle_tpu/nn/functional/norm.py:14, its `prim` in training) as fused
// XLA elementwise and reduction ops, with no pallas_call. The port added
// it because the op-for-op PyTorch version took ~155 of a ResNet50 graph
// step's 175 ms of device time at B=256 (profile_static.py resnet50,
// PERF.md section 6).
//
// For x viewed as [outer, C, inner] (batch_norm_common.cuh), a channel's
// n = outer * inner elements: mean and biased variance (the shifted-data
// sums, in f32 a thread, in f64 across splits), rstd = 1 / sqrt(var +
// eps), and y = (x - mean) * (rstd * w) + b in f32, written in y's dtype
// (x's, or f32 where w or b is f32 beside a bf16 x). w and b come as f32
// (ones and zeros when the layer has none). mean, var and rstd [C] are
// written in f32 for the running statistics and the backward.
//
// Bound on the H100: bytes. A few operations an element against 2-4 bytes
// read and 2-4 written; the least time is x read once and y written once
// over 3.35 TB/s (0.245 ms at [256, 64, 112, 112] in bf16, the largest
// norm of ResNet50 at B=256).
//
// What the design does about it, and what it leaves: three launches on the
// caller's stream, no atomics (deterministic, graph-safe). (1)
// partial_sums, grid (C, S): S splits of each channel's units, enough
// blocks to fill the card, 16-byte loads where inner allows, neighbouring
// threads on neighbouring units; (2) finalize, a thread a channel; (3)
// apply, a grid-stride pass over every unit, its channel found by two
// multiply-shift divisions. x is read twice (statistics, then apply):
// 1.5x the bound's bytes at best. A channels-last tensor (inner = 1) reads
// a channel's elements C apart, uncoalesced: correct, slow, off ResNet's
// NCHW path.

#include "batch_norm_common.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace bn;

template <typename TX>
__global__ void finalize_stats(const TX* __restrict__ x,
                               const float* __restrict__ part,
                               float* __restrict__ mean,
                               float* __restrict__ var,
                               float* __restrict__ rstd, int C, int64_t inner,
                               int S, double n, float eps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double sa = 0.0, sb = 0.0;
  for (int s = 0; s < S; ++s) {
    sa += part[((int64_t)c * S + s) * 2];
    sb += part[((int64_t)c * S + s) * 2 + 1];
  }
  const double shift = to_f(x[(int64_t)c * inner]);
  const double m = sa / n;
  double v = sb / n - m * m;
  if (v < 0.0) v = 0.0;
  mean[c] = (float)(shift + m);
  var[c] = (float)v;
  rstd[c] = 1.0f / sqrtf((float)v + eps);
}

template <typename TX, typename TY, int V>
__global__ void __launch_bounds__(kThreads)
apply_fwd(const TX* __restrict__ x, TY* __restrict__ y,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          const float* __restrict__ w, const float* __restrict__ b,
          Div by_row, Div by_c, uint32_t total_units) {
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t u = blockIdx.x * kThreads + threadIdx.x; u < total_units;
       u += stride) {
    const int c = channel_of(u, by_row, by_c);
    const float m = mean[c], sc = rstd[c] * w[c], sh = b[c];
    float v[V];
    load<TX, V>(x + (int64_t)u * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = fmaf(v[j] - m, sc, sh);
    store<TY, V>(y + (int64_t)u * V, v);
  }
}

template <typename TX, typename TY, int V>
int run(const void* x, const float* w, const float* b, void* y, float* mean,
        float* var, float* rstd, float* part, int64_t outer, int C,
        int64_t inner, int S, float eps, int max_blocks, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const uint32_t units_row = (uint32_t)(inner / V);
  const uint32_t units = (uint32_t)(outer * units_row);
  const Div by_row = make_div(units_row);
  partial_sums<TX, TX, V, false><<<dim3(C, S), kThreads, 0, st>>>(
      xp, nullptr, nullptr, part, C, units_row, by_row, units, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finalize_stats<TX><<<(C + 127) / 128, 128, 0, st>>>(
      xp, part, mean, var, rstd, C, inner, S, (double)outer * inner, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const uint32_t total = units * (uint32_t)C;
  apply_fwd<TX, TY, V><<<apply_grid(total, max_blocks), kThreads, 0, st>>>(
      xp, static_cast<TY*>(y), mean, rstd, w, b, by_row, make_div(C), total);
  return (int)cudaGetLastError();
}

template <typename TX, typename TY>
int by_vec(int vec, const void* x, const float* w, const float* b, void* y,
           float* mean, float* var, float* rstd, float* part, int64_t outer,
           int C, int64_t inner, int S, float eps, int max_blocks,
           cudaStream_t st) {
  switch (vec) {
    case 1: return run<TX, TY, 1>(x, w, b, y, mean, var, rstd, part, outer,
                                  C, inner, S, eps, max_blocks, st);
    case 2: return run<TX, TY, 2>(x, w, b, y, mean, var, rstd, part, outer,
                                  C, inner, S, eps, max_blocks, st);
    case 4: return run<TX, TY, 4>(x, w, b, y, mean, var, rstd, part, outer,
                                  C, inner, S, eps, max_blocks, st);
    case 8:
      if constexpr (sizeof(TX) == 2)
        return run<TX, TY, 8>(x, w, b, y, mean, var, rstd, part, outer, C,
                              inner, S, eps, max_blocks, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paddle_tpu_torch

// x [outer, C, inner] contiguous in x_dtype; w, b [C] f32; y like x in
// y_dtype; mean, var, rstd [C] f32; part [C * S * 2] f32 scratch. vec: the
// elements a load (1, 2, 4, or 8 for bf16 x), dividing inner, every
// pointer aligned to it. Returns a cudaError_t (0 on success).
extern "C" int batch_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mean, void* var, void* rstd,
                              void* part, long long outer, int C,
                              long long inner, int S, int vec, float eps,
                              int x_dtype, int y_dtype, int max_blocks,
                              void* stream) {
  using namespace paddle_tpu_torch;
  using namespace paddle_tpu_torch::bn;
  if (outer <= 0 || C <= 0 || inner <= 0 || S <= 0 || inner % vec != 0 ||
      outer * inner / vec * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  float* r = static_cast<float*>(rstd);
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && y_dtype == kFloat32)
    return by_vec<float, float>(vec, x, wp, bp, y, m, v, r, p, outer, C,
                                inner, S, eps, max_blocks, st);
  if (x_dtype == kBFloat16 && y_dtype == kBFloat16)
    return by_vec<__nv_bfloat16, __nv_bfloat16>(vec, x, wp, bp, y, m, v, r,
                                                p, outer, C, inner, S, eps,
                                                max_blocks, st);
  if (x_dtype == kBFloat16 && y_dtype == kFloat32)
    return by_vec<__nv_bfloat16, float>(vec, x, wp, bp, y, m, v, r, p, outer,
                                        C, inner, S, eps, max_blocks, st);
  return (int)cudaErrorInvalidValue;
}
