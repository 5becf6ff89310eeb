// Batch norm BACKWARD in training for Hopper (sm_90a): dx, dw and db from
// dy, x and the forward's mean and rstd.
//
// Replaces no TPU kernel: the JAX package differentiates its training
// `batch_norm` prim (paddle_tpu/nn/functional/norm.py:27-41) through XLA,
// with no pallas_call. Added with batch_norm_fwd.cu for the same reason:
// the op-for-op backward was most of a ResNet50 step on the card.
//
// For x viewed as [outer, C, inner] (batch_norm_common.cuh) and a
// channel's n elements, with xhat = (x - mean) * rstd: db = sum(dy), dw =
// sum(dy * xhat) = rstd * sum(dy * (x - mean)), and the closed form of the
// gradient through the batch statistics,
//   dx = rstd * w * (dy - db / n - xhat * dw / n)
//      = k1 * dy + k2 * (x - mean) + k3,
// k1 = rstd * w, k2 = -k1 * rstd * dw / n, k3 = -k1 * db / n, computed a
// channel in f64 and applied in f32; dx in x's dtype, dw and db [C] in f32
// (the wrapper casts them to the parameters' dtypes). dy comes in y's
// dtype: x's, or f32 beside a bf16 x.
//
// Bound on the H100: bytes. The least time is dy and x read once and dx
// written once over 3.35 TB/s (0.368 ms at [256, 64, 112, 112] in bf16).
//
// What the design does about it, and what it leaves: the forward's three
// launches again, no atomics (deterministic, graph-safe). (1) the two sums
// a (channel, split), (2) finalize, a thread a channel, (3) the dx pass,
// grid-stride. dy and x are read twice: 5/3 of the bound's bytes at best.
// Channels-last (inner = 1) is correct and slow, as in the forward.

#include "batch_norm_common.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace bn;

__global__ void finalize_grads(const float* __restrict__ part,
                               const float* __restrict__ rstd,
                               const float* __restrict__ w,
                               float* __restrict__ dw, float* __restrict__ db,
                               float* __restrict__ coef, int C, int S,
                               double n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double sa = 0.0, sb = 0.0;
  for (int s = 0; s < S; ++s) {
    sa += part[((int64_t)c * S + s) * 2];
    sb += part[((int64_t)c * S + s) * 2 + 1];
  }
  const double r = rstd[c];
  const double dwv = r * sb;
  dw[c] = (float)dwv;
  db[c] = (float)sa;
  const double k1 = r * (double)w[c];
  coef[c] = (float)k1;
  coef[C + c] = (float)(-k1 * r * dwv / n);
  coef[2 * C + c] = (float)(-k1 * sa / n);
}

template <typename TX, typename TD, int V>
__global__ void __launch_bounds__(kThreads)
apply_bwd(const TX* __restrict__ x, const TD* __restrict__ dy,
          TX* __restrict__ dx, const float* __restrict__ mean,
          const float* __restrict__ coef, int C, Div by_row, Div by_c,
          uint32_t total_units) {
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t u = blockIdx.x * kThreads + threadIdx.x; u < total_units;
       u += stride) {
    const int c = channel_of(u, by_row, by_c);
    const float m = mean[c], k1 = coef[c], k2 = coef[C + c],
                k3 = coef[2 * C + c];
    float xv[V], dv[V];
    load<TX, V>(x + (int64_t)u * V, xv);
    load<TD, V>(dy + (int64_t)u * V, dv);
#pragma unroll
    for (int j = 0; j < V; ++j)
      xv[j] = fmaf(k1, dv[j], fmaf(k2, xv[j] - m, k3));
    store<TX, V>(dx + (int64_t)u * V, xv);
  }
}

template <typename TX, typename TD, int V>
int run(const void* x, const void* dy, const float* mean, const float* rstd,
        const float* w, void* dx, float* dw, float* db, float* part,
        float* coef, int64_t outer, int C, int64_t inner, int S,
        int max_blocks, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TD* dp = static_cast<const TD*>(dy);
  const uint32_t units_row = (uint32_t)(inner / V);
  const uint32_t units = (uint32_t)(outer * units_row);
  const Div by_row = make_div(units_row);
  partial_sums<TX, TD, V, true><<<dim3(C, S), kThreads, 0, st>>>(
      xp, dp, mean, part, C, units_row, by_row, units, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finalize_grads<<<(C + 127) / 128, 128, 0, st>>>(
      part, rstd, w, dw, db, coef, C, S, (double)outer * inner);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const uint32_t total = units * (uint32_t)C;
  apply_bwd<TX, TD, V><<<apply_grid(total, max_blocks), kThreads, 0, st>>>(
      xp, dp, static_cast<TX*>(dx), mean, coef, C, by_row, make_div(C),
      total);
  return (int)cudaGetLastError();
}

template <typename TX, typename TD>
int by_vec(int vec, const void* x, const void* dy, const float* mean,
           const float* rstd, const float* w, void* dx, float* dw, float* db,
           float* part, float* coef, int64_t outer, int C, int64_t inner,
           int S, int max_blocks, cudaStream_t st) {
  switch (vec) {
    case 1: return run<TX, TD, 1>(x, dy, mean, rstd, w, dx, dw, db, part,
                                  coef, outer, C, inner, S, max_blocks, st);
    case 2: return run<TX, TD, 2>(x, dy, mean, rstd, w, dx, dw, db, part,
                                  coef, outer, C, inner, S, max_blocks, st);
    case 4: return run<TX, TD, 4>(x, dy, mean, rstd, w, dx, dw, db, part,
                                  coef, outer, C, inner, S, max_blocks, st);
    case 8:
      if constexpr (sizeof(TX) == 2)
        return run<TX, TD, 8>(x, dy, mean, rstd, w, dx, dw, db, part, coef,
                              outer, C, inner, S, max_blocks, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paddle_tpu_torch

// x [outer, C, inner] contiguous in x_dtype; dy like x in dy_dtype; mean,
// rstd, w [C] f32; dx like x in x_dtype; dw, db [C] f32; part [C * S * 2]
// and coef [3 * C] f32 scratch; vec as batch_norm_fwd's. Returns a
// cudaError_t (0 on success).
extern "C" int batch_norm_bwd(const void* x, const void* dy, const void* mean,
                              const void* rstd, const void* w, void* dx,
                              void* dw, void* db, void* part, void* coef,
                              long long outer, int C, long long inner, int S,
                              int vec, int x_dtype, int dy_dtype,
                              int max_blocks, void* stream) {
  using namespace paddle_tpu_torch;
  using namespace paddle_tpu_torch::bn;
  if (outer <= 0 || C <= 0 || inner <= 0 || S <= 0 || inner % vec != 0 ||
      outer * inner / vec * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* wp = static_cast<const float*>(w);
  float* dwp = static_cast<float*>(dw);
  float* dbp = static_cast<float*>(db);
  float* p = static_cast<float*>(part);
  float* k = static_cast<float*>(coef);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && dy_dtype == kFloat32)
    return by_vec<float, float>(vec, x, dy, m, r, wp, dx, dwp, dbp, p, k,
                                outer, C, inner, S, max_blocks, st);
  if (x_dtype == kBFloat16 && dy_dtype == kBFloat16)
    return by_vec<__nv_bfloat16, __nv_bfloat16>(vec, x, dy, m, r, wp, dx,
                                                dwp, dbp, p, k, outer, C,
                                                inner, S, max_blocks, st);
  if (x_dtype == kBFloat16 && dy_dtype == kFloat32)
    return by_vec<__nv_bfloat16, float>(vec, x, dy, m, r, wp, dx, dwp, dbp,
                                        p, k, outer, C, inner, S, max_blocks,
                                        st);
  return (int)cudaErrorInvalidValue;
}
