// Fused layernorm FORWARD kernel for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/fused_layernorm.py::_fwd_kernel
// (wrapper `_fwd`, entry `fused_layer_norm`). For each row of x [n, d]:
// mean and variance in f32 (two passes over the row held in registers),
// rstd = rsqrt(var + eps), y = (x - mean) * rstd * gamma + beta written in
// x's dtype, and the row's mean and rstd [n] in f32 for the backward
// (fused_layernorm_bwd.cu).
//
// Bound on the H100: bytes. The kernel does about 8 operations per element
// against 2-4 bytes read and 2-4 written, far below the card's ~295
// operations a byte, so the least time is x read once and y written once
// over 3.35 TB/s.
//
// What the design does about it: one block per row, each element read from
// device memory once and written once. Loads and stores are 16 bytes a
// thread where the pointers are 16-byte aligned and d a multiple of 8 (bf16)
// or 4 (f32); neighbouring threads take neighbouring chunks, so a warp's
// accesses coalesce. The row stays in registers between the statistics and
// the output (at most 32 elements a thread, d <= 8192), and the two sums are
// warp shuffles plus one pass over the block's warps in shared memory.
// gamma and beta are read through the read-only path and stay in L2.

#include "rowwise_common.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace rowwise;

template <typename T, typename G, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
ln_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
              const G* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mu, float* __restrict__ rstd, int d,
              float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int chunks = d / VEC;
  float v[NV][VEC];
  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      load_f32<T, VEC>(v[i], xr + c * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[0] += v[i][j];
    }
  }
  block_sum<1>(s, red);
  const float mean = s[0] / d;
  s[0] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (threadIdx.x + i * blockDim.x < chunks) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] -= mean;
        s[0] += v[i][j] * v[i][j];
      }
    }
  }
  block_sum<1>(s, red);
  const float rs = rsqrtf(s[0] / d + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      float g[VEC], b[VEC];
      load_f32<G, VEC>(g, gamma + c * VEC);
      load_f32<G, VEC>(b, beta + c * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = v[i][j] * rs * g[j] + b[j];
      store_f32<T, VEC>(yr + c * VEC, v[i]);
    }
  }
  if (threadIdx.x == 0) {
    mu[row] = mean;
    rstd[row] = rs;
  }
}

template <typename T, typename G, int VEC>
int launch(const void* x, const void* g, const void* b, void* y, float* mu,
           float* rs, int n, int d, float eps, cudaStream_t s) {
  int threads = 0;
  const int nv = chunks_per_thread(d / VEC, VEC, &threads);
#define PTT_LN_FWD(NV)                                                      \
  if (nv == NV) {                                                           \
    if constexpr (NV * VEC <= kMaxPerThread)                                \
      ln_fwd_kernel<T, G, VEC, NV><<<n, threads, 0, s>>>(                   \
          static_cast<const T*>(x), static_cast<const G*>(g),               \
          static_cast<const G*>(b), static_cast<T*>(y), mu, rs, d, eps);    \
    return (int)cudaGetLastError();                                         \
  }
  PTT_LN_FWD(1) PTT_LN_FWD(2) PTT_LN_FWD(4) PTT_LN_FWD(8) PTT_LN_FWD(16)
  PTT_LN_FWD(32)
#undef PTT_LN_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename G>
int by_width(const void* x, const void* g, const void* b, void* y, float* mu,
             float* rs, int n, int d, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (d % V == 0 && aligned16({x, g, b, y}))
    return launch<T, G, V>(x, g, b, y, mu, rs, n, d, eps, s);
  return launch<T, G, 1>(x, g, b, y, mu, rs, n, d, eps, s);
}

}  // namespace
}  // namespace paddle_tpu_torch

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// fused_layernorm.py. x and y [n, d] contiguous, of dtype `dtype` (0 float32,
// 1 bfloat16); gamma and beta [d] of dtype `gdtype` (float32 or `dtype`); mu and
// rstd [n] float32. 1 <= d <= 8192, 1 <= n < 2^31. Launches on `stream`
// without synchronising; returns the launch's cudaGetLastError().
extern "C" int fused_layernorm_fwd(const void* x, const void* gamma,
                                   const void* beta, void* y, void* mu,
                                   void* rstd, int n, int d, float eps,
                                   int dtype, int gdtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (n <= 0 || d <= 0 || d > rowwise::kMaxD) return (int)cudaErrorInvalidValue;
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && gdtype == kFloat32)
    return by_width<float, float>(x, gamma, beta, y, m, r, n, d, eps, s);
  if (dtype == kBFloat16 && gdtype == kFloat32)
    return by_width<__nv_bfloat16, float>(x, gamma, beta, y, m, r, n, d, eps,
                                          s);
  if (dtype == kBFloat16 && gdtype == kBFloat16)
    return by_width<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, m, r, n,
                                                  d, eps, s);
  return (int)cudaErrorInvalidValue;
}
