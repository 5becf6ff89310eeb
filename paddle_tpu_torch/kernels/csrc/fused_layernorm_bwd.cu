// Fused layernorm BACKWARD kernel for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/fused_layernorm.py::_bwd_kernel
// (wrapper `_bwd`). From x, dy [n, d], gamma [d] and the forward's mean and
// rstd [n] (f32): xhat = (x - mean) * rstd, wdy = dy * gamma, the row means
// c1 = mean(wdy) and c2 = mean(wdy * xhat) in f32, dx = (wdy - c1 - xhat *
// c2) * rstd written in x's dtype; and, per block of kRowsPerBlock rows,
// one row of dgamma and dbeta partials (sums over the block's rows of
// dy * xhat and dy, f32) into dg_part, db_part [nb, d]. The wrapper sums the
// partials over the blocks, as the JAX package leaves that sum to XLA. Rows
// past n are not read: the Pallas kernel's masked padding rows.
//
// Bound on the H100: bytes. About 12 operations per element against x and
// dy read and dx written once (6 bytes an element in bf16), far below ~295
// operations a byte; the least time is those bytes, the statistics and the
// partials over 3.35 TB/s.
//
// What the design does about it: a block walks its rows one after the
// other; each thread keeps the same chunks of every row (16-byte loads and
// stores where alignment and d allow), so its dgamma/dbeta partials for
// those columns accumulate in registers over the block's rows and are
// written once. gamma is read once per block. The two row sums of a row
// are one combined block reduction (warp shuffles plus one pass over the
// warps in shared memory). x and dy are read from device memory once, dx
// written once; the partials add 2 * nb * d floats.

#include "rowwise_common.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace rowwise;

// Rows one block walks, and so one partial row per kRowsPerBlock rows;
// kernels/cuda/fused_layernorm.py::ROWS_PER_BLOCK mirrors it.
constexpr int kRowsPerBlock = 16;

template <typename T, typename G, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
ln_bwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ dg_part, float* __restrict__ db_part, int n,
              int d) {
  __shared__ float red[64];
  const int chunks = d / VEC;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(n, r0 + kRowsPerBlock);
  float g[NV][VEC], adg[NV][VEC], adb[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) load_f32<G, VEC>(g[i], gamma + c * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) adg[i][j] = adb[i][j] = 0.f;
  }
  for (int r = r0; r < r1; ++r) {
    const size_t off = (size_t)r * d;
    const float m = mu[r], rs = rstd[r];
    float xh[NV][VEC], dv[NV][VEC];
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < chunks) {
        load_f32<T, VEC>(xh[i], x + off + c * VEC);
        load_f32<T, VEC>(dv[i], dy + off + c * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          xh[i][j] = (xh[i][j] - m) * rs;
          const float w = dv[i][j] * g[i][j];
          s[0] += w;
          s[1] += w * xh[i][j];
        }
      }
    }
    block_sum<2>(s, red);
    const float c1 = s[0] / d, c2 = s[1] / d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < chunks) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          o[j] = (dv[i][j] * g[i][j] - c1 - xh[i][j] * c2) * rs;
          adg[i][j] += dv[i][j] * xh[i][j];
          adb[i][j] += dv[i][j];
        }
        store_f32<T, VEC>(dx + off + c * VEC, o);
      }
    }
  }
  const size_t prow = (size_t)blockIdx.x * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      store_f32<float, VEC>(dg_part + prow + c * VEC, adg[i]);
      store_f32<float, VEC>(db_part + prow + c * VEC, adb[i]);
    }
  }
}

template <typename T, typename G, int VEC>
int launch(const void* x, const void* g, const float* mu, const float* rs,
           const void* dy, void* dx, float* dgp, float* dbp, int n, int d,
           cudaStream_t s) {
  int threads = 0;
  const int nv = chunks_per_thread(d / VEC, VEC, &threads);
  const int nb = (n + kRowsPerBlock - 1) / kRowsPerBlock;
#define PTT_LN_BWD(NV)                                                      \
  if (nv == NV) {                                                           \
    if constexpr (NV * VEC <= kMaxPerThread)                                \
      ln_bwd_kernel<T, G, VEC, NV><<<nb, threads, 0, s>>>(                  \
          static_cast<const T*>(x), static_cast<const G*>(g), mu, rs,       \
          static_cast<const T*>(dy), static_cast<T*>(dx), dgp, dbp, n, d);  \
    return (int)cudaGetLastError();                                         \
  }
  PTT_LN_BWD(1) PTT_LN_BWD(2) PTT_LN_BWD(4) PTT_LN_BWD(8) PTT_LN_BWD(16)
  PTT_LN_BWD(32)
#undef PTT_LN_BWD
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename G>
int by_width(const void* x, const void* g, const float* mu, const float* rs,
             const void* dy, void* dx, float* dgp, float* dbp, int n, int d,
             cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (d % V == 0 && aligned16({x, g, dy, dx, dgp, dbp}))
    return launch<T, G, V>(x, g, mu, rs, dy, dx, dgp, dbp, n, d, s);
  return launch<T, G, 1>(x, g, mu, rs, dy, dx, dgp, dbp, n, d, s);
}

}  // namespace
}  // namespace paddle_tpu_torch

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// fused_layernorm.py. x, dy and dx [n, d] contiguous, of dtype `dtype` (0
// float32, 1 bfloat16); gamma [d] of dtype `gdtype` (float32 or
// `dtype`); mu, rstd [n] float32;
// dg_part, db_part [ceil(n / 16), d] float32. 1 <= d <= 8192,
// 1 <= n < 2^31. Launches on `stream` without
// synchronising; returns the launch's cudaGetLastError().
extern "C" int fused_layernorm_bwd(const void* x, const void* gamma,
                                   const void* mu, const void* rstd,
                                   const void* dy, void* dx, void* dg_part,
                                   void* db_part, int n, int d, int dtype,
                                   int gdtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (n <= 0 || d <= 0 || d > rowwise::kMaxD)
    return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* dg = static_cast<float*>(dg_part);
  float* db = static_cast<float*>(db_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && gdtype == kFloat32)
    return by_width<float, float>(x, gamma, m, r, dy, dx, dg, db, n, d, s);
  if (dtype == kBFloat16 && gdtype == kFloat32)
    return by_width<__nv_bfloat16, float>(x, gamma, m, r, dy, dx, dg, db, n,
                                          d, s);
  if (dtype == kBFloat16 && gdtype == kBFloat16)
    return by_width<__nv_bfloat16, __nv_bfloat16>(x, gamma, m, r, dy, dx, dg,
                                                  db, n, d, s);
  return (int)cudaErrorInvalidValue;
}
