// Fused layernorm FORWARD kernel for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/fused_layernorm.py::_fwd_kernel
// (wrapper `_fwd`, entry `fused_layer_norm`). For each row of x [n, d]:
// mean and variance in f32 (two passes over the row: the mean, then the
// mean of (x - mean)^2), rstd = rsqrt(var + eps), y = (x - mean) * rstd *
// gamma + beta written in x's dtype, and the row's mean and rstd [n] in f32
// for the backward (fused_layernorm_bwd.cu).
//
// Bound on the H100: bytes. The kernel does about 7 operations per element
// against 2-4 bytes read and 2-4 written, far below the card's ~295
// operations a byte, so the least time is x read once and y written once
// (with gamma, beta, mean and rstd) over 3.35 TB/s: 0.00753 ms at [8192,
// 768] in bf16, 0.01505 in f32.
//
// What the design does about it: rows per team, loads ahead of the
// reductions, and no register spent on a row in flight.
// - A row is held by a team of warps (rowwise_common.cuh, `team_shape`):
//   up to d = 1024 (512 on the scalar path) one warp, which sums the row
//   with shuffles alone and no barrier; a wider row 2-16 warps, which meet
//   at a named barrier of their own. A block of 16 warps holds 16 teams (or
//   16 / tw wide ones).
// - The teams walk the rows by a grid stride: no more teams than the card
//   holds at once (the kernel's occupancy), evened out so that every team
//   takes the same number of rows, give or take one.
// - Each team stages its rows in shared memory by 16-byte cp.async,
//   kStages of them: the copies of the next two rows are in flight while
//   it reduces the current one (`RowStages`). An earlier draft held the
//   next row in registers; the registers it took capped the rows in flight
//   an SM, and so the bytes.
// - Each lane loads its columns of gamma and beta once, into registers,
//   and keeps them for every row it takes.
// - Where x, y, gamma and beta are 16-byte aligned and d a multiple of 8
//   (bf16) or 4 (f32), a lane holds chunks of 16 bytes, neighbouring lanes
//   on neighbouring chunks, and copies and reads only its own. Else (the
//   scalar path) a lane holds single elements, and the team copies the
//   aligned 16-byte blocks of memory that hold the row, then meets at its
//   barrier before reading them. An earlier draft copied one element a
//   copy there (and bf16, which cp.async cannot copy, through registers):
//   0.0385 ms at [8192, 1025] in bf16, against 0.0339 now.
// - Lane 0 of a team stores the row's mean and rstd.
// - The grid and the shared-memory request are asked of the runtime once
//   a device and team width (`LaunchCache`), not at every launch.
// Why 16 warps and 3 stages: `profile_layernorm.py` (PERF.md section 6).
//
// Measured (`compare_serve.py --layernorm P . . P`, the kernel it
// replaced in the same run; NVIDIA H100 80GB HBM3, 700.00 W, SM 1980 MHz,
// memory 2619 MHz): [8192, 768] bf16 0.01478-0.01485 ms (51% of its
// bound; the old kernel's 0.01626-0.01629; `y.copy_(x)` of the same bytes
// 0.01440-0.01446), f32 0.02211-0.02224 (0.02477-0.02480). The scalar
// path is still slower than the old kernel at [8192, 1025]: bf16
// 0.03392-0.03402 against 0.03034-0.03037, f32 0.03363-0.03376 against
// 0.03315-0.03322 (PERF.md, B17).

#include "rowwise_common.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace rowwise;

constexpr int kBlockWarps = 16;
constexpr int kStages = 3;    // rows staged a team: the current one, 2 ahead

template <typename T, int VEC, int NC>
using Stages = RowStages<T, VEC, NC, 1, kStages>;

template <typename T, typename G, int VEC, int NC, int THREADS>
__global__ void __launch_bounds__(THREADS)
ln_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
              const G* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mu, float* __restrict__ rstd, int n, int d,
              int tw, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];   // teams' stages
  __shared__ float red[2 * THREADS / 32];   // two buffers, used in turns
  const int tt = 32 * tw;                   // threads a team
  const int teams = blockDim.x / tt;
  const int team = threadIdx.x / tt, l = threadIdx.x - team * tt;
  const int chunks = d / VEC;
  float* red0 = red + team * tw;
  float* red1 = red0 + blockDim.x / 32;
  Stages<T, VEC, NC> st{smem + team * Stages<T, VEC, NC>::bytes(tt), tt, l,
                        d};
  const long long stride = (long long)gridDim.x * teams;
  const long long first = (long long)blockIdx.x * teams + team;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (first + k * stride < n) st.copy(k, 0, x, first + k * stride, n);
    cp_async_commit();
  }
  float g[NC][VEC], b[NC][VEC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = l + i * tt;
    if (c < chunks) {
      load_f32<G, VEC>(g[i], gamma + c * VEC);
      load_f32<G, VEC>(b[i], beta + c * VEC);
    }
  }
  int k = 0;
  for (long long row = first; row < n; row += stride, ++k) {
    cp_async_wait<kStages - 2>();   // this row's copies have landed
    st.sync(tw, team);              // (the team's, on the scalar path)
    const long long ahead = row + (kStages - 1) * stride;
    if (ahead < n) st.copy((k + kStages - 1) % kStages, 0, x, ahead, n);
    cp_async_commit();
    const T* xs = st.row(k % kStages, 0, x + row * d);
    float v[VEC], s[1] = {0.f};
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = l + i * tt;
      if (c < chunks) {
        load_f32<T, VEC>(v, xs + c * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[0] += v[j];
      }
    }
    team_sum<1>(s, tw, team, red0);
    const float mean = s[0] / d;
    s[0] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = l + i * tt;
      if (c < chunks) {
        load_f32<T, VEC>(v, xs + c * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xc = v[j] - mean;
          s[0] += xc * xc;
        }
      }
    }
    team_sum<1>(s, tw, team, red1);
    const float rs = rsqrtf(s[0] / d + eps);
    T* yr = y + row * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = l + i * tt;
      if (c < chunks) {
        load_f32<T, VEC>(v, xs + c * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          v[j] = (v[j] - mean) * rs * g[i][j] + b[i][j];
        store_f32<T, VEC>(yr + c * VEC, v);
      }
    }
    if (l == 0) {
      mu[row] = mean;
      rstd[row] = rs;
    }
  }
}

// Blocks of `teams` teams for a grid-stride walk over n rows: at most as
// many teams as the card holds at once (`f`: the kernel's blocks an SM at
// the launch's threads and bytes, on every SM), then as few as take the
// same number of rows each.
inline int row_blocks(const LaunchFacts& f, int teams, int n) {
  const long long cap = (long long)(f.sms > 0 ? f.sms : 1) *
                        (f.per_sm > 0 ? f.per_sm : 1) * teams;
  const long long rows_each = (n + cap - 1) / cap;
  const long long need = (n + rows_each - 1) / rows_each;
  return (int)((need + teams - 1) / teams);
}

template <typename T, typename G, int VEC, int NC, int THREADS>
int run(const TeamShape& sh, const void* x, const void* g, const void* b,
        void* y, float* mu, float* rs, int n, int d, float eps,
        cudaStream_t s) {
  const auto kernel = ln_fwd_kernel<T, G, VEC, NC, THREADS>;
  const int tt = 32 * sh.tw, threads = tt * sh.teams;
  const size_t smem = sh.teams * Stages<T, VEC, NC>::bytes(tt);
  static LaunchCache cache;
  const LaunchFacts f = cache.get(kernel, sh.tw, threads, smem);
  if (f.err != cudaSuccess) return (int)f.err;
  kernel<<<row_blocks(f, sh.teams, n), threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const G*>(g),
      static_cast<const G*>(b), static_cast<T*>(y), mu, rs, n, d, sh.tw, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename G, int VEC>
int launch(const void* x, const void* g, const void* b, void* y, float* mu,
           float* rs, int n, int d, float eps, cudaStream_t s) {
  const TeamShape sh = team_shape(d / VEC, VEC, kBlockWarps);
  if (sh.tw > 1)
    return run<T, G, VEC, kTeamElems / VEC, kMaxTeamThreads>(
        sh, x, g, b, y, mu, rs, n, d, eps, s);
#define PTT_LN_FWD(NC)                                                     \
  if (sh.nc == NC) {                                                       \
    if constexpr (NC * VEC <= kWarpRowElems)                               \
      return run<T, G, VEC, NC, 32 * kBlockWarps>(sh, x, g, b, y, mu, rs,  \
                                                  n, d, eps, s);           \
    return (int)cudaErrorInvalidValue;                                     \
  }
  PTT_LN_FWD(1) PTT_LN_FWD(2) PTT_LN_FWD(3) PTT_LN_FWD(4) PTT_LN_FWD(5)
  PTT_LN_FWD(6) PTT_LN_FWD(7) PTT_LN_FWD(8) PTT_LN_FWD(16)
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
