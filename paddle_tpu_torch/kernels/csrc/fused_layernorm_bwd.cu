// Fused layernorm BACKWARD kernel for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/fused_layernorm.py::_bwd_kernel
// (wrapper `_bwd`). From x, dy [n, d], gamma [d] and the forward's mean and
// rstd [n] (f32): xhat = (x - mean) * rstd, wdy = dy * gamma, the row means
// c1 = mean(wdy) and c2 = mean(wdy * xhat) in f32, dx = (wdy - c1 - xhat *
// c2) * rstd written in x's dtype; and, per block of kRowsPerBlock
// contiguous rows, one row of dgamma and dbeta partials (sums over the
// block's rows of dy * xhat and dy, f32) into dg_part, db_part [nb, d]. The
// op sums the partials over the blocks, as the JAX package leaves that sum
// to XLA. Rows past n are not read: the Pallas kernel's masked padding
// rows. No atomics: every sum is taken in a fixed order, so two calls give
// the same bits.
//
// Bound on the H100: bytes. About 13 operations per element against x and
// dy read and dx written once (6 bytes an element in bf16), far below ~295
// operations a byte; the least time is those bytes, gamma, the statistics,
// and dgamma and dbeta counted as [d] each, over 3.35 TB/s: 0.01129 ms at
// [8192, 768] in bf16, 0.02256 in f32.
//
// What the design does about it: teams over contiguous blocks of rows,
// loads ahead, and no register spent on a row in flight.
// - A block of 8 warps takes kRowsPerBlock contiguous rows. A row is held
//   by a team of warps (rowwise_common.cuh, `team_shape`): up to d = 1024
//   (512 on the scalar path) one warp, whose two row sums are shuffles with
//   no barrier, so the block holds 8 teams; a wider row 2-16 warps, which
//   meet at a named barrier of their own, 16 / tw teams a block.
// - Team t takes the block's rows t, t + teams, ... in that order. It
//   stages them in shared memory by cp.async, kStages of them (x, dy, and
//   each lane's copy of the row's mean and rstd): the copies of the next
//   two rows are in flight while it reduces the current one (`RowStages`,
//   as in the forward: 16-byte copies on both paths, a team barrier
//   between a row's copies and its reads on the scalar path).
// - Each lane keeps its columns' gamma and its dgamma / dbeta sums in
//   registers across its rows. At the end the teams' sums meet in shared
//   memory (over the stages), and each column's are added in team order
//   into the block's partial row.
// - A lane holds chunks of 16 bytes where x, dy, dx and gamma are 16-byte
//   aligned and d a multiple of 8 (bf16) or 4 (f32); else single elements.
//   x and dy are read from device memory once, dx written once; the
//   partials add 2 * nb * d floats, which the op reads back once.
// - The shared-memory request is made once a device and team width
//   (`LaunchCache`).
// Earlier drafts, measured: the next row held in registers (at 194
// registers a lane, one block of 8 warps an SM: two waves of 256 blocks),
// then the sums in shared memory; both kept fewer bytes in flight than the
// stages do. Why 8 warps, 32 rows and 3 stages: `profile_layernorm.py`
// (PERF.md section 6): 64 rows make the op's sums cheaper at d = 768 but
// leave a wide row's n / 64 blocks too few to fill the card.
//
// Measured (`compare_serve.py --layernorm P . . P`, the kernel it
// replaced in the same run; NVIDIA H100 80GB HBM3, 700.00 W, SM 1980 MHz,
// memory 2619 MHz): [8192, 768] bf16 0.02157-0.02173 ms (52% of its
// bound; the old kernel's 0.02976-0.02979; `torch.add(x, dy, out=dx)` of
// the same bytes 0.01923); the op's whole backward 0.03581-0.03587
// (0.05210-0.05242; `native_layer_norm_backward` 0.06189-0.06192); f32
// 0.03536-0.03549 (0.04173-0.04202). The scalar path at [8192, 1025]:
// bf16 0.04771-0.04774 (0.07994-0.08006). PERF.md section 6, row 7.

#include "rowwise_common.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace rowwise;

// Rows one block takes, and so one partial row per kRowsPerBlock rows;
// kernels/cuda/fused_layernorm.py::ROWS_PER_BLOCK mirrors it.
constexpr int kRowsPerBlock = 32;
constexpr int kBlockWarps = 8;
constexpr int kStages = 3;    // rows staged a team: the current one, 2 ahead

template <typename T, int VEC, int NC>
using Stages = RowStages<T, VEC, NC, 2, kStages>;   // x and dy

// Shared memory of a block of `teams` teams of `tt` threads: each team's
// stages, then its lanes' copies of each staged row's mean and rstd. After
// the rows the stages hold each team's dgamma and dbeta sums [2][d] (no
// more bytes than the stages: 8 d a team against 2 kStages d sizeof(T)).
template <typename T, int VEC, int NC>
__host__ __device__ constexpr size_t team_bytes(int tt) {
  return Stages<T, VEC, NC>::bytes(tt) + sizeof(float) * kStages * 2 * tt;
}

template <typename T, typename G, int VEC, int NC, int THREADS>
__global__ void __launch_bounds__(THREADS)
ln_bwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ dg_part, float* __restrict__ db_part, int n,
              int d, int tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * 2 * THREADS / 32];   // two buffers, in turns
  const int tt = 32 * tw;                  // threads a team
  const int teams = blockDim.x / tt;
  const int team = threadIdx.x / tt, l = threadIdx.x - team * tt;
  const int chunks = d / VEC;
  float* red0 = red + team * tw * 2;
  float* red1 = red0 + blockDim.x / 32 * 2;
  unsigned char* mine = smem + team * team_bytes<T, VEC, NC>(tt);
  Stages<T, VEC, NC> st{mine, tt, l, d};
  float* stats =
      reinterpret_cast<float*>(mine + Stages<T, VEC, NC>::bytes(tt));
  const long long r0 = (long long)blockIdx.x * kRowsPerBlock;
  const long long r1 = r0 + kRowsPerBlock < n ? r0 + kRowsPerBlock : n;
  // stage k of this team's rows: x, dy, and the lane's copies of the row's
  // mean and rstd at stats[(2 stage + 0 / 1) tt + l]
  auto stage = [&](int sg, long long row) {
    st.copy(sg, 0, x, row, n);
    st.copy(sg, 1, dy, row, n);
    cp_async4(smem_addr(stats + 2 * sg * tt + l), mu + row, true);
    cp_async4(smem_addr(stats + (2 * sg + 1) * tt + l), rstd + row, true);
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (r0 + team + k * teams < r1) stage(k, r0 + team + k * teams);
    cp_async_commit();
  }
  float g[NC][VEC], adg[NC][VEC], adb[NC][VEC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = l + i * tt;
    if (c < chunks) load_f32<G, VEC>(g[i], gamma + c * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) adg[i][j] = adb[i][j] = 0.f;
  }
  int k = 0;
  for (long long row = r0 + team; row < r1; row += teams, ++k) {
    cp_async_wait<kStages - 2>();   // this row's copies have landed
    st.sync(tw, team);              // (the team's, on the scalar path)
    const long long ahead = row + (kStages - 1) * teams;
    if (ahead < r1) stage((k + kStages - 1) % kStages, ahead);
    cp_async_commit();
    const int sg = k % kStages;
    const T* xs = st.row(sg, 0, x + row * d);
    const T* dys = st.row(sg, 1, dy + row * d);
    const float m = stats[2 * sg * tt + l], rs = stats[(2 * sg + 1) * tt + l];
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = l + i * tt;
      if (c < chunks) {
        float xv[VEC], dv[VEC];
        load_f32<T, VEC>(xv, xs + c * VEC);
        load_f32<T, VEC>(dv, dys + c * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (xv[j] - m) * rs, w = dv[j] * g[i][j];
          s[0] += w;
          s[1] += w * xh;
          adg[i][j] += dv[j] * xh;
          adb[i][j] += dv[j];
        }
      }
    }
    team_sum<2>(s, tw, team, (k & 1) ? red1 : red0);
    const float c1 = s[0] / d, c2 = s[1] / d;
    T* dxr = dx + row * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = l + i * tt;
      if (c < chunks) {
        float xv[VEC], dv[VEC];
        load_f32<T, VEC>(xv, xs + c * VEC);
        load_f32<T, VEC>(dv, dys + c * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (xv[j] - m) * rs;
          xv[j] = (dv[j] * g[i][j] - c1 - xh * c2) * rs;
        }
        store_f32<T, VEC>(dxr + c * VEC, xv);
      }
    }
  }
  // the block's partial row: the teams' sums through shared memory (over
  // the stages, once every team is done with them), each column's added
  // in team order
  cp_async_wait<0>();
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem);   // [teams][2][d]
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = l + i * tt;
    if (c < chunks) {
      store_f32<float, VEC>(sums + 2 * team * d + c * VEC, adg[i]);
      store_f32<float, VEC>(sums + (2 * team + 1) * d + c * VEC, adb[i]);
    }
  }
  __syncthreads();
  const size_t prow = (size_t)blockIdx.x * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float sg = sums[col], sb = sums[d + col];
    for (int t = 1; t < teams; ++t) {
      sg += sums[2 * t * d + col];
      sb += sums[(2 * t + 1) * d + col];
    }
    dg_part[prow + col] = sg;
    db_part[prow + col] = sb;
  }
}

template <typename T, typename G, int VEC, int NC, int THREADS>
int run(const TeamShape& sh, const void* x, const void* g, const float* mu,
        const float* rs, const void* dy, void* dx, float* dgp, float* dbp,
        int n, int d, cudaStream_t s) {
  const auto kernel = ln_bwd_kernel<T, G, VEC, NC, THREADS>;
  const int tt = 32 * sh.tw, threads = tt * sh.teams;
  const int nb = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = sh.teams * team_bytes<T, VEC, NC>(tt);
  static LaunchCache cache;   // its shared-memory request; the grid is nb
  const cudaError_t err = cache.get(kernel, sh.tw, threads, smem).err;
  if (err != cudaSuccess) return (int)err;
  kernel<<<nb, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const G*>(g), mu, rs,
      static_cast<const T*>(dy), static_cast<T*>(dx), dgp, dbp, n, d, sh.tw);
  return (int)cudaGetLastError();
}

template <typename T, typename G, int VEC>
int launch(const void* x, const void* g, const float* mu, const float* rs,
           const void* dy, void* dx, float* dgp, float* dbp, int n, int d,
           cudaStream_t s) {
  const TeamShape sh = team_shape(d / VEC, VEC, kBlockWarps);
  if (sh.tw > 1)
    return run<T, G, VEC, kTeamElems / VEC, kMaxTeamThreads>(
        sh, x, g, mu, rs, dy, dx, dgp, dbp, n, d, s);
#define PTT_LN_BWD(NC)                                                     \
  if (sh.nc == NC) {                                                       \
    if constexpr (NC * VEC <= kWarpRowElems)                               \
      return run<T, G, VEC, NC, 32 * kBlockWarps>(sh, x, g, mu, rs, dy, dx, \
                                                  dgp, dbp, n, d, s);      \
    return (int)cudaErrorInvalidValue;                                     \
  }
  PTT_LN_BWD(1) PTT_LN_BWD(2) PTT_LN_BWD(3) PTT_LN_BWD(4) PTT_LN_BWD(5)
  PTT_LN_BWD(6) PTT_LN_BWD(7) PTT_LN_BWD(8) PTT_LN_BWD(16)
#undef PTT_LN_BWD
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename G>
int by_width(const void* x, const void* g, const float* mu, const float* rs,
             const void* dy, void* dx, float* dgp, float* dbp, int n, int d,
             cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (d % V == 0 && aligned16({x, g, dy, dx}))
    return launch<T, G, V>(x, g, mu, rs, dy, dx, dgp, dbp, n, d, s);
  return launch<T, G, 1>(x, g, mu, rs, dy, dx, dgp, dbp, n, d, s);
}

}  // namespace
}  // namespace paddle_tpu_torch

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// fused_layernorm.py. x, dy and dx [n, d] contiguous, of dtype `dtype` (0
// float32, 1 bfloat16); gamma [d] of dtype `gdtype` (float32 or
// `dtype`); mu, rstd [n] float32;
// dg_part, db_part [ceil(n / kRowsPerBlock), d] float32. 1 <= d <= 8192,
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
