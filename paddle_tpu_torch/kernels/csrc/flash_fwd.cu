// Flash-attention FORWARD kernel for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py::_fwd_kernel
// (wrapper `_fwd`, entry `flash_attention`). For each (b*h, query row):
// online-softmax attention over the keys, the causal diagonal aligned
// bottom-right (key j visible to row i when j <= i + Sk - Sq), masked
// scores -1e30, the row sum clamped at 1e-30. Writes out [BH, Sq, D] in
// the input dtype and the row logsumexp lse [BH, Sq] in f32, which the
// backward kernels (flash_dq.cu, flash_dkv.cu) recompute the probabilities
// from.
//
// Bound on the H100: operations. The two products cost 4 * D operations
// per visible (query, key) pair, against reading q, k, v and writing out
// once: at S = 1024, D = 64 that is ~16 operations per byte in bf16,
// so the bound is the causal operation count over the dtype's peak rate.
//
// Two loops, picked by a fixed rule before the launch (`mma_takes`, the
// wrapper's `arm`): q, k, v in bfloat16 with a head dim that is a multiple
// of 16 up to 128 run on the tensor cores (flash_fwd_mma.cuh, whose header
// gives that loop's design); float32 and the other head dims run the
// CUDA-core loop below, unchanged.
//
// The CUDA-core loop: grid (query block of 64 rows, b*h), the longest
// causal blocks launched first. A block keeps its 64 scaled query rows in
// shared memory and walks the key tiles up to its last visible one,
// skipping the tiles past the causal diagonal; each K/V tile is staged in
// shared memory once and read there by every row. The score and value
// products are register-tiled (4 rows x 4 keys, or 4 rows x 4 head dims,
// per thread), and each row keeps its running max, sum and accumulator in
// f32 registers. Float32 stays on the CUDA cores because the tensor cores
// would take it only as TF32.

#include <cmath>

#include "flash_common.cuh"
#include "flash_fwd_mma.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace flash;

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, int causal,
                 float scale) {
  constexpr int BK = KeyTile<DC>::value;
  constexpr int RM = kBlockQ / 16;   // query rows per thread
  constexpr int CN = BK / 16;        // keys per thread in a score tile
  constexpr int LDP = BK + 4;        // the two ty of a warp 16 banks apart
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                  // [kBlockQ][ld], q * scale
  float* ks = qs + kBlockQ * ld;     // [BK][ld]
  float* vs = ks + BK * ld;          // [BK][ld]
  float* ps = vs + BK * ld;          // [kBlockQ][LDP], probabilities

  const int bh = blockIdx.y;
  const int nqb = (sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * kBlockQ;
  const int off = sk - sq;
  int nkb = (sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + kBlockQ - 1 + off) / BK + 1);
  const T* qp = q + (size_t)bh * sq * d;
  const T* kp = k + (size_t)bh * sk * d;
  const T* vp = v + (size_t)bh * sk * d;
  const int tx = tile_tx(), ty = tile_ty();

  stage(qs, ld, qp, q0, kBlockQ, sq, d, scale);
  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < nkb; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the previous tile is no longer read
    stage(ks, ld, kp, k0, BK, sk, d, 1.f);
    stage(vs, ld, vp, k0, BK, sk, d, 1.f);
    __syncthreads();
    float s[RM][CN];
    tile_dot<RM, CN>(s, qs, ks, ld, d);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty * RM + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        if (kpos >= sk || (causal && kpos > qpos + off)) s[i][jj] = kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        s[i][jj] = expf(s[i][jj] - m_new);
        rs += s[i][jj];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj)
        ps[(ty * RM + i) * LDP + tx + 16 * jj] = s[i][jj];
    }
    __syncthreads();
    tile_accumulate<RM, DC>(acc, ps, LDP, vs, ld, BK, d);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) orow[col] = from_float<T>(acc[i][c] / lc);
    }
    if (tx == 0) lse[(size_t)bh * sq + row] = m[i] + logf(lc);
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int bh, int sq, int sk, int d, int causal,
           float scale, cudaStream_t stream) {
  constexpr int BK = KeyTile<DC>::value;
  const size_t smem =
      ((size_t)(kBlockQ + 2 * BK) * (d + 1) + kBlockQ * (BK + 4)) *
      sizeof(float);
  auto kern = flash_fwd_kernel<T, DC>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, d, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int bh, int sq, int sk, int d, int causal,
             float scale, cudaStream_t s) {
#define PTT_FWD(DC) \
  launch<T, DC>(q, k, v, out, lse, bh, sq, sk, d, causal, scale, s)
  if (d <= 16) return PTT_FWD(1);
  if (d <= 32) return PTT_FWD(2);
  if (d <= 64) return PTT_FWD(4);
  if (d <= 128) return PTT_FWD(8);
  return PTT_FWD(16);
#undef PTT_FWD
}

}  // namespace
}  // namespace paddle_tpu_torch

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// flash_attention.py. q and out [bh, sq, d], k and v [bh, sk, d], all of
// one dtype (0 float32, 1 bfloat16) and contiguous; lse [bh, sq] float32.
// bfloat16 with mma_takes(dtype, d) takes the tensor-core loop, which needs
// q, k, v and out on 16-byte boundaries. Launches on `stream` without
// synchronising; returns the launch's cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int sq, int sk, int d,
                         int causal, float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d > 256 ||
      (causal && sq > sk))
    return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma_takes(dtype, d)) {
    if (!aligned16(q, k, v, out)) return (int)cudaErrorInvalidValue;
    return launch_flash_fwd_mma(q, k, v, out, l, bh, sq, sk, d, causal,
                                scale, s);
  }
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, out, l, bh, sq, sk, d, causal, scale, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, out, l, bh, sq, sk, d, causal,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}
