// Flash-attention BACKWARD kernel for dQ, Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py::_dq_kernel (the
// first `pl.pallas_call` of `_bwd`). For each query row it recomputes the
// probabilities from the forward's saved logsumexp, P = exp(s - lse) (0
// where masked: keys past the bottom-right causal diagonal or past Sk),
// and sums dQ = scale * sum_j P (dP - delta) K_j with dP = dO V^T and
// delta = rowsum(dO * O), computed in f32 outside the kernel as `_bwd`
// does. dq is written in q's dtype, each row by exactly one block, so no
// atomics are needed and a run repeats bit for bit.
//
// Bound on the H100: operations. Three products (scores, dP, dS K) cost
// 6 * D operations per visible (query, key) pair, against reading q, k, v,
// dO, lse and delta and writing dq once.
//
// Two loops, picked by a fixed rule before the launch (`mma_takes`, the
// wrapper's `dq_arm`): q, k, v and dO in bfloat16 with a head dim that is
// a multiple of 16 up to 128 run on the tensor cores (flash_dq_mma.cuh,
// whose header gives that loop's design); float32 and the other head dims
// run the CUDA-core loop below, unchanged. Float32 stays on the CUDA cores
// because the tensor cores would take it only as TF32.
//
// The CUDA-core loop: grid (query block of 64 rows, b*h), the longest
// causal blocks first, as in flash_fwd.cu. A block keeps its scaled q rows
// and their dO rows in shared memory, walks the key tiles up to its last
// visible one (the tiles past the causal diagonal are skipped), stages
// each K/V tile once, forms the scores and dP in one register-tiled pass
// over the head dim, and accumulates its dq rows in f32 registers.

#include "flash_common.cuh"
#include "flash_dq_mma.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace flash;

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int sq,
                int sk, int d, int causal, float scale) {
  constexpr int BK = KeyTile<DC>::value;
  constexpr int RM = kBlockQ / 16;
  constexpr int CN = BK / 16;
  constexpr int LDP = BK + 4;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                  // [kBlockQ][ld], q * scale
  float* dos = qs + kBlockQ * ld;    // [kBlockQ][ld]
  float* ks = dos + kBlockQ * ld;    // [BK][ld]
  float* vs = ks + BK * ld;          // [BK][ld]
  float* dss = vs + BK * ld;         // [kBlockQ][LDP], dS

  const int bh = blockIdx.y;
  const int nqb = (sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * kBlockQ;
  const int off = sk - sq;
  int nkb = (sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + kBlockQ - 1 + off) / BK + 1);
  const size_t qbase = (size_t)bh * sq;
  const T* kp = k + (size_t)bh * sk * d;
  const T* vp = v + (size_t)bh * sk * d;
  const int tx = tile_tx(), ty = tile_ty();

  stage(qs, ld, q + qbase * d, q0, kBlockQ, sq, d, scale);
  stage(dos, ld, dout + qbase * d, q0, kBlockQ, sq, d, 1.f);
  float lr[RM], dr[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    lr[i] = row < sq ? lse[qbase + row] : 0.f;
    dr[i] = row < sq ? delta[qbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < nkb; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    stage(ks, ld, kp, k0, BK, sk, d, 1.f);
    stage(vs, ld, vp, k0, BK, sk, d, 1.f);
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
    tile_dot<RM, CN>(s, qs, ks, ld, d);
    tile_dot<RM, CN>(dp, dos, vs, ld, d);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty * RM + i;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        const bool seen = kpos < sk && (!causal || kpos <= qpos + off);
        const float p = seen ? expf(s[i][jj] - lr[i]) : 0.f;
        dss[(ty * RM + i) * LDP + tx + 16 * jj] = p * (dp[i][jj] - dr[i]);
      }
    }
    __syncthreads();
    tile_accumulate<RM, DC>(acc, dss, LDP, ks, ld, BK, d);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= sq) continue;
    T* drow = dq + (qbase + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) drow[col] = from_float<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int bh, int sq,
           int sk, int d, int causal, float scale, cudaStream_t stream) {
  constexpr int BK = KeyTile<DC>::value;
  const size_t smem =
      ((size_t)(2 * kBlockQ + 2 * BK) * (d + 1) + kBlockQ * (BK + 4)) *
      sizeof(float);
  auto kern = flash_dq_kernel<T, DC>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sq, sk, d, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, int bh, int sq,
             int sk, int d, int causal, float scale, cudaStream_t s) {
#define PTT_DQ(DC) \
  launch<T, DC>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, causal, scale, s)
  if (d <= 16) return PTT_DQ(1);
  if (d <= 32) return PTT_DQ(2);
  if (d <= 64) return PTT_DQ(4);
  if (d <= 128) return PTT_DQ(8);
  return PTT_DQ(16);
#undef PTT_DQ
}

}  // namespace
}  // namespace paddle_tpu_torch

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// flash_attention.py. q, dout and dq [bh, sq, d], k and v [bh, sk, d], all
// of one dtype (0 float32, 1 bfloat16) and contiguous; lse and delta
// [bh, sq] float32. bfloat16 with mma_takes(dtype, d) takes the
// tensor-core loop, which needs q, k, v and dout on 16-byte boundaries.
// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError().
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int bh, int sq, int sk, int d, int causal,
                        float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d > 256 ||
      (causal && sq > sk))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma_takes(dtype, d)) {
    if (!aligned16(q, k, v, dout)) return (int)cudaErrorInvalidValue;
    return launch_flash_dq_mma(q, k, v, dout, l, dl, dq, bh, sq, sk, d,
                               causal, scale, s);
  }
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, dout, l, dl, dq, bh, sq, sk, d, causal,
                           scale, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, dout, l, dl, dq, bh, sq, sk, d,
                                   causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
