// Flash-attention BACKWARD kernel for dK and dV, Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py::_dkv_kernel (the
// second `pl.pallas_call` of `_bwd`). For each key it recomputes the
// probabilities of the query rows that see it from the saved logsumexp,
// P = exp(s - lse), masked to 0 past the bottom-right causal diagonal and
// on the ragged query and key tails, and sums
//   dV = sum_i P_i dO_i,   dK = scale * sum_i P_i (dP_i - delta_i) q_i
// with dP = dO V^T and delta = rowsum(dO * O) from outside the kernel.
// dk and dv are written in k's and v's dtype, each row by exactly one
// block: no atomics, and a run repeats bit for bit.
//
// Bound on the H100: operations. Four products (scores, dV, dP, dK) cost
// 8 * D operations per visible (query, key) pair, against reading q, k, v,
// dO, lse and delta and writing dk and dv once.
//
// Two loops, picked by a fixed rule before the launch (`mma_takes`, the
// wrapper's `dkv_arm`): q, k, v and dO in bfloat16 with a head dim that is
// a multiple of 16 up to 128 run on the tensor cores (flash_dkv_mma.cuh,
// whose header gives that loop's design); float32 and the other head dims
// run the CUDA-core loop below, unchanged. Float32 stays on the CUDA cores
// because the tensor cores would take it only as TF32.
//
// The CUDA-core loop: grid (key block, b*h). A block keeps its K and V
// rows in shared memory and walks the query tiles of 64 rows from the
// first one that can see its keys, `max(0, k0 - (Sk - Sq)) / 64`, as the
// Pallas kernel starts (:170-173); the earliest key blocks see the most
// query rows and are launched first. Each q/dO tile is staged once; the
// transposed scores and dP come from one register-tiled pass, and dk, dv
// accumulate in f32 registers.

#include "flash_common.cuh"
#include "flash_dkv_mma.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace flash;

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int sq, int sk, int d, int causal,
                 float scale) {
  constexpr int BK = KeyTile<DC>::value;   // keys per block
  constexpr int RM = BK / 16;              // keys per thread
  constexpr int CN = kBlockQ / 16;         // query rows per thread in a tile
  constexpr int LDP = kBlockQ + 16 / RM;   // the two ty of a warp 16 banks apart
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;                  // [BK][ld]
  float* vs = ks + BK * ld;          // [BK][ld]
  float* qs = vs + BK * ld;          // [kBlockQ][ld]
  float* dos = qs + kBlockQ * ld;    // [kBlockQ][ld]
  float* pt = dos + kBlockQ * ld;    // [BK][LDP], P transposed
  float* dst = pt + BK * LDP;        // [BK][LDP], dS transposed
  float* ls = dst + BK * LDP;        // [kBlockQ] lse of the tile's rows
  float* dl = ls + kBlockQ;          // [kBlockQ] delta of the tile's rows

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int off = sk - sq;
  const int nqb = (sq + kBlockQ - 1) / kBlockQ;
  const int first = causal ? max(0, k0 - off) / kBlockQ : 0;
  const size_t qbase = (size_t)bh * sq;
  const size_t kbase = (size_t)bh * sk;
  const int tx = tile_tx(), ty = tile_ty();

  stage(ks, ld, k + kbase * d, k0, BK, sk, d, 1.f);
  stage(vs, ld, v + kbase * d, k0, BK, sk, d, 1.f);
  float gk[RM][DC], gv[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int t = first; t < nqb; ++t) {
    const int q0 = t * kBlockQ;
    __syncthreads();   // the previous tile is no longer read
    stage(qs, ld, q + qbase * d, q0, kBlockQ, sq, d, 1.f);
    stage(dos, ld, dout + qbase * d, q0, kBlockQ, sq, d, 1.f);
    if (threadIdx.x < kBlockQ) {
      const int row = q0 + threadIdx.x;
      ls[threadIdx.x] = row < sq ? lse[qbase + row] : 0.f;
      dl[threadIdx.x] = row < sq ? delta[qbase + row] : 0.f;
    }
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
    tile_dot<RM, CN>(s, ks, qs, ld, d);
    tile_dot<RM, CN>(dp, vs, dos, ld, d);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kpos = k0 + ty * RM + i;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        const int r = tx + 16 * jj;
        const int qpos = q0 + r;
        const bool seen = kpos < sk && qpos < sq &&
                          (!causal || kpos <= qpos + off);
        const float p = seen ? expf(s[i][jj] * scale - ls[r]) : 0.f;
        pt[(ty * RM + i) * LDP + r] = p;
        dst[(ty * RM + i) * LDP + r] = p * (dp[i][jj] - dl[r]);
      }
    }
    __syncthreads();
    tile_accumulate<RM, DC>(gv, pt, LDP, dos, ld, kBlockQ, d);
    tile_accumulate<RM, DC>(gk, dst, LDP, qs, ld, kBlockQ, d);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = k0 + ty * RM + i;
    if (key >= sk) continue;
    T* krow = dk + (kbase + key) * d;
    T* vrow = dv + (kbase + key) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        krow[col] = from_float<T>(gk[i][c] * scale);
        vrow[col] = from_float<T>(gv[i][c]);
      }
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int sq, int sk, int d, int causal, float scale,
           cudaStream_t stream) {
  constexpr int BK = KeyTile<DC>::value;
  constexpr int LDP = kBlockQ + 16 / (BK / 16);
  const size_t smem = ((size_t)(2 * BK + 2 * kBlockQ) * (d + 1) +
                       2 * BK * LDP + 2 * kBlockQ) * sizeof(float);
  auto kern = flash_dkv_kernel<T, DC>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + BK - 1) / BK, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, d, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dk, void* dv, int bh,
             int sq, int sk, int d, int causal, float scale,
             cudaStream_t s) {
#define PTT_DKV(DC)                                                         \
  launch<T, DC>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, causal,  \
                scale, s)
  if (d <= 16) return PTT_DKV(1);
  if (d <= 32) return PTT_DKV(2);
  if (d <= 64) return PTT_DKV(4);
  if (d <= 128) return PTT_DKV(8);
  return PTT_DKV(16);
#undef PTT_DKV
}

}  // namespace
}  // namespace paddle_tpu_torch

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// flash_attention.py. q and dout [bh, sq, d], k, v, dk and dv [bh, sk, d],
// all of one dtype (0 float32, 1 bfloat16) and contiguous; lse and delta
// [bh, sq] float32. bfloat16 with mma_takes(dtype, d) takes the
// tensor-core loop, which needs q, k, v and dout on 16-byte boundaries.
// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError().
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int bh, int sq, int sk, int d,
                         int causal, float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d > 256 ||
      (causal && sq > sk))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma_takes(dtype, d)) {
    if (!aligned16(q, k, v, dout)) return (int)cudaErrorInvalidValue;
    return launch_flash_dkv_mma(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, d,
                                causal, scale, s);
  }
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, d,
                           causal, scale, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk,
                                   d, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
