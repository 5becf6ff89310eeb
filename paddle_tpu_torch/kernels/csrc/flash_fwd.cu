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
// once: at S = 1024, D = 64 that is ~16 operations per byte in bf16 and ~8
// in f32, so the bound is the causal operation count over the dtype's peak
// rate (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA
// cores): at the train shape (B=8, H=12, S=1024, D=64, causal) 0.19250 ms
// in f32, at the incubate shape (non-causal) 0.38462 ms.
//
// Two loops, picked by a fixed rule before the launch (`mma_takes`, the
// wrapper's `arm`): q, k, v in bfloat16 with a head dim that is a multiple
// of 16 up to 128 run on the tensor cores (flash_fwd_mma.cuh, whose header
// gives that loop's design); float32, and bfloat16 at the other head dims
// (up to 256), run the CUDA-core loop below. Float32 stays on the CUDA
// cores because the tensor cores would take it only as TF32.
//
// The CUDA-core loop (flash_common.cuh's register-tiled primitives, the
// design of the f32 paged prefill, paged_prefill.cuh):
// - Grid (query blocks of 64 rows, b*h), taken in the order of the linear
//   block index as every (b, h) of the last (heaviest causal) query block,
//   then of the one before, so the first wave holds the longest chains.
//   A block stops at its last visible key tile.
// - The block's 64 query rows go to shared memory once. K and V tiles of
//   BK keys (64 up to D=128, 32 above) come through two rings of two
//   stages by cp.async (16, 8 or 4 bytes a copy, `copy_granule`), K one
//   tile ahead of V: while tile j's P V and tile j + 1's S are formed, K of
//   tile j + 2 and V of tile j + 1 are in flight. bfloat16 rows are widened
//   into the same f32 tiles by plain loads, once a tile. Rows are padded to
//   a stride of 4 mod 8 floats.
// - 256 threads as a 16 x 16 grid: thread (ty, tx) holds the scores of
//   rows ty + 16 i (4 rows) against keys tx + 16 j (BK / 16 keys), and O
//   for its 4 rows x 4 * DC columns, in f32 registers, formed from float4
//   reads with exact f32 FMAs (64 FMAs per 8 reads). Where the steps of
//   the two products match (D = 61-64, GPT-2's 64), tile j + 1's S = Q K^T
//   and tile j's O += P V run in one pass (`tile_nt_nn`), 32 accumulators
//   interleaved; elsewhere in two (`tile_nt`, `tile_nn`).
// - The scale times log2 e multiplies the f32 scores after the product
//   (the Pallas kernel scales q first: the same product, a rounding
//   apart), so that the softmax takes exp2f, a few instructions fewer than
//   expf, and lse = m ln 2 + log(max(l, 1e-30)). The causal mask and
//   the ragged key tail cost work only on a tile that crosses the diagonal
//   or the end of the keys. The row max takes one half-warp reduction a
//   tile; each row sum stays a per-thread share (keys tx + 16 j), added
//   across the 16 threads once at the end. P goes to shared memory (rows
//   of BK + 16 floats: the two half-warps of a warp write 16 banks apart).
//   out = O / max(l, 1e-30) in the input dtype.
// - Shared memory ((64 + 4 BK) rows of the padded D plus P): 107,520 bytes
//   at D=64, two blocks an SM (128 registers a thread); 189,440 at D=128,
//   211,968 at D=256, one block.
// - Measured on an H100 80GB HBM3 at 700 W, 1980 MHz (compare_serve.py
//   --flash, the loop it replaced in the same call): 0.4405-0.4432 ms at
//   the train shape, 44% of its 0.1925 ms bound, against 0.9152-0.9156;
//   0.8269-0.8283 at the incubate shape, 46% of 0.3846, against
//   1.4851-1.4855. Taking
//   out S saves 0.17 / 0.34 ms, P V 0.15 / 0.30, the copies 0.03 / 0.06
//   (profile_dkv.py core).

#include <cmath>

#include "flash_common.cuh"
#include "flash_fwd_mma.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace flash;

// Shared-memory bytes of a CUDA-core forward block (the wrapper's
// `core_fwd_smem`): Q, two stages of K and V rows, and P.
inline size_t core_fwd_smem(int d) {
  const int bk = d <= 128 ? 64 : 32;
  return ((size_t)(kBlockQ + 4 * bk) * tile_ld(d) +
          (size_t)kBlockQ * (bk + 16)) * sizeof(float);
}

// T: q, k, v and out (float or bfloat16). DC: the float4 column chunks of O
// a thread owns (tx + 16 c), so D <= 64 * DC; KPT: the keys of a tile a
// thread owns (tx + 16 j), BK = 16 * KPT.
template <typename T, int DC, int KPT>
__global__ void __launch_bounds__(kThreads, DC == 1 ? 2 : 1)
flash_fwd_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int sq, int sk, int d,
                      int causal, float scale, int gran_q, int gran_kv) {
  constexpr int BK = 16 * KPT;
  constexpr int RM = kBlockQ / 16;   // query rows a thread: ty + 16 i
  constexpr int LDP = BK + 16;
  extern __shared__ __align__(16) float smem[];
  const int ld = tile_ld(d);
  float* qs = smem;                              // [kBlockQ][ld]
  float* kring = qs + (size_t)kBlockQ * ld;      // [2][BK][ld]
  float* vring = kring + (size_t)2 * BK * ld;    // [2][BK][ld]
  float* ps = vring + (size_t)2 * BK * ld;       // [kBlockQ][LDP]

  // blocks in launch order: every (b, h) of the last query block, then of
  // the one before, ...
  const int nbh = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int bh = lin % nbh;
  const int q0 = (gridDim.x - 1 - lin / nbh) * kBlockQ;
  const int off = sk - sq;
  int nkb = (sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + kBlockQ - 1 + off) / BK + 1);
  const T* qp = q + (size_t)bh * sq * d;
  const T* kp = k + (size_t)bh * sk * d;
  const T* vp = v + (size_t)bh * sk * d;
  const int tx = tile_tx(), ty = tile_ty();
  const int n4 = (d + 3) / 4;
  // the next tile's S and this tile's P V in one pass when their steps
  // match (D rounded up to 4 equal to the keys of a tile: D = 61-64)
  const bool fused = DC == 1 && 4 * n4 == BK;

  zero_pad(smem, ld, kBlockQ + 4 * BK, d);   // Q and both rings
  auto load_k = [&](int j) {
    if (j < nkb)
      load_rows<BK>(kring + (size_t)(j & 1) * BK * ld, ld, kp, j * BK, sk, d,
                    gran_kv);
  };
  auto load_v = [&](int j) {
    if (j < nkb)
      load_rows<BK>(vring + (size_t)(j & 1) * BK * ld, ld, vp, j * BK, sk, d,
                    gran_kv);
  };
  // copy groups: (Q, K 0), then (K 1, V 0), then at tile j (K j+2, V j+1)
  load_rows<kBlockQ>(qs, ld, qp, q0, sq, d, gran_q);
  load_k(0);
  cp_async_commit();
  load_k(1);
  load_v(0);
  cp_async_commit();

  float m[RM], l[RM], acc[RM][DC][4], s[RM][KPT];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;   // this thread's share: keys tx + 16 j
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // tile j's scores in s: scale (into base-2 units), mask, then the online
  // softmax (one row max a tile, O rescaled) and P to shared memory
  const float scale2 = scale * kLog2e;
  auto softmax = [&](int j) {
    const int k0 = j * BK;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) s[i][jj] *= scale2;
    // the mask, only on a tile past some row's diagonal or past the keys
    if (k0 + BK > sk || (causal && k0 + BK - 1 > q0 + off)) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int lim = causal ? min(q0 + ty + 16 * i + off + 1, sk) : sk;
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj)
          if (k0 + tx + 16 * jj >= lim) s[i][jj] = kNegInf;
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int jj = 1; jj < KPT; ++jj) mx = fmaxf(mx, s[i][jj]);
      const float mn = fmaxf(m[i], half_warp_max(mx));
      const float alpha = exp2f(m[i] - mn);
      float rs = 0.f;
      float* prow = ps + (size_t)(ty + 16 * i) * LDP + tx;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const float p = exp2f(s[i][jj] - mn);   // 0 where masked
        rs += p;
        prow[16 * jj] = p;
      }
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
  };

  cp_async_wait<1>();
  __syncthreads();   // Q and K 0 are in
  tile_nt<RM, KPT>(s, qs, kring, ld, n4);   // S of tile 0: rows, keys
  softmax(0);
  for (int j = 0; j < nkb; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // P j, K j+1 and V j are in; K j, V j-1 are read
    load_k(j + 2);
    load_v(j + 1);
    cp_async_commit();
    const bool next = j + 1 < nkb;
    const float* kn = kring + (size_t)((j + 1) & 1) * BK * ld;
    const float* vt = vring + (size_t)(j & 1) * BK * ld;
    // S of tile j + 1 = q K^T, and O += P V of tile j: rows ty + 16 i, keys
    // tx + 16 jj, columns 4 (tx + 16 c) .. + 3
    if (next && fused) {
      tile_nt_nn<RM, KPT, DC>(s, qs, kn, ld, acc, ps, LDP, vt, BK);
    } else {
      if (next) tile_nt<RM, KPT>(s, qs, kn, ld, n4);
      tile_nn<RM, DC>(acc, ps, LDP, vt, ld, BK, n4);
    }
    if (next) {
      __syncthreads();   // P j is read
      softmax(j + 1);
    }
  }
  cp_async_wait<0>();   // nothing left in flight past the last tile

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float lc = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    T* orow = out + ((size_t)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (tx + 16 * c) + e;
        if (col < d) orow[col] = from_float<T>(acc[i][c][e] / lc);
      }
    if (tx == 0) lse[(size_t)bh * sq + row] = m[i] * kLn2 + logf(lc);
  }
}

template <typename T, int DC, int KPT>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int bh, int sq, int sk, int d, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = core_fwd_smem(d);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_core_kernel<T, DC, KPT>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int gq = copy_granule(d * (int)sizeof(float), q, q);
  const int gkv = copy_granule(d * (int)sizeof(float), k, v);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, d, causal,
      scale, gq, gkv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int bh, int sq, int sk, int d, int causal,
             float scale, cudaStream_t s) {
#define PTT_FWD(DC, KPT) \
  launch<T, DC, KPT>(q, k, v, out, lse, bh, sq, sk, d, causal, scale, s)
  if (d <= 64) return PTT_FWD(1, 4);
  if (d <= 128) return PTT_FWD(2, 4);
  return PTT_FWD(4, 2);
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
