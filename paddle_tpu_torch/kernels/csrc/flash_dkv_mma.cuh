// The flash-attention BACKWARD loop for dK and dV on Hopper's tensor cores,
// for q, k, v and dO in bfloat16 with a head dim that is a multiple of 16
// up to 128 (`mma_takes`). flash_dkv.cu launches it for those calls and
// keeps its CUDA-core loop for float32 and the other head dims.
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py::_dkv_kernel (the
// second `pl.pallas_call` of `_bwd`), as flash_dkv.cu's header says: for
// every key, dV = sum_i P_i dO_i and dK = scale * sum_i dS_i q_i, with
// P = exp(q . k * scale - lse) and dS = P * (dO . v - delta), P zero past
// the bottom-right causal diagonal and on query rows >= Sq; dk and dv in
// bf16, lse and delta f32 from outside.
//
// Bound on the H100: operations, the four products (8 * D per visible
// pair) over 989 TFLOP/s: 25.8 GFLOP at the train shape (B=8, H=12,
// S=1024, D=64, causal), 0.026 ms. On the f32 CUDA cores (~67 TFLOP/s)
// the same work needs 0.385 ms: only the tensor cores reach SDPA's
// backward.
//
// Design:
// - Block and grid. A block owns kBlockK = 64 key rows of one (b, h): 4
//   warps of 16 keys, one 16-row mma tile each (two row tiles a warp would
//   hold two 16 x D f32 accumulators each for dK and dV beside the two
//   score tiles: over 255 registers at D=64), and two blocks share an SM
//   (up to 256 registers a thread), so one block's barrier does not idle
//   the SM. (8 warps of one block an SM, 2 warps of four and other ring
//   depths were slower at GPT-2's shapes on an H100: profile_dkv.py,
//   PERF.md.) The grid is (b*h, key tiles) and blockIdx.y 0 is key tile
//   0, which sees the most causal query rows: the heaviest tiles start
//   first across every (b, h).
// - The block walks the query tiles of kBlockQ rows (64 up to D=64, 32
//   above, for the registers of S^T and dP^T) from the first that sees
//   its keys, max(0, k0 - (Sk - Sq)) / kBlockQ, as the Pallas kernel does
//   (:170-173). A warp skips the tiles wholly before its own first visible
//   query (warp-uniform).
// - Copies. K and V of the block arrive once, their own cp.async group.
//   Q and dO tiles, with their lse and delta, arrive in a ring of kStages
//   stages of 16-byte (4-byte for lse and delta) cp.async copies; rows are
//   padded by 16 bytes, so ldmatrix meets no bank conflict; rows past Sq
//   (Sk for K and V) are zero-filled.
// - Products, all on mma.sync m16n8k16 with bf16 operands and f32
//   accumulators. S^T = K Q^T and dP^T = V dO^T take A from K / V through
//   ldmatrix and B from Q / dO through plain ldmatrix. dV += P^T dO and
//   dK += dS^T Q take A from the S^T / dS^T accumulators repacked to bf16
//   (the accumulators of two 8-query column tiles are one 16-deep A
//   fragment) and B from dO / Q through ldmatrix.trans: one shared-memory
//   Q and dO tile serves both orientations.
// - Numerics. The scale applies in f32 after the product, inside the
//   exponent: P = 2^(s * scale * log2 e - lse * log2 e) through the
//   special-function exp2. A thread reads lse and delta of the query
//   columns its accumulator fragment holds. The mask runs only on tiles
//   that cross a key's causal limit or the Sq tail; it zeroes rows >= Sq
//   explicitly (a zero-filled q row has s = 0, and lse there is not
//   -inf). P and dS are rounded to bf16 only as the A fragments of dV and
//   dK; the f32 P feeds dS. dK is scaled once at the end.
// - Determinism. Every dk and dv row is written by exactly one block and
//   thread, with no atomics: a run repeats bit for bit. dQ stays its own
//   kernel (flash_dq.cu, flash_dq_mma.cuh) for the same reason.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace paddle_tpu_torch {
namespace flash_dkv_mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockK = 16 * kWarps;   // key rows a block
constexpr int kStages = 3;             // query tiles in the load ring

// Shared-memory layout of one block, in bytes: K and V, then the ring of
// stages, each a Q tile, a dO tile, and the tile's lse and delta. bf16
// rows are padded by 16 bytes.
template <int DH>
struct Layout {
  static constexpr int kBlockQ = DH <= 64 ? 64 : 32;   // query rows a tile
  static constexpr int kLd = DH + 8;                   // bf16 row, elements
  static constexpr int kKV = kBlockK * kLd * 2;        // K or V of the block
  static constexpr int kQ = kBlockQ * kLd * 2;         // one Q or dO tile
  static constexpr int kStage = 2 * kQ + 2 * kBlockQ * 4;
  static constexpr int kBytes = 2 * kKV + kStages * kStage;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int sq, int sk,
                     int causal, float scale) {
  using L = Layout<DH>;
  constexpr int BQ = L::kBlockQ, kLd = L::kLd;
  constexpr int KD = DH / 16;     // 16-deep steps over d: S^T, dP^T
  constexpr int NT = BQ / 8;      // 8-query column tiles of S^T
  constexpr int KQ = BQ / 16;     // 16-deep steps over queries: dV, dK
  constexpr int ND = DH / 8;      // 8-wide tiles of dK and dV
  constexpr int kChunks = DH / 8; // 16-byte chunks of a bf16 row
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(dkv_smem);
  __nv_bfloat16* vs = ks + kBlockK * kLd;
  unsigned char* ring = dkv_smem + 2 * L::kKV;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;   // key tile 0 first: the heaviest
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int off = sk - sq;               // the diagonal's offset
  const int first = causal ? max(0, k0 - off) / BQ : 0;
  const int ntiles = (sq + BQ - 1) / BQ - first;   // at least 1
  const __nv_bfloat16* qp = q + (size_t)bh * sq * DH;
  const __nv_bfloat16* dop = dout + (size_t)bh * sq * DH;
  const float* lp = lse + (size_t)bh * sq;
  const float* dlp = delta + (size_t)bh * sq;

  // K and V of the block, their own copy group; rows past Sk are zeros
  {
    const __nv_bfloat16* kp = k + ((size_t)bh * sk + k0) * DH;
    const __nv_bfloat16* vp = v + ((size_t)bh * sk + k0) * DH;
    const int nkeys = min(kBlockK, sk - k0);
    for (int e = tid; e < kBlockK * kChunks; e += kThreads) {
      const int r = e / kChunks, ch = e % kChunks;
      const bool live = r < nkeys;
      const size_t o = live ? (size_t)r * DH + ch * 8 : 0;
      cp_async16(smem_addr(ks + r * kLd + ch * 8), kp + o, live);
      cp_async16(smem_addr(vs + r * kLd + ch * 8), vp + o, live);
    }
    cp_async_commit();
  }

  // Issues the copies of the i-th query tile of the walk into its ring
  // stage, zero-filled past Sq; one copy group, empty past the last tile
  // so that the group count stays uniform.
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      unsigned char* st = ring + (i % kStages) * L::kStage;
      __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(st);
      __nv_bfloat16* dos = qs + BQ * kLd;
      float* ls = reinterpret_cast<float*>(st + 2 * L::kQ);
      const int q0 = (first + i) * BQ;
      for (int e = tid; e < BQ * kChunks; e += kThreads) {
        const int r = e / kChunks, ch = e % kChunks;
        const bool live = q0 + r < sq;
        const size_t o = live ? (size_t)(q0 + r) * DH + ch * 8 : 0;
        cp_async16(smem_addr(qs + r * kLd + ch * 8), qp + o, live);
        cp_async16(smem_addr(dos + r * kLd + ch * 8), dop + o, live);
      }
      if (tid < BQ) {
        const bool live = q0 + tid < sq;
        const int o = live ? q0 + tid : 0;
        cp_async4(smem_addr(ls + tid), lp + o, live);
        cp_async4(smem_addr(ls + BQ + tid), dlp + o, live);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load_tile(s);

  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row, column pair
  const int wk0 = k0 + 16 * warp;           // the warp's first key
  const int key_lo = wk0 + g, key_hi = key_lo + 8;   // this thread's keys
  float gk[ND][4], gv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) gk[d][i] = gv[d][i] = 0.f;
  const float sl = scale * kLog2e;

  // Folds the i-th query tile of the walk into the warp's dK and dV.
  auto multiply_tile = [&](int i) {
    const unsigned char* st = ring + (i % kStages) * L::kStage;
    const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* dos = qs + BQ * kLd;
    const float* ls = reinterpret_cast<const float*>(st + 2 * L::kQ);
    const float* dls = ls + BQ;
    const int q0 = (first + i) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys by the tile's
    // queries, NT column tiles of 8
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      unsigned ka[4], va[4];
      const int a_off = (16 * warp + (lane & 15)) * kLd + kc * 16 +
                        (lane >> 4) * 8;
      ldsm_x4(smem_addr(ks + a_off), ka);
      ldsm_x4(smem_addr(vs + a_off), va);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                          kc * 16 + ((lane >> 3) & 1) * 8;
        unsigned b[4];
        ldsm_x4(smem_addr(qs + b_off), b);
        mma_16816(s[2 * np], ka, b[0], b[1]);
        mma_16816(s[2 * np + 1], ka, b[2], b[3]);
        ldsm_x4(smem_addr(dos + b_off), b);
        mma_16816(dp[2 * np], va, b[0], b[1]);
        mma_16816(dp[2 * np + 1], va, b[2], b[3]);
      }
    }

    // P = 2^(s * sl - lse * log2 e) and dS = P (dP - delta), in place;
    // element j of column tile n is key (j < 2 ? key_lo : key_hi) and
    // query q0 + 8 n + 2 t4 + (j & 1). The mask only where the tile
    // crosses a key's causal limit or the Sq tail.
    const bool masked = (causal && wk0 + 15 > q0 + off) || q0 + BQ > sq;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t4;
      const float2 lv = *reinterpret_cast<const float2*>(ls + c);
      const float2 dl = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j < 2 ? key_lo : key_hi;
        const int qry = q0 + c + (j & 1);
        float p = fast_exp2(fmaf(s[n][j], sl, -(j & 1 ? lv.y : lv.x) * kLog2e));
        if (masked && (qry >= sq || (causal && key > qry + off))) p = 0.f;
        s[n][j] = p;
        dp[n][j] = p * (dp[n][j] - (j & 1 ? dl.y : dl.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q, A from the registers rounded to bf16,
    // B from dO and Q through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < KQ; ++kc) {
      const unsigned pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const unsigned da[4] = {pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                              pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                              pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                              pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int dd = 0; dd < DH / 16; ++dd) {
        const int b_off = (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                          dd * 16 + (lane >> 4) * 8;
        unsigned b[4];
        ldsm_x4_trans(smem_addr(dos + b_off), b);
        mma_16816(gv[2 * dd], pa, b[0], b[1]);
        mma_16816(gv[2 * dd + 1], pa, b[2], b[3]);
        ldsm_x4_trans(smem_addr(qs + b_off), b);
        mma_16816(gk[2 * dd], da, b[0], b[1]);
        mma_16816(gk[2 * dd + 1], da, b[2], b[3]);
      }
    }
  };

  for (int i = 0; i < ntiles; ++i) {
    // tile i has landed (this thread's copies); after the barrier
    // everyone's has, and the stage of tile i - 1 is free
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_tile(i + kStages - 1);
    // warp-uniform: the warp has keys, and its first key is seen by the
    // tile's last query
    const int qlast = (first + i) * BQ + BQ - 1;
    if (wk0 < sk && (!causal || wk0 <= qlast + off)) multiply_tile(i);
  }

  const size_t kbase = (size_t)bh * sk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? key_hi : key_lo;
    if (key >= sk) continue;
    __nv_bfloat16* krow = dk + (kbase + key) * DH;
    __nv_bfloat16* vrow = dv + (kbase + key) * DH;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = d * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(krow + col) =
          pack_bf16(gk[d][2 * h] * scale, gk[d][2 * h + 1] * scale);
      *reinterpret_cast<unsigned*>(vrow + col) =
          pack_bf16(gv[d][2 * h], gv[d][2 * h + 1]);
    }
  }
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dk, void* dv,
              int bh, int sq, int sk, int causal, float scale,
              cudaStream_t stream) {
  auto kern = flash_dkv_mma_kernel<DH>;
  constexpr int smem = Layout<DH>::kBytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(bh, (sk + kBlockK - 1) / kBlockK);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq,
      sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_dkv_mma

// Launches the tensor-core dK/dV loop on `stream`; the caller has checked
// mma_takes(kBFloat16, d), 16-byte alignment of q, k, v and dout and
// (causal) sq <= sk. Returns the launch's cudaGetLastError().
inline int launch_flash_dkv_mma(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv,
                                int bh, int sq, int sk, int d, int causal,
                                float scale, cudaStream_t stream) {
#define PTT_DKV_MMA(DH)                                                    \
  case DH:                                                                 \
    return flash_dkv_mma::launch_dh<DH>(q, k, v, dout, lse, delta, dk, dv, \
                                        bh, sq, sk, causal, scale, stream)
  switch (d) {
    PTT_DKV_MMA(16);
    PTT_DKV_MMA(32);
    PTT_DKV_MMA(48);
    PTT_DKV_MMA(64);
    PTT_DKV_MMA(80);
    PTT_DKV_MMA(96);
    PTT_DKV_MMA(112);
    PTT_DKV_MMA(128);
  }
#undef PTT_DKV_MMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace paddle_tpu_torch
