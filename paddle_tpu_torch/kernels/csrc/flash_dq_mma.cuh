// The flash-attention BACKWARD loop for dQ on Hopper's tensor cores, for q,
// k, v and dO in bfloat16 with a head dim that is a multiple of 16 up to
// 128 (`mma_takes`). flash_dq.cu launches it for those calls and keeps its
// CUDA-core loop for float32 and the other head dims.
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py::_dq_kernel (the
// first `pl.pallas_call` of `_bwd`), as flash_dq.cu's header says: for
// every query row, dQ = scale * sum_j dS_j k_j with P = exp(q . k * scale -
// lse), dP = dO V^T and dS = P (dP - delta), P zero past the bottom-right
// causal diagonal and past Sk; dq in bf16, lse and delta f32 from outside.
//
// Bound on the H100: operations, the three products (6 * D per visible
// pair) over 989 TFLOP/s: 19.35 GFLOP at the train shape (B=8, H=12,
// S=1024, D=64, causal), 0.01956 ms. On the f32 CUDA cores (~67 TFLOP/s)
// the same work needs 0.29 ms, more than SDPA's forward and backward: only
// the tensor cores reach them.
//
// Design (flash_dkv_mma.cuh turned around):
// - Block and grid. A block owns kWarps * kRowTiles * 16 query rows of one
//   (b, h): 4 warps, each of two 16-row mma tiles up to D=64 (128 rows; a
//   K or V fragment a warp loads from shared memory feeds both) and of one
//   above (64 rows: two spill there), two blocks an SM. The grid is (b*h,
//   query tiles) and blockIdx.y 0 takes the LAST query tile, the one that
//   sees the most causal keys, so the heaviest tiles start first across
//   every (b, h), as in flash_fwd_mma.cuh. (At GPT-2's train shape on an
//   H100, one 16-row tile a warp over 64-key tiles, the first design, was
//   15% slower, and 1% with three blocks an SM; 16-key tiles 7%; one
//   8-warp block an SM 16%; 2 stages 3%; 2 warps four blocks an SM and 4
//   stages within 1%: profile_dkv.py, PERF.md.)
// - Copies. The block's Q and dO rows arrive once (their own cp.async
//   group) and each warp keeps its Q and dO A fragments in registers; a
//   thread reads lse and delta of its own two rows a row tile. K and V
//   tiles of kKeys = 32 keys (the registers of S and dP beside two row
//   tiles' dQ, Q and dO fragments: 254 at D=64) arrive in a ring of
//   kStages stages of 16-byte cp.async copies; rows are padded by 16
//   bytes, so ldmatrix meets no bank conflict; rows past the block's last
//   visible key (or Sk) are zero-filled. The walk stops at the block's
//   last visible key tile, as the Pallas kernel's `num_kb` does
//   (:135-139); a warp skips the tiles wholly past its own rows' diagonal
//   (warp-uniform).
// - Products, all on mma.sync m16n8k16 with bf16 operands and f32
//   accumulators. S = Q K^T and dP = dO V^T take B from K and V through
//   plain ldmatrix. dQ += dS K takes A from the dS accumulators repacked to
//   bf16 (the accumulators of two 8-key column tiles are one 16-deep A
//   fragment) and B from K through ldmatrix.trans: one shared-memory K
//   tile serves both products.
// - Numerics. The scale applies in f32 after the product, inside the
//   exponent: P = 2^(s * scale * log2 e - lse * log2 e) through the
//   special-function exp2. The mask runs only on tiles that cross a row's
//   causal limit or the Sk tail. dS comes from the f32 P and is rounded to
//   bf16 only as the A operand of dS K. dQ is scaled once at the end. Rows
//   at or past Sq are computed from zeros and never written.
// - Determinism. Every dq row is written by exactly one block and thread,
//   with no atomics: a run repeats bit for bit (dK and dV are their own
//   kernel, flash_dkv_mma.cuh, for the same reason).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace paddle_tpu_torch {
namespace flash_dq_mma {

// The block shape of a head dim: kWarps warps of kRowTiles 16-row mma
// tiles each (every K and V fragment a warp loads serves all its row
// tiles), K and V tiles of kKeys keys in a ring of kStages, and
// kMinBlocks blocks an SM.
template <int DH>
struct Tile {
  static constexpr int kWarps = 4;
  static constexpr int kRowTiles = DH <= 64 ? 2 : 1;
  static constexpr int kKeys = 32;
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = 2;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockQ = 16 * kRowTiles * kWarps;
};

// Shared-memory layout of one block, in bytes: the Q and dO rows, then the
// ring of K/V stages. bf16 rows are padded by 16 bytes.
template <int DH>
struct Layout {
  static constexpr int kLd = DH + 8;                          // elements
  static constexpr int kQ = Tile<DH>::kBlockQ * kLd * 2;      // Q or dO
  static constexpr int kTile = Tile<DH>::kKeys * kLd * 2;     // K or V
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBytes = 2 * kQ + Tile<DH>::kStages * kStage;
};

template <int DH>
__global__ void __launch_bounds__(Tile<DH>::kThreads, Tile<DH>::kMinBlocks)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int sq, int sk,
                    int causal, float scale) {
  using L = Layout<DH>;
  using TL = Tile<DH>;
  constexpr int kThreads = TL::kThreads, kBlockQ = TL::kBlockQ;
  constexpr int kKeys = TL::kKeys, kStages = TL::kStages;
  constexpr int kLd = L::kLd;
  constexpr int RT = TL::kRowTiles;
  constexpr int KC = DH / 16;       // 16-deep steps over d: S, dP
  constexpr int NT = kKeys / 8;     // 8-key column tiles of S and dP
  constexpr int ND = DH / 8;        // 8-wide tiles of dQ
  constexpr int kChunks = DH / 8;   // 16-byte chunks of a bf16 row
  extern __shared__ __align__(16) unsigned char dq_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(dq_smem);
  __nv_bfloat16* dos = qs + kBlockQ * kLd;
  unsigned char* ring = dq_smem + 2 * L::kQ;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tile first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = qt * kBlockQ;
  const int nrows = min(kBlockQ, sq - row0);   // rows of q, dO and dq
  const int off = sk - sq;                     // the diagonal's offset
  // keys [0, kv_end): those some row of the block sees
  const int kv_end = causal ? min(sk, row0 + nrows + off) : sk;
  const int ntiles = (kv_end + kKeys - 1) / kKeys;
  const size_t qbase = (size_t)bh * sq + row0;
  const __nv_bfloat16* kp = k + (size_t)bh * sk * DH;
  const __nv_bfloat16* vp = v + (size_t)bh * sk * DH;

  // Q and dO rows, their own copy group; rows past Sq are zeros
  for (int e = tid; e < kBlockQ * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks;
    const bool live = r < nrows;
    const size_t o = live ? (qbase + r) * DH + ch * 8 : 0;
    cp_async16(smem_addr(qs + r * kLd + ch * 8), q + o, live);
    cp_async16(smem_addr(dos + r * kLd + ch * 8), dout + o, live);
  }
  cp_async_commit();

  // Issues the copies of key tile kt into its ring stage, zero-filled past
  // kv_end; one copy group, empty past the last tile so that the group
  // count stays uniform.
  auto load_tile = [&](int kt) {
    if (kt < ntiles) {
      __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(
          ring + (kt % kStages) * L::kStage);
      __nv_bfloat16* vs = ks + kKeys * kLd;
      const int key0 = kt * kKeys;
      for (int e = tid; e < kKeys * kChunks; e += kThreads) {
        const int t = e / kChunks, ch = e % kChunks;
        const bool live = key0 + t < kv_end;
        const size_t o = live ? (size_t)(key0 + t) * DH + ch * 8 : 0;
        cp_async16(smem_addr(ks + t * kLd + ch * 8), kp + o, live);
        cp_async16(smem_addr(vs + t * kLd + ch * 8), vp + o, live);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load_tile(s);

  // a warp owns 16 * RT query rows; row j of a thread (j < 2 * RT) is row
  // row_of(j) of the block
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row, column pair
  const int wrow0 = warp * 16 * RT;
  auto row_of = [&](int j) { return wrow0 + 16 * (j / 2) + g + 8 * (j % 2); };
  // the last key a row sees (rows past Sq are clamped like the last one)
  auto limit = [&](int r) {
    return causal ? min(row0 + r + off, sk - 1) : sk - 1;
  };
  // per row: its key limit, lse * log2 e and delta (0 past Sq)
  int lim[2 * RT];
  float lr[2 * RT], dl[2 * RT];
#pragma unroll
  for (int j = 0; j < 2 * RT; ++j) {
    const int r = row_of(j);
    lim[j] = limit(r);
    lr[j] = r < nrows ? lse[qbase + r] * kLog2e : 0.f;
    dl[j] = r < nrows ? delta[qbase + r] : 0.f;
  }
  const int wfirst = limit(wrow0);
  const int wlast = limit(min(wrow0 + 16 * RT - 1, nrows - 1));
  // tiles holding a key some row of this warp sees; none for a warp whose
  // rows are all past Sq
  const int wtiles = wrow0 < nrows ? wlast / kKeys + 1 : 0;

  cp_async_wait<kStages - 1>();   // the Q and dO group has landed
  __syncthreads();
  unsigned qf[RT][KC][4], df[RT][KC][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int a_off = (wrow0 + 16 * rt + (lane & 15)) * kLd + kc * 16 +
                        (lane >> 4) * 8;
      ldsm_x4(smem_addr(qs + a_off), qf[rt][kc]);
      ldsm_x4(smem_addr(dos + a_off), df[rt][kc]);
    }

  float acc[RT][ND][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int d = 0; d < ND; ++d)
      acc[rt][d][0] = acc[rt][d][1] = acc[rt][d][2] = acc[rt][d][3] = 0.f;
  const float sl = scale * kLog2e;

  // Folds key tile kt into the warp's dQ rows.
  auto multiply_tile = [&](int kt) {
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(
        ring + (kt % kStages) * L::kStage);
    const __nv_bfloat16* vs = ks + kKeys * kLd;
    const int key0 = kt * kKeys;

    // S = Q K^T and dP = dO V^T over the tile's keys: NT column tiles of
    // 8 for each 16-row tile; each K and V fragment serves every row tile
    float s[RT][NT][4], dp[RT][NT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[rt][n][i] = dp[rt][n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                          kc * 16 + ((lane >> 3) & 1) * 8;
        unsigned b[4];
        ldsm_x4(smem_addr(ks + b_off), b);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          mma_16816(s[rt][2 * np], qf[rt][kc], b[0], b[1]);
          mma_16816(s[rt][2 * np + 1], qf[rt][kc], b[2], b[3]);
        }
        ldsm_x4(smem_addr(vs + b_off), b);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          mma_16816(dp[rt][2 * np], df[rt][kc], b[0], b[1]);
          mma_16816(dp[rt][2 * np + 1], df[rt][kc], b[2], b[3]);
        }
      }
    }

    // P = 2^(s * sl - lse * log2 e) and dS = P (dP - delta), in place in
    // dp; element i of column tile n is row j = 2 rt + (i >> 1) and key
    // key0 + 8 n + 2 t4 + (i & 1). The mask only where the tile crosses a
    // row's causal limit or the Sk tail.
    const bool masked = key0 + kKeys - 1 > wfirst;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * rt + (i >> 1);
          float p = fast_exp2(fmaf(s[rt][n][i], sl, -lr[j]));
          if (masked && key0 + n * 8 + 2 * t4 + (i & 1) > lim[j]) p = 0.f;
          dp[rt][n][i] = p * (dp[rt][n][i] - dl[j]);
        }

    // dQ += dS K, A from the dS registers rounded to bf16, B from K
    // through ldmatrix.trans; each K fragment serves every row tile
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      unsigned a[RT][4];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        const float(&d0)[4] = dp[rt][2 * kc];
        const float(&d1)[4] = dp[rt][2 * kc + 1];
        a[rt][0] = pack_bf16(d0[0], d0[1]);
        a[rt][1] = pack_bf16(d0[2], d0[3]);
        a[rt][2] = pack_bf16(d1[0], d1[1]);
        a[rt][3] = pack_bf16(d1[2], d1[3]);
      }
#pragma unroll
      for (int dd = 0; dd < DH / 16; ++dd) {
        unsigned b[4];
        ldsm_x4_trans(smem_addr(ks +
                                (kc * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * kLd +
                                dd * 16 + (lane >> 4) * 8),
                      b);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          mma_16816(acc[rt][2 * dd], a[rt], b[0], b[1]);
          mma_16816(acc[rt][2 * dd + 1], a[rt], b[2], b[3]);
        }
      }
    }
  };

  for (int kt = 0; kt < ntiles; ++kt) {
    // tile kt has landed (this thread's copies); after the barrier
    // everyone's has, and the stage of tile kt - 1 is free
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_tile(kt + kStages - 1);
    if (kt < wtiles) multiply_tile(kt);   // warp-uniform
  }

  __nv_bfloat16* qrow = dq + qbase * DH;
#pragma unroll
  for (int j = 0; j < 2 * RT; ++j) {
    const int r = row_of(j);
    if (r >= nrows) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<unsigned*>(qrow + r * DH + d * 8 + 2 * t4) =
          pack_bf16(acc[j / 2][d][2 * (j % 2)] * scale,
                    acc[j / 2][d][2 * (j % 2) + 1] * scale);
  }
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int sq,
              int sk, int causal, float scale, cudaStream_t stream) {
  auto kern = flash_dq_mma_kernel<DH>;
  constexpr int smem = Layout<DH>::kBytes;
  constexpr int kBlockQ = Tile<DH>::kBlockQ;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(bh, (sq + kBlockQ - 1) / kBlockQ);
  kern<<<grid, Tile<DH>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), sq, sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_dq_mma

// Launches the tensor-core dQ loop on `stream`; the caller has checked
// mma_takes(kBFloat16, d), 16-byte alignment of q, k, v and dout and
// (causal) sq <= sk. Returns the launch's cudaGetLastError().
inline int launch_flash_dq_mma(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, int bh, int sq,
                               int sk, int d, int causal, float scale,
                               cudaStream_t stream) {
#define PTT_DQ_MMA(DH)                                                     \
  case DH:                                                                 \
    return flash_dq_mma::launch_dh<DH>(q, k, v, dout, lse, delta, dq, bh,  \
                                       sq, sk, causal, scale, stream)
  switch (d) {
    PTT_DQ_MMA(16);
    PTT_DQ_MMA(32);
    PTT_DQ_MMA(48);
    PTT_DQ_MMA(64);
    PTT_DQ_MMA(80);
    PTT_DQ_MMA(96);
    PTT_DQ_MMA(112);
    PTT_DQ_MMA(128);
  }
#undef PTT_DQ_MMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace paddle_tpu_torch
