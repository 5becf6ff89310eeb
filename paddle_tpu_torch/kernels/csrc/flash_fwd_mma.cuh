// The flash-attention FORWARD loop on Hopper's tensor cores, for q, k and v
// in bfloat16 with a head dim that is a multiple of 16 up to 128
// (`mma_takes`). flash_fwd.cu launches it for those calls and keeps its
// CUDA-core loop for float32 and the other head dims.
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py::_fwd_kernel
// (wrapper `_fwd`), as flash_fwd.cu's header says: out [BH, Sq, D] in bf16
// and lse [BH, Sq] in f32, the causal diagonal aligned bottom-right (key j
// visible to row i when j <= i + Sk - Sq), the row sum clamped at 1e-30.
//
// Bound on the H100: at the train shape (B=8, H=12, S=1024, D=64, causal)
// the bytes (q, k, v read once, out and lse written once: 50.7 MB, 0.0151
// ms) over the causal products (12.9 GFLOP, 0.0131 ms at 989 TFLOP/s); the
// non-causal incubate shape is bound by its 25.8 GFLOP (0.0261 ms).
//
// Design:
// - Tile and grid. A block owns 128 query rows of one (b, h) (`Tile`): at
//   head dims up to 64, 4 warps of 32 rows, two 16-row mma tiles each, so
//   every K and V fragment a warp loads from shared memory feeds two
//   products; above 64, 8 warps of 16 rows. Each warp walks every key tile
//   its rows see. The grid is (b*h, query tiles) and blockIdx.y 0 takes
//   the LAST query tile, so the causal tiles that see the most keys start
//   first across every (b, h) and the tail of the last wave holds the
//   light tiles. (Other tiles, among them paged_prefill_mma.cuh's 64 rows
//   of 8 warps that split each key tile in halves, were slower at GPT-2's
//   shapes on an H100; PERF.md keeps their times.)
// - Q once into registers (cp.async to shared memory, then ldmatrix). K and
//   V are plain 64-row boxes of a contiguous [Sk, D] matrix: each row is a
//   16-byte cp.async into a ring of kStages tiles (rows padded by 16 bytes,
//   so ldmatrix meets no bank conflict), tiles j+1 to j+kStages-1 in flight
//   while tile j is multiplied; rows at or past the block's last visible
//   key are not read but zero-filled (source size 0), and the mask hides
//   them. K reaches its B fragments through ldmatrix, V through
//   ldmatrix.trans.
// - S = Q K^T on mma.sync m16n8k16 (bf16 operands, f32 accumulators).
//   Online softmax in f32 on the raw scores, sm_scale applied in f32 after
//   the product inside the exponent (p = 2^(s * scale * log2 e - m * scale
//   * log2 e), one FMA and one special-function exp2 a score); the mask
//   runs only on tiles that cross a row's causal limit or the Sk tail, and
//   tiles wholly past the diagonal are never visited. The row sum l adds
//   the f32 p; p is rounded to bf16 only as the A fragment of O += P V
//   (the score accumulators of two 8-key column tiles are that fragment).
//   So lse = m * scale + log(l) carries no rounding of P, and the backward
//   kernels (flash_dq.cu, flash_dkv.cu) recompute the same probabilities
//   from it as before.
// - Rows at or past Sq are computed from zeros and never written.
// Left for later: wgmma with TMA boxes and producer warps (the products
// still issue as mma.sync).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "mma_common.cuh"

namespace paddle_tpu_torch {
namespace flash_mma {

constexpr int kKeys = 64;     // keys of a tile
constexpr int kStages = 4;    // tiles in the load ring

// The tile of a head dim: kWarps warps of kRowTiles 16-row mma tiles each
// (every K and V fragment serves all of a warp's row tiles), each warp
// walking every key tile of its rows. Up to 64 dims, 4 warps of two row
// tiles; above, two row tiles' registers spill, so 8 warps of one. Either
// way 128 query rows a block.
template <int DH>
struct Tile {
  static constexpr int kWarps = DH <= 64 ? 4 : 8;
  static constexpr int kRowTiles = DH <= 64 ? 2 : 1;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockQ = 16 * kRowTiles * kWarps;
  // two blocks an SM where their registers fit (up to 255 a thread for two
  // row tiles)
  static constexpr int kMinBlocks = DH <= 64 ? 2 : 1;
};

// Shared-memory layout of one block, in bytes: the Q tile, then the ring of
// K/V stages. bf16 rows are padded by 16 bytes.
template <int DH>
struct Layout {
  static constexpr int kLd = DH + 8;                 // bf16 row, elements
  static constexpr int kTile = kKeys * kLd * 2;      // one K or V tile
  static constexpr int kQ = Tile<DH>::kBlockQ * kLd * 2;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBytes = kQ + kStages * kStage;
};

template <int DH>
__global__ void __launch_bounds__(Tile<DH>::kThreads, Tile<DH>::kMinBlocks)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int sq, int sk, int causal, float scale) {
  using L = Layout<DH>;
  using TL = Tile<DH>;
  constexpr int kThreads = TL::kThreads, kBlockQ = TL::kBlockQ;
  constexpr int kLd = L::kLd;
  constexpr int KC = DH / 16;           // 16-deep steps of Q K^T
  constexpr int ND = DH / 8;            // 8-wide tiles of O
  constexpr int kChunks = DH / 8;       // 16-byte chunks of a bf16 row
  constexpr int NT = kKeys / 8;         // 8-key column tiles of S
  constexpr int RT = TL::kRowTiles;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  unsigned char* ring = flash_smem + L::kQ;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tile first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = qt * kBlockQ;
  const int nrows = min(kBlockQ, sq - row0);   // rows of q and out
  const int off = sk - sq;                     // the diagonal's offset
  // keys [0, kv_end): those some row of the block sees
  const int kv_end = causal ? min(sk, row0 + nrows + off) : sk;
  const int ntiles = (kv_end + kKeys - 1) / kKeys;
  const __nv_bfloat16* qp = q + ((size_t)bh * sq + row0) * DH;
  const __nv_bfloat16* kp = k + (size_t)bh * sk * DH;
  const __nv_bfloat16* vp = v + (size_t)bh * sk * DH;

  // Q tile, its own copy group; rows past Sq are zeros
  for (int e = tid; e < kBlockQ * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks;
    const bool live = r < nrows;
    cp_async16(smem_addr(qs + r * kLd + ch * 8),
               live ? qp + (size_t)r * DH + ch * 8 : q, live);
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

  // a warp owns 16 * kRowTiles query rows; row j of a thread
  // (j < 2 * kRowTiles) is row row_of(j) of the block
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row, column pair
  const int wrow0 = warp * 16 * RT;
  auto row_of = [&](int j) { return wrow0 + 16 * (j / 2) + g + 8 * (j % 2); };
  // the last key a row sees (rows past Sq are clamped like the last one)
  auto limit = [&](int r) {
    return causal ? min(row0 + r + off, sk - 1) : sk - 1;
  };
  int lim[2 * RT];
#pragma unroll
  for (int j = 0; j < 2 * RT; ++j) lim[j] = limit(row_of(j));
  const int wfirst = limit(wrow0);
  const int wlast = limit(min(wrow0 + 16 * RT - 1, nrows - 1));
  // tiles holding a key some row of this warp sees; none for a warp whose
  // rows are all past Sq
  const int wtiles = wrow0 < nrows ? wlast / kKeys + 1 : 0;

  cp_async_wait<kStages - 1>();   // the Q group has landed
  __syncthreads();
  unsigned qf[RT][KC][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldsm_x4(smem_addr(qs + (wrow0 + 16 * rt + (lane & 15)) * kLd +
                        kc * 16 + (lane >> 4) * 8),
              qf[rt][kc]);

  float o[RT][ND][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int d = 0; d < ND; ++d)
      o[rt][d][0] = o[rt][d][1] = o[rt][d][2] = o[rt][d][3] = 0.f;
  // the running max of the raw scores q . k, -inf until a row has seen a
  // key, and the running sum of the f32 p
  float m[2 * RT], l[2 * RT];
#pragma unroll
  for (int j = 0; j < 2 * RT; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
  }
  // p = 2^(s * sl - m * sl): sm_scale, applied to the f32 product
  const float sl = scale * kLog2e;

  // Folds key tile kt into the warp's rows.
  auto multiply_tile = [&](int kt) {
    const __nv_bfloat16* kt_s = reinterpret_cast<const __nv_bfloat16*>(
        ring + (kt % kStages) * L::kStage);
    const __nv_bfloat16* vt_s = kt_s + kKeys * kLd;
    const int key0 = kt * kKeys;

    // S = Q K^T over the tile's keys: NT column tiles of 8 for each
    // 16-row tile; each K fragment serves every row tile
    float s[RT][NT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        s[rt][n][0] = s[rt][n][1] = s[rt][n][2] = s[rt][n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned b[4];
        ldsm_x4(smem_addr(kt_s +
                          (np * 16 + (lane & 7) +
                           ((lane >> 4) << 3)) * kLd +
                          kc * 16 + ((lane >> 3) & 1) * 8),
                b);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          mma_16816(s[rt][2 * np], qf[rt][kc], b[0], b[1]);
          mma_16816(s[rt][2 * np + 1], qf[rt][kc], b[2], b[3]);
        }
      }
    }

    // the mask on tiles that cross a row's limit, then the row max; a row
    // lives on the 4 threads of a quad
    const bool masked = key0 + kKeys - 1 > wfirst;
    float mx[2 * RT];
#pragma unroll
    for (int j = 0; j < 2 * RT; ++j) mx[j] = m[j];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * rt + (i >> 1);
          if (masked && key0 + n * 8 + 2 * t4 + (i & 1) > lim[j])
            s[rt][n][i] = -INFINITY;
          mx[j] = fmaxf(mx[j], s[rt][n][i]);
        }
    float alpha[2 * RT], mb[2 * RT], rs[2 * RT];
#pragma unroll
    for (int j = 0; j < 2 * RT; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(kFullMask, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(kFullMask, mx[j], 2));
      // a row that has seen no key yet keeps p = 0 and its empty state
      mb[j] = mx[j] == -INFINITY ? 0.f : mx[j] * sl;
      alpha[j] = fast_exp2(fmaf(m[j], sl, -mb[j]));
      m[j] = mx[j];
      rs[j] = 0.f;
    }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * rt + (i >> 1);
          s[rt][n][i] = fast_exp2(fmaf(s[rt][n][i], sl, -mb[j]));
          rs[j] += s[rt][n][i];
        }
#pragma unroll
    for (int j = 0; j < 2 * RT; ++j)   // f32 p, this thread's columns
      l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[rt][d][0] *= alpha[2 * rt];
        o[rt][d][1] *= alpha[2 * rt];
        o[rt][d][2] *= alpha[2 * rt + 1];
        o[rt][d][3] *= alpha[2 * rt + 1];
      }

    // O += P V, P from the score registers rounded to bf16; each V
    // fragment serves every row tile
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      unsigned a[RT][4];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        const float(&p0)[4] = s[rt][2 * kc];
        const float(&p1)[4] = s[rt][2 * kc + 1];
        a[rt][0] = pack_bf16(p0[0], p0[1]);
        a[rt][1] = pack_bf16(p0[2], p0[3]);
        a[rt][2] = pack_bf16(p1[0], p1[1]);
        a[rt][3] = pack_bf16(p1[2], p1[3]);
      }
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        unsigned b[4];
        ldsm_x4_trans(
            smem_addr(vt_s +
                      (kc * 16 + (lane & 7) +
                       ((lane >> 3) & 1) * 8) * kLd +
                      dp * 16 + (lane >> 4) * 8),
            b);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          mma_16816(o[rt][2 * dp], a[rt], b[0], b[1]);
          mma_16816(o[rt][2 * dp + 1], a[rt], b[2], b[3]);
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

  __nv_bfloat16* obase = out + ((size_t)bh * sq + row0) * DH;
  float* lrow = lse + (size_t)bh * sq + row0;
#pragma unroll
  for (int j = 0; j < 2 * RT; ++j) {   // the row sums over a quad
    l[j] += __shfl_xor_sync(kFullMask, l[j], 1);
    l[j] += __shfl_xor_sync(kFullMask, l[j], 2);
  }
#pragma unroll
  for (int j = 0; j < 2 * RT; ++j) {
    const int r = row_of(j);
    if (r >= nrows) continue;
    const float lc = fmaxf(l[j], 1e-30f), inv = 1.f / lc;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<unsigned*>(obase + r * DH + d * 8 + 2 * t4) =
          pack_bf16(o[j / 2][d][2 * (j % 2)] * inv,
                    o[j / 2][d][2 * (j % 2) + 1] * inv);
    if (t4 == 0) lrow[r] = m[j] * scale + logf(lc);
  }
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, void* out,
              float* lse, int bh, int sq, int sk, int causal, float scale,
              cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<DH>;
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
      static_cast<__nv_bfloat16*>(out), lse, sq, sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_mma

// Launches the tensor-core forward on `stream`; the caller has checked
// mma_takes(kBFloat16, d), 16-byte alignment and (causal) sq <= sk.
// Returns the launch's cudaGetLastError().
inline int launch_flash_fwd_mma(const void* q, const void* k, const void* v,
                                void* out, float* lse, int bh, int sq, int sk,
                                int d, int causal, float scale,
                                cudaStream_t stream) {
#define PTT_FLASH_MMA(DH)                                                  \
  case DH:                                                                 \
    return flash_mma::launch_dh<DH>(q, k, v, out, lse, bh, sq, sk, causal, \
                                    scale, stream)
  switch (d) {
    PTT_FLASH_MMA(16);
    PTT_FLASH_MMA(32);
    PTT_FLASH_MMA(48);
    PTT_FLASH_MMA(64);
    PTT_FLASH_MMA(80);
    PTT_FLASH_MMA(96);
    PTT_FLASH_MMA(112);
    PTT_FLASH_MMA(128);
  }
#undef PTT_FLASH_MMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace paddle_tpu_torch
