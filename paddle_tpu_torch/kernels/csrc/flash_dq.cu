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
// dO, lse and delta and writing dq once: at the train shape (B=8, H=12,
// S=1024, D=64, causal) 0.28875 ms in f32 at 67 TFLOP/s, at the incubate
// shape (non-causal) 0.57694 ms.
//
// Two loops, picked by a fixed rule before the launch (`mma_takes`, the
// wrapper's `dq_arm`): q, k, v and dO in bfloat16 with a head dim that is
// a multiple of 16 up to 128 run on the tensor cores (flash_dq_mma.cuh,
// whose header gives that loop's design); float32, and bfloat16 at the
// other head dims (up to 256), run the CUDA-core loop below. Float32 stays
// on the CUDA cores because the tensor cores would take it only as TF32.
//
// The CUDA-core loop (flash_common.cuh's register-tiled primitives, the
// design of flash_fwd.cu and flash_dkv.cu):
// - Grid (query blocks of 64 rows, b*h), taken in the order of the linear
//   block index as every (b, h) of the last (heaviest causal) query block,
//   then of the one before, as the forward. A block walks the key tiles of
//   BK keys (64 up to D=128, 32 above) up to its last visible one.
// - The block's Q and dO rows come into shared memory once; its rows' lse
//   and delta into registers. K and V tiles stream through two cp.async
//   rings (16, 8 or 4 bytes a copy, `copy_granule`): K of two stages, so
//   the next tile's K is in flight through both products of this one, and
//   V of one, the next tile's V in flight through dQ += dS K, once dP has
//   read this one (K falls to one stage where two do not fit, D > 240).
//   bfloat16 rows are widened into the same f32 tiles by plain loads. Rows
//   are padded to a stride of 4 mod 8 floats.
// - 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows ty + 16
//   i and keys tx + 16 j of a tile. One pass over D with float4 reads forms
//   S = Q K^T and dP = dO V^T in registers (`tile_nt2`, exact f32 FMAs, 32
//   accumulators interleaved); then P = exp2f(S * scale * log2 e - lse *
//   log2 e) (the scale multiplies the f32 scores after the product; the
//   Pallas kernel scales q first: the same product, a rounding apart),
//   masked only on a tile that crosses the diagonal or the end of the
//   keys, and dS = P (dP - delta) goes to shared memory (rows of BK + 16
//   floats: the two half-warps of a warp write 16 banks apart).
// - dQ += dS K is tiled the same way over the K tile still in its stage
//   (`tile_nn`): each thread owns its 4 rows x 4 * DC columns in f32
//   registers (16 at D <= 64), written once at the end times `scale`.
// - Shared memory (Q, dO, three K/V stages, dS): 107,520 bytes at D=64,
//   two blocks an SM (registers capped at 128); 189,440 at D=128 and
//   211,968 at D=256 (one K stage), one block.
// - Measured on an H100 80GB HBM3 at 700 W, 1980 MHz (compare_serve.py
//   --flash, the loop it replaced in the same call): 0.6322-0.6324 ms at
//   the train shape, 46% of its 0.2888 ms bound, against 1.1608-1.1661;
//   1.1929-1.2019 at the incubate shape, 48% of 0.5769, against
//   1.9452-1.9556. Other rings (profile_dkv.py core flash_dq, train /
//   incubate ms, the shipped ring 0.638 / 1.211): K and V one stage, two
//   blocks an SM 0.652 / 1.243; K and V two stages, one block 0.728 /
//   1.374; two stages of 32-key tiles, two blocks 0.750 / 1.416; this
//   ring at one block 0.736 / 1.394. Taking out S and dP saves 0.38 /
//   0.74 ms, dS K 0.17 / 0.32, the K/V copies 0.02 / 0.04.

#include "flash_common.cuh"
#include "flash_dq_mma.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace flash;

// K and V ring stages (K drops to one where two do not fit), the keys a
// thread owns at D <= 64 (64-key tiles) and the blocks an SM there
constexpr int kDqKStages = 2;
constexpr int kDqVStages = 1;
constexpr int kDqSmallKpt = 4;
constexpr int kDqMinBlocks = 2;

// Keys of a CUDA-core dQ key tile at head dim d.
inline int dq_keys(int d) {
  return d <= 64 ? 16 * kDqSmallKpt : d <= 128 ? 64 : 32;
}

// Shared-memory layout of a CUDA-core dQ block (the wrapper's
// `core_dq_layout`): Q, dO, the K ring, the V ring, then dS.
struct DqLayout {
  int kst, vst;
  size_t bytes;
};

inline size_t dq_bytes(int d, int kst, int vst) {
  const int bk = dq_keys(d);
  return ((size_t)(2 * kBlockQ + (kst + vst) * bk) * tile_ld(d) +
          (size_t)kBlockQ * (bk + 16)) * sizeof(float);
}

inline DqLayout core_dq_layout(int d) {
  int kst = kDqKStages, vst = kDqVStages;
  while ((vst > 1 || kst > 1) && dq_bytes(d, kst, vst) > (size_t)kMaxSmem) {
    if (vst > 1) --vst;
    else --kst;
  }
  return {kst, vst, dq_bytes(d, kst, vst)};
}

// T: q, k, v, dO and dq (float or bfloat16). DC: the float4 column chunks
// of dQ a thread owns (tx + 16 c), so D <= 64 * DC; KPT: the keys of a tile
// a thread owns (tx + 16 j), BK = 16 * KPT. kst, vst: the rings' stages
// (1 or 2).
template <typename T, int DC, int KPT>
__global__ void __launch_bounds__(kThreads, DC == 1 ? kDqMinBlocks : 1)
flash_dq_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int sq, int sk, int d, int causal, float scale,
                     int gran_q, int gran_kv, int kst, int vst) {
  constexpr int BK = 16 * KPT;
  constexpr int RM = kBlockQ / 16;   // query rows a thread: ty + 16 i
  constexpr int LDP = BK + 16;
  extern __shared__ __align__(16) float smem[];
  const int ld = tile_ld(d);
  float* qs = smem;                                 // [kBlockQ][ld]
  float* dos = qs + (size_t)kBlockQ * ld;           // [kBlockQ][ld]
  float* kring = dos + (size_t)kBlockQ * ld;        // [kst][BK][ld]
  float* vring = kring + (size_t)kst * BK * ld;     // [vst][BK][ld]
  float* dss = vring + (size_t)vst * BK * ld;       // [kBlockQ][LDP]

  // blocks in launch order: every (b, h) of the last query block, then of
  // the one before, ...
  const int nbh = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int bh = lin % nbh;
  const int q0 = (gridDim.x - 1 - lin / nbh) * kBlockQ;
  const int off = sk - sq;
  int nkb = (sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + kBlockQ - 1 + off) / BK + 1);
  const size_t qbase = (size_t)bh * sq;
  const T* kp = k + (size_t)bh * sk * d;
  const T* vp = v + (size_t)bh * sk * d;
  const int tx = tile_tx(), ty = tile_ty();
  const int n4 = (d + 3) / 4;
  const float scale2 = scale * kLog2e;   // scores in base-2 units

  zero_pad(smem, ld, 2 * kBlockQ + (kst + vst) * BK, d);   // Q, dO, rings
  auto load_k = [&](int j) {
    if (j < nkb)
      load_rows<BK>(kring + (size_t)(j & (kst - 1)) * BK * ld, ld, kp,
                    j * BK, sk, d, gran_kv);
  };
  auto load_v = [&](int j) {
    if (j < nkb)
      load_rows<BK>(vring + (size_t)(j & (vst - 1)) * BK * ld, ld, vp,
                    j * BK, sk, d, gran_kv);
  };
  load_rows<kBlockQ>(qs, ld, q + qbase * d, q0, sq, d, gran_q);
  load_rows<kBlockQ>(dos, ld, dout + qbase * d, q0, sq, d, gran_q);
  load_k(0);
  load_v(0);
  cp_async_commit();

  // the owned rows' lse (in base-2 units) and delta; 0 past sq, where Q
  // and dO are zero rows, so dS is 0 there
  float lr[RM], dr[RM], acc[RM][DC][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < sq ? lse[qbase + row] * kLog2e : 0.f;
    dr[i] = row < sq ? delta[qbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int j = 0; j < nkb; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // K j and V j are in; dS and K j - 1 are read
    if (kst > 1) load_k(j + 1);
    if (vst > 1) load_v(j + 1);
    cp_async_commit();
    const int k0 = j * BK;
    const float* kt = kring + (size_t)(j & (kst - 1)) * BK * ld;
    const float* vt = vring + (size_t)(j & (vst - 1)) * BK * ld;

    // S = Q K^T and dP = dO V^T: rows ty + 16 i, keys tx + 16 jj
    float s[RM][KPT], dp[RM][KPT];
    tile_nt2<RM, KPT>(s, qs, kt, dp, dos, vt, ld, n4);
    // P = 2^(S * scale * log2 e - lse * log2 e); the mask, only on a tile
    // past some row's diagonal or past the keys
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int lim = causal ? min(q0 + ty + 16 * i + off + 1, sk) : sk;
      float* drow = dss + (size_t)(ty + 16 * i) * LDP + tx;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const bool seen = !edge || k0 + tx + 16 * jj < lim;
        const float p = seen ? exp2f(s[i][jj] * scale2 - lr[i]) : 0.f;
        drow[16 * jj] = p * (dp[i][jj] - dr[i]);
      }
    }
    __syncthreads();   // dS is in; V j is read
    if (vst == 1) {
      load_v(j + 1);
      cp_async_commit();
    }
    // dQ += dS K: rows ty + 16 i, columns 4 (tx + 16 c) .. + 3
    tile_nn<RM, DC>(acc, dss, LDP, kt, ld, BK, n4);
    if (kst == 1) {
      __syncthreads();   // K j is read: the next tile's K may land
      load_k(j + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();   // nothing left in flight past the last tile

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    T* drow = dq + (qbase + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (tx + 16 * c) + e;
        if (col < d) drow[col] = from_float<T>(acc[i][c][e] * scale);
      }
  }
}

template <typename T, int DC, int KPT>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int bh, int sq,
           int sk, int d, int causal, float scale, cudaStream_t stream) {
  const DqLayout lay = core_dq_layout(d);
  if (lay.bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = flash_dq_core_kernel<T, DC, KPT>;
  cudaError_t err = allow_smem(kern, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int gq = copy_granule(d * (int)sizeof(float), q, dout);
  const int gkv = copy_granule(d * (int)sizeof(float), k, v);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  kern<<<grid, kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sq, sk, d, causal, scale, gq, gkv, lay.kst,
      lay.vst);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, int bh, int sq,
             int sk, int d, int causal, float scale, cudaStream_t s) {
#define PTT_DQ(DC, KPT)                                                   \
  launch<T, DC, KPT>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, causal, \
                     scale, s)
  if (d <= 64) return PTT_DQ(1, kDqSmallKpt);
  if (d <= 128) return PTT_DQ(2, 4);
  return PTT_DQ(4, 2);
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
