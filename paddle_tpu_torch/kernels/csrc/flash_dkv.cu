// Flash-attention BACKWARD kernel for dK and dV, Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py::_dkv_kernel (the
// second `pl.pallas_call` of `_bwd`). For each key it recomputes the
// probabilities of the query rows that see it from the saved logsumexp,
// P = exp(s - lse), masked to 0 past the bottom-right causal diagonal and
// on the ragged query tail, and sums
//   dV = sum_i P_i dO_i,   dK = scale * sum_i P_i (dP_i - delta_i) q_i
// with dP = dO V^T and delta = rowsum(dO * O) from outside the kernel.
// dk and dv are written in k's and v's dtype, each row by exactly one
// block: no atomics, and a run repeats bit for bit.
//
// Bound on the H100: operations. Four products (scores, dV, dP, dK) cost
// 8 * D operations per visible (query, key) pair, against reading q, k, v,
// dO, lse and delta and writing dk and dv once: at the train shape (B=8,
// H=12, S=1024, D=64, causal) 0.38500 ms in f32 at 67 TFLOP/s, at the
// incubate shape (non-causal) 0.76925 ms.
//
// Two loops, picked by a fixed rule before the launch (`mma_takes`, the
// wrapper's `dkv_arm`): q, k, v and dO in bfloat16 with a head dim that is
// a multiple of 16 up to 128 run on the tensor cores (flash_dkv_mma.cuh,
// whose header gives that loop's design); float32, and bfloat16 at the
// other head dims (up to 256), run the CUDA-core loop below. Float32 stays
// on the CUDA cores because the tensor cores would take it only as TF32.
//
// The CUDA-core loop (flash_common.cuh's register-tiled primitives):
// - Grid (key blocks of BK keys, b*h), BK = 64 up to D=128 and 32 above,
//   taken in the order of the linear block index as every (b, h) of key
//   block 0 (which sees the most causal query rows), then of block 1, ...
//   A block walks the query tiles of 64 rows from the first one that can
//   see its keys, `max(0, k0 - (Sk - Sq)) / 64`, as the Pallas kernel
//   starts (:170-173).
// - The block's K and V rows come in once by cp.async (16, 8 or 4 bytes a
//   copy, `copy_granule`); each query tile's Q and dO rows, with their lse
//   and delta, come through a ring. Up to D=64 it has one stage and two
//   blocks share an SM (registers capped at 128), each block's copies
//   hidden behind the other's products; above, two stages where they fit
//   (D=65-112 and 129-160), one block an SM, the next tile's copies in
//   flight while this one is multiplied. bfloat16 rows are widened into the
//   same f32 tiles by plain loads. Rows are padded to a stride of 4 mod 8
//   floats.
// - 256 threads as a 16 x 16 grid: thread (ty, tx) owns keys ty + 16 i and
//   query rows tx + 16 j of a tile. One pass over D with float4 reads forms
//   S^T = K Q^T and dP^T = V dO^T in registers (`tile_nt2`, exact f32
//   FMAs, 32 accumulators interleaved); then P^T = exp(S^T * scale - lse),
//   taken as exp2f of both terms times log2 e, masked only on a tile that
//   crosses the diagonal or the end of the queries, and dS^T = P^T (dP^T -
//   delta) go to shared memory (rows of 64 + 16 floats: the two half-warps
//   of a warp write 16 banks apart).
// - dV += P^T dO and dK += dS^T Q are tiled the same way, in one pass over
//   the tile's rows (`tile_nn2`, their accumulators interleaved): each
//   thread owns its BK / 16 keys x 4 * DC columns of both in f32 registers,
//   written once at the end, dK times `scale`.
// - Shared memory (K, V, the ring, P^T and dS^T): 111,104 bytes at D=64
//   (one stage, two blocks an SM); 176,640 at D=128 and 220,672 at D=256
//   (one stage, one block).
// - Measured on an H100 80GB HBM3 at 700 W, 1980 MHz (compare_serve.py
//   --flash, the loop it replaced in the same call): 0.8217-0.8329 ms at
//   the train shape, 47% of its 0.3850 ms bound, against 1.4407-1.4622;
//   1.5620-1.5841 at the incubate shape, 49% of 0.7693, against
//   2.4583-2.4614. Two
//   stages with one block an SM: 0.916 / 1.724 ms; one stage, one block:
//   0.973 / 1.831. Taking out S^T and dP^T saves 0.38 / 0.75 ms, dV and dK
//   0.35 / 0.68, the copies 0.04 / 0.07 (profile_dkv.py core).

#include "flash_common.cuh"
#include "flash_dkv_mma.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace flash;

// Q/dO ring stages: one at D <= 64, where two blocks an SM (registers
// capped at 128) hide each other's copies; above, two where they fit
constexpr int kDkvSmallStages = 1;
constexpr int kDkvStages = 2;
constexpr int kDkvMinBlocks = 2;   // blocks an SM at D <= 64
constexpr int kDkvLdp = kBlockQ + 16;

// Shared-memory layout of a CUDA-core dK/dV block (the wrapper's
// `core_dkv_layout`): the ring's stages and the bytes. K, V, the ring
// (Q rows, then dO rows, a stage), P^T, dS^T, then each stage's lse and
// delta.
struct DkvLayout {
  int stages;
  size_t bytes;
};

inline DkvLayout core_dkv_layout(int d) {
  const int bk = d <= 128 ? 64 : 32;
  const int ld = tile_ld(d);
  for (int st = d <= 64 ? kDkvSmallStages : kDkvStages; st > 1; --st) {
    const size_t b = ((size_t)(2 * bk + 2 * st * kBlockQ) * ld +
                      (size_t)2 * bk * kDkvLdp + 2 * st * kBlockQ) *
                     sizeof(float);
    if (b <= (size_t)kMaxSmem) return {st, b};
  }
  return {1, ((size_t)(2 * bk + 2 * kBlockQ) * ld + (size_t)2 * bk * kDkvLdp +
              2 * kBlockQ) * sizeof(float)};
}

// T: q, k, v, dO, dk and dv (float or bfloat16). DC: the float4 column
// chunks of dK and dV a thread owns (tx + 16 c), so D <= 64 * DC; RM: the
// keys a thread owns (ty + 16 i), BK = 16 * RM.
template <typename T, int DC, int RM>
__global__ void __launch_bounds__(kThreads, DC == 1 ? kDkvMinBlocks : 1)
flash_dkv_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int d, int causal,
                      float scale, int gran_q, int gran_kv, int stages) {
  constexpr int BK = 16 * RM;          // keys of the block
  constexpr int CN = kBlockQ / 16;     // query rows a thread: tx + 16 j
  constexpr int LDP = kDkvLdp;
  extern __shared__ __align__(16) float smem[];
  const int ld = tile_ld(d);
  float* ks = smem;                                   // [BK][ld]
  float* vs = ks + (size_t)BK * ld;                   // [BK][ld]
  float* ring = vs + (size_t)BK * ld;                 // [stages][2 * 64][ld]
  float* pt = ring + (size_t)stages * 2 * kBlockQ * ld;   // [BK][LDP]
  float* dst = pt + (size_t)BK * LDP;                 // [BK][LDP]
  float* rowv = dst + (size_t)BK * LDP;               // [stages][2][64]

  // blocks in launch order: every (b, h) of key block 0, then of block 1
  const int nbh = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int bh = lin % nbh;
  const int k0 = (lin / nbh) * BK;
  const int off = sk - sq;
  const int nqb = (sq + kBlockQ - 1) / kBlockQ;
  const int first = causal ? max(0, k0 - off) / kBlockQ : 0;
  const int ntiles = nqb - first;
  const size_t qbase = (size_t)bh * sq;
  const size_t kbase = (size_t)bh * sk;
  const T* qp = q + qbase * d;
  const T* dop = dout + qbase * d;
  const int tx = tile_tx(), ty = tile_ty();
  const int tid = threadIdx.x;
  const int n4 = (d + 3) / 4;
  const float scale2 = scale * kLog2e;   // scores in base-2 units

  zero_pad(smem, ld, 2 * BK + stages * 2 * kBlockQ, d);   // K, V, the ring
  // query tile `first + i` into stage i % stages: Q rows, dO rows, then the
  // rows' lse and delta (zeros past sq)
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int st = i % stages, q0 = (first + i) * kBlockQ;
      float* qt = ring + (size_t)st * 2 * kBlockQ * ld;
      load_rows<kBlockQ>(qt, ld, qp, q0, sq, d, gran_q);
      load_rows<kBlockQ>(qt + (size_t)kBlockQ * ld, ld, dop, q0, sq, d,
                         gran_q);
      if (tid < 2 * kBlockQ) {
        const int r = tid & (kBlockQ - 1), row = q0 + r;
        const float* src = (tid < kBlockQ ? lse : delta) + qbase +
                           (row < sq ? row : 0);
        cp_async4(smem_addr(rowv + st * 2 * kBlockQ + tid), src, row < sq);
      }
    }
    cp_async_commit();   // one group a tile, empty past the last
  };
  load_rows<BK>(ks, ld, k + kbase * d, k0, sk, d, gran_kv);   // in tile
  load_rows<BK>(vs, ld, v + kbase * d, k0, sk, d, gran_kv);   // 0's group
  issue(0);

  float gk[RM][DC][4], gv[RM][DC][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[i][c][e] = gv[i][c][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // tile i is in; tile i - 1 (P^T, dS^T) is read
    if (stages > 1) issue(i + 1);
    const int st = i % stages, q0 = (first + i) * kBlockQ;
    const float* qt = ring + (size_t)st * 2 * kBlockQ * ld;
    const float* dot = qt + (size_t)kBlockQ * ld;
    const float* ls = rowv + st * 2 * kBlockQ;
    const float* dl = ls + kBlockQ;

    // S^T = K Q^T and dP^T = V dO^T: keys ty + 16 r, query rows tx + 16 j
    float s[RM][CN], dp[RM][CN];
    tile_nt2<RM, CN>(s, ks, qt, dp, vs, dot, ld, n4);
    // P^T = 2^(S^T * scale * log2 e - lse * log2 e); the mask, only on a
    // tile past some key's diagonal or past the queries
    const bool edge = q0 + kBlockQ > sq ||
                      (causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int r = tx + 16 * j;
      const float lr = ls[r] * kLog2e, dr = dl[r];
      const int lim = causal ? q0 + r + off : sk;   // keys <= lim see row r
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const int key = k0 + ty + 16 * a;
        const bool seen = !edge || (q0 + r < sq && key <= lim);
        const float p = seen ? exp2f(s[a][j] * scale2 - lr) : 0.f;
        pt[(size_t)(ty + 16 * a) * LDP + r] = p;
        dst[(size_t)(ty + 16 * a) * LDP + r] = p * (dp[a][j] - dr);
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: keys ty + 16 r, columns 4 (tx + 16 c)
    tile_nn2<RM, DC>(gv, pt, dot, gk, dst, qt, LDP, ld, kBlockQ, n4);
    if (stages == 1) {
      __syncthreads();   // the one stage is read: the next tile may land
      issue(i + 1);
    }
  }
  cp_async_wait<0>();   // nothing left in flight past the last tile

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= sk) continue;
    T* krow = dk + (kbase + key) * d;
    T* vrow = dv + (kbase + key) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (tx + 16 * c) + e;
        if (col < d) {
          krow[col] = from_float<T>(gk[a][c][e] * scale);
          vrow[col] = from_float<T>(gv[a][c][e]);
        }
      }
  }
}

template <typename T, int DC, int RM>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int sq, int sk, int d, int causal, float scale,
           cudaStream_t stream) {
  constexpr int BK = 16 * RM;
  const DkvLayout lay = core_dkv_layout(d);
  if (lay.bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = flash_dkv_core_kernel<T, DC, RM>;
  cudaError_t err = allow_smem(kern, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int gq = copy_granule(d * (int)sizeof(float), q, dout);
  const int gkv = copy_granule(d * (int)sizeof(float), k, v);
  const dim3 grid((sk + BK - 1) / BK, bh);
  kern<<<grid, kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, d, causal, scale, gq,
      gkv, lay.stages);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dk, void* dv, int bh,
             int sq, int sk, int d, int causal, float scale,
             cudaStream_t s) {
#define PTT_DKV(DC, RM)                                                      \
  launch<T, DC, RM>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, causal, \
                    scale, s)
  if (d <= 64) return PTT_DKV(1, 4);
  if (d <= 128) return PTT_DKV(2, 4);
  return PTT_DKV(4, 2);
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
