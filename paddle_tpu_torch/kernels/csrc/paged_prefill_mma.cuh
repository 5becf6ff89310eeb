// The ragged paged-attention PREFILL loop on Hopper's tensor cores, for q in
// bfloat16: shared by paged_prefill.cu (bfloat16 pools) and
// paged_prefill_int8.cu (int8 pools with f32 scales), which launch it when
// q is bfloat16 and the head dim is a multiple of 16 up to 128
// (`mma_takes`). Every other case runs the CUDA-core loop of
// paged_prefill.cuh.
//
// Replaces: paddle_tpu/kernels/pallas/prefill_attention.py::_prefill_kernel
// (entry `prefill_attention`), both arms. One chunk of C queries of ONE
// sequence, the chunk's first token at absolute position `start`, attends
// over that sequence's K/V pages with an absolute-position causal mask (the
// query at p sees keys 0..p), f32 scores and an f32 online softmax; rows at
// or past `valid` are written as 0. A query tile of padding rows visits 0
// pages; any other visits ceil((start + last live row + 1) / page_size),
// never more than pages_per_slot.
//
// Bound on the H100: the K/V bytes of the visible pages (2 * keys * dh *
// itemsize, plus 2 * 4 scale bytes per key for int8 pools) over 3.35
// TB/s, or the causal products (4 * dh operations per visible (query, key)
// pair) over 989 TFLOP/s. At C=1024, GPT-2 small's 12 heads of 64 that is
// 1.61 GFLOP, 0.0016 ms, against 0.0019 ms of bytes: a few microseconds.
//
// Design:
// - Tile and grid. A block owns 64 query rows of one head: 4 groups of
//   16 rows, each taken by two warps that split every 64-key tile in
//   halves and merge their (O, max, sum) at the end, so the longest chain
//   of tiles one warp walks is half the causal window (8 warps a block).
//   The grid is (heads, query tiles) and blockIdx.y 0 takes the LAST query
//   tile, so the tiles that see the most keys start first on every head
//   and the causal tail is short.
// - Products on the tensor cores: S = Q K^T and O += P V with
//   mma.sync.m16n8k16 (bf16 operands, f32 accumulators). Q is loaded once
//   into registers (cp.async to shared memory, then ldmatrix), K through
//   ldmatrix and V through ldmatrix.trans. The softmax scale multiplies S
//   in f32 after the product (1/sqrt(dh) is not a power of two for every
//   dh, so q * scale would round). P stays in registers: the score
//   accumulators of two 8-key column tiles are exactly the A fragment of
//   the next product once rounded to bf16, as in the flash kernels. The
//   row max takes two shuffles across the four threads that hold a row,
//   once per half tile, and the row sum two at the end; the causal mask is
//   applied only on half tiles that cross a row's limit.
// - Page gather and the load ring. A 64-key tile spans several pages (or
//   part of one), so it is no single TMA box: each key row is gathered by
//   16-byte cp.async copies from page_table[key / page_size], for any page
//   size; the block's page-table row is read into shared memory once, so
//   no copy waits on a lookup. Four stages of K and V tiles sit in shared
//   memory (18 KB a stage at dh=64 in bf16, rows padded by 16 bytes so
//   ldmatrix meets no bank conflict); tiles j+1 to j+3 are in flight while
//   tile j is multiplied. Keys past the block's last live position are
//   never read: their copies have source size 0 and fill zeros, which the
//   mask hides.
// - int8 pools: the int8 bytes and the tile's 64 K and 64 V scales are
//   copied as they are, so only they are read from device memory. While
//   the warps multiply tile j, the block widens tile j+1's int8 K and V
//   to bf16 in a second shared-memory buffer (integer-to-float by byte
//   permutes and one add, no conversion instructions), which is exact
//   (|v| <= 127 fits bf16's 8-bit significand): V must reach its B
//   fragments transposed, and ldmatrix.trans moves only 16-bit elements.
//   The copies run one tile further ahead, so a tile still costs one
//   barrier. The scales are folded in after the products:
//   s_t = (q . k_t) * (ks_t / sqrt(dh)) in f32, and p_t * vs_t before P is
//   rounded to bf16. Against the plain version (dequantize, then f32
//   products) only the order of the sums and P's rounding differ.
// - Why mma.sync and not wgmma with TMA here: the whole C=1024 product is
//   1.61 GFLOP, about 5 microseconds even at 300 TFLOP/s, a seventh of one
//   SDPA call over the gathered window; what sets this kernel's pace is
//   the page gather and the latency of the heaviest tile's chain, not the
//   product instruction (profile_prefill.py on an H100: taking either
//   product out saves at most 3.2 of 26.6 us at C=1024). wgmma with TMA
//   and producer warps belongs to the flash kernels, whose products set a
//   train step's pace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace paddle_tpu_torch {

constexpr int kRowWarps = 4;                  // 16-row groups of a block
constexpr int kMmaWarps = 2 * kRowWarps;      // x 2 halves of each key tile
constexpr int kMmaBlockQ = 16 * kRowWarps;    // query rows of a block
constexpr int kMmaKeys = 64;                  // keys of a tile
constexpr int kHalfKeys = kMmaKeys / 2;       // keys of a tile one warp takes
constexpr int kMmaStages = 4;                 // tiles in the load ring
constexpr int kMaxPages = 16384;              // page-table row kept in smem
// Four int8 values (the bytes of `w`, lowest first) as four bf16 in two
// registers, exactly: each byte b becomes the float 2^23 + (b + 128) by
// placing b ^ 0x80 under the exponent of 2^23, loses 2^23 + 128 in one
// exact add, and keeps the upper half of the float, which is its bf16
// (|b| <= 128 needs 8 significant bits).
__device__ __forceinline__ uint2 widen_int8x4(unsigned w) {
  const unsigned u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)) -
           8388736.f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// Shared-memory layout of one block, in bytes: the Q tile, the ring of
// K/V stages and, for int8 pools, two buffers of widened bf16 K and V with
// the tile's K scales (times 1/sqrt(dh)) and V scales: the tile being
// multiplied and the next one, widened meanwhile. bf16 rows are padded by
// 16 bytes, so the 8 rows an ldmatrix reads fall in 8 distinct 16-byte
// bank groups.
template <typename P, int DH>
struct MmaLayout {
  static constexpr bool kInt8 = std::is_same_v<P, signed char>;
  static constexpr int kLd = DH + 8;               // bf16 row, elements
  static constexpr int kRowBytes = kInt8 ? DH + 16 : 2 * kLd;   // ring row
  static constexpr int kTile = kMmaKeys * 2 * kLd;  // one bf16 K or V tile
  static constexpr int kQ = kMmaBlockQ * 2 * kLd;
  static constexpr int kScales = kInt8 ? 2 * kMmaKeys * 4 : 0;
  static constexpr int kStage = 2 * kMmaKeys * kRowBytes + kScales;
  static constexpr int kWideBuf = 2 * kTile + kScales;
  static constexpr int kWide = kInt8 ? 2 * kWideBuf : 0;
  static constexpr int kBytes = kQ + kMmaStages * kStage + kWide;
};

// n / d for 0 <= n < 2^31 by one multiply-high, the divisor fixed for a
// launch (the page size): (umulhi(n, mul) + n) >> shift.
struct FastDiv {
  unsigned d, mul, shift;
  explicit FastDiv(unsigned divisor) : d(divisor), mul(0), shift(0) {
    while ((1u << shift) < d) ++shift;
    mul = (unsigned)(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, mul) + n) >> shift;
  }
};

template <typename P, int DH>
__global__ void __launch_bounds__(kMmaWarps * 32, DH <= 64 ? 2 : 1)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const P* __restrict__ k_pages,
                         const P* __restrict__ v_pages,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ page_table,
                         __nv_bfloat16* __restrict__ out,
                         int* __restrict__ visits, int c, int nh,
                         FastDiv ps, int maxp, const int* __restrict__ start_p,
                         const int* __restrict__ valid_p, int block_q,
                         float scale) {
  using L = MmaLayout<P, DH>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int kLd = L::kLd;
  constexpr int KC = DH / 16;                  // 16-deep steps of Q K^T
  constexpr int ND = DH / 8;                   // 8-wide tiles of O
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kChunks = DH / 8;              // 16-byte chunks, bf16 row
  constexpr int kPoolChunks = DH * (int)sizeof(P) / 16;
  // int8: the loop widens tile kt + 1 while it multiplies tile kt, so the
  // copies run one tile further ahead
  constexpr int kAhead = kInt8 ? 1 : 0;
  static_assert(kThreads >= 2 * kMmaKeys, "a thread per K or V scale");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  unsigned char* ring = mma_smem + L::kQ;
  unsigned char* wide = ring + kMmaStages * L::kStage;
  int* pts = reinterpret_cast<int*>(mma_smem + L::kBytes);   // page row

  const ChunkBounds cb =
      load_chunk_bounds(start_p, valid_p, c, maxp * (int)ps.d);
  const int start = cb.start, valid = cb.valid;
  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tile first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = qt * block_q;
  const int nrows = max(0, min(valid - row0, block_q));   // live rows
  const int rows_out = min(block_q, c - row0);            // rows of `out`
  // keys [0, kv_end): up to the last live row's position, in the slot
  const int kv_end =
      nrows > 0 ? min(start + row0 + nrows, maxp * (int)ps.d) : 0;
  const int npages = (kv_end + ps.d - 1) / ps.d;
  if (visits != nullptr && tid == 0) visits[qt * nh + h] = npages;
  const size_t tok = (size_t)nh * DH;
  __nv_bfloat16* obase = out + (size_t)row0 * tok + (size_t)h * DH;

  if (nrows == 0) {   // a tile of padding rows reads nothing, writes zeros
    for (int e = tid; e < rows_out * kChunks; e += kThreads)
      *reinterpret_cast<uint4*>(obase + (e / kChunks) * tok +
                                (e % kChunks) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }

  // Q tile, its own copy group; rows past the live ones are zeros
  for (int e = tid; e < kMmaBlockQ * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks;
    const bool live = r < nrows;
    const __nv_bfloat16* src =
        live ? q + (size_t)(row0 + r) * tok + (size_t)h * DH + ch * 8 : q;
    cp_async16(smem_addr(qs + r * kLd + ch * 8), src, live);
  }
  cp_async_commit();
  // the pages the block visits, once, so that no copy waits on a lookup
  for (int i = tid; i < npages; i += kThreads)
    pts[i] = __ldg(page_table + i);
  __syncthreads();

  // token slot of `key` in the pools (key < kv_end)
  auto slot_of = [&](int key) {
    const unsigned pi = ps.div((unsigned)key);
    return (size_t)pts[pi] * ps.d + (key - pi * ps.d);
  };
  const int ntiles = (kv_end + kMmaKeys - 1) / kMmaKeys;
  // Issues the copies of key tile kt into its ring stage: every key row
  // from its own page, zero-filled past kv_end; one copy group, empty past
  // the last tile so that the group count stays uniform.
  auto load_tile = [&](int kt) {
    if (kt < ntiles) {
      unsigned char* st = ring + (kt % kMmaStages) * L::kStage;
      const int key0 = kt * kMmaKeys;
      for (int e = tid; e < kMmaKeys * kPoolChunks; e += kThreads) {
        const int t = e / kPoolChunks, ch = e % kPoolChunks;
        const int key = key0 + t;
        const bool live = key < kv_end;
        const size_t off =
            live ? (slot_of(key) * nh + h) * DH + ch * (16 / sizeof(P)) : 0;
        unsigned char* kd = st + t * L::kRowBytes + ch * 16;
        cp_async16(smem_addr(kd), k_pages + off, live);
        cp_async16(smem_addr(kd + kMmaKeys * L::kRowBytes), v_pages + off,
                   live);
      }
      if constexpr (kInt8) {
        float* kss =
            reinterpret_cast<float*>(st + 2 * kMmaKeys * L::kRowBytes);
        if (tid < 2 * kMmaKeys) {   // K scales, then V scales
          const int t = tid % kMmaKeys, key = key0 + t;
          const bool live = key < kv_end;
          const size_t slot = live ? slot_of(key) * nh + h : 0;
          cp_async4(smem_addr(kss + tid),
                    (tid < kMmaKeys ? k_scale : v_scale) + slot, live);
        }
      }
    }
    cp_async_commit();
  };

  // int8: widens landed tile kt (its K and V to bf16, its K scales times
  // 1/sqrt(dh), its V scales as they are) into wide buffer kt % 2, the
  // whole block
  auto widen_tile = [&](int kt) {
    if constexpr (kInt8) {
      if (kt >= ntiles) return;
      const unsigned char* st = ring + (kt % kMmaStages) * L::kStage;
      unsigned char* wb = wide + (kt & 1) * L::kWideBuf;
      constexpr int kRowChunks = DH / 16;
      for (int e = tid; e < 2 * kMmaKeys * kRowChunks; e += kThreads) {
        const int r = e / kRowChunks, ch = e % kRowChunks;   // r < 128: K, V
        const uint4 raw = *reinterpret_cast<const uint4*>(
            st + r * L::kRowBytes + ch * 16);
        const uint2 a = widen_int8x4(raw.x), b = widen_int8x4(raw.y);
        const uint2 c2 = widen_int8x4(raw.z), d = widen_int8x4(raw.w);
        uint4* dst = reinterpret_cast<uint4*>(wb + (r * kLd + ch * 16) * 2);
        dst[0] = make_uint4(a.x, a.y, b.x, b.y);
        dst[1] = make_uint4(c2.x, c2.y, d.x, d.y);
      }
      if (tid < 2 * kMmaKeys) {
        const float* src =
            reinterpret_cast<const float*>(st + 2 * kMmaKeys * L::kRowBytes);
        float* dsc = reinterpret_cast<float*>(wb + 2 * L::kTile);
        dsc[tid] = tid < kMmaKeys ? src[tid] * scale : src[tid];
      }
    }
  };

  for (int s = 0; s < kMmaStages - 1 + kAhead; ++s) load_tile(s);

  // warp roles: 16 query rows (rw) x one half of every key tile (kh)
  const int rw = warp % kRowWarps, kh = warp / kRowWarps;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row, column pair
  const int wrow0 = rw * 16;
  const int khalf = kh * kHalfKeys;
  // the last key each of this thread's two rows sees; padding rows see up
  // to the block's last live key
  const int base = start + row0 + wrow0;
  const int lim0 = min(base + g, kv_end - 1);
  const int lim1 = min(base + g + 8, kv_end - 1);
  const int wfirst = min(base, kv_end - 1);
  const int wlast =
      min(start + row0 + min(wrow0 + 15, nrows - 1), kv_end - 1);
  // tiles whose half holds a key some row of this warp sees; none for a
  // group of padding rows
  const int wtiles = wrow0 < nrows && wlast >= khalf
                         ? (wlast - khalf) / kMmaKeys + 1
                         : 0;

  cp_async_wait<kMmaStages - 1 + kAhead>();   // the Q group has landed
  __syncthreads();
  unsigned qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(smem_addr(qs + (wrow0 + (lane & 15)) * kLd + kc * 16 +
                      (lane >> 4) * 8),
            qf[kc]);
  if constexpr (kInt8) {
    cp_async_wait<kMmaStages - 1>();   // tile 0 has landed
    __syncthreads();
    widen_tile(0);
  }

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // -inf until a row has seen a key: a warp's half tile may hide every
  // key from some of its rows
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // Folds key tile kt (the warp's half of it) into the warp's rows.
  auto multiply_tile = [&](int kt) {
    const __nv_bfloat16* kt_s;
    const float* kss = nullptr;   // int8: K scales / sqrt(dh), V scales
    if constexpr (kInt8) {
      const unsigned char* wb = wide + (kt & 1) * L::kWideBuf;
      kt_s = reinterpret_cast<const __nv_bfloat16*>(wb);
      kss = reinterpret_cast<const float*>(wb + 2 * L::kTile);
    } else {
      kt_s = reinterpret_cast<const __nv_bfloat16*>(
          ring + (kt % kMmaStages) * L::kStage);
    }
    const __nv_bfloat16* vt_s = kt_s + kMmaKeys * kLd;
    const int key0 = kt * kMmaKeys + khalf;   // this warp's first key

    // S = Q K^T over the warp's 32 keys: 4 column tiles of 8, 16 rows each
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned b[4];
        ldsm_x4(smem_addr(kt_s +
                          (khalf + np * 16 + (lane & 7) +
                           ((lane >> 4) << 3)) * kLd +
                          kc * 16 + ((lane >> 3) & 1) * 8),
                b);
        mma_16816(s[2 * np], qf[kc], b[0], b[1]);
        mma_16816(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    }

    // scale (and K scales), causal mask on tiles that cross a row's limit
    const bool masked = key0 + kHalfKeys - 1 > wfirst;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n * 8 + 2 * t4 + (i & 1);   // key key0 + col
        float x;
        if constexpr (kInt8)
          x = s[n][i] * kss[khalf + col];
        else
          x = s[n][i] * scale;
        if (masked && key0 + col > (i < 2 ? lim0 : lim1)) x = -INFINITY;
        s[n][i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // online softmax: a row lives on the 4 threads of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));
    // a row that has seen no key yet keeps p = 0 and its empty state
    const float mb0 = mx0 == -INFINITY ? 0.f : mx0 * kLog2e;
    const float mb1 = mx1 == -INFINITY ? 0.f : mx1 * kLog2e;
    const float a0 = fast_exp2(m0 * kLog2e - mb0);
    const float a1 = fast_exp2(m1 * kLog2e - mb1);
    m0 = mx0;
    m1 = mx1;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      s[n][0] = fast_exp2(fmaf(s[n][0], kLog2e, -mb0));
      s[n][1] = fast_exp2(fmaf(s[n][1], kLog2e, -mb0));
      s[n][2] = fast_exp2(fmaf(s[n][2], kLog2e, -mb1));
      s[n][3] = fast_exp2(fmaf(s[n][3], kLog2e, -mb1));
      r0 += s[n][0] + s[n][1];
      r1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + r0;   // this thread's columns; the quad adds at the end
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }

    // O += P V, P from the score registers (times the V scales), in bf16
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      float vs[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
      if constexpr (kInt8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = khalf + (2 * kc + j) * 8 + 2 * t4;
          vs[j][0] = kss[kMmaKeys + col];
          vs[j][1] = kss[kMmaKeys + col + 1];
        }
      }
      const float(&p0)[4] = s[2 * kc];
      const float(&p1)[4] = s[2 * kc + 1];
      const unsigned a[4] = {pack_bf16(p0[0] * vs[0][0], p0[1] * vs[0][1]),
                             pack_bf16(p0[2] * vs[0][0], p0[3] * vs[0][1]),
                             pack_bf16(p1[0] * vs[1][0], p1[1] * vs[1][1]),
                             pack_bf16(p1[2] * vs[1][0], p1[3] * vs[1][1])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        unsigned b[4];
        ldsm_x4_trans(
            smem_addr(vt_s +
                      (khalf + kc * 16 + (lane & 7) +
                       ((lane >> 3) & 1) * 8) * kLd +
                      dp * 16 + (lane >> 4) * 8),
            b);
        mma_16816(o[2 * dp], a, b[0], b[1]);
        mma_16816(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  };

  for (int kt = 0; kt < ntiles; ++kt) {
    // tile kt + kAhead has landed (this thread's copies); after the
    // barrier everyone's has, and the stage and buffer of tile kt - 1 are
    // free
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    load_tile(kt + kMmaStages - 1 + kAhead);
    widen_tile(kt + 1);
    if (kt < wtiles) multiply_tile(kt);   // warp-uniform
  }

  // merge the two key halves of every row: the second half's warps leave
  // (O, m, l) in the drained ring, the first half's fold them in and write
  l0 += __shfl_xor_sync(kFullMask, l0, 1);
  l0 += __shfl_xor_sync(kFullMask, l0, 2);
  l1 += __shfl_xor_sync(kFullMask, l1, 1);
  l1 += __shfl_xor_sync(kFullMask, l1, 2);
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kOLd = DH + 4;   // f32 row of the merge buffer
  static_assert(kMmaBlockQ * (kOLd + 2) * 4 <= kMmaStages * L::kStage,
                "the merge buffer fits the ring");
  float* mo = reinterpret_cast<float*>(ring);
  float* mml = mo + kMmaBlockQ * kOLd;   // [rows][2]: m, l
  const int r0 = wrow0 + g, r1 = r0 + 8;
  if (kh == 1) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = d * 8 + 2 * t4;
      *reinterpret_cast<float2*>(mo + r0 * kOLd + col) =
          make_float2(o[d][0], o[d][1]);
      *reinterpret_cast<float2*>(mo + r1 * kOLd + col) =
          make_float2(o[d][2], o[d][3]);
    }
    if (t4 == 0) {
      mml[2 * r0] = m0;
      mml[2 * r0 + 1] = l0;
      mml[2 * r1] = m1;
      mml[2 * r1 + 1] = l1;
    }
  }
  __syncthreads();
  if (kh == 1) return;
  const float mb0 = mml[2 * r0], mb1 = mml[2 * r1];
  const float mm0 = fmaxf(m0, mb0), mm1 = fmaxf(m1, mb1);
  // weights of the two halves; 0 for a row neither half saw
  const float fa0 = mm0 == -INFINITY ? 0.f : fast_exp2((m0 - mm0) * kLog2e);
  const float fb0 = mm0 == -INFINITY ? 0.f : fast_exp2((mb0 - mm0) * kLog2e);
  const float fa1 = mm1 == -INFINITY ? 0.f : fast_exp2((m1 - mm1) * kLog2e);
  const float fb1 = mm1 == -INFINITY ? 0.f : fast_exp2((mb1 - mm1) * kLog2e);
  const float ls0 = l0 * fa0 + mml[2 * r0 + 1] * fb0;
  const float ls1 = l1 * fa1 + mml[2 * r1 + 1] * fb1;
  const float inv0 = r0 < nrows ? 1.f / fmaxf(ls0, 1e-30f) : 0.f;
  const float inv1 = r1 < nrows ? 1.f / fmaxf(ls1, 1e-30f) : 0.f;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + 2 * t4;
    const float2 ob0 = *reinterpret_cast<const float2*>(mo + r0 * kOLd + col);
    const float2 ob1 = *reinterpret_cast<const float2*>(mo + r1 * kOLd + col);
    if (r0 < rows_out)
      *reinterpret_cast<unsigned*>(obase + r0 * tok + col) =
          pack_bf16((o[d][0] * fa0 + ob0.x * fb0) * inv0,
                    (o[d][1] * fa0 + ob0.y * fb0) * inv0);
    if (r1 < rows_out)
      *reinterpret_cast<unsigned*>(obase + r1 * tok + col) =
          pack_bf16((o[d][2] * fa1 + ob1.x * fb1) * inv1,
                    (o[d][3] * fa1 + ob1.y * fb1) * inv1);
  }
}

template <typename P, int DH>
int launch_mma_dh(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_scale, const void* v_scale,
                  const int* page_table, void* out, int* visits, int c,
                  int nh, int ps, int maxp, const int* start,
                  const int* valid, int block_q, cudaStream_t stream) {
  auto kern = paged_prefill_mma_kernel<P, DH>;
  // the layout, then the page-table row
  const int smem = MmaLayout<P, DH>::kBytes + (maxp * 4 + 15) / 16 * 16;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(nh, (c + block_q - 1) / block_q);
  kern<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), page_table,
      static_cast<__nv_bfloat16*>(out), visits, c, nh, FastDiv(ps), maxp,
      start, valid, block_q, (float)(1.0 / std::sqrt((double)DH)));
  return (int)cudaGetLastError();
}

// Launches the tensor-core loop for q/out in bf16 and pools of type P
// (bf16, or int8 with k_scale/v_scale) on `stream`; the caller has checked
// mma_takes(dtype, dh), block_q <= kMmaBlockQ, maxp <= kMaxPages and
// 16-byte alignment.
// Returns the launch's cudaGetLastError().
template <typename P>
int launch_paged_prefill_mma(const void* q, const void* k_pages,
                             const void* v_pages, const void* k_scale,
                             const void* v_scale, const int* page_table,
                             void* out, int* visits, int c, int nh, int dh,
                             int ps, int maxp, const int* start,
                             const int* valid, int block_q,
                             cudaStream_t stream) {
#define PTT_MMA(DH)                                                          \
  case DH:                                                                   \
    return launch_mma_dh<P, DH>(q, k_pages, v_pages, k_scale, v_scale,       \
                                page_table, out, visits, c, nh, ps, maxp,    \
                                start, valid, block_q, stream)
  switch (dh) {
    PTT_MMA(16);
    PTT_MMA(32);
    PTT_MMA(48);
    PTT_MMA(64);
    PTT_MMA(80);
    PTT_MMA(96);
    PTT_MMA(112);
    PTT_MMA(128);
  }
#undef PTT_MMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace paddle_tpu_torch
