// The ragged paged-attention PREFILL loop on the CUDA cores, shared by the
// float kernel (paged_prefill.cu) and the int8 kernel
// (paged_prefill_int8.cu) for every call the tensor-core loop
// (paged_prefill_mma.cuh) does not take: q in float32, over float32 or int8
// pools (the tensor cores would take f32 only as TF32, about three decimal
// digits), and q in bfloat16 with a head dim that is not a multiple of 16
// or is above 128. The two kernels differ only in the pool element type P
// and so in how a key or value is read when a page is staged in shared
// memory (`pool_value` in attention_common.cuh): a float pool converts, an
// int8 pool widens and scales by its token slot's f32 scale. The staged
// tiles are f32 either way.
//
// One chunk of C queries of ONE sequence, the chunk's first token at
// absolute position `start`, attends over that sequence's K/V pages (the
// chunk's own K/V already written to them) with an absolute-position
// causal mask: the query at position p sees keys 0..p. Rows at or past
// `valid` are chunk padding and are written as 0.
//
// Bound on the H100: memory for the K/V bytes, operations for the scores.
// The pages the chunk's live rows can see are read once (2 * pages *
// page_size * dh * itemsize bytes, plus 2 * 4 scale bytes per key for int8
// pools, over 3.35 TB/s); the causal score and value products cost 4 * dh
// operations per visible (query, key) pair (67 TFLOP/s in f32).
//
// What the design does about it: grid (query block, head). A block loads
// each visited page's [page_size, dh] K and V slice for its head into
// shared memory ONCE (widened, and for int8 pools scaled, on the way in)
// and every query row of the block reads it there, so a page costs one
// device-memory read per block instead of one per row. Each warp owns a
// few rows; per row the keys past its causal limit are cut off before any
// product is formed. The page loop runs block_visits pages: 0 for a block
// of padding rows, ceil((start + last live row + 1) / page_size) otherwise,
// never the slot's capacity. Known gap: each score is reduced across the
// warp one key at a time, a chain of five shuffles per key and row, and
// page loads do not overlap the products.
#pragma once

#include <cmath>

#include "attention_common.cuh"

namespace paddle_tpu_torch {

constexpr int kPrefillWarps = 8;
constexpr int kRowsPerWarp = 4;   // block_q <= kPrefillWarps * kRowsPerWarp

template <typename T, typename P, int DPL>
__global__ void __launch_bounds__(kPrefillWarps * 32)
paged_prefill_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                     const P* __restrict__ v_pages,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ page_table, T* __restrict__ out,
                     int* __restrict__ visits, int c, int nh, int dh, int ps,
                     int maxp, const int* __restrict__ start_p,
                     const int* __restrict__ valid_p, int block_q,
                     float scale) {
  extern __shared__ float smem[];   // K tile [ps, dh] then V tile [ps, dh]
  float* ktile = smem;
  float* vtile = smem + (size_t)ps * dh;

  const ChunkBounds cb = load_chunk_bounds(start_p, valid_p, c, maxp * ps);
  const int start = cb.start, valid = cb.valid;
  const int qb = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = qb * block_q;
  const int nrows = max(0, min(valid - row0, block_q));   // live rows here
  int npages = 0;
  if (nrows > 0) npages = min((start + row0 + nrows - 1 + ps) / ps, maxp);
  if (visits != nullptr && threadIdx.x == 0) visits[qb * nh + h] = npages;

  const size_t tok = (size_t)nh * dh;
  float qv[kRowsPerWarp][DPL], acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + kPrefillWarps * k;
    m[k] = kNegInf;
    l[k] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      acc[k][i] = 0.f;
      qv[k][i] = (r < nrows && d < dh)
                     ? to_float(q[(size_t)(row0 + r) * tok + h * dh + d]) *
                           scale
                     : 0.f;
    }
  }

  for (int j = 0; j < npages; ++j) {
    const int page = page_table[j];
    const size_t page_base = (size_t)page * ps * tok + (size_t)h * dh;
    // token slot of key 0 of this page and head; key t is t * nh further
    const size_t slot0 = (size_t)page * ps * nh + h;
    __syncthreads();   // the previous tile is no longer read
    for (int e = threadIdx.x; e < ps * dh; e += blockDim.x) {
      const int t = e / dh, d = e - t * dh;
      const size_t slot = slot0 + (size_t)t * nh;
      ktile[e] = pool_value(k_pages, k_scale, page_base + t * tok + d, slot);
      vtile[e] = pool_value(v_pages, v_scale, page_base + t * tok + d, slot);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int r = warp + kPrefillWarps * k;
      if (r >= nrows) continue;   // warp-uniform: r depends on warp only
      const int pos = start + row0 + r;
      const int visible = min(ps, pos - j * ps + 1);
      for (int t0 = 0; t0 < visible; t0 += 32) {
        const float* kt = ktile + (size_t)t0 * dh;
        const float* vt = vtile + (size_t)t0 * dh;
        fold_tile<DPL>(
            qv[k], acc[k], m[k], l[k], min(32, visible - t0), dh,
            [&](int t, int d) { return kt[t * dh + d]; },
            [&](int t, int d) { return vt[t * dh + d]; });
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + kPrefillWarps * k;
    if (r >= block_q || row0 + r >= c) continue;
    const float inv = r < nrows ? 1.f / fmaxf(l[k], 1e-30f) : 0.f;
    T* orow = out + (size_t)(row0 + r) * tok + (size_t)h * dh;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) orow[d] = from_float<T>(r < nrows ? acc[k][i] * inv : 0.f);
    }
  }
}

// Launches the prefill kernel on `stream` for q/out of type T and pools of
// type P (k_scale/v_scale null unless P is int8); returns the launch's
// cudaGetLastError() (or the error of raising the block's dynamic
// shared-memory limit).
template <typename T, typename P>
int launch_paged_prefill(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scale,
                         const void* v_scale, const int* page_table,
                         void* out, int* visits, int c, int nh, int dh,
                         int ps, int maxp, const int* start,
                         const int* valid, int block_q, cudaStream_t stream) {
  const dim3 grid((c + block_q - 1) / block_q, nh);
  const dim3 block(kPrefillWarps * 32);
  const size_t smem = 2 * (size_t)ps * dh * sizeof(float);
  const float scale = (float)(1.0 / std::sqrt((double)dh));
  const T* qp = static_cast<const T*>(q);
  const P* kp = static_cast<const P*>(k_pages);
  const P* vp = static_cast<const P*>(v_pages);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  T* op = static_cast<T*>(out);
#define PTT_PREFILL(DPL)                                                     \
  do {                                                                       \
    auto kern = paged_prefill_kernel<T, P, DPL>;                             \
    if (smem > 48 * 1024) {                                                  \
      cudaError_t err = cudaFuncSetAttribute(                                \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);     \
      if (err != cudaSuccess) return (int)err;                               \
    }                                                                        \
    kern<<<grid, block, smem, stream>>>(qp, kp, vp, ks, vs, page_table, op,  \
                                        visits, c, nh, dh, ps, maxp, start,  \
                                        valid, block_q, scale);              \
  } while (0)
  if (dh <= 32) PTT_PREFILL(1);
  else if (dh <= 64) PTT_PREFILL(2);
  else if (dh <= 128) PTT_PREFILL(4);
  else PTT_PREFILL(8);
#undef PTT_PREFILL
  return (int)cudaGetLastError();
}

constexpr int kCoreBlockQ = kPrefillWarps * kRowsPerWarp;

// Checks the C entry points' shape arguments; `max_block_q` is the query
// tile of the loop the call takes (kCoreBlockQ, or kMmaBlockQ). `start` and
// `valid` are device values, never read on the host: the kernels clamp
// them (`load_chunk_bounds`); here they must only be pointers.
inline bool prefill_args_ok(int c, int nh, int dh, int ps, int maxp,
                            const int* start, const int* valid, int block_q,
                            int max_block_q) {
  return c > 0 && nh > 0 && dh > 0 && dh <= 256 && ps > 0 && maxp > 0 &&
         (long long)maxp * ps <= 0x7fffffff - c && start != nullptr &&
         valid != nullptr && block_q > 0 && block_q <= max_block_q;
}

}  // namespace paddle_tpu_torch
