// The ragged paged-attention DECODE loop for Hopper (sm_90a), shared by the
// float kernel (paged_decode.cu) and the int8 kernel (paged_decode_int8.cu).
// They differ only in the pool element type P and so in how a key or value
// is read (`pool_value` in attention_common.cuh): a float pool converts, an
// int8 pool widens and scales by its token slot's f32 scale.
//
// One decode token per (sequence b, head h) attends over that sequence's
// K/V pages, looked up through its row of the page table; the pools are
// [num_pages, page_size, nh, dh].
//
// Bound on the H100: memory. A (b, h) pair reads its live pages' K and V
// slices once (2 * pages * page_size * dh * itemsize bytes, plus 2 * 4
// scale bytes per key for int8 pools) and does about 4 * dh operations per
// key: the least time is the live bytes over 3.35 TB/s.
//
// What the design does about it: the page loop stops at
// min(ceil((pos + 1) / page_size), pages_per_slot), so traffic follows each
// sequence's true length, never the slot's capacity. A warp reads one key's
// dh contiguous values with its 32 lanes (coalesced), and the four warps of
// the block walk interleaved pages with their own online softmax, merged
// once at the end, so four page streams are in flight per (b, h). One
// block per (b, h) is 96 blocks for GPT-2 small at B=8, which does not
// fill 132 SMs: both kernels take the loop split across blocks
// (paged_decode_split.cuh) for head dims that are a multiple of 16 up to
// 256, and this loop for the others.
//
// The pages_per_slot clamp is a guard the Pallas kernel does not have: a
// slot whose position sits at or past its capacity (an occupied slot that
// is no longer dispatched, or a trash-only row at pos = pages_per_slot *
// page_size) would otherwise read past its page-table row.
#pragma once

#include <cmath>

#include "attention_common.cuh"

namespace paddle_tpu_torch {

constexpr int kDecodeWarps = 4;

template <typename T, typename P, int DPL>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                    const P* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ positions, T* __restrict__ out,
                    int* __restrict__ visits, int nh, int dh, int ps,
                    int maxp, float scale) {
  extern __shared__ float smem[];   // [kDecodeWarps * dh] partial accumulators
  __shared__ float sm_m[kDecodeWarps], sm_l[kDecodeWarps];

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = positions[b];
  const int npages = min((pos + ps) / ps, maxp);
  if (visits != nullptr && threadIdx.x == 0) visits[b * nh + h] = npages;

  const T* qrow = q + ((size_t)b * nh + h) * dh;
  float qv[DPL], acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < dh ? to_float(qrow[d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const size_t tok = (size_t)nh * dh;   // stride between tokens of a page
  const int* row = page_table + (size_t)b * maxp;
  for (int j = warp; j < npages; j += kDecodeWarps) {
    const int visible = min(ps, pos - j * ps + 1);   // keys <= pos here
    for (int t0 = 0; t0 < visible; t0 += 32) {
      // token slot of key t0 of this page and head, and its element at d=0
      const size_t slot0 = ((size_t)row[j] * ps + t0) * nh + h;
      const size_t base = slot0 * dh;
      fold_tile<DPL>(
          qv, acc, m, l, min(32, visible - t0), dh,
          [&](int t, int d) {
            return pool_value(k_pages, k_scale, base + t * tok + d,
                              slot0 + (size_t)t * nh);
          },
          [&](int t, int d) {
            return pool_value(v_pages, v_scale, base + t * tok + d,
                              slot0 + (size_t)t * nh);
          });
    }
  }

  // merge the warps' partial softmax states
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) smem[warp * dh + d] = acc[i];
  }
  __syncthreads();
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float denom = 0.f;
  float wgt[kDecodeWarps];
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) {
    wgt[w] = expf(sm_m[w] - mx);
    denom += sm_l[w] * wgt[w];
  }
  denom = fmaxf(denom, 1e-30f);
  T* orow = out + ((size_t)b * nh + h) * dh;
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) a += smem[w * dh + d] * wgt[w];
    orow[d] = from_float<T>(a / denom);
  }
}

// Launches the decode kernel on `stream` for q/out of type T and pools of
// type P (k_scale/v_scale null unless P is int8); returns the launch's
// cudaGetLastError().
template <typename T, typename P>
int launch_paged_decode(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scale,
                        const void* v_scale, const int* page_table,
                        const int* positions, void* out, int* visits,
                        int batch, int nh, int dh, int ps, int maxp,
                        cudaStream_t stream) {
  const dim3 grid(batch, nh);
  const dim3 block(kDecodeWarps * 32);
  const size_t smem = (size_t)kDecodeWarps * dh * sizeof(float);
  const float scale = (float)(1.0 / std::sqrt((double)dh));
  const T* qp = static_cast<const T*>(q);
  const P* kp = static_cast<const P*>(k_pages);
  const P* vp = static_cast<const P*>(v_pages);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  T* op = static_cast<T*>(out);
#define PTT_DECODE(DPL)                                                   \
  paged_decode_kernel<T, P, DPL><<<grid, block, smem, stream>>>(          \
      qp, kp, vp, ks, vs, page_table, positions, op, visits, nh, dh, ps,  \
      maxp, scale)
  if (dh <= 32) PTT_DECODE(1);
  else if (dh <= 64) PTT_DECODE(2);
  else if (dh <= 128) PTT_DECODE(4);
  else PTT_DECODE(8);
#undef PTT_DECODE
  return (int)cudaGetLastError();
}

// Checks the C entry points' scalar arguments.
inline bool decode_args_ok(int batch, int nh, int dh, int ps, int maxp) {
  return batch > 0 && nh > 0 && dh > 0 && dh <= 256 && ps > 0 && maxp > 0;
}

}  // namespace paddle_tpu_torch
