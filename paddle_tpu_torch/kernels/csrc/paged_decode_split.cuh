// The ragged paged-attention DECODE loop split across blocks (flash
// decoding), for float and int8 pools: paged_decode.cu (float32 or bfloat16
// pools of q's dtype) and paged_decode_int8.cu (int8 pools with f32
// scales) launch it when the head dim is a multiple of 16 up to 256, and
// keep the one-block-per-(b, h) loop of paged_decode.cuh for the other
// head dims. The pool element type P is a template argument: each type has
// its own key and value readers (`load_key`, `Value4`), and only int8
// pools read the k_scale / v_scale of a key (a compile-time flag, no branch
// per key).
//
// Replaces: paddle_tpu/kernels/pallas/paged_attention.py::_decode_kernel,
// its float arm and its quant=True arm, as paged_decode.cu's and
// paged_decode_int8.cu's headers say.
//
// Bound on the H100: memory, the live pages' K and V bytes (and the int8
// pools' f32 scales) over 3.35 TB/s: at GPT-2 small's B=8 serve shape
// about 7.5 MB in bf16 (~2.2 us) and 4 MB in int8 (~1.2 us). One block per
// (b, h) walked each row's keys in one serial chain (96 blocks on 132 SMs
// at B=8, 12 at B=1), a warp reduction per key: a latency chain 70-160x
// its bound.
//
// Design:
// - Grid (b*nh, splits). Split s of a row walks the contiguous page range
//   [s * pps, (s + 1) * pps), pps = ceil(pages_per_slot / splits), cut at
//   the row's length-aware stop (min(ceil((pos + 1) / page_size),
//   pages_per_slot)). The split count comes from shapes only (the wrapper's
//   `splits`: B, nh, pages_per_slot and the SM count), never from pos,
//   which lies on the card. A split wholly past its row's last page writes
//   an empty partial (m = -inf, l = 0) and reads no K or V.
// - Inside a split, each of kWarps warps takes groups of 32 consecutive
//   keys in turn. For the scores a lane owns one key: it reads that key's
//   dh values as 16-byte loads (16 int8, 8 bf16 or 4 f32 values a load)
//   and forms q . k in f32 against q in shared memory, then s = (q . k) *
//   scale, times the key's k_scale for int8 pools, after the product. One
//   warp max per 32 keys, and the row sum as per-lane shares added once at
//   the end.
// - For P V a lane owns 4 dims (4 bytes of an int8 V row, 8 of a bf16 one,
//   16 of an f32 one): LPK lanes cover one key's row (dh / 4 rounded up to
//   a power of two, at most 32), so a warp takes 32 / LPK keys a pass, with
//   p already times the key's V scale for int8 pools. The V values of a
//   group's passes are loaded beside its keys while they fit in 64
//   registers a lane (every int8 head dim, bf16 up to 128, f32 up to 64);
//   wider rows load each pass's values in the pass.
// - One launch, merge included: each split's (m, l, acc[dh]) goes to a
//   workspace; the last block of a (b, h) to finish (a __threadfence, then
//   atomicInc on its ticket, which wraps back to 0 at splits - 1 and so is
//   ready for the next launch) reads the partials from L2 and writes out.
//   With one split the block writes out directly. The wrapper allocates
//   the tickets zeroed once per device, (b, h) count and stream, shared by
//   the float and int8 kernels; the partials are torch.empty. No memset,
//   no second launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "attention_common.cuh"

namespace paddle_tpu_torch {
namespace decode_split {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 64;   // the wrapper's MAX_SPLITS
constexpr int kMaxDh = 256;

// The rule that picks this loop: 16-byte key loads tile the head dim.
inline bool split_takes(int dh) { return dh > 0 && dh % 16 == 0 && dh <= kMaxDh; }

__device__ __forceinline__ float sbyte(unsigned w, int j) {
  return (float)(signed char)(w >> (8 * j));
}

// bf16 value j (0 low, 1 high) of a 32-bit word, widened exactly.
__device__ __forceinline__ float bhalf(unsigned w, int j) {
  return __uint_as_float(j == 0 ? w << 16 : w & 0xffff0000u);
}

__device__ __forceinline__ float dot4(unsigned w, float4 q) {
  return q.x * sbyte(w, 0) + q.y * sbyte(w, 1) + q.z * sbyte(w, 2) +
         q.w * sbyte(w, 3);
}

__device__ __forceinline__ float dot4(unsigned w0, unsigned w1, float4 q) {
  return q.x * bhalf(w0, 0) + q.y * bhalf(w0, 1) + q.z * bhalf(w1, 0) +
         q.w * bhalf(w1, 1);
}

__device__ __forceinline__ float dot4(float4 w, float4 q) {
  return q.x * w.x + q.y * w.y + q.z * w.z + q.w * w.w;
}

// q . key over dh values of a pool row `row` (q in shared memory), in f32,
// from 16-byte loads.
__device__ __forceinline__ float load_key(const signed char* __restrict__ row,
                                          const float* qs, int dh) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < dh / 16; ++c) {
    const uint4 w = __ldg(r + c);
    const float4* qv = reinterpret_cast<const float4*>(qs + 16 * c);
    s += dot4(w.x, qv[0]) + dot4(w.y, qv[1]) + dot4(w.z, qv[2]) +
         dot4(w.w, qv[3]);
  }
  return s;
}

__device__ __forceinline__ float load_key(
    const __nv_bfloat16* __restrict__ row, const float* qs, int dh) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < dh / 8; ++c) {
    const uint4 w = __ldg(r + c);
    const float4* qv = reinterpret_cast<const float4*>(qs + 8 * c);
    s += dot4(w.x, w.y, qv[0]) + dot4(w.z, w.w, qv[1]);
  }
  return s;
}

__device__ __forceinline__ float load_key(const float* __restrict__ row,
                                          const float* qs, int dh) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < dh / 4; ++c)
    s += dot4(__ldg(r + c), reinterpret_cast<const float4*>(qs)[c]);
  return s;
}

// Values 4 c .. 4 c + 3 of a pool row, and value j of them as f32.
template <typename P>
struct Value4;
template <>
struct Value4<signed char> {
  using type = unsigned;   // four bytes
  static __device__ __forceinline__ type load(const signed char* row, int c) {
    return __ldg(reinterpret_cast<const unsigned*>(row) + c);
  }
  static __device__ __forceinline__ float at(type w, int j) {
    return sbyte(w, j);
  }
};
template <>
struct Value4<__nv_bfloat16> {
  using type = uint2;      // four bf16
  static __device__ __forceinline__ type load(const __nv_bfloat16* row,
                                              int c) {
    return __ldg(reinterpret_cast<const uint2*>(row) + c);
  }
  static __device__ __forceinline__ float at(type w, int j) {
    return bhalf(j < 2 ? w.x : w.y, j & 1);
  }
};
template <>
struct Value4<float> {
  using type = float4;
  static __device__ __forceinline__ type load(const float* row, int c) {
    return __ldg(reinterpret_cast<const float4*>(row) + c);
  }
  static __device__ __forceinline__ float at(type w, int j) {
    return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
  }
};

template <typename T, typename P, int LPK, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const P* __restrict__ k_pages,
                          const P* __restrict__ v_pages,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ page_table,
                          const int* __restrict__ positions,
                          T* __restrict__ out, int* __restrict__ visits,
                          float* __restrict__ partials,
                          unsigned* __restrict__ tickets, int nh, int dh,
                          int ps, int maxp, int pps, float scale) {
  using V4 = Value4<P>;
  using W = typename V4::type;
  constexpr bool kScaled = std::is_same_v<P, signed char>;   // int8 pools
  constexpr int KPP = 32 / LPK;   // keys of a P V pass
  // a group's V values loaded beside its keys: up to 64 registers a lane
  constexpr bool kEarlyV = LPK * DPL * sizeof(W) <= 64 * 4;
  __shared__ __align__(16) float qs[kMaxDh];
  __shared__ __align__(16) float sm_acc[kWarps][kMaxDh];
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_w[kMaxSplits], sm_ls[kMaxSplits];
  __shared__ bool sm_last;

  const int bh = blockIdx.x, b = bh / nh, h = bh - b * nh;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = positions[b];
  const int npages = min((pos + ps) / ps, maxp);
  if (visits != nullptr && split == 0 && tid == 0) visits[bh] = npages;
  const int nkeys = min(pos + 1, maxp * ps);   // keys 0..pos, in the slot
  const int kb = split * pps * ps;             // this split's keys [kb, ke)
  const int ke = min(kb + pps * ps, nkeys);

  const int* row = page_table + (size_t)b * maxp;
  // the page of this lane's key in the warp's first group, fetched before
  // pos is known (the index is clamped to the row; a dead key's is unused)
  int pg = __ldg(row + min((kb + warp * 32 + lane) / ps, maxp - 1));
  for (int d = tid; d < dh; d += kThreads)
    qs[d] = to_float(q[(size_t)bh * dh + d]);
  __syncthreads();

  const int sub = lane / LPK, cl = lane % LPK;   // key of a pass, dims
  float m = -INFINITY, l = 0.f;                 // l: this lane's share
  float acc[DPL][4];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int k0 = kb + warp * 32; k0 < ke; k0 += kWarps * 32) {
    const int key = k0 + lane;
    const bool live = key < ke;
    // (token slot * nh + h) of this lane's key; slot 0's for a dead key
    const int slot = live ? (pg * ps + key % ps) * nh + h : h;
    pg = __ldg(row + min((k0 + kWarps * 32 + lane) / ps, maxp - 1));
    // this lane's 4 values of V row `st` (zeros past dh)
    auto value4 = [&](int st, int c) {
      const int d4 = cl + c * LPK;
      return 4 * d4 < dh ? V4::load(v_pages + (size_t)st * dh, d4) : W{};
    };
    W vw[kEarlyV ? LPK : 1][DPL];
    if constexpr (kEarlyV) {   // the V values of this lane's passes
#pragma unroll
      for (int i = 0; i < LPK; ++i) {
        const int st = __shfl_sync(kFullMask, slot, i * KPP + sub);
#pragma unroll
        for (int c = 0; c < DPL; ++c) vw[i][c] = value4(st, c);
      }
    }
    float s = -INFINITY, vsc = 0.f;
    if (live) {
      if constexpr (kScaled) {
        s = load_key(k_pages + (size_t)slot * dh, qs, dh) *
            (__ldg(k_scale + slot) * scale);
        vsc = __ldg(v_scale + slot);
      } else {
        s = load_key(k_pages + (size_t)slot * dh, qs, dh) * scale;
      }
    }
    const float m_new = fmaxf(m, warp_max(s));   // the group has a live key
    const float alpha = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.f;
    l = l * alpha + p;
    m = m_new;
    const float pv = kScaled ? p * vsc : p;   // 0 for a dead key
#pragma unroll
    for (int c = 0; c < DPL; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] *= alpha;
#pragma unroll
    for (int i = 0; i < LPK; ++i) {   // 32 / KPP passes
      const int src = i * KPP + sub;
      const float pt = __shfl_sync(kFullMask, pv, src);
      W w[DPL];
      if constexpr (kEarlyV) {
#pragma unroll
        for (int c = 0; c < DPL; ++c) w[c] = vw[i][c];
      } else {
        const int st = __shfl_sync(kFullMask, slot, src);
#pragma unroll
        for (int c = 0; c < DPL; ++c) w[c] = value4(st, c);
      }
#pragma unroll
      for (int c = 0; c < DPL; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] += pt * V4::at(w[c], j);
    }
  }

  // the warp's state: l over its lanes, acc over the KPP keys of a pass
  l = warp_sum(l);
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int c = 0; c < DPL; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[c][j] += __shfl_xor_sync(kFullMask, acc[c][j], o);
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (sub == 0) {
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d4 = cl + c * LPK;
      if (4 * d4 < dh)
        *reinterpret_cast<float4*>(&sm_acc[warp][4 * d4]) =
            make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    }
  }
  __syncthreads();
  // the split's state: the warps merged (a warp that took no group has
  // m = -inf and weighs 0)
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wgt[kWarps], ls = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - mx);
    ls += sm_l[w] * wgt[w];
  }
  T* orow = out + (size_t)bh * dh;
  if (splits == 1) {
    const float inv = 1.f / fmaxf(ls, 1e-30f);
    for (int d = tid; d < dh; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * wgt[w];
      orow[d] = from_float<T>(a * inv);
    }
    return;
  }

  // partials [b*nh][splits][dh + 2]: acc, then m and l
  float* part = partials + ((size_t)bh * splits + split) * (dh + 2);
  for (int d = tid; d < dh; d += kThreads) {
    float a = 0.f;   // 0 for an empty split: every warp weighs 0
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * wgt[w];
    part[d] = a;
  }
  if (tid == 0) {
    part[dh] = mx;   // -inf for an empty split
    part[dh + 1] = ls;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    sm_last = atomicInc(tickets + bh, (unsigned)(splits - 1)) ==
              (unsigned)(splits - 1);
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  // the last block of (b, h): merge every split's partial, read from L2
  const float* pb = partials + (size_t)bh * splits * (dh + 2);
  if (tid < splits) {
    sm_w[tid] = __ldcg(pb + (size_t)tid * (dh + 2) + dh);
    sm_ls[tid] = __ldcg(pb + (size_t)tid * (dh + 2) + dh + 1);
  }
  __syncthreads();
  if (warp == 0) {
    float gm = -INFINITY;
    for (int s = lane; s < splits; s += 32) gm = fmaxf(gm, sm_w[s]);
    gm = warp_max(gm);   // finite: split 0 holds key 0
    float gl = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float w = sm_w[s] == -INFINITY ? 0.f : expf(sm_w[s] - gm);
      sm_w[s] = w;
      gl += w * sm_ls[s];
    }
    gl = warp_sum(gl);
    if (lane == 0) sm_l[0] = gl;
  }
  __syncthreads();
  const float inv = 1.f / fmaxf(sm_l[0], 1e-30f);
  for (int d = tid; d < dh; d += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      a += sm_w[s] * __ldcg(pb + (size_t)s * (dh + 2) + d);
    orow[d] = from_float<T>(a * inv);
  }
}

}  // namespace decode_split

// Launches the split decode loop on `stream` for q/out of type T over
// pools of element type P: float or __nv_bfloat16 (q's type, no scales) or
// signed char with its f32 k_scale / v_scale. `partials`
// ([b*nh*splits*(dh+2)] f32) and `tickets` ([b*nh] u32, zero before the
// first launch and left zero by every launch) may be null only for
// splits == 1. The caller has checked split_takes(dh) and 16-byte aligned
// pools. Returns the launch's cudaGetLastError().
template <typename T, typename P>
int launch_paged_decode_split(const void* q, const void* k_pages,
                              const void* v_pages, const void* k_scale,
                              const void* v_scale, const int* page_table,
                              const int* positions, void* out, int* visits,
                              float* partials, unsigned* tickets, int batch,
                              int nh, int dh, int ps, int maxp, int splits,
                              cudaStream_t stream) {
  using namespace decode_split;
  if (splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (partials == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int pps = (maxp + splits - 1) / splits;
  const dim3 grid(batch * nh, splits);
  const float scale = (float)(1.0 / std::sqrt((double)dh));
  const T* qp = static_cast<const T*>(q);
  const P* kp = static_cast<const P*>(k_pages);
  const P* vp = static_cast<const P*>(v_pages);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  T* op = static_cast<T*>(out);
#define PTT_SPLIT(LPK, DPL)                                                 \
  paged_decode_split_kernel<T, P, LPK, DPL><<<grid, kThreads, 0, stream>>>( \
      qp, kp, vp, ks, vs, page_table, positions, op, visits, partials,      \
      tickets, nh, dh, ps, maxp, pps, scale)
  const int nch = dh / 4;   // 4-value chunks of a V row
  if (nch <= 4) PTT_SPLIT(4, 1);
  else if (nch <= 8) PTT_SPLIT(8, 1);
  else if (nch <= 16) PTT_SPLIT(16, 1);
  else if (nch <= 32) PTT_SPLIT(32, 1);
  else PTT_SPLIT(32, 2);
#undef PTT_SPLIT
  return (int)cudaGetLastError();
}

}  // namespace paddle_tpu_torch
