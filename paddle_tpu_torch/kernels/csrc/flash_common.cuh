// Device helpers shared by the three flash-attention kernels
// (flash_fwd.cu, flash_dq.cu, flash_dkv.cu): the thread grid, tile staging
// into shared memory, and the register-tiled products of two staged tiles.
//
// Layout: every tensor is [B*H, S, D], contiguous. A block has 256 threads
// seen as a 16 x 16 grid: tx = lane & 15 walks columns, ty = threadIdx.x >> 4
// walks rows, so the 16 threads sharing a ty form one half-warp and a
// reduction over a row's columns is a shuffle over offsets 8, 4, 2, 1.
//
// The register-tiled f32 loops (the design of the paged prefill's
// CUDA-core loop, paged_prefill.cuh): `tile_ld`, `copy_granule`,
// `load_rows`, `zero_pad`, `tile_nt`, `tile_nt2`, `tile_nn`, `tile_nn2`,
// `tile_nt_nn`. f32 tile rows are padded to a stride of 4 mod 8 floats, so
// the 8 rows a quarter warp reads with one float4 each fall in distinct
// banks. Thread (ty, tx) owns rows ty + 16 i and keys (or columns, or
// float4 column chunks) tx + 16 j, and forms 4 x 4 register tiles with
// exact f32 FMAs (`fmaf`) from float4 reads: 64 FMAs per 8 reads. Rows come
// in by cp.async of contiguous rows, 16, 8 or 4 bytes a copy as the row
// bytes and the pointers' alignment allow, so that a tensor 4 bytes off a
// 16-byte boundary or a head dim of 33 is taken too; bfloat16 rows are
// widened into the same f32 tiles by plain loads.
#pragma once

#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace paddle_tpu_torch {
namespace flash {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;   // query rows per block (fwd, dq) or per tile (dkv)

__device__ __forceinline__ int tile_tx() { return threadIdx.x & 15; }
__device__ __forceinline__ int tile_ty() { return threadIdx.x >> 4; }

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory a block may take: the H100's 227 KB opt-in limit
// less room for the kernels' static arrays (the wrapper's MAX_SMEM).
constexpr int kMaxSmem = 232448 - 1024;

// Floats of an f32 tile row: d rounded up to 8, plus 4.
__host__ __device__ inline int tile_ld(int d) { return (d + 7) / 8 * 8 + 4; }

// The widest cp.async copy (16, 8 or 4 bytes) that divides a row of
// `row_bytes` and the alignment of both pointers (b may repeat a); float
// rows always allow 4.
inline int copy_granule(int row_bytes, const void* a, const void* b) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b) | (uintptr_t)row_bytes;
  for (int g = 16; g > 4; g >>= 1)
    if ((x & (uintptr_t)(g - 1)) == 0) return g;
  return 4;
}

__device__ __forceinline__ void cp_async8(unsigned dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

// Rows [row0, row0 + ROWS) of a [n, d] row-major matrix `src` into the f32
// tile `dst` (rows of `ld` floats), rows at or past n as zeros; columns at
// or past d are not written (`zero_pad` clears them once). float rows go by
// cp.async, `gran` bytes a copy, kThreads / ROWS threads a row, each row's
// first chunks by neighbouring threads (the caller commits the group);
// bfloat16 rows are widened by plain loads.
template <int ROWS, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src, int row0,
                                          int n, int d, int gran) {
  constexpr int kTpr = kThreads / ROWS;
  static_assert(kTpr * ROWS == kThreads, "ROWS must divide kThreads");
  const int t = threadIdx.x / kTpr, sub = threadIdx.x % kTpr;
  const int g = row0 + t;
  const bool live = g < n;
  const T* s = src + (size_t)(live ? g : 0) * d;
  float* r = dst + (size_t)t * ld;
  if constexpr (std::is_same_v<T, float>) {
    const unsigned a = smem_addr(r);
    if (gran == 16) {   // one branch a call, none a copy
      for (int c = 4 * sub; c < d; c += 4 * kTpr)
        cp_async16(a + 4 * c, s + c, live);
    } else if (gran == 8) {
      for (int c = 2 * sub; c < d; c += 2 * kTpr)
        cp_async8(a + 4 * c, s + c, live);
    } else {
      for (int c = sub; c < d; c += kTpr) cp_async4(a + 4 * c, s + c, live);
    }
  } else {
    for (int c = sub; c < d; c += kTpr) r[c] = live ? to_float(s[c]) : 0.f;
  }
}

// Zeros in columns [d, d rounded up to 4) of `rows` tile rows of `ld`
// floats from `dst`: the float4 reads of the products reach them, and no
// copy writes them.
__device__ __forceinline__ void zero_pad(float* dst, int ld, int rows, int d) {
  const int pad = ((d + 3) & ~3) - d;
  if (pad == 0) return;
  for (int e = threadIdx.x; e < rows * pad; e += kThreads) {
    const int r = e / pad;
    dst[(size_t)r * ld + d + e - r * pad] = 0.f;
  }
}

// acc[i][j] = sum_{c < 4 n4} a[(ty + 16 i) * ld + c] * b[(tx + 16 j) * ld + c]:
// rows of a against rows of b (A B^T), float4 reads, exact f32 FMAs.
template <int RM, int CN>
__device__ __forceinline__ void tile_nt(float (&acc)[RM][CN],
                                        const float* a, const float* b,
                                        int ld, int n4) {
  const float* ar = a + (size_t)tile_ty() * ld;
  const float* br = b + (size_t)tile_tx() * ld;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < 4 * n4; c += 4) {
    float4 x[RM], y[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      x[i] = *reinterpret_cast<const float4*>(ar + (size_t)16 * i * ld + c);
#pragma unroll
    for (int j = 0; j < CN; ++j)
      y[j] = *reinterpret_cast<const float4*>(br + (size_t)16 * j * ld + c);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// Two products A1 B1^T and A2 B2^T of the same shapes in one pass over the
// columns (flash_dkv.cu: S^T = K Q^T and dP^T = V dO^T; flash_dq.cu: S =
// Q K^T and dP = dO V^T).
template <int RM, int CN>
__device__ __forceinline__ void tile_nt2(float (&s)[RM][CN], const float* a1,
                                         const float* b1,
                                         float (&t)[RM][CN], const float* a2,
                                         const float* b2, int ld, int n4) {
  const size_t ro = (size_t)tile_ty() * ld, co = (size_t)tile_tx() * ld;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = t[i][j] = 0.f;
  // not unrolled: 32 accumulators give the step its overlap, and the
  // registers stay under the 128 of two blocks an SM
#pragma unroll 1
  for (int c = 0; c < 4 * n4; c += 4) {
    float4 x[RM], y[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      x[i] = *reinterpret_cast<const float4*>(a1 + ro + (size_t)16 * i * ld + c);
#pragma unroll
    for (int j = 0; j < CN; ++j)
      y[j] = *reinterpret_cast<const float4*>(b1 + co + (size_t)16 * j * ld + c);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
#pragma unroll
    for (int i = 0; i < RM; ++i)
      x[i] = *reinterpret_cast<const float4*>(a2 + ro + (size_t)16 * i * ld + c);
#pragma unroll
    for (int j = 0; j < CN; ++j)
      y[j] = *reinterpret_cast<const float4*>(b2 + co + (size_t)16 * j * ld + c);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        t[i][j] = fmaf(x[i].x, y[j].x, t[i][j]);
        t[i][j] = fmaf(x[i].y, y[j].y, t[i][j]);
        t[i][j] = fmaf(x[i].z, y[j].z, t[i][j]);
        t[i][j] = fmaf(x[i].w, y[j].w, t[i][j]);
      }
  }
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// One step of `tile_nn`: acc += the [rows, 4] weight columns `p` (float4
// per row) times rows k .. k + 3 of x. A thread whose column chunk lies
// past the n4 chunks of a row reads the last one instead (no branch in the
// step); the accumulators it feeds are never stored.
template <int RM, int DC>
__device__ __forceinline__ void nn_step(float (&acc)[RM][DC][4],
                                        const float4 (&p)[RM],
                                        const float* x, int ld, int k,
                                        int n4) {
  const int tx = tile_tx();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* xr = x + (size_t)(k + kk) * ld;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int ch = min(tx + 16 * c, n4 - 1);
      const float4 y = *reinterpret_cast<const float4*>(xr + 4 * ch);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float pv = comp(p[i], kk);
        acc[i][c][0] = fmaf(pv, y.x, acc[i][c][0]);
        acc[i][c][1] = fmaf(pv, y.y, acc[i][c][1]);
        acc[i][c][2] = fmaf(pv, y.z, acc[i][c][2]);
        acc[i][c][3] = fmaf(pv, y.w, acc[i][c][3]);
      }
    }
  }
}

// acc[i][c][e] += sum_{k < n} w[(ty + 16 i) * ldw + k] * x[k * ld + 4 (tx +
// 16 c) + e] for the float4 column chunks tx + 16 c < n4 (n a multiple of
// 4): a [rows, n] weight tile times an [n, 4 n4] tile (P V, P^T dO, dS^T Q,
// dS K).
template <int RM, int DC>
__device__ __forceinline__ void tile_nn(float (&acc)[RM][DC][4],
                                        const float* w, int ldw,
                                        const float* x, int ld, int n,
                                        int n4) {
  const float* wr = w + (size_t)tile_ty() * ldw;
#pragma unroll 2
  for (int k = 0; k < n; k += 4) {
    float4 p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      p[i] = *reinterpret_cast<const float4*>(wr + (size_t)16 * i * ldw + k);
    nn_step<RM, DC>(acc, p, x, ld, k, n4);
  }
}

// Two `tile_nn` products over the same rows of x's k index in one pass
// (flash_dkv.cu: dV += P^T dO and dK += dS^T Q), their accumulators
// interleaved.
template <int RM, int DC>
__device__ __forceinline__ void tile_nn2(float (&acc1)[RM][DC][4],
                                         const float* w1, const float* x1,
                                         float (&acc2)[RM][DC][4],
                                         const float* w2, const float* x2,
                                         int ldw, int ld, int n, int n4) {
  const size_t ro = (size_t)tile_ty() * ldw;
#pragma unroll 2
  for (int k = 0; k < n; k += 4) {
    float4 p1[RM], p2[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      p1[i] = *reinterpret_cast<const float4*>(w1 + ro + (size_t)16 * i * ldw + k);
      p2[i] = *reinterpret_cast<const float4*>(w2 + ro + (size_t)16 * i * ldw + k);
    }
    nn_step<RM, DC>(acc1, p1, x1, ld, k, n4);
    nn_step<RM, DC>(acc2, p2, x2, ld, k, n4);
  }
}

// `tile_nt` and `tile_nn` in one pass (flash_fwd.cu: the next tile's S =
// Q K^T beside this tile's O += P V), for n4 == n / 4: step t takes
// columns 4t .. 4t + 3 of the first product and rows 4t .. 4t + 3 of x.
template <int RM, int CN, int DC>
__device__ __forceinline__ void tile_nt_nn(float (&s)[RM][CN], const float* a,
                                           const float* b, int ld,
                                           float (&acc)[RM][DC][4],
                                           const float* w, int ldw,
                                           const float* x, int n) {
  const float* ar = a + (size_t)tile_ty() * ld;
  const float* br = b + (size_t)tile_tx() * ld;
  const float* wr = w + (size_t)tile_ty() * ldw;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < n; k += 4) {
    float4 xa[RM], yb[CN], p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      xa[i] = *reinterpret_cast<const float4*>(ar + (size_t)16 * i * ld + k);
      p[i] = *reinterpret_cast<const float4*>(wr + (size_t)16 * i * ldw + k);
    }
#pragma unroll
    for (int j = 0; j < CN; ++j)
      yb[j] = *reinterpret_cast<const float4*>(br + (size_t)16 * j * ld + k);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(xa[i].x, yb[j].x, s[i][j]);
        s[i][j] = fmaf(xa[i].y, yb[j].y, s[i][j]);
        s[i][j] = fmaf(xa[i].z, yb[j].z, s[i][j]);
        s[i][j] = fmaf(xa[i].w, yb[j].w, s[i][j]);
      }
    nn_step<RM, DC>(acc, p, x, ld, k, n / 4);
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
__host__ inline cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace flash
}  // namespace paddle_tpu_torch
