// Device helpers shared by the three flash-attention kernels
// (flash_fwd.cu, flash_dq.cu, flash_dkv.cu): the thread grid, tile staging
// into shared memory, and the register-tiled product of two staged tiles.
//
// Layout: every tensor is [B*H, S, D], contiguous. A block has 256 threads
// seen as a 16 x 16 grid: tx = lane & 15 walks columns, ty = threadIdx.x >> 4
// walks rows, so the 16 threads sharing a ty form one half-warp and a
// reduction over a row's columns is a shuffle over offsets 8, 4, 2, 1.
// Thread (ty, tx) owns rows ty * RM + i (i < RM) and columns tx + 16 * j
// (j < CN) of a tile. Staged rows have a stride of D + 1 floats: a row walk
// (fixed d, rows tx + 16 j) and a column walk (fixed row, d = tx + 16 j)
// both hit 16 distinct banks.
#pragma once

#include "attention_common.cuh"

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

// Key tiles per block: 64 for head dims up to 128, 32 above (shared memory).
template <int DC>
struct KeyTile {
  static constexpr int value = DC <= 8 ? 64 : 32;
};

// Rows [row0, row0 + rows) of a [n, d] matrix into dst (row stride ld) as
// f32, times `scale`; rows at or past n are written as 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int row0, int rows, int n, int d,
                                      float scale) {
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    const int g = row0 + r;
    dst[r * ld + c] = g < n ? to_float(src[(size_t)g * d + c]) * scale : 0.f;
  }
}

// acc[i][j] = sum_{kk < d} a[(ty * RM + i) * ld + kk] * b[(tx + 16 j) * ld + kk]
template <int RM, int CN>
__device__ __forceinline__ void tile_dot(float (&acc)[RM][CN], const float* a,
                                         const float* b, int ld, int d) {
  const int tx = tile_tx(), ty = tile_ty();
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < d; ++kk) {
    float av[RM], bv[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[(ty * RM + i) * ld + kk];
#pragma unroll
    for (int j = 0; j < CN; ++j) bv[j] = b[(tx + 16 * j) * ld + kk];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// acc[i][c] += sum_{kk < n} w[(ty * RM + i) * ldw + kk] * x[kk * ld + tx + 16 c]
// for the columns tx + 16 c < d: a [RM rows] x [n] weight tile of shared
// memory times a staged [n, d] tile.
template <int RM, int DC>
__device__ __forceinline__ void tile_accumulate(float (&acc)[RM][DC],
                                                const float* w, int ldw,
                                                const float* x, int ld, int n,
                                                int d) {
  const int tx = tile_tx(), ty = tile_ty();
#pragma unroll 4
  for (int kk = 0; kk < n; ++kk) {
    float wv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) wv[i] = w[(ty * RM + i) * ldw + kk];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      const float xv = col < d ? x[kk * ld + col] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][c] += wv[i] * xv;
    }
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
