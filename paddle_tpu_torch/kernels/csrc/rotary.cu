// Fused rotary position embedding kernel for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/rotary.py::_rope_kernel (entry
// `apply_rotary_emb`). q and k [B, H, S, D] are rotated in one pass with
// the GPT-NeoX half split: for position s and pair j < D/2, with x1 =
// x[j], x2 = x[D/2 + j], c = cos[s, j], sn = sin[s, j]:
//   out[j] = x1 * c - x2 * sn,   out[D/2 + j] = x2 * c + x1 * sn,
// in f32, stored in q's dtype. Each product and the sum are rounded
// separately (no fused multiply-add), as the plain PyTorch version rounds
// them, so the two agree bit for bit in f32.
//
// Bound on the H100: bytes. Six operations per pair against 8-16 bytes of
// q and k read and written per pair, far below ~295 operations a byte; the
// least time is q and k read and written once and the cos/sin tables read
// once, over 3.35 TB/s.
//
// What the design does about it: one thread per (row, 4 pairs), where a
// row is one (b, h, s) of q and k; it reads the 4 cos and 4 sin values once
// and applies them to q and to k, so the tables are read once per row pair
// rather than per tensor. Loads and stores are 4 elements wide (16 bytes in
// f32, 8 in bf16) where D/2 is a multiple of 4 and the pointers are 16-byte
// aligned; neighbouring threads take neighbouring pairs, so every access
// coalesces. The tables ([S, D/2], 256 KB at S=1024, D=64 in f32) are
// reread by every (b, h) and stay in L2.

#include "rowwise_common.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace rowwise;

template <typename T, typename C, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const C* __restrict__ cs, const C* __restrict__ sn,
            T* __restrict__ qo, T* __restrict__ ko, long long rows, int s,
            int half) {
  const int per_row = half / VEC;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * per_row) return;
  const long long row = i / per_row;
  const int j = (int)(i - row * per_row) * VEC;
  const int pos = (int)(row % s);
  float c[VEC], si[VEC];
  load_f32<C, VEC>(c, cs + (size_t)pos * half + j);
  load_f32<C, VEC>(si, sn + (size_t)pos * half + j);
  const size_t base = (size_t)row * 2 * half + j;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const T* src = t == 0 ? q : k;
    T* dst = t == 0 ? qo : ko;
    float x1[VEC], x2[VEC], o1[VEC], o2[VEC];
    load_f32<T, VEC>(x1, src + base);
    load_f32<T, VEC>(x2, src + base + half);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      o1[e] = __fsub_rn(__fmul_rn(x1[e], c[e]), __fmul_rn(x2[e], si[e]));
      o2[e] = __fadd_rn(__fmul_rn(x2[e], c[e]), __fmul_rn(x1[e], si[e]));
    }
    store_f32<T, VEC>(dst + base, o1);
    store_f32<T, VEC>(dst + base + half, o2);
  }
}

template <typename T, typename C, int VEC>
int launch(const void* q, const void* k, const void* cs, const void* sn,
           void* qo, void* ko, long long rows, int s, int half,
           cudaStream_t st) {
  const long long total = rows * (half / VEC);
  const long long blocks = (total + kMaxThreads - 1) / kMaxThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rope_kernel<T, C, VEC><<<(unsigned)blocks, kMaxThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const C*>(cs), static_cast<const C*>(sn),
      static_cast<T*>(qo), static_cast<T*>(ko), rows, s, half);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int by_width(const void* q, const void* k, const void* cs, const void* sn,
             void* qo, void* ko, long long rows, int s, int half,
             cudaStream_t st) {
  if (half % 4 == 0 && aligned16({q, k, cs, sn, qo, ko}))
    return launch<T, C, 4>(q, k, cs, sn, qo, ko, rows, s, half, st);
  return launch<T, C, 1>(q, k, cs, sn, qo, ko, rows, s, half, st);
}

}  // namespace
}  // namespace paddle_tpu_torch

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// rotary.py. q, k, q_out and k_out [rows = B * H * S, d] contiguous, of
// dtype `dtype` (0 float32, 1 bfloat16); cos and sin [s, d / 2] contiguous,
// of dtype `cdtype` (float32 or `dtype`); row r is at position r % s. d even.
// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError().
extern "C" int rotary(const void* q, const void* k, const void* cos,
                      const void* sin, void* q_out, void* k_out,
                      long long rows, int s, int d, int dtype, int cdtype,
                      void* stream) {
  using namespace paddle_tpu_torch;
  if (rows <= 0 || s <= 0 || rows % s != 0 || d <= 0 || d % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int half = d / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && cdtype == kFloat32)
    return by_width<float, float>(q, k, cos, sin, q_out, k_out, rows, s,
                                  half, st);
  if (dtype == kBFloat16 && cdtype == kFloat32)
    return by_width<__nv_bfloat16, float>(q, k, cos, sin, q_out, k_out, rows,
                                          s, half, st);
  if (dtype == kBFloat16 && cdtype == kBFloat16)
    return by_width<__nv_bfloat16, __nv_bfloat16>(q, k, cos, sin, q_out,
                                                  k_out, rows, s, half, st);
  return (int)cudaErrorInvalidValue;
}
