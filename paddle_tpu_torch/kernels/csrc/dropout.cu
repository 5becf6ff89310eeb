// Hidden-dropout kernel of the GPT training forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/models/gpt.py::_fdropout, which the JAX package
// computes in XLA (no Pallas kernel): out = where(bernoulli(key, 1 - p,
// x.shape), x / (1 - p), 0), with jax.random's bits. For the element at
// flat index i, with the key's two words (k0, k1):
//   (h0, h1) = threefry2x32((k0, k1), (i >> 32, i & 0xffffffff))
//   u        = float((((h0 ^ h1) >> 9) | 0x3f800000) bits) - 1    in [0, 1)
//   out[i]   = u < thr ? x[i] / c : 0
// where thr = float32(1 - p) and c = 1 - p rounded to x's dtype, both
// passed by the wrapper; the division is IEEE (__fdiv_rn) in float32 and
// rounds once to x's dtype, as XLA divides. The mask is never stored: the
// gradient is this kernel again on the incoming gradient with the same key.
//
// Bound on the H100: integer operations. Each element costs threefry's 20
// rounds of add, rotate and xor plus its key injections, 72 integer
// operations, and 6 more for the counter, the bits and the select, against
// 4 (bf16) or 8 (f32) bytes read and written: the card's 64 INT32 lanes an
// SM do about 16.7e12 of them a second, far fewer than its bytes allow.
//
// What the design does about it: one pass and no more integer work than
// the hash itself. The key words are read from device memory once a
// thread (no host int, so a captured graph replays any key); the three
// key-schedule constants with their round counts are folded once a thread;
// each rotation is one funnel shift. A thread takes 16 bytes of x (4 f32
// or 8 bf16 elements) with one vector load and one vector store where x
// and out are 16-byte aligned and n a multiple of the width, else one
// element.

#include <cstdint>

#include "rowwise_common.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace rowwise;

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kOneBits = 0x3F800000u;   // 1.0f

struct Key {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define PT_ROUND(r)      \
  x0 += x1;              \
  x1 = rotl(x1, r) ^ x0;

// jax.random's 32 random bits of counter (hi, lo): the two threefry-2x32
// words xored (jax._src.prng, threefry_partitionable).
__device__ __forceinline__ uint32_t threefry_bits(const Key& k, uint32_t hi,
                                                  uint32_t lo) {
  uint32_t x0 = hi + k.k0, x1 = lo + k.k1;
  PT_ROUND(13) PT_ROUND(15) PT_ROUND(26) PT_ROUND(6)
  x0 += k.k1; x1 += k.k2 + 1u;
  PT_ROUND(17) PT_ROUND(29) PT_ROUND(16) PT_ROUND(24)
  x0 += k.k2; x1 += k.k0 + 2u;
  PT_ROUND(13) PT_ROUND(15) PT_ROUND(26) PT_ROUND(6)
  x0 += k.k0; x1 += k.k1 + 3u;
  PT_ROUND(17) PT_ROUND(29) PT_ROUND(16) PT_ROUND(24)
  x0 += k.k1; x1 += k.k2 + 4u;
  PT_ROUND(13) PT_ROUND(15) PT_ROUND(26) PT_ROUND(6)
  x0 += k.k2; x1 += k.k0 + 5u;
  return x0 ^ x1;
}

#undef PT_ROUND

__device__ __forceinline__ float drop_one(const Key& k, long long i, float v,
                                          float thr, float c) {
  const unsigned long long ui = (unsigned long long)i;
  const uint32_t bits = threefry_bits(k, (uint32_t)(ui >> 32), (uint32_t)ui);
  const float u = __fsub_rn(__uint_as_float((bits >> 9) | kOneBits), 1.0f);
  return u < thr ? __fdiv_rn(v, c) : 0.0f;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
               const long long* __restrict__ key, long long n, float thr,
               float c) {
  const long long base =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (base >= n) return;
  Key k;
  k.k0 = (uint32_t)__ldg(key);
  k.k1 = (uint32_t)__ldg(key + 1);
  k.k2 = k.k0 ^ k.k1 ^ kParity;
  float v[VEC];
  load_f32<T, VEC>(v, x + base);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = drop_one(k, base + e, v[e], thr, c);
  store_f32<T, VEC>(out + base, v);
}

template <typename T, int VEC>
int launch(const void* x, void* out, const void* key, long long n, float thr,
           float c, cudaStream_t st) {
  const long long threads = n / VEC;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dropout_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const long long*>(key), n, thr, c);
  return (int)cudaGetLastError();
}

template <typename T>
int by_width(const void* x, void* out, const void* key, long long n,
             float thr, float c, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (n % kVec == 0 && aligned16({x, out}))
    return launch<T, kVec>(x, out, key, n, thr, c, st);
  return launch<T, 1>(x, out, key, n, thr, c, st);
}

}  // namespace
}  // namespace paddle_tpu_torch

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// dropout.py. x and out [n] contiguous, of dtype `dtype` (0 float32,
// 1 bfloat16); key [2] int64 on the device, each holding one uint32 key
// word; thr = float32(1 - p), c = 1 - p rounded to `dtype`. Launches on
// `stream` without synchronising; returns the launch's cudaGetLastError().
extern "C" int hidden_dropout(const void* x, void* out, const void* key,
                              long long n, float thr, float c, int dtype,
                              void* stream) {
  using namespace paddle_tpu_torch;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return by_width<float>(x, out, key, n, thr, c, st);
  if (dtype == kBFloat16)
    return by_width<__nv_bfloat16>(x, out, key, n, thr, c, st);
  return (int)cudaErrorInvalidValue;
}
