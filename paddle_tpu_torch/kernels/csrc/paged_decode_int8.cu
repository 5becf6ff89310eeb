// Ragged paged-attention DECODE kernel for Hopper (sm_90a), int8 pools.
//
// Replaces: paddle_tpu/kernels/pallas/paged_attention.py::_decode_kernel
// (entry `paged_attention`) with quant=True: int8 K/V pages with f32 scale
// pools [num_pages, page_size, nh], one scale per token slot and head.
// Scores, mask and online softmax in f32, as the float kernel's.
//
// Bound on the H100: memory. Per (b, h) and visible key the kernel must
// read 2 * dh int8 bytes and 2 * 4 scale bytes, about a quarter of the
// float32 bytes at dh = 64; the least time is the live pages' bytes over
// 3.35 TB/s.
//
// Two loops, picked by a fixed rule before the launch (`split_takes`, the
// wrapper's `arm`): a head dim that is a multiple of 16 up to 256 takes the
// loop split across blocks of paged_decode_split.cuh ("split"), whose
// header gives its design: 16-byte key loads, the K scale after the
// product, the V scale folded into p, the splits merged in the same
// launch. Other head dims keep the one-block-per-(b, h) loop of
// paged_decode.cuh ("per_head"), which widens each value and multiplies it
// by its slot's scale before the product (`pool_value` in
// attention_common.cuh) and reads a byte per lane per element.

#include "paged_decode.cuh"
#include "paged_decode_split.cuh"

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// paged_attention.py. Every tensor is contiguous: q and out [batch, nh, dh]
// (f32 or bf16, `dtype`), pools [num_pages, ps, nh, dh] int8, scales
// [num_pages, ps, nh] f32, page_table [batch, maxp] int32, positions
// [batch] int32, visits [batch, nh] int32 or null. The split loop also
// takes `splits`, the partials [batch * nh * splits * (dh + 2)] f32 and
// the tickets [batch * nh] u32 (zero before the first launch; every launch
// leaves them zero), both may be null when splits is 1, and pools on
// 16-byte boundaries. Launches on `stream` without synchronising; returns
// the launch's cudaGetLastError().
extern "C" int paged_decode_int8(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, const void* page_table,
                                 const void* positions, void* out,
                                 void* visits, void* partials, void* tickets,
                                 int batch, int nh, int dh, int ps, int maxp,
                                 int splits, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (!decode_args_ok(batch, nh, dh, ps, maxp))
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* pos = static_cast<const int*>(positions);
  int* vis = static_cast<int*>(visits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (decode_split::split_takes(dh)) {
    if (((reinterpret_cast<size_t>(k_pages) |
          reinterpret_cast<size_t>(v_pages)) & 15) != 0)
      return (int)cudaErrorInvalidValue;
    float* part = static_cast<float*>(partials);
    unsigned* tick = static_cast<unsigned*>(tickets);
    if (dtype == kFloat32)
      return launch_paged_decode_split<float, signed char>(
          q, k_pages, v_pages, k_scale, v_scale, pt, pos, out, vis, part,
          tick, batch, nh, dh, ps, maxp, splits, s);
    if (dtype == kBFloat16)
      return launch_paged_decode_split<__nv_bfloat16, signed char>(
          q, k_pages, v_pages, k_scale, v_scale, pt, pos, out, vis, part,
          tick, batch, nh, dh, ps, maxp, splits, s);
    return (int)cudaErrorInvalidValue;
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_paged_decode<float, signed char>(
        q, k_pages, v_pages, k_scale, v_scale, pt, pos, out, vis, batch, nh,
        dh, ps, maxp, s);
  if (dtype == kBFloat16)
    return launch_paged_decode<__nv_bfloat16, signed char>(
        q, k_pages, v_pages, k_scale, v_scale, pt, pos, out, vis, batch, nh,
        dh, ps, maxp, s);
  return (int)cudaErrorInvalidValue;
}
