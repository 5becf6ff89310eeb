// Ragged paged-attention DECODE kernel for Hopper (sm_90a), int8 pools.
//
// Replaces: paddle_tpu/kernels/pallas/paged_attention.py::_decode_kernel
// (entry `paged_attention`) with quant=True: int8 K/V pages with f32 scale
// pools [num_pages, page_size, nh], one scale per token slot and head.
// Each key and value is widened to f32 and multiplied by its slot's scale
// right after the load, before the dot product (`pool_value` in
// attention_common.cuh); scores, mask and online softmax are the float
// kernel's, from the same loop (paged_decode.cuh).
//
// Bound on the H100: memory. Per (b, h) and visible key the kernel must
// read 2 * dh int8 bytes and 2 * 4 scale bytes, about a quarter of the
// float32 bytes at dh = 64; the least time is the live pages' bytes over
// 3.35 TB/s. What the design does about it: the loop reads the int8 bytes
// and nothing wider from device memory, and stops at the sequence's length
// as the float kernel does. Known gap: each lane loads one byte at a time;
// four values per lane (char4) and split-K are ROADMAP B2.

#include "paged_decode.cuh"

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// paged_attention.py. Every tensor is contiguous: q and out [batch, nh, dh]
// (f32 or bf16, `dtype`), pools [num_pages, ps, nh, dh] int8, scales
// [num_pages, ps, nh] f32, page_table [batch, maxp] int32, positions
// [batch] int32, visits [batch, nh] int32 or null. Launches on `stream`
// without synchronising; returns the launch's cudaGetLastError().
extern "C" int paged_decode_int8(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, const void* page_table,
                                 const void* positions, void* out,
                                 void* visits, int batch, int nh, int dh,
                                 int ps, int maxp, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (!decode_args_ok(batch, nh, dh, ps, maxp))
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* pos = static_cast<const int*>(positions);
  int* vis = static_cast<int*>(visits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
