// Ragged paged-attention PREFILL kernel for Hopper (sm_90a), int8 pools.
//
// Replaces: paddle_tpu/kernels/pallas/prefill_attention.py::_prefill_kernel
// (entry `prefill_attention`) with quant=True: int8 K/V pages with f32
// scale pools [num_pages, page_size, nh], one scale per token slot and
// head. The one place the int8 arm differs from the float one is the
// staging of a page in shared memory: each value is widened to f32 and
// multiplied by its slot's scale there (`pool_value` in
// attention_common.cuh), before any product; the scores, mask and online
// softmax are the float kernel's, from the same loop (paged_prefill.cuh).
//
// Bound on the H100: the visible pages' bytes (2 * dh int8 values and 2 * 4
// scale bytes per key and head) over 3.35 TB/s, or at long chunks the
// causal products (4 * dh operations per visible pair) over the peak rate.
// What the design does about it: a block reads each page's int8 bytes once
// for all its query rows and never a widened copy from device memory.
// Known gap: the products run on the CUDA cores in f32 (ROADMAP B2).

#include "paged_prefill.cuh"

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// prefill_attention.py. Every tensor is contiguous: q and out [c, nh, dh]
// (f32 or bf16, `dtype`), pools [num_pages, ps, nh, dh] int8, scales
// [num_pages, ps, nh] f32, page_table [maxp] int32 (this sequence's row),
// visits [ceil(c / block_q), nh] int32 or null. Launches on `stream`
// without synchronising; returns the launch's cudaGetLastError().
extern "C" int paged_prefill_int8(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale, const void* page_table,
                                  void* out, void* visits, int c, int nh,
                                  int dh, int ps, int maxp, int start,
                                  int valid, int block_q, int dtype,
                                  void* stream) {
  using namespace paddle_tpu_torch;
  if (!prefill_args_ok(c, nh, dh, ps, maxp, start, valid, block_q))
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  int* vis = static_cast<int*>(visits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_paged_prefill<float, signed char>(
        q, k_pages, v_pages, k_scale, v_scale, pt, out, vis, c, nh, dh, ps,
        maxp, start, valid, block_q, s);
  if (dtype == kBFloat16)
    return launch_paged_prefill<__nv_bfloat16, signed char>(
        q, k_pages, v_pages, k_scale, v_scale, pt, out, vis, c, nh, dh, ps,
        maxp, start, valid, block_q, s);
  return (int)cudaErrorInvalidValue;
}
