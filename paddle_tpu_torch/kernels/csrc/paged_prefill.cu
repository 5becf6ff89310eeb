// Ragged paged-attention PREFILL kernel for Hopper (sm_90a), float pools.
//
// Replaces: paddle_tpu/kernels/pallas/prefill_attention.py::_prefill_kernel
// (entry `prefill_attention`), its float arm. The loop, its bound and its
// design are in paged_prefill.cuh, shared with the int8 kernel
// (paged_prefill_int8.cu). At C=1024 in bf16 the bound is the bytes; in
// f32 it is the operations.

#include "paged_prefill.cuh"

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// prefill_attention.py. Every tensor is contiguous: q and out [c, nh, dh],
// pools [num_pages, ps, nh, dh] of q's dtype, page_table [maxp] int32 (this
// sequence's row), visits [ceil(c / block_q), nh] int32 or null. Launches
// on `stream` without synchronising; returns the launch's
// cudaGetLastError().
extern "C" int paged_prefill(const void* q, const void* k_pages,
                             const void* v_pages, const void* page_table,
                             void* out, void* visits, int c, int nh, int dh,
                             int ps, int maxp, int start, int valid,
                             int block_q, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (!prefill_args_ok(c, nh, dh, ps, maxp, start, valid, block_q))
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  int* vis = static_cast<int*>(visits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_paged_prefill<float, float>(
        q, k_pages, v_pages, nullptr, nullptr, pt, out, vis, c, nh, dh, ps,
        maxp, start, valid, block_q, s);
  if (dtype == kBFloat16)
    return launch_paged_prefill<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, pt, out, vis, c, nh, dh, ps,
        maxp, start, valid, block_q, s);
  return (int)cudaErrorInvalidValue;
}
