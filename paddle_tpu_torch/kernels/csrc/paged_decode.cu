// Ragged paged-attention DECODE kernel for Hopper (sm_90a), float pools.
//
// Replaces: paddle_tpu/kernels/pallas/paged_attention.py::_decode_kernel
// (entry `paged_attention`), its float arm. The loop, its bound and its
// design are in paged_decode.cuh, shared with the int8 kernel
// (paged_decode_int8.cu).

#include "paged_decode.cuh"

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// paged_attention.py. Every tensor is contiguous: q and out [batch, nh, dh],
// pools [num_pages, ps, nh, dh] of q's dtype, page_table [batch, maxp]
// int32, positions [batch] int32, visits [batch, nh] int32 or null.
// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* page_table,
                            const void* positions, void* out, void* visits,
                            int batch, int nh, int dh, int ps, int maxp,
                            int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (!decode_args_ok(batch, nh, dh, ps, maxp))
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* pos = static_cast<const int*>(positions);
  int* vis = static_cast<int*>(visits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_paged_decode<float, float>(q, k_pages, v_pages, nullptr,
                                             nullptr, pt, pos, out, vis,
                                             batch, nh, dh, ps, maxp, s);
  if (dtype == kBFloat16)
    return launch_paged_decode<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, pt, pos, out, vis, batch, nh,
        dh, ps, maxp, s);
  return (int)cudaErrorInvalidValue;
}
