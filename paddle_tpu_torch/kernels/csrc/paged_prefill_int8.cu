// Ragged paged-attention PREFILL kernel for Hopper (sm_90a), int8 pools.
//
// Replaces: paddle_tpu/kernels/pallas/prefill_attention.py::_prefill_kernel
// (entry `prefill_attention`) with quant=True: int8 K/V pages with f32
// scale pools [num_pages, page_size, nh], one scale per token slot and
// head.
//
// Bound on the H100: the visible pages' bytes (2 * dh int8 values and 2 * 4
// scale bytes per key and head) over 3.35 TB/s, or the causal products (4 *
// dh operations per visible pair) over the peak rate of q's dtype.
//
// Two loops, chosen by a fixed rule before the launch:
// - q in bfloat16 with dh a multiple of 16 up to 128: the tensor-core loop
//   of paged_prefill_mma.cuh. Only the int8 bytes and the scales are
//   copied from device memory (cp.async, 4-stage ring); the block widens a
//   tile's int8 K and V to bf16 in shared memory, which is exact, and the
//   scales are folded in after the products: s_t = (q . k_t) * ks_t /
//   sqrt(dh) in f32, and p_t * vs_t before P is rounded to bf16 for the
//   P V product. Not wgmma yet (see that header).
// - q in float32, or another head dim: the CUDA-core loop of
//   paged_prefill.cuh, where each value is widened to f32 and multiplied
//   by its slot's scale as a page is staged (`pool_value` in
//   attention_common.cuh), before any product, as the Pallas quant arm
//   does.

#include "paged_prefill.cuh"
#include "paged_prefill_mma.cuh"

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// prefill_attention.py. Every tensor is contiguous: q and out [c, nh, dh]
// (f32 or bf16, `dtype`), pools [num_pages, ps, nh, dh] int8, scales
// [num_pages, ps, nh] f32, page_table [maxp] int32 (this sequence's row),
// visits [ceil(c / block_q), nh] int32 or null; `start` and `valid` point
// at int32s in device memory, as in paged_prefill.cu. block_q is the query
// tile of the loop the call takes, as in paged_prefill.cu. Launches on
// `stream`
// without synchronising; returns the launch's cudaGetLastError().
extern "C" int paged_prefill_int8(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale, const void* page_table,
                                  void* out, void* visits, int c, int nh,
                                  int dh, int ps, int maxp,
                                  const void* start, const void* valid,
                                  int block_q, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  const int* pt = static_cast<const int*>(page_table);
  const int* st = static_cast<const int*>(start);
  const int* va = static_cast<const int*>(valid);
  int* vis = static_cast<int*>(visits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma_takes(dtype, dh)) {
    if (!prefill_args_ok(c, nh, dh, ps, maxp, st, va, block_q,
                         kMmaBlockQ) ||
        maxp > kMaxPages || !aligned16(q, k_pages, v_pages, out))
      return (int)cudaErrorInvalidValue;
    return launch_paged_prefill_mma<signed char>(
        q, k_pages, v_pages, k_scale, v_scale, pt, out, vis, c, nh, dh, ps,
        maxp, st, va, block_q, s);
  }
  if (!prefill_args_ok(c, nh, dh, ps, maxp, st, va, block_q,
                       kCoreBlockQ))
    return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_paged_prefill<float, signed char>(
        q, k_pages, v_pages, k_scale, v_scale, pt, out, vis, c, nh, dh, ps,
        maxp, st, va, block_q, s);
  if (dtype == kBFloat16)
    return launch_paged_prefill<__nv_bfloat16, signed char>(
        q, k_pages, v_pages, k_scale, v_scale, pt, out, vis, c, nh, dh, ps,
        maxp, st, va, block_q, s);
  return (int)cudaErrorInvalidValue;
}
