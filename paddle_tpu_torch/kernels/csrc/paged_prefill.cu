// Ragged paged-attention PREFILL kernel for Hopper (sm_90a), float pools.
//
// Replaces: paddle_tpu/kernels/pallas/prefill_attention.py::_prefill_kernel
// (entry `prefill_attention`), its float arm.
//
// Bound on the H100: the visible pages' K/V bytes over 3.35 TB/s, or the
// causal products (4 * dh operations per visible pair) over the peak rate:
// at C=1024 and GPT-2 small's heads, 0.0019 ms of bytes in bf16, and in
// f32 the operations, 1.61 GFLOP at 67 TFLOP/s: 0.0241 ms.
//
// Two loops, chosen by a fixed rule before the launch:
// - q and pools in bfloat16 with dh a multiple of 16 up to 128 (GPT-2's
//   64): the tensor-core loop of paged_prefill_mma.cuh. 64-row query tiles
//   of 8 warps (4 row groups x 2 halves of each 64-key tile), S = Q K^T
//   and O += P V on mma.sync m16n8k16 with f32 accumulators, P kept in
//   registers and rounded to bf16, key rows gathered page by page with
//   cp.async into a 4-stage ring that overlaps the next tiles' loads with
//   the products. Not wgmma yet: the products are a few microseconds
//   here, and the gather and the grid's fill set the pace (see that
//   header).
// - everything else (f32, other head dims): the CUDA-core loop of
//   paged_prefill.cuh, f32 throughout: 64-row query tiles whose scores and
//   P V products are register-tiled FFMAs, pages gathered by cp.async into
//   a ring, and the keys split across blocks by a count from shapes, the
//   splits merged in the same launch.
#include "paged_prefill.cuh"
#include "paged_prefill_mma.cuh"

// C entry point, bound with ctypes by paddle_tpu_torch/kernels/cuda/
// prefill_attention.py. Every tensor is contiguous: q and out [c, nh, dh],
// pools [num_pages, ps, nh, dh] of q's dtype, page_table [maxp] int32 (this
// sequence's row), visits [ceil(c / block_q), nh, splits] int32 or null;
// `start` and `valid` each point at one int32 in device memory (the chunk's
// first position and its live rows), which every block reads and clamps
// when it starts, so a captured graph serves any chunk its upload
// describes. block_q is the query tile of the loop the call takes: at most
// 64 on either loop; the tensor-core loop's tensors must start on 16-byte
// boundaries, its slot has at most 16384 pages, and it takes one split.
// On the CUDA-core loop `splits` (1 to 32) blocks share each (query tile,
// head)'s keys: with more than one, `partials` ([ceil(c / block_q) * nh *
// splits * 64 * (dh4 + 2)] f32, dh4 = dh rounded up to 4) and `tickets`
// ([ceil(c / block_q) * nh] u32, zero, and left zero by every launch) must
// be given. Launches on `stream` without synchronising; returns the
// launch's cudaGetLastError().
extern "C" int paged_prefill(const void* q, const void* k_pages,
                             const void* v_pages, const void* page_table,
                             void* out, void* visits, void* partials,
                             void* tickets, int c, int nh, int dh, int ps,
                             int maxp, const void* start, const void* valid,
                             int block_q, int splits, int dtype,
                             void* stream) {
  using namespace paddle_tpu_torch;
  const int* pt = static_cast<const int*>(page_table);
  const int* st = static_cast<const int*>(start);
  const int* va = static_cast<const int*>(valid);
  int* vis = static_cast<int*>(visits);
  float* part = static_cast<float*>(partials);
  unsigned* tik = static_cast<unsigned*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma_takes(dtype, dh)) {
    if (!prefill_args_ok(c, nh, dh, ps, maxp, st, va, block_q,
                         kMmaBlockQ) || splits != 1 ||
        maxp > kMaxPages || !aligned16(q, k_pages, v_pages, out))
      return (int)cudaErrorInvalidValue;
    return launch_paged_prefill_mma<__nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, pt, out, vis, c, nh, dh, ps,
        maxp, st, va, block_q, s);
  }
  if (!prefill_args_ok(c, nh, dh, ps, maxp, st, va, block_q,
                       kCoreBlockQ))
    return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_paged_prefill<float, float>(
        q, k_pages, v_pages, nullptr, nullptr, pt, out, vis, part, tik, c,
        nh, dh, ps, maxp, st, va, block_q, splits, s);
  if (dtype == kBFloat16)
    return launch_paged_prefill<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, pt, out, vis, part, tik, c,
        nh, dh, ps, maxp, st, va, block_q, splits, s);
  return (int)cudaErrorInvalidValue;
}
