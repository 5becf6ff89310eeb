"""Wrappers of the ragged paged-attention DECODE kernels, the Hopper
counterparts of `paddle_tpu/kernels/pallas/paged_attention.py::
_decode_kernel`: `kernels/csrc/paged_decode.cu` for float pools and
`kernels/csrc/paged_decode_int8.cu` for int8 pools with f32 scales (the
Pallas kernel's ``quant=True`` arm). Both run the loop of
`csrc/paged_decode.cuh`.

Bound on the H100: the live pages' K/V bytes over 3.35 TB/s (see the
sources' headers for the design against it). The wrappers take CUDA
tensors only and always launch their kernel; `kernels/paged_attention.py`
sends CPU tensors to the plain version, `_plain_paged_attention`.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels._build import CudaKernel
from paddle_tpu_torch.kernels.cuda import (DTYPE_CODES, check_attention_args,
                                           require_cuda)

__all__ = ["KERNEL", "KERNEL_INT8", "pages_needed", "paged_decode",
           "paged_decode_int8"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("paged_decode", "paged_decode",
                    [_P] * 7 + [_I] * 6 + [_P])
KERNEL_INT8 = CudaKernel("paged_decode_int8", "paged_decode_int8",
                         [_P] * 9 + [_I] * 6 + [_P])


def pages_needed(pos, page_size, pages_per_slot):
    """Trip count of the kernel's page loop for position ``pos``: the
    length-aware stop ``ceil((pos + 1) / page_size)``, clamped to
    ``pages_per_slot`` so a slot at or past its capacity never reads past
    its page-table row (the Pallas kernel has no such clamp)."""
    n = (pos + page_size) // page_size
    if isinstance(n, torch.Tensor):
        return n.clamp(max=pages_per_slot)
    return min(n, pages_per_slot)


def _launch(op, kernel, q, k_pages, v_pages, scales, page_table, pos,
            return_visits):
    check_attention_args(op, q, k_pages, v_pages,
                         {"page_table": page_table, "pos": pos}, scales)
    b, nh, dh = q.shape
    _, ps, _, _ = k_pages.shape
    maxp = page_table.shape[1]
    if tuple(page_table.shape) != (b, maxp) or tuple(pos.shape) != (b,):
        raise ValueError(f"{op}: page_table {tuple(page_table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    require_cuda(op, q)
    out = torch.empty_like(q)
    visits = torch.empty((b, nh), dtype=torch.int32, device=q.device) \
        if return_visits else None
    kernel.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  *(s.data_ptr() for s in scales or ()),
                  page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                  None if visits is None else visits.data_ptr(),
                  b, nh, dh, ps, maxp, DTYPE_CODES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return (out, visits) if return_visits else out


def paged_decode(q, k_pages, v_pages, page_table, pos, *,
                 return_visits=False):
    """One decode token per sequence over paged K/V.

    q [B, nh, dh]; pools [num_pages, page_size, nh, dh] of q's dtype
    (float32 or bfloat16); page_table [B, pages_per_slot] int32; pos [B]
    int32, all on one CUDA device. Returns [B, nh, dh] in q.dtype and, with
    ``return_visits``, the per-(b, h) page-loop trip counts [B, nh] int32.
    """
    return _launch("paged_decode", KERNEL, q, k_pages, v_pages, None,
                   page_table, pos, return_visits)


def paged_decode_int8(q, k_pages, v_pages, k_scale, v_scale, page_table,
                      pos, *, return_visits=False):
    """:func:`paged_decode` over int8 pools: ``k_scale``/``v_scale`` are
    the f32 scale pools [num_pages, page_size, nh], one scale per token
    slot and head; q and the result are float32 or bfloat16."""
    return _launch("paged_decode_int8", KERNEL_INT8, q, k_pages, v_pages,
                   (k_scale, v_scale), page_table, pos, return_visits)
