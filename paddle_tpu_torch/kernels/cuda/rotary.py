"""Wrapper of the fused rotary-embedding kernel (`kernels/csrc/rotary.cu`),
the Hopper counterpart of `paddle_tpu/kernels/pallas/rotary.py::_rope_kernel`.

Bound on the H100: bytes (see the source's header for the design against
it). The wrapper takes CUDA tensors only and always launches the kernel;
`kernels/rotary.py` sends CPU tensors to the plain version. q and k
[B, H, S, D] of one shape and dtype (float32 or bfloat16), D even; cos and
sin [S, D/2] of one dtype (float32 or q's); all contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels._build import CudaKernel
from paddle_tpu_torch.kernels.cuda import DTYPE_CODES, require_cuda

__all__ = ["KERNEL", "rotary", "check_rope_args"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("rotary", "rotary", [_P] * 6 + [_L, _I, _I, _I, _I, _P])


def check_rope_args(op, q, k, cos, sin):
    """Raise ValueError unless q and k are [B, H, S, D] of one shape and
    dtype (float32 or bfloat16, D even) on one device with cos and sin
    [S, D/2] of one dtype (float32 or q's)."""
    named = [("q", q), ("k", k), ("cos", cos), ("sin", sin)]
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"{op}: all tensors must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{op}: dtype {q.dtype} not supported; expected "
                         "float32 or bfloat16")
    if k.dtype != q.dtype or tuple(k.shape) != tuple(q.shape):
        raise ValueError(f"{op}: q and k must share one shape and dtype, got "
                         f"{q.dtype} {tuple(q.shape)} and {k.dtype} "
                         f"{tuple(k.shape)}")
    if q.dim() != 4 or q.shape[-1] % 2 or min(q.shape) < 1:
        raise ValueError(f"{op}: q and k must be [B, H, S, D] with D even, "
                         f"got {tuple(q.shape)}")
    s, half = q.shape[2], q.shape[3] // 2
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != (s, half):
            raise ValueError(f"{op}: {name} must be [S, D/2] = {[s, half]}, "
                             f"got {list(t.shape)}")
    if cos.dtype != sin.dtype or cos.dtype not in (torch.float32, q.dtype):
        raise ValueError(f"{op}: cos and sin must share one dtype, float32 "
                         f"or q's, got {cos.dtype} and {sin.dtype}")


def rotary(q, k, cos, sin):
    """(q_rot, k_rot) in q's dtype, one launch for both."""
    check_rope_args("rotary", q, k, cos, sin)
    for name, t in (("q", q), ("k", k), ("cos", cos), ("sin", sin)):
        if not t.is_contiguous():
            raise ValueError(f"rotary: {name} must be contiguous")
    require_cuda("rotary", q, "kernels/rotary.py")
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    b, h, s, d = q.shape
    KERNEL.launch(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                  qo.data_ptr(), ko.data_ptr(), b * h * s, s, d,
                  DTYPE_CODES[q.dtype], DTYPE_CODES[cos.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return qo, ko
