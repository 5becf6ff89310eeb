"""Wrappers of the batch norm kernels (`kernels/csrc/batch_norm_fwd.cu`,
`batch_norm_bwd.cu`), which the port adds for `nn.functional.batch_norm`
in training: the JAX package computes it through XLA, with no Pallas
kernel (`paddle_tpu/nn/functional/norm.py:14`).

Bound on the H100: bytes (see each source's header). Each kernel is three
launches on the current stream: per-(channel, split) partial sums (grid
(C, S), `splits`), a per-channel finalize, and a grid-stride elementwise
pass; no atomics, so a captured graph replays the eager bits. The wrappers
take CUDA tensors only and always launch their kernel; `kernels/
batch_norm.py` sends CPU tensors to the plain versions. x is viewed as
[outer, C, inner] (contiguous), in float32 or bfloat16; the forward's
output is float32 beside a bfloat16 x only where the weight or bias is
float32, and dy comes in that dtype.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels._build import CudaKernel
from paddle_tpu_torch.kernels.cuda import DTYPE_CODES, require_cuda
from paddle_tpu_torch.kernels.cuda.paged_attention import _sm_count

__all__ = ["FWD", "BWD", "THREADS", "BLOCKS_PER_SM", "splits", "vec_width",
           "batch_norm_fwd", "batch_norm_bwd"]

THREADS = 256          # batch_norm_common.cuh's kThreads
BLOCKS_PER_SM = 8      # blocks a launch asks of each SM
MIN_SPLIT_UNITS = 4 * THREADS   # units a split holds at least
_MAX_UNITS = 1 << 31

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FWD = CudaKernel("batch_norm_fwd", "batch_norm_fwd",
                 [_P] * 8 + [_L, _I, _L, _I, _I, _F, _I, _I, _I, _P])
BWD = CudaKernel("batch_norm_bwd", "batch_norm_bwd",
                 [_P] * 10 + [_L, _I, _L, _I, _I, _I, _I, _I, _P])
_VIA = "kernels/batch_norm.py"


def splits(channels: int, units: int, sm_count: int) -> int:
    """Blocks a channel's sums take: enough for BLOCKS_PER_SM blocks on
    each SM in all, each with at least MIN_SPLIT_UNITS units (one when a
    channel has fewer), at most 65535 (the grid's y limit)."""
    want = -(-BLOCKS_PER_SM * int(sm_count) // int(channels))
    return max(1, min(want, int(units) // MIN_SPLIT_UNITS, 65535))


def vec_width(inner: int, tensors) -> int:
    """Elements a load: the widest of 8, 4, 2, 1 that fits 16 bytes of
    the first tensor's (x's) dtype, divides ``inner``, and to whose bytes
    every tensor's address is aligned."""
    for v in (8, 4, 2, 1):
        if v * tensors[0].element_size() <= 16 and inner % v == 0 and all(
                t.data_ptr() % (v * t.element_size()) == 0 for t in tensors):
            return v
    return 1


def _check(op, x, others, params):
    """Raise ValueError on what the kernels do not take: mixed devices, x
    other than a contiguous float32 / bfloat16 [outer, C, inner], other
    tensors of another shape or not contiguous, per-channel tensors other
    than float32 [C], too many elements; then demand CUDA. Returns (outer,
    C, inner)."""
    named = [("x", x), *others, *params]
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"{op}: all tensors must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{op}: dtype {x.dtype} not supported; expected "
                         "float32 or bfloat16")
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"{op}: x must be [outer, C, inner], got "
                         f"{tuple(x.shape)}")
    outer, c, inner = x.shape
    if x.numel() >= _MAX_UNITS:
        raise ValueError(f"{op}: {x.numel()} elements; at most 2^31 - 1")
    for name, t in others:
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"{op}: {name} must be {list(x.shape)}, got "
                             f"{list(t.shape)}")
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"{op}: {name} must be float32 or bfloat16, "
                             f"got {t.dtype}")
    for name, t in params:
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{op}: {name} must be float32 [{c}], got "
                             f"{t.dtype} {list(t.shape)}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    require_cuda(op, x, _VIA)
    return outer, c, inner


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def batch_norm_fwd(x, w, b, eps, y_dtype):
    """x [outer, C, inner] -> (y like x in ``y_dtype``, mean, var, rstd
    [C] f32), the variance biased; ``w`` and ``b`` [C] f32."""
    if y_dtype not in DTYPE_CODES or (x.dtype == torch.float32 and
                                      y_dtype != torch.float32):
        raise ValueError(f"batch_norm_fwd: y must be float32, or bfloat16 "
                         f"beside a bfloat16 x; got {y_dtype} for {x.dtype}")
    outer, c, inner = _check("batch_norm_fwd", x, [], [("w", w), ("b", b)])
    y = torch.empty(x.shape, dtype=y_dtype, device=x.device)
    mean, var, rstd = (torch.empty(c, dtype=torch.float32, device=x.device)
                       for _ in range(3))
    v = vec_width(inner, [x, y])
    s = splits(c, outer * inner // v, _sm_count(x.device.index))
    part = torch.empty(c * s * 2, dtype=torch.float32, device=x.device)
    FWD.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
               mean.data_ptr(), var.data_ptr(), rstd.data_ptr(),
               part.data_ptr(), outer, c, inner, s, v, float(eps),
               DTYPE_CODES[x.dtype], DTYPE_CODES[y_dtype],
               BLOCKS_PER_SM * _sm_count(x.device.index), _stream(x))
    return y, mean, var, rstd


def batch_norm_bwd(x, dy, mean, rstd, w):
    """(dx like x, dw [C] f32, db [C] f32) for x [outer, C, inner], dy of
    x's shape (x's dtype, or float32 beside a bfloat16 x), and the
    forward's mean and rstd and the weight [C] f32."""
    outer, c, inner = _check("batch_norm_bwd", x, [("dy", dy)],
                             [("mean", mean), ("rstd", rstd), ("w", w)])
    if x.dtype == torch.float32 and dy.dtype != torch.float32:
        raise ValueError("batch_norm_bwd: a float32 x takes a float32 dy")
    dx = torch.empty_like(x)
    dw, db = (torch.empty(c, dtype=torch.float32, device=x.device)
              for _ in range(2))
    v = vec_width(inner, [x, dy, dx])
    s = splits(c, outer * inner // v, _sm_count(x.device.index))
    part = torch.empty(c * s * 2, dtype=torch.float32, device=x.device)
    coef = torch.empty(3 * c, dtype=torch.float32, device=x.device)
    BWD.launch(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
               w.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
               part.data_ptr(), coef.data_ptr(), outer, c, inner, s, v,
               DTYPE_CODES[x.dtype], DTYPE_CODES[dy.dtype],
               BLOCKS_PER_SM * _sm_count(x.device.index), _stream(x))
    return dx, dw, db
