"""Wrapper of the hidden-dropout kernel (`kernels/csrc/dropout.cu`), the
Hopper counterpart of `paddle_tpu/models/gpt.py::_fdropout` (XLA in the JAX
package, not Pallas).

Bound on the H100: integer operations (the threefry hash of every
element; see the source's header). The wrapper takes CUDA tensors only
and always launches the kernel; `kernels/dropout.py` sends CPU tensors to
the plain version. x contiguous float32 or bfloat16, key a ``[2]`` int64
key tensor on x's device; the key words are read on the card, never on
the host.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels._build import CudaKernel
from paddle_tpu_torch.kernels.cuda import DTYPE_CODES, require_cuda
from paddle_tpu_torch.kernels.dropout import divisor, keep_threshold

__all__ = ["KERNEL", "dropout", "THREEFRY_INT_OPS", "INT_OPS_PER_ELEMENT"]

_P, _F, _I, _L = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                  ctypes.c_longlong)
KERNEL = CudaKernel("dropout", "hidden_dropout",
                    [_P, _P, _P, _L, _F, _F, _I, _P])

# integer operations a thread does for one element, counted from the
# kernel: threefry-2x32's 20 rounds of (add, funnel-shift rotate, xor) and
# its 6 key injections of 2 adds; then the counter's two words (2), the
# bits' xor, shift and or (3), and the keep test's select (1)
THREEFRY_INT_OPS = 20 * 3 + 6 * 2
INT_OPS_PER_ELEMENT = THREEFRY_INT_OPS + 6


def dropout(x, key, p):
    """``where(bernoulli(key, 1 - p), x / (1 - p), 0)`` in x's dtype, one
    launch."""
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"dropout: dtype {x.dtype} not supported; expected "
                         "float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError("dropout: x must be contiguous")
    if key.device != x.device or key.dtype != torch.int64 or \
            tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(f"dropout: key must be a contiguous [2] int64 "
                         f"tensor on {x.device}, got {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}")
    require_cuda("dropout", x, "kernels/dropout.py")
    out = torch.empty_like(x)
    if x.numel():
        KERNEL.launch(x.data_ptr(), out.data_ptr(), key.data_ptr(),
                      x.numel(), keep_threshold(p), divisor(p, x.dtype),
                      DTYPE_CODES[x.dtype],
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out
