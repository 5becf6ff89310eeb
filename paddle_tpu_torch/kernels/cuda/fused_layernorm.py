"""Wrappers of the fused layernorm kernels (`kernels/csrc/fused_layernorm_fwd.cu`,
`fused_layernorm_bwd.cu`), the Hopper counterparts of
`paddle_tpu/kernels/pallas/fused_layernorm.py::_fwd_kernel` and `_bwd_kernel`.

Bound on the H100: bytes (see each source's header for the design against
it). The wrappers take CUDA tensors only and always launch their kernel;
`kernels/fused_layernorm.py` sends CPU tensors to the plain versions.
Rows [n, d], contiguous, x in float32 or bfloat16, gamma and beta in
float32 or x's dtype, 1 <= d <= 8192.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels._build import CudaKernel
from paddle_tpu_torch.kernels.cuda import DTYPE_CODES, require_cuda

__all__ = ["FWD", "BWD", "MAX_D", "ROWS_PER_BLOCK", "fused_layernorm_fwd",
           "fused_layernorm_bwd"]

MAX_D = 8192            # rowwise_common.cuh: 256 threads x 32 elements
ROWS_PER_BLOCK = 16     # fused_layernorm_bwd.cu's kRowsPerBlock

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD = CudaKernel("fused_layernorm_fwd", "fused_layernorm_fwd",
                 [_P] * 6 + [_I, _I, _F, _I, _I, _P])
BWD = CudaKernel("fused_layernorm_bwd", "fused_layernorm_bwd",
                 [_P] * 8 + [_I] * 4 + [_P])
_VIA = "kernels/fused_layernorm.py"


def _check(op, x, gamma, named):
    """Raise ValueError on anything the kernels do not take: mixed devices,
    x (and dy) other than f32/bf16 [n, d] with 1 <= d <= 8192 and n >= 1,
    gamma (and beta) other than [d] in f32 or x's dtype, statistics other
    than f32 [n, 1], non-contiguous tensors; then demand CUDA. Returns
    (n, d)."""
    named = [("x", x), ("gamma", gamma), *named]
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"{op}: all tensors must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{op}: dtype {x.dtype} not supported; expected "
                         "float32 or bfloat16")
    if x.dim() != 2 or not 1 <= x.shape[1] <= MAX_D or x.shape[0] < 1:
        raise ValueError(f"{op}: x must be [n, d] with n >= 1 and 1 <= d <= "
                         f"{MAX_D}, got {tuple(x.shape)}")
    n, d = x.shape
    if gamma.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"{op}: gamma must be float32 or x's dtype, got "
                         f"{gamma.dtype}")
    for name, t in named:
        if name in ("mu", "rstd"):
            want_dt, want_shape = torch.float32, (n, 1)
        elif name in ("gamma", "beta"):
            want_dt, want_shape = gamma.dtype, (d,)
        else:
            want_dt, want_shape = x.dtype, (n, d)
        if t.dtype != want_dt:
            raise ValueError(f"{op}: {name} must be {want_dt}, got {t.dtype}")
        if tuple(t.shape) != want_shape:
            raise ValueError(f"{op}: {name} must be {list(want_shape)}, got "
                             f"{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    require_cuda(op, x, _VIA)
    return n, d


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_layernorm_fwd(x, gamma, beta, eps):
    """(y [n, d] in x's dtype, mu [n, 1] f32, rstd [n, 1] f32)."""
    n, d = _check("fused_layernorm_fwd", x, gamma, [("beta", beta)])
    y = torch.empty_like(x)
    mu = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    FWD.launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
               mu.data_ptr(), rstd.data_ptr(), n, d, float(eps),
               DTYPE_CODES[x.dtype], DTYPE_CODES[gamma.dtype], _stream(x))
    return y, mu, rstd


def fused_layernorm_bwd(x, gamma, mu, rstd, dy):
    """(dx [n, d] in x's dtype, dgamma and dbeta partials [nb, d] f32), one
    partial row per ROWS_PER_BLOCK rows, nb = ceil(n / ROWS_PER_BLOCK)."""
    n, d = _check("fused_layernorm_bwd", x, gamma,
                  [("mu", mu), ("rstd", rstd), ("dy", dy)])
    nb = -(-n // ROWS_PER_BLOCK)
    dx = torch.empty_like(x)
    dg = torch.empty((nb, d), dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    BWD.launch(x.data_ptr(), gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
               dy.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(), n,
               d, DTYPE_CODES[x.dtype], DTYPE_CODES[gamma.dtype], _stream(x))
    return dx, dg, db
