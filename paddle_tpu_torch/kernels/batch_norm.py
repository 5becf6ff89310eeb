"""Batch norm in training, forward and backward, over the channel axis
(the training arm of `nn/functional/norm.py::batch_norm`; the JAX package
computes it as XLA ops in `paddle_tpu/nn/functional/norm.py:27-41`).

x is viewed as [outer, C, inner] (`view3`).

- forward: each channel's mean and biased variance, ``y = (x - mean) /
  sqrt(var + eps) * w + b`` (w and b optional), and the channel's mean,
  variance and ``rstd = 1 / sqrt(var + eps)`` in the accumulation dtype
  (float32, float64 for a float64 x) for the running statistics and the
  backward;
- backward, with ``xhat = (x - mean) * rstd``: ``db = sum(dy)``, ``dw =
  sum(dy * xhat)``, ``dx = rstd * w * (dy - db / n - xhat * dw / n)``,
  the closed form of the gradient through the batch statistics; dw and db
  in the accumulation dtype.

`kernels/registry.py` op ``batch_norm`` picks the arm once per forward
call by the tensor's device, and the backward follows it: a CPU tensor
takes the plain PyTorch versions below (the forward op for op in x's
dtype, as the JAX prim computes it), a CUDA tensor the hand-written
kernels `kernels/csrc/batch_norm_{fwd,bwd}.cu` through
`kernels/cuda/batch_norm.py` (float32 and bfloat16; they compute in f32
and round the output once), and never the plain versions.
"""
from __future__ import annotations

import math

import torch

__all__ = ["view3", "train_fwd", "train_bwd"]


def view3(x: torch.Tensor, ch_axis: int) -> torch.Tensor:
    """x (contiguous) as [outer, C, inner] around ``ch_axis``."""
    return x.reshape(math.prod(x.shape[:ch_axis]), x.shape[ch_axis],
                     math.prod(x.shape[ch_axis + 1:]))


def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


def _plain_fwd(x, w, b, eps):
    """x [outer, C, inner] -> (y, mean, var, rstd), the statistics [C] in
    the accumulation dtype; y op for op in x's dtype (promoted by w and
    b's)."""
    shape = (1, x.shape[1], 1)
    v, m = torch.var_mean(x, dim=(0, 2), correction=0)
    y = (x - m.reshape(shape)) / torch.sqrt(v.reshape(shape) + eps)
    if w is not None:
        y = y * w.reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    acc = _acc(x.dtype)
    v = v.to(acc)
    return y, m.to(acc), v, torch.rsqrt(v + eps)


def _plain_bwd(x, dy, mean, rstd, w):
    """(dx in x's dtype, dw, db [C] in the accumulation dtype)."""
    acc = mean.dtype
    shape = (1, x.shape[1], 1)
    n = x.numel() // x.shape[1]
    xhat = (x.to(acc) - mean.reshape(shape)) * rstd.reshape(shape)
    dyf = dy.to(acc)
    db = dyf.sum(dim=(0, 2))
    dw = (dyf * xhat).sum(dim=(0, 2))
    scale = rstd if w is None else rstd * w.to(acc)
    dx = (dyf - xhat * (dw / n).reshape(shape)
          - (db / n).reshape(shape)) * scale.reshape(shape)
    return dx.to(x.dtype), dw, db


def _out_dtype(x, w, b):
    dt = x.dtype
    for t in (w, b):
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return dt


def _ones_or(t, c, like, fill):
    if t is None:
        return torch.full((c,), fill, dtype=torch.float32, device=like.device)
    return t.float().contiguous()


def _cuda_fwd(x, w, b, eps):
    from paddle_tpu_torch.kernels.cuda import batch_norm as cbn
    c = x.shape[1]
    return cbn.batch_norm_fwd(x, _ones_or(w, c, x, 1.0),
                              _ones_or(b, c, x, 0.0), eps,
                              _out_dtype(x, w, b))


def _cuda_bwd(x, dy, mean, rstd, w):
    from paddle_tpu_torch.kernels.cuda import batch_norm as cbn
    return cbn.batch_norm_bwd(x, dy, mean, rstd,
                              _ones_or(w, x.shape[1], x, 1.0))


def train_fwd(impl, x, w, b, eps):
    """(y, mean, var, rstd) of x [outer, C, inner] by ``impl`` ("plain"
    or "cuda", `kernels/registry.py`'s choice)."""
    return (_cuda_fwd if impl == "cuda" else _plain_fwd)(x, w, b, eps)


def train_bwd(impl, x, dy, mean, rstd, w):
    """(dx, dw, db) by the forward's ``impl``."""
    return (_cuda_bwd if impl == "cuda" else _plain_bwd)(x, dy, mean, rstd,
                                                         w)
