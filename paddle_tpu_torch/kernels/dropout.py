"""Hidden dropout of the GPT training forward (counterpart of
`paddle_tpu/models/gpt.py::_fdropout`, which the JAX package computes in
XLA: there is no Pallas kernel behind it).

``hidden_dropout(x, key, p)`` is ``where(bernoulli(key, 1 - p, x.shape), x
/ (1 - p), 0)`` with the JAX train step's semantics:

- the mask is `jax.random.bernoulli` in mode "low" with 64-bit types off:
  float32 uniforms from the threefry bits of each element's flat index,
  against ``float32(1 - p)`` (`kernels/prng.py::bernoulli`);
- the divisor is ``1 - p`` rounded to x's dtype first (``bf16(0.9) =
  0.8984375``), and the division is a true IEEE division in float32,
  rounded once to x's dtype, as XLA computes ``x / (1 - p)``.

The gradient is the same op on the incoming gradient with the same key:
exactly JAX's derivative of the ``where``. Only the key is saved, never
the mask. ``p == 0`` returns x and dispatches nothing.

`kernels/registry.py` op ``fused_dropout`` picks the arm per call by x's
device: a CPU tensor takes the plain PyTorch version below, a CUDA tensor
the hand-written kernel `kernels/csrc/dropout.cu` through
`kernels/cuda/dropout.py` (one pass: hash, compare, scale), and never the
plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.kernels import prng, registry

__all__ = ["hidden_dropout"]


def keep_threshold(p: float) -> float:
    """``float32(1 - p)``: a uniform below it keeps its element."""
    return float(np.float32(1.0 - p))


def divisor(p: float, dtype: torch.dtype) -> float:
    """``1 - p`` rounded to ``dtype`` (exact in float32)."""
    return torch.tensor(1.0 - p, dtype=dtype).item()


def _plain_dropout(x, key, p):
    keep = prng.bernoulli(key, 1.0 - p, x.shape)
    c = torch.full((), divisor(p, x.dtype), dtype=x.dtype, device=x.device)
    # a tensor divisor, not a Python scalar: CUDA turns division by a host
    # scalar into a product with its reciprocal, one rounding more
    return torch.where(keep, x / c, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def _dropout(x, key, p):
    if registry.dispatch("fused_dropout", x) == "cuda":
        from paddle_tpu_torch.kernels.cuda.dropout import dropout
        return dropout(x.contiguous(), key, p)
    return _plain_dropout(x, key, p)


class _HiddenDropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, key, p):
        ctx.save_for_backward(key)
        ctx.p = p
        return _dropout(x, key, p)

    @staticmethod
    def backward(ctx, g):
        key, = ctx.saved_tensors
        return _HiddenDropout.apply(g, key, ctx.p), None, None


def hidden_dropout(x: torch.Tensor, key: torch.Tensor, p: float):
    """Upscale-in-train dropout of x (float32 or bfloat16) at rate ``p``
    with the mask of ``jax.random.bernoulli(key, 1 - p, x.shape)``; key is
    a ``[2]`` int64 key tensor (`kernels/prng.py`) on x's device.
    Differentiable in x."""
    p = float(p)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"hidden_dropout: rate {p} outside [0, 1)")
    if p == 0.0:
        return x
    if tuple(key.shape) != (2,) or key.dtype != torch.int64:
        raise ValueError(f"hidden_dropout: key must be a [2] int64 key "
                         f"tensor, got {key.dtype} {tuple(key.shape)}")
    if key.device != x.device:
        raise ValueError(f"hidden_dropout: key on {key.device}, x on "
                         f"{x.device}")
    return _HiddenDropout.apply(x, key, p)
