"""`layer_norm` (counterpart of `paddle_tpu/nn/functional/norm.py:73-104`)."""
from __future__ import annotations

import torch

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Layernorm over the trailing ``normalized_shape`` axes, op for op as
    the JAX package: mean and (population) variance in f32, ``(x - mean) /
    sqrt(var + epsilon)``, then the weight and bias in f32, cast back to x's
    dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.dim() - len(list(normalized_shape)), x.dim()))
    a = x.float()
    m = a.mean(dim=axes, keepdim=True)
    v = a.var(dim=axes, keepdim=True, correction=0)
    out = (a - m) / torch.sqrt(v + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
