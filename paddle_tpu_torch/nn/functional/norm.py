"""`layer_norm` (counterpart of `paddle_tpu/nn/functional/norm.py:73-104`).
The batch, instance, group, local-response and spectral norms wait for
ROADMAP A7.2."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.ops.common import ensure_tensor

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Layernorm over the trailing ``normalized_shape`` axes, op for op as
    the JAX package: mean and (population) variance in f32, ``(x - mean) /
    sqrt(var + epsilon)``, then the weight and bias in f32, cast back to x's
    dtype."""
    x = ensure_tensor(x)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.ndim - len(list(normalized_shape)), x.ndim))
    has_w, has_b = weight is not None, bias is not None
    inputs = [x] + [ensure_tensor(t) for t in (weight, bias) if t is not None]

    def prim(a, *wb):
        a32 = a.float()
        m = a32.mean(dim=axes, keepdim=True)
        v = a32.var(dim=axes, keepdim=True, correction=0)
        out = (a32 - m) / torch.sqrt(v + epsilon)
        it = iter(wb)
        if has_w:
            out = out * next(it).float()
        if has_b:
            out = out + next(it).float()
        return out.to(a.dtype)

    return apply(prim, *inputs, op_name="layer_norm")
