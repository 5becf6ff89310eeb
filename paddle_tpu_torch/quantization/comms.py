"""The abs-max int8 quantizer (counterpart of `QMAX` and `absmax_int8` in
`paddle_tpu/quantization/comms.py`). The KV page writes reduce the head
dim (`kernels/paged_attention.py::quantize_kv`) and the weight leaves
reduce the contraction axis (`quantization/serving.py`). The blockwise
collective codec of the JAX module is not ported yet (ROADMAP A6).
"""
from __future__ import annotations

import torch

__all__ = ["QMAX", "absmax_int8"]

QMAX = 127.0


def absmax_int8(x, axis, keepdims=False):
    """``s = max(|x|, axis) / 127`` clamped at 1e-8 (before the divide),
    ``q = clip(round(x / s), -127, 127)``; returns (q int8, s float32).

    The operation order is the JAX one, so values and scales are bit for
    bit JAX's: the maximum in f32, one division by 127, one division of
    each value by its scale, and round half to even (`torch.round`, like
    `jnp.round`). Multiplying by ``127 / max`` instead rounds differently.
    """
    f = x.float()
    s = f.abs().amax(dim=axis, keepdim=True).clamp_min(1e-8) / QMAX
    q = torch.round(f / s).clamp(-QMAX, QMAX).to(torch.int8)
    return q, (s if keepdims else s.squeeze(axis))
