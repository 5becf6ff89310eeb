"""`LayerNorm` (counterpart of `paddle_tpu/nn/layers/norm.py:114-141`)."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers.common import resolve_device

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """`nn.functional.layer_norm` over the trailing ``normalized_shape``
    axes with a float32 ``weight`` (ones) and ``bias`` (zeros) of that
    shape; ``weight_attr=False`` / ``bias_attr=False`` drop them."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        super().__init__()
        dev = resolve_device(device, "LayerNorm")
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, device=dev))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, device=dev))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
