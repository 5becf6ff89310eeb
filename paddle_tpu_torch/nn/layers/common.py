"""`Linear` and `Dropout` (counterpart of `paddle_tpu/nn/layers/common.py:16-38,
76-89`), and the device rule of the port's layers."""
from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["resolve_device", "Linear", "Dropout"]


def resolve_device(device, who) -> torch.device:
    """``device``, or the CUDA card when it is None; with no CUDA, None
    raises naming ``device="cpu"``, the way to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on the CUDA card by default and CUDA is not "
                "available here; pass device=\"cpu\" to run it with the "
                "plain PyTorch kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` [in_features,
    out_features] (the Paddle layout). Fresh weights are Xavier-uniform from
    ``generator`` (PyTorch's default generator when None), the bias 0, as the
    JAX package's defaults; ``bias_attr=False`` drops the bias. The other
    ``*_attr`` arguments are accepted and ignored."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device, "Linear")
        self.in_features = in_features
        self.out_features = out_features
        limit = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(in_features, out_features).uniform_(
            -limit, limit, generator=generator)
        self.weight = nn.Parameter(w.to(dev))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_features, device=dev))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Dropout(nn.Module):
    """`nn.functional.dropout` with the module's training flag (a new
    module trains, as in PyTorch and Paddle)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"
