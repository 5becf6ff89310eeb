"""Activations (counterpart of `paddle_tpu/nn/functional/activation.py`),
those `incubate.nn.FusedFeedForward` is built with. Each is the PyTorch op
with the jax.nn function's formula: ``gelu`` is the exact (erf) form unless
``approximate=True`` asks for the tanh form."""
from __future__ import annotations

import torch

__all__ = ["relu", "gelu", "silu", "tanh", "sigmoid"]


def relu(x, name=None):
    return torch.relu(x)


def gelu(x, approximate=False, name=None):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return torch.nn.functional.silu(x)


def tanh(x, name=None):
    return torch.tanh(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)
