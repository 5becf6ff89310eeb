"""Einsum (counterpart of `paddle_tpu/ops/einsum.py`)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.ops.common import ensure_tensor

__all__ = ["einsum"]


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    ts = [ensure_tensor(o) for o in operands]
    return apply(lambda *arrs: torch.einsum(equation, *arrs), *ts,
                 op_name="einsum")
