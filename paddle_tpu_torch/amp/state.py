"""The autocast state and each op's cast decision (counterpart of
`paddle_tpu/amp/state.py`).

The JAX package's names and decisions, with torch dtypes inside: an op
that calls :func:`amp_cast_inputs` (``linear``, ``matmul``) casts its
floating inputs to the autocast dtype, or to float32, or not at all, by
the same white and black lists. Nothing else casts: the port adds no
autocast of its own (no ``torch.autocast``), so every op's output dtype is
the JAX package's.
"""
from __future__ import annotations

import torch

# ops computed in low precision under O1 (ref WHITE_LIST)
WHITE_LIST = {"linear", "matmul", "bmm", "conv2d", "conv1d", "conv3d", "mv",
              "conv2d_transpose", "einsum", "mm"}
# ops kept in fp32 under O1 (ref BLACK_LIST: numerically sensitive)
BLACK_LIST = {"exp", "log", "square", "log_softmax", "softmax", "mean", "sum",
              "cross_entropy", "softmax_with_cross_entropy", "norm", "cumsum",
              "layer_norm", "batch_norm", "reduce_mean", "reduce_sum", "pow",
              "rsqrt", "sigmoid_cross_entropy_with_logits"}

__all__ = ["WHITE_LIST", "BLACK_LIST", "amp_state", "in_amp_context",
           "amp_dtype", "amp_cast_inputs"]


class _AmpState:
    __slots__ = ("enabled", "level", "dtype", "custom_white", "custom_black")

    def __init__(self):
        self.enabled = False
        self.level = "O1"
        self.dtype = torch.bfloat16
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def in_amp_context() -> bool:
    return _state.enabled


def amp_dtype() -> torch.dtype:
    return _state.dtype


def amp_cast_inputs(op_name, *tensors):
    """Cast float inputs per the autocast policy; identity when AMP is
    off."""
    if not _state.enabled:
        return tensors if len(tensors) > 1 else tensors[0]
    white = (WHITE_LIST | _state.custom_white) - _state.custom_black
    black = (BLACK_LIST | _state.custom_black) - _state.custom_white
    low = _state.dtype
    if _state.level == "O2":
        target = None if op_name in black else low
    else:
        if op_name in white:
            target = low
        elif op_name in black:
            target = torch.float32
        else:
            target = None
    if target is None:
        return tensors if len(tensors) > 1 else tensors[0]
    out = []
    for t in tensors:
        if t is not None and t.dtype.is_floating_point and t.dtype != target:
            out.append(t.astype(target))
        else:
            out.append(t)
    return tuple(out) if len(out) > 1 else out[0]
