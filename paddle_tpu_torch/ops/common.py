"""Shared op-dispatch helpers (counterpart of `paddle_tpu/ops/common.py`).

Each op is a torch function routed through `core.autograd.apply`. Python
scalars stay Python scalars inside the op, so they promote as the JAX
package's weakly typed scalars do: a float32 tensor plus 0.5 stays float32.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core import tensor as tensor_mod
from paddle_tpu_torch.core.autograd import apply, is_grad_enabled
from paddle_tpu_torch.core.tensor import Tensor, _is_scalar, to_torch

__all__ = ["ensure_tensor", "promote_pair", "unary", "binary",
           "make_inplace", "inplace_guard", "rebind", "weak_scalar"]


def ensure_tensor(x, dtype=None):
    if isinstance(x, Tensor):
        return x
    return Tensor(x, dtype=dtype)


def promote_pair(x: Tensor, y: Tensor):
    """Paddle's promotion: an int tensor meeting a float tensor takes the
    float dtype; otherwise numpy's common type."""
    dx, dy = x.dtype, y.dtype
    if dx == dy:
        return x, y
    fx, fy = dx.is_floating_point, dy.is_floating_point
    if fx and not fy:
        return x, y.astype(dx)
    if fy and not fx:
        return x.astype(dy), y
    common = dtype_mod.promote_types(dx, dy)
    if dx != common:
        x = x.astype(common)
    if dy != common:
        y = y.astype(common)
    return x, y


def unary(tfn, name):
    def op(x, name=None):
        x = ensure_tensor(x)
        return apply(tfn, x, op_name=name)

    op.__name__ = name
    op.__doc__ = f"Elementwise ``{name}`` (paddle.{name})."
    return op


def binary(tfn, name, promote=True):
    def op(x, y, name=None):
        xs, ys = _is_scalar(x), _is_scalar(y)
        if xs and ys:
            a = to_torch(x, None, None)
            return Tensor(tfn(a, to_torch(y, None, None)), _internal=True)
        if ys:
            return apply(lambda a: tfn(a, weak_scalar(y, a)),
                         ensure_tensor(x), op_name=name)
        if xs:
            return apply(lambda b: tfn(weak_scalar(x, b), b),
                         ensure_tensor(y), op_name=name)
        xt, yt = ensure_tensor(x), ensure_tensor(y)
        if promote:
            xt, yt = promote_pair(xt, yt)
        return apply(tfn, xt, yt, op_name=name)

    op.__name__ = name
    op.__doc__ = f"Elementwise ``{name}`` with broadcasting (paddle.{name})."
    return op


def weak_scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as the 0-d tensor it promotes to beside ``like``."""
    return torch.tensor(v, dtype=_scalar_dtype(v, like.dtype),
                        device=like.device)


def _scalar_dtype(v, tensor_dtype):
    """The dtype a Python scalar takes beside a tensor of ``tensor_dtype``
    (weak typing: the tensor's dtype unless the scalar is a float meeting
    an int or bool tensor)."""
    if isinstance(v, bool):
        return tensor_dtype
    if isinstance(v, int):
        return torch.int64 if tensor_dtype == torch.bool else tensor_dtype
    if isinstance(v, float) and not (tensor_dtype.is_floating_point or
                                     tensor_dtype.is_complex):
        return dtype_mod.get_default_dtype()
    if isinstance(v, complex) and not tensor_dtype.is_complex:
        return torch.complex64
    return tensor_dtype


def make_inplace(op):
    """The trailing-underscore in-place variant of a functional op."""

    def op_(x, *args, **kwargs):
        inplace_guard(x)
        res = op(x, *args, **kwargs)
        return rebind(x, res)

    op_.__name__ = op.__name__ + "_"
    op_.__doc__ = f"In-place variant of ``{op.__name__}``."
    return op_


def inplace_guard(x: Tensor):
    if is_grad_enabled() and not x.stop_gradient and x.is_leaf:
        raise RuntimeError(
            "in-place operation on a leaf Tensor that requires grad is not "
            "allowed (matches the reference dygraph restriction); wrap in "
            "paddle.no_grad() or operate on a non-leaf")


def rebind(x: Tensor, res: Tensor) -> Tensor:
    """Make ``x`` observe the result of a functional op in place: ``x``
    takes the result's torch tensor, history included."""
    if x.is_leaf and x._data.requires_grad and res._data.grad_fn is None:
        x._write(res._data)          # a leaf under no_grad keeps itself
        return x
    tensor_mod.note_write(x)
    x._data = res._data
    x._sg = res._sg
    x._install_hooks()
    return x
