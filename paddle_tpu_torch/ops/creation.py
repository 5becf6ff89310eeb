"""Tensor creation ops (counterpart of `paddle_tpu/ops/creation.py`): new
tensors go to the current device (`device.set_device`)."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.common import ensure_tensor, inplace_guard, rebind

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
           "meshgrid", "diag", "diagflat", "diag_embed", "diagonal", "tril",
           "triu", "tril_indices", "triu_indices", "assign", "clone", "numel",
           "is_tensor", "is_empty", "complex", "polar", "as_complex",
           "as_real", "cast", "cast_"]


def _shape_arg(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _dev():
    return device_mod.current_device()


def _new(t: torch.Tensor) -> Tensor:
    return Tensor(t, _internal=True)


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape_arg(shape),
                            dtype=dtype_mod.convert_dtype(dtype),
                            device=_dev()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape_arg(shape),
                           dtype=dtype_mod.convert_dtype(dtype),
                           device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = dtype_mod.bool_
        elif isinstance(fill_value, int):
            dtype = dtype_mod.int64
        else:
            dtype = dtype_mod.get_default_dtype()
    return _new(torch.full(_shape_arg(shape), fill_value,
                           dtype=dtype_mod.convert_dtype(dtype),
                           device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(x, dtype):
    x = ensure_tensor(x)
    d = dtype_mod.convert_dtype(dtype) if dtype is not None else x.dtype
    return x._data, d


def zeros_like(x, dtype=None, name=None):
    a, d = _like(x, dtype)
    return _new(torch.zeros(a.shape, dtype=d, device=a.device))


def ones_like(x, dtype=None, name=None):
    a, d = _like(x, dtype)
    return _new(torch.ones(a.shape, dtype=d, device=a.device))


def full_like(x, fill_value, dtype=None, name=None):
    a, d = _like(x, dtype)
    return _new(torch.full(a.shape, fill_value, dtype=d, device=a.device))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def _val(v):
    return v.item() if isinstance(v, Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _val(start), _val(end), _val(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (dtype_mod.int64 if builtins.all(
            isinstance(v, (int, np.integer)) for v in (start, end, step))
            else dtype_mod.get_default_dtype())
    return _new(torch.arange(start, end, step,
                             dtype=dtype_mod.convert_dtype(dtype),
                             device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace(_val(start), _val(stop), int(_val(num)),
                               dtype=dtype_mod.convert_dtype(dtype),
                               device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace(_val(start), _val(stop), int(_val(num)),
                               base=_val(base),
                               dtype=dtype_mod.convert_dtype(dtype),
                               device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    m = int(num_rows) if num_columns is None else int(num_columns)
    return _new(torch.eye(int(num_rows), m,
                          dtype=dtype_mod.convert_dtype(dtype),
                          device=_dev()))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    ts = [ensure_tensor(a) for a in args]
    return apply(lambda *arrs: tuple(torch.meshgrid(*arrs, indexing="ij")),
                 *ts, op_name="meshgrid")


def diag(x, offset=0, padding_value=0, name=None):
    x = ensure_tensor(x)

    def prim(a):
        if a.dim() == 1 and padding_value != 0:
            n = a.shape[0] + builtins.abs(offset)
            out = torch.full((n, n), padding_value, dtype=a.dtype,
                             device=a.device)
            idx = torch.arange(a.shape[0], device=a.device)
            if offset >= 0:
                return out.index_put((idx, idx + offset), a)
            return out.index_put((idx - offset, idx), a)
        return torch.diag(a, offset)

    return apply(prim, x, op_name="diag")


def diagflat(x, offset=0, name=None):
    return apply(lambda a: torch.diagflat(a, offset), ensure_tensor(x),
                 op_name="diagflat")


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply(lambda a: torch.diag_embed(a, offset, dim1, dim2),
                 ensure_tensor(x), op_name="diag_embed")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a: torch.diagonal(a, offset, axis1, axis2),
                 ensure_tensor(x), op_name="diagonal")


def tril(x, diagonal=0, name=None):
    return apply(lambda a: torch.tril(a, diagonal), ensure_tensor(x),
                 op_name="tril")


def triu(x, diagonal=0, name=None):
    return apply(lambda a: torch.triu(a, diagonal), ensure_tensor(x),
                 op_name="triu")


def tril_indices(row, col, offset=0, dtype="int64"):
    return _new(torch.tril_indices(int(row), int(col), offset,
                                   device=_dev()).to(
        dtype_mod.convert_dtype(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return _new(torch.triu_indices(int(row), int(col), offset,
                                   device=_dev()).to(
        dtype_mod.convert_dtype(dtype)))


def assign(x, output=None):
    """A copy of ``x`` (into ``output`` when given)."""
    if not isinstance(x, Tensor):
        x = Tensor(np.asarray(x))
    out = apply(lambda a: a.clone(), x, op_name="assign")
    if output is not None:
        return rebind(output, out)
    return out


def clone(x, name=None):
    return ensure_tensor(x).clone()


def numel(x, name=None):
    x = ensure_tensor(x)
    return _new(torch.tensor(x.size, dtype=torch.int64,
                             device=x._data.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def is_empty(x, name=None):
    x = ensure_tensor(x)
    return _new(torch.tensor(x.size == 0, device=x._data.device))


def complex(real, imag, name=None):
    return apply(torch.complex, ensure_tensor(real), ensure_tensor(imag),
                 op_name="complex")


def polar(abs, angle, name=None):
    return apply(torch.polar, ensure_tensor(abs), ensure_tensor(angle),
                 op_name="polar")


def as_complex(x, name=None):
    return apply(lambda a: torch.view_as_complex(a.contiguous()),
                 ensure_tensor(x), op_name="as_complex")


def as_real(x, name=None):
    return apply(torch.view_as_real, ensure_tensor(x), op_name="as_real")


def cast(x, dtype):
    x = ensure_tensor(x)
    d = dtype_mod.convert_dtype(dtype)
    if x.dtype == d:
        return x
    return apply(lambda a: a.to(d), x, op_name="cast")


def cast_(x, dtype):
    inplace_guard(x)
    return rebind(x, cast(x, dtype))
