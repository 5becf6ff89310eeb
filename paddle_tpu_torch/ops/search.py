"""Search and sort ops (counterpart of `paddle_tpu/ops/search.py`)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.common import (ensure_tensor, inplace_guard,
                                         promote_pair, rebind)

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
           "nonzero", "where", "where_", "masked_fill", "index_fill",
           "searchsorted", "bucketize"]


def _arg(tfn, axis, keepdim, d):
    def prim(a):
        if axis is None:
            r = tfn(a.reshape(-1))
            return (r.reshape((1,) * a.dim()) if keepdim else r).to(d)
        return tfn(a, dim=int(axis), keepdim=keepdim).to(d)
    return prim


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = ensure_tensor(x)
    return apply(_arg(torch.argmax, axis, keepdim,
                      dtype_mod.convert_dtype(dtype)), x, op_name="argmax")


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = ensure_tensor(x)
    return apply(_arg(torch.argmin, axis, keepdim,
                      dtype_mod.convert_dtype(dtype)), x, op_name="argmin")


def argsort(x, axis=-1, descending=False, stable=True, name=None):
    x = ensure_tensor(x)
    return apply(lambda a: torch.sort(a, dim=axis, descending=descending,
                                      stable=True).indices, x,
                 op_name="argsort")


def sort(x, axis=-1, descending=False, stable=True, name=None):
    x = ensure_tensor(x)
    return apply(lambda a: torch.sort(a, dim=axis, descending=descending,
                                      stable=True).values, x, op_name="sort")


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    x = ensure_tensor(x)
    if isinstance(k, Tensor):
        k = int(k.item())

    def prim(a):
        r = torch.topk(a, k, dim=axis, largest=largest, sorted=True)
        return r.values, r.indices

    return apply(prim, x, op_name="topk")


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = ensure_tensor(x)

    def prim(a):
        ax = axis % a.dim()
        s = torch.sort(a, dim=ax, stable=True)
        v = s.values.select(ax, k - 1)
        i = s.indices.select(ax, k - 1)
        if keepdim:
            v, i = v.unsqueeze(ax), i.unsqueeze(ax)
        return v, i

    return apply(prim, x, op_name="kthvalue")


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of equally
    frequent ones) and the index of its last occurrence. (The JAX
    package's run-length scan is not associative and can miss the mode:
    ROADMAP C18.)"""
    x = ensure_tensor(x)

    def prim(a):
        ax = axis % a.dim()
        s = torch.sort(a, dim=ax, stable=True)
        srt, sidx = s.values, s.indices
        n = a.shape[ax]
        runs = [torch.ones_like(srt.select(ax, 0), dtype=torch.int64)]
        for j in range(1, n):
            same = srt.select(ax, j) == srt.select(ax, j - 1)
            runs.append(torch.where(same, runs[-1] + 1,
                                    torch.ones_like(runs[-1])))
        best = torch.argmax(torch.stack(runs, dim=ax), dim=ax, keepdim=True)
        v = torch.take_along_dim(srt, best, dim=ax)
        i = torch.take_along_dim(sidx, best, dim=ax)
        if not keepdim:
            v, i = v.squeeze(ax), i.squeeze(ax)
        return v, i

    return apply(prim, x, op_name="mode")


def nonzero(x, as_tuple=False):
    x = ensure_tensor(x)
    nz = torch.nonzero(x._data.detach())
    if as_tuple:
        return tuple(Tensor(c, _internal=True) for c in nz.unbind(1))
    return Tensor(nz, _internal=True)


def where(condition, x=None, y=None, name=None):
    condition = ensure_tensor(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x, y = promote_pair(ensure_tensor(x), ensure_tensor(y))
    return apply(lambda c, a, b: torch.where(c.bool(), a, b), condition, x, y,
                 op_name="where")


def where_(condition, x=None, y=None, name=None):
    inplace_guard(x)
    return rebind(x, where(condition, x, y))


def masked_fill(x, mask, value):
    from paddle_tpu_torch.ops import manipulation
    return manipulation.masked_fill(x, mask, value)


def index_fill(x, index, axis, value, name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    return apply(lambda a, i: torch.index_fill(a, axis, i.long(), value), x,
                 index, op_name="index_fill")


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    sorted_sequence, values = (ensure_tensor(sorted_sequence),
                               ensure_tensor(values))
    return apply(lambda s, v: torch.searchsorted(
        s, v.to(s.dtype), right=right, out_int32=out_int32),
        sorted_sequence, values, op_name="searchsorted")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)
