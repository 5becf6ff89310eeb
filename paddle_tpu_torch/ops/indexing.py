"""``Tensor.__getitem__`` / ``__setitem__`` (counterpart of
`paddle_tpu/ops/indexing.py`). Tensor and array indices are op inputs;
ints, slices, None and Ellipsis stay static. ``__setitem__`` writes into a
clone and rebinds, so a tensor read before the write keeps its value."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.common import ensure_tensor, inplace_guard, rebind

__all__ = ["getitem", "setitem"]


def _decompose(idx):
    """(static spec, tensor inputs, was a tuple) of an index expression."""
    items = idx if isinstance(idx, tuple) else (idx,)
    spec, tensors = [], []

    def conv(it):
        if isinstance(it, Tensor):
            tensors.append(it)
            return ("t", len(tensors) - 1)
        if isinstance(it, (np.ndarray, list)) or (
                isinstance(it, tuple) and not isinstance(idx, tuple)):
            tensors.append(Tensor(np.asarray(it)))
            return ("t", len(tensors) - 1)
        if isinstance(it, builtins.slice):
            def stat(v):
                return int(v.item()) if isinstance(v, Tensor) else v
            return ("sl", (stat(it.start), stat(it.stop), stat(it.step)))
        if it is None or it is Ellipsis or isinstance(
                it, (int, np.integer, bool)):
            return ("s", int(it) if isinstance(it, np.integer) else it)
        raise TypeError(f"unsupported index type: {type(it)}")

    for it in items:
        spec.append(conv(it))
    return spec, tensors, isinstance(idx, tuple)


def _rebuild(spec, arrays):
    out = []
    for kind, v in spec:
        if kind == "t":
            a = arrays[v]
            out.append(a if a.dtype == torch.bool else a.long())
        elif kind == "sl":
            out.append(builtins.slice(*v))
        else:
            out.append(v)
    return tuple(out)


def _negative_steps(spec):
    return builtins.any(k == "sl" and v[2] is not None and v[2] < 0
                        for k, v in spec)


def _index(a, spec, arrays):
    idx = _rebuild(spec, arrays)
    if not _negative_steps(spec):
        return a[idx]
    # torch slices step forward only: index with every backward slice made
    # whole, then pick each such output axis's positions in order
    if any(k == "t" for k, _ in spec):
        raise NotImplementedError(
            "a negative slice step beside a tensor index")
    n_used = sum(1 for it in idx if it is not None and it is not Ellipsis)
    plain, picks, out_dim, in_dim = [], [], 0, 0
    for it in idx:
        if it is Ellipsis:
            skip = a.dim() - n_used
            plain.append(it)
            out_dim += skip
            in_dim += skip
        elif it is None:
            plain.append(it)
            out_dim += 1
        elif isinstance(it, builtins.slice):
            if it.step is not None and it.step < 0:
                picks.append((out_dim, list(range(a.shape[in_dim]))[it]))
                plain.append(builtins.slice(None))
            else:
                plain.append(it)
            out_dim += 1
            in_dim += 1
        else:                                   # an int drops its axis
            plain.append(it)
            in_dim += 1
    out = a[tuple(plain)]
    for dim, r in picks:
        out = out.index_select(dim, torch.tensor(r, dtype=torch.long,
                                                 device=a.device))
    return out


def getitem(x, idx):
    x = ensure_tensor(x)
    spec, tensors, _ = _decompose(idx)
    return apply(lambda a, *ia: _index(a, spec, ia), x, *tensors,
                 op_name="getitem")


def setitem(x, idx, value):
    """``x[idx] = value``: a clone of x with the write, rebound into x."""
    inplace_guard(x)
    x = ensure_tensor(x)
    spec, tensors, _ = _decompose(idx)
    if _negative_steps(spec):
        raise NotImplementedError("setitem with a negative slice step")
    if isinstance(value, (int, float, bool)):
        def prim(a, *ia):
            out = a.clone()
            out[_rebuild(spec, ia)] = torch.tensor(value, dtype=a.dtype,
                                                   device=a.device)
            return out

        res = apply(prim, x, *tensors, op_name="setitem")
    else:
        v = ensure_tensor(value)

        def prim(a, vv, *ia):
            out = a.clone()
            out[_rebuild(spec, ia)] = vv.to(a.dtype)
            return out

        res = apply(prim, x, v, *tensors, op_name="setitem")
    return rebind(x, res)
