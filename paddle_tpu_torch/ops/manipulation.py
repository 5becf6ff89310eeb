"""Shape and layout ops (counterpart of `paddle_tpu/ops/manipulation.py`).
The ops whose output shape depends on the data (``unique``, ``histogram``,
...) compute on the host, as the JAX package does."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor, to_torch
from paddle_tpu_torch.ops.common import ensure_tensor, make_inplace, rebind

__all__ = [
    "reshape", "reshape_", "view", "flatten", "flatten_", "squeeze",
    "squeeze_", "unsqueeze", "unsqueeze_", "transpose", "t",
    "matrix_transpose", "moveaxis", "swapaxes", "concat", "stack", "unstack",
    "split", "chunk", "tensor_split", "tile", "expand", "expand_as",
    "broadcast_to", "broadcast_tensors", "flip", "rot90", "roll", "gather",
    "gather_nd", "scatter", "scatter_", "scatter_nd_add", "scatter_nd",
    "index_select", "index_sample", "index_add", "index_add_", "index_put",
    "index_put_", "take_along_axis", "put_along_axis", "put_along_axis_",
    "take", "masked_select", "masked_fill", "masked_fill_", "masked_scatter",
    "repeat_interleave", "unique", "unique_consecutive", "unbind", "slice",
    "strided_slice", "crop", "tolist", "bincount", "one_hot", "histogram",
    "histogramdd", "as_strided", "view_as", "atleast_1d", "atleast_2d",
    "atleast_3d", "shard_index", "fill_", "fill", "zero_", "fill_diagonal_",
    "fill_diagonal_tensor", "fill_diagonal_tensor_", "multiplex", "reverse",
    "renorm",
]


def _ints(v):
    if isinstance(v, Tensor):
        v = v.tolist()
    if isinstance(v, (int, np.integer)):
        return int(v)
    return [int(x.item()) if isinstance(x, Tensor) else int(x) for x in v]


def _axes(v):
    a = _ints(v)
    return [a] if isinstance(a, int) else a


def _host(t: Tensor) -> np.ndarray:
    return t.numpy()


def _new(arr, like_device) -> Tensor:
    return Tensor(to_torch(np.asarray(arr), None, like_device),
                  _internal=True)


def reshape(x, shape, name=None):
    x = ensure_tensor(x)
    shp = tuple(_axes(shape))
    return apply(lambda a: torch.reshape(a, shp), x, op_name="reshape")


reshape_ = make_inplace(reshape)
view = reshape


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = ensure_tensor(x)
    nd = builtins.max(x.ndim, 1)
    s, e = start_axis % nd, stop_axis % nd

    def prim(a):
        if a.dim() == 0:
            return a.reshape(1)
        return a.reshape(a.shape[:s] + (-1,) + a.shape[e + 1:])

    return apply(prim, x, op_name="flatten")


flatten_ = make_inplace(flatten)


def squeeze(x, axis=None, name=None):
    x = ensure_tensor(x)

    def prim(a):
        if axis is None:
            return torch.squeeze(a)
        axes = tuple(ax % a.dim() for ax in _axes(axis)
                     if a.shape[ax % a.dim()] == 1)
        return torch.squeeze(a, dim=axes) if axes else a

    return apply(prim, x, op_name="squeeze")


squeeze_ = make_inplace(squeeze)


def _expand_dims(a, axes):
    nd = a.dim() + len(axes)
    for ax in sorted(ax % nd for ax in axes):
        a = a.unsqueeze(ax)
    return a


def unsqueeze(x, axis, name=None):
    x = ensure_tensor(x)
    axes = _axes(axis)
    return apply(lambda a: _expand_dims(a, axes), x, op_name="unsqueeze")


unsqueeze_ = make_inplace(unsqueeze)


def transpose(x, perm, name=None):
    x = ensure_tensor(x)
    p = tuple(_axes(perm))
    return apply(lambda a: a.permute(p), x, op_name="transpose")


def t(x, name=None):
    x = ensure_tensor(x)
    if x.ndim > 2:
        raise ValueError("paddle.t only supports ndim<=2; use transpose")
    return apply(lambda a: a.T if a.dim() == 2 else a, x, op_name="t")


def matrix_transpose(x):
    x = ensure_tensor(x)
    return apply(lambda a: a.transpose(-1, -2), x, op_name="matrix_transpose")


def moveaxis(x, source, destination, name=None):
    x = ensure_tensor(x)
    s, d = _ints(source), _ints(destination)
    return apply(lambda a: torch.movedim(a, s, d), x, op_name="moveaxis")


def swapaxes(x, axis0, axis1, name=None):
    x = ensure_tensor(x)
    return apply(lambda a: a.transpose(int(axis0), int(axis1)), x,
                 op_name="swapaxes")


def concat(x, axis=0, name=None):
    ts = [ensure_tensor(t) for t in x]
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    common = ts[0].dtype
    for t2 in ts[1:]:
        common = torch.promote_types(common, t2.dtype)
    ts = [t2 if t2.dtype == common else t2.astype(common) for t2 in ts]
    return apply(lambda *arrs: torch.cat(arrs, dim=axis), *ts,
                 op_name="concat")


def stack(x, axis=0, name=None):
    ts = [ensure_tensor(t) for t in x]
    return apply(lambda *arrs: torch.stack(arrs, dim=axis), *ts,
                 op_name="stack")


def unstack(x, axis=0, num=None, name=None):
    x = ensure_tensor(x)
    return list(apply(lambda a: tuple(torch.unbind(a, dim=axis)), x,
                      op_name="unstack"))


def split(x, num_or_sections, axis=0, name=None):
    x = ensure_tensor(x)
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    axis = int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dimension {dim} along axis {axis} is not divisible "
                f"by num_or_sections={num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = [int(s.item()) if isinstance(s, Tensor) else int(s)
                    for s in num_or_sections]
        if builtins.any(s < 0 for s in sections):
            known = builtins.sum(s for s in sections if s >= 0)
            sections = [s if s >= 0 else dim - known for s in sections]
    out = apply(lambda a: tuple(torch.split(a, sections, dim=axis)), x,
                op_name="split")
    return list(out)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    x = ensure_tensor(x)
    dim = x.shape[int(axis)]
    if isinstance(num_or_indices, int):
        base, rem = divmod(dim, num_or_indices)
        sections = [base + (1 if i < rem else 0)
                    for i in range(num_or_indices)]
    else:
        sections, prev = [], 0
        for i in (int(i) for i in num_or_indices):
            sections.append(builtins.min(i, dim) - prev)
            prev = builtins.min(i, dim)
        sections.append(dim - prev)
    return split(x, sections, axis=axis)


def tile(x, repeat_times, name=None):
    x = ensure_tensor(x)
    reps = tuple(_axes(repeat_times))
    return apply(lambda a: torch.tile(a, reps), x, op_name="tile")


def expand(x, shape, name=None):
    x = ensure_tensor(x)
    shp = _axes(shape)

    def prim(a):
        tgt = list(shp)
        off = len(tgt) - a.dim()
        for i in range(len(tgt)):
            if tgt[i] == -1:
                if i < off:
                    raise ValueError(
                        f"expand: -1 at position {i} has no corresponding "
                        f"input dim (input ndim {a.dim()}, target ndim "
                        f"{len(tgt)})")
                tgt[i] = a.shape[i - off]
        return torch.broadcast_to(a, tuple(tgt))

    return apply(prim, x, op_name="expand")


def expand_as(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    shp = tuple(y.shape)
    return apply(lambda a: torch.broadcast_to(a, shp), x, op_name="expand_as")


def broadcast_to(x, shape, name=None):
    x = ensure_tensor(x)
    shp = tuple(_axes(shape))
    return apply(lambda a: torch.broadcast_to(a, shp), x,
                 op_name="broadcast_to")


def broadcast_tensors(inputs, name=None):
    ts = [ensure_tensor(t) for t in inputs]
    return list(apply(lambda *arrs: tuple(torch.broadcast_tensors(*arrs)),
                      *ts, op_name="broadcast_tensors"))


def flip(x, axis, name=None):
    x = ensure_tensor(x)
    axes = tuple(_axes(axis))
    return apply(lambda a: torch.flip(a, axes), x, op_name="flip")


def rot90(x, k=1, axes=(0, 1), name=None):
    x = ensure_tensor(x)
    return apply(lambda a: torch.rot90(a, k, tuple(axes)), x, op_name="rot90")


def roll(x, shifts, axis=None, name=None):
    x = ensure_tensor(x)
    sh = _ints(shifts)
    ax = None if axis is None else _ints(axis)

    def prim(a):
        if ax is None:
            return torch.roll(a.reshape(-1), sh).reshape(a.shape)
        return torch.roll(a, sh, ax)

    return apply(prim, x, op_name="roll")


def _take(a, i, axis):
    """``jnp.take(a, i, axis)`` for an index of any rank."""
    axis = axis % a.dim()
    flat = torch.index_select(a, axis, i.reshape(-1).long())
    return flat.reshape(a.shape[:axis] + tuple(i.shape) + a.shape[axis + 1:])


def gather(x, index, axis=0, name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply(lambda a, i: _take(a, i.reshape(-1) if i.dim() > 1 else i,
                                    axis), x, index, op_name="gather")


def _nd_index(i):
    return tuple(i.long().unbind(-1))


def gather_nd(x, index, name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    return apply(lambda a, i: a[_nd_index(i)], x, index, op_name="gather_nd")


def _in_range(i, n):
    return (i >= -n) & (i < n)


def scatter(x, index, updates, overwrite=True, name=None):
    """Write ``updates`` into the rows ``index`` of x (overwrite), or zero
    those rows and add (not overwrite); indices out of range are dropped."""
    x, index, updates = (ensure_tensor(x), ensure_tensor(index),
                         ensure_tensor(updates))

    def prim(a, i, u):
        i = i.reshape(-1).long()
        keep = _in_range(i, a.shape[0])
        i, u = i[keep], u.to(a.dtype)[keep]
        if overwrite:
            return a.index_put((i,), u)
        zeroed = a.index_put((i,), torch.zeros_like(u))
        return zeroed.index_put((i,), u, accumulate=True)

    return apply(prim, x, index, updates, op_name="scatter")


scatter_ = make_inplace(scatter)


def scatter_nd_add(x, index, updates, name=None):
    x, index, updates = (ensure_tensor(x), ensure_tensor(index),
                         ensure_tensor(updates))
    return apply(lambda a, i, u: a.index_put(_nd_index(i), u.to(a.dtype),
                                             accumulate=True),
                 x, index, updates, op_name="scatter_nd_add")


def scatter_nd(index, updates, shape, name=None):
    index, updates = ensure_tensor(index), ensure_tensor(updates)
    shp = tuple(_axes(shape))
    return apply(lambda i, u: torch.zeros(shp, dtype=u.dtype,
                                          device=u.device).index_put(
        _nd_index(i), u, accumulate=True), index, updates,
        op_name="scatter_nd")


def index_select(x, index, axis=0, name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    return apply(lambda a, i: _take(a, i, axis), x, index,
                 op_name="index_select")


def index_sample(x, index):
    x, index = ensure_tensor(x), ensure_tensor(index)
    return apply(lambda a, i: torch.gather(a, 1, i.long()), x, index,
                 op_name="index_sample")


def index_add(x, index, axis, value, name=None):
    x, index, value = (ensure_tensor(x), ensure_tensor(index),
                       ensure_tensor(value))
    return apply(lambda a, i, v: torch.index_add(a, axis, i.long(),
                                                 v.to(a.dtype)),
                 x, index, value, op_name="index_add")


index_add_ = make_inplace(index_add)


def index_put(x, indices, value, accumulate=False, name=None):
    x = ensure_tensor(x)
    idx_ts = [ensure_tensor(i) for i in indices]
    value = ensure_tensor(value)

    def prim(a, v, *idx):
        idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
        return a.index_put(idx, v.to(a.dtype), accumulate=accumulate)

    return apply(prim, x, value, *idx_ts, op_name="index_put")


index_put_ = make_inplace(index_put)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr, indices = ensure_tensor(arr), ensure_tensor(indices)
    return apply(lambda a, i: torch.take_along_dim(a, i.long(), dim=axis),
                 arr, indices, op_name="take_along_axis")


_REDUCE = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod",
           "amax": "amax", "amin": "amin"}


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    arr, indices = ensure_tensor(arr), ensure_tensor(indices)
    values = ensure_tensor(values)

    def prim(a, i, v):
        i = i.long()
        v = torch.broadcast_to(v.to(a.dtype), i.shape)
        if reduce == "assign":
            return torch.scatter(a, axis, i, v)
        if reduce not in _REDUCE:
            raise ValueError(f"unsupported reduce {reduce}")
        return torch.scatter_reduce(a, axis, i, v, _REDUCE[reduce],
                                    include_self=True)

    return apply(prim, arr, indices, values, op_name="put_along_axis")


put_along_axis_ = make_inplace(put_along_axis)


def take(x, index, mode="raise", name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    n = x.size
    if mode == "raise":
        idx = _host(index)
        if idx.size and (idx.min() < -n or idx.max() >= n):
            raise IndexError(
                f"take: index out of range for tensor of {n} elements "
                f"(got min={idx.min()}, max={idx.max()})")

    def prim(a, i):
        i = i.long()
        if mode == "wrap":
            i = torch.remainder(i, n)
        else:
            i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
        return a.reshape(-1)[i.reshape(-1)].reshape(i.shape)

    return apply(prim, x, index, op_name="take")


def masked_select(x, mask, name=None):
    x, mask = ensure_tensor(x), ensure_tensor(mask)
    return apply(lambda a, m: torch.broadcast_to(a, m.shape)[m], x, mask,
                 op_name="masked_select")


def masked_fill(x, mask, value, name=None):
    x, mask = ensure_tensor(x), ensure_tensor(mask)
    if isinstance(value, Tensor):
        return apply(lambda a, m, v: torch.where(m, v.to(a.dtype), a), x,
                     mask, value, op_name="masked_fill")
    return apply(lambda a, m: torch.where(
        m, torch.tensor(value, dtype=a.dtype, device=a.device), a), x, mask,
        op_name="masked_fill")


masked_fill_ = make_inplace(masked_fill)


def masked_scatter(x, mask, value, name=None):
    x, mask, value = ensure_tensor(x), ensure_tensor(mask), \
        ensure_tensor(value)

    def prim(a, m, v):
        mb = torch.broadcast_to(m, a.shape).reshape(-1)
        pos = torch.cumsum(mb.long(), 0) - 1
        vals = v.reshape(-1)[pos.clamp(0, v.numel() - 1)]
        return torch.where(mb, vals, a.reshape(-1)).reshape(a.shape)

    return apply(prim, x, mask, value, op_name="masked_scatter")


def repeat_interleave(x, repeats, axis=None, name=None):
    x = ensure_tensor(x)
    if isinstance(repeats, Tensor):
        return apply(lambda a, r: torch.repeat_interleave(a, r.long(),
                                                          dim=axis),
                     x, repeats, op_name="repeat_interleave")
    return apply(lambda a: torch.repeat_interleave(a, repeats, dim=axis), x,
                 op_name="repeat_interleave")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dev = x._data.device
    if not isinstance(res, tuple):
        return _new(res, dev)
    return tuple(_new(r, dev) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    arr = _host(x)
    if axis is None:
        arr = arr.reshape(-1)
        keep = np.ones(arr.shape[0], bool)
        keep[1:] = arr[1:] != arr[:-1]
    else:
        moved = np.moveaxis(arr, axis, 0)
        keep = np.ones(moved.shape[0], bool)
        keep[1:] = (moved[1:] != moved[:-1]).reshape(
            moved.shape[0] - 1, -1).any(axis=1)
    dev = x._data.device
    outs = [_new(np.compress(keep, arr, axis=0 if axis is None else axis),
                 dev)]
    if return_inverse:
        outs.append(_new((np.cumsum(keep) - 1).astype(np.int64), dev))
    if return_counts:
        idx = np.flatnonzero(keep)
        outs.append(_new(np.diff(np.append(idx, keep.shape[0])).astype(
            np.int64), dev))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unbind(x, axis=0, name=None):
    x = ensure_tensor(x)
    return list(apply(lambda a: tuple(torch.unbind(a, dim=axis)), x,
                      op_name="unbind"))


def slice(input, axes, starts, ends):
    input = ensure_tensor(input)
    axes, starts, ends = _axes(axes), _axes(starts), _axes(ends)

    def prim(a):
        idx = [builtins.slice(None)] * a.dim()
        for ax, s, e in zip(axes, starts, ends):
            idx[ax] = builtins.slice(s, e)
        return a[tuple(idx)]

    return apply(prim, input, op_name="slice")


def _strided(a, idx):
    """``a[idx]`` for slices that may step backwards (torch slices step
    forward only: a negative step flips a forward slice)."""
    out = a
    for ax, sl in enumerate(idx):
        if sl.step is not None and sl.step < 0:
            n = out.shape[ax]
            r = list(range(n))[sl]
            out = out.index_select(ax, torch.tensor(r, dtype=torch.long,
                                                    device=a.device))
        elif sl != builtins.slice(None):
            out = out[(builtins.slice(None),) * ax + (sl,)]
    return out


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = ensure_tensor(x)
    axes, starts, ends, strides = (_axes(axes), _axes(starts), _axes(ends),
                                   _axes(strides))

    def prim(a):
        idx = [builtins.slice(None)] * a.dim()
        for ax, s, e, st in zip(axes, starts, ends, strides):
            idx[ax] = builtins.slice(s, e, st)
        return _strided(a, idx)

    return apply(prim, x, op_name="strided_slice")


def crop(x, shape=None, offsets=None, name=None):
    x = ensure_tensor(x)
    shp = _axes(shape)
    offs = [0] * x.ndim if offsets is None else _axes(offsets)

    def prim(a):
        idx = tuple(builtins.slice(o, o + (s if s != -1 else a.shape[i] - o))
                    for i, (o, s) in enumerate(zip(offs, shp)))
        return a[idx]

    return apply(prim, x, op_name="crop")


def tolist(x):
    return ensure_tensor(x).tolist()


def bincount(x, weights=None, minlength=0, name=None):
    x = ensure_tensor(x)
    n = int(builtins.max(int(_host(x).max(initial=0)) + 1, minlength))
    if weights is not None:
        return apply(lambda a, w: torch.bincount(a, w, minlength=n), x,
                     ensure_tensor(weights), op_name="bincount")
    return apply(lambda a: torch.bincount(a, minlength=n), x,
                 op_name="bincount")


def one_hot(x, num_classes, name=None):
    """Rows of the identity in the default float dtype; an index outside
    [0, num_classes) gives a row of zeros, as jax.nn.one_hot."""
    x = ensure_tensor(x)

    def prim(a):
        cls = torch.arange(num_classes, device=a.device)
        return (a.long()[..., None] == cls).to(dtype_mod.get_default_dtype())

    return apply(prim, x, op_name="one_hot")


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    input = ensure_tensor(input)
    arr = _host(input)
    lo, hi = (min, max) if (min != 0 or max != 0) else (arr.min(), arr.max())
    w = None if weight is None else _host(ensure_tensor(weight))
    h, _ = np.histogram(arr, bins=bins, range=(lo, hi), weights=w,
                        density=density)
    return _new(h if density else h.astype(np.int64), input._data.device)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    x = ensure_tensor(x)
    w = None if weights is None else _host(ensure_tensor(weights))
    h, edges = np.histogramdd(_host(x), bins=bins, range=ranges,
                              density=density, weights=w)
    dev = x._data.device
    return _new(h, dev), [_new(e, dev) for e in edges]


def as_strided(x, shape, stride, offset=0, name=None):
    x = ensure_tensor(x)
    return apply(lambda a: torch.as_strided(a.contiguous().reshape(-1),
                                            tuple(shape), tuple(stride),
                                            offset).clone(), x,
                 op_name="as_strided")


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def atleast_1d(*inputs, name=None):
    outs = [reshape(t, [1]) if ensure_tensor(t).ndim == 0
            else ensure_tensor(t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [apply(torch.atleast_2d, ensure_tensor(t), op_name="atleast_2d")
            for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [apply(torch.atleast_3d, ensure_tensor(t), op_name="atleast_3d")
            for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    input = ensure_tensor(input)
    size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    return apply(lambda a: torch.where((a >= lo) & (a < hi), a - lo,
                                       torch.full_like(a, ignore_value)),
                 input, op_name="shard_index")


def fill_(x, value):
    """In-place fill with a scalar (``paddle.Tensor.fill_``)."""
    x = ensure_tensor(x)
    return rebind(x, apply(lambda a: torch.full_like(a, value), x,
                           op_name="fill_"))


fill = fill_


def zero_(x):
    return fill_(x, 0.0)


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    """In-place diagonal fill: 2-D with ``offset`` (``wrap`` restarts the
    diagonal below each square block), N-D square on the main diagonal."""
    x = ensure_tensor(x)

    def prim(a):
        v = torch.tensor(value, dtype=a.dtype, device=a.device)
        if a.dim() == 2:
            h, w = a.shape
            if wrap and offset == 0:
                mask = torch.zeros(h * w, dtype=torch.bool, device=a.device)
                mask[torch.arange(0, h * w, w + 1, device=a.device)] = True
                return torch.where(mask.reshape(h, w), v, a)
            rows = torch.arange(h, device=a.device)
            cols = rows + offset
            ok = (cols >= 0) & (cols < w)
            mask = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
            mask[rows[ok], cols[ok]] = True
            return torch.where(mask, v, a)
        idx = (torch.arange(a.shape[0], device=a.device),) * a.dim()
        return a.index_put(idx, v)

    return rebind(x, apply(prim, x, op_name="fill_diagonal_"))


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """Write ``y`` onto the (dim1, dim2) diagonal band of ``x``; ``y``
    carries the diagonal as its last axis."""
    x, y = ensure_tensor(x), ensure_tensor(y)

    def prim(a, b):
        a2 = torch.movedim(a, (dim1, dim2), (-2, -1))
        h, w = a2.shape[-2], a2.shape[-1]
        rows = torch.arange(h, device=a.device)
        cols = rows + offset
        ok = (cols >= 0) & (cols < w)
        rs, cs = rows[ok], cols[ok]
        bm = torch.movedim(b, -1, 0) if b.dim() == a.dim() - 1 else b
        upd = torch.broadcast_to(bm, (rs.shape[0],) + tuple(a2.shape[:-2]))
        upd = torch.movedim(upd, 0, -1).to(a2.dtype)
        lead = tuple(builtins.slice(None) for _ in a2.shape[:-2])
        out = a2.clone()
        out[lead + (rs, cs)] = upd
        return torch.movedim(out, (-2, -1), (dim1, dim2))

    return apply(prim, x, y, op_name="fill_diagonal_tensor")


def fill_diagonal_tensor_(x, y, offset=0, dim1=0, dim2=1, name=None):
    x = ensure_tensor(x)
    return rebind(x, fill_diagonal_tensor(x, y, offset=offset, dim1=dim1,
                                          dim2=dim2))


def multiplex(inputs, index, name=None):
    """Row ``i`` of the output is ``inputs[index[i]][i]``."""
    ts = [ensure_tensor(t) for t in inputs]
    idx = ensure_tensor(index)

    def prim(i, *cands):
        st = torch.stack(cands, 0)
        return st[i.reshape(-1).long(),
                  torch.arange(st.shape[1], device=st.device)]

    return apply(prim, idx, *ts, op_name="multiplex")


def reverse(x, axis, name=None):
    return flip(x, axis)


def renorm(x, p, axis, max_norm, name=None):
    """Clamp each slice along ``axis`` to p-norm at most ``max_norm``."""
    x = ensure_tensor(x)

    def prim(a):
        moved = torch.movedim(a, axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = torch.sum(torch.abs(flat) ** p, dim=1) ** (1.0 / p)
        s = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
        flat = flat * s[:, None].to(a.dtype)
        return torch.movedim(flat.reshape(moved.shape), 0, axis)

    return apply(prim, x, op_name="renorm")
