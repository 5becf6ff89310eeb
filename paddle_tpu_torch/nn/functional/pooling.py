"""Pooling functionals (counterpart of `paddle_tpu/nn/functional/pooling.py`).

The JAX package pools with ``lax.reduce_window`` (XLA, no Pallas kernel);
here each is one torch pooling call on the channels-first layout, with the
JAX package's windows:

- max pads with -inf and average with zeros, both explicitly (``F.pad``)
  unless the padding is one that torch applies alike (symmetric, at most
  half the window);
- ``ceil_mode`` widens the high padding by ``stride - rem`` where the
  padded size leaves a remainder, and keeps every window that starts
  there. torch's own ``ceil_mode`` drops a last window that would start in
  the right padding, so it is never used;
- an exclusive average divides by the count of real elements in the
  window (a pooled ones tensor); a window wholly in the padding gives NaN
  as in the JAX package; ``exclusive=False`` divides by the window size;
- ``return_mask`` is the flat spatial index of each window's maximum,
  counted, as the JAX package counts it, over the trailing dims of the
  input as given, on its padding without ``ceil_mode``. Ties go to the
  smallest index in both packages; the JAX package's packing of value and
  index into one float64 can pick another element where two values differ
  by less than their index gap over 1e9 (ROADMAP C22).

The adaptive pools take the JAX package's windows (start ``floor(i * in /
out)``, end ``ceil((i + 1) * in / out)``), one spatial dim after another;
a dim that the output divides is one reshaped mean or max, any other is
sliced window by window. Their backward is the reduction's own, with no
atomics (torch's ``adaptive_avg_pool2d`` backward on the card is flagged
nondeterministic and is not used).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.nn.functional.conv import (_padding, _same_pads,
                                                 _torch_pad, _tuple)
from paddle_tpu_torch.ops.common import ensure_tensor

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _resolve(pads, sizes, k, s):
    """String padding as ``reduce_window`` resolves it over the window."""
    if pads == "VALID":
        return [(0, 0)] * len(k)
    if pads == "SAME":
        return _same_pads(sizes, k, s)
    return [tuple(p) for p in pads]


def _native(pads, k):
    """Padding torch's pools apply themselves: symmetric, at most half
    the window."""
    return all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k))


def _pool(x, ksize, stride, padding, n_spatial, data_format, kind,
          ceil_mode=False, exclusive=True):
    x = ensure_tensor(x)
    k = _tuple(ksize, n_spatial)
    s = _tuple(stride if stride is not None else ksize, n_spatial)
    channels_last = data_format.endswith("C")
    pads = _padding(padding, n_spatial, channels_last)
    sizes = x.shape[1:-1] if channels_last else x.shape[2:]
    string = isinstance(pads, str)
    pads = _resolve(pads, sizes, k, s)
    if ceil_mode and not string:
        # extend the high padding so that truncated windows are kept
        pads = [(lo, hi + (ss - rem if rem else 0)) for (lo, hi), ss, rem in
                ((p, ss, (size + p[0] + p[1] - kk) % ss) for p, size, kk, ss
                 in zip(pads, sizes, k, s))]
    native = _native(pads, k)
    divisor = exclusive and any(lo or hi for lo, hi in pads)

    def prim(a):
        a = a.movedim(-1, 1) if channels_last else a
        if kind == "max":
            if native:
                out = _MAX[n_spatial](a, k, s, [lo for lo, _ in pads])
            else:
                low = -math.inf if a.is_floating_point() else \
                    torch.iinfo(a.dtype).min
                out = _MAX[n_spatial](TF.pad(a, _torch_pad(pads), value=low),
                                      k, s, 0)
        else:
            if native:
                out = _AVG[n_spatial](a, k, s, [lo for lo, _ in pads],
                                      count_include_pad=not divisor)
            else:
                out = _AVG[n_spatial](TF.pad(a, _torch_pad(pads)), k, s, 0)
                if divisor:   # the share of each window that is real
                    ones = torch.ones((1, 1) + tuple(a.shape[2:]),
                                      dtype=torch.promote_types(
                                          a.dtype, torch.float32),
                                      device=a.device)
                    frac = _AVG[n_spatial](TF.pad(ones, _torch_pad(pads)), k,
                                           s, 0)
                    out = (out / frac).to(a.dtype)
        return out.movedim(1, -1) if channels_last else out

    return apply(prim, x, op_name=f"{kind}_pool{n_spatial}d")


def _pool_mask(x, ksize, stride, padding, n_spatial):
    """The flat spatial index of each window's maximum (see the module
    docstring)."""
    x = ensure_tensor(x)
    k = _tuple(ksize, n_spatial)
    s = _tuple(stride if stride is not None else ksize, n_spatial)

    def prim(a):
        spatial = tuple(a.shape[2:])
        pads = _resolve(_padding(padding, n_spatial), spatial, k, s)
        low = -math.inf if a.is_floating_point() else \
            torch.iinfo(a.dtype).min
        padded = TF.pad(a, _torch_pad(pads), value=low)
        _, where = _MAX[n_spatial](padded, k, s, 0, return_indices=True)
        index = torch.arange(math.prod(spatial), device=a.device).reshape(
            (1, 1) + spatial).to(torch.float64)
        index = TF.pad(index, _torch_pad(pads), value=-1).reshape(-1)
        return index[where].to(torch.int64)

    return apply(prim, x, op_name="max_pool_mask")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    out = _pool(x, kernel_size, stride, padding, 1, fmt, "max", ceil_mode)
    if return_mask:
        return out, _pool_mask(x, kernel_size, stride, padding, 1)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 2, data_format, "max",
                ceil_mode)
    if return_mask:
        return out, _pool_mask(x, kernel_size, stride, padding, 2)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 3, data_format, "max",
                ceil_mode)
    if return_mask:
        return out, _pool_mask(x, kernel_size, stride, padding, 3)
    return out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _pool(x, kernel_size, stride, padding, 1, fmt, "avg", ceil_mode,
                 exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 ceil_mode, exclusive)


def _adaptive_pool(x, output_size, n_spatial, data_format, kind):
    x = ensure_tensor(x)
    channels_last = data_format.endswith("C")
    in_spatial = tuple(x.shape[1:-1] if channels_last else x.shape[2:])
    out_sz = _tuple(output_size, n_spatial) if not isinstance(
        output_size, (list, tuple)) else tuple(output_size)
    out_sz = tuple(int(o) if o is not None else i
                   for o, i in zip(out_sz, in_spatial))

    def reduce(seg, ax):
        if kind == "max":
            return seg.amax(dim=ax, keepdim=True)
        return seg.mean(dim=ax, keepdim=True)

    def prim(a):
        src = a.movedim(-1, 1) if channels_last else a
        for d, (isz, osz) in enumerate(zip(in_spatial, out_sz)):
            ax = 2 + d
            if isz % osz == 0:
                shape = src.shape[:ax] + (osz, isz // osz) + \
                    src.shape[ax + 1:]
                src = reduce(src.reshape(shape), ax + 1).squeeze(ax + 1)
                continue
            pieces = []
            for i in range(osz):
                st, en = (i * isz) // osz, -(-((i + 1) * isz) // osz)
                pieces.append(reduce(src.narrow(ax, st, en - st), ax))
            src = torch.cat(pieces, dim=ax)
        return src.movedim(1, -1) if channels_last else src

    return apply(prim, x, op_name=f"adaptive_{kind}_pool{n_spatial}d")


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "NCW", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 1, "NCW", "max")
    return (out, None) if return_mask else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 2, "NCHW", "max")
    return (out, None) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 3, "NCDHW", "max")
    return (out, None) if return_mask else out
