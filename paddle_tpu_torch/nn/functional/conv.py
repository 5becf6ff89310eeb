"""Convolution functionals (counterpart of `paddle_tpu/nn/functional/conv.py`).

The JAX package runs one ``lax.conv_general_dilated`` (XLA, no Pallas
kernel); here each is one ``torch.nn.functional.conv{n}d`` or
``conv_transpose{n}d`` (cuDNN on the card). The amp cast sites are the
JAX package's (``amp_cast_inputs(op_name, x, weight)``), and so is every
padding form: an int, one a spatial dim, ``(lo, hi)`` pairs flat or
nested, ``"SAME"`` and ``"VALID"``. torch pads both sides alike and
refuses ``padding="same"`` with a stride above 1, so a padding that is
not symmetric (XLA's ``SAME`` puts an odd extra row on the high side) is
applied with ``F.pad`` first. Channels-last inputs are moved to the
channels-first layout torch's convolutions take and back. The bias is
added in the output's dtype, as its own op.

A transpose takes Paddle's ``[in, out / groups, *k]`` weights, which are
torch's ``conv_transpose`` layout. It is computed unpadded and then cut
(or padded with zeros) to the JAX package's grad-of-conv padding:
``k_eff - 1 - lo`` before, ``k_eff - 1 - hi + output_padding`` after, so
any ``output_padding`` works, not only those below the stride. With
``"SAME"`` / ``"VALID"`` the pads are ``lax.conv_transpose``'s; the JAX
package's own string-padded transposes raise a TypeError on jax 0.9
(ROADMAP C23).
"""
from __future__ import annotations

import torch.nn.functional as TF

from paddle_tpu_torch.amp.state import amp_cast_inputs
from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.ops.common import ensure_tensor

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _padding(padding, n, channels_last=False):
    """``[(lo, hi)]`` a spatial dim, or ``"SAME"`` / ``"VALID"``. A nested
    form takes a pair a spatial dim, or Paddle's pair a dim of the input
    (the batch and channel pairs dropped); the JAX package's reading of
    the nested form fails on both (ROADMAP C23)."""
    if isinstance(padding, str):
        return padding.upper()  # SAME / VALID
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if padding and isinstance(padding[0], (list, tuple)):
        pairs = [tuple(int(q) for q in p) for p in padding]
        if len(pairs) == n + 2:
            pairs = pairs[1:-1] if channels_last else pairs[2:]
        return pairs
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    return [(int(padding[2 * i]), int(padding[2 * i + 1])) for i in range(n)]


def _same_pads(sizes, k_eff, strides):
    """XLA's ``SAME`` (`lax.padtype_to_pads`): the output is ceil(size /
    stride), the odd extra row on the high side."""
    pads = []
    for size, k, s in zip(sizes, k_eff, strides):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads):
    """``[(lo, hi)]`` a spatial dim -> ``F.pad``'s flat list (last dim
    first)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return flat


def _channels_first(a, channels_last):
    return a.movedim(-1, 1) if channels_last else a


def _channels_back(a, channels_last):
    return a.movedim(1, -1) if channels_last else a


def _add_bias(out, bias, n_spatial, channels_last):
    bias = ensure_tensor(bias)
    if bias.dtype != out.dtype:
        bias = bias.astype(out.dtype)
    shape = [1] * (n_spatial + 2)
    shape[-1 if channels_last else 1] = bias.shape[0]
    return out + bias.reshape(shape)


def _conv(x, weight, bias, stride, padding, dilation, groups, n_spatial,
          data_format, op_name):
    x, weight = amp_cast_inputs(op_name, ensure_tensor(x),
                                ensure_tensor(weight))
    strides = _tuple(stride, n_spatial)
    dilations = _tuple(dilation, n_spatial)
    channels_last = data_format.endswith("C")
    pads = _padding(padding, n_spatial, channels_last)
    conv = _CONV[n_spatial]

    def prim(a, w):
        a = _channels_first(a, channels_last)
        p = pads
        if p == "VALID":
            p = [(0, 0)] * n_spatial
        elif p == "SAME":
            k_eff = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
            p = _same_pads(a.shape[2:], k_eff, strides)
        if all(lo == hi for lo, hi in p):
            out = conv(a, w, None, strides, [lo for lo, _ in p], dilations,
                       groups)
        else:
            out = conv(TF.pad(a, _torch_pad(p)), w, None, strides, 0,
                       dilations, groups)
        return _channels_back(out, channels_last)

    out = apply(prim, x, weight, op_name=op_name)
    if bias is not None:
        out = _add_bias(out, bias, n_spatial, channels_last)
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, fmt,
                 "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format, "conv3d")


def _transpose_pads(pads, k_eff, strides, out_pads):
    """The (before, after) padding of the grad-of-conv the JAX package
    computes: the input dilated by the stride, then padded so."""
    if pads == "SAME":
        out = []
        for k, s in zip(k_eff, strides):
            total = k + s - 2
            a = k - 1 if s > k - 1 else -(-total // 2)
            out.append((a, total - a))
        return out
    if pads == "VALID":
        return [(k - 1, k + s - 2 + max(k - s, 0) - (k - 1))
                for k, s in zip(k_eff, strides)]
    return [(k - 1 - lo, k - 1 - hi + op)
            for k, (lo, hi), op in zip(k_eff, pads, out_pads)]


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n_spatial, data_format, op_name,
                    output_size=None):
    x, weight = amp_cast_inputs(op_name, ensure_tensor(x),
                                ensure_tensor(weight))
    strides = _tuple(stride, n_spatial)
    dilations = _tuple(dilation, n_spatial)
    out_pads = _tuple(output_padding, n_spatial)
    channels_last = data_format.endswith("C")
    pads = _padding(padding, n_spatial, channels_last)
    conv_t = _CONV_T[n_spatial]

    def prim(a, w):
        a = _channels_first(a, channels_last)
        k_eff = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
        full = conv_t(a, w, None, strides, 0, 0, groups, dilations)
        # the unpadded transpose is the grad-of-conv padded k_eff - 1 on
        # each side: cut (or zero-pad) to the JAX package's padding
        cut = [(b - (k - 1), e - (k - 1)) for (b, e), k in
               zip(_transpose_pads(pads, k_eff, strides, out_pads), k_eff)]
        out = TF.pad(full, _torch_pad(cut)) if any(
            b or e for b, e in cut) else full
        return _channels_back(out, channels_last)

    out = apply(prim, x, weight, op_name=op_name)
    if output_size is not None:
        want = [int(s) for s in (output_size if isinstance(
            output_size, (list, tuple)) else [output_size] * n_spatial)]
        have = out.shape[1:-1] if channels_last else out.shape[2:]
        if list(have) != want:
            extra = [(0, w0 - h) for w0, h in zip(want, have)]

            def grow(a):
                a = _channels_first(a, channels_last)
                return _channels_back(TF.pad(a, _torch_pad(extra)),
                                      channels_last)

            out = apply(grow, out, op_name="output_size_pad")
    if bias is not None:
        out = _add_bias(out, bias, n_spatial, channels_last)
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, fmt, "conv1d_transpose",
                           output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format,
                           "conv2d_transpose", output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format,
                           "conv3d_transpose", output_size)
