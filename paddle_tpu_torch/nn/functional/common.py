"""Common functionals (counterpart of `paddle_tpu/nn/functional/common.py`):
linear, the dropouts, embedding, one_hot, label_smooth, pad, bilinear,
cosine_similarity, the pixel and channel shuffles and normalize.

Dropout in training draws its key from the global generator
(``paddle.seed``'s stream, `ops/random.py`) as the JAX package's eager
dropout does. The mask is ``bernoulli(key, 1 - p)`` with a float32 ``p``,
and the kept values are divided by ``1 - p`` in x's dtype. The default
form (no ``axis``, ``upscale_in_train``, float32 or bfloat16 x) is the
registry's ``fused_dropout`` op (`kernels/dropout.py`), which runs the
``dropout`` kernel on the card. The JAX package computes the same mask
when it runs with 64-bit types off; with them on (its default) it draws
float64 uniforms instead, and the masks differ (ROADMAP C16).
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.amp.state import amp_cast_inputs
from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.kernels.dropout import hidden_dropout
from paddle_tpu_torch.ops.common import ensure_tensor
from paddle_tpu_torch.ops.random import default_generator

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "pad", "zeropad2d",
           "bilinear", "cosine_similarity", "pixel_shuffle",
           "pixel_unshuffle", "channel_shuffle", "normalize"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` [in, out] (the Paddle layout);
    the bias is cast to x's dtype. Under `amp.auto_cast` x and weight are
    cast first (`amp/state.py`, the JAX package's one cast site here)."""
    x, weight = amp_cast_inputs("linear", ensure_tensor(x),
                                ensure_tensor(weight))
    if bias is not None:
        bias = ensure_tensor(bias)
        if bias.dtype != x.dtype:
            bias = bias.astype(x.dtype)
        return apply(lambda a, w, b: torch.matmul(a, w) + b, x, weight, bias,
                     op_name="linear")
    return apply(torch.matmul, x, weight, op_name="linear")


def _key(x):
    return default_generator().next_key(x._data.device)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}; expected "
                         "'upscale_in_train' or 'downscale_in_infer'")
    x = ensure_tensor(x)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return apply(lambda a: a * (1 - p), x, op_name="dropout_infer")
        return x
    if p == 1.0:
        return apply(torch.zeros_like, x, op_name="dropout")
    key = _key(x)
    if axis is None and mode == "upscale_in_train" and \
            x.dtype in (torch.float32, torch.bfloat16):
        return apply(lambda a: hidden_dropout(a, key, p), x,
                     op_name="dropout")
    ax = None if axis is None else tuple(axis) \
        if isinstance(axis, (list, tuple)) else (axis,)

    def prim(a):
        shape = a.shape if ax is None else tuple(
            a.shape[i] if i in ax else 1 for i in range(a.dim()))
        keep = prng.bernoulli(key, 1.0 - p, shape)
        zero = torch.zeros((), dtype=a.dtype, device=a.device)
        if mode == "upscale_in_train":
            c = torch.full((), 1.0 - p, dtype=a.dtype, device=a.device)
            return torch.where(keep, a / c, zero)
        return torch.where(keep, a, zero)

    return apply(prim, x, op_name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    ax = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p=p, axis=list(ax), training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p=p, axis=list(ax), training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    x = ensure_tensor(x)
    if not training or p == 0.0:
        return x
    key = _key(x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805

    def prim(a):
        keep = prng.bernoulli(key, 1.0 - p, a.shape)
        A = 1.0 / math.sqrt((1 - p) * (1 + p * alpha_p ** 2))
        B = -A * alpha_p * p
        return (A * torch.where(keep, a, torch.full_like(a, alpha_p))
                + B).to(a.dtype)

    return apply(prim, x, op_name="alpha_dropout")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows ``weight[x]``; rows of ``padding_idx`` come out zero.
    ``sparse=True`` (a SelectedRows gradient) is not ported and raises."""
    if sparse:
        raise NotImplementedError(
            "embedding(sparse=True): the SelectedRows gradient is not ported "
            "(ROADMAP A7.2); use the dense gradient (sparse=False)")
    x, weight = ensure_tensor(x), ensure_tensor(weight)
    if padding_idx is not None and padding_idx < 0:
        padding_idx = weight.shape[0] + padding_idx

    def prim(ids, w):
        out = w[ids.long()]
        if padding_idx is not None and padding_idx >= 0:
            out = torch.where((ids == padding_idx)[..., None],
                              torch.zeros((), dtype=w.dtype, device=w.device),
                              out)
        return out

    return apply(prim, x, weight, op_name="embedding")


def one_hot(x, num_classes, name=None):
    from paddle_tpu_torch.ops.manipulation import one_hot as _oh
    return _oh(x, num_classes)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    label = ensure_tensor(label)
    if prior_dist is not None:
        return apply(lambda lab, pd: (1 - epsilon) * lab + epsilon * pd,
                     label, ensure_tensor(prior_dist),
                     op_name="label_smooth")
    return apply(lambda lab: (1 - epsilon) * lab + epsilon / lab.shape[-1],
                 label, op_name="label_smooth")


_PAD_MODE = {"reflect": "reflect", "replicate": "replicate",
             "circular": "circular"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad ``x``: a list of 2 * ndim widths pads every axis, first axis
    first; a shorter list pads the spatial axes of ``data_format``, the
    last axis first."""
    x = ensure_tensor(x)
    if isinstance(pad, Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]

    def prim(a):
        nd = a.dim()
        if len(pad) == 2 * nd:
            widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        else:
            widths = [(0, 0)] * nd
            last = data_format.endswith("C")
            for i in range(len(pad) // 2):
                dim = nd - 2 - i if last else nd - 1 - i
                widths[dim] = (pad[2 * i], pad[2 * i + 1])
        flat = []
        for lo, hi in reversed(widths):
            flat += [lo, hi]
        if mode == "constant":
            return torch.nn.functional.pad(a, flat, value=value)
        # torch pads the trailing axes only in these modes: move the padded
        # axes last
        dims = [i for i, w in enumerate(widths) if w != (0, 0)]
        rest = [i for i in range(nd) if i not in dims]
        perm = rest + dims
        moved = a.permute(perm)
        lead = len(rest)
        flat = []
        for d in reversed(dims):
            flat += list(widths[d])
        shape = moved.shape
        batch = moved.reshape((-1, 1) + tuple(shape[lead:]))
        out = torch.nn.functional.pad(batch, flat, mode=_PAD_MODE[mode])
        out = out.reshape(tuple(shape[:lead]) + tuple(out.shape[2:]))
        inv = [perm.index(i) for i in range(nd)]
        return out.permute(inv)

    return apply(prim, x, op_name="pad")


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def bilinear(x1, x2, weight, bias=None, name=None):
    out = apply(lambda a, b, w: torch.einsum("bi,oij,bj->bo", a, w, b),
                ensure_tensor(x1), ensure_tensor(x2), ensure_tensor(weight),
                op_name="bilinear")
    if bias is not None:
        out = out + ensure_tensor(bias)
    return out


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def prim(a, b):
        dot = torch.sum(a * b, dim=axis)
        na = torch.sqrt(torch.sum(a * a, dim=axis))
        nb = torch.sqrt(torch.sum(b * b, dim=axis))
        return dot / torch.clamp(na * nb, min=eps)

    return apply(prim, ensure_tensor(x1), ensure_tensor(x2),
                 op_name="cosine_similarity")


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def prim(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c // (r * r), r, r, h, w)
            a = a.permute(0, 1, 4, 2, 5, 3)
            return a.reshape(n, c // (r * r), h * r, w * r)
        n, h, w, c = a.shape
        a = a.reshape(n, h, w, r, r, c // (r * r))
        a = a.permute(0, 1, 3, 2, 4, 5)
        return a.reshape(n, h * r, w * r, c // (r * r))

    return apply(prim, ensure_tensor(x), op_name="pixel_shuffle")


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def prim(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c, h // r, r, w // r, r)
            a = a.permute(0, 1, 3, 5, 2, 4)
            return a.reshape(n, c * r * r, h // r, w // r)
        n, h, w, c = a.shape
        a = a.reshape(n, h // r, r, w // r, r, c)
        a = a.permute(0, 1, 3, 2, 4, 5)
        return a.reshape(n, h // r, w // r, c * r * r)

    return apply(prim, ensure_tensor(x), op_name="pixel_unshuffle")


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def prim(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            return a.reshape(n, groups, c // groups, h, w).permute(
                0, 2, 1, 3, 4).reshape(n, c, h, w)
        n, h, w, c = a.shape
        return a.reshape(n, h, w, groups, c // groups).permute(
            0, 1, 2, 4, 3).reshape(n, h, w, c)

    return apply(prim, ensure_tensor(x), op_name="channel_shuffle")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def prim(a):
        nrm = torch.sum(torch.abs(a) ** p, dim=axis,
                        keepdim=True) ** (1.0 / p)
        return a / torch.clamp(nrm, min=epsilon)

    return apply(prim, ensure_tensor(x), op_name="normalize")
