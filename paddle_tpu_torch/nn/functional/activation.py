"""Activation functionals (counterpart of
`paddle_tpu/nn/functional/activation.py`): each is the torch op with the
jax.nn function's formula (``gelu`` is the erf form unless
``approximate=True`` asks for tanh)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.ops.common import (ensure_tensor, inplace_guard, rebind,
                                         unary)
from paddle_tpu_torch.ops.random import default_generator
from paddle_tpu_torch.kernels import prng

__all__ = ["relu", "relu_", "relu6", "sigmoid", "tanh", "tanh_", "silu",
           "swish", "mish", "hardswish", "hardsigmoid", "tanhshrink",
           "leaky_relu", "prelu", "rrelu", "elu", "elu_", "celu", "selu",
           "gelu", "hardtanh", "hardshrink", "softshrink", "softplus",
           "softsign", "thresholded_relu", "softmax", "softmax_",
           "log_softmax", "log_sigmoid", "maxout", "glu"]

relu = unary(torch.relu, "relu")
relu6 = unary(lambda a: torch.clamp(a, 0, 6), "relu6")
sigmoid = unary(torch.sigmoid, "sigmoid")
tanh = unary(torch.tanh, "tanh")
silu = unary(TF.silu, "silu")
swish = silu
mish = unary(lambda a: a * torch.tanh(TF.softplus(a)), "mish")
hardswish = unary(lambda a: a * torch.clamp(a + 3, 0, 6) / 6, "hardswish")
hardsigmoid = unary(lambda a: torch.clamp(a / 6 + 0.5, 0, 1), "hardsigmoid")
tanhshrink = unary(lambda a: a - torch.tanh(a), "tanhshrink")


def _inplace(fn):
    def op_(x, *args, **kwargs):
        inplace_guard(x)
        return rebind(x, fn(x, *args, **kwargs))
    op_.__name__ = fn.__name__ + "_"
    return op_


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply(lambda a: TF.leaky_relu(a, negative_slope),
                 ensure_tensor(x), op_name="leaky_relu")


def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = ensure_tensor(x), ensure_tensor(weight)

    def prim(a, w):
        if w.numel() > 1:
            ax = 1 if data_format == "NCHW" else a.dim() - 1
            shape = [1] * a.dim()
            shape[ax] = w.numel()
            w = w.reshape(shape)
        return torch.where(a > 0, a, a * w)

    return apply(prim, x, weight, op_name="prelu")


def rrelu(x, lower=0.125, upper=0.333, training=False, name=None):
    x = ensure_tensor(x)
    if training:
        key = default_generator().next_key(x._data.device)
        return apply(lambda a: torch.where(
            a >= 0, a, a * prng.uniform(key, a.shape, lower, upper, a.dtype)),
            x, op_name="rrelu")
    mid = (lower + upper) / 2.0
    return apply(lambda a: torch.where(a >= 0, a, a * mid), x,
                 op_name="rrelu")


def elu(x, alpha=1.0, name=None):
    return apply(lambda a: TF.elu(a, alpha), ensure_tensor(x), op_name="elu")


def celu(x, alpha=1.0, name=None):
    return apply(lambda a: TF.celu(a, alpha), ensure_tensor(x),
                 op_name="celu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply(lambda a: scale * torch.where(a > 0, a,
                                               alpha * torch.expm1(a)),
                 ensure_tensor(x), op_name="selu")


def gelu(x, approximate=False, name=None):
    return apply(lambda a: TF.gelu(a, approximate="tanh" if approximate
                                   else "none"), ensure_tensor(x),
                 op_name="gelu")


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply(lambda a: torch.clamp(a, min, max), ensure_tensor(x),
                 op_name="hardtanh")


def hardshrink(x, threshold=0.5, name=None):
    return apply(lambda a: torch.where(a.abs() > threshold, a,
                                       torch.zeros_like(a)),
                 ensure_tensor(x), op_name="hardshrink")


def softshrink(x, threshold=0.5, name=None):
    return apply(lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, torch.zeros_like(a))),
        ensure_tensor(x), op_name="softshrink")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply(lambda a: torch.where(a * beta > threshold, a,
                                       TF.softplus(a * beta) / beta),
                 ensure_tensor(x), op_name="softplus")


def softsign(x, name=None):
    return apply(TF.softsign, ensure_tensor(x), op_name="softsign")


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply(lambda a: torch.where(a > threshold, a,
                                       torch.full_like(a, value)),
                 ensure_tensor(x), op_name="thresholded_relu")


def softmax(x, axis=-1, dtype=None, name=None):
    x = ensure_tensor(x)
    if dtype is not None:
        x = x.astype(dtype)
    return apply(lambda a: torch.softmax(a, dim=axis), x, op_name="softmax")


def log_softmax(x, axis=-1, dtype=None, name=None):
    x = ensure_tensor(x)
    if dtype is not None:
        x = x.astype(dtype)
    return apply(lambda a: torch.log_softmax(a, dim=axis), x,
                 op_name="log_softmax")


def log_sigmoid(x, name=None):
    return apply(TF.logsigmoid, ensure_tensor(x), op_name="log_sigmoid")


def maxout(x, groups, axis=1, name=None):
    def prim(a):
        ax = axis % a.dim()
        c = a.shape[ax]
        shape = a.shape[:ax] + (c // groups, groups) + a.shape[ax + 1:]
        return torch.amax(a.reshape(shape), dim=ax + 1)

    return apply(prim, ensure_tensor(x), op_name="maxout")


def glu(x, axis=-1, name=None):
    return apply(lambda a: TF.glu(a, dim=axis), ensure_tensor(x),
                 op_name="glu")


relu_ = _inplace(relu)
elu_ = _inplace(elu)
softmax_ = _inplace(softmax)
tanh_ = _inplace(tanh)
