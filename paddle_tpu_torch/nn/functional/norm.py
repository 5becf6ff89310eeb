"""`batch_norm` and `layer_norm` (counterpart of
`paddle_tpu/nn/functional/norm.py:14-104`). The instance, group,
local-response and spectral norms wait for ROADMAP A7.2.

``batch_norm`` keeps the JAX package's semantics:

- in training the batch mean and biased variance normalize, in x's dtype
  (bfloat16 under amp O2, where `amp.decorate` casts the weight and bias
  too), and the running statistics move by Paddle's momentum, ``running
  = momentum * running + (1 - momentum) * batch``, with the unbiased
  variance ``n / (n - 1)``; the running buffers keep their own dtype
  (float32) and are written under ``no_grad`` through ``Tensor._write``,
  so a ``to_static`` step finds them as state;
- in eval, or with ``use_global_stats``, the running statistics
  normalize, op for op as the JAX prim, with its dtype promotion.

The training arm is one ``torch.autograd.Function`` over
`kernels/batch_norm.py`: its forward is the JAX prim's ``(x - mean) /
sqrt(var + epsilon) * weight + bias`` (on the card the ``batch_norm_fwd``
kernel, `kernels/registry.py` op ``batch_norm``), and it keeps for the
backward only its input and the per-channel mean and ``1 / sqrt(var +
epsilon)``, where op-for-op autograd would keep about three full-size
tensors a norm. The backward is the closed form of the JAX prim's
gradient (on the card ``batch_norm_bwd``), its sums in float32 (float64
for a float64 input).
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.autograd import apply, no_grad
from paddle_tpu_torch.kernels import batch_norm as bn_kernels
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.ops.common import ensure_tensor

__all__ = ["batch_norm", "layer_norm"]


class _BatchNormTrain(torch.autograd.Function):
    """(x, weight or None, bias or None) -> (out, batch mean, batch biased
    variance); the statistics in x's dtype, not differentiable."""

    @staticmethod
    def forward(ctx, a, w, b, ch_axis, epsilon):
        impl = registry.dispatch("batch_norm", a)
        x = bn_kernels.view3(a.contiguous(), ch_axis)
        y, mean, var, rstd = bn_kernels.train_fwd(impl, x, w, b, epsilon)
        ctx.save_for_backward(x, mean, rstd, w)
        ctx.meta = (impl, a.shape, None if b is None else b.dtype)
        m, v = mean.to(a.dtype), var.to(a.dtype)
        ctx.mark_non_differentiable(m, v)
        return y.reshape(a.shape), m, v

    @staticmethod
    def backward(ctx, dy, _dm, _dv):
        x, mean, rstd, w = ctx.saved_tensors
        impl, shape, b_dtype = ctx.meta
        dx, dw, db = bn_kernels.train_bwd(
            impl, x, dy.contiguous().reshape(x.shape), mean, rstd, w)
        need = ctx.needs_input_grad
        return (dx.reshape(shape) if need[0] else None,
                dw.to(w.dtype) if w is not None and need[1] else None,
                db.to(b_dtype) if b_dtype is not None and need[2] else None,
                None, None)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    x = ensure_tensor(x)
    channels_last = data_format.endswith("C") and len(data_format) > 2
    ch_axis = (x.ndim - 1) if channels_last else (1 if x.ndim > 1 else 0)
    use_batch_stats = training and not use_global_stats
    has_w, has_b = weight is not None, bias is not None
    wb = [ensure_tensor(t) for t in (weight, bias) if t is not None]

    if use_batch_stats:
        def prim(a, *params):
            it = iter(params)
            w = next(it) if has_w else None
            b = next(it) if has_b else None
            return _BatchNormTrain.apply(a, w, b, ch_axis, epsilon)

        out, batch_mean, batch_var = apply(prim, x, *wb, op_name="batch_norm")
        if running_mean is not None:
            with no_grad():
                n = math.prod(s for i, s in enumerate(x.shape)
                              if i != ch_axis)
                unbiased = batch_var._data * (n / max(n - 1, 1))
                running_mean._write(momentum * running_mean._data +
                                    (1 - momentum) * batch_mean._data)
                running_var._write(momentum * running_var._data +
                                   (1 - momentum) * unbiased)
        return out

    rm, rv = ensure_tensor(running_mean), ensure_tensor(running_var)

    def prim(a, m, v, *params):
        shape = [1] * a.dim()
        shape[ch_axis] = a.shape[ch_axis]
        out = (a - m.reshape(shape)) / torch.sqrt(v.reshape(shape) + epsilon)
        it = iter(params)
        if has_w:
            out = out * next(it).reshape(shape)
        if has_b:
            out = out + next(it).reshape(shape)
        return out

    return apply(prim, x, rm, rv, *wb, op_name="batch_norm")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Layernorm over the trailing ``normalized_shape`` axes, op for op as
    the JAX package: mean and (population) variance in f32, ``(x - mean) /
    sqrt(var + epsilon)``, then the weight and bias in f32, cast back to x's
    dtype."""
    x = ensure_tensor(x)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.ndim - len(list(normalized_shape)), x.ndim))
    has_w, has_b = weight is not None, bias is not None
    inputs = [x] + [ensure_tensor(t) for t in (weight, bias) if t is not None]

    def prim(a, *wb):
        a32 = a.float()
        m = a32.mean(dim=axes, keepdim=True)
        v = a32.var(dim=axes, keepdim=True, correction=0)
        out = (a32 - m) / torch.sqrt(v + epsilon)
        it = iter(wb)
        if has_w:
            out = out * next(it).float()
        if has_b:
            out = out + next(it).float()
        return out.to(a.dtype)

    return apply(prim, *inputs, op_name="layer_norm")
