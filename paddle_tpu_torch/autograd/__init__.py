"""paddle.autograd of the port (counterpart of
`paddle_tpu/autograd/__init__.py`): backward, grad, the grad switches and
`PyLayer`, a user-defined op whose forward and backward take Paddle Tensors;
it runs as a ``torch.autograd.Function``."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.autograd import (  # noqa: F401
    apply, backward, enable_grad, grad, is_grad_enabled, no_grad,
    set_grad_enabled)
from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "EagerPyLayer", "backward", "grad",
           "no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "apply", "jacobian", "hessian"]


class PyLayerContext:
    """The ``ctx`` of a PyLayer's forward and backward."""

    def __init__(self):
        self._saved = ()
        self.materialize_grads = True
        self._non_diff = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved

    def mark_not_inplace(self, *a):
        pass

    def mark_non_differentiable(self, *a):
        self._non_diff = a

    def set_materialize_grads(self, v):
        self.materialize_grads = v


def _unwrap_all(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (tuple, list)):
        return type(x)(_unwrap_all(v) for v in x)
    return x


class _Function(torch.autograd.Function):
    """Runs a PyLayer: the forward under no_grad on the Tensors rebuilt
    from the torch inputs, the backward on Tensors of the cotangents."""

    @staticmethod
    def forward(fctx, layer, pctx, n_args, *flat):
        args = [Tensor(a.detach(), _internal=True)
                if isinstance(a, torch.Tensor) else a for a in flat[:n_args]]
        kwargs = dict(zip(flat[n_args::2], flat[n_args + 1::2]))
        fctx.layer, fctx.pctx = layer, pctx
        fctx.tensor_pos = [i for i, a in enumerate(flat[:n_args])
                           if isinstance(a, torch.Tensor)]
        fctx.n_in = n_args
        with torch.no_grad():
            out = layer.forward(pctx, *args, **kwargs)
        fctx.multi = isinstance(out, (tuple, list))
        outs = list(out) if fctx.multi else [out]
        return tuple(o._data.clone() if isinstance(o, Tensor) else o
                     for o in outs)

    @staticmethod
    def backward(fctx, *cts):
        cts = [Tensor(c, _internal=True) for c in cts]
        with torch.no_grad():
            grads = fctx.layer.backward(fctx.pctx, *cts)
        if not isinstance(grads, (tuple, list)):
            grads = (grads,)
        res = [None] * fctx.n_in
        for gi, pos in enumerate(fctx.tensor_pos):
            g = grads[gi] if gi < len(grads) else None
            res[pos] = None if g is None else _unwrap_all(g)
        return (None, None, None, *res)


class PyLayer:
    """User-defined autograd op (``paddle.autograd.PyLayer``): a subclass
    defines ``forward(ctx, *args)`` and ``backward(ctx, *grads)`` on
    Tensors; ``backward`` returns one gradient a Tensor input."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        flat = [a._data if isinstance(a, Tensor) else a for a in args]
        for k, v in kwargs.items():
            flat += [k, v]
        record = torch.is_grad_enabled() and any(
            isinstance(a, Tensor) and not a.stop_gradient for a in args)
        outs = _Function.apply(cls, ctx, len(args), *flat)
        wrapped = tuple(Tensor(o, stop_gradient=not record, _internal=True)
                        if isinstance(o, torch.Tensor) else o for o in outs)
        return wrapped if len(wrapped) > 1 else wrapped[0]


EagerPyLayer = PyLayer


def jacobian(func, xs, batch_axis=None):
    """The Jacobian of ``func`` at ``xs`` (``torch.autograd.functional``)."""
    single = isinstance(xs, Tensor)
    xs_list = [xs] if single else list(xs)

    def wrapped(*arrs):
        return func(*[Tensor(a, stop_gradient=False, _internal=True)
                      for a in arrs])._data

    J = torch.autograd.functional.jacobian(
        wrapped, tuple(t._data.detach() for t in xs_list))
    if single:
        return Tensor(J[0], _internal=True)
    return [Tensor(j, _internal=True) for j in J]


def hessian(func, xs, batch_axis=None):
    single = isinstance(xs, Tensor)
    xs_list = [xs] if single else list(xs)

    def wrapped(*arrs):
        out = func(*[Tensor(a, stop_gradient=False, _internal=True)
                     for a in arrs])
        return out._data.reshape(())

    H = torch.autograd.functional.hessian(
        wrapped, tuple(t._data.detach() for t in xs_list))
    if single:
        return Tensor(H[0][0], _internal=True)
    return [[Tensor(h, _internal=True) for h in row] for row in H]
