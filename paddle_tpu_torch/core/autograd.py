"""Eager autograd of the port (counterpart of `paddle_tpu/core/autograd.py`).

The JAX package records a tape of ``jax.vjp`` closures; here the tape is
torch's own: every op runs through :func:`apply`, which unwraps the Paddle
Tensors, runs the op on their torch tensors with torch's grad mode on when
some input needs a gradient, and wraps the outputs. ``backward``,
:func:`grad` (``paddle.grad``), ``retain_graph``, ``create_graph``, hooks
and ``.grad`` accumulation are ``torch.autograd``'s. The grad switches
(`no_grad`, `enable_grad`, `set_grad_enabled`) are torch's grad mode, so a
torch op inside a Paddle ``no_grad`` block records nothing either.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

__all__ = ["apply", "backward", "grad", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class set_grad_enabled(torch.set_grad_enabled):
    """Context manager (and function) setting grad mode, torch's."""


class no_grad(torch.no_grad):
    """Context manager / decorator disabling gradient recording
    (``paddle.no_grad``)."""


class enable_grad(torch.enable_grad):
    """Context manager / decorator enabling gradient recording."""


_T = None


def _tensor_mod():
    global _T
    if _T is None:
        from paddle_tpu_torch.core import tensor as T
        _T = T
    return _T


def needs_grad(t) -> bool:
    return not t.stop_gradient and (t._data.is_floating_point()
                                    or t._data.is_complex())


def apply(prim: Callable, *inputs, op_name: str = "", **static_kwargs):
    """``prim(*torch_tensors, **static_kwargs)`` on the inputs' torch
    tensors, recording for autograd when grad mode is on and an input needs
    a gradient. Returns a Tensor or a tuple of Tensors; their
    ``stop_gradient`` is False exactly when the op recorded, as in the JAX
    package."""
    T = _tensor_mod()
    if T._read_hook is not None:
        for t in inputs:
            T._read_hook(t, "_data")
    arrays = [t._data for t in inputs]
    record = torch.is_grad_enabled() and any(needs_grad(t) for t in inputs)
    fn = functools.partial(prim, **static_kwargs) if static_kwargs else prim
    with torch.set_grad_enabled(record):
        out = fn(*arrays)
    if _DEBUG_CHECKS:
        _debug_check_outputs(op_name or getattr(prim, "__name__", "op"),
                             list(out) if isinstance(out, (tuple, list))
                             else [out])
    return wrap_outputs(out, stop_gradient=not record)


_DEBUG_CHECKS = False     # flipped by flags.set_flags (check_nan_inf/benchmark)


def _debug_check_outputs(op_name, outs):
    """FLAGS_check_nan_inf / FLAGS_benchmark hooks at the dispatch point (ref
    per-op nan/inf detection `eager/nan_inf_utils.cc`, gated the same way).
    Eager only: a `to_static` capture checks nothing, as a JAX trace
    checks nothing."""
    from paddle_tpu_torch.framework.flags import flag_value
    check = flag_value("check_nan_inf")
    bench = flag_value("benchmark")
    if not (check or bench) or _tensor_mod().in_capture():
        return
    for o in outs:
        if not isinstance(o, torch.Tensor):
            continue
        if o.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        if bench and o.is_cuda:
            torch.cuda.synchronize(o.device)
        if check and (o.is_floating_point() or o.is_complex()):
            bad = ~torch.isfinite(o.detach())
            if bool(bad.any()):
                raise FloatingPointError(
                    f"FLAGS_check_nan_inf: op '{op_name}' produced "
                    f"{int(bad.sum())} non-finite value(s) in an output of "
                    f"shape {tuple(o.shape)}")


def wrap_outputs(out, stop_gradient):
    T = _tensor_mod()
    if isinstance(out, (tuple, list)):
        return tuple(T.Tensor(o, stop_gradient=stop_gradient, _internal=True)
                     for o in out)
    return T.Tensor(out, stop_gradient=stop_gradient, _internal=True)


def _seed_grad(t, g):
    T = _tensor_mod()
    if g is None:
        return torch.ones_like(t._data)
    if isinstance(g, T.Tensor):
        return g._data.to(t._data.dtype)
    return torch.as_tensor(g, dtype=t._data.dtype, device=t._data.device)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate into ``.grad`` of the leaves that need it, from
    ``tensors`` seeded with ``grad_tensors`` (ones of each tensor's shape
    where None, for any shape, as the reference does). Backward through a
    graph already freed raises RuntimeError unless it was kept by
    ``retain_graph=True``."""
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if not t._data.requires_grad:
            continue
        roots.append(t._data)
        seeds.append(_seed_grad(t, g))
    if roots:
        torch.autograd.backward(roots, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, without touching ``.grad``; always a list. An input that
    no output reaches raises RuntimeError unless ``allow_unused`` (then its
    entry is None). ``create_graph`` records the backward for higher-order
    gradients. ``no_grad_vars`` are not supported (their gradient would
    need a graph cut torch cannot make after the fact) and raise."""
    T = _tensor_mod()
    if no_grad_vars:
        raise NotImplementedError(
            "paddle.grad(no_grad_vars=...) is not ported: set stop_gradient "
            "on those tensors before the forward instead")
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    outs, seeds = [], []
    for t, g in zip(outputs, grad_outputs):
        if t._data.requires_grad:
            outs.append(t._data)
            seeds.append(_seed_grad(t, g))
    live = [i for i, t in enumerate(inputs) if t._data.requires_grad]
    got = [None] * len(inputs)
    if outs and live:
        res = torch.autograd.grad(
            outs, [inputs[i]._data for i in live], seeds,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
        for i, r in zip(live, res):
            got[i] = r
    result = []
    for i, r in enumerate(got):
        if r is None:
            if not allow_unused:
                raise RuntimeError(
                    f"input {i} is unreachable from outputs; pass "
                    "allow_unused=True to get None for such inputs")
            result.append(None)
        else:
            result.append(T.Tensor(r, stop_gradient=not r.requires_grad,
                                   _internal=True))
    return result
