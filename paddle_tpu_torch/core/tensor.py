"""The eager Tensor of the port (counterpart of `paddle_tpu/core/tensor.py`).

A `Tensor` wraps a torch tensor, ``_data``, as the JAX Tensor wraps a jax
array; it does not subclass ``torch.Tensor``, whose methods of the same
names mean other things (``transpose(perm)``, ``split(num_or_sections,
axis)``, ``max(axis)``, ``flatten(start_axis, stop_axis)``...), so Paddle
semantics never leak into torch code that meets the tensor.

- ``stop_gradient`` is the inverse of ``_data.requires_grad`` for floating
  tensors: ``stop_gradient = False`` on a tensor with no history makes its
  torch tensor a leaf that requires grad; ``True`` detaches it.
- In-place Paddle methods and ``__setitem__`` keep the JAX package's value
  semantics: they rebind ``_data`` to an out-of-place result, so an op that
  read the old value keeps it and autograd never raises "modified by an
  inplace operation". A value written into a leaf that requires grad (an
  optimizer update, ``set_value``, a state dict load) is copied into the
  leaf under ``no_grad`` instead, so the leaf, its ``.grad`` and its hooks
  stay.
- A `Parameter` is a Tensor whose ``_data`` is a leaf with
  ``requires_grad=True`` (unless built with ``trainable=False``).

New tensors go where `device.set_device` says (the card by default).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.core import autograd
from paddle_tpu_torch.core import dtype as dtype_mod

__all__ = ["Tensor", "Parameter", "to_tensor", "unwrap", "torch_state",
           "set_capture_hooks", "set_capture_active", "in_capture",
           "current_stamp", "note_read", "note_write"]

_ops_cache = None

# The tensor-creation clock: `jit.to_static` tells the tensors that existed
# before a step ran (parameters, optimizer state, the key chain) from the
# step's temporaries by their stamp.
_creation_clock = 0


def current_stamp() -> int:
    return _creation_clock


# Read and write hooks of `jit.to_static` (the JAX package's
# `set_capture_hooks`, `core/tensor.py:43-67`). A hook takes ``(holder,
# key)``: a Tensor and ``"_data"``, or a dict or an object holding a torch
# tensor under ``key`` (an optimizer's accumulator or master copy, the
# generator's key). The write hook fires BEFORE the value is rebound.
_read_hook = None
_write_hook = None
# True while a `to_static` step runs (eagerly, captured or replayed):
# stateful code keeps host values out of it (the optimizer's lr and step).
_capture_active = False


def set_capture_hooks(read_hook, write_hook):
    global _read_hook, _write_hook
    prev = (_read_hook, _write_hook)
    _read_hook, _write_hook = read_hook, write_hook
    return prev


def set_capture_active(v: bool) -> bool:
    global _capture_active
    prev = _capture_active
    _capture_active = bool(v)
    return prev


def in_capture() -> bool:
    return _capture_active


def note_read(holder, key="_data"):
    if _read_hook is not None:
        _read_hook(holder, key)


def note_write(holder, key="_data"):
    if _write_hook is not None:
        _write_hook(holder, key)


def _host_read(t):
    """A Tensor's value is about to be read on the host: inside a
    `to_static` step that is data-dependent control flow, which a captured
    graph cannot replay (the JAX package converts such a step with
    dy2static, which is not ported: ROADMAP A10)."""
    if _capture_active:
        from paddle_tpu_torch.jit.static_function import (
            DataDependentControlFlowError, HINT)
        raise DataDependentControlFlowError(HINT)


def _ops():
    global _ops_cache
    if _ops_cache is None:
        import paddle_tpu_torch.ops as ops
        _ops_cache = ops
    return _ops_cache


def _is_scalar(x) -> bool:
    return isinstance(x, (int, float, bool, complex)) and \
        not isinstance(x, Tensor)


def _differentiable(a: torch.Tensor) -> bool:
    return a.is_floating_point() or a.is_complex()


class Tensor:
    __slots__ = ("_data", "_sg", "_hooks", "_hook_counter", "_hooked",
                 "name", "persistable", "_stamp", "__weakref__", "__dict__")

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 _internal=False):
        global _creation_clock
        _creation_clock += 1
        self._stamp = _creation_clock
        if _internal:
            self._data = data
        elif isinstance(data, Tensor):
            arr = data._data
            if dtype is not None:
                arr = arr.to(dtype_mod.convert_dtype(dtype))
            self._data = arr
        else:
            self._data = to_torch(data, dtype, place)
        self._sg = True
        self._hooks = {}
        self._hook_counter = 0
        self._hooked = None
        self.name = ""
        self.persistable = False
        if _internal:
            self._sg = bool(stop_gradient)
        elif not stop_gradient:
            self.stop_gradient = False
        elif self._data.requires_grad:
            self._data = self._data.detach()

    # ------------------------------------------------------------ autograd

    @property
    def stop_gradient(self) -> bool:
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        self._sg = value
        d = self._data
        if value:
            if d.requires_grad:
                self._data = d.detach()
        elif _differentiable(d) and not d.requires_grad:
            self._data = d.detach().requires_grad_(True)
            self._install_hooks()

    @property
    def _grad_node(self):
        """The torch autograd node that made this tensor (None for a
        leaf)."""
        return self._data.grad_fn

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    @property
    def grad(self):
        g = self._data.grad
        return None if g is None else Tensor(g, _internal=True)

    @grad.setter
    def grad(self, value):
        if value is None:
            self._data.grad = None
        else:
            v = value._data if isinstance(value, Tensor) else \
                to_torch(value, self.dtype, None)
            self._data.grad = v.to(self._data.device, self._data.dtype)

    def backward(self, grad_tensor=None, retain_graph=False):
        autograd.backward([self], [grad_tensor], retain_graph=retain_graph)

    def register_hook(self, hook):
        """``hook(grad) -> grad or None``, called with this tensor's
        gradient as a Tensor (for a leaf, before it accumulates)."""
        self._hook_counter += 1
        hid = self._hook_counter
        self._hooks[hid] = hook
        self._install_hooks()

        class RemovableHandle:
            def __init__(h, tensor, hid):
                h._t, h._id = tensor, hid

            def remove(h):
                h._t._hooks.pop(h._id, None)

        return RemovableHandle(self, hid)

    def _install_hooks(self):
        """One torch hook on the current torch tensor runs every Paddle
        hook in order; installed again when ``_data`` is rebound."""
        d = self._data
        if not self._hooks or not d.requires_grad or self._hooked is d:
            return
        hooks = self._hooks

        def run(g):
            for hook in list(hooks.values()):
                out = hook(Tensor(g, _internal=True))
                if out is not None:
                    g = out._data if isinstance(out, Tensor) else \
                        torch.as_tensor(out, dtype=g.dtype, device=g.device)
            return g

        d.register_hook(run)
        self._hooked = d

    def clear_grad(self, set_to_zero=True):
        """Zero ``.grad`` in place (``set_to_zero``, Paddle's default), or
        drop it."""
        g = self._data.grad
        if set_to_zero and g is not None:
            g.zero_()
        else:
            self._data.grad = None

    clear_gradient = clear_grad

    def detach(self):
        return Tensor(self._data.detach(), _internal=True)

    def detach_(self):
        self.stop_gradient = True
        return self

    # ------------------------------------------------------------ data

    def _write(self, new: torch.Tensor):
        """Rebind the value (an in-place op's result, a state load). A leaf
        that requires grad takes the value by an in-place copy under
        ``no_grad``, keeping its identity, ``.grad`` and hooks; where the
        shape, dtype or device changes it becomes a new leaf."""
        if _write_hook is not None:
            _write_hook(self, "_data")
        d = self._data
        if d.requires_grad and d.grad_fn is None:
            with torch.no_grad():
                if new.shape == d.shape and new.dtype == d.dtype and \
                        new.device == d.device:
                    d.copy_(new)
                    return
            self._data = new.detach().requires_grad_(True)
            self._install_hooks()
            return
        self._data = new.detach() if self._sg else new

    @property
    def data(self):
        return self

    @data.setter
    def data(self, value):
        self._write(value._data if isinstance(value, Tensor)
                    else to_torch(value, None, None))

    def set_value(self, value):
        v = value._data if isinstance(value, Tensor) else \
            to_torch(value, self.dtype, None)
        if tuple(v.shape) != tuple(self._data.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(v.shape)} "
                             f"vs {tuple(self._data.shape)}")
        self._write(v.to(self._data.device, self._data.dtype))

    # ------------------------------------------------------------ properties

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dim(self):
        return self._data.dim()

    def rank(self):
        return self._data.dim()

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def T(self):
        return _ops().t(self)

    @property
    def mT(self):
        return _ops().matrix_transpose(self)

    @property
    def place(self):
        return device_mod.place_of(self._data)

    def get_tensor(self):
        return self

    # ------------------------------------------------------------ conversion

    def numpy(self):
        """A numpy copy; bfloat16 comes out as float32 (numpy has no
        bfloat16)."""
        _host_read(self)
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        _host_read(self)
        return self._data.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype):
        return _ops().cast(self, dtype)

    def cast(self, dtype):
        return _ops().cast(self, dtype)

    def clone(self):
        return autograd.apply(lambda a: a.clone(), self, op_name="clone")

    def _to_device(self, dev):
        if self._data.device == dev:
            return self
        return autograd.apply(lambda a: a.to(dev), self, op_name="to")

    def cpu(self):
        return self._to_device(torch.device("cpu"))

    def cuda(self, device_id=None, blocking=True):
        return self._to_device(torch.device("cuda", device_id or 0))

    def to(self, *args, **kwargs):
        """``to(dtype)``, ``to(device)`` or ``to(device, dtype)``: a device
        is a string (``"cpu"``, ``"gpu:0"``), a Place or a torch device."""
        out = self
        for a in list(args) + list(kwargs.values()):
            if a is None or isinstance(a, bool):
                continue
            if isinstance(a, (torch.device, device_mod.Place)) or (
                    isinstance(a, str) and a.split(":")[0].lower() in
                    ("cpu", "gpu", "cuda", "tpu")):
                out = out._to_device(device_mod._parse(a))
            else:
                out = out.astype(a)
        return out

    def pin_memory(self):
        return self

    def contiguous(self):
        if self._data.is_contiguous():
            return self
        return autograd.apply(lambda a: a.contiguous(), self,
                              op_name="contiguous")

    def is_contiguous(self):
        return self._data.is_contiguous()

    def zero_(self):
        self._write(torch.zeros_like(self._data))
        return self

    def fill_(self, value):
        self._write(torch.full_like(self._data, value))
        return self

    # ------------------------------------------------------------ dunders

    def __repr__(self):
        body = repr(self.numpy())
        body = body[body.find("(") + 1: body.rfind(")")] \
            if body.startswith("array") else body
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {body})")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        _host_read(self)
        return bool(self._data.detach())

    def __int__(self):
        _host_read(self)
        return int(self._data.detach())

    def __float__(self):
        _host_read(self)
        return float(self._data.detach())

    def __index__(self):
        if _capture_active:
            from paddle_tpu_torch.jit.static_function import (
                DataDependentIndexError, HINT)
            raise DataDependentIndexError(HINT)
        return self._data.__index__()

    def __hash__(self):
        return id(self)

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return object.__format__(self, spec)

    def __deepcopy__(self, memo):
        global _creation_clock
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        _creation_clock += 1
        new._stamp = _creation_clock
        d = self._data
        new._data = d.detach().clone().requires_grad_(d.requires_grad) \
            if d.grad_fn is None or not d.requires_grad else d.clone()
        new._sg = self._sg
        new._hooks, new._hook_counter, new._hooked = {}, 0, None
        new.name, new.persistable = self.name, self.persistable
        for k, v in self.__dict__.items():
            new.__dict__[k] = copy.deepcopy(v, memo)
        return new

    def __add__(self, o):
        return _ops().add(self, o)

    def __radd__(self, o):
        return _ops().add(self, o)

    def __sub__(self, o):
        return _ops().subtract(self, o)

    def __rsub__(self, o):
        return _ops().subtract(o, self)

    def __mul__(self, o):
        return _ops().multiply(self, o)

    def __rmul__(self, o):
        return _ops().multiply(self, o)

    def __truediv__(self, o):
        return _ops().divide(self, o)

    def __rtruediv__(self, o):
        return _ops().divide(o, self)

    def __floordiv__(self, o):
        return _ops().floor_divide(self, o)

    def __rfloordiv__(self, o):
        return _ops().floor_divide(o, self)

    def __mod__(self, o):
        return _ops().remainder(self, o)

    def __rmod__(self, o):
        return _ops().remainder(o, self)

    def __pow__(self, o):
        return _ops().pow(self, o)

    def __rpow__(self, o):
        return _ops().pow(o, self)

    def __matmul__(self, o):
        return _ops().matmul(self, o)

    def __rmatmul__(self, o):
        return _ops().matmul(o, self)

    def __neg__(self):
        return _ops().neg(self)

    def __abs__(self):
        return _ops().abs(self)

    def __invert__(self):
        return _ops().logical_not(self) if self.dtype == torch.bool \
            else _ops().bitwise_not(self)

    def __and__(self, o):
        return _ops().bitwise_and(self, o)

    def __or__(self, o):
        return _ops().bitwise_or(self, o)

    def __xor__(self, o):
        return _ops().bitwise_xor(self, o)

    def __eq__(self, o):
        return _ops().equal(self, o)

    def __ne__(self, o):
        return _ops().not_equal(self, o)

    def __lt__(self, o):
        return _ops().less_than(self, o)

    def __le__(self, o):
        return _ops().less_equal(self, o)

    def __gt__(self, o):
        return _ops().greater_than(self, o)

    def __ge__(self, o):
        return _ops().greater_equal(self, o)

    def __getitem__(self, idx):
        return _ops().getitem(self, idx)

    def __setitem__(self, idx, value):
        return _ops().setitem(self, idx, value)

    def __iadd__(self, o):
        return _ops().add_(self, o)

    def __isub__(self, o):
        return _ops().subtract_(self, o)

    def __imul__(self, o):
        return _ops().multiply_(self, o)

    def __itruediv__(self, o):
        return _ops().divide_(self, o)


def to_torch(data, dtype, place) -> torch.Tensor:
    """Host data (Python scalars and lists, numpy arrays, torch tensors) ->
    a torch tensor on ``place`` (the current device when None), with
    Paddle's dtype defaults: a Python float, or a float list, takes the
    default dtype; a Python int int64; a numpy array keeps its dtype."""
    want = dtype_mod.convert_dtype(dtype) if dtype is not None else None
    dev = device_mod._parse(place) if place is not None else None
    if isinstance(data, torch.Tensor):
        out = data.detach()
        if want is not None:
            out = out.to(want)
        return out if dev is None else out.to(dev)
    if dev is None:
        dev = device_mod.current_device()
    if isinstance(data, (bool, int, float, complex)):
        if want is None:
            if isinstance(data, bool):
                want = dtype_mod.bool_
            elif isinstance(data, int):
                want = dtype_mod.int64
            elif isinstance(data, float):
                want = dtype_mod.get_default_dtype()
            else:
                want = dtype_mod.complex64
        return torch.tensor(data, dtype=want, device=dev)
    explicit_np = isinstance(data, np.ndarray) or np.isscalar(data)
    if isinstance(data, (list, tuple)) and data and \
            all(isinstance(x, Tensor) for x in data):
        return torch.stack([x._data for x in data]).to(dev)
    arr = np.asarray(data)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        t = torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16)
    else:
        if want is None and arr.dtype == np.float64 and not explicit_np:
            want = dtype_mod.get_default_dtype()
        t = torch.from_numpy(np.array(arr, order="C"))
    if want is not None:
        t = t.to(want)
    return t.to(dev)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new Tensor from Python data, numpy or a
    Tensor (a copy, with no history), on ``place`` or the current
    device."""
    if isinstance(data, Tensor):
        arr = data._data.detach()
        if dtype is not None:
            arr = arr.to(dtype_mod.convert_dtype(dtype))
        if place is not None:
            arr = arr.to(device_mod._parse(place))
        return Tensor(arr.clone(), stop_gradient=stop_gradient,
                      _internal=True)
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


class Parameter(Tensor):
    """A trainable Tensor (``paddle.fluid.framework.Parameter``): its torch
    tensor is a leaf with ``requires_grad=True``, or without when
    ``trainable=False``."""

    def __init__(self, data, dtype=None, stop_gradient=False, trainable=True):
        super().__init__(data, dtype=dtype, stop_gradient=not trainable
                         if trainable is not None else stop_gradient)
        self.persistable = True

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v):
        self.stop_gradient = not v


def unwrap(x):
    """The torch tensor of a Tensor (a torch tensor as it is)."""
    return x._data if isinstance(x, Tensor) else x


def torch_state(layer) -> dict:
    """``{name: torch tensor}`` of a Layer's ``state_dict()``, detached:
    what torch-side consumers (the serving engine, the scanned train step,
    checkpoints) read of a Paddle model."""
    return {k: unwrap(v).detach() for k, v in layer.state_dict().items()}
