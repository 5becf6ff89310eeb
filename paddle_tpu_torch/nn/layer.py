"""``nn.Layer``, the module system (counterpart of `paddle_tpu/nn/layer.py`).

A Layer holds Paddle Parameters, buffers and sublayers; ``parameters()``,
``state_dict()`` and ``set_state_dict()`` give and take Paddle Tensors, as
the JAX package's do. It does not subclass ``torch.nn.Module``, whose
``parameters()`` and ``state_dict()`` mean torch tensors. Torch code that
consumes a Layer's weights reads them with `core.tensor.torch_state`.
Parameters are created on the current device (`device.set_device`).
"""
from __future__ import annotations

import collections
import itertools
from typing import Iterator

import numpy as np
import torch

from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.tensor import Parameter, Tensor, to_torch

__all__ = ["Layer", "HookRemoveHelper"]

_param_name_counter = itertools.count()


class HookRemoveHelper:
    def __init__(self, hooks: dict, hook_id: int):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class Layer:
    def __init__(self, name_scope=None, dtype=None):
        self.training = True
        self._dtype = dtype
        self._parameters: dict = collections.OrderedDict()
        self._buffers: dict = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._sub_layers: dict = collections.OrderedDict()
        self._forward_pre_hooks: dict = collections.OrderedDict()
        self._forward_post_hooks: dict = collections.OrderedDict()
        self._hook_counter = 0
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # ------------------------------------------------------- registration

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning parameters")
            for d in (layers, buffers):
                if d is not None:
                    d.pop(name, None)
            params[name] = value
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning sublayers")
            for d in (params, buffers):
                if d is not None:
                    d.pop(name, None)
            layers[name] = value
            self.__dict__.pop(name, None)
        elif buffers is not None and name in buffers:
            if value is None or isinstance(value, Tensor):
                buffers[name] = value
            else:
                buffers[name].set_value(value)
        else:
            if params is not None and name in params and value is None:
                params.pop(name)
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter requires a Parameter")
        self._parameters[str(name)] = parameter
        return parameter

    def register_buffer(self, name, tensor, persistable=True):
        if tensor is not None:
            tensor.persistable = True
        self._buffers[str(name)] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(str(name))
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new Parameter drawn by ``attr``'s initializer (else
        ``default_initializer``, else zeros for a bias and Xavier-uniform
        for a weight), named uniquely unless ``attr`` names it."""
        from paddle_tpu_torch.framework.param_attr import ParamAttr
        from paddle_tpu_torch.nn import initializer as I
        dtype = dtype_mod.convert_dtype(dtype or self._dtype)
        init, trainable = None, True
        if isinstance(attr, ParamAttr):
            init, trainable = attr.initializer, attr.trainable
        elif callable(attr):
            init = attr
        if init is None:
            init = default_initializer or (
                I.Constant(0.0) if is_bias else I.XavierUniform())
        shape = tuple(int(s) for s in shape)
        data = torch.empty(shape, dtype=dtype,
                           device=device_mod.current_device()) \
            if I.drawing_skipped() else init(shape, dtype)
        p = Parameter(data, trainable=trainable)
        if isinstance(attr, ParamAttr):
            p.need_clip = attr.need_clip
            if attr.learning_rate != 1.0:
                p.optimize_attr = {"learning_rate": attr.learning_rate}
        if isinstance(attr, ParamAttr) and attr.name:
            p.name = attr.name
        else:
            kind = "b" if is_bias else "w"
            p.name = f"{self._name_scope}_{next(_param_name_counter)}.{kind}_0"
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None):
        return Tensor(torch.zeros((), dtype=dtype_mod.convert_dtype(
            dtype or self._dtype), device=device_mod.current_device()),
            _internal=True)

    # ------------------------------------------------------- iteration

    def parameters(self, include_sublayers=True) -> list:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True
                         ) -> Iterator[tuple]:
        seen = set()
        for name, layer in self._traverse(prefix, include_sublayers):
            for pname, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{name}.{pname}" if name else pname), p

    def buffers(self, include_sublayers=True) -> list:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for name, layer in self._traverse(prefix, include_sublayers):
            for bname, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{name}.{bname}" if name else bname), b

    def _traverse(self, prefix="", include_sublayers=True):
        yield prefix, self
        if include_sublayers:
            for name, sub in self._sub_layers.items():
                if sub is None:
                    continue
                yield from sub._traverse(
                    f"{prefix}.{name}" if prefix else name, True)

    def children(self) -> Iterator["Layer"]:
        for _, sub in self.named_children():
            yield sub

    def named_children(self):
        for name, sub in self._sub_layers.items():
            if sub is not None:
                yield name, sub

    def sublayers(self, include_self=False) -> list:
        out = [layer for _, layer in self._traverse("", True)]
        return out if include_self else out[1:]

    def named_sublayers(self, prefix="", include_self=False):
        for name, layer in self._traverse(prefix, True):
            if not include_self and layer is self:
                continue
            yield name, layer

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def full_name(self):
        return self._name_scope

    # ------------------------------------------------------- modes

    def train(self):
        self.training = True
        for sub in self.sublayers():
            sub.training = True
        return self

    def eval(self):
        self.training = False
        for sub in self.sublayers():
            sub.training = False
        return self

    # ------------------------------------------------------- hooks

    def register_forward_pre_hook(self, hook):
        self._hook_counter += 1
        self._forward_pre_hooks[self._hook_counter] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_counter)

    def register_forward_post_hook(self, hook):
        self._hook_counter += 1
        self._forward_post_hooks[self._hook_counter] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_counter)

    # ------------------------------------------------------- call

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in tuple(self._forward_pre_hooks.values()):
            res = hook(self, inputs)
            if res is not None:
                inputs = res if isinstance(res, tuple) else (res,)
        out = self.forward(*inputs, **kwargs)
        for hook in tuple(self._forward_post_hooks.values()):
            res = hook(self, inputs, out)
            if res is not None:
                out = res
        return out

    # ------------------------------------------------------- state

    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None \
            else collections.OrderedDict()
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p
        for name, layer in self._traverse("", include_sublayers):
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistable_buffer_names:
                    continue
                full = f"{name}.{bname}" if name else bname
                dest[structured_name_prefix + full] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load values (Tensors, torch tensors or arrays) into the existing
        parameters and buffers by key, shape-checked, each cast to its
        target's dtype and device. Returns (missing, unexpected) keys."""
        own = self.state_dict()
        missing, unexpected = [], []
        for key, target in own.items():
            if key not in state_dict:
                missing.append(key)
                continue
            v = state_dict[key]
            if isinstance(v, Tensor):
                arr = v._data
            elif isinstance(v, torch.Tensor):
                arr = v
            else:
                arr = to_torch(np.asarray(v), None, target._data.device)
            if tuple(arr.shape) != tuple(target._data.shape):
                raise ValueError(
                    f"shape mismatch for {key}: checkpoint "
                    f"{tuple(arr.shape)} vs parameter "
                    f"{tuple(target._data.shape)}")
            target._write(arr.detach().to(target._data.device,
                                          target._data.dtype))
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict

    # ------------------------------------------------------- dtype/device

    def to(self, device=None, dtype=None, blocking=None):
        """Move every parameter and floating buffer to ``device`` and/or
        cast it to ``dtype``. A dtype given in the device slot (``to("bf16")``,
        ``to(torch.bfloat16)``) is taken as the dtype."""
        if device is not None and not isinstance(
                device, (torch.device, device_mod.Place)) and not (
                isinstance(device, str) and device.split(":")[0].lower() in
                ("cpu", "gpu", "cuda", "tpu")):
            device, dtype = None, device
        dev = None if device is None else device_mod._parse(device)
        d = None if dtype is None else dtype_mod.convert_dtype(dtype)
        for t in self.parameters() + self.buffers():
            a = t._data
            want_d = d if d is not None and (a.is_floating_point()) else \
                a.dtype
            want_dev = dev or a.device
            if a.dtype != want_d or a.device != want_dev:
                t._write(a.detach().to(want_dev, want_d))
        if d is not None:
            self._dtype = d
            for sub in self.sublayers():
                sub._dtype = d
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def half(self):
        return self.to(dtype="float16")

    def clear_gradients(self, set_to_zero=True):
        for p in self.parameters():
            p.clear_grad(set_to_zero)

    def __repr__(self):
        lines = []
        for name, sub in self._sub_layers.items():
            body = repr(sub).split("\n")
            body = [body[0]] + ["  " + ln for ln in body[1:]]
            lines.append(f"({name}): " + "\n".join(body))
        main = self.__class__.__name__ + "(" + self.extra_repr()
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"

    def extra_repr(self):
        return ""
