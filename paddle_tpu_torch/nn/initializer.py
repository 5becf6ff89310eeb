"""Weight initializers (counterpart of `paddle_tpu/nn/initializer.py`).

Each is a callable ``(shape, dtype) -> torch tensor`` on the current device
(`device.set_device`), drawn from the global generator's next key (the
Paddle seed stream, `ops/random.py`) with the JAX package's distribution,
so a Layer built after ``paddle.seed(s)`` in either package creates the
same weights, parameter for parameter, when it creates them in the same
order.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.ops.random import default_generator

__all__ = ["skip_draws", "drawing_skipped", "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierUniform", "XavierNormal", "KaimingUniform", "KaimingNormal",
           "Assign", "Dirac", "Orthogonal", "calculate_gain"]


_SKIP = [False]


@contextlib.contextmanager
def skip_draws():
    """Parameters created inside get uninitialized storage and draw
    nothing from the stream: for a caller that fills every parameter
    itself (`models/gpt.py::GPTForCausalLM` with a ``generator``)."""
    prev, _SKIP[0] = _SKIP[0], True
    try:
        yield
    finally:
        _SKIP[0] = prev


def drawing_skipped() -> bool:
    return _SKIP[0]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]          # Linear weights are [in, out]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _key():
    return default_generator().next_key(device_mod.current_device())


def _dt(dtype):
    return dtype_mod.convert_dtype(dtype)


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=_dt(dtype),
                          device=device_mod.current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return self.mean + self.std * prng.normal(_key(), tuple(shape),
                                                  _dt(dtype))


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        return self.mean + self.std * prng.truncated_normal(
            _key(), self.a, self.b, tuple(shape), _dt(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return prng.uniform(_key(), tuple(shape), self.low, self.high,
                            _dt(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return prng.uniform(_key(), tuple(shape), -limit, limit, _dt(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return std * prng.normal(_key(), tuple(shape), _dt(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return math.sqrt(2.0)

    def __call__(self, shape, dtype):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        limit = self._gain() * math.sqrt(3.0 / fi)
        return prng.uniform(_key(), tuple(shape), -limit, limit, _dt(dtype))


class KaimingNormal(KaimingUniform):
    def __call__(self, shape, dtype):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        std = self._gain() / math.sqrt(fi)
        return std * prng.normal(_key(), tuple(shape), _dt(dtype))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        from paddle_tpu_torch.core.tensor import to_torch, unwrap
        v = unwrap(self.value)
        arr = v if isinstance(v, torch.Tensor) else to_torch(v, None, None)
        if tuple(arr.shape) != tuple(shape):
            arr = arr.reshape(tuple(shape))
        return arr.to(device_mod.current_device(), _dt(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        mins = min(oc // self.groups, ic)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(mins):
                out[(g * (oc // self.groups) + i, i) + tuple(centers)] = 1.0
        return torch.from_numpy(out).to(device_mod.current_device(),
                                        _dt(dtype))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = prng.normal(_key(), (max(rows, cols), min(rows, cols)))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)).to(
            _dt(dtype))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0
