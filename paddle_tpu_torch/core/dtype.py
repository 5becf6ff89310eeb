"""Dtypes (counterpart of `paddle_tpu/core/dtype.py`).

Paddle's dtype names map onto torch dtypes: ``paddle_tpu_torch.float32`` is
``torch.float32`` and a `Tensor`'s ``dtype`` is its torch tensor's. Every
spelling the JAX package accepts converts here too: a name or alias
(``"float32"``, ``"fp16"``, ``"int"``), a numpy dtype, a Python type
(``float`` is the default dtype, ``int`` int64), or a torch dtype.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "set_default_dtype", "get_default_dtype", "convert_dtype",
           "dtype_name", "is_floating", "is_integer", "is_complex", "finfo",
           "iinfo", "to_numpy_dtype"]

_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
}

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(f"default dtype must be a floating dtype, got {d}")
    _default_dtype = d


def get_default_dtype() -> torch.dtype:
    return _default_dtype


def convert_dtype(d) -> torch.dtype:
    """Any dtype spec -> a torch dtype; None is the default dtype."""
    if d is None:
        return _default_dtype
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        name = _ALIASES.get(d, d)
        if name in _NAME_TO_DTYPE:
            return _NAME_TO_DTYPE[name]
        return convert_dtype(np.dtype(name))
    if d is float:
        return _default_dtype
    if d is int:
        return int64
    if d is bool:
        return bool_
    if d is complex:
        return complex64
    name = np.dtype(d).name           # numpy types and dtypes, ml_dtypes'
    if name not in _NAME_TO_DTYPE:
        raise TypeError(f"unsupported dtype {d!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(d) -> str:
    """The Paddle name of a dtype: ``"float32"``, ``"bool"``..."""
    return _DTYPE_TO_NAME[convert_dtype(d)]


def to_numpy_dtype(d) -> np.dtype:
    """The numpy dtype of the same name (bfloat16 has none in numpy and
    raises TypeError)."""
    name = dtype_name(d)
    if name not in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        return np.dtype(name)
    raise TypeError(f"{name} has no numpy dtype")


def is_floating(d) -> bool:
    return convert_dtype(d).is_floating_point


def is_integer(d) -> bool:
    d = convert_dtype(d)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def is_complex(d) -> bool:
    return convert_dtype(d).is_complex


def is_inexact(d) -> bool:
    d = convert_dtype(d)
    return d.is_floating_point or d.is_complex


def finfo(d):
    return torch.finfo(convert_dtype(d))


def iinfo(d):
    return torch.iinfo(convert_dtype(d))


def promote_types(a, b) -> torch.dtype:
    """numpy's promotion of two dtypes (the JAX package promotes
    tensor-tensor pairs with ``np.promote_types`` where one is not float)."""
    return torch.promote_types(convert_dtype(a), convert_dtype(b))
