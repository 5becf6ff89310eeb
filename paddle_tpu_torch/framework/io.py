"""`save` / `load` of nested dicts and lists of tensors in the JAX
package's single-file format (counterpart of `paddle_tpu/framework/io.py`,
``paddle.save`` / ``paddle.load``; the port imports nothing from it).

Layout (little-endian): ``PDTPU001`` | u64 tree length | the pickled tree,
each tensor replaced by a ``_TensorRef(idx, is_param, stop_gradient,
name)`` | u32 tensor count | per tensor a u64 length and an ``np.save``
payload. The JAX tree names its placeholder class
``paddle_tpu.framework.io._TensorRef``: this module writes that name into
the stream without importing it, and its unpickler maps it to its own
class and refuses every other global of the JAX package, so a file from
either package loads in the other.

bfloat16: ``np.save`` of the JAX package's ``ml_dtypes`` array writes the
descriptor ``<V2`` (two raw bytes an element, the dtype's name lost). The
only two-byte void the JAX package writes is bfloat16, so `load` reads a
``V2`` payload as ``torch.bfloat16`` of the same bits (``return_numpy``:
the ``V2`` array as the JAX `load` gives it), and `save` writes a
bfloat16 tensor as the same ``<V2`` bytes.
"""
from __future__ import annotations

import io as _io
import os
import pickle
import struct

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Parameter, Tensor

__all__ = ["save", "load"]

_MAGIC = b"PDTPU001"
_REF_GLOBAL = ("paddle_tpu.framework.io", "_TensorRef")
_V2 = np.dtype("V2")


class _TensorRef:
    """The tree's placeholder for tensor ``idx``; the JAX class's slots, in
    its order, so that both packages pickle it alike."""
    __slots__ = ("idx", "is_param", "stop_gradient", "name")

    def __init__(self, idx, is_param, stop_gradient, name):
        self.idx = idx
        self.is_param = is_param
        self.stop_gradient = stop_gradient
        self.name = name


class _Pickler(pickle._Pickler):
    """Pickles `_TensorRef` under the JAX package's global name (the C
    pickler would import that module to check the name)."""

    def save_global(self, obj, name=None):
        if obj is not _TensorRef:
            return super().save_global(obj, name)
        self.save(_REF_GLOBAL[0])
        self.save(_REF_GLOBAL[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _REF_GLOBAL:
            return _TensorRef
        if module.split(".")[0] == "paddle_tpu":
            raise pickle.UnpicklingError(
                f"refusing the JAX package's global {module}.{name}: only "
                f"its _TensorRef placeholder is read")
        return super().find_class(module, name)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_V2)
    return t.numpy()


def _npy(arr: np.ndarray) -> bytes:
    buf = _io.BytesIO()
    if arr.dtype == _V2:
        # the ``<V2`` descriptor the JAX package's bfloat16 arrays get
        header = np.lib.format.header_data_from_array_1_0(arr)
        header["descr"] = "<V2"
        np.lib.format.write_array_header_1_0(buf, header)
        buf.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _pack(obj):
    tensors = []

    def convert(o):
        if isinstance(o, Tensor):
            tensors.append(_to_numpy(o._data))
            return _TensorRef(len(tensors) - 1, isinstance(o, Parameter),
                              bool(o.stop_gradient), o.name or "")
        if isinstance(o, torch.Tensor):
            tensors.append(_to_numpy(o))
            return _TensorRef(len(tensors) - 1,
                              isinstance(o, torch.nn.Parameter),
                              not o.requires_grad, "")
        if isinstance(o, dict):
            return {k: convert(v) for k, v in o.items()}
        if isinstance(o, list):
            return [convert(v) for v in o]
        if isinstance(o, tuple):
            return tuple(convert(v) for v in o)
        return o

    return convert(obj), tensors


def _unpack(obj, tensors, return_numpy=False):
    def convert(o):
        if isinstance(o, _TensorRef):
            arr = tensors[o.idx]
            if return_numpy:
                return arr
            if arr.dtype == _V2:
                return torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            return torch.from_numpy(arr.copy())
        if isinstance(o, dict):
            return {k: convert(v) for k, v in o.items()}
        if isinstance(o, list):
            return [convert(v) for v in o]
        if isinstance(o, tuple):
            return tuple(convert(v) for v in o)
        return o

    return convert(obj)


def save(obj, path, protocol=4):
    """Write a nested structure of tensors (torch tensors or Paddle
    Tensors; or a Layer or module, as its ``state_dict()``) to one
    ``PDTPU001`` file."""
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        obj = obj.state_dict()
    tree, tensors = _pack(obj)
    buf = _io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(tree)
    meta = buf.getvalue()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(meta)))
        f.write(meta)
        f.write(struct.pack("<I", len(tensors)))
        for arr in tensors:
            payload = _npy(arr)
            f.write(struct.pack("<Q", len(payload)))
            f.write(payload)


def load(path, return_numpy=False):
    """Read a file `save` or the JAX ``paddle.save`` wrote: tensors come
    back as CPU torch tensors, or as numpy arrays with ``return_numpy``. A
    file without the magic is read as a plain pickle, as the JAX `load`
    does, through the same unpickler (no JAX package global)."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            f.seek(0)
            return _Unpickler(f).load()
        (meta_len,) = struct.unpack("<Q", f.read(8))
        tree = _Unpickler(_io.BytesIO(f.read(meta_len))).load()
        (n,) = struct.unpack("<I", f.read(4))
        tensors = []
        for _ in range(n):
            (plen,) = struct.unpack("<Q", f.read(8))
            tensors.append(np.load(_io.BytesIO(f.read(plen)),
                                   allow_pickle=False))
    return _unpack(tree, tensors, return_numpy=return_numpy)
