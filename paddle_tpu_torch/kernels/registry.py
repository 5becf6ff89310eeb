"""Kernel registry of the port: named op -> its impls -> the impl one call
takes (counterpart of `paddle_tpu/kernels/registry.py`, reduced to the ops
of the ported slices: serving's two paged-attention ops and fused sampler,
training's flash attention and hidden dropout, and the fused layernorm and
rotary embedding of `incubate.nn`).

The JAX registry chooses among impls by a forced flag, a viability probe
and a measured winner. Here the choice is the tensor's device and nothing
else: a tensor on the CPU takes ``plain`` (the PyTorch version), a CUDA
tensor takes ``cuda`` (the hand-written kernel) and never falls back. An
op whose one impl is ``torch`` (the sampler, which the JAX package also
computes outside any kernel) takes it on either device.
Every resolution counts ``kernel.dispatch.{op}.{impl}``. PyTorch runs
eagerly, so this counts calls, where the JAX counter counts program
builds.
"""
from __future__ import annotations

import torch

__all__ = ["OPS", "dispatch", "counts", "reset_counts", "add_counts"]

OPS = {
    "paged_attention": ("plain", "cuda"),
    "prefill_attention": ("plain", "cuda"),
    "flash_attention": ("plain", "cuda"),
    "fused_layernorm": ("plain", "cuda"),
    "fused_rope": ("plain", "cuda"),
    "fused_dropout": ("plain", "cuda"),
    "fused_sampling": ("torch",),
}

_COUNTS: dict[str, int] = {}


def dispatch(op: str, tensor: torch.Tensor) -> str:
    """The impl ``op`` takes for ``tensor``, counted."""
    if op not in OPS:
        raise KeyError(f"unknown kernel op {op!r}; registered: {sorted(OPS)}")
    if tensor.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel op {op!r} has no impl for device "
                         f"{tensor.device}; expected cpu or cuda")
    if OPS[op] == ("torch",):
        impl = "torch"
    else:
        impl = "plain" if tensor.device.type == "cpu" else "cuda"
    name = f"kernel.dispatch.{op}.{impl}"
    _COUNTS[name] = _COUNTS.get(name, 0) + 1
    return impl


def counts() -> dict[str, int]:
    """``{"kernel.dispatch.{op}.{impl}": calls}`` since the last reset."""
    return dict(_COUNTS)


def reset_counts():
    _COUNTS.clear()


def add_counts(deltas: dict[str, int]):
    """Add ``{"kernel.dispatch.{op}.{impl}": calls}`` to the counts: a
    replayed CUDA graph's dispatches, which ran in Python only while it was
    captured (`inference/graphs.py`)."""
    for name, n in deltas.items():
        _COUNTS[name] = _COUNTS.get(name, 0) + n
