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
Every resolution counts ``kernel.dispatch.{op}.{impl}`` twice: in the
port's metrics registry (`observability/__init__.py`, cumulative, as the
JAX counter is) and in this module's own counts, which `counts` reads
and `reset_counts` sets to 0 (`chip_smoke.py` zeroes them around a
path's run). PyTorch runs eagerly, so this counts calls, where the JAX
counter counts program builds. The warm-up and capture runs of a CUDA
graph count in neither (`inference/graphs.py`: `capturing`, then
`restore_counts`); each replay adds the capture's counts to both
(`add_counts`).
"""
from __future__ import annotations

import threading

import torch

from paddle_tpu_torch.observability import metrics

__all__ = ["OPS", "dispatch", "counts", "reset_counts", "add_counts",
           "capturing", "restore_counts"]

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
# a thread inside `capturing` counts into _COUNTS only: the graph's
# capture reads its dispatches from there and then restores them
_LOCAL = threading.local()


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
    if not getattr(_LOCAL, "capturing", False):
        metrics.counter(name).inc()
    return impl


def counts() -> dict[str, int]:
    """``{"kernel.dispatch.{op}.{impl}": calls}`` since the last reset."""
    return dict(_COUNTS)


def reset_counts():
    _COUNTS.clear()


def add_counts(deltas: dict[str, int]):
    """Add ``{"kernel.dispatch.{op}.{impl}": calls}`` to the counts and the
    metrics registry: a replayed CUDA graph's dispatches, which ran in
    Python only while it was captured (`inference/graphs.py`)."""
    for name, n in deltas.items():
        _COUNTS[name] = _COUNTS.get(name, 0) + n
        metrics.counter(name).inc(n)


class capturing:
    """Context: this thread's dispatches count in `counts` only, not in
    the metrics registry (a graph's warm-up and capture runs, whose counts
    `restore_counts` then takes back)."""

    def __enter__(self):
        self._was = getattr(_LOCAL, "capturing", False)
        _LOCAL.capturing = True
        return self

    def __exit__(self, *exc):
        _LOCAL.capturing = self._was
        return False


def restore_counts(snapshot: dict[str, int]):
    """Set `counts` back to ``snapshot`` (a `counts()` taken earlier),
    leaving the metrics registry as it is."""
    _COUNTS.clear()
    _COUNTS.update(snapshot)
