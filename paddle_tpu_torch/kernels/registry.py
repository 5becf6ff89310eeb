"""Kernel registry of the port: named op -> its impls -> the impl one call
takes (counterpart of `paddle_tpu/kernels/registry.py`, reduced to the ops
of the ported slices: serving's two paged-attention ops and fused sampler,
training's flash attention and hidden dropout, the fused layernorm and
rotary embedding of `incubate.nn`, and batch norm in training).

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
graph count in neither: inside `capturing` a thread counts its kernel
launches and dispatches in a tally of its own (`tally`), so another
thread's launches meanwhile (a second engine of the process serving
while this one captures) still count. A capture of a training step also
counts what the autograd engine launches for it on its own device thread:
that thread runs the backward on the stream being captured, whose tally
it takes (`capturing(stream)`). Each replay adds the capture's counts to
both (`add_counts`; `inference/graphs.py`).
"""
from __future__ import annotations

import itertools
import threading

import torch

from paddle_tpu_torch.observability import metrics

__all__ = ["OPS", "dispatch", "counts", "reset_counts", "add_counts",
           "capturing", "tally", "capture_id"]

OPS = {
    "paged_attention": ("plain", "cuda"),
    "prefill_attention": ("plain", "cuda"),
    "flash_attention": ("plain", "cuda"),
    "fused_layernorm": ("plain", "cuda"),
    "fused_rope": ("plain", "cuda"),
    "fused_dropout": ("plain", "cuda"),
    "batch_norm": ("plain", "cuda"),
    "fused_sampling": ("torch",),
}

_COUNTS: dict[str, int] = {}
# a thread inside `capturing` counts into its own tally only
_LOCAL = threading.local()
_CAPTURE_IDS = itertools.count(1)
# the tallies of the captures in progress, by the stream each captures
_STREAM_TALLY: dict[int, dict] = {}


def tally() -> dict | None:
    """This thread's tally while it is inside `capturing`: ``{"launches":
    {kernel: n}, "dispatches": {name: n}}``; else, on a stream being
    captured (the autograd engine's thread in a captured backward), that
    capture's tally; else None."""
    own = getattr(_LOCAL, "tally", None)
    if own is None and _STREAM_TALLY:
        own = _STREAM_TALLY.get(torch.cuda.current_stream().cuda_stream)
    return own


def capture_id() -> int | None:
    """The number of this thread's `capturing` context, unique in the
    process (a graph's own kernel buffers key on it,
    `kernels/cuda/paged_attention.py::_tickets`); else None."""
    return getattr(_LOCAL, "capture_id", None)


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
    own = tally()
    if own is not None:
        own["dispatches"][name] = own["dispatches"].get(name, 0) + 1
    else:
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
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
    """Context: this thread's kernel launches (`_build.CudaKernel.launch`)
    and dispatches count in a fresh tally of its own (`tally`, also the
    context's ``tally`` attribute), never in the shared counts or the
    metrics registry: a graph's warm-up and capture runs. With ``stream``
    (the stream a graph is captured on) any thread's launches on that
    stream count in the tally too. `capture_id` numbers the context."""

    def __init__(self, stream=None):
        self._stream = None if stream is None else stream.cuda_stream

    def __enter__(self):
        self._was = getattr(_LOCAL, "tally", None), capture_id()
        self.tally = {"launches": {}, "dispatches": {}}
        self.capture_id = next(_CAPTURE_IDS)
        _LOCAL.tally, _LOCAL.capture_id = self.tally, self.capture_id
        if self._stream is not None:
            _STREAM_TALLY[self._stream] = self.tally
        return self

    def __exit__(self, *exc):
        _LOCAL.tally, _LOCAL.capture_id = self._was
        if self._stream is not None:
            _STREAM_TALLY.pop(self._stream, None)
        return False
