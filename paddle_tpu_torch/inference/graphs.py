"""Captured CUDA graphs of the engine's step programs: the PyTorch
counterpart of the JAX engine's AOT-compiled step executables
(`paddle_tpu/inference/engine.py::_compiled`).

A :class:`StepGraph` captures ONE step body, a function with no arguments
that reads only tensors which keep their identity between steps (the
engine's packed-state or packed-prefill buffer, its pools, weights, token
and key buffers) and writes its results into such tensors with
``copy_``. Each call replays the graph: the step's hundreds of kernels go
to the card in one ``cudaGraphLaunch``.

Capture follows PyTorch's recipe. The body runs eagerly ``WARMUP_RUNS``
times on the device's capture stream first, so that what it caches per
stream (cuBLAS workspaces, the tickets of the split decode loop and of
the CUDA-core prefill loop, `kernels/cuda/paged_attention.py::_tickets`)
exists outside the graph's
private memory pool; then one more run is captured on that stream, in
the thread-local capture mode: only the capturing thread is barred from
CUDA calls that would break a capture, so an engine loop may capture
while other threads of its process (a server's, a watchdog's) run. A
failed capture raises: there is no eager fallback on the card.

The engine's prefill and chunk graphs of one engine share one memory pool
(``pool``, a `torch.cuda.graph_pool_handle`): they are replayed one at a
time on one stream and their results leave through engine-owned buffers
(the pools, the key chains, a token buffer) or are read before the next
replay, so no graph needs its temporaries kept from one replay to the
next. The decode and verify graph keeps a pool of its own.

Every graph of a device is captured on ONE side stream,
:func:`capture_stream`: cuBLAS keeps a 32 MiB workspace for each stream it
has run on for the life of the process, so a stream per engine would leave
32 MiB behind per engine (PyTorch's pool of 32 streams a device bounds
that at 1 GiB). The graphs therefore share that stream's cuBLAS
workspace, which each reads when it replays: replay them on one stream
at a time (the engine replays on the caller's current stream, the
legacy default stream unless the caller set another). The engines of
one process (replicas behind a router, each on a serve thread of its
own) share it too, and a graph's warm-up runs use it: the warm-up runs
and capture of a graph, and every replay, take turns
(`_CAPTURE_LOCK`).

Launch counts. `kernels/_build.py::CudaKernel.launch` and
`kernels/registry.py::dispatch` count in Python, so a replay would count
nothing. The capture records each kernel's and each dispatch counter's
increase while the body is captured, and every replay adds exactly that.
The warm-up runs and the capture itself leave every count as it was: they
belong to no step of the engine. They count in the capturing thread's own
tally (`registry.capturing`), so launches that other threads make
meanwhile, another engine of the process serving, still count; so does
what the autograd engine's thread launches on the capture stream for a
captured backward (`jit.to_static`'s train steps).
"""
from __future__ import annotations

import functools
import threading

import torch

from paddle_tpu_torch.kernels import registry

__all__ = ["StepGraph", "WARMUP_RUNS", "capture_stream"]

WARMUP_RUNS = 2
# one graph's warm-up runs and capture, or one replay, at a time in the
# process: the warm-up runs use the capture stream's cuBLAS workspace,
# which the graphs captured on that stream use again when they replay
_CAPTURE_LOCK = threading.RLock()


@functools.lru_cache(maxsize=None)
def capture_stream(device) -> torch.cuda.Stream:
    """The one side stream every step graph of ``device`` is captured on."""
    return torch.cuda.Stream(device)


class StepGraph:
    """One step body captured as a CUDA graph on ``device``'s
    :func:`capture_stream`. ``outputs`` is what the captured run of the body
    returned: tensors of the graph's pool that every replay rewrites.
    Calling the graph replays it on the current stream, adds the capture's
    launch and dispatch counts, and returns ``outputs``; arguments are
    ignored, since the graph's inputs are the tensors it was captured
    over. The body itself is not kept. ``pool``: a memory pool shared with
    other graphs (`torch.cuda.graph_pool_handle`), or None for a private
    one. ``warmup_runs``: the eager runs before the capture; a caller whose
    body's earlier runs were real steps on the capture stream already
    (`jit.to_static`'s) passes 0."""

    def __init__(self, body, device, pool=None, warmup_runs=WARMUP_RUNS):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        stream = capture_stream(device)
        # the warm-up runs and the capture count in this thread's tally
        # only, never the shared counts or the metrics registry; the
        # capture's share of it is what a replay adds
        with _CAPTURE_LOCK, registry.capturing(stream) as cap:
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for _ in range(warmup_runs):
                    body()
            start = {k: dict(v) for k, v in cap.tally.items()}
            self.graph = torch.cuda.CUDAGraph()
            # synchronizes the device before capture begins; a CUDA call
            # of another thread (a server's, while its engine loop
            # captures) cannot invalidate this capture
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.outputs = body()
        self.kernel_launches, self.dispatches = (
            {k: n - start[part].get(k, 0)
             for k, n in cap.tally[part].items()
             if n != start[part].get(k, 0)}
            for part in ("launches", "dispatches"))
        self.replays = 0

    def __call__(self, *_):
        with _CAPTURE_LOCK:
            self.graph.replay()
        for k, n in self.kernel_launches.items():
            k.launches += n
        registry.add_counts(self.dispatches)
        self.replays += 1
        return self.outputs
