"""Devices (counterpart of `paddle_tpu/device/__init__.py`).

`set_device` picks where new tensors and parameters go: ``"gpu"`` /
``"gpu:N"`` (also ``"cuda"``, ``"cuda:N"``) for a CUDA card, ``"cpu"`` for
the host. Until it is called, new tensors go to the card, and on a machine
without CUDA creating one raises RuntimeError naming
``set_device("cpu")``: nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "CUDAPinnedPlace",
           "set_device", "get_device", "current_device", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_rocm",
           "is_compiled_with_xpu", "is_compiled_with_custom_device",
           "is_compiled_with_distribute", "synchronize",
           "max_memory_allocated", "memory_allocated",
           "max_memory_reserved", "memory_reserved", "cuda", "Stream",
           "Event", "current_stream", "stream_guard", "device_scope"]


class Place:
    def __init__(self, kind: str, device_id: int = 0):
        self._kind = kind
        self._id = device_id

    def __repr__(self):
        return f"Place({self._kind}:{self._id})"

    def __eq__(self, other):
        return isinstance(other, Place) and (self._kind, self._id) == \
            (other._kind, other._id)

    def __hash__(self):
        return hash((self._kind, self._id))

    def is_cpu_place(self):
        return self._kind == "cpu"

    def is_gpu_place(self):
        return self._kind == "gpu"

    def is_tpu_place(self):
        return False

    def get_device_id(self):
        return self._id

    def torch_device(self) -> torch.device:
        return torch.device("cpu") if self._kind == "cpu" \
            else torch.device("cuda", self._id)


def CPUPlace():
    return Place("cpu", 0)


def CUDAPlace(device_id=0):
    return Place("gpu", int(device_id))


TPUPlace = CUDAPlace      # scripts written for the JAX package run on the card
CUDAPinnedPlace = CPUPlace

_current: torch.device | None = None


def _parse(device) -> torch.device:
    if isinstance(device, Place):
        return device.torch_device()
    if isinstance(device, torch.device):
        return device
    dev = str(device).lower()
    kind, _, idx = dev.partition(":")
    if kind == "cpu":
        return torch.device("cpu")
    if kind in ("gpu", "cuda", "tpu"):
        return torch.device("cuda", int(idx or 0))
    raise ValueError(f"set_device: unknown device {device!r}; expected "
                     "'cpu', 'gpu', 'gpu:N' or 'cuda:N'")


def set_device(device):
    """Make ``device`` the place of new tensors; returns its name."""
    global _current
    _current = _parse(device)
    return get_device()


def current_device() -> torch.device:
    """The torch device new tensors go to: the one `set_device` chose, else
    the card. With neither, raises RuntimeError."""
    if _current is not None:
        return _current
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch puts new tensors on the CUDA card by default "
            "and CUDA is not available here; call "
            "paddle_tpu_torch.set_device(\"cpu\") to run on the CPU with the "
            "plain PyTorch kernels")
    return torch.device("cuda", torch.cuda.current_device())


def get_device() -> str:
    """``"cpu"`` or ``"gpu:N"``: where new tensors go."""
    d = current_device()
    return "cpu" if d.type == "cpu" else f"gpu:{d.index or 0}"


def place_of(t: torch.Tensor) -> Place:
    return CPUPlace() if t.device.type == "cpu" \
        else CUDAPlace(t.device.index or 0)


def device_count():
    return torch.cuda.device_count()


def is_compiled_with_cuda():
    return torch.version.cuda is not None


def is_compiled_with_rocm():
    return False


def is_compiled_with_xpu():
    return False


def is_compiled_with_custom_device(device_type="gpu"):
    return False


def is_compiled_with_distribute():
    return True


def synchronize(device=None):
    """Wait for the card's queued work (a no-op without CUDA)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def max_memory_allocated(device=None):
    return int(torch.cuda.max_memory_allocated(device)) \
        if torch.cuda.is_available() else 0


def memory_allocated(device=None):
    return int(torch.cuda.memory_allocated(device)) \
        if torch.cuda.is_available() else 0


def max_memory_reserved(device=None):
    return int(torch.cuda.max_memory_reserved(device)) \
        if torch.cuda.is_available() else 0


def memory_reserved(device=None):
    return int(torch.cuda.memory_reserved(device)) \
        if torch.cuda.is_available() else 0


class Stream:
    """A CUDA stream of the card (``torch.cuda.Stream``)."""

    def __init__(self, device=None, priority=0):
        self._s = torch.cuda.Stream(device=device, priority=priority)

    def synchronize(self):
        self._s.synchronize()

    def wait_stream(self, stream):
        self._s.wait_stream(stream._s if isinstance(stream, Stream)
                            else stream)

    def wait_event(self, event):
        self._s.wait_event(event._e if isinstance(event, Event) else event)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event


class Event:
    """A CUDA event (``torch.cuda.Event``)."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self._e = torch.cuda.Event(enable_timing=enable_timing,
                                   blocking=blocking,
                                   interprocess=interprocess)

    def record(self, stream=None):
        self._e.record(stream._s if isinstance(stream, Stream) else stream)

    def query(self):
        return self._e.query()

    def synchronize(self):
        self._e.synchronize()

    def elapsed_time(self, end):
        return self._e.elapsed_time(end._e)


def current_stream(device=None):
    s = Stream.__new__(Stream)
    s._s = torch.cuda.current_stream(device)
    return s


@contextlib.contextmanager
def stream_guard(stream):
    with torch.cuda.stream(stream._s if isinstance(stream, Stream)
                           else stream):
        yield


class cuda:
    """``paddle.device.cuda``: the card's memory counters and sync."""

    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_allocated = staticmethod(memory_allocated)
    max_memory_reserved = staticmethod(max_memory_reserved)
    memory_reserved = staticmethod(memory_reserved)
    device_count = staticmethod(device_count)
    synchronize = staticmethod(synchronize)

    @staticmethod
    def empty_cache():
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


@contextlib.contextmanager
def device_scope(device):
    """Put new tensors on ``device`` inside the block (``set_device`` for
    its duration; None leaves the current choice)."""
    global _current
    prev = _current
    if device is not None:
        _current = _parse(device)
    try:
        yield
    finally:
        _current = prev
