"""ctypes binding + batch codec for the native shared-memory queue
(counterpart of `paddle_tpu/io/native_queue.py`, over the port's own copy
of `io/native/shm_queue.cpp` — the reference's C++ blocking-queue /
shared-memory DataLoader transport, `imperative/data_loader.cc`).

The library is built by ``g++`` at first use into ``io/native/libshmq.so``
(git-ignored). Its segment layout is the JAX package's, so a queue either
package creates opens in the other's.

The codec packs a (possibly nested) batch as ONE buffer: a small pickled
skeleton where each ndarray is replaced by an (offset, dtype, shape) record,
followed by the raw array bytes — decode returns numpy views into the popped
buffer (no per-array pickling). Its bytes equal the JAX codec's both ways.
Torch tensors do not travel: DataLoader workers send numpy."""
from __future__ import annotations

import ctypes
import os
import pickle
import struct
import subprocess
import uuid

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "shm_queue.cpp")
_SO = os.path.join(_HERE, "native", "libshmq.so")
_LIB = None
_LIB_ERR = None


def _build():
    # build to a unique temp path then atomically publish: concurrent ranks
    # on one host must never CDLL a half-written .so
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC, "-lpthread",
           "-lrt"]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, _SO)


def get_lib():
    """Compile (once) and load the native library; None if no toolchain."""
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.shmq_create.restype = ctypes.c_void_p
        lib.shmq_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_uint64]
        lib.shmq_open.restype = ctypes.c_void_p
        lib.shmq_open.argtypes = [ctypes.c_char_p]
        lib.shmq_push.restype = ctypes.c_int
        lib.shmq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64]
        lib.shmq_pop.restype = ctypes.c_int64
        lib.shmq_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_uint64]
        lib.shmq_pop_timed.restype = ctypes.c_int64
        lib.shmq_pop_timed.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_uint64, ctypes.c_int64]
        lib.shmq_count.restype = ctypes.c_uint64
        lib.shmq_count.argtypes = [ctypes.c_void_p]
        lib.shmq_close.argtypes = [ctypes.c_void_p]
        lib.shmq_release.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except Exception as e:   # missing g++ etc. — caller falls back to mp.Queue
        _LIB_ERR = e
        _LIB = None
    return _LIB


class ShmQueue:
    """Fixed-slot blocking MPMC queue in POSIX shared memory."""

    def __init__(self, slots=8, slot_bytes=64 << 20, name=None, create=True):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native queue unavailable: {_LIB_ERR}")
        self._lib = lib
        self.name = name or f"/pdtpu_q_{uuid.uuid4().hex[:12]}"
        self.slot_bytes = slot_bytes
        if create:
            self._h = lib.shmq_create(self.name.encode(), slots, slot_bytes)
        else:
            self._h = lib.shmq_open(self.name.encode())
        if not self._h:
            raise OSError(f"shmq_{'create' if create else 'open'} failed "
                          f"for {self.name}")

    def attach(self):
        """Open the same queue from another process."""
        return ShmQueue(slot_bytes=self.slot_bytes, name=self.name,
                        create=False)

    def push(self, payload: bytes):
        rc = self._lib.shmq_push(self._h, payload, len(payload))
        if rc == -2:
            raise ValueError(
                f"payload {len(payload)}B exceeds slot size "
                f"{self.slot_bytes}B — raise DataLoader shm_slot_bytes")
        if rc == -1:
            raise EOFError("queue closed")

    def pop(self, timeout=None):
        """Pop one payload (bytes, exact length). Waits in short native polls
        so KeyboardInterrupt stays deliverable; `timeout` (seconds) raises
        TimeoutError. The receive buffer is allocated ONCE per queue and only
        the payload bytes are copied out (not the full slot)."""
        if not hasattr(self, "_popbuf"):
            self._popbuf = (ctypes.c_char * self.slot_bytes)()
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            n = self._lib.shmq_pop_timed(self._h, self._popbuf,
                                         self.slot_bytes, 300)
            if n >= 0:
                return bytes(memoryview(self._popbuf)[:n])
            if n == -1:
                raise EOFError("queue closed and drained")
            if n == -3:
                if deadline is not None and _time.monotonic() > deadline:
                    raise TimeoutError(
                        f"shm queue pop timed out after {timeout}s")
                continue
            raise RuntimeError(f"shmq_pop error {n}")

    def qsize(self):
        return int(self._lib.shmq_count(self._h))

    def close(self):
        self._lib.shmq_close(self._h)

    def release(self):
        if self._h:
            self._lib.shmq_release(self._h)
            self._h = None


# ---------------------------------------------------------------- batch codec

_ARRAY = "__nd__"


def encode_batch(obj) -> bytes:
    arrays = []

    def strip(o):
        if isinstance(o, np.ndarray):
            if o.dtype.hasobject or o.dtype.names is not None:
                # object/structured dtypes can't ship as raw bytes — keep
                # them pickled inside the skeleton (mp.Queue-equivalent)
                return o
            arrays.append(np.ascontiguousarray(o))
            a = arrays[-1]
            return (_ARRAY, len(arrays) - 1, str(a.dtype), a.shape)
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            items = [strip(v) for v in o]
            return items if isinstance(o, list) else ("__tup__", items)
        return o

    skeleton = pickle.dumps(strip(obj), protocol=pickle.HIGHEST_PROTOCOL)
    parts = [struct.pack("<I", len(skeleton)), skeleton]
    for a in arrays:
        parts.append(a.tobytes())       # raw bytes, no per-array pickling
    return b"".join(parts)


def decode_batch(buf):
    mv = memoryview(buf)
    (skel_len,) = struct.unpack("<I", mv[:4])
    skeleton = pickle.loads(mv[4: 4 + skel_len])
    offset = 4 + skel_len
    out_arrays = {}

    def sizes(o):
        nonlocal offset
        if isinstance(o, tuple) and len(o) == 4 and o[0] == _ARRAY:
            _, idx, dtype, shape = o
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            out_arrays[idx] = np.frombuffer(
                mv[offset: offset + n], dtype=dtype).reshape(shape)
            offset += n
            return
        if isinstance(o, dict):
            for v in o.values():
                sizes(v)
        elif isinstance(o, tuple) and len(o) == 2 and o[0] == "__tup__":
            for v in o[1]:
                sizes(v)
        elif isinstance(o, list):
            for v in o:
                sizes(v)

    sizes(skeleton)

    def rebuild(o):
        if isinstance(o, tuple) and len(o) == 4 and o[0] == _ARRAY:
            return out_arrays[o[1]]
        if isinstance(o, dict):
            return {k: rebuild(v) for k, v in o.items()}
        if isinstance(o, tuple) and len(o) == 2 and o[0] == "__tup__":
            return tuple(rebuild(v) for v in o[1])
        if isinstance(o, list):
            return [rebuild(v) for v in o]
        return o

    return rebuild(skeleton)
