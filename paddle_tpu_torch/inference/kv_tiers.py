"""Host-RAM and disk spill tiers under the engine's HBM prefix store
(counterpart of `paddle_tpu/inference/kv_tiers.py`).

A prefix-cache eviction DEMOTES a page instead of dropping it:

- **Host tier**: a bounded LRU of framed page blobs in host RAM. When the
  byte bound overflows, the LRU entry demotes to the disk tier, or is
  discarded when there is no disk tier.
- **Disk tier**: a bounded directory of one file per page blob, named by
  the page-chain hash's hex. Overflow discards (and unlinks) LRU files.

Entries are keyed by the rolling page-chain hashes of the engine's prefix
store (`serving/disagg.py::prompt_page_hashes`), so a lookup continues from
HBM into the tiers.

Every blob is framed ``PTKT1\\n | u32 header_len | JSON header | body``,
byte for byte the JAX package's framing: the header carries a blake2b
checksum of the body, verified BEFORE any payload byte is interpreted, the
page geometry, the pool dtype by its numpy name (``bfloat16`` too: the
values travel as raw bytes, never through a numpy bfloat16 type), a
per-store salt and the flush epoch. A corrupt, truncated, mis-keyed or
stale blob raises the typed :class:`HandoffCorrupt` inside the store, is
counted in ``kvtier_refusals`` (an ``engine.kvtier.refused`` flight
event) and reads as a plain miss: the request prefills cold and never
sees an error.

Each count goes to the engine's ``counters`` dict and, under the JAX
package's name (``engine.kvtier.hits_host``, ...), to the port's metrics
registry, with the blob bytes spilled and the tiers' sizes
(``engine.kvtier.host_pages`` / ``host_bytes`` / ``disk_pages`` /
``disk_bytes`` gauges).

The store moves bytes only; the engine gathers and scatters the pages on
the device (`kernels/paged_attention.py::export_pages` / `import_pages`).
Pages and their int8 scales are immutable once full, so a re-uploaded page
is bit-identical to the page that was spilled.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from paddle_tpu_torch.inference.errors import HandoffCorrupt
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import flight
from paddle_tpu_torch.testing import faults

__all__ = ["KVTierStore", "TierEntry", "MAGIC"]

MAGIC = b"PTKT1\n"

# pool dtype name (the JAX header's) -> (torch dtype, numpy dtype of the
# same width that carries its raw bytes)
_DTYPES = {"float32": (torch.float32, np.float32),
           "bfloat16": (torch.bfloat16, np.int16),
           "int8": (torch.int8, np.int8)}


def dtype_name(dtype: torch.dtype) -> str:
    """A pool dtype's name in the blob header: numpy's name for it."""
    for name, (dt, _) in _DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"no KV tier encoding for {dtype}")


def _raw(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes, bfloat16 as int16 of the same bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _tensor(buf: bytes, name: str, shape) -> torch.Tensor:
    dt, carrier = _DTYPES[name]
    arr = np.frombuffer(buf, carrier).reshape(shape).copy()
    return torch.from_numpy(arr).view(dt)


def _digest(body: bytes) -> str:
    return hashlib.blake2b(body, digest_size=16).hexdigest()


@dataclass
class TierEntry:
    """One re-uploadable page: K/V contents ``[nl, ps, nh, dh]`` on the
    CPU, the int8 scale planes ``[nl, ps, nh]`` when the pool is quantized,
    and the tier that served it (``"host"`` or ``"disk"``)."""
    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None
    vs: torch.Tensor | None
    tier: str


class KVTierStore:
    """Bounded host-RAM and disk spill tiers under one HBM prefix store.

    ``host_bytes`` / ``disk_bytes`` bound each tier (None or 0 turns it
    off); ``disk_dir`` is OWNED by the store: leftover ``.ptkt`` files are
    removed at construction, and every blob is salted per store, so a file
    that survives or is copied in refuses as stale. ``page_shape`` is
    ``(nl, ps, nh, dh)``, ``dtype`` the pool dtype's name, ``scales``
    whether pages carry int8 scale planes. ``counters``: the dict the store
    counts into (the engine's), else its own. Thread-safe.
    """

    def __init__(self, host_bytes=None, disk_bytes=None, disk_dir=None, *,
                 page_shape, dtype: str, scales: bool, counters=None):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r}: expected one of "
                             f"{sorted(_DTYPES)}")
        self._host_cap = int(host_bytes or 0)
        self._disk_cap = int(disk_bytes or 0)
        self._shape = tuple(int(d) for d in page_shape)  # (nl, ps, nh, dh)
        self._dtype = dtype
        self._scales = bool(scales)
        self._lock = threading.RLock()
        # hash -> framed blob (host) / blob size on disk (disk), least
        # recently used first
        self._host: OrderedDict[bytes, bytes] = OrderedDict()
        self._disk: OrderedDict[bytes, int] = OrderedDict()
        self._host_bytes = 0
        self._disk_bytes = 0
        # flush() advances the epoch: a blob of an older epoch is STALE;
        # the salt pins blobs to this store
        self._epoch = 0
        self._salt = os.urandom(8).hex()
        self.counters = counters if counters is not None else {}
        for k in ("kvtier_hits_host", "kvtier_hits_disk",
                  "kvtier_spills_host", "kvtier_spills_disk",
                  "kvtier_refusals"):
            self.counters.setdefault(k, 0)
        self._dir = None
        if self._disk_cap:
            if disk_dir is None:
                disk_dir = tempfile.mkdtemp(prefix="ptkv_tier_")
            self._dir = str(disk_dir)
            os.makedirs(self._dir, exist_ok=True)
            for f in os.listdir(self._dir):          # the store owns it
                if f.endswith(".ptkt"):
                    self._unlink(os.path.join(self._dir, f))
        self._metrics = {k: metrics.counter("engine." + k.replace(
            "kvtier_", "kvtier.")) for k in (
                "kvtier_hits_host", "kvtier_hits_disk", "kvtier_spills_host",
                "kvtier_spills_disk", "kvtier_bytes_host",
                "kvtier_bytes_disk", "kvtier_refusals")}
        self._gauges = {k: metrics.gauge("engine.kvtier." + k) for k in (
            "host_pages", "host_bytes", "disk_pages", "disk_bytes")}
        self._update_gauges()

    # --------------------------------------------------------------- framing

    def _pack(self, h: bytes, k, v, ks, vs) -> bytes:
        parts = [_raw(k), _raw(v)]
        if self._scales:
            parts += [_raw(ks.float()), _raw(vs.float())]
        body = b"".join(parts)
        head = json.dumps({
            "sum": _digest(body), "hash": h.hex(),
            "shape": list(self._shape), "dtype": self._dtype,
            "scales": self._scales, "epoch": self._epoch,
            "salt": self._salt}).encode()
        return MAGIC + struct.pack("<I", len(head)) + head + body

    def _unpack(self, h: bytes, blob: bytes) -> tuple:
        """Verify and decode one framed blob; raises HandoffCorrupt on any
        integrity or staleness fault, before a payload byte is read."""
        m = len(MAGIC)
        if blob[:m] != MAGIC:
            raise HandoffCorrupt("KV tier blob has a foreign magic: not a "
                                 "PTKT1 spill entry")
        try:
            (hlen,) = struct.unpack("<I", blob[m:m + 4])
            head = json.loads(blob[m + 4:m + 4 + hlen].decode())
            if not isinstance(head, dict):
                raise ValueError(f"header is {type(head).__name__}")
        except (struct.error, ValueError) as e:
            raise HandoffCorrupt(f"KV tier blob header unparseable "
                                 f"({type(e).__name__}: {e})") from e
        body = blob[m + 4 + hlen:]
        if head.get("sum") != _digest(body):
            raise HandoffCorrupt(
                f"KV tier blob failed its content checksum over "
                f"{len(body)} body bytes: truncated or bit-flipped")
        if head.get("salt") != self._salt or \
                int(head.get("epoch", -1)) != self._epoch:
            raise HandoffCorrupt(
                "KV tier blob is STALE (a pre-flush epoch or another "
                "store's entry): its KV may predate a weight refresh")
        if head.get("hash") != h.hex() \
                or tuple(head.get("shape", ())) != self._shape \
                or head.get("dtype") != self._dtype \
                or bool(head.get("scales")) != self._scales:
            raise HandoffCorrupt("KV tier blob does not match its key or "
                                 "geometry")
        nl, ps, nh, dh = self._shape
        n = nl * ps * nh * dh * np.dtype(_DTYPES[self._dtype][1]).itemsize
        s = nl * ps * nh * 4 if self._scales else 0
        if len(body) != 2 * n + 2 * s:
            raise HandoffCorrupt(f"KV tier blob body is {len(body)} bytes, "
                                 f"its geometry says {2 * n + 2 * s}")
        k = _tensor(body[:n], self._dtype, self._shape)
        v = _tensor(body[n:2 * n], self._dtype, self._shape)
        ks = vs = None
        if self._scales:
            ks = _tensor(body[2 * n:2 * n + s], "float32", (nl, ps, nh))
            vs = _tensor(body[2 * n + s:], "float32", (nl, ps, nh))
        return k, v, ks, vs

    # ------------------------------------------------------------------ tiers

    def _path(self, h: bytes) -> str:
        return os.path.join(self._dir, h.hex() + ".ptkt")

    @staticmethod
    def _unlink(path: str):
        try:
            os.unlink(path)
        except OSError:
            pass

    def _count(self, key: str, nbytes: int = 0):
        """One count of ``key`` into the engine's dict and the registry;
        a spill's ``nbytes`` also into its tier's bytes counter."""
        self.counters[key] += 1
        self._metrics[key].inc()
        if nbytes:
            self._metrics[key.replace("spills", "bytes")].inc(nbytes)

    def _refuse(self, h: bytes, why: str):
        self._count("kvtier_refusals")
        flight.record("engine.kvtier.refused", hash=h.hex(), error=why)

    def _update_gauges(self):
        self._gauges["host_pages"].set(len(self._host))
        self._gauges["host_bytes"].set(self._host_bytes)
        self._gauges["disk_pages"].set(len(self._disk))
        self._gauges["disk_bytes"].set(self._disk_bytes)

    def _put_disk(self, h: bytes, blob: bytes):
        if not self._disk_cap or len(blob) > self._disk_cap:
            return
        if h in self._disk:
            self._disk_bytes -= self._disk.pop(h)
            self._unlink(self._path(h))
        path = self._path(h)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)                 # never a torn final file
        self._disk[h] = len(blob)
        self._disk_bytes += len(blob)
        self._count("kvtier_spills_disk", len(blob))
        while self._disk_bytes > self._disk_cap and self._disk:
            old, sz = self._disk.popitem(last=False)
            self._disk_bytes -= sz
            self._unlink(self._path(old))

    def put(self, h: bytes, k, v, ks=None, vs=None):
        """Spill one evicted page's contents (CPU tensors) under its chain
        hash: into the host tier (its LRU overflow demotes to disk), or
        straight to disk without a host tier. Idempotent per hash."""
        h = bytes(h)
        blob = self._pack(h, k, v, ks, vs)
        with self._lock:
            if self._host_cap and len(blob) <= self._host_cap:
                if h in self._host:
                    self._host_bytes -= len(self._host.pop(h))
                self._host[h] = blob
                self._host_bytes += len(blob)
                self._count("kvtier_spills_host", len(blob))
                while self._host_bytes > self._host_cap and self._host:
                    old, old_blob = self._host.popitem(last=False)
                    self._host_bytes -= len(old_blob)
                    self._put_disk(old, old_blob)   # demote, else discard
            else:
                self._put_disk(h, blob)
            self._update_gauges()

    def get(self, h: bytes) -> TierEntry | None:
        """One chain hash, host tier first. A corrupt or stale entry (or
        the armed ``kvtier.disk_corrupt`` fault on a disk entry) is
        dropped, counted in ``kvtier_refusals`` and returned as a miss."""
        h = bytes(h)
        with self._lock:
            blob = self._host.get(h)
            if blob is not None:
                self._host.move_to_end(h)
                try:
                    entry = self._unpack(h, blob)
                except HandoffCorrupt as e:
                    self._host_bytes -= len(self._host.pop(h))
                    self._refuse(h, str(e))
                    self._update_gauges()
                    return None
                self._count("kvtier_hits_host")
                return TierEntry(*entry, "host")
            if h in self._disk:
                self._disk.move_to_end(h)
                try:
                    if faults.ENABLED and faults.fire("kvtier.disk_corrupt"):
                        raise HandoffCorrupt(
                            "injected disk-tier corruption "
                            "(kvtier.disk_corrupt)")
                    with open(self._path(h), "rb") as f:
                        blob = f.read()
                    entry = self._unpack(h, blob)
                except (HandoffCorrupt, OSError) as e:
                    self._disk_bytes -= self._disk.pop(h)
                    self._unlink(self._path(h))
                    self._refuse(h, f"{type(e).__name__}: {e}")
                    self._update_gauges()
                    return None
                self._count("kvtier_hits_disk")
                return TierEntry(*entry, "disk")
        return None

    # ------------------------------------------------------------- inventory

    def hashes(self) -> list[str]:
        """Hex chain hashes of every spilled page, host tier first."""
        with self._lock:
            return [h.hex() for h in self._host] \
                + [h.hex() for h in self._disk]

    def host_pages(self) -> int:
        with self._lock:
            return len(self._host)

    def disk_pages(self) -> int:
        with self._lock:
            return len(self._disk)

    def flush(self):
        """Drop both tiers and advance the epoch: KV spilled under old
        weights must never re-upload after a weight refresh; even a disk
        file that could not be deleted then refuses as stale."""
        with self._lock:
            self._host.clear()
            self._host_bytes = 0
            for h in list(self._disk):
                self._unlink(self._path(h))
            self._disk.clear()
            self._disk_bytes = 0
            self._epoch += 1
            self._update_gauges()
