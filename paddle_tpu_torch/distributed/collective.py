"""Process-level collectives of the port (counterpart of the eager
multi-process part of `paddle_tpu/distributed/collective.py`).

The JAX package moves eager cross-process payloads through its coordination
service's key-value store when its backend cannot compile a multi-process
program (`_kv_allgather`); the port has only that path, over the
`torch.distributed.TCPStore` that `parallel.init_parallel_env` joins:

- `_kv_client()` wraps the store in `StoreKV`, a client with the methods of
  the JAX coordination client that `liveness.py`, this module and
  `train/fault_tolerance.py` call, so they read as the JAX code does;
- `_kv_allgather` / `_proc_allgather` give the rank-ordered ``[P, N]``
  stack of one array from every rank, under the JAX key names
  (``ptpu_ag/<seq>/<rank>`` with its ``ptpu_mk/`` readiness marker,
  ``ag_done/<seq>`` barriers) and with the ``train.collective_stall``
  fault site.

Every other collective op of the JAX module (the in-graph and eager
all-reduce family, p2p, groups) is ROADMAP A6 and raises
NotImplementedError naming it.
"""
from __future__ import annotations

import datetime
import struct
import time

import numpy as np

__all__ = ["StoreKV", "ReduceOp", "all_reduce", "all_gather",
           "all_gather_object", "reduce", "broadcast", "scatter",
           "reduce_scatter", "alltoall", "alltoall_single", "send", "recv",
           "isend", "irecv", "new_group", "get_group", "wait", "Group",
           "split_group", "destroy_process_group"]


class StoreKV:
    """The JAX coordination client's key-value surface over a TCPStore.

    The store has no directory listing and no directory delete, and its
    libuv server refuses a message over 8 MiB. So:

    - every set also appends the key's name to a listing of each of its
      parent directories (``ptpu_dir:<dir>/``): ``key_value_dir_get(prefix)``
      reads the prefix's listing and returns the keys that still exist
      (recursively, as the coordination service does), and a delete of a
      key ending in ``/`` deletes every listed key and the listing;
    - a value over ``CHUNK`` bytes is stored in pieces of ``CHUNK`` bytes
      under ``ptpu_chunk:<key>/<i>`` with a header under the key itself,
      set after the pieces, so a visible key is a readable value; a rank
      moving pieces renews its liveness heartbeat between them
      (`liveness.LivenessMonitor.rebeat`, as `checkpoint.save_sharded`
      does between shard files): a payload of hundreds of MB takes
      seconds, and its writer must not read as a dead peer meanwhile;
    - ``blocking_key_value_get_bytes`` waits on the key with its own
      timeout (the store's ``wait``), and an expiry raises TimeoutError
      with the coordination service's ``DEADLINE_EXCEEDED`` text
      (`liveness.is_timeout`);
    - keys are write-once (``ALREADY_EXISTS``), as the service's are;
    - ``wait_at_barrier(id, timeout_ms)`` counts arrivals with ``add``.
    """

    CHUNK = 4 << 20
    _MAGIC = b"\x00PTPU-CHUNKED-1\x00"
    _HEAD = struct.Struct("<QQ")           # pieces, total bytes

    def __init__(self, store, world):
        self.store = store
        self.world = int(world)

    # ------------------------------------------------------------ values

    def _exists(self, key) -> bool:
        return bool(self.store.check([key]))

    def key_value_set_bytes(self, key, value):
        if self._exists(key):
            raise RuntimeError(f"ALREADY_EXISTS: key {key!r} already set")
        value = bytes(value)
        if len(value) > self.CHUNK:
            n = -(-len(value) // self.CHUNK)
            view = memoryview(value)
            for i in range(n):
                _rebeat()
                self.store.set(f"ptpu_chunk:{key}/{i}",
                               bytes(view[i * self.CHUNK:(i + 1) * self.CHUNK]))
            value = self._MAGIC + self._HEAD.pack(n, len(value))
        self.store.set(key, value)
        parts = key.split("/")
        for depth in range(1, len(parts)):
            self.store.append("ptpu_dir:" + "/".join(parts[:depth]) + "/",
                              key.encode() + b"\n")

    def _read(self, key) -> bytes:
        raw = bytes(self.store.get(key))
        if len(raw) == len(self._MAGIC) + self._HEAD.size \
                and raw.startswith(self._MAGIC):
            n, total = self._HEAD.unpack(raw[len(self._MAGIC):])
            out = bytearray(total)
            pos = 0
            for i in range(n):
                _rebeat()
                piece = self.store.get(f"ptpu_chunk:{key}/{i}")
                out[pos:pos + len(piece)] = piece
                pos += len(piece)
            return bytes(out)
        return raw

    def blocking_key_value_get_bytes(self, key, timeout_ms):
        try:
            self.store.wait([key], datetime.timedelta(
                milliseconds=int(timeout_ms)))
        except Exception as e:  # noqa: BLE001 — the store's timeout error
            if self._exists(key):
                return self._read(key)
            raise TimeoutError(
                f"DEADLINE_EXCEEDED: GetKeyValue({key!r}) timed out after "
                f"{int(timeout_ms)}ms ({type(e).__name__})") from e
        return self._read(key)

    # ------------------------------------------------------- directories

    def _listed(self, prefix):
        lkey = "ptpu_dir:" + prefix
        if not self._exists(lkey):
            return []
        names = bytes(self.store.get(lkey)).decode().split("\n")
        return sorted({n for n in names if n})

    def key_value_dir_get(self, prefix):
        """[(key, value as str)] of every existing key under ``prefix``
        (a directory: its trailing ``/`` is implied)."""
        prefix = prefix.rstrip("/") + "/"
        out = []
        for k in self._listed(prefix):
            if self._exists(k):
                out.append((k, self._read(k).decode(errors="replace")))
        return out

    def _delete_one(self, key):
        raw = bytes(self.store.get(key)) if self._exists(key) else b""
        if raw.startswith(self._MAGIC) \
                and len(raw) == len(self._MAGIC) + self._HEAD.size:
            n, _ = self._HEAD.unpack(raw[len(self._MAGIC):])
            for i in range(n):
                self.store.delete_key(f"ptpu_chunk:{key}/{i}")
        self.store.delete_key(key)

    def key_value_delete(self, key):
        """Delete ``key``, or with a trailing ``/`` every key under it."""
        if not key.endswith("/"):
            self._delete_one(key)
            return
        listings = {"ptpu_dir:" + key}
        for k in self._listed(key):
            self._delete_one(k)
            parts = k[len(key):].split("/")
            listings.update("ptpu_dir:" + key + "/".join(parts[:d]) + "/"
                            for d in range(1, len(parts)))
        for lkey in listings:
            self.store.delete_key(lkey)

    # ------------------------------------------------------------ barrier

    def wait_at_barrier(self, barrier_id, timeout_ms):
        """Block until ``world`` processes called with this id."""
        if self.store.add(f"ptpu_wab:{barrier_id}/count", 1) >= self.world:
            self.store.set(f"ptpu_wab:{barrier_id}/done", b"1")
        try:
            self.store.wait([f"ptpu_wab:{barrier_id}/done"],
                            datetime.timedelta(milliseconds=int(timeout_ms)))
        except Exception as e:  # noqa: BLE001 — the store's timeout error
            raise TimeoutError(
                f"DEADLINE_EXCEEDED: barrier {barrier_id!r} timed out after "
                f"{int(timeout_ms)}ms ({type(e).__name__})") from e


def _rebeat():
    """Renew this rank's heartbeat where a liveness monitor is installed."""
    from paddle_tpu_torch.distributed import liveness
    mon = liveness.current()
    if mon is not None:
        mon.rebeat()


def _kv_client():
    from paddle_tpu_torch.distributed import parallel
    if parallel._store is None:
        raise RuntimeError("p2p needs init_parallel_env (the fleet's "
                           "TCPStore)")
    client = _CLIENT.get(id(parallel._store))
    if client is None:
        client = StoreKV(parallel._store, parallel.get_world_size())
        _CLIENT.clear()
        _CLIENT[id(parallel._store)] = client
    return client


_CLIENT: dict = {}


def _multiprocess() -> bool:
    from paddle_tpu_torch.distributed.parallel import get_world_size
    return get_world_size() > 1


# allgather sequence counter: all ranks issue eager collectives in the same
# program order, so the counter stays in lockstep
_ag_seq = [0]
# seconds and bytes of the newest allgather's parts, for the reducer's
# per-piece timing (publish = this rank's set, read = the peers' gets)
last_allgather: dict = {}


def _kv_allgather(arr):
    """process_allgather over the fleet's key-value store: each rank
    publishes its array bytes under a sequenced key, then reads each
    peer's. O(P·data) through rank 0's store: a correctness path."""
    from paddle_tpu_torch.distributed import liveness
    from paddle_tpu_torch.distributed.parallel import get_rank, get_world_size
    from paddle_tpu_torch.testing import faults
    if faults.ENABLED:
        # train.collective_stall: the armed rank sleeps delay_s BEFORE
        # publishing its contribution — to the peers a wedged rank, which
        # their liveness monitors must turn into typed PeerLost
        faults.fire("train.collective_stall")
    client = _kv_client()
    np_arr = np.ascontiguousarray(np.asarray(arr))
    seq = _ag_seq[0]
    _ag_seq[0] += 1
    me = get_rank()
    world = get_world_size()
    t0 = time.perf_counter()
    liveness.set_with_marker(client, f"ptpu_ag/{seq}/{me}",
                             np_arr.tobytes())
    t1 = time.perf_counter()
    parts = []
    for r in range(world):
        if r == me:
            parts.append(np_arr)
            continue
        raw = liveness.guarded_get_bytes(
            client, f"ptpu_ag/{seq}/{r}", 60_000,
            what=f"allgather seq {seq}")
        parts.append(np.frombuffer(bytes(raw), dtype=np_arr.dtype)
                     .reshape(np_arr.shape))
    t2 = time.perf_counter()
    try:
        # peers have all read by the barrier: own key is safe to delete
        if liveness.current() is not None:
            liveness.kv_barrier(client, f"ag_done/{seq}", rank=me,
                                world=world, timeout_ms=60_000)
            liveness.clear_with_marker(client, f"ptpu_ag/{seq}/{me}")
            if me == 0 and seq >= 2:
                liveness.kv_barrier_cleanup(client, f"ag_done/{seq - 2}")
        else:
            client.wait_at_barrier(f"ptpu_ag_done/{seq}", 60_000)
            client.key_value_delete(f"ptpu_ag/{seq}/{me}")
            client.key_value_delete(f"ptpu_mk/ptpu_ag/{seq}/{me}")
    except liveness.PeerLost:
        raise
    except Exception:  # noqa: BLE001 — cleanup is best-effort
        pass
    last_allgather.update(publish_s=t1 - t0, read_s=t2 - t1,
                          barrier_s=time.perf_counter() - t2,
                          bytes=int(np_arr.nbytes) * world)
    return np.stack(parts)


def _proc_allgather(arr):
    """The rank-ordered ``[P, N]`` stack of ``arr`` from every process."""
    return _kv_allgather(arr)


# ------------------------------------------------------------ not ported


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _a6(name):
    def op(*args, **kwargs):
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.{name} is not ported: the eager "
            "collectives are ROADMAP A6 (this slice ports only the "
            "process-level allgather the elastic trainer uses)")
    op.__name__ = name
    return op


all_reduce = _a6("all_reduce")
all_gather = _a6("all_gather")
all_gather_object = _a6("all_gather_object")
reduce = _a6("reduce")
broadcast = _a6("broadcast")
scatter = _a6("scatter")
reduce_scatter = _a6("reduce_scatter")
alltoall = _a6("alltoall")
alltoall_single = _a6("alltoall_single")
send = _a6("send")
recv = _a6("recv")
isend = _a6("isend")
irecv = _a6("irecv")
new_group = _a6("new_group")
get_group = _a6("get_group")
wait = _a6("wait")
split_group = _a6("split_group")
destroy_process_group = _a6("destroy_process_group")
Group = _a6("Group")
