"""Collective communication (counterpart of
`paddle_tpu/distributed/collective.py`; ref
`python/paddle/distributed/collective.py` and its eager ProcessGroup path).

The JAX package has two paths. In a trace under ``shard_map`` with a group
bound to a mesh axis, its collectives are XLA's (``psum`` and the rest,
the ``in_graph`` mode); on concrete arrays they move through its
coordination service's key-value store when its backend cannot compile a
multi-process program (`_kv_allgather`). A port tensor is never a tracer,
so the port has the second path only, as a JAX tensor outside a trace
does; the in-graph one comes with the meta-parallel engine (ROADMAP
A6.4). Its transport is the `torch.distributed.TCPStore` that
`parallel.init_parallel_env` joins:

- `_kv_client()` wraps the store in `StoreKV`, a client with the methods of
  the JAX coordination client that `liveness.py`, this module and
  `train/fault_tolerance.py` call, so they read as the JAX code does;
- `_kv_allgather` / `_proc_allgather` give the rank-ordered ``[P, N]``
  stack of one array from every rank, under the JAX key names
  (``ptpu_ag/<seq>/<rank>`` with its ``ptpu_mk/`` readiness marker,
  ``ag_done/<seq>`` barriers) and with the ``train.collective_stall``
  fault site;
- the ops (``all_reduce`` and its family, ``send`` / ``recv``) run in the
  JAX package's two eager modes: ``local`` at world 1 (a plain
  all-reduce is the identity; a quantized one still makes the codec's
  round trip) and ``eager`` across processes (the allgather, then a
  reduce over the rank-ordered stack in float32, one add at a time in rank
  order; scatter, alltoall and p2p over sequenced ``ptpu_p2p/`` keys).
  CUDA tensors cross through the host; the results land on the input's
  device. Groups are bookkeeping, as in the JAX eager path: every op
  spans all processes. ``collective.calls{op, mode}``,
  ``collective.bytes{op, mode}`` and ``collective.quantized_calls`` count
  as the JAX package counts them.

The store is O(P * data) through rank 0: a correctness path, not NCCL.
"""
from __future__ import annotations

import datetime
import pickle
import struct
import time

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops.common import ensure_tensor

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




# ------------------------------------------------------------- accounting


def _payload_nbytes(data) -> int:
    """A payload's bytes from its shape and dtype."""
    try:
        return int(data.numel()) * data.element_size()
    except Exception:  # noqa: BLE001 — accounting must never break the op
        return 0


def _note_collective(op: str, mode: str, *datas):
    """Per-primitive accounting: the call and the local payload's bytes the
    primitive moves or produces per participant, labelled by mode
    (``eager`` across processes, ``local`` at world 1)."""
    metrics.counter("collective.calls", op=op, mode=mode).inc()
    nb = sum(_payload_nbytes(d) for d in datas)
    if nb:
        metrics.counter("collective.bytes", op=op, mode=mode).inc(nb)


def _note_quantized(mode: str, q, scales):
    """A quantized all-reduce's accounting: the bytes are what the wire
    moves, the int8 blocks and their f32 scales (~1/3.8 of the f32 payload
    at the default block)."""
    from paddle_tpu_torch.quantization.comms import quantized_payload_nbytes
    metrics.counter("collective.calls", op="all_reduce", mode=mode).inc()
    metrics.counter("collective.quantized_calls").inc()
    metrics.counter("collective.bytes", op="all_reduce", mode=mode).inc(
        quantized_payload_nbytes(q, scales))


def _mode() -> str:
    return "eager" if _multiprocess() else "local"


# ------------------------------------------------------------------ groups


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """A communication group: a set of ranks, optionally bound to a mesh
    axis name (kept for the JAX signature; no port op reads it)."""

    def __init__(self, ranks=None, gid=0, axis_name=None):
        from paddle_tpu_torch.distributed.parallel import get_world_size
        self.ranks = list(ranks) if ranks is not None else \
            list(range(max(get_world_size(), 1)))
        self.id = gid
        self.axis_name = axis_name

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return len(self.ranks)

    @property
    def rank(self):
        from paddle_tpu_torch.distributed.parallel import get_rank
        r = get_rank()
        return self.ranks.index(r) if r in self.ranks else -1

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self):
        from paddle_tpu_torch.distributed.parallel import get_rank
        return get_rank() in self.ranks

    def process_group(self):
        return self

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks}, axis={self.axis_name})"


_group_counter = 0
_groups: dict[int, Group] = {}
_default_group: Group | None = None


def _get_default_group() -> Group:
    global _default_group
    if _default_group is None:
        _default_group = Group(gid=0)
        _groups[0] = _default_group
    return _default_group


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    global _group_counter
    _group_counter += 1
    g = Group(ranks, _group_counter, axis_name=axis_name)
    _groups[g.id] = g
    return g


def get_group(gid=0):
    return _groups.get(gid) or _get_default_group()


def split_group(parent_group=None, split_sizes=None):
    parent = parent_group or _get_default_group()
    out = []
    start = 0
    for size in split_sizes:
        out.append(new_group(parent.ranks[start:start + size]))
        start += size
    return out


def destroy_process_group(group=None):
    global _default_group
    if group is None:
        _groups.clear()
        _default_group = None
    else:
        _groups.pop(group.id, None)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until ``tensor``'s pending device work is done."""
    if isinstance(tensor, Tensor) and tensor._data.is_cuda:
        torch.cuda.current_stream(tensor._data.device).synchronize()


# --------------------------------------------------------------- transport


def _host(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array on the host; bfloat16 as its int16 words
    (numpy has no bfloat16)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return np.ascontiguousarray(x.cpu().numpy())


def _wire_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype `_host` gives a tensor of ``dtype``."""
    return _host(torch.empty(0, dtype=dtype)).dtype


def _to_device(arr, like: torch.Tensor) -> torch.Tensor:
    """A host array from `_host` back as a tensor of ``like``'s dtype on
    ``like``'s device."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def _gather(x: torch.Tensor) -> torch.Tensor:
    """The rank-ordered ``[P, *x.shape]`` stack of ``x`` from every
    process, on ``x``'s device."""
    return _to_device(_proc_allgather(_host(x)), x)


def _publish(src, dst, x: torch.Tensor):
    """Put ``x``'s bytes under the next (src, dst) p2p key."""
    from paddle_tpu_torch.distributed import liveness
    n, key = _p2p_peek_key(src, dst)
    liveness.set_with_marker(_kv_client(), key, _host(x).tobytes())
    _p2p_advance(src, dst, n)


def _take(src, dst, like: torch.Tensor, shape, what):
    """Read the next (src, dst) p2p payload as a tensor of ``like``'s dtype
    and device with ``shape``, and free the store's copy."""
    from paddle_tpu_torch.distributed import liveness
    n, key = _p2p_peek_key(src, dst)
    client = _kv_client()
    raw = liveness.guarded_get_bytes(client, key, 120_000, what=what)
    _p2p_advance(src, dst, n)
    # free the store's copy (payload and readiness marker)
    liveness.clear_with_marker(client, key)
    arr = np.frombuffer(raw, dtype=_wire_dtype(like.dtype)).reshape(shape)
    return _to_device(arr, like)


# ----------------------------------------------------------- collectives


def _sum_ranks(stacked):
    """Sum over the rank axis 0 in rank order, one add at a time."""
    total = stacked[0]
    for r in range(1, stacked.shape[0]):
        total = total + stacked[r]
    return total


def _divide(x, n):
    # by a tensor on x's device: CUDA turns division by a host scalar into
    # a product with its reciprocal, one rounding more
    return x / torch.full((), n, dtype=x.dtype if x.is_floating_point()
                          else torch.float32, device=x.device)


def _reduce_stack(stacked, op):
    """``op`` over the rank-ordered stack, floating values in float32."""
    x = stacked.float() if stacked.is_floating_point() else stacked
    if op == ReduceOp.SUM:
        return _sum_ranks(x)
    if op == ReduceOp.AVG:
        return _divide(_sum_ranks(x), x.shape[0])
    if op == ReduceOp.MAX:
        return x.amax(dim=0)
    if op == ReduceOp.MIN:
        return x.amin(dim=0)
    if op == ReduceOp.PROD:
        total = x[0]
        for r in range(1, x.shape[0]):
            total = total * x[r]
        return total
    raise ValueError(f"unknown reduce op {op!r}")


def _quantized_all_reduce(tensor, t, op, quant_block):
    """Blockwise abs-max int8 all-reduce (EQuARX-style): quantize the local
    payload into int8 blocks and per-block f32 scales, move THOSE,
    dequantize each participant's blocks and reduce in f32. The error is
    bounded per block (`comms.roundtrip_bound`). SUM/AVG only: MAX, MIN and
    PROD gain nothing from a lossy codec and are refused."""
    from paddle_tpu_torch.quantization import comms
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(
            f"quantized all_reduce supports SUM/AVG, got {op!r}")
    x = t._data
    q, s, meta = comms.quantize_blockwise(x, quant_block)
    _note_quantized(_mode(), q, s)
    if _multiprocess():
        gq, gs = _gather(q), _gather(s)      # int8 on the wire, ~1/4 bytes
        total = _sum_ranks(comms.dequantize_blockwise(
            gq, gs, (tuple(x.shape), int(x.numel()), torch.float32)))
        if op == ReduceOp.AVG:
            total = _divide(total, gq.shape[0])
        tensor._write(total.to(x.dtype))
    else:
        # 1 participant: the round trip still applies, so one process's
        # numerics are the multi-process semantics
        tensor._write(comms.dequantize_blockwise(q, s, meta).to(x.dtype))
    return tensor


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               quantized=False, quant_block=None):
    """Across processes: the allgather over the store and a local reduce in
    rank order. One process: the identity.

    ``quantized=True`` moves the blockwise abs-max int8 form instead
    (SUM/AVG; ~1/4 of the wire bytes at a per-block bounded error;
    `collective.bytes` records the quantized payload). ``quant_block`` sets
    the codec's block (default `quantization.comms.DEFAULT_BLOCK`)."""
    t = ensure_tensor(tensor)
    if quantized:
        from paddle_tpu_torch.quantization.comms import DEFAULT_BLOCK
        return _quantized_all_reduce(tensor, t, op,
                                     int(quant_block or DEFAULT_BLOCK))
    _note_collective("all_reduce", _mode(), t._data)
    if _multiprocess():
        tensor._write(_reduce_stack(_gather(t._data), op).to(t._data.dtype))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    t = ensure_tensor(tensor)
    _note_collective("all_gather", _mode(), t._data)
    if _multiprocess():
        stacked = _gather(t._data)
        for i in range(stacked.shape[0]):
            tensor_list.append(Tensor(stacked[i], _internal=True))
    else:
        tensor_list.append(Tensor(t._data, _internal=True))
    return tensor_list


def all_gather_object(object_list, obj, group=None):
    if not _multiprocess():
        object_list.append(obj)
        return object_list
    payload = np.frombuffer(pickle.dumps(obj), np.uint8)
    sizes = _proc_allgather(np.asarray([payload.size], np.int64))
    padded = np.zeros(int(np.max(sizes)), np.uint8)
    padded[: payload.size] = payload
    gathered = _proc_allgather(padded)
    for row, size in zip(gathered, sizes.reshape(-1)):
        object_list.append(pickle.loads(row[: int(size)].tobytes()))
    return object_list


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    all_reduce(tensor, op=op, group=group)
    return tensor


def broadcast(tensor, src, group=None, sync_op=True):
    t = ensure_tensor(tensor)
    _note_collective("broadcast", _mode(), t._data)
    if _multiprocess():
        tensor._write(_gather(t._data)[src])
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    from paddle_tpu_torch.distributed.parallel import get_rank, get_world_size
    _note_collective("scatter", _mode(), ensure_tensor(tensor)._data)
    if not _multiprocess():
        if tensor_list:
            tensor._write(ensure_tensor(tensor_list[0])._data)
        return tensor
    rank = get_rank()
    # right-sized p2p through the store: each rank moves O(data / P)
    if rank == src:
        if not tensor_list:
            raise ValueError("scatter src needs tensor_list")
        for r in range(get_world_size()):
            chunk = ensure_tensor(tensor_list[r])
            if r == rank:
                tensor._write(chunk._data)
            else:
                _publish(src, r, chunk._data)
    else:
        recv(tensor, src=src)
    return tensor


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    parts = [ensure_tensor(x) for x in tensor_list] \
        if isinstance(tensor_list, (list, tuple)) \
        else [ensure_tensor(tensor_list)]
    _note_collective("reduce_scatter", _mode(), *[x._data for x in parts])
    if _multiprocess():
        from paddle_tpu_torch.distributed.parallel import get_rank
        local = torch.stack([x._data for x in parts])
        summed = _reduce_stack(_gather(local), ReduceOp.SUM)
        tensor._write(summed[get_rank()].to(local.dtype))
    else:
        tensor._write(parts[0]._data)
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    if out_tensor_list is None:
        out_tensor_list = []
    ts = [ensure_tensor(x) for x in in_tensor_list]
    _note_collective("alltoall", _mode(), *[t._data for t in ts])
    if not _multiprocess():
        out_tensor_list.extend(ts)
        return out_tensor_list
    from paddle_tpu_torch.distributed.parallel import get_rank, get_world_size
    rank, world = get_rank(), get_world_size()
    # pairwise exchange through the store: O(data / P) per peer
    for r in range(world):
        if r != rank:
            _publish(rank, r, ts[r]._data)
    for r in range(world):
        if r == rank:
            out_tensor_list.append(Tensor(ts[rank]._data, _internal=True))
        else:
            out_tensor_list.append(Tensor(_take(
                r, rank, ts[r]._data, tuple(ts[r]._data.shape),
                f"alltoall from rank {r}"), _internal=True))
    return out_tensor_list


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Rank r's output is every rank's r-th chunk of its input along axis
    0, in rank order. Without split sizes the chunks are equal, as the JAX
    package cuts them; with ``in_split_sizes`` (rows this rank sends to
    each rank) and ``out_split_sizes`` (rows it receives from each) they
    may differ, as in the reference's `alltoall_single`. The JAX package
    ignores the two lists (ROADMAP C24)."""
    t = ensure_tensor(in_tensor)
    _note_collective("alltoall_single", _mode(), t._data)
    if not _multiprocess():
        if out_tensor is not None:
            out_tensor._write(t._data)
            return out_tensor
        return t
    from paddle_tpu_torch.distributed.parallel import get_rank, get_world_size
    rank, n = get_rank(), get_world_size()
    x = t._data
    if in_split_sizes is None and out_split_sizes is None:
        gathered = _gather(x.reshape((n, -1) + tuple(x.shape[1:])))
        mine = torch.cat([gathered[p][rank] for p in range(n)], dim=0)
    else:
        send_rows = list(in_split_sizes or [x.shape[0] // n] * n)
        recv_rows = list(out_split_sizes or [x.shape[0] // n] * n)
        chunks = x.split(send_rows, dim=0)
        for r in range(n):
            if r != rank:
                _publish(rank, r, chunks[r])
        mine = torch.cat([chunks[rank] if r == rank else _take(
            r, rank, x, (recv_rows[r], *x.shape[1:]),
            f"alltoall_single from rank {r}") for r in range(n)], dim=0)
    if out_tensor is not None:
        out_tensor._write(mine)
        return out_tensor
    return Tensor(mine, _internal=True)


# --------------------------------------------------------- point to point

# p2p sequence counters, keyed (src, dst): both ends advance in lockstep,
# and only AFTER a successful transfer, so a timed-out recv retries the
# same sequence number instead of skipping a message
_p2p_seq: dict = {}


def _p2p_peek_key(src, dst):
    n = _p2p_seq.get((src, dst), 0)
    return n, f"ptpu_p2p/{src}to{dst}/{n}"


def _p2p_advance(src, dst, n):
    _p2p_seq[(src, dst)] = n + 1


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send (ref `send_v2` / ProcessGroup::Send): the payload
    travels through the fleet's store, a correctness path for
    control-plane-sized tensors, like the reference's Gloo fallback."""
    t = ensure_tensor(tensor)
    if not _multiprocess():
        raise RuntimeError("send() with world_size 1 has no peer")
    _note_collective("send", "eager", t._data)
    from paddle_tpu_torch.distributed.parallel import get_rank
    _publish(get_rank(), dst, t._data)


def recv(tensor, src=0, group=None, sync_op=True):
    """Point-to-point receive into ``tensor``, whose shape and dtype the
    payload takes (ref `recv_v2` / ProcessGroup::Recv); see send()."""
    t = ensure_tensor(tensor)
    if not _multiprocess():
        raise RuntimeError("recv() with world_size 1 has no peer")
    _note_collective("recv", "eager", t._data)
    from paddle_tpu_torch.distributed.parallel import get_rank
    t._write(_take(src, get_rank(), t._data, tuple(t._data.shape),
                   f"recv from rank {src}"))
    return t


def isend(tensor, dst, group=None):
    send(tensor, dst, group)
    return _DoneTask()


def irecv(tensor, src=None, group=None):
    recv(tensor, src if src is not None else 0, group)
    return _DoneTask()


class _DoneTask:
    """Completed-task handle (the store transport is synchronous)."""

    def wait(self):
        return True

    def is_completed(self):
        return True
