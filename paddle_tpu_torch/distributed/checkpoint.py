"""Distributed (sharded) checkpointing (counterpart of
`paddle_tpu/distributed/checkpoint.py`; the same on-disk format, so a
checkpoint written by either package loads in the other).

Format: a directory with
  index.json / index.p<pid>.json — {key: {shape, dtype, shards: [{file,
                             slices, sum}]}} plus the ``__ckpt_meta__``
                             format stamp; non-tensor entries as literals
  <key>.p<pid>s<j>.npy     — one file per shard per process

The port's leaves are torch tensors (or numpy arrays and JSON literals).
A tensor on one device is one full-shape shard, as a single-device JAX
array is, so the index and ``.npy`` bytes equal the JAX package's for the
same state. bfloat16, whose dtype numpy lacks: the synchronous path widens
it to a float32 ``.npy`` and keeps ``"bfloat16"`` in the index, as the JAX
path does (`checkpoint.py:200-201` there); the async path writes the host
snapshot's raw 16-bit words under the descriptor ``<V2``, the bytes
``np.save`` writes for the JAX package's ``ml_dtypes`` snapshot. The
loader reads both as ``torch.bfloat16`` (the JAX loader cannot read the
``<V2`` file: ROADMAP C15).

Each process writes only the shards it owns (``partition=(rank, world)``:
the leaves `shard_owner` assigns it, literals to rank 0) plus its partial
index; ``async_save`` snapshots to the host on the calling thread and
writes from a background thread. Every shard records a content checksum
(blake2b-128 over the bytes written) and ``load_sharded`` verifies it and
the format stamp: a truncated, bit-flipped or future-format checkpoint is
refused with `CheckpointCorrupt`, a missing one (no index, missing shard,
coverage gap) with `CheckpointIncomplete`. The publication protocol on
top (LATEST, COMPLETE, retention) is `train/fault_tolerance.py`'s.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.testing import faults

# Bumped when the on-disk layout changes incompatibly. Indexes carry it under
# _META_KEY; loaders refuse a mismatched stamp (a checkpoint written by a
# NEWER format must not be half-understood). Legacy indexes without the stamp
# (pre-checksum checkpoints) still load — they simply skip verification.
CKPT_FORMAT_VERSION = 2
_META_KEY = "__ckpt_meta__"


class CheckpointCorrupt(RuntimeError):
    """The checkpoint's payload fails integrity verification: a shard file
    is truncated or undecodable, its content hash does not match the one
    recorded at save time, its shape disagrees with the index, or the
    index carries an incompatible format-version stamp. Never load it —
    resume from an older complete checkpoint instead."""


class CheckpointIncomplete(RuntimeError):
    """The checkpoint is structurally missing pieces: no index, a shard
    file named by the index is absent, the shards do not cover the full
    array, or (at the manager level) there is no LATEST pointer to resume
    from. Typically a save that crashed partway — by protocol such a
    checkpoint was never published and must be ignored, not repaired."""


def _digest(data: np.ndarray) -> str:
    """Content hash of the EXACT array bytes written to disk (post any
    bf16->f32 widening), so load can verify without re-reading the file.
    Hashes through the buffer protocol — no tobytes() copy, so a multi-GB
    shard costs no transient second allocation on the writer thread."""
    return hashlib.blake2b(np.ascontiguousarray(data).data,
                           digest_size=16).hexdigest()


def _sanitize(key):
    """Filesystem-safe, collision-proof file stem for a state_dict key: the
    readable sanitized name plus a short hash of the RAW key (two distinct
    keys like 'a/b' and 'a_b' must never share shard files)."""
    import hashlib
    h = hashlib.sha1(key.encode()).hexdigest()[:8]
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + "-" + h


_V2 = np.dtype("V2")          # a bfloat16 word, as the JAX snapshot writes it


def _is_literal(value) -> bool:
    """True for the non-tensor metadata entries (global_step, cursors...)
    that the index stores as JSON literals — the ONE predicate both
    save_sharded and async_save's partition filter use."""
    return isinstance(value, (int, float, str, bool, type(None))) or (
        isinstance(value, (list, tuple)) and all(
            isinstance(v, (int, float, str, bool)) for v in value))


def shard_owner(key: str, world: int) -> int:
    """Stable owner rank for a checkpoint leaf under key-partitioned
    multi-host saves: a content hash of the RAW key mod world, so every
    rank computes the same partition with zero coordination. Literal
    (metadata) entries are always rank 0's."""
    h = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") % max(1, int(world))


def _dtype_name(arr) -> str:
    """The index's dtype string: numpy's name, "bfloat16" for a torch
    bfloat16 tensor or a ``V2`` snapshot of one."""
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).replace("torch.", "")
    return "bfloat16" if arr.dtype == _V2 else str(arr.dtype)


def _host_words(t: torch.Tensor) -> np.ndarray:
    """A host copy of tensor ``t``: numpy of its dtype, or for bfloat16 the
    raw words as a ``V2`` array (the bytes of the JAX ``ml_dtypes``
    snapshot)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_V2)
    return t.numpy()


def _save_npy(fpath, data):
    """``np.save``, but a ``V2`` (bfloat16) array gets the descriptor
    ``<V2`` that ``np.save`` writes for an ``ml_dtypes.bfloat16`` array."""
    if data.dtype != _V2:
        np.save(fpath, data)
        return
    with open(fpath, "wb") as f:
        head = np.lib.format.header_data_from_array_1_0(data)
        head["descr"] = "<V2"
        np.lib.format.write_array_header_1_0(f, head)
        f.write(np.ascontiguousarray(data).tobytes())


def save_sharded(state_dict, path, partition=None):
    """Save a (possibly nested) state_dict of tensors shard-by-shard.

    Every process writes its own shards plus a per-process partial index
    ``index.p<pid>.json``; loaders merge ALL partial indexes, so multi-host
    saves need no cross-process gather. Writes publish atomically (tmp +
    rename).

    ``partition=(rank, world)``: key-partitioned multi-host mode for fleets
    whose per-process state is fully REPLICATED (data parallel — each
    process holds the whole array): rank r writes only the leaves
    :func:`shard_owner` assigns it (literals go to rank 0), so the fleet
    writes each byte once and the merged indexes cover the full state only
    when EVERY rank's shards landed."""
    os.makedirs(path, exist_ok=True)
    if partition is not None:
        rank, world = int(partition[0]), int(partition[1])
        if not (0 <= rank < world):
            raise ValueError(f"partition rank {rank} outside world {world}")
        pid = rank
    else:
        from paddle_tpu_torch.distributed.parallel import get_rank
        rank = world = None
        pid = get_rank()
    index = {_META_KEY: {"version": CKPT_FORMAT_VERSION}}
    nwritten = 0

    def _write_shard(fname, data):
        # chaos sites: a save that dies between shard files must leave the
        # checkpoint INVISIBLE (no index, no LATEST), and a torn write must
        # be refused at load by checksum
        nonlocal nwritten
        from paddle_tpu_torch.distributed import liveness
        mon = liveness.current()
        if mon is not None:
            # a rank actively writing shards is ALIVE: renew the heartbeat
            # per shard so a slow write never reads as a dead peer
            mon.rebeat()
        if faults.ENABLED and nwritten > 0 \
                and faults.fire("ckpt.crash_between_shards"):
            raise faults.FaultInjected(
                f"fault injected at ckpt.crash_between_shards ({fname})")
        fpath = os.path.join(path, fname)
        _save_npy(fpath, data)
        nwritten += 1
        if faults.ENABLED and faults.fire("ckpt.write_truncate"):
            with open(fpath, "r+b") as f:
                f.truncate(max(1, os.path.getsize(fpath) // 2))

    for key, value in _flatten(state_dict).items():
        if _is_literal(value):
            if world is not None and rank != 0:
                continue               # literals are rank 0's
            index[key] = {"literal": value if not isinstance(value, tuple)
                          else list(value)}
            continue
        if world is not None and shard_owner(key, world) != rank:
            continue                   # another rank writes this leaf
        skey = _sanitize(key)
        fname = f"{skey}.p{pid}s0.npy"
        if isinstance(value, np.ndarray):
            # pre-snapshotted host array (async_save): written as it is
            data = value
        else:
            # a tensor: one full-shape shard; bfloat16 widened to float32
            # (npy-portable; the dtype stays in the index)
            t = value.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            data = t.to("cpu").contiguous().numpy()
        _write_shard(fname, data)
        index[key] = {"shape": list(data.shape), "dtype": _dtype_name(value),
                      "shards": [{"file": fname, "slices": [
                          [0, d] for d in data.shape],
                          "sum": _digest(data)}]}
    idx_path = os.path.join(path, f"index.p{pid}.json")
    tmp = idx_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(index, f)
    os.replace(tmp, idx_path)
    if pid == 0:
        # back-compat alias; loaders merge every index.p*.json regardless
        tmp = os.path.join(path, "index.json.tmp")
        with open(tmp, "w") as f:
            json.dump(index, f)
        os.replace(tmp, os.path.join(path, "index.json"))
    return path


class _SaveThread(threading.Thread):
    """Background writer that re-raises its exception on join(). A failed
    write must surface on the NEXT join()/wait(), never vanish in a
    daemon thread."""

    def __init__(self, snapshot, path, on_complete=None, partition=None):
        super().__init__(daemon=True, name="pt-ckpt-save")
        self._snapshot = snapshot
        self._path = path
        self._on_complete = on_complete
        self._partition = partition
        self.exc = None
        self.seconds = None            # the write's wall, once done

    def run(self):
        t0 = time.perf_counter()
        try:
            save_sharded(self._snapshot, self._path,
                         partition=self._partition)
            if self._on_complete is not None:
                self._on_complete(self._path)
        except BaseException as e:   # noqa: BLE001 — stored, re-raised on join
            self.exc = e
        self.seconds = time.perf_counter() - t0

    def join(self, timeout=None):
        super().join(timeout)
        if not self.is_alive() and self.exc is not None:
            raise self.exc

    # checkpoint-manager alias: `wait()` = join + error propagation
    wait = join


def async_save(state_dict, path, on_complete=None, partition=None):
    """Copy values to the HOST on the calling thread (the train step
    updates its parameters in place — a reference would race the next
    step), then write in the background. join()/wait() re-raises write
    errors. The blocking cost to the caller is ONLY the host snapshot.
    ``on_complete(path)`` runs on the writer thread after a fully
    successful save (the manager's hook for the COMPLETE marker + LATEST
    pointer). ``partition=(rank, world)`` snapshots (and writes) only this
    rank's key-partition — see :func:`save_sharded`."""
    snapshot = {}
    for key, value in _flatten(state_dict).items():
        if partition is not None:
            rank, world = int(partition[0]), int(partition[1])
            owner = 0 if _is_literal(value) else shard_owner(key, world)
            if owner != rank:
                continue               # unowned: don't even snapshot it
        if isinstance(value, torch.Tensor):
            value = _host_words(value)     # synchronous host copy
        snapshot[key] = value

    t = _SaveThread(snapshot, path, on_complete, partition=partition)
    t.start()
    return t


def read_literal(path, key, default=None):
    """Read ONE literal entry (int/str/list metadata) from a checkpoint's
    index without touching any shard — the cheap metadata peek the
    checkpoint manager uses. Returns ``default`` when the index or the
    key is absent/unreadable."""
    import glob as _glob
    out = default
    for pf in sorted(_glob.glob(os.path.join(path, "index.p*.json"))):
        try:
            with open(pf) as f:
                part = json.load(f)
        except Exception:  # noqa: BLE001 — a peek must never raise
            return default
        entry = part.get(key)
        if isinstance(entry, dict) and "literal" in entry:
            out = entry["literal"]
    return out


def _bf16_words(data: np.ndarray) -> np.ndarray:
    """A bfloat16 shard as uint16 words: a ``V2`` file's own, or a
    float32 file's values rounded to bfloat16 (exact for values saved
    from bfloat16)."""
    if data.dtype == _V2:
        return data.view(np.uint16)
    return torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def load_sharded(path, template=None, return_numpy=False, verify=True):
    """Load a sharded checkpoint into a flat {key: tensor} dict.

    ``template``: optional {key: tensor} — each loaded tensor lands on
    its template leaf's device (else the CPU). ``return_numpy``: numpy
    arrays instead (bfloat16 entries stay CPU ``torch.bfloat16`` tensors:
    numpy has no such dtype).

    Integrity: a missing index or shard file raises `CheckpointIncomplete`;
    a truncated/undecodable shard, a shape that disagrees with the index, a
    content-hash mismatch, or an incompatible format-version stamp raises
    `CheckpointCorrupt`. ``verify=False`` skips only the content hashing
    (structural checks always run)."""
    import glob as _glob
    index = {}
    partials = sorted(_glob.glob(os.path.join(path, "index.p*.json")))
    if not partials:
        legacy = os.path.join(path, "index.json")
        if not os.path.exists(legacy):
            raise CheckpointIncomplete(
                f"no checkpoint index under {path!r} — save crashed before "
                "publishing, or wrong directory")
        partials = [legacy]
    for pf in partials:
        with open(pf) as f:
            part = json.load(f)
        meta = part.pop(_META_KEY, None)
        if meta is not None and meta.get("version") != CKPT_FORMAT_VERSION:
            raise CheckpointCorrupt(
                f"checkpoint {path!r} has format version "
                f"{meta.get('version')!r}, this reader understands "
                f"{CKPT_FORMAT_VERSION} — refusing to half-interpret it")
        for key, entry in part.items():
            if key in index and "shards" in entry:
                index[key]["shards"].extend(entry["shards"])
            else:
                index[key] = entry
    tpl_flat = _flatten(template) if template is not None else {}
    out = {}
    for key, meta in index.items():
        if "literal" in meta:
            out[key] = meta["literal"]
            continue
        cast_bf16 = meta["dtype"] == "bfloat16"
        full = np.empty(meta["shape"], dtype=np.uint16 if cast_bf16
                        else np.dtype(meta["dtype"]))
        boxes = []
        for e in meta["shards"]:
            fpath = os.path.join(path, e["file"])
            if not os.path.exists(fpath):
                raise CheckpointIncomplete(
                    f"checkpoint shard {e['file']!r} for {key!r} is missing "
                    f"from {path!r}")
            try:
                data = np.load(fpath, allow_pickle=False)
            except Exception as exc:  # noqa: BLE001 — any decode failure
                raise CheckpointCorrupt(
                    f"checkpoint shard {e['file']!r} for {key!r} is "
                    f"truncated or undecodable: {type(exc).__name__}: {exc}"
                ) from exc
            want = tuple(b - a for a, b in e["slices"])
            if tuple(data.shape) != want:
                raise CheckpointCorrupt(
                    f"checkpoint shard {e['file']!r} for {key!r} has shape "
                    f"{tuple(data.shape)}, index says {want}")
            if verify and e.get("sum") is not None \
                    and _digest(data) != e["sum"]:
                raise CheckpointCorrupt(
                    f"checkpoint shard {e['file']!r} for {key!r} fails its "
                    "content checksum — bit rot or a torn write; refusing "
                    "to load it")
            sl = tuple(slice(a, b) for a, b in e["slices"])
            full[sl] = _bf16_words(data) if cast_bf16 else data
            boxes.append([tuple(p) for p in e["slices"]])
        _check_coverage(key, meta["shape"], boxes)
        if cast_bf16:
            arr = torch.from_numpy(full.view(np.int16)).view(torch.bfloat16)
        elif return_numpy:
            out[key] = full
            continue
        else:
            arr = torch.from_numpy(full)
        if return_numpy:
            out[key] = arr
            continue
        tpl = tpl_flat.get(key)
        if isinstance(tpl, torch.Tensor):
            arr = arr.to(tpl.device)
        out[key] = arr
    return out


def _check_coverage(key, shape, boxes):
    """O(#shards^2) arithmetic coverage check: total volume of (deduped,
    non-overlapping) shard boxes must equal the array volume — no O(#elements)
    bool mask (a 1B-param tensor would cost an extra GB just to verify)."""
    total = int(np.prod(shape)) if shape else 1
    boxes = list({tuple(b) for b in boxes})
    vol = 0
    for b in boxes:
        v = 1
        for lo, hi in b:
            v *= hi - lo
        vol += v
    for i, a in enumerate(boxes):
        for b in boxes[i + 1:]:
            if all(lo1 < hi2 and lo2 < hi1
                   for (lo1, hi1), (lo2, hi2) in zip(a, b)):
                raise CheckpointCorrupt(
                    f"checkpoint shards for '{key}' overlap: {a} vs {b}")
    if vol != total:
        raise CheckpointIncomplete(
            f"checkpoint shard files for '{key}' cover {vol} of {total} "
            f"elements of {shape} — incomplete multi-host save?")


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, prefix=f"{key}/"))
        else:
            out[key] = v
    return out
