"""Disaggregated serving (counterpart of `paddle_tpu/serving/disagg.py`):

- **`prompt_page_hashes`**: the rolling page-chain hash of a prompt, which
  an engine's prefix store, its KV tiers and a fleet's prefix directory
  all key on; byte-identical to the JAX package's (one seed, one digest).
- **The ``PTKS1`` page stream**: the one-shot ``PTKV1`` handoff blob
  (`inference/handoff.py`'s `KVHandoff`) as a stream of records: one
  header record (the prompt and the cache geometry), a page batch as each
  chunk of the prefill worker's prefill completes its pages, and a final
  record with the first token and the tail pages
  (`DecodeEngine.submit_prefill_stream`). Every record carries the blake2b
  body checksum of the other blobs, so a truncated or bit-flipped record
  is a typed `HandoffCorrupt` refusal before any page is adopted. The
  records are the JAX package's byte for byte; a bfloat16 pool's pages
  travel as their raw 16-bit words (``int16`` arrays here).
- **`KVStreamAssembler`**: the receive side. Records are fed in order and
  the final one returns the assembled `KVHandoff`. Assembly is host numpy
  only: no engine page is allocated until the complete, verified handoff
  goes through ``submit_import``, so a partial stream leaves the decode
  pool as it was. A one-shot ``PTKV1`` blob is a complete stream of one.
- **`PrefixDirectory`**: the router's fleet-wide map from a page hash to
  the prefill worker whose store holds that page, so a shared prefix is
  prefilled once per fleet (`serving/router.py`).
"""
from __future__ import annotations

import hashlib
import json
import struct
import threading
from collections import OrderedDict

import numpy as np

from paddle_tpu_torch.inference.errors import HandoffCorrupt
from paddle_tpu_torch.inference.handoff import (KVHandoff, _blob_digest,
                                                _np_cache_dtype,
                                                _read_blob_head)

__all__ = ["STREAM_MAGIC", "pack_stream_header", "pack_stream_pages",
           "pack_stream_final", "stream_records", "KVStreamAssembler",
           "PrefixDirectory", "prompt_page_hashes"]

STREAM_MAGIC = b"PTKS1\n"

_PREFIX_SEED = b"pt-prefix-v1"


def prompt_page_hashes(ids, page_size: int) -> list[bytes]:
    """Rolling hash over a prompt's FULL token pages: ``h_i = H(h_{i-1} |
    page_i tokens)``, blake2b with a 16-byte digest over the int32 token
    bytes. Chained keys mean a page is only reusable when every page before
    it matches too; a trailing partial page gets no hash."""
    ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int32)
    ps = int(page_size)
    out, h = [], _PREFIX_SEED
    for i in range(ids.size // ps):
        h = hashlib.blake2b(h + ids[i * ps:(i + 1) * ps].tobytes(),
                            digest_size=16).digest()
        out.append(h)
    return out


# ------------------------------------------------------------ wire records


def _pack_record(head: dict, body: bytes) -> bytes:
    head = dict(head)
    head["sum"] = _blob_digest(body)
    hb = json.dumps(head).encode()
    return b"".join([STREAM_MAGIC, struct.pack("<I", len(hb)), hb, body])


def pack_stream_header(seq: int, prompt: np.ndarray, page_size: int,
                       dtype: str, geom, n_pages: int, n_records: int,
                       scales: bool, trace_ctx=None) -> bytes:
    """Record 0 of a KV page stream: the handoff's prompt (body) plus
    everything the assembler needs to preallocate — ``geom`` is
    ``[nl, page_size, nh, dh]``, ``n_pages`` the total page count the
    stream will deliver, ``scales`` whether page batches carry int8
    scale sections. ``trace_ctx`` is an optional ``(trace_id, parent)``
    hex pair: the fleet trace context rides the header so the decode
    side's spans join the same stitched trace even when the relayed
    options carried none."""
    head = {"kind": "head", "seq": int(seq), "page_size": int(page_size),
            "dtype": str(dtype), "prompt_len": int(np.asarray(prompt).size),
            "geom": [int(d) for d in geom], "n_pages": int(n_pages),
            "n_records": int(n_records), "scales": bool(scales)}
    if trace_ctx and trace_ctx[0]:
        head["trace"] = trace_ctx[0]
        if trace_ctx[1]:
            head["parent"] = trace_ctx[1]
    body = np.ascontiguousarray(prompt, np.int32).tobytes()
    return _pack_record(head, body)


def _pages_body(k_blob, v_blob, k_s=None, v_s=None) -> bytes:
    parts = [np.ascontiguousarray(k_blob).tobytes(),
             np.ascontiguousarray(v_blob).tobytes()]
    if k_s is not None:
        parts += [np.ascontiguousarray(k_s, np.float32).tobytes(),
                  np.ascontiguousarray(v_s, np.float32).tobytes()]
    return b"".join(parts)


def pack_stream_pages(seq: int, page0: int, k_blob, v_blob,
                      k_s=None, v_s=None) -> bytes:
    """One page batch: blobs are ``[nl, n, page_size, nh, dh]`` (scales
    ``[nl, n, page_size, nh]`` f32, int8 pools only), landing at page
    indices ``[page0, page0 + n)`` of the stream's page list."""
    n = int(np.asarray(k_blob).shape[1])
    head = {"kind": "pages", "seq": int(seq), "page0": int(page0), "n": n}
    return _pack_record(head, _pages_body(k_blob, v_blob, k_s, v_s))


def pack_stream_final(seq: int, first_token: int, page0: int, k_blob,
                      v_blob, k_s=None, v_s=None) -> bytes:
    """The closing record: the prefill's sampled seed token plus the tail
    page batch (``n`` may be 0 — a prompt ending on a page boundary has
    no tail). The decode side admits the slot the moment this lands."""
    n = int(np.asarray(k_blob).shape[1])
    head = {"kind": "final", "seq": int(seq),
            "first_token": int(first_token), "page0": int(page0), "n": n}
    return _pack_record(head, _pages_body(k_blob, v_blob, k_s, v_s))


def stream_records(handoff: KVHandoff, pages_per_batch: int = 1) \
        -> list[bytes]:
    """Split a one-shot :class:`KVHandoff` into PTKS1 stream records —
    the bridge for tests/drills and for re-streaming a blob that arrived
    one-shot. The engine's live export path packs records directly as
    its chunks complete (`DecodeEngine.submit_prefill_stream`)."""
    ppb = max(1, int(pages_per_batch))
    nl, n_pages, ps, nh, dh = handoff.k_pages.shape
    scales = handoff.k_scales is not None
    starts = list(range(0, n_pages, ppb))
    if starts:
        tail0 = starts.pop()         # the last batch rides the final record
    else:
        tail0 = 0
    n_records = 2 + len(starts)
    recs = [pack_stream_header(0, handoff.prompt, handoff.page_size,
                               handoff.cache_dtype, [nl, ps, nh, dh],
                               n_pages, n_records, scales)]
    for i, p0 in enumerate(starts):
        sl = slice(p0, min(p0 + ppb, n_pages))
        recs.append(pack_stream_pages(
            1 + i, p0, handoff.k_pages[:, sl], handoff.v_pages[:, sl],
            handoff.k_scales[:, sl] if scales else None,
            handoff.v_scales[:, sl] if scales else None))
    sl = slice(tail0, n_pages)
    recs.append(pack_stream_final(
        n_records - 1, handoff.first_token, tail0,
        handoff.k_pages[:, sl], handoff.v_pages[:, sl],
        handoff.k_scales[:, sl] if scales else None,
        handoff.v_scales[:, sl] if scales else None))
    return recs


class KVStreamAssembler:
    """Receive side of a PTKS1 page stream: ``feed`` records in order;
    the final record returns the assembled :class:`KVHandoff` (None
    until then). Everything is host-side numpy — no engine resource is
    touched until the complete handoff is imported, so abandoning a
    partial stream costs nothing and a damaged record refuses typed
    (:class:`HandoffCorrupt`, checksum-verified before any byte of the
    payload is interpreted) before any page could be adopted.

    A single legacy one-shot ``PTKV1`` blob is accepted as a complete
    stream — old senders keep working unchanged."""

    def __init__(self):
        self._seq = 0
        self._head: dict | None = None
        self._k = self._v = self._ks = self._vs = None
        self._prompt: np.ndarray | None = None
        self._covered: np.ndarray | None = None
        self.complete = False
        # fleet trace context carried by the stream header, if any:
        # (trace_id, parent) hex pair the receiving replica attaches to
        # its RequestTrace when the relayed options carried none
        self.trace_ctx = None

    def _corrupt(self, msg: str):
        raise HandoffCorrupt(f"KV stream: {msg}")

    def feed(self, buf: bytes) -> KVHandoff | None:
        if self.complete:
            self._corrupt("record after the final record")
        if buf[:len(KVHandoff.MAGIC)] == KVHandoff.MAGIC:
            # legacy one-shot PTKV1 blob = a complete stream of one
            if self._seq != 0:
                self._corrupt("one-shot PTKV1 blob mid-stream")
            self.complete = True
            return KVHandoff.unpack(buf)
        if buf[:len(STREAM_MAGIC)] != STREAM_MAGIC:
            self._corrupt("bad record magic (not PTKS1/PTKV1)")
        # _read_blob_head verifies the blake2b body checksum FIRST — a
        # truncated or bit-flipped record dies here, typed
        head, off = _read_blob_head(buf, len(STREAM_MAGIC),
                                    "PTKS1 stream record")
        # the body checksum does not cover the JSON header, so every
        # header FIELD read below must refuse typed on damage too —
        # never escape as a raw TypeError/ValueError
        try:
            seq = int(head.get("seq", -1))
        except (TypeError, ValueError):
            seq = -1
        if seq != self._seq:
            self._corrupt(f"record out of order: got seq "
                          f"{head.get('seq')}, want {self._seq}")
        kind = head.get("kind")
        if self._seq == 0:
            if kind != "head":
                self._corrupt(f"first record is {kind!r}, not the header")
            self._start(head, buf, off)
            self._seq += 1
            return None
        if self._head is None:
            self._corrupt("page record before the header")
        if kind not in ("pages", "final"):
            self._corrupt(f"unknown record kind {kind!r}")
        self._place(head, buf, off)
        self._seq += 1
        if kind != "final":
            return None
        if int(self._head["n_records"]) != self._seq:
            self._corrupt(f"final record at seq {self._seq - 1} but the "
                          f"header promised {self._head['n_records']} "
                          f"records")
        if not bool(self._covered.all()):
            missing = int((~self._covered).sum())
            self._corrupt(f"final record landed with {missing} page(s) "
                          f"never delivered")
        try:
            first_token = int(head["first_token"])
        except (KeyError, TypeError, ValueError):
            self._corrupt("final record carries no usable first_token")
        self.complete = True
        return KVHandoff(
            prompt=self._prompt, first_token=first_token,
            k_pages=self._k, v_pages=self._v,
            page_size=int(self._head["page_size"]),
            cache_dtype=str(self._head["dtype"]),
            k_scales=self._ks, v_scales=self._vs)

    def _start(self, head: dict, buf: bytes, off: int):
        try:
            nl, ps, nh, dh = (int(d) for d in head["geom"])
            n_pages = int(head["n_pages"])
            s0 = int(head["prompt_len"])
            page_size = int(head["page_size"])
            n_records = int(head["n_records"])
            dt = _np_cache_dtype(str(head["dtype"]))
            bad_geom = min(nl, ps, nh, dh, page_size, n_records) < 1 \
                or n_pages < 1 or s0 < 1 \
                or n_pages != -(-s0 // page_size)
        except (KeyError, ValueError, TypeError,
                ZeroDivisionError) as e:
            self._corrupt(f"header unusable ({type(e).__name__}: {e})")
        if bad_geom:
            self._corrupt(f"header geometry inconsistent: {n_pages} pages "
                          f"for a {s0}-token prompt at page_size "
                          f"{head['page_size']}")
        self._prompt = np.frombuffer(buf, np.int32, count=s0,
                                     offset=off).copy()
        self._k = np.zeros((nl, n_pages, ps, nh, dh), dt)
        self._v = np.zeros_like(self._k)
        if bool(head.get("scales")):
            self._ks = np.zeros((nl, n_pages, ps, nh), np.float32)
            self._vs = np.zeros_like(self._ks)
        self._covered = np.zeros(n_pages, bool)
        self._head = head
        if head.get("trace"):
            self.trace_ctx = (str(head["trace"]), head.get("parent"))

    def _place(self, head: dict, buf: bytes, off: int):
        try:
            p0, n = int(head.get("page0", -1)), int(head.get("n", -1))
        except (TypeError, ValueError):
            p0 = n = -1
        n_pages = self._k.shape[1]
        if p0 < 0 or n < 0 or p0 + n > n_pages:
            self._corrupt(f"page batch [{p0}, {p0 + n}) outside the "
                          f"stream's {n_pages} pages")
        if n and bool(self._covered[p0:p0 + n].any()):
            self._corrupt(f"page batch [{p0}, {p0 + n}) overlaps pages "
                          f"already delivered")
        nl, _, ps, nh, dh = self._k.shape
        shape = (nl, n, ps, nh, dh)
        cnt = int(np.prod(shape))
        dt = self._k.dtype
        want = 2 * cnt * dt.itemsize
        sshape = (nl, n, ps, nh)
        scnt = int(np.prod(sshape))
        if self._ks is not None:
            want += 2 * scnt * 4
        if len(buf) - off != want:
            self._corrupt(f"page batch body is {len(buf) - off} bytes, "
                          f"want {want} for {n} page(s)")
        if n == 0:
            return
        k = np.frombuffer(buf, dt, count=cnt, offset=off).reshape(shape)
        off += cnt * dt.itemsize
        v = np.frombuffer(buf, dt, count=cnt, offset=off).reshape(shape)
        off += cnt * dt.itemsize
        self._k[:, p0:p0 + n] = k
        self._v[:, p0:p0 + n] = v
        if self._ks is not None:
            ks = np.frombuffer(buf, np.float32, count=scnt,
                               offset=off).reshape(sshape)
            off += scnt * 4
            vs = np.frombuffer(buf, np.float32, count=scnt,
                               offset=off).reshape(sshape)
            self._ks[:, p0:p0 + n] = ks
            self._vs[:, p0:p0 + n] = vs
        self._covered[p0:p0 + n] = True


# -------------------------------------------------------- fleet directory


class PrefixDirectory:
    """The router's fleet-wide prefix map: rolling page hash -> the
    prefill replica whose engine store holds that page. Bounded LRU
    (``capacity`` hashes), thread-safe; entries leave on replica
    departure (`invalidate`), on the replica's own store shrinking
    (`replace`, driven by the STATS prefix export: evictions and
    weight-refresh flushes propagate here), and by LRU pressure.

    Lookups walk the prompt's hashes LONGEST-first: the hashes are
    chained (`prompt_page_hashes`), so a replica holding page i holds
    every page before it, and the first hit names both the replica and the
    cached depth.

    KV tiering: replicas advertise their SPILLED pages (host/disk tiers)
    beside the resident ones, so a directory hit on a spilled prefix still
    routes to the one replica that can re-upload it instead of
    re-prefilling anywhere. The directory tracks which hashes are spilled
    per replica; `is_spilled` / `spilled_depth` let the router meter how
    much of its affinity traffic rides the spill tiers."""

    def __init__(self, capacity: int = 4096):
        self._cap = max(1, int(capacity))
        self._lock = threading.Lock()
        self._map: OrderedDict[bytes, str] = OrderedDict()
        self._by_replica: dict[str, set[bytes]] = {}
        self._spilled: dict[str, set[bytes]] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def _drop(self, h: bytes):
        rid = self._map.pop(h, None)
        if rid is not None:
            s = self._by_replica.get(rid)
            if s is not None:
                s.discard(h)
                if not s:
                    del self._by_replica[rid]
            sp = self._spilled.get(rid)
            if sp is not None:
                sp.discard(h)
                if not sp:
                    del self._spilled[rid]

    def register(self, hashes, replica_id: str):
        """Record that ``replica_id``'s store holds these pages (the
        router just routed the prompt there, or STATS said so). Last
        writer wins: the directory is best-effort routing state, not
        ownership."""
        rid = str(replica_id)
        with self._lock:
            for h in hashes:
                h = bytes(h)
                self._drop(h)
                self._map[h] = rid
                self._by_replica.setdefault(rid, set()).add(h)
            while len(self._map) > self._cap:
                self._drop(next(iter(self._map)))

    def replace(self, replica_id: str, hashes, spilled=()):
        """Reconcile with the replica's OWN prefix export (STATS): drop
        directory entries the replica no longer holds (evicted past its
        tiers, flushed on a weight refresh), add the ones it does.
        ``spilled`` marks the subset that lives in the replica's host/disk
        spill tiers rather than device memory: routable all the same (the
        replica re-uploads on a hit), but metered separately."""
        rid = str(replica_id)
        keep = {bytes(h) for h in hashes}
        with self._lock:
            stale = [h for h in self._by_replica.get(rid, ())
                     if h not in keep]
            for h in stale:
                self._drop(h)
            sp = {bytes(h) for h in spilled} & keep
            if sp:
                self._spilled[rid] = sp
            else:
                self._spilled.pop(rid, None)
        self.register(keep, rid)

    def invalidate(self, replica_id: str):
        """Membership churn: the replica left the rotation, so every
        entry pointing at it is dead weight."""
        rid = str(replica_id)
        with self._lock:
            for h in list(self._by_replica.get(rid, ())):
                self._drop(h)
            self._spilled.pop(rid, None)

    def is_spilled(self, h, replica_id: str) -> bool:
        """True when the replica advertised this hash from a SPILL tier:
        an affinity route to it re-uploads instead of reading the pool."""
        with self._lock:
            return bytes(h) in self._spilled.get(str(replica_id), ())

    def spilled_depth(self, replica_id: str) -> int:
        """How many of the replica's advertised pages are spilled."""
        with self._lock:
            return len(self._spilled.get(str(replica_id), ()))

    def lookup(self, hashes) -> tuple[str | None, int]:
        """``(replica_id, cached_pages)`` for the LONGEST prefix any
        replica holds, or ``(None, 0)``. The caller re-validates the
        replica against live membership and breaker state: the directory
        never blocks a route, it only biases one."""
        with self._lock:
            for i in range(len(hashes) - 1, -1, -1):
                rid = self._map.get(bytes(hashes[i]))
                if rid is not None:
                    return rid, i + 1
        return None, 0
