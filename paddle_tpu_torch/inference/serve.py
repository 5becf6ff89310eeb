"""The serve tier of the port: a standalone serving process and its wire
clients (counterpart of `paddle_tpu/inference/serve.py`; the port imports
nothing from it). Every wire format is the JAX package's, byte for byte,
so a JAX client, router or peer talks to a port replica and the reverse.

Run:  python -m paddle_tpu_torch.inference.serve --gpt-config g.json --port 0
(prints ``LISTENING <port>`` on stdout when ready; ``--device cpu`` serves
on the CPU, the default ``cuda`` on the card, and nothing falls back).

Wire protocol (little-endian):
  hello   : u32 magic | 32-byte sha256 auth digest (once per connection)
  request : u32 magic 'PRPD' | u32 op (1=run 2=ping 3=shutdown 4=stats
            5=generate 6=prometheus 7=cancel 8=migrate 9=prefill
            10=kv_stream 11=trace_export 12=debug_dump) | u32 n_arrays |
            arrays...
  array   : u8 dtype | u8 ndim | u32 dims[ndim] | u64 nbytes | bytes
  response: u32 magic | u32 status (0 ok else error) |
            ok: u32 n_arrays | arrays...   err: u32 len | utf8 message

bfloat16 arrays (dtype code 7) travel as their raw 16-bit words and come
out of `recv_arrays` as CPU ``torch.bfloat16`` tensors, which
`send_arrays` frames back byte-equal (the JAX package's ``ml_dtypes``
is not needed on either side).

GENERATE (op 5): int32 prompt ids (1-D), int32 [1] max_new_tokens, then
optionally an int32 options array ``[cache, speculate[, deadline_ms[,
key0..key3[, tid0..tid3, par0..par1]]]]`` (a deadline in ms, a 16-byte
idempotency key, the fleet trace context) and a uint8 cancel tag. The
request lands in the engine's scheduler queue; the engine thread batches
it with every other connection's, and the answer is one int32 array of
prompt + generated ids. Failures answer the typed error line
(`inference/errors.py`).

CANCEL (op 7): one uint8 tag of a concurrent GENERATE; int32 [1], 1 if it
named live work. A GENERATE whose client disconnects is cancelled too.

MIGRATE (op 8): one uint8 ``PTMG1`` blob from a draining peer
(`InferenceServer.drain(migrate_peers=...)`); the request resumes here
token-identically and the answer is its full id sequence, which the
sender splices into the original request's future.

PREFILL (op 9) / KV_STREAM (op 10): the two halves of disaggregated
serving. A ``--role prefill`` worker streams ``PTKS1`` page records as
its chunked prefill produces them; a decode replica takes the relayed
records with the request's options and answers the full id sequence as
GENERATE does, without any prefill program of its own.

STATS (4), PROMETHEUS (6), TRACE_EXPORT (11), DEBUG_DUMP (12): the port's
metrics registry as JSON, its Prometheus text, one trace's spans, and the
flight recorder's ring, each as one uint8 array.

Auth: every connection opens with the digest of the shared secret; a
mismatch drops it before any op is read. The secret is an explicit
``auth_name``, else ``PADDLE_SERVE_TOKEN``, else a random token the server
prints once (``TOKEN <hex>``).

Threads: the engine's `serve_loop` runs on the server's engine thread, the
only one that touches the card. Connection threads call only the engine's
host-side entry points (`submit`, `cancel`, `submit_import`,
`submit_prefill_stream`, `prefix_hashes`, `tier_hashes`, `take_migrated`).

Not here: the ``--model`` / ``model_prefix`` path, which serves a saved
model through a ``Predictor`` (ROADMAP A7); the soak harness (A5.6.5).
The router and the autoscaler that front several replicas are
`serving/router.py` and `serving/autoscale.py`.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import hmac
import json
import os
import random
import secrets as _secrets
import select
import socket
import struct
import threading
import time

import numpy as np

import torch

from paddle_tpu_torch.distributed.fleet.elastic import (NodeRegistry,
                                                        TcpNodeRegistry,
                                                        node_role,
                                                        role_node_id)
from paddle_tpu_torch.inference.errors import (Cancelled, DeadlineExceeded,
                                               HandoffCorrupt, from_wire)
from paddle_tpu_torch.inference.handoff import (pack_migration,
                                                unpack_migration)
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import flight
from paddle_tpu_torch.observability.tracing import (RequestTrace,
                                                    new_span_id,
                                                    trace_to_words,
                                                    words_to_trace)
from paddle_tpu_torch.testing import faults

MAGIC = 0x50445250
(OP_RUN, OP_PING, OP_SHUTDOWN, OP_STATS, OP_GENERATE, OP_PROMETHEUS,
 OP_CANCEL, OP_MIGRATE, OP_PREFILL, OP_KV_STREAM, OP_TRACE_EXPORT,
 OP_DEBUG_DUMP) = \
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12

# replica tiers (docs/SERVING.md "Disaggregated serving"): "both" is the
# legacy symmetric replica; a "prefill" worker serves OP_PREFILL only
# (never GENERATE/MIGRATE — it must not decode) and a "decode" replica
# never serves OP_PREFILL (it must never compile a prefill program in
# disaggregated operation — the no-retrace pin, tests/test_disagg.py)
REPLICA_ROLES = ("both", "prefill", "decode")


def auth_token(secret_name: str | None = None) -> bytes:
    """Digest both sides compare: sha256 of the EXPLICIT shared secret
    (the server's printed startup token or its ``auth_name``) when one is
    given, else of ``PADDLE_SERVE_TOKEN``. Explicit beats ambient on both
    sides — an exported env var for deployment A must not silently
    override the secret a client deliberately passes for deployment B."""
    if secret_name is not None:
        secret = f"pt-serve:{secret_name}"
    else:
        secret = os.environ.get("PADDLE_SERVE_TOKEN") or ""
    return hashlib.sha256(secret.encode()).digest()

def retrying_connect(host, port, *, timeout=60.0, attempts=5,
                     base_delay_s=0.05, max_delay_s=2.0, deadline_s=None,
                     jitter=0.5):
    """``socket.create_connection`` with exponential backoff + jitter and a
    hard deadline. A replica restart (rolling deploy, elastic eviction)
    surfaces as a few hundred ms of ``ConnectionRefusedError`` — retrying
    with backoff rides it out instead of failing the caller instantly,
    and the jitter keeps a fleet of reconnecting clients from stampeding
    the fresh process. ``deadline_s`` caps the WHOLE dance (sleeps are
    clipped to it), so a hung endpoint can never hold a caller past it.
    Used by `RemotePredictor` and a migrating drain."""
    t_end = None if deadline_s is None else time.monotonic() + deadline_s
    delay = base_delay_s
    last = None
    for i in range(max(1, int(attempts))):
        if t_end is not None and time.monotonic() >= t_end:
            break
        try:
            to = timeout if t_end is None \
                else max(0.001, min(timeout, t_end - time.monotonic()))
            sock = socket.create_connection((host, int(port)), timeout=to)
            # the deadline bounds the CONNECT dance only; request IO on the
            # established socket gets the caller's full timeout back
            sock.settimeout(timeout)
            return sock
        except OSError as e:
            last = e
        if i == attempts - 1:
            break
        sleep = delay * (1.0 + jitter * random.random())
        if t_end is not None:
            sleep = min(sleep, max(0.0, t_end - time.monotonic()))
        time.sleep(sleep)
        delay = min(delay * 2.0, max_delay_s)
    raise ConnectionError(
        f"connect to {host}:{port} failed after {attempts} attempts"
        + (f" (deadline {deadline_s}s)" if deadline_s is not None else "")
        + f": {type(last).__name__ if last else 'deadline'}: {last}")


_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "bool",
           "float16", "bfloat16", "int8", "int16", "uint16", "uint32",
           "uint64"]
_DTYPE_CODE = {n: i for i, n in enumerate(_DTYPES)}


def peek_disconnect(conn) -> str:
    """Non-blocking client-liveness peek, shared by serve's GENERATE wait
    and the router's replica wait (the cross-tier disconnect chain,
    docs/ROBUSTNESS.md): a request/response client sends NOTHING while
    awaiting its answer, so readable means EOF (``"gone"``) or
    protocol-violating pipelined bytes (``"pipelined"`` — the caller
    stops watching and lets the op loop sort it out); ``"quiet"`` is the
    healthy case. A socket torn down under the peek reads as gone."""
    try:
        readable, _, _ = select.select([conn], [], [], 0)
        if not readable:
            return "quiet"
        return "gone" if conn.recv(1, socket.MSG_PEEK) == b"" \
            else "pipelined"
    except OSError:
        return "gone"


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _wire_view(a) -> tuple[str, np.ndarray]:
    """``(wire dtype name, contiguous numpy array of the bytes)`` of a
    numpy array or a tensor; bfloat16 (a tensor, or an ``ml_dtypes`` array
    a caller made) as its raw 16-bit words."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        a = t.numpy()
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.int16)
    return a.dtype.name, a


def send_arrays(sock, arrays):
    parts = []
    for a in arrays:
        name, a = _wire_view(a)
        if name not in _DTYPE_CODE:
            raise TypeError(f"unsupported wire dtype {name}")
        parts.append(struct.pack("<BB", _DTYPE_CODE[name], a.ndim))
        parts.append(struct.pack(f"<{a.ndim}I", *a.shape))
        parts.append(struct.pack("<Q", a.nbytes))
        parts.append(a.tobytes())
    sock.sendall(b"".join(parts))


def recv_arrays(sock, n):
    """``n`` framed arrays: numpy arrays, bfloat16 ones as CPU
    ``torch.bfloat16`` tensors of the same bits."""
    out = []
    for _ in range(n):
        code, ndim = struct.unpack("<BB", _recv_exact(sock, 2))
        dims = struct.unpack(f"<{ndim}I", _recv_exact(sock, 4 * ndim))
        (nbytes,) = struct.unpack("<Q", _recv_exact(sock, 8))
        raw = _recv_exact(sock, nbytes)
        name = _DTYPES[code]
        if name == "bfloat16":
            words = np.frombuffer(raw, np.int16).reshape(dims).copy()
            out.append(torch.from_numpy(words).view(torch.bfloat16))
        else:
            out.append(np.frombuffer(raw, dtype=np.dtype(name))
                       .reshape(dims).copy())
    return out


class InferenceServer:
    """Owns one in-process decode engine; serves generate() and the other
    wire ops over TCP.

    ``engine`` is a `paddle_tpu_torch.inference.engine.DecodeEngine`; a
    dedicated thread runs its `serve_loop` (the only thread that touches
    its device), so GENERATE requests from any number of connections batch
    onto the same fixed-shape decode step. ``model_prefix`` (a saved model
    served by a ``Predictor``, the RUN op) is not ported (ROADMAP A7): it
    raises NotImplementedError.

    Auth secret, in order: an explicit ``auth_name`` (a deployment-chosen
    shared string; clients pass it as ``secret=`` — explicit beats
    ambient), else ``PADDLE_SERVE_TOKEN`` (same env on clients), else a
    RANDOM per-startup token in ``generated_secret`` that the CLI prints
    once as ``TOKEN <hex>``: a secret anyone could derive would let
    whoever reaches the port SHUTDOWN the server."""

    def __init__(self, model_prefix, host="127.0.0.1", port=0, engine=None,
                 auth_name=None, role="both"):
        if model_prefix is None and engine is None:
            raise ValueError("need a model_prefix, an engine, or both")
        if model_prefix is not None:
            raise NotImplementedError(
                "model_prefix= serves a saved model through a Predictor, "
                "which the port does not have yet (ROADMAP A7); serve a "
                "decode engine with engine=")
        if role not in REPLICA_ROLES:
            raise ValueError(
                f"role must be one of {REPLICA_ROLES}, got {role!r}")
        self.role = role
        self.generated_secret = None
        if auth_name is not None:
            basis = auth_name            # explicit beats the env var
        elif os.environ.get("PADDLE_SERVE_TOKEN"):
            basis = None                 # the env var IS the secret
        else:
            self.generated_secret = _secrets.token_hex(16)
            basis = self.generated_secret
        self._engine = engine
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._token = auth_token(
            basis if basis is None else str(basis))
        self._registry = None          # elastic-registry lease (drain leaves)
        self._draining = False
        self._migrating = False    # a migrate drain's export is underway
        # --migrate-on-drain: a bare drain() (e.g. the SIGTERM handler)
        # live-migrates in-flight work to registry-discovered peers
        self.migrate_on_drain = False
        self._tags: dict[bytes, str] = {}   # cancel tag -> engine req id
        self._tag_lock = threading.Lock()
        # requests in flight to a migration peer: req id -> the open
        # OP_MIGRATE socket (None before the first ship attempt). A
        # cancel for an EXPORTED request — the engine no longer owns it —
        # marks _mig_cancelled and drops the socket, so the peer's own
        # disconnect watch cancels into ITS engine (the chain composes
        # client -> victim -> peer -> engine, tests/test_migration.py)
        self._mig_socks: dict[str, socket.socket | None] = {}
        self._mig_cancelled: dict[str, str] = {}
        self._mig_lock = threading.Lock()
        self._drain_thread = None      # set by install_sigterm_drain's handler
        self._engine_thread = None
        if engine is not None:
            self._engine_thread = threading.Thread(
                target=engine.serve_loop, args=(self._stop,), daemon=True)
            self._engine_thread.start()

    def attach_registry(self, registry):
        """Hold the elastic-registry lease this replica registered under
        (`distributed/fleet/elastic.py` NodeRegistry/TcpNodeRegistry);
        `drain()` deregisters it so the router stops sending traffic before
        the process exits. The lease id becomes this process's fleet
        identity for the observability plane (trace exports + metrics
        re-labeling, docs/OBSERVABILITY.md)."""
        self._registry = registry
        rid = getattr(registry, "node_id", None)
        if rid:
            metrics.set_node_identity(role=self.role, node_id=rid)
        return self

    def drain(self, deadline_s=30.0, migrate_peers=None):
        """Graceful shutdown (SIGTERM contract, docs/SERVING.md): refuse
        new GENERATE submits, let everything in flight finish for up to
        ``deadline_s``, deregister from the elastic registry, then stop
        the server (stragglers past the deadline are aborted by the engine
        thread's shutdown path). Returns True when all in-flight work
        finished inside the deadline.

        ``migrate_peers`` (docs/SERVING.md "Live migration"): peer
        replica endpoints ("host:port" iterable, or a {replica_id:
        endpoint} mapping) sharing this replica's auth secret. When
        given — or when ``migrate_on_drain`` is set and the registry
        lists other alive replicas — the drain LIVE-MIGRATES instead of
        waiting: the engine exports every in-flight request at its next
        step boundary (mid-decode ones as warm KV handoffs), each item
        ships to a peer over OP_MIGRATE with bounded per-peer fallback,
        and the peer's tokens are spliced into the ORIGINAL request
        future — the blocked client (or router) sees a normal answer,
        zero errors. Drain wall-clock becomes one step + the transfer,
        not the longest running generation."""
        metrics.counter("serve.drains").inc()
        self._draining = True
        peers = migrate_peers
        if peers is None and self.migrate_on_drain:
            peers = self._discover_peers()
        if isinstance(peers, dict):
            peers = list(peers.values())
        peers = [str(p) for p in (peers or [])]
        migrate = bool(peers) and self._engine is not None
        clean = True
        if self._engine is not None:
            if migrate:
                # set BEFORE the engine starts exporting: _cancel_request
                # consults this to record export-window cancels
                self._migrating = True
            self._engine.drain(migrate=migrate)
            t_end = time.monotonic() + float(deadline_s)
            if migrate:
                try:
                    items = self._engine.take_migrated(
                        timeout=float(deadline_s))
                except TimeoutError:
                    items, clean = [], False
                if items:
                    clean = self._migrate_items(items, peers, t_end) \
                        and clean
                self._migrating = False
                with self._mig_lock:
                    # export-window cancels for requests that never made
                    # it into an item (completed first, or aborted)
                    self._mig_cancelled.clear()
            while self._engine._has_work():
                if time.monotonic() >= t_end:
                    clean = False
                    break
                time.sleep(0.01)
        if self._registry is not None:
            try:
                self._registry.leave()
            except OSError:
                pass               # registry gone: exiting anyway
        self._stop.set()
        if self._engine_thread is not None \
                and self._engine_thread is not threading.current_thread():
            # join the engine thread before reporting drained: a process
            # that exits while the loop's final abort still runs device
            # calls tears the backend down under it (C++ terminate at
            # interpreter shutdown)
            self._engine_thread.join(timeout=30.0)
        return clean

    # -------------------------------------------------------- live migration

    def _discover_peers(self) -> list[str]:
        """Registry-based peer discovery for ``migrate_on_drain``: every
        OTHER alive REPLICA's endpoint (own lease excluded by node id and
        endpoint; router-role leases excluded by role — a router cannot
        decode a migrated request, docs/ROBUSTNESS.md "Control-plane
        HA"). Sorted for a deterministic fallback order."""
        if self._registry is None:
            return []
        try:
            alive = self._registry.alive_nodes()
        except OSError:
            return []
        own_id = getattr(self._registry, "node_id", None)
        own_ep = str(getattr(self._registry, "endpoint", None))
        # exclude the KNOWN non-decoding roles only: routers cannot
        # decode at all, and a prefill-tier worker refuses MIGRATE by
        # contract. A NEGATIVE filter on purpose — an unknown role
        # (including a legacy id whose colon prefix merely parses as
        # one, e.g. "east-1:replica-3") keeps its earlier behavior as a
        # decode-capable migration peer
        return [str(ep) for rid, ep in sorted(alive.items())
                if rid != own_id and str(ep) != own_ep
                and node_role(rid) not in ("router", "prefill")]

    def _migrate_items(self, items, peers, t_end) -> bool:
        """Ship each exported :class:`MigrationItem` to a peer and splice
        the peer's answer into the ORIGINAL request future. Items ship
        CONCURRENTLY (one slow peer must not serialize the drain) with
        bounded per-peer fallback — each peer tried at most once per item,
        start offset rotated by item index to spread the load. Terminal
        typed outcomes from the peer (``DeadlineExceeded``/``Cancelled``)
        pass through to the future verbatim; transport failures and
        not-taking-work answers fall back to the next peer; all peers
        dead answers ONE bounded typed error, never a hang. Fault site
        ``serve.migrate_drop`` makes a peer attempt fail (chaos: peer
        death mid-migration, docs/ROBUSTNESS.md)."""
        done_ok = []
        # the cancel tag (if the client registered one) travels WITH the
        # request, so the peer can register it too and a post-migration
        # CANCEL still reaches the engine actually decoding
        with self._tag_lock:
            rev = {rid: t for t, rid in self._tags.items()}
        with self._mig_lock:
            for it in items:
                it.tag = rev.get(it.request.request_id)
                self._mig_socks.setdefault(it.request.request_id, None)

        def _one(idx, item):
            req = item.request
            arr = np.frombuffer(pack_migration(item), np.uint8)
            if faults.ENABLED and faults.fire("serve.blob_corrupt"):
                # wire-integrity drill (docs/ROBUSTNESS.md): flip one
                # byte deep in the blob BODY — the peer's checksum
                # verification must refuse it typed (HandoffCorrupt,
                # serve.blob_corrupt_refused) and the per-peer fallback
                # re-packs the INTACT item for the next attempt
                arr = arr.copy()
                arr[-max(1, arr.size // 3)] ^= 0xFF
            last = None
            # bounded per-peer fallback, start rotated by item index; a
            # HandoffCorrupt refusal may re-queue ONE attempt to the same
            # peer with a freshly packed blob (the peer is healthy — the
            # BYTES were damaged)
            order = [peers[(idx + k) % len(peers)]
                     for k in range(len(peers))]
            reshipped = False
            i = 0
            try:
                while i < len(order):
                    reason = self._mig_cancel_reason(req.request_id)
                    if reason is not None:
                        # cancelled while migrating (client disconnect,
                        # wait budget, CANCEL op): terminal, no more peers
                        req._finish(f"Cancelled: {reason}")
                        done_ok.append(True)
                        return
                    ep = order[i]
                    i += 1
                    if faults.ENABLED and faults.fire("serve.migrate_drop"):
                        metrics.counter("serve.migrate_drops").inc()
                        last = f"{ep}: FaultInjected: serve.migrate_drop"
                        continue
                    budget = t_end - time.monotonic()
                    if budget <= 0:
                        last = last or "migration deadline exhausted"
                        break
                    try:
                        out = self._ship_migration(
                            ep, arr, timeout=budget,
                            track_as=req.request_id)
                    except (DeadlineExceeded, Cancelled) as e:
                        # terminal per-request outcomes: the deadline is
                        # the client's own clock and the cancel its own
                        # doing — another peer changes neither, relay
                        # verbatim
                        req._finish(f"{type(e).__name__}: {e}")
                        done_ok.append(True)
                        return
                    except Exception as e:  # noqa: BLE001 — classify below
                        last = f"{ep}: {type(e).__name__}: {e}"
                        if isinstance(e, HandoffCorrupt):
                            # the peer refused the BLOB, not the request:
                            # the bytes were damaged in flight (or by the
                            # serve.blob_corrupt drill) — re-pack from
                            # the intact in-memory item and give the SAME
                            # peer one clean re-ship (once per item)
                            # instead of burning a healthy peer on
                            # damaged bytes
                            arr = np.frombuffer(pack_migration(item),
                                                np.uint8)
                            if not reshipped:
                                reshipped = True
                                order.insert(i, ep)
                        continue
                    out = np.asarray(out).reshape(-1)
                    req.generated = [int(t)
                                     for t in out[req.prompt.size:]]
                    req._finish(None)
                    metrics.counter("serve.migrations_out").inc()
                    done_ok.append(True)
                    return
                reason = self._mig_cancel_reason(req.request_id)
                if reason is not None:
                    # the failed exchange WAS the cancel: _cancel_request
                    # dropped our peer socket to stop the decode
                    req._finish(f"Cancelled: {reason}")
                    done_ok.append(True)
                    return
                metrics.counter("serve.migrate_failed").inc()
                req._finish(
                    f"migration failed: no peer accepted the request "
                    f"({len(peers)} tried); last: {last}")
            finally:
                with self._mig_lock:
                    self._mig_socks.pop(req.request_id, None)
                    self._mig_cancelled.pop(req.request_id, None)

        # bounded worker pool, not one thread per item: a SIGTERM with a
        # deep queue would otherwise open len(items) simultaneous sockets
        # against a small peer set — a thread/FD storm on the victim and
        # a connection storm on the survivors at the exact moment the
        # fleet is losing capacity. Items still ship concurrently (one
        # slow peer cannot serialize the drain) at a fixed cost.
        work = collections.deque(enumerate(items))

        def _runner():
            while True:
                try:
                    idx, item = work.popleft()   # GIL-atomic
                except IndexError:
                    return
                _one(idx, item)

        ths = [threading.Thread(target=_runner, daemon=True,
                                name=f"pt-serve-migrate-{i}")
               for i in range(min(len(items), 16))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=max(0.0, t_end - time.monotonic()) + 30.0)
        return len(done_ok) == len(items)

    def _mig_cancel_reason(self, request_id: str) -> str | None:
        with self._mig_lock:
            return self._mig_cancelled.get(request_id)

    def _ship_migration(self, endpoint: str, blob_arr, timeout: float,
                        track_as: str | None = None):
        """One OP_MIGRATE exchange with a peer replica on a fresh authed
        connection (the fleet-shared secret this server was started
        with). Returns the peer's full int32 id sequence or raises the
        peer's typed error (`from_wire`). ``track_as`` publishes the
        socket under the migrating request's id so `_cancel_request` can
        drop it — the only way to stop a decode that already left for
        the peer."""
        host, port = endpoint.rsplit(":", 1)
        sock = retrying_connect(host, int(port), timeout=max(1.0, timeout),
                                attempts=2,
                                deadline_s=min(5.0, max(0.5, timeout)))
        if track_as is not None:
            with self._mig_lock:
                self._mig_socks[track_as] = sock
        try:
            sock.sendall(struct.pack("<I", MAGIC) + self._token)
            sock.sendall(struct.pack("<III", MAGIC, OP_MIGRATE, 1))
            send_arrays(sock, [blob_arr])
            magic, status, n = struct.unpack(
                "<III", _recv_exact(sock, 12))
            if magic != MAGIC:
                raise ConnectionError(
                    f"bad magic from migration peer {endpoint} (auth "
                    f"mismatch drops the connection — the fleet must "
                    f"share one auth secret)")
            if status != 0:
                raise from_wire(
                    _recv_exact(sock, n).decode(errors="replace"))
            (out,) = recv_arrays(sock, n)
            return out
        finally:
            sock.close()

    def _migrate_in(self, arrays, trace, conn):
        """MIGRATE op body (the RECEIVING replica): unpack the PTMG1 blob,
        resume the request — warm handoffs through the engine's
        `submit_import` mailbox (applied between fixed-shape steps; this
        connection thread never touches device state), cold prompts
        through plain `submit` — and block for the full answer exactly
        like GENERATE does, client-disconnect watch included."""
        if self._draining:
            raise RuntimeError(
                "server draining: not accepting new requests")
        if self._engine is None:
            raise RuntimeError("no decode engine attached "
                               "(start with --gpt-config or engine=)")
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-role replica does not decode: MIGRATE needs a "
                "decode-capable tier (role=both|decode)")
        if len(arrays) != 1:
            raise ValueError(
                f"MIGRATE wants one uint8 PTMG1 blob array, "
                f"got {len(arrays)}")
        try:
            item = unpack_migration(
                np.ascontiguousarray(arrays[0], np.uint8).tobytes())
        except HandoffCorrupt:
            # wire integrity (docs/ROBUSTNESS.md): a truncated/bit-flipped
            # blob is REFUSED typed — the sender falls back to re-shipping
            # from its intact in-memory item, never to decoding garbage
            metrics.counter("serve.blob_corrupt_refused").inc()
            raise
        if trace is not None:
            # the ORIGINAL ingress trace id rode the PTMG1 header: the
            # peer's spans land in the same stitched trace, parented on
            # the source replica's span (docs/OBSERVABILITY.md)
            trace.attach_context(item.trace_id, item.parent_span)
        deadline_s = None if item.deadline_ms is None \
            else item.deadline_ms / 1000.0
        if item.handoff is not None:
            req = self._engine.submit_import(
                item.handoff, max_new_tokens=item.max_new_tokens,
                deadline_s=deadline_s, trace=trace, cache=item.cache,
                speculate=item.speculate, request_key=item.request_key)
        else:
            smp = item.sample or {}     # a COLD sampled item restarts its
            req = self._engine.submit(  # chain from the original seed
                item.prompt, item.max_new_tokens,
                trace=trace, deadline_s=deadline_s,
                cache=item.cache, speculate=item.speculate,
                request_key=item.request_key,
                temperature=smp.get("temperature", 1.0),
                top_k=smp.get("top_k", 0), seed=smp.get("seed", 0))
        # the request's cancel tag rode the blob: register it HERE so a
        # post-migration CANCEL (the router broadcasts to every replica)
        # reaches the engine that now owns the decode
        with self._tagged(item.tag, req.request_id):
            out = self._await_result(req, conn, deadline_s)
        metrics.counter("serve.migrations_in").inc()
        return np.ascontiguousarray(out, np.int32)

    # ------------------------------------------------ disaggregated serving

    def _stats_extra(self) -> dict:
        """Disaggregation extras riding the STATS payload: this
        replica's ``role`` plus the engine's prefix-store export —
        page size and the rolling page hashes it currently indexes —
        the data source of the router's fleet prefix directory
        (docs/SERVING.md "Disaggregated serving"). ``node`` is the fleet
        identity (role + registry-lease id + pid) the metrics plane uses
        to re-label this replica's rows (docs/OBSERVABILITY.md)."""
        extra: dict = {"role": self.role, "node": metrics.node_identity()}
        if self._engine is not None:
            extra["prefix"] = {
                "page_size": int(self._engine.ecfg.page_size)}
            if self.role == "prefill":
                # the hash list is the fleet directory's data source and
                # only prefill workers are affinity targets — exporting a
                # decode replica's (potentially large) store every STATS
                # pull would be recurring wire bytes nobody reads
                hashes = self._engine.prefix_hashes()
                metrics.gauge("engine.prefix_exported_hashes").set(
                    len(hashes))
                extra["prefix"]["hashes"] = hashes
                # KV tiering (docs/SERVING.md "KV tiering"): the spilled
                # chains ride too — a directory hit on a spilled prefix
                # routes here so THIS replica re-uploads instead of the
                # fleet re-prefilling
                spilled = self._engine.tier_hashes()
                metrics.gauge("engine.kvtier.exported_hashes").set(
                    len(spilled))
                if spilled:
                    extra["prefix"]["spilled"] = spilled
        return extra

    def _prefill_stream(self, arrays, conn) -> bool:
        """OP_PREFILL body (the PREFILL-WORKER side of disaggregation,
        docs/SERVING.md "Disaggregated serving"): run the engine's
        chunked prefill for one prompt and stream the resulting PTKS1
        records back AS THEY ARE PRODUCED — response header first (the
        record count is known once the prefix-cache lookup fixes the
        chunk plan), then one uint8 array per record. The engine does
        the device work on ITS loop thread (`submit_prefill_stream`
        mailbox); this connection thread only relays.

        Returns False when the stream died AFTER the response header
        went out (engine failure mid-prefill, receiver gone, or the
        ``serve.stream_drop`` fault drill) — the caller drops the
        connection, and the router's fallback re-runs the prefill
        symmetrically on the decode replica. Failures BEFORE the header
        raise and travel back as a normal typed wire error."""
        if self._draining:
            raise RuntimeError(
                "server draining: not accepting new requests")
        if self._engine is None:
            raise RuntimeError("no decode engine attached "
                               "(start with --gpt-config or engine=)")
        if self.role == "decode":
            raise RuntimeError(
                "decode-role replica serves no PREFILL (its engine must "
                "never compile a prefill program — the disaggregation "
                "no-retrace pin)")
        if len(arrays) not in (1, 2):
            raise ValueError(
                f"PREFILL wants [prompt_ids[, options]], got "
                f"{len(arrays)} arrays")
        cache = True
        trace_ctx = None
        if len(arrays) == 2:
            # width 7 appends the fleet trace context (4 trace-id words +
            # 2 parent-span words, all-zero = absent) — the worker's
            # prefill spans join the stitched trace and the context rides
            # onward in the PTKS1 header (docs/OBSERVABILITY.md)
            opts = np.asarray(arrays[1]).reshape(-1)
            if opts.size not in (1, 7):
                raise ValueError(
                    f"PREFILL options wants int32 [cache[, tid0..tid3, "
                    f"par0..par1]], got {opts.size} values")
            cache = bool(int(opts[0]))
            if opts.size == 7:
                tid, parent = words_to_trace([int(w) for w in opts[1:7]])
                if tid is not None:
                    trace_ctx = (tid, parent)
        sink = self._engine.submit_prefill_stream(arrays[0], cache=cache,
                                                  trace_ctx=trace_ctx)
        kind, val = sink.get(timeout=600.0)
        if kind == "err":
            raise from_wire(val)
        n_records = int(val)
        conn.sendall(struct.pack("<III", MAGIC, 0, n_records))
        for _ in range(n_records):
            kind, val = sink.get(timeout=600.0)
            if kind != "rec":
                # the engine died mid-stream with the header already out:
                # the response is unfinishable — drop the connection so
                # the router's fallback takes over
                metrics.counter("serve.prefill_stream_errors").inc()
                return False
            if faults.ENABLED and faults.fire("serve.stream_drop"):
                # deterministic mid-stream worker death (testing/
                # faults.py): the receiver sees the stream end early and
                # must discard the partial pages cleanly
                metrics.counter("serve.stream_drops").inc()
                return False
            try:
                send_arrays(conn, [np.frombuffer(val, np.uint8)])
            except OSError:
                return False          # receiver gone mid-stream
        metrics.counter("serve.prefill_streams").inc()
        return True

    def _kv_stream_in(self, arrays, trace, conn):
        """OP_KV_STREAM body (the DECODE-REPLICA side): assemble the
        relayed PTKS1 records — every record checksum-verified, a
        damaged or short stream refused typed BEFORE any page is
        adopted, so a partial stream leaves this pool at baseline — and
        the moment the final record lands, admit the slot through the
        engine's import mailbox and decode to completion. Wire shape:
        ``[options int32 [max_new_tokens, cache, speculate, deadline_ms
        [, key0..key3]], tag uint8 (may be empty), record uint8 ...]``.
        The response is the full int32 id sequence, exactly what a
        symmetric GENERATE would answer — deadlines, the cancel tag, and
        the idempotency key all ride the options so the whole
        request-control surface survives disaggregation."""
        if self._draining:
            raise RuntimeError(
                "server draining: not accepting new requests")
        if self._engine is None:
            raise RuntimeError("no decode engine attached "
                               "(start with --gpt-config or engine=)")
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-role replica does not decode (KV_STREAM needs "
                "role=both|decode)")
        if len(arrays) < 3:
            raise ValueError(
                f"KV_STREAM wants [options, tag, record...], got "
                f"{len(arrays)} arrays")
        opts = np.asarray(arrays[0]).reshape(-1)
        if opts.size not in (4, 8, 14):
            raise ValueError(
                f"KV_STREAM options wants int32 [max_new_tokens, cache, "
                f"speculate, deadline_ms[, key0..key3[, tid0..tid3, "
                f"par0..par1]]], got {opts.size} values")
        mnt = int(opts[0])
        cache, speculate = bool(int(opts[1])), bool(int(opts[2]))
        deadline_s = int(opts[3]) / 1000.0 if int(opts[3]) > 0 else None
        key = np.ascontiguousarray(opts[4:8], np.int32).tobytes() \
            if opts.size >= 8 and np.any(opts[4:8]) else None
        if opts.size == 14 and trace is not None:
            tid, parent = words_to_trace([int(w) for w in opts[8:14]])
            trace.attach_context(tid, parent)
        tag = np.ascontiguousarray(arrays[1], np.uint8).tobytes() or None
        # imported here: `serving/__init__.py` loads the router, which
        # imports this module
        from paddle_tpu_torch.serving.disagg import KVStreamAssembler
        asm = KVStreamAssembler()
        handoff = None
        try:
            for rec in arrays[2:]:
                handoff = asm.feed(
                    np.ascontiguousarray(rec, np.uint8).tobytes())
            if handoff is None:
                raise HandoffCorrupt(
                    "KV stream ended without a final record")
        except HandoffCorrupt:
            # same refusal discipline as OP_MIGRATE blob damage: typed,
            # counted, and nothing was adopted (docs/ROBUSTNESS.md
            # "Wire integrity")
            metrics.counter("serve.blob_corrupt_refused").inc()
            raise
        if trace is not None and asm.trace_ctx is not None:
            # header-carried context (idempotent: a context that already
            # arrived via the options wins) — a direct worker->decode
            # stream stays traced even without the router's options relay
            trace.attach_context(*asm.trace_ctx)
        req = self._engine.submit_import(
            handoff, max_new_tokens=mnt, deadline_s=deadline_s,
            trace=trace, cache=cache, speculate=speculate,
            request_key=key)
        with self._tagged(tag, req.request_id):
            out = self._await_result(req, conn, deadline_s)
        metrics.counter("serve.kv_stream_in").inc()
        return np.ascontiguousarray(out, np.int32)

    def serve_forever(self):
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.5)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._client_loop, args=(conn,),
                                 daemon=True)
            t.start()
        self._sock.close()

    def _client_loop(self, conn):
        try:
            # connection hello: magic + 32-byte shared-secret digest; a bad
            # or missing digest drops the connection before any op is read
            try:
                conn.settimeout(10.0)
                hello = _recv_exact(conn, 4 + 32)
            except (ConnectionError, socket.timeout):
                return
            (magic,) = struct.unpack("<I", hello[:4])
            if magic != MAGIC or not hmac.compare_digest(hello[4:],
                                                         self._token):
                return
            conn.settimeout(None)
            while not self._stop.is_set():
                try:
                    head = _recv_exact(conn, 12)
                except ConnectionError:
                    return
                magic, op, n = struct.unpack("<III", head)
                if magic != MAGIC:
                    self._send_err(conn, "bad magic")
                    return
                if op == OP_PING:
                    conn.sendall(struct.pack("<III", MAGIC, 0, 0))
                    continue
                if op == OP_STATS:
                    # stats endpoint: the process metrics snapshot as one
                    # uint8 JSON array — same array framing as every other
                    # response, so any wire client can read it. Engine
                    # servers also export their role and prefix-store
                    # hashes (the router directory's data source)
                    conn.sendall(struct.pack("<III", MAGIC, 0, 1))
                    send_arrays(conn, [stats_payload(self._stats_extra())])
                    continue
                if op == OP_PROMETHEUS:
                    # same framing, Prometheus text exposition body: wire
                    # clients can relay it to a scraper without HTTP
                    conn.sendall(struct.pack("<III", MAGIC, 0, 1))
                    send_arrays(conn, [np.frombuffer(
                        metrics.to_prometheus().encode(),
                        dtype=np.uint8).copy()])
                    continue
                if op == OP_TRACE_EXPORT:
                    # fleet tracing pull: one uint8 array carrying the
                    # 16-byte trace id; response = uint8 JSON {node,
                    # trace_id, spans} with wall-rebased timestamps — the
                    # fleet collector (observability/fleet.py) stitches
                    # these from every registry member into ONE trace
                    arrays = recv_arrays(conn, n)
                    if len(arrays) != 1:
                        self._send_err(conn, "ValueError: TRACE_EXPORT "
                                             "wants one uint8 trace-id "
                                             "array")
                        return
                    tid = np.ascontiguousarray(
                        arrays[0], np.uint8).tobytes().hex()
                    conn.sendall(struct.pack("<III", MAGIC, 0, 1))
                    send_arrays(conn, [trace_export_payload(tid)])
                    continue
                if op == OP_DEBUG_DUMP:
                    # remote flight-recorder pull (the SIGUSR1 dump,
                    # minus the shell access): uint8 JSON {node, events,
                    # metrics} — `router --dump <replica>` relays it so
                    # an operator can inspect a wedged replica's ring
                    recv_arrays(conn, n)
                    conn.sendall(struct.pack("<III", MAGIC, 0, 1))
                    send_arrays(conn, [debug_dump_payload()])
                    continue
                if op == OP_SHUTDOWN:
                    conn.sendall(struct.pack("<III", MAGIC, 0, 0))
                    self._stop.set()
                    return
                t0 = time.perf_counter()
                # the request's SLO clock starts HERE, at wire accept —
                # body receive, queue wait, prefill and decode all count
                trace = RequestTrace() \
                    if op in (OP_GENERATE, OP_MIGRATE, OP_KV_STREAM) \
                    else None
                try:
                    if faults.ENABLED:
                        faults.fire("serve.slow_read")   # slow client
                        if faults.fire("serve.socket_drop"):
                            return      # network drop: close, no response
                    arrays = recv_arrays(conn, n)
                    metrics.counter("serve.request_bytes").inc(
                        sum(a.nbytes for a in arrays))
                    if op == OP_PREFILL:
                        # streaming response: the body sends its own
                        # header + one array per PTKS1 record AS THE
                        # ENGINE PRODUCES THEM (the whole point — the
                        # wire transfer overlaps the prefill compute).
                        # False = the stream died after the header went
                        # out (fault drill or engine failure): the
                        # response is unfinishable, drop the connection
                        # — the router falls back to symmetric prefill
                        if not self._prefill_stream(arrays, conn):
                            return
                        continue
                    if op == OP_GENERATE:
                        outs = [self._generate(arrays, trace, conn)]
                        if faults.ENABLED and faults.fire("serve.ack_drop"):
                            # the ACCEPTED-BUT-UNANSWERED window: the
                            # generation ran to completion, the answer is
                            # about to ship, and the connection dies —
                            # the ambiguous failure exactly-once exists
                            # for. The client's resubmit (same request
                            # key) replays the cached answer instead of
                            # re-burning the generation
                            # (docs/ROBUSTNESS.md "Control-plane HA")
                            return
                    elif op == OP_MIGRATE:
                        outs = [self._migrate_in(arrays, trace, conn)]
                    elif op == OP_KV_STREAM:
                        outs = [self._kv_stream_in(arrays, trace, conn)]
                    elif op == OP_CANCEL:
                        outs = [self._cancel_op(arrays)]
                    else:
                        # OP_RUN (and any unknown op): the port serves no
                        # model artifact (ROADMAP A7)
                        raise RuntimeError(
                            "engine-only server: no model artifact "
                            "loaded, only GENERATE/PING/STATS served")
                    conn.sendall(struct.pack("<III", MAGIC, 0, len(outs)))
                    send_arrays(conn, outs)
                    metrics.counter("serve.requests").inc()
                    metrics.counter("serve.response_bytes").inc(
                        sum(a.nbytes for a in outs))
                    dt = time.perf_counter() - t0
                    metrics.histogram("serve.request_seconds").observe(dt)
                    metrics.add_span("serve.request", t0, dt, cat="serve")
                except Exception as e:  # noqa: BLE001 — wire back to client
                    metrics.counter("serve.errors").inc()
                    if trace is not None and not trace.done:
                        # a GENERATE that died BEFORE engine retirement
                        # (submit validation, dead engine, result timeout)
                        # still closes its trace: the failure shows up in
                        # serve.request_errors and the Chrome trace instead
                        # of vanishing from the per-request tooling
                        trace.mark_done(f"{type(e).__name__}: {e}")
                    try:
                        self._send_err(conn, f"{type(e).__name__}: {e}")
                    except OSError:
                        pass    # client gone (disconnect-cancel path):
                        #         nothing to report to, nobody to crash
                    # the request body may be partially unconsumed (e.g. a
                    # reshape error mid-recv_arrays): the stream position is
                    # unknowable, so the next 12-byte header read would parse
                    # payload garbage and permanently desync — drop the
                    # connection after reporting
                    return
        finally:
            conn.close()

    def _generate(self, arrays, trace=None, conn=None):
        """GENERATE op body: enqueue into the engine's scheduler and block
        this connection thread on the request future — the engine thread
        does the actual batched decoding. ``trace`` is the wire-accept
        `RequestTrace`; the engine carries it to retirement. While
        blocked, the wait WATCHES ``conn`` for a client disconnect: a
        GENERATE whose client hung up is cancelled into the engine
        (`DecodeEngine.cancel`) instead of decoding tokens nobody will
        read (docs/ROBUSTNESS.md "Cancellation")."""
        if self._draining:
            # wire-level refusal ahead of the engine's own: a draining
            # server must not accept work even in the window before
            # drain() reaches the engine
            raise RuntimeError(
                "server draining: not accepting new requests")
        if self._engine is None:
            raise RuntimeError("no decode engine attached "
                               "(start with --gpt-config or engine=)")
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-role replica does not decode: GENERATE needs a "
                "decode-capable tier (role=both|decode)")
        if len(arrays) not in (2, 3, 4):
            raise ValueError(
                f"GENERATE wants [prompt_ids, max_new_tokens[, options[, "
                f"cancel_tag]]], got {len(arrays)} arrays")
        ids, mnt = arrays[0], arrays[1]
        kw = {}
        deadline_s = None
        if len(arrays) >= 3:
            # optional per-request knobs: int32 [cache, speculate] flags
            # (prefix-cache / n-gram-drafting participation; both default
            # on, gated by the engine-level config — docs/SERVING.md)
            # plus an optional third deadline_ms value (> 0 arms the
            # engine's per-request deadline — docs/ROBUSTNESS.md) and,
            # at 7 values, a 16-byte client-generated idempotency
            # request key as 4 trailing int32 words (exactly-once
            # resubmission — docs/ROBUSTNESS.md "Control-plane HA"; the
            # 2/3-wide shapes stay legacy at-least-once). At 13 values,
            # six more words carry the fleet trace context — 16-byte
            # trace id + 8-byte parent span id, all-zero = absent
            # (docs/OBSERVABILITY.md "Fleet tracing"); zero key words at
            # this width mean a traced request WITHOUT an idempotency key
            opts = np.asarray(arrays[2]).reshape(-1)
            if opts.size not in (2, 3, 7, 13):
                raise ValueError(
                    f"GENERATE options wants int32 [cache, speculate"
                    f"[, deadline_ms[, key0..key3[, tid0..tid3, par0..par1"
                    f"]]]], got {opts.size} values")
            kw = dict(cache=bool(int(opts[0])), speculate=bool(int(opts[1])))
            if opts.size >= 3 and int(opts[2]) > 0:
                deadline_s = int(opts[2]) / 1000.0
            if opts.size >= 7 and np.any(opts[3:7]):
                kw["request_key"] = np.ascontiguousarray(
                    opts[3:7], np.int32).tobytes()
            if opts.size == 13 and trace is not None:
                tid, parent = words_to_trace([int(w) for w in opts[7:13]])
                trace.attach_context(tid, parent)
        tag = None
        if len(arrays) == 4:
            tag = np.ascontiguousarray(arrays[3], np.uint8).tobytes()
        req = self._engine.submit(ids, int(np.asarray(mnt).reshape(-1)[0]),
                                  trace=trace, deadline_s=deadline_s, **kw)
        with self._tagged(tag, req.request_id):
            out = self._await_result(req, conn, deadline_s)
        metrics.counter("serve.generate_requests").inc()
        return np.ascontiguousarray(out, np.int32)

    @contextlib.contextmanager
    def _tagged(self, tag, request_id):
        """Register a CANCEL tag for the duration of a wait — shared by
        GENERATE and the MIGRATE receive path (a migrated request must
        stay cancellable on the replica that now decodes it). On exit,
        pop only OUR registration: a concurrent request reusing the tag
        has overwritten the mapping, and deleting it here would make
        that request uncancellable."""
        if tag is not None:
            with self._tag_lock:
                self._tags[tag] = request_id
        try:
            yield
        finally:
            if tag is not None:
                with self._tag_lock:
                    if self._tags.get(tag) == request_id:
                        del self._tags[tag]

    def _cancel_request(self, request_id: str, reason: str) -> bool:
        """Cancel ``request_id`` WHEREVER it lives: the local engine, or
        — when a migrating drain already exported it — the peer decoding
        it, by marking it cancelled and dropping the OP_MIGRATE socket.
        The peer's own disconnect watch turns the EOF into an engine
        cancel, so the chain composes client -> victim -> peer -> engine
        and a request can never outlive its client just because it
        migrated (tests/test_migration.py)."""
        ok = False
        if self._engine is not None:
            ok = bool(self._engine.cancel(request_id, reason=reason))
        with self._mig_lock:
            if request_id in self._mig_socks:
                self._mig_cancelled[request_id] = reason
                sock = self._mig_socks[request_id]
                ok = True
                if sock is not None:
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass       # exchange already over: nothing to stop
            elif self._migrating:
                # the EXPORT WINDOW: during a MIGRATING drain the engine loop
                # detaches a request (engine.cancel misses it — or worse,
                # answers a stale True off the slot mirror it is mid-way
                # through detaching) before _migrate_items registers it in
                # _mig_socks. Record the cancel UNCONDITIONALLY — even on
                # ok=True, the same mailbox discipline as engine.cancel's
                # _admit/_place window — so _migrate_items finishes it
                # typed-Cancelled instead of shipping it to a peer that
                # would decode for a gone client. Entries for requests
                # that never migrate are swept at drain end. (A plain
                # drain has no export window: the flag keeps a cancel
                # racing normal completion a clean miss there.)
                self._mig_cancelled[request_id] = reason
                ok = True
        return ok

    def _await_result(self, req, conn, deadline_s):
        """Block on the request future, but never blindly: the wait polls
        so it can (a) notice the CLIENT disconnecting and cancel the
        request into the engine — freeing its slot and pages for work
        someone still wants — and (b) bound the total wait (the deadline
        plus scheduling grace when one is set, the legacy 600 s
        otherwise), so a wedged engine surfaces a typed timeout error
        instead of an indefinite hang.

        Waiter accounting (docs/ROBUSTNESS.md "Control-plane HA"): every
        wait registers on the request, and the abandon-side cancels fire
        only when THIS wait was the LAST party attached — a dedup'd
        resubmit (same request key through a surviving router) shares the
        future, and the dead first connection must not kill the
        generation its replacement is blocked on. The last-leaver
        election is the atomic decrement in `remove_waiter` (two waits
        abandoning in the same poll tick must elect exactly ONE
        canceller, never zero)."""
        budget = 600.0 if deadline_s is None else float(deadline_s) + 30.0
        t_end = time.monotonic() + budget
        watch = conn is not None
        req.add_waiter()
        detached = False
        try:
            while True:
                try:
                    return req.result(timeout=0.2)
                except TimeoutError:
                    pass
                if time.monotonic() >= t_end:
                    # abandoning the wait must also abandon the WORK:
                    # without the cancel the slot keeps decoding tokens
                    # nobody will read — and the router, classifying this
                    # timeout as resubmittable, would start a duplicate
                    # elsewhere while this replica still burns steps on
                    # the original. Unless another waiter remains
                    # attached: then the work is still wanted and only
                    # THIS wait gives up.
                    detached = True
                    if req.remove_waiter() == 0:
                        self._cancel_request(
                            req.request_id,
                            reason="serve wait budget exhausted")
                    raise TimeoutError("generation still running")
                if watch and not self._stop.is_set():
                    state = peek_disconnect(conn)
                    if state == "pipelined":
                        watch = False
                    elif state == "gone":
                        detached = True
                        if req.remove_waiter() == 0:
                            self._cancel_request(
                                req.request_id,
                                reason="client disconnected")
                            # counted only when the disconnect actually
                            # cancelled: a generation deliberately kept
                            # alive for an attached resubmit must not
                            # show up as a cancel on the dashboard
                            metrics.counter(
                                "serve.disconnect_cancels").inc()
                        raise ConnectionError(
                            "client disconnected mid-GENERATE "
                            "(request cancelled)")
        finally:
            if not detached:
                req.remove_waiter()

    def _cancel_op(self, arrays):
        """CANCEL op body: map the client tag to the live engine request
        (if any) and cancel it. Unknown tags are a clean miss (int32 [0]),
        never an error — cancellation racing completion is normal."""
        if len(arrays) != 1:
            raise ValueError(
                f"CANCEL wants one uint8 tag array, got {len(arrays)}")
        tag = np.ascontiguousarray(arrays[0], np.uint8).tobytes()
        with self._tag_lock:
            rid = self._tags.get(tag)
        ok = False
        if rid is not None:
            ok = self._cancel_request(rid, reason="CANCEL wire op")
        metrics.counter("serve.cancels").inc()
        return np.asarray([1 if ok else 0], np.int32)

    @staticmethod
    def _send_err(conn, msg):
        raw = msg.encode()
        conn.sendall(struct.pack("<III", MAGIC, 1, len(raw)) + raw)


def stats_payload(extra: dict | None = None) -> np.ndarray:
    """The serve stats response body: the process metrics snapshot (request
    counts, latency histogram, and every other subsystem's metrics — one
    process, one registry) serialized as a uint8 JSON array. ``extra``
    merges additional top-level keys in — the engine server adds its
    ``role`` and the prefix-store export the router's fleet directory
    feeds on (docs/SERVING.md "Disaggregated serving")."""
    snap = metrics.snapshot()
    if extra:
        snap = dict(snap, **extra)
    raw = json.dumps(snap).encode()
    return np.frombuffer(raw, dtype=np.uint8).copy()


def trace_export_payload(trace_id: str) -> np.ndarray:
    """TRACE_EXPORT response body: this process's spans for one trace id
    (hex) plus its fleet identity, as a uint8 JSON array. Span timestamps
    are unix-epoch microseconds so exports from different processes land
    on one timeline (observability/fleet.py stitches them)."""
    body = {"node": metrics.node_identity(), "trace_id": trace_id,
            "spans": metrics.spans_for_trace(trace_id)}
    return np.frombuffer(json.dumps(body).encode(), np.uint8).copy()


def debug_dump_payload() -> np.ndarray:
    """DEBUG_DUMP response body: the process flight-recorder ring + full
    metrics snapshot + fleet identity as a uint8 JSON array — the same
    shape `dump_ring` writes locally, pulled over the wire instead."""
    body = {"node": metrics.node_identity(), "events": flight.events(),
            "metrics": metrics.snapshot()}
    return np.frombuffer(json.dumps(body).encode(), np.uint8).copy()


class RemotePredictor:
    """Python wire client mirroring the Predictor.run() surface.

    Auth: pass ``secret=`` — the ``TOKEN <hex>`` value the server printed
    at startup, or the ``auth_name`` it was constructed with — or an
    explicit 32-byte ``token=`` digest; with neither, the env-var secret
    alone is used (works when PADDLE_SERVE_TOKEN is set on both sides).
    ``model_prefix=`` is the legacy alias for ``secret=`` (servers no
    longer derive their token from the model path).

    Connect (and idempotent-op IO) retries with exponential backoff +
    jitter under a hard deadline (`retrying_connect`): a replica restart
    used to surface as an instant ``ConnectionRefusedError``; now the
    client rides out up to ``retry_deadline_s`` of it. ``connect_retries=1``
    restores the old single-attempt behavior.

    Multi-router failover (docs/ROBUSTNESS.md "Control-plane HA"): pass
    ``endpoints=["host:port", ...]`` — several redundant routers sharing
    one auth secret — or ``registry_dir=``/``registry_addr=`` to discover
    router-role leases from the elastic registry. The client then (a)
    rotates to the next endpoint whenever the current one is unreachable,
    (b) mints a 16-byte idempotency ``request_key`` per `generate` call
    and RESUBMITS through a surviving router when the wire dies
    mid-request — the fleet's dedup table makes the resubmit attach to or
    replay the original generation, never re-run it — and (c) broadcasts
    `cancel` across every known router, so a tag registered through
    router A is killable through router B. A single ``host``/``port``
    client keeps the legacy at-least-once behavior exactly (no key, wire
    errors surface to the caller) unless an explicit ``request_key`` is
    passed."""

    def __init__(self, host="127.0.0.1", port=None, timeout=60.0,
                 model_prefix=None, token=None, secret=None,
                 connect_retries=3, retry_deadline_s=10.0,
                 endpoints=None, registry_dir=None, registry_addr=None):
        if secret is None and model_prefix is not None \
                and not os.environ.get("PADDLE_SERVE_TOKEN"):
            # legacy alias keeps its LEGACY semantics: the old auth_token
            # let the env var beat model_prefix on both sides, so a
            # deployment with PADDLE_SERVE_TOKEN set everywhere that still
            # passes model_prefix= must keep matching the env-var digest
            secret = model_prefix
        if token is None and secret is None and \
                not os.environ.get("PADDLE_SERVE_TOKEN"):
            raise ValueError(
                "RemotePredictor cannot derive the auth secret: pass "
                "secret= (the TOKEN value the server printed at startup, "
                "or its auth_name=), an explicit 32-byte token=, or set "
                "PADDLE_SERVE_TOKEN on both sides — otherwise the server "
                "silently drops the connection")
        self._timeout = timeout
        self._retries = max(1, int(connect_retries))
        self._retry_deadline = retry_deadline_s
        self._outs = []
        self._token_bytes = token if token is not None else auth_token(
            secret if secret is None else str(secret))
        self._registry = None
        if registry_dir or registry_addr:
            self._registry = NodeRegistry(registry_dir) if registry_dir \
                else TcpNodeRegistry(registry_addr)
        if endpoints is not None:
            eps = [self._norm_ep(e) for e in endpoints]
            if not eps:
                raise ValueError("endpoints= must name >= 1 router")
        elif self._registry is not None:
            eps = self._discover_routers()
        else:
            eps = [(host, port)]
        self._endpoints: list[tuple] = eps
        self._ep_idx = 0
        # idempotent failover only when the client CAN fail over: a
        # plain host/port client keeps legacy wire semantics verbatim
        self._ha = endpoints is not None or self._registry is not None
        self._sock = None
        self._connect()

    @staticmethod
    def _norm_ep(ep) -> tuple:
        if isinstance(ep, str):
            host, _, port = ep.rpartition(":")
            return host, int(port)
        host, port = ep
        return str(host), int(port)

    def _discover_routers(self) -> list[tuple]:
        """Router-role leases from the registry, sorted for a
        deterministic failover order; waits up to ``retry_deadline_s``
        for the first one to appear (a client may start before its
        routers finish registering)."""
        t_end = time.monotonic() + max(0.0, float(self._retry_deadline))
        while True:
            try:
                alive = self._registry.alive_nodes()
            except OSError:
                alive = {}
            eps = [self._norm_ep(str(ep)) for rid, ep in
                   sorted(alive.items()) if node_role(rid) == "router"]
            if eps:
                return eps
            if time.monotonic() >= t_end:
                raise ConnectionError(
                    "no router-role lease in the registry (routers "
                    "register as 'router:<id>'; replicas are not valid "
                    "failover targets)")
            time.sleep(0.05)

    def _refresh_endpoints(self):
        """Fold in registry churn before a failover attempt: a router
        started after this client keeps requests flowing when the
        original set dies. Non-raising — discovery failure keeps the
        last known list."""
        if self._registry is None:
            return
        try:
            eps = self._discover_routers()
        except (ConnectionError, OSError):
            return
        cur = self._endpoints[self._ep_idx]
        self._endpoints = eps
        self._ep_idx = eps.index(cur) if cur in eps else 0

    def _connect(self, fast=False):
        """Connect to the first reachable endpoint, starting at the
        current one. ``fast`` is the mid-request failover flavor: one
        attempt per endpoint under a short deadline — the surviving
        deadline budget belongs to the resubmit, not to backoff."""
        attempts = 1 if fast else self._retries
        deadline = min(2.0, float(self._retry_deadline)) if fast \
            else self._retry_deadline
        n = len(self._endpoints)
        last = None
        for k in range(n):
            i = (self._ep_idx + k) % n
            host, port = self._endpoints[i]
            try:
                sock = retrying_connect(host, port, timeout=self._timeout,
                                        attempts=attempts,
                                        deadline_s=deadline)
            except (ConnectionError, OSError) as e:
                last = e
                continue
            self._ep_idx = i
            self._sock = sock
            self._sock.sendall(struct.pack("<I", MAGIC) + self._token_bytes)
            return
        raise ConnectionError(
            f"no endpoint reachable ({n} tried): "
            f"{type(last).__name__ if last else 'none'}: {last}")

    def _reconnect(self, fast=False):
        try:
            self._sock.close()
        except OSError:
            pass
        self._connect(fast=fast)

    def _failover(self):
        """Mid-request wire death: rotate PAST the current endpoint (it
        just failed mid-exchange — even if still reachable, starting the
        resubmit elsewhere spreads the retry), fold in registry churn,
        reconnect fast. `router.failovers` counts every switch."""
        metrics.counter("router.failovers").inc()
        self._refresh_endpoints()
        self._ep_idx = (self._ep_idx + 1) % len(self._endpoints)
        self._reconnect(fast=True)

    def _idempotent(self, fn):
        """Run a read-only op; on a broken connection (server restarted
        between calls) reconnect with backoff and retry ONCE. Only ops
        with no server-side effect ride this — generate() surfaces IO
        errors to the caller (the router owns resubmission)."""
        try:
            return fn()
        except (ConnectionError, socket.timeout, OSError):
            self._reconnect()
            return fn()

    def ping(self):
        def _do():
            self._sock.sendall(struct.pack("<III", MAGIC, OP_PING, 0))
            magic, status, _ = struct.unpack(
                "<III", _recv_exact(self._sock, 12))
            return magic == MAGIC and status == 0
        return self._idempotent(_do)

    def stats(self) -> dict:
        """Fetch the server's metrics snapshot (request latency/throughput
        counters plus everything else its registry holds)."""
        def _do():
            self._sock.sendall(struct.pack("<III", MAGIC, OP_STATS, 0))
            magic, status, n = struct.unpack(
                "<III", _recv_exact(self._sock, 12))
            if magic != MAGIC or status != 0:
                raise ConnectionError("bad stats response")
            (payload,) = recv_arrays(self._sock, n)
            return json.loads(payload.tobytes().decode())
        return self._idempotent(_do)

    def prometheus(self) -> str:
        """The server's metrics in Prometheus text exposition format
        (PROMETHEUS wire op) — relay to a scraper or eyeball directly."""
        def _do():
            self._sock.sendall(
                struct.pack("<III", MAGIC, OP_PROMETHEUS, 0))
            magic, status, n = struct.unpack(
                "<III", _recv_exact(self._sock, 12))
            if magic != MAGIC or status != 0:
                raise ConnectionError("bad prometheus response")
            (payload,) = recv_arrays(self._sock, n)
            return payload.tobytes().decode()
        return self._idempotent(_do)

    def trace_export(self, trace_id: str) -> dict:
        """Pull this endpoint's span buffer for one fleet trace id (hex):
        ``{"node": {...}, "trace_id": ..., "spans": [...]}`` with
        wall-rebased Chrome-trace events. The fleet collector
        (`observability/fleet.py`) calls this against every registry
        member and stitches the exports into ONE trace."""
        def _do():
            tid = np.frombuffer(bytes.fromhex(trace_id), np.uint8).copy()
            self._sock.sendall(
                struct.pack("<III", MAGIC, OP_TRACE_EXPORT, 1))
            send_arrays(self._sock, [tid])
            magic, status, n = struct.unpack(
                "<III", _recv_exact(self._sock, 12))
            if magic != MAGIC:
                raise ConnectionError("bad magic in response")
            if status != 0:
                raise from_wire(
                    _recv_exact(self._sock, n).decode(errors="replace"))
            (payload,) = recv_arrays(self._sock, n)
            return json.loads(payload.tobytes().decode())
        return self._idempotent(_do)

    def debug_dump(self) -> dict:
        """Fetch the remote process's flight-recorder ring + metrics
        snapshot (DEBUG_DUMP wire op) — the SIGUSR1 dump without shell
        access; `router --dump <replica>` relays this for operators."""
        def _do():
            self._sock.sendall(
                struct.pack("<III", MAGIC, OP_DEBUG_DUMP, 0))
            magic, status, n = struct.unpack(
                "<III", _recv_exact(self._sock, 12))
            if magic != MAGIC:
                raise ConnectionError("bad magic in response")
            if status != 0:
                raise from_wire(
                    _recv_exact(self._sock, n).decode(errors="replace"))
            (payload,) = recv_arrays(self._sock, n)
            return json.loads(payload.tobytes().decode())
        return self._idempotent(_do)

    def generate(self, prompt_ids, max_new_tokens=32, cache=None,
                 speculate=None, deadline_s=None, tag=None,
                 request_key=None, trace_id=None, parent_span=None):
        """Batched server-side decode: ship the prompt, get prompt +
        generated ids back. Concurrent generate() calls from any number of
        clients share the server engine's decode batch.

        ``cache`` / ``speculate`` (default None = server default, on):
        per-request prefix-cache / speculative-drafting participation —
        sent as an optional third options array so old servers keep
        working with knob-less calls (docs/SERVING.md).

        ``deadline_s`` bounds the request end to end: past it the server
        answers a typed :class:`DeadlineExceeded` instead of tokens
        (rides the options array as deadline_ms; a router forwards the
        REMAINING budget on every resubmit). ``tag`` (str/bytes) names
        the request for a concurrent `cancel` call from another
        connection. Server-side failures raise TYPED exceptions —
        `DeadlineExceeded` / `Cancelled` / `Overloaded` (all RuntimeError
        subclasses) — reconstructed from the one-line wire error
        (docs/ROBUSTNESS.md).

        ``request_key`` (docs/ROBUSTNESS.md "Control-plane HA"): the
        16-byte idempotency key riding the options array. Default None
        mints a fresh key per call on a failover-capable client
        (``endpoints=``/registry) and sends none on a plain host/port
        client (legacy at-least-once); pass explicit bytes to name the
        request yourself, or ``False`` to force legacy mode. With a key,
        a connection that dies mid-request is RESUBMITTED — through the
        next endpoint under the surviving deadline budget — and the
        fleet's dedup table guarantees the retry attaches to or replays
        the original generation instead of re-running it.

        ``trace_id`` (docs/OBSERVABILITY.md "Fleet tracing"): a 16-byte
        hex trace id — mint one with
        `paddle_tpu_torch.observability.tracing.mint_trace()` — threads the
        fleet trace context through every hop this request takes
        (router, prefill worker, decode replica, migration peer); the
        same context rides every resubmit, so a failover's spans all
        land in one stitched trace. ``parent_span`` optionally names
        this client hop's span id (default: freshly minted)."""
        key = request_key
        if key is None and self._ha:
            key = _secrets.token_bytes(16)
        elif key is False:
            key = None
        if key is not None:
            key = bytes(key)
            if len(key) != 16:
                raise ValueError(
                    f"request_key must be 16 bytes, got {len(key)}")
        ids = np.ascontiguousarray(np.asarray(prompt_ids).reshape(-1),
                                   np.int32)
        trace_ctx = None
        if trace_id:
            # this hop's span id doubles as the downstream parent; the
            # SAME context rides every resubmit so a failover's attempts
            # stitch into one trace
            trace_ctx = (str(trace_id), parent_span or new_span_id())
        t_deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        t0 = time.perf_counter()
        # one attempt per endpoint plus one (the single-endpoint replay
        # case: the same server answers the resubmit from its dedup
        # table after e.g. an ack-window drop)
        budget = len(self._endpoints) + 1
        while True:
            remaining = None
            if t_deadline is not None:
                remaining = t_deadline - time.monotonic()
                if remaining <= 0:
                    raise DeadlineExceeded(
                        f"request deadline ({deadline_s}s) exhausted "
                        f"before an endpoint answered")
            try:
                out = self._generate_once(ids, max_new_tokens, cache,
                                          speculate, remaining, tag, key,
                                          trace_ctx)
                if trace_ctx is not None:
                    metrics.add_span(
                        "client.generate", t0, time.perf_counter() - t0,
                        cat="client", trace_id=trace_ctx[0],
                        span_id=trace_ctx[1])
                return out
            except (ConnectionError, socket.timeout, OSError):
                # wire death mid-request. Without a key this is the
                # legacy contract: surface it (a blind resubmit could
                # duplicate the generation). With one, fail over and
                # resubmit — dedup makes the retry exactly-once.
                budget -= 1
                if key is None or budget <= 0:
                    raise
                self._failover()

    def _generate_once(self, ids, max_new_tokens, cache, speculate,
                       deadline_s, tag, key, trace_ctx=None):
        """One GENERATE exchange on the current connection (the wire
        body of `generate`; deadline_s here is the REMAINING budget)."""
        arrays = [ids, np.asarray([max_new_tokens], np.int32)]
        if trace_ctx is not None:
            # traced requests ship the FULL 13-wide options vector: the
            # trace words sit at fixed trailing positions, so an absent
            # deadline/key rides as zero words (the server treats an
            # all-zero key group as "no key" at this width)
            opts = [1 if cache is None else int(bool(cache)),
                    1 if speculate is None else int(bool(speculate)),
                    0 if deadline_s is None
                    else max(1, int(float(deadline_s) * 1000))]
            if key is not None:
                opts.extend(int(w) for w in np.frombuffer(key, np.int32))
            else:
                opts.extend([0, 0, 0, 0])
            opts.extend(trace_to_words(trace_ctx[0], trace_ctx[1]))
            arrays.append(np.asarray(opts, np.int32))
        elif cache is not None or speculate is not None \
                or deadline_s is not None or tag is not None \
                or key is not None:
            opts = [1 if cache is None else int(bool(cache)),
                    1 if speculate is None else int(bool(speculate))]
            if deadline_s is not None or tag is not None or key is not None:
                # the tag array is positional (4th), so it forces the
                # >= 3-wide options shape even with no deadline (0 = none)
                opts.append(0 if deadline_s is None
                            else max(1, int(float(deadline_s) * 1000)))
            if key is not None:
                opts.extend(int(w) for w in np.frombuffer(key, np.int32))
            arrays.append(np.asarray(opts, np.int32))
        if tag is not None:
            arrays.append(np.frombuffer(self._tag_bytes(tag), np.uint8))
        self._sock.sendall(struct.pack("<III", MAGIC, OP_GENERATE,
                                       len(arrays)))
        send_arrays(self._sock, arrays)
        magic, status, n = struct.unpack(
            "<III", _recv_exact(self._sock, 12))
        if magic != MAGIC:
            raise ConnectionError("bad magic in response")
        if status != 0:
            raise from_wire(
                _recv_exact(self._sock, n).decode(errors="replace"))
        (out,) = recv_arrays(self._sock, n)
        return out

    @staticmethod
    def _tag_bytes(tag) -> bytes:
        return tag.encode() if isinstance(tag, str) else bytes(tag)

    def cancel(self, tag) -> bool:
        """Cancel a GENERATE submitted (from ANOTHER connection) with this
        ``tag``. Returns True when the tag named live work; a miss —
        already finished, never seen — is False, not an error.

        On a multi-endpoint client the cancel BROADCASTS: after the
        current connection, every other known router gets the tag on a
        fresh probe-grade connection — the routers are independent, so
        the one that accepted the GENERATE may not be the one this client
        is currently talking to (docs/ROBUSTNESS.md "Control-plane HA").
        Unreachable routers are a clean miss, never an error."""
        def _do():
            return self._cancel_exchange(self._sock, tag)
        if len(self._endpoints) == 1:
            return self._idempotent(_do)
        try:
            hit = self._idempotent(_do)
        except (ConnectionError, socket.timeout, OSError, RuntimeError):
            hit = False          # the fan-out below may still land it
        cur = self._endpoints[self._ep_idx]
        for ep in self._endpoints:
            if ep != cur:
                hit = self._cancel_via(ep, tag) or hit
        return hit

    def _cancel_exchange(self, sock, tag) -> bool:
        """ONE CANCEL request/response on an authed socket — the single
        owner of the CANCEL wire framing, shared by the current
        connection and every broadcast arm (protocol drift in one copy
        would silently break only the untraveled path)."""
        sock.sendall(struct.pack("<III", MAGIC, OP_CANCEL, 1))
        send_arrays(sock,
                    [np.frombuffer(self._tag_bytes(tag), np.uint8)])
        magic, status, n = struct.unpack(
            "<III", _recv_exact(sock, 12))
        if magic != MAGIC:
            raise ConnectionError("bad magic in response")
        if status != 0:
            raise from_wire(
                _recv_exact(sock, n).decode(errors="replace"))
        (out,) = recv_arrays(sock, n)
        return bool(int(np.asarray(out).reshape(-1)[0]))

    def _cancel_via(self, ep, tag) -> bool:
        """`_cancel_exchange` against ``ep`` on a fresh probe-grade authed
        connection (broadcast arm of `cancel`); any failure is a clean
        miss."""
        host, port = ep
        try:
            sock = retrying_connect(host, port, timeout=5.0, attempts=1,
                                    deadline_s=2.0)
        except (ConnectionError, OSError):
            return False
        try:
            sock.sendall(struct.pack("<I", MAGIC) + self._token_bytes)
            return self._cancel_exchange(sock, tag)
        except (OSError, ConnectionError, RuntimeError, struct.error):
            return False
        finally:
            sock.close()

    def run(self, inputs):
        self._sock.sendall(struct.pack("<III", MAGIC, OP_RUN, len(inputs)))
        send_arrays(self._sock, inputs)
        magic, status, n = struct.unpack(
            "<III", _recv_exact(self._sock, 12))
        if magic != MAGIC:
            raise ConnectionError("bad magic in response")
        if status != 0:
            raise RuntimeError(
                _recv_exact(self._sock, n).decode(errors="replace"))
        self._outs = recv_arrays(self._sock, n)
        return True

    def get_output_names(self):
        return [f"out{i}" for i in range(len(self._outs))]

    def get_output_handle(self, name):
        class _H:
            def __init__(self, buf):
                self._buf = buf

            def copy_to_cpu(self):
                return self._buf

        return _H(self._outs[int(name.removeprefix("out"))])

    def shutdown_server(self):
        self._sock.sendall(struct.pack("<III", MAGIC, OP_SHUTDOWN, 0))
        try:
            _recv_exact(self._sock, 12)
        except ConnectionError:
            pass

    def close(self):
        self._sock.close()


def install_sigusr1_dump():
    """SIGUSR1 -> faulthandler all-thread stack dump to stderr (the ops
    contract for a live hang, docs/ROBUSTNESS.md: ``kill -USR1 <pid>``
    shows where every thread is stuck WITHOUT killing the process).
    Installed by the serve and router CLIs; no-op where the platform has
    no SIGUSR1. Returns True when installed."""
    import faulthandler
    import signal

    if not hasattr(signal, "SIGUSR1"):
        return False
    # chain=False: the default SIGUSR1 disposition is process TERMINATION,
    # so chaining would dump the stacks and then kill the server anyway
    faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)
    return True


def install_sigterm_drain(server: InferenceServer, deadline_s=30.0):
    """SIGTERM -> graceful drain (the pod-eviction / rolling-deploy
    contract): refuse new submits, finish in-flight requests up to
    ``deadline_s``, deregister from the elastic registry, exit. The
    handler returns immediately — the drain runs on a daemon thread so a
    signal can never wedge the main thread mid-accept. Returns the
    installed handler (tests invoke it directly)."""
    import signal

    def _handler(signum, frame):  # noqa: ARG001 — signal handler signature
        t = threading.Thread(target=server.drain, args=(deadline_s,),
                             daemon=True, name="pt-serve-drain")
        server._drain_thread = t
        t.start()

    signal.signal(signal.SIGTERM, _handler)
    return _handler


# GPTConfig fields of the JAX package the port's model lacks: a config file
# may name them at these defaults; any other value is refused (ROADMAP A6)
_JAX_ONLY_GPT_FIELDS = {"seq_parallel": False, "sp_attention": "ring"}


def _gpt_config(spec: dict):
    """The port's GPTConfig of a JAX config file's GPTConfig fields."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    for name, default in _JAX_ONLY_GPT_FIELDS.items():
        if name in spec and spec.pop(name) != default:
            raise NotImplementedError(
                f"GPTConfig.{name} other than {default!r} is sequence "
                f"parallelism across cards, which the port does not have "
                f"yet (ROADMAP A6)")
    return GPTConfig(**spec)


def main(argv=None):
    ap = argparse.ArgumentParser("paddle_tpu_torch.inference.serve")
    ap.add_argument("--model", default=None,
                    help="jit.save prefix of a deployed model (RUN op; not "
                         "ported, ROADMAP A7)")
    ap.add_argument("--gpt-config", default=None,
                    help="JSON file of GPTConfig fields (plus optional "
                         "'weights': a PDTPU001 state-dict file, "
                         "framework/io.py, and "
                         "'engine': EngineConfig fields) — attaches a "
                         "batched decode engine serving the GENERATE op")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="also serve GET /metrics (Prometheus text "
                         "exposition) from a stdlib HTTP endpoint on this "
                         "port (0 = ephemeral; printed as 'METRICS <port>')")
    ap.add_argument("--auth-name", default=None,
                    help="deployment-chosen shared auth secret (clients "
                         "pass it as secret=); default is PADDLE_SERVE_TOKEN "
                         "or a random per-startup token printed once as "
                         "'TOKEN <hex>'")
    ap.add_argument("--registry-dir", default=None,
                    help="shared-filesystem elastic registry directory: "
                         "register this replica for router discovery "
                         "(distributed/fleet/elastic.py NodeRegistry)")
    ap.add_argument("--registry-addr", default=None,
                    help="host:port of a TcpRegistryServer to register "
                         "with (needs PADDLE_ELASTIC_TOKEN)")
    ap.add_argument("--replica-id", default=None,
                    help="registry node id (default replica-<pid>)")
    ap.add_argument("--role", default="both",
                    choices=list(REPLICA_ROLES),
                    help="disaggregated-serving tier (docs/SERVING.md "
                         "\"Disaggregated serving\"): 'prefill' serves "
                         "only the PREFILL page-stream op, 'decode' "
                         "never compiles a prefill program (GENERATE/"
                         "MIGRATE/KV_STREAM only); registry lease id "
                         "gains the '<role>:' prefix so the router "
                         "routes by tier. Default 'both' = the legacy "
                         "symmetric replica")
    ap.add_argument("--advertise", default=None,
                    help="endpoint to publish in the registry (default "
                         "<host>:<bound port>)")
    ap.add_argument("--drain-deadline", type=float, default=30.0,
                    help="SIGTERM graceful-drain budget in seconds: finish "
                         "in-flight requests up to this long before exit")
    ap.add_argument("--migrate-on-drain", action="store_true",
                    help="SIGTERM/drain live-migrates in-flight requests "
                         "to registry-discovered peer replicas (OP_MIGRATE "
                         "wire op, fleet-shared auth) instead of waiting "
                         "them out — the preemptible-VM serving contract "
                         "(docs/SERVING.md \"Live migration\"); needs a "
                         "registry and a fleet-shared --auth-name")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="NAME=OBJECTIVE[;OPTS]",
                    help="declare a process-scope SLO evaluated over this "
                         "replica's own metrics registry every "
                         "--slo-interval seconds; e.g. "
                         "'ttft=serve.ttft_seconds p99 < 2.0s;fast=60;"
                         "slow=300'. Repeatable. Firing alerts ride "
                         "/metrics as slo_alert_firing and land in "
                         "watchdog stall dumps (docs/OBSERVABILITY.md)")
    ap.add_argument("--slo-interval", type=float, default=5.0,
                    help="seconds between --slo evaluation passes")
    ap.add_argument("--usage-log", default=None, metavar="PATH",
                    help="append one JSON usage record per terminated "
                         "request to PATH (size-rotated; the in-memory "
                         "ring and usage.* counters are always on)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["native", "f32", "bf16", "int8"],
                    help="KV page-pool storage dtype (engine servers; "
                         "overrides the config file's engine.kv_dtype). "
                         "int8 stores pages with per-token per-head scales "
                         "— ~2x+ concurrent slots per pool byte "
                         "(docs/QUANTIZATION.md)")
    ap.add_argument("--weight-dtype", default=None,
                    choices=["native", "int8"],
                    help="serve the model's matmul weights int8 with "
                         "per-channel scales, dequantized in-program "
                         "(engine servers; overrides engine.weight_dtype)")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device: 'cuda' (the card, default) "
                         "or 'cpu'; nothing falls back to the CPU")
    args = ap.parse_args(argv)
    if args.model is None and args.gpt_config is None:
        ap.error("need --model and/or --gpt-config")
    if (args.kv_dtype is not None or args.weight_dtype is not None) \
            and args.gpt_config is None:
        # silently serving full-width after an operator asked for int8
        # would be a capacity surprise, not a convenience
        ap.error("--kv-dtype/--weight-dtype configure the decode engine: "
                 "they require --gpt-config")
    if args.model is not None:
        ap.error("--model serves a saved model through a Predictor, which "
                 "the port does not have yet (ROADMAP A7)")
    engine = None
    if args.gpt_config is not None:
        from paddle_tpu_torch.framework import io as pio
        from paddle_tpu_torch.inference.engine import (DecodeEngine,
                                                       EngineConfig)
        from paddle_tpu_torch.models.gpt import GPTForCausalLM
        with open(args.gpt_config) as f:
            spec = json.load(f)
        weights = spec.pop("weights", None)
        espec = spec.pop("engine", {})
        # CLI knobs override the config file: the same deployment artifact
        # serves full-width or quantized by flag flip
        if args.kv_dtype is not None:
            espec["kv_dtype"] = args.kv_dtype
        if args.weight_dtype is not None:
            espec["weight_dtype"] = args.weight_dtype
        ecfg = EngineConfig(**espec)
        from paddle_tpu_torch import device as device_mod
        with device_mod.device_scope(args.device):
            model = GPTForCausalLM(_gpt_config(spec))
        if weights:
            model.set_state_dict(pio.load(weights))
        engine = DecodeEngine(model, ecfg, device=args.device)
    srv = InferenceServer(None, args.host, args.port, engine=engine,
                          auth_name=args.auth_name, role=args.role)
    srv.migrate_on_drain = bool(args.migrate_on_drain)
    # fleet identity for the observability plane: the trace collector and
    # metrics rollups label this process's spans/rows with role + id even
    # when no registry is attached (docs/OBSERVABILITY.md)
    metrics.set_node_identity(
        role=args.role, node_id=args.replica_id or f"replica-{os.getpid()}")
    if args.registry_dir or args.registry_addr:
        rid = args.replica_id or f"replica-{os.getpid()}"
        if args.role != "both":
            # the tier rides the lease id ('prefill:<id>'/'decode:<id>')
            # so the router classifies the replica without extra state;
            # unprefixed ids stay the legacy symmetric tier
            rid = role_node_id(args.role, rid)
        metrics.set_node_identity(node_id=rid)
        endpoint = args.advertise or f"{args.host}:{srv.port}"
        if args.registry_dir:
            registry = NodeRegistry(args.registry_dir, rid, endpoint)
        else:
            registry = TcpNodeRegistry(args.registry_addr, rid, endpoint)
        registry.register()
        srv.attach_registry(registry)
        print(f"REGISTERED {rid} {endpoint}", flush=True)
    install_sigterm_drain(srv, deadline_s=args.drain_deadline)
    install_sigusr1_dump()
    print(f"LISTENING {srv.port}", flush=True)
    if srv.generated_secret is not None:
        # printed ONCE at startup; clients pass it as secret= / the C
        # client hashes it the same way — never derived from the model path
        print(f"TOKEN {srv.generated_secret}", flush=True)
    if args.metrics_port is not None:
        from paddle_tpu_torch.observability.prometheus import \
            start_http_exporter
        exporter = start_http_exporter(host=args.host,
                                       port=args.metrics_port)
        print(f"METRICS {exporter.server_address[1]}", flush=True)
    if args.usage_log is not None:
        from paddle_tpu_torch.observability.usage import usage_log
        usage_log.configure(args.usage_log)
    if args.slo:
        from paddle_tpu_torch.observability.slo import (SLOEvaluator,
                                                        parse_slo)
        slo = SLOEvaluator([parse_slo(s) for s in args.slo],
                           scope="process")

        def _slo_loop():
            # daemon evaluation pass: windows this replica's OWN metrics
            # registry; firing alerts surface via /metrics
            # (slo_alert_firing) and the watchdog's stall-dump slo section
            while True:
                time.sleep(max(0.05, args.slo_interval))
                try:
                    slo.evaluate()
                except Exception:  # noqa: BLE001 — telemetry never
                    pass           # kills the serving process

        threading.Thread(target=_slo_loop, daemon=True,
                         name="pt-serve-slo").start()
    srv.serve_forever()
    # serve_forever returns as soon as _stop is set — but a SIGTERM drain
    # (daemon thread) may still be finishing in-flight work, and the
    # engine thread still runs its shutdown abort. Exiting now would tear
    # CUDA down under a live launch or graph replay and skip the
    # stragglers' abort path.
    if srv._drain_thread is not None:
        srv._drain_thread.join(timeout=args.drain_deadline + 60.0)
    if srv._engine_thread is not None:
        srv._engine_thread.join(timeout=60.0)


if __name__ == "__main__":
    main()
