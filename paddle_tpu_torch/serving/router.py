"""Router of the port: a wire-compatible front door over N engine
replicas (counterpart of `paddle_tpu/serving/router.py`; the port imports
nothing from it). It speaks the serve wire protocol of
`paddle_tpu_torch/inference/serve.py`, which is the JAX package's byte for
byte, so a client of one replica talks to the router unchanged, and a JAX
client, router or replica works with a port router or replica and the
reverse. The router is host code: it relays int32 ids and opaque page
records and never touches a tensor or a device.

Run:  python -m paddle_tpu_torch.serving.router --replica r0=HOST:PORT ...
(or ``--registry-dir DIR``; prints ``LISTENING <port>`` when ready; SIGTERM
stops it and the process exits 0). Behind the front door:

- **Membership** comes from the elastic registry
  (`distributed/fleet/elastic.py`): replicas register
  ``node_<id>.json``-style leases (file or TCP backend) and renew them on
  heartbeats; the router polls ``alive_nodes()`` in observer mode — a
  replica that joins mid-stream starts receiving traffic on the next poll,
  a replica whose heartbeat expires is routed around. Static fleets (tests,
  bench) pass ``replicas={id: "host:port"}`` instead.
- **Placement policies** (``POLICIES``): ``round_robin`` (default),
  ``least_outstanding`` (fewest router-tracked in-flight requests), and
  ``slo_aware`` — the poll thread pulls each replica's metrics snapshot
  over the STATS op and ranks replicas by their ``serve.tpot_seconds`` p99
  (the decode SLO the tracing layer maintains), outstanding count as the
  tiebreak; replicas with no observations yet rank optimistically so fresh
  capacity warms up.
- **Failure handling — a circuit breaker per replica**
  (docs/ROBUSTNESS.md): every replica carries a breaker with the classic
  three states. CLOSED = in rotation; background PING health probes run
  each poll cycle, and ``breaker_threshold`` consecutive probe failures —
  or ONE request-path connection failure / not-taking-work answer — OPEN
  it (out of rotation, the old "eviction"). After ``evict_cooldown_s`` an
  open breaker goes HALF-OPEN: the next health probe (or a trial request,
  when no closed replica remains) decides — success re-closes it, failure
  re-opens with a fresh cooldown. The failed request itself is resubmitted
  to another replica under a bounded budget (``max_resubmits``) — a
  mid-flight replica kill is a retry, not a client-visible error.
  Application errors (bad request, ``DeadlineExceeded``, ``Cancelled``)
  relay to the client unchanged and are never resubmitted; a typed
  ``Overloaded`` answer resubmits WITHOUT opening the breaker (the
  replica is healthy, just full) — and when every replica sheds, the
  client gets one clean typed ``Overloaded`` line, never a hang.
- **Deadline budget forwarding**: a GENERATE whose options array carries
  ``deadline_ms`` is forwarded with the REMAINING budget on every
  (re)submit, and the per-attempt IO timeout is clipped to it — the
  client's deadline bounds the whole routed attempt chain, resubmits
  included (``router.deadline_exceeded`` counts budget exhaustion).
- **Redundant routers** (docs/ROBUSTNESS.md "Control-plane HA"): N
  routers run simultaneously over the shared registry, each routing
  independently — routing state is SOFT (breakers/outstanding rebuild
  from probes), so there is no leader. A router registers ITSELF under
  the distinct ``router`` role (``--router-id`` -> node id
  ``router:<id>``) for client discovery; router-role leases never enter
  any replica rotation. Requests carrying an idempotency KEY route by
  rendezvous hash — routers with the same healthy view independently
  pick the same replica, so a failover resubmit lands on the engine
  whose dedup table already owns the key (best-effort while breaker
  views transiently diverge; the dedup table bounds duplicates to that
  window) — and an ambiguous mid-wire death gets one same-replica retry
  (``router.ack_retries``) instead of an eviction.

Observability (docs/OBSERVABILITY.md): ``router.requests``,
``router.replica_errors``, ``router.resubmits``, ``router.no_replica``,
per-replica ``router.replica_requests{replica=..}`` counters and
``router.outstanding{replica=..}`` gauges, a ``router.request_seconds``
histogram, and a ``router.forward`` span per routed request tagged with
the replica id — one Perfetto filter shows which replica served a request.

- **Disaggregated serving** (docs/SERVING.md "Disaggregated serving"):
  replicas declare a tier via their lease role (``prefill:<id>`` /
  ``decode:<id>``; unprefixed = legacy symmetric). With both tiers
  healthy the router drives GENERATE two-phase: OP_PREFILL to a prefill
  worker picked with CACHE AFFINITY — a fleet-wide prefix directory
  (`serving/disagg.py` PrefixDirectory, keyed by the engines' rolling
  page hashes, fed from their STATS prefix exports and the router's own
  routing, invalidated on eviction/refresh/membership churn) biases
  shared-prefix traffic to the worker already holding the longest
  prefix, so a system prompt is prefilled once per FLEET — and the
  worker's PTKS1 page records relay to the decode replica's OP_KV_STREAM
  as they are produced. The decode replica admits the slot when the
  final record lands and answers the full sequence, token-identical to a
  symmetric route; it never compiles a prefill program. Deadlines,
  cancel tags and idempotency keys ride the stream options; a prefill
  worker dying mid-stream falls back to one symmetric attempt
  (``router.disagg_fallbacks``) with the partial pages discarded
  cleanly.

The router is deliberately stateless about request CONTENT: GENERATE in,
int32 ids out (the disaggregated flow relays opaque checksummed page
records; it never interprets them).
"""
from __future__ import annotations

import argparse
import hashlib
import hmac
import json
import os
import select
import secrets as _secrets
import signal
import socket
import struct
import threading
import time

import numpy as np

from paddle_tpu_torch.distributed.fleet.elastic import (NodeRegistry,
                                                        TcpNodeRegistry,
                                                        node_role,
                                                        router_node_id)
from paddle_tpu_torch.inference.errors import DeadlineExceeded, Overloaded
from paddle_tpu_torch.inference.serve import (MAGIC, OP_CANCEL,
                                              OP_DEBUG_DUMP, OP_GENERATE,
                                              OP_KV_STREAM, OP_PING,
                                              OP_PREFILL, OP_PROMETHEUS,
                                              OP_RUN, OP_SHUTDOWN, OP_STATS,
                                              OP_TRACE_EXPORT, _recv_exact,
                                              auth_token, debug_dump_payload,
                                              install_sigusr1_dump,
                                              peek_disconnect, recv_arrays,
                                              retrying_connect, send_arrays,
                                              stats_payload,
                                              trace_export_payload)
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import flight
from paddle_tpu_torch.observability.tracing import (new_request_id,
                                                    new_span_id,
                                                    trace_to_words,
                                                    words_to_trace)
from paddle_tpu_torch.serving.disagg import (PrefixDirectory,
                                             prompt_page_hashes)
from paddle_tpu_torch.testing import faults

__all__ = ["Router", "ReplicaState", "POLICIES", "ReplicaUnavailable"]


class ReplicaUnavailable(ConnectionError):
    """The replica answered, but with a not-taking-work error (draining,
    engine stopped) — resubmit elsewhere, same as a dead connection."""


class _ReplicaAppError(RuntimeError):
    """The replica rejected the REQUEST itself: relaying it to another
    replica would fail identically, so it goes straight back to the
    client and never burns resubmit budget."""


class _ClientDisconnected(RuntimeError):
    """The ROUTER's client hung up mid-GENERATE. Deliberately NOT a
    ConnectionError/OSError: it must escape the resubmit loop (nobody is
    left to answer) instead of burning budget on another replica."""


def _classify_wire_error(msg: str) -> Exception:
    """Split replica wire errors by the exception TYPE the replica raised
    (the wire message is ``<Type>: <text>``): a ``ValueError`` is request
    validation (bad prompt/length — identical on every replica, relay it),
    as is an engine-less replica serving only RUN; ``DeadlineExceeded``
    and ``Cancelled`` are terminal per-request outcomes — the deadline is
    global and the cancel was the client's own, so another replica changes
    neither: relay them verbatim. Everything else — draining, engine
    stopped/aborted/died, result timeout, a typed ``Overloaded`` shed —
    means THIS replica can't finish the work, which is exactly what
    resubmission is for. Defaulting to resubmittable is deliberate: abort
    reasons are free-form text, and a missed marker must cost a bounded
    retry, not a client-visible error."""
    if msg.startswith(("ValueError", "DeadlineExceeded", "Cancelled")) \
            or "no decode engine attached" in msg:
        return _ReplicaAppError(msg)
    return ReplicaUnavailable(msg)


# a replica-answered error justifies EVICTION (not just resubmission of
# this one request) only when it says the replica stopped taking work;
# other request-scoped failures ("request needs N pages", result timeout)
# must not let one bad request empty the whole rotation for a cooldown
_EVICT_MARKERS = ("drain", "engine stopped", "engine loop died")


def _should_evict(e: Exception) -> bool:
    """Connection-level failures (refused/dropped/timed-out sockets) always
    evict — the replica's wire stack is gone. A `ReplicaUnavailable` the
    replica ANSWERED with evicts only on an explicit not-taking-work
    marker; anything else resubmits this request (the `tried` set already
    keeps it off the same replica) while the replica stays in rotation
    for everyone else."""
    if not isinstance(e, ReplicaUnavailable):
        return True
    return any(m in str(e) for m in _EVICT_MARKERS)


class ReplicaState:
    """Router-side view of one engine replica, including its circuit
    breaker: ``closed`` (in rotation) -> ``open`` (out of rotation —
    request-path eviction or ``breaker_threshold`` consecutive probe
    failures) -> after the cooldown ``half_open`` (one probe/trial
    decides) -> ``closed`` again or back to ``open``
    (docs/ROBUSTNESS.md "Circuit breaker")."""

    __slots__ = ("replica_id", "endpoint", "outstanding", "errors",
                 "breaker", "consec_fail", "probe_at", "evicted_at",
                 "stats", "stats_at", "role", "_g_out")

    def __init__(self, replica_id: str, endpoint: str):
        self.replica_id = replica_id
        self.endpoint = endpoint
        # disaggregation tier (docs/SERVING.md "Disaggregated serving"):
        # parsed from the lease id's role prefix ('prefill:'/'decode:');
        # an unprefixed legacy id is the symmetric 'both' tier. The
        # replica's own STATS role export refines this (static fleets
        # whose ids carry no prefix still classify).
        role = node_role(replica_id)
        self.role = role if role in ("prefill", "decode") else "both"
        self.outstanding = 0
        self.errors = 0
        self.breaker = "closed"
        self.consec_fail = 0       # consecutive health-probe failures
        self.probe_at = 0.0        # last health probe (monotonic)
        self.evicted_at = 0.0      # breaker-open timestamp (monotonic)
        self.stats = None          # last STATS snapshot (slo_aware policy)
        self.stats_at = 0.0
        self._g_out = metrics.gauge("router.outstanding",
                                    replica=replica_id)

    @property
    def draining(self) -> bool:
        """Back-compat view: out of normal rotation (breaker not
        closed)."""
        return self.breaker != "closed"


def _pick_round_robin(router: "Router", cands: list[ReplicaState]):
    router._rr += 1
    return cands[router._rr % len(cands)]


def _pick_least_outstanding(router: "Router", cands: list[ReplicaState]):
    return min(cands, key=lambda r: (r.outstanding, r.replica_id))


def _pick_slo_aware(router: "Router", cands: list[ReplicaState]):
    """Best observed decode SLO wins: rank by the replica's own
    ``serve.tpot_seconds`` p99 (pulled over STATS by the poll thread),
    outstanding as the tiebreak. A replica with no observations yet scores
    0.0 — optimistic, so fresh capacity gets traffic and earns a score."""
    def score(r: ReplicaState):
        tpot = None
        if r.stats:
            h = r.stats.get("histograms", {}).get("serve.tpot_seconds")
            if h:
                tpot = h.get("p99")
        return (0.0 if tpot is None else float(tpot), r.outstanding,
                r.replica_id)
    return min(cands, key=score)


POLICIES = {
    "round_robin": _pick_round_robin,
    "least_outstanding": _pick_least_outstanding,
    "slo_aware": _pick_slo_aware,
}


class Router:
    """Front door process: accepts serve-protocol connections, forwards
    GENERATE to a policy-picked replica, resubmits around failures.

    >>> router = Router(replicas={"r0": f"127.0.0.1:{p0}",
    ...                           "r1": f"127.0.0.1:{p1}"},
    ...                 replica_secret="fleet", auth_name="front")
    >>> threading.Thread(target=router.serve_forever, daemon=True).start()
    >>> cli = RemotePredictor(port=router.port, secret="front")
    >>> out = cli.generate(prompt_ids, max_new_tokens=64)

    ``registry`` is an observer-mode NodeRegistry / TcpNodeRegistry whose
    ``alive_nodes()`` maps replica id -> "host:port"; ``replicas`` is the
    static equivalent (both compose — static entries survive registry
    churn). ``replica_secret`` is the fleet-shared auth secret every
    replica was started with (its ``--auth-name``); None falls back to
    ``PADDLE_SERVE_TOKEN`` on both sides. The router's OWN client-facing
    auth follows the serve rules: ``auth_name`` > ``PADDLE_SERVE_TOKEN`` >
    a random per-startup token in ``generated_secret``.
    """

    def __init__(self, registry=None, replicas=None, policy="round_robin",
                 host="127.0.0.1", port=0, auth_name=None,
                 replica_secret=None, poll_interval_s=1.0,
                 stats_interval_s=5.0, max_resubmits=2,
                 evict_cooldown_s=5.0, connect_deadline_s=5.0,
                 request_timeout_s=600.0, breaker_threshold=3,
                 health_interval_s=None, page_size=None,
                 directory_capacity=4096):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; have {sorted(POLICIES)}")
        if registry is None and not replicas:
            raise ValueError("need a registry and/or static replicas")
        self._registry = registry
        self._policy = policy
        self._poll_interval = float(poll_interval_s)
        self._stats_interval = float(stats_interval_s)
        self._max_resubmits = int(max_resubmits)
        self._evict_cooldown = float(evict_cooldown_s)
        self._connect_deadline = float(connect_deadline_s)
        self._request_timeout = float(request_timeout_s)
        self._breaker_threshold = max(1, int(breaker_threshold))
        # PING probe cadence per replica; defaults to the poll interval
        # (probes ride the poll thread's cycle)
        self._health_interval = float(poll_interval_s
                                      if health_interval_s is None
                                      else health_interval_s)
        self._replica_token = auth_token(
            None if replica_secret is None else str(replica_secret))
        # fleet prefix directory (docs/SERVING.md "Disaggregated
        # serving"): rolling page hash -> prefill replica, fed by the
        # replicas' STATS prefix exports and the router's own routing;
        # `page_size` keys the prompt hashing — None learns it from the
        # first engine STATS pull (affinity is policy-pick until then)
        self._directory = PrefixDirectory(capacity=directory_capacity)
        self._page_size = None if page_size is None else int(page_size)
        self._rr = -1
        self._rlock = threading.Lock()
        self._replicas: dict[str, ReplicaState] = {}
        self._static = dict(replicas or {})
        # fold the registry in SYNCHRONOUSLY before listening: a
        # registry-only router must not serve its first poll_interval of
        # requests with an empty rotation
        reg_view = {}
        if registry is not None:
            try:
                reg_view = registry.alive_nodes()
            except OSError:
                pass               # registry not up yet: the poll catches up
        self._sync_membership(reg_view)

        self.generated_secret = None
        if auth_name is not None:
            basis = auth_name
        elif os.environ.get("PADDLE_SERVE_TOKEN"):
            basis = None
        else:
            self.generated_secret = _secrets.token_hex(16)
            basis = self.generated_secret
        self._token = auth_token(basis if basis is None else str(basis))

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._lease = None            # router-role registry lease
        self._fleet = None            # FleetMetrics fed by _refresh_stats
        self._slo = None              # fleet-scope SLOEvaluator (attach_slo)
        self._conns: set[socket.socket] = set()   # live client conns
        self._conn_lock = threading.Lock()
        # the membership poll thread ALWAYS runs: beyond registry
        # membership it is what re-admits an error-evicted replica after
        # the cooldown (static fleets included — without it an eviction
        # would be permanent). slo_aware's STATS pulls live on their OWN
        # thread: a half-open replica blocking a stats read must never
        # stall membership sync
        self._poll_thread = threading.Thread(
            target=self._poll_loop, daemon=True, name="pt-router-poll")
        self._poll_thread.start()
        # PING health probes get their OWN thread (docs/ROBUSTNESS.md):
        # probe IO against a dead replica must never stall membership
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="pt-router-health")
        self._probe_thread.start()
        # the STATS thread ALWAYS runs now (it used to be slo_aware-only):
        # beyond SLO ranking it is the fleet prefix directory's data feed
        # and how a static replica's role/page_size are learned — a
        # disaggregated fleet without it would never build affinity
        self._stats_thread = threading.Thread(
            target=self._stats_loop, daemon=True, name="pt-router-stats")
        self._stats_thread.start()

    # ----------------------------------------------------------- membership

    def replica_ids(self, healthy_only=False) -> list[str]:
        with self._rlock:
            return sorted(r.replica_id for r in self._replicas.values()
                          if not (healthy_only and r.draining))

    def replica_view(self) -> list[dict]:
        """Point-in-time snapshot of the rotation — one dict per replica
        with ``replica_id``/``endpoint``/``outstanding``/``breaker`` —
        for controllers that observe the router without reaching into its
        locking (the autoscaler, `serving/autoscale.py`)."""
        with self._rlock:
            return [dict(replica_id=r.replica_id, endpoint=r.endpoint,
                         outstanding=r.outstanding, breaker=r.breaker,
                         role=r.role)
                    for r in sorted(self._replicas.values(),
                                    key=lambda x: x.replica_id)]

    def _sync_membership(self, registry_alive: dict):
        """Fold one REGISTRY view in: new ids join rotation (breaker
        closed), missing ids (lease expired or deregistered) leave it.
        The static set is read HERE, under `_rlock` — never from a
        caller's snapshot — so a replica `remove_static_replica` just
        dropped cannot be resurrected (and a freshly added one cannot be
        transiently evicted) by a poll cycle that raced the mutation; a
        registry lease for the SAME id still wins the endpoint (a
        self-registering replica that restarts on a new port must be
        followed, not pinned to its stale static entry).
        An OPEN breaker is NOT reset by the registry still vouching for
        the replica — a crashed process keeps a fresh lease until its
        TTL; re-admission is the health probe's job (open -> half_open
        after the cooldown, then a successful PING closes it).
        ROUTER-role leases (``router:<id>`` — this router's own siblings
        in a redundant control plane) are NOT replicas: they share the
        registry for client discovery and never enter the rotation."""
        with self._rlock:
            alive = dict(self._static)
            # every non-router role joins the rotation — legacy replicas
            # ('both'), prefill workers and decode replicas alike; the
            # tier decides WHICH traffic they get (`_pick` keeps pure
            # prefill workers out of GENERATE placement)
            alive.update({rid: ep for rid, ep in registry_alive.items()
                          if node_role(rid) != "router"})
            for rid, ep in alive.items():
                self._join_replica(rid, str(ep))
            for rid in [rid for rid in self._replicas if rid not in alive]:
                self._leave_replica(self._replicas.pop(rid))

    def _join_replica(self, rid: str, ep: str):
        """Fold one replica into the rotation (or follow its endpoint) —
        the ONE join bookkeeping path, shared by the membership poll and
        `add_static_replica`. Caller holds ``_rlock``."""
        r = self._replicas.get(rid)
        if r is None:
            self._replicas[rid] = ReplicaState(rid, ep)
            metrics.counter("router.replica_joins").inc()
            flight.record("router.join", replica=rid, endpoint=ep)
        else:
            r.endpoint = ep

    def _leave_replica(self, r):
        """Leave bookkeeping for a replica already popped from the
        rotation — the ONE leave path, shared by the membership poll and
        `remove_static_replica`. Membership churn invalidates the
        replica's fleet-directory entries: affinity must never bias a
        route toward a corpse."""
        r._g_out.set(0)
        self._directory.invalidate(r.replica_id)
        metrics.counter("router.replica_leaves").inc()
        flight.record("router.leave", replica=r.replica_id)

    def add_static_replica(self, replica_id: str, endpoint: str):
        """Fold one replica into the STATIC membership at runtime (the
        autoscaler's spawn path, `serving/autoscale.py`): it joins the
        rotation immediately and survives registry churn like any other
        static entry. Thread-safe; re-adding an existing id just updates
        its endpoint. The `_static` mutation happens under `_rlock` —
        `_sync_membership` reads `_static` under the same lock, so a poll
        cycle can never observe (and act on) a half-applied change."""
        rid, ep = str(replica_id), str(endpoint)
        with self._rlock:
            self._static[rid] = ep
            self._join_replica(rid, ep)

    def remove_static_replica(self, replica_id: str):
        """Drop a replica from the static set AND the live rotation (the
        autoscaler's scale-down path — called BEFORE the drain so no new
        traffic lands on the victim while it migrates its in-flight work
        away). Atomic with respect to the membership poll (same `_rlock`
        discipline as `add_static_replica` — a concurrent `_sync_membership`
        can never resurrect the victim from a stale static snapshot). A
        registry lease for the same id re-admits it on the next poll;
        static scale-down therefore uses launcher-owned ids that never
        carry a lease."""
        rid = str(replica_id)
        with self._rlock:
            self._static.pop(rid, None)
            r = self._replicas.pop(rid, None)
        if r is not None:
            self._leave_replica(r)

    def _poll_loop(self):
        while not self._stop.wait(self._poll_interval):
            reg_view = {}
            if self._registry is not None:
                try:
                    reg_view = self._registry.alive_nodes()
                except OSError:
                    continue       # transient registry outage: hold steady
            self._sync_membership(reg_view)

    # ------------------------------------------------------ circuit breaker

    def _probe_loop(self):
        # probes live on their OWN thread: an unreachable replica's probe
        # IO (up to the probe deadline each) must never stall membership
        # sync or delay the other replicas' breaker transitions. The loop
        # survives ANY probe exception — open->half_open->closed recovery
        # happens nowhere else, so a dead probe thread would turn every
        # future breaker-open into a permanent eviction
        while not self._stop.wait(self._health_interval):
            try:
                self._probe_replicas()
            except Exception:  # noqa: BLE001 — recovery must outlive bugs
                metrics.counter("router.probe_errors").inc()

    def _probe_replicas(self):
        """Background PING health probes (one per replica per
        ``health_interval_s``, on the dedicated health thread): a closed
        replica failing ``breaker_threshold`` consecutive probes opens
        its breaker BEFORE a client request has to discover the corpse;
        an open breaker past the cooldown goes half-open and the probe's
        verdict closes or re-opens it."""
        now = time.monotonic()
        due = []
        with self._rlock:
            for r in self._replicas.values():
                if r.breaker == "open" and \
                        now - r.evicted_at >= self._evict_cooldown:
                    r.breaker = "half_open"
                    metrics.counter("router.breaker_half_open").inc()
                    flight.record("router.breaker", replica=r.replica_id,
                                  state="half_open")
                if r.breaker == "half_open" or (
                        r.breaker == "closed"
                        and now - r.probe_at >= self._health_interval):
                    due.append(r)
        # concurrent fan-out (same pattern as _route_cancel): one dead
        # replica's probe must cost the CYCLE its own deadline, not push
        # every later replica's probe and breaker transition behind it
        def _one(rep):
            rep.probe_at = time.monotonic()
            self._record_probe(rep, self._ping_replica(rep))
        ths = [threading.Thread(target=_one, args=(rep,), daemon=True)
               for rep in due]
        for t in ths:
            t.start()
        for t in ths:
            t.join()

    def _ping_replica(self, r: ReplicaState) -> bool:
        """One authed PING exchange at probe-grade timeouts (clipped to
        2 s regardless of the request-path connect deadline) — a probe
        must cost this loop milliseconds-to-seconds, never a request
        timeout."""
        probe_deadline = min(self._connect_deadline, 2.0)
        try:
            # endpoint parse INSIDE the guard: a malformed registry entry
            # ("host" with no port) is a failed probe, not a probe-thread
            # killer
            host, port = r.endpoint.rsplit(":", 1)
            sock = retrying_connect(host, int(port),
                                    timeout=probe_deadline + 2.0,
                                    attempts=1,
                                    deadline_s=probe_deadline)
        except (OSError, ConnectionError, ValueError):
            return False
        try:
            sock.sendall(struct.pack("<I", MAGIC) + self._replica_token)
            sock.sendall(struct.pack("<III", MAGIC, OP_PING, 0))
            magic, status, _ = struct.unpack(
                "<III", _recv_exact(sock, 12))
            return magic == MAGIC and status == 0
        except (OSError, ConnectionError, struct.error):
            return False
        finally:
            sock.close()

    def _record_probe(self, r: ReplicaState, ok: bool):
        with self._rlock:
            if ok:
                r.consec_fail = 0
                # a successful probe closes HALF-OPEN only: a stale PING
                # that was in flight when the request path opened the
                # breaker must not re-close it with no cooldown (PING
                # succeeding is weak evidence — a dead engine's serve
                # loop still answers it); an open breaker waits out its
                # cooldown and earns closure from the half-open probe
                if r.breaker == "half_open":
                    r.breaker = "closed"
                    metrics.counter("router.breaker_close").inc()
                    flight.record("router.breaker",
                                  replica=r.replica_id, state="closed")
                return
            r.consec_fail += 1
            if r.breaker == "half_open" or (
                    r.breaker == "closed"
                    and r.consec_fail >= self._breaker_threshold):
                self._open_breaker_locked(r, "health probe failed")

    def _open_breaker_locked(self, r: ReplicaState, reason: str):
        """Caller holds ``_rlock``."""
        r.breaker = "open"
        r.evicted_at = time.monotonic()
        r.errors += 1
        metrics.counter("router.breaker_open").inc()
        flight.record("router.breaker", replica=r.replica_id,
                      state="open", reason=reason)

    def _stats_loop(self):
        while not self._stop.wait(self._poll_interval):
            self._refresh_stats()
            if self._slo is not None and self._fleet is not None:
                # fleet-scope burn-rate pass over the rollup the SAME
                # pull just refreshed — alert evaluation rides the
                # existing cadence, no second clock
                try:
                    self._slo.evaluate(self._fleet.rollup())
                except Exception:  # noqa: BLE001 — telemetry never
                    pass           # stalls the stats loop

    def _refresh_stats(self):
        """Pull each healthy replica's STATS snapshot (rate-limited per
        replica) so `slo_aware` ranks on fresh serve.tpot histograms. A
        failed pull only ages the cached stats — placement failure
        handling stays with the forward path."""
        now = time.monotonic()
        with self._rlock:
            due = [r for r in self._replicas.values()
                   if not r.draining
                   and now - r.stats_at >= self._stats_interval]
        for r in due:
            # stats_at advances on FAILURE too: a wedged replica must be
            # rate-limited like a healthy one, or it would stay "due" and
            # stall every poll cycle back to back
            r.stats_at = time.monotonic()
            try:
                # short dedicated IO timeout: a STATS pull is a few KB of
                # telemetry, never worth the full GENERATE request
                # timeout — a half-open replica must cost this loop
                # seconds, not minutes
                snap = self._replica_op(r, OP_STATS,
                                        timeout=self._connect_deadline + 5.0)
                r.stats = json.loads(snap.tobytes().decode())
            except (OSError, ConnectionError, ValueError):
                continue
            if self._fleet is not None:
                # fleet metrics plane (docs/OBSERVABILITY.md "Fleet
                # metrics plane"): the SAME pull that feeds slo_aware and
                # the prefix directory feeds the fleet rollup — no second
                # scrape loop against the replicas
                try:
                    self._fleet.ingest(r.replica_id, r.role, r.endpoint,
                                       r.stats)
                except (TypeError, ValueError, KeyError):
                    pass    # malformed snapshot: the rollup keeps its view
            # disaggregation extras (docs/SERVING.md "Disaggregated
            # serving"): the replica's self-declared role (refines the
            # lease-prefix classification — static fleets with
            # unprefixed ids still tier), the fleet page size, and —
            # for prefill workers — the prefix-store hashes that FEED
            # the fleet directory (replace() also drops entries the
            # store evicted or flushed: stale affinity self-heals)
            role = r.stats.get("role")
            if role in ("both", "prefill", "decode"):
                r.role = role
            pre = r.stats.get("prefix") or {}
            if self._page_size is None and pre.get("page_size"):
                self._page_size = int(pre["page_size"])
            if r.role == "prefill" and ("hashes" in pre
                                        or "spilled" in pre):
                try:
                    # KV tiering: SPILLED chains route like resident ones
                    # (the replica re-uploads on hit — docs/SERVING.md
                    # "KV tiering"); the directory just meters them apart
                    spilled = [bytes.fromhex(h)
                               for h in pre.get("spilled", [])]
                    self._directory.replace(
                        r.replica_id,
                        [bytes.fromhex(h)
                         for h in pre.get("hashes", [])] + spilled,
                        spilled=spilled)
                except ValueError:
                    pass       # malformed export: keep the old view

    # -------------------------------------------------------------- routing

    def _pick(self, tried: set,
              key: bytes | None = None) -> ReplicaState | None:
        with self._rlock:
            # pure prefill workers never take GENERATE traffic — a
            # decode on one would compile decode programs and break the
            # tier contract (decode and legacy 'both' replicas both can)
            cands = [r for r in self._replicas.values()
                     if r.breaker == "closed" and r.role != "prefill"
                     and r.replica_id not in tried]
            if not cands:
                # no closed replica left: a HALF-OPEN one may carry trial
                # traffic — its success re-closes the breaker, its failure
                # re-opens it (the request still has its resubmit budget)
                cands = [r for r in self._replicas.values()
                         if r.breaker == "half_open"
                         and r.role != "prefill"
                         and r.replica_id not in tried]
            if not cands:
                return None
            if key is not None:
                # KEYED placement is rendezvous-hashed, not policy-picked
                # (docs/ROBUSTNESS.md "Control-plane HA"): routers with
                # the same healthy view independently compute the same
                # replica for a key — a resubmit through a DIFFERENT
                # router lands on the engine whose dedup table already
                # holds the request, with no shared routing state (and
                # only a transient breaker-view divergence can re-run a
                # key elsewhere). Random 16-byte keys spread uniformly,
                # and HRW moves only the affected keys on membership
                # churn; the `tried` fallback order matches across
                # routers too.
                return max(cands, key=lambda r: self._hrw(key, r))
            cands.sort(key=lambda r: r.replica_id)
            return POLICIES[self._policy](self, cands)

    @staticmethod
    def _hrw(key: bytes, r: ReplicaState) -> tuple:
        h = hashlib.blake2b(key + r.replica_id.encode(),
                            digest_size=8).digest()
        return (int.from_bytes(h, "little"), r.replica_id)

    @staticmethod
    def _request_key(arrays) -> bytes | None:
        """The GENERATE options array's 16-byte idempotency key (the
        7-wide options shape's trailing four int32 words), if present."""
        if len(arrays) >= 3:
            opts = np.asarray(arrays[2]).reshape(-1)
            if opts.size >= 7 and np.any(opts[3:7]):
                return np.ascontiguousarray(opts[3:7], np.int32).tobytes()
        return None

    @staticmethod
    def _trace_ctx(arrays) -> tuple[str | None, str | None]:
        """The GENERATE options array's fleet trace context — the 13-wide
        options shape's trailing TRACE_WORDS int32 words — as a
        ``(trace_id, parent_span)`` hex pair; ``(None, None)`` when no
        context rode the request (all-zero words)."""
        if len(arrays) >= 3:
            opts = np.asarray(arrays[2]).reshape(-1)
            if opts.size >= 13:
                return words_to_trace([int(w) for w in opts[7:13]])
        return None, None

    def _evict(self, r: ReplicaState, reason: str):
        with self._rlock:
            self._open_breaker_locked(r, reason)
        flight.record("router.evict", replica=r.replica_id, reason=reason)

    def _replica_op(self, r: ReplicaState, op: int, arrays=(),
                    timeout=None, client_conn=None):
        """One request/response exchange with a replica on a fresh authed
        connection. Returns the response arrays (GENERATE) or single
        payload array (STATS/PROMETHEUS). A connection per exchange is
        deliberate: the failure classification (`_classify_wire_error`)
        needs request/response isolation — a resubmitted request must
        never read a half-delivered response from a previous exchange —
        and it keeps the router stateless about replica sockets; a
        persistent-pool optimization would buy one connect RTT per
        request at the cost of desync tracking.

        ``client_conn`` (GENERATE only): while the replica decodes, the
        ROUTER's own client socket is watched; client EOF drops the
        replica connection — whose serve-side disconnect watch then
        cancels the request into its engine — and raises
        `_ClientDisconnected`. The disconnect chain composes across
        tiers: client -> router -> replica -> engine.cancel
        (docs/ROBUSTNESS.md "Cancellation")."""
        eff_timeout = timeout if timeout is not None \
            else self._request_timeout
        host, port = r.endpoint.rsplit(":", 1)
        sock = retrying_connect(host, int(port), timeout=eff_timeout,
                                attempts=2,
                                deadline_s=self._connect_deadline)
        sent = False
        try:
            sock.sendall(struct.pack("<I", MAGIC) + self._replica_token)
            sock.sendall(struct.pack("<III", MAGIC, op, len(arrays)))
            if arrays:
                send_arrays(sock, arrays)
            sent = True
            if client_conn is not None:
                self._await_replica_or_client_gone(sock, client_conn,
                                                   eff_timeout)
            magic, status, n = struct.unpack(
                "<III", _recv_exact(sock, 12))
            if magic != MAGIC:
                raise ConnectionError(
                    f"bad magic from replica {r.replica_id} (auth "
                    f"mismatch drops the connection — check "
                    f"replica_secret)")
            if status != 0:
                msg = _recv_exact(sock, n).decode(errors="replace")
                raise _classify_wire_error(msg)
            outs = recv_arrays(sock, n)
            return outs if op == OP_GENERATE else outs[0]
        except (ConnectionError, socket.timeout, OSError) as e:
            # a wire death AFTER the request was delivered is AMBIGUOUS:
            # the replica may be running — or may already have finished —
            # the work. `_route_generate` gives a keyed request one
            # same-replica retry on this (the dedup table resolves the
            # ambiguity); everything else keeps the evict+resubmit path
            if sent and not isinstance(e, ReplicaUnavailable):
                # a classified ReplicaUnavailable is an ANSWER (the
                # replica refused the work) — definitive, not ambiguous
                e._pt_ambiguous = True
            raise
        finally:
            sock.close()

    @staticmethod
    def _await_replica_or_client_gone(sock, conn, timeout):
        """Block until the replica's response STARTS, peeking the
        router's own client socket each cycle (`serve.peek_disconnect` —
        the same liveness idiom serve's GENERATE wait uses, shared so the
        two tiers of the disconnect chain cannot drift). On client EOF:
        count it and raise — the enclosing finally closes the replica
        socket, which is exactly the disconnect the replica's serve-side
        watch turns into an engine cancel."""
        t_end = time.monotonic() + timeout
        watch = True
        while True:
            readable, _, _ = select.select([sock], [], [], 0.25)
            if readable:
                return
            if watch:
                state = peek_disconnect(conn)
                if state == "pipelined":
                    watch = False
                elif state == "gone":
                    metrics.counter("router.disconnect_drops").inc()
                    raise _ClientDisconnected(
                        "client disconnected mid-GENERATE (replica "
                        "connection dropped; the replica cancels)")
            if time.monotonic() >= t_end:
                raise socket.timeout(
                    "timed out waiting for replica response")

    @staticmethod
    def _deadline_ms(arrays) -> int | None:
        """The GENERATE options array's deadline_ms (> 0), if present."""
        if len(arrays) >= 3:
            opts = np.asarray(arrays[2]).reshape(-1)
            if opts.size >= 3 and int(opts[2]) > 0:
                return int(opts[2])
        return None

    def _route_generate(self, arrays, conn=None) -> list[np.ndarray]:
        """Forward one GENERATE to a policy-picked replica; on replica
        failure open its breaker and resubmit elsewhere, up to
        ``max_resubmits`` times. A request carrying a deadline forwards
        its REMAINING budget on every attempt (and clips the attempt's IO
        timeout to it), so resubmission can never stretch a request past
        its deadline. Raises to the client only when the budget, the
        deadline, or the healthy set is exhausted (or the request itself
        is bad) — always one clean typed line, never a hang.

        A request carrying an idempotency KEY routes by rendezvous hash
        (`_pick`), forwards the CLIENT's key on every attempt (never a
        per-attempt identity), and treats an ambiguous mid-wire death —
        the request was delivered, the answer never arrived — as ONE
        free same-replica retry: the replica's dedup table attaches or
        replays, so the ambiguity costs zero duplicate generations and
        no eviction (docs/ROBUSTNESS.md "Control-plane HA")."""
        rid_req = new_request_id()
        budget = self._max_resubmits
        tried: set[str] = set()
        key = self._request_key(arrays)
        trace_id, client_span = self._trace_ctx(arrays)
        router_span = None
        if trace_id is not None:
            # re-parent the forwarded context to THIS hop's span id so the
            # replica's spans chain client -> router -> replica; the trace
            # id itself is forwarded verbatim on every attempt (resubmits
            # and ack-retries reuse the rewritten options array)
            router_span = new_span_id()
            arrays = list(arrays)
            opts = np.array(np.asarray(arrays[2]).reshape(-1), np.int32,
                            copy=True)
            opts[7:13] = trace_to_words(trace_id, router_span)
            arrays[2] = opts
        retried_same: set[str] = set()
        forced: ReplicaState | None = None
        t0 = time.perf_counter()
        deadline_ms = self._deadline_ms(arrays)
        t_deadline = None if deadline_ms is None \
            else time.monotonic() + deadline_ms / 1000.0
        last_err = None
        overloads = others = 0
        if self._disagg_ready():
            # two-phase flow first (docs/SERVING.md "Disaggregated
            # serving"); a None return — the prefill tier failed or died
            # mid-stream — falls back to the symmetric loop below, which
            # prefills on the decode-capable replica itself. Terminal
            # outcomes raise straight through.
            outs = self._route_disagg(arrays, conn, key, t_deadline,
                                      deadline_ms, rid_req, t0,
                                      (trace_id, client_span, router_span))
            if outs is not None:
                return outs
            metrics.counter("router.disagg_fallbacks").inc()
            flight.record("router.disagg_fallback", request_id=rid_req)
        while True:
            fwd, timeout = arrays, None
            if t_deadline is not None:
                remaining = t_deadline - time.monotonic()
                if remaining <= 0:
                    metrics.counter("router.deadline_exceeded").inc()
                    raise DeadlineExceeded(
                        f"request deadline ({deadline_ms} ms) exhausted "
                        f"after {len(tried)} attempt(s)"
                        + (f"; last replica error: {last_err}"
                           if last_err else ""))
                # forward the REMAINING budget, not the original: the
                # replica's engine must expire the request by the
                # CLIENT's clock, resubmits included
                fwd = list(arrays)
                opts = np.array(np.asarray(arrays[2]).reshape(-1),
                                np.int32, copy=True)
                opts[2] = max(1, int(remaining * 1000))
                fwd[2] = opts
                # grace past the replica's own deadline handling: the
                # engine answers DeadlineExceeded first; the clip only
                # catches a wedged replica
                timeout = min(self._request_timeout, remaining + 10.0)
            r, forced = forced if forced is not None \
                else self._pick(tried, key=key), None
            if r is None:
                if overloads and not others:
                    # every reachable replica answered a typed shed:
                    # relay ONE typed Overloaded line (retryable-later),
                    # not a router-internal wrapper
                    metrics.counter("router.shed").inc()
                    raise Overloaded(
                        f"all replicas shedding load; last: {last_err}")
                metrics.counter("router.no_replica").inc()
                raise RuntimeError(
                    "router: no healthy replica available"
                    + (f" (last error from {last_err})" if last_err
                       else ""))
            with self._rlock:
                r.outstanding += 1
                r._g_out.set(r.outstanding)
            try:
                outs = self._replica_op(r, OP_GENERATE, fwd,
                                        timeout=timeout, client_conn=conn)
            except (ReplicaUnavailable, ConnectionError, socket.timeout,
                    OSError) as e:
                last_err = f"{r.replica_id}: {type(e).__name__}: {e}"
                metrics.counter("router.replica_errors").inc()
                if key is not None and getattr(e, "_pt_ambiguous", False) \
                        and r.replica_id not in retried_same:
                    # AMBIGUOUS wire death on a KEYED request: the replica
                    # got the request and may be decoding (or done) — a
                    # resubmit elsewhere would duplicate the generation.
                    # Retry the SAME replica once, free of eviction and
                    # resubmit budget: its dedup table attaches/replays.
                    # A replica that is actually dead fails the retry's
                    # CONNECT (unambiguous) and takes the normal
                    # evict+resubmit path below.
                    retried_same.add(r.replica_id)
                    forced = r
                    metrics.counter("router.ack_retries").inc()
                    flight.record("router.ack_retry",
                                  replica=r.replica_id, error=last_err)
                    continue
                if isinstance(e, ReplicaUnavailable) \
                        and str(e).startswith("Overloaded"):
                    overloads += 1     # healthy replica, full queue: no
                    #                    breaker action, try elsewhere
                else:
                    others += 1
                if _should_evict(e):
                    self._evict(r, f"{type(e).__name__}: {e}")
                tried.add(r.replica_id)
                if budget <= 0:
                    if overloads and not others:
                        metrics.counter("router.shed").inc()
                        raise Overloaded(
                            f"all replicas shedding load; last: "
                            f"{last_err}") from e
                    raise RuntimeError(
                        f"router: resubmit budget "
                        f"({self._max_resubmits}) exhausted; last "
                        f"replica error: {last_err}") from e
                budget -= 1
                metrics.counter("router.resubmits").inc()
                continue
            finally:
                with self._rlock:
                    r.outstanding -= 1
                    r._g_out.set(r.outstanding)
            with self._rlock:
                r.consec_fail = 0
                # half-open trial succeeded: the replica is back. ONLY
                # half-open — a success that was in flight when another
                # request's failure opened the breaker must not re-close
                # it with zero cooldown (same stale-success guard as
                # `_record_probe`)
                if r.breaker == "half_open":
                    r.breaker = "closed"
                    metrics.counter("router.breaker_close").inc()
                    flight.record("router.breaker",
                                  replica=r.replica_id, state="closed")
            dt = time.perf_counter() - t0
            metrics.counter("router.requests").inc()
            metrics.counter("router.replica_requests",
                            replica=r.replica_id).inc()
            metrics.histogram("router.request_seconds").observe(dt)
            metrics.add_span("router.forward", t0, dt, cat="router",
                             args={"request_id": rid_req,
                                   "replica": r.replica_id},
                             trace_id=trace_id, parent=client_span,
                             span_id=router_span)
            return outs

    # ------------------------------------------------ disaggregated routing

    def _disagg_ready(self) -> bool:
        """The two-phase flow needs BOTH tiers healthy: >= 1 closed
        prefill worker and >= 1 closed decode-capable replica. Anything
        less routes symmetric — disaggregation is an optimization, never
        an availability dependency."""
        with self._rlock:
            has_p = any(r.breaker == "closed" and r.role == "prefill"
                        for r in self._replicas.values())
            has_d = any(r.breaker == "closed"
                        and r.role in ("decode", "both")
                        for r in self._replicas.values())
        return has_p and has_d

    def _pick_prefill(self, hashes):
        """``(replica, affinity_hit)``: the prefill worker for this
        prompt. The fleet directory biases shared-prefix traffic to the
        worker whose store already holds the longest prefix (the prompt
        then prefills only its uncached tail — a system prompt costs the
        FLEET one prefill); a miss falls back to the placement policy.
        Fault site ``router.stale_directory`` forces a deliberately
        stale affinity route (deterministic staleness drill: the worker
        just prefills the whole prompt — correctness never depended on
        the directory)."""
        with self._rlock:
            cands = [r for r in self._replicas.values()
                     if r.breaker == "closed" and r.role == "prefill"]
            if not cands:
                return None, False
            cands.sort(key=lambda r: r.replica_id)
            if faults.ENABLED and faults.fire("router.stale_directory"):
                metrics.counter("router.stale_affinity").inc()
                return cands[-1], True
            if hashes:
                rid, depth = self._directory.lookup(hashes)
                if rid is not None:
                    for r in cands:
                        if r.replica_id == rid:
                            spilled = self._directory.is_spilled(
                                hashes[depth - 1], rid)
                            if spilled:
                                # the hit's deepest page lives in a spill
                                # tier: this route trades a re-upload for
                                # a fleet-wide re-prefill
                                metrics.counter(
                                    "router.affinity_spilled").inc()
                            flight.record("router.affinity",
                                          replica=rid, depth=depth,
                                          spilled=spilled)
                            return r, True
            return POLICIES[self._policy](self, cands), False

    def _pick_decode(self, key):
        """The decode replica for a disaggregated request: dedicated
        decode tier first, legacy 'both' replicas as the fallback pool.
        Keyed requests keep their rendezvous-hash placement so a
        failover resubmit lands on the engine whose dedup table owns the
        key (docs/ROBUSTNESS.md "Control-plane HA")."""
        with self._rlock:
            cands = [r for r in self._replicas.values()
                     if r.breaker == "closed" and r.role == "decode"]
            if not cands:
                cands = [r for r in self._replicas.values()
                         if r.breaker == "closed" and r.role == "both"]
            if not cands:
                return None
            if key is not None:
                return max(cands, key=lambda r: self._hrw(key, r))
            cands.sort(key=lambda r: r.replica_id)
            return POLICIES[self._policy](self, cands)

    def _open_replica(self, r: ReplicaState, timeout):
        """Fresh authed replica connection (the disagg exchanges manage
        their own sockets — one prefill stream feeds one decode stream,
        so the request/response isolation of `_replica_op` does not
        fit)."""
        host, port = r.endpoint.rsplit(":", 1)
        sock = retrying_connect(host, int(port), timeout=timeout,
                                attempts=2,
                                deadline_s=self._connect_deadline)
        sock.sendall(struct.pack("<I", MAGIC) + self._replica_token)
        return sock

    def _route_disagg(self, arrays, conn, key, t_deadline, deadline_ms,
                      rid_req, t0, trace3=(None, None, None)):
        """One two-phase GENERATE (docs/SERVING.md "Disaggregated
        serving"): OP_PREFILL to the affinity-picked prefill worker,
        whose PTKS1 page records RELAY to the chosen decode replica's
        OP_KV_STREAM as they are produced — the decode replica admits
        the slot the moment the final record lands and answers the full
        sequence, token-identical to a symmetric route. Deadlines
        forward as remaining budget, the cancel tag and idempotency key
        ride the stream options, and the client-disconnect watch covers
        the prefill wait, the record relay AND the decode wait (a
        client hanging up mid-prefill drops both sockets — the fleet
        stops paying immediately). One honest window: a CANCEL by tag
        that arrives while the prefill is still streaming is a clean
        miss — the tag registers on the decode replica with the stream
        options — so the request runs to completion; the disconnect
        chain is what bounds an abandoned client's cost.

        Returns the response arrays, or None to FALL BACK to symmetric
        routing (prefill worker dead/mid-stream death/no tier capacity)
        — the decode side discards a partial stream with its pool
        untouched, and the caller re-runs the prompt as a plain
        GENERATE. Terminal per-request outcomes (validation errors,
        DeadlineExceeded, Cancelled, client disconnect) raise through
        verbatim; they would be identical on any route."""
        trace_id, client_span, router_span = trace3
        # both tiers' spans parent on the router hop: the prefill worker's
        # engine.prefill_stream AND the decode replica's request spans
        # chain under one router.forward — the stitched trace shows the
        # two-phase fan-out as siblings, not a linear chain
        twords = trace_to_words(trace_id, router_span) \
            if trace_id is not None else None
        prompt = np.ascontiguousarray(np.asarray(arrays[0]).reshape(-1),
                                      np.int32)
        mnt = int(np.asarray(arrays[1]).reshape(-1)[0])
        cache, spec = 1, 1
        if len(arrays) >= 3:
            opts = np.asarray(arrays[2]).reshape(-1)
            cache, spec = int(opts[0]), int(opts[1])
        tag = np.ascontiguousarray(arrays[3], np.uint8).reshape(-1) \
            if len(arrays) == 4 else np.zeros(0, np.uint8)
        hashes = prompt_page_hashes(prompt, self._page_size) \
            if (self._page_size and cache) else []
        pre, hit = self._pick_prefill(hashes)
        dec = self._pick_decode(key)
        if pre is None or dec is None:
            return None
        metrics.counter("router.disagg_requests").inc()
        (metrics.counter("router.affinity_hits") if hit
         else metrics.counter("router.affinity_misses")).inc()
        timeout = self._request_timeout
        remaining_ms = 0
        if t_deadline is not None:
            remaining = t_deadline - time.monotonic()
            if remaining <= 0:
                metrics.counter("router.deadline_exceeded").inc()
                raise DeadlineExceeded(
                    f"request deadline ({deadline_ms} ms) exhausted "
                    f"before the prefill tier was reached")
            remaining_ms = max(1, int(remaining * 1000))
            timeout = min(self._request_timeout, remaining + 10.0)
        opts_kv = [mnt, cache, spec, remaining_ms]
        if key is not None or twords is not None:
            # the trace words ride PAST the key slot, so a traced keyless
            # request pads four zero key words (serve's parser ignores an
            # all-zero key group)
            opts_kv += ([int(w) for w in np.frombuffer(key, np.int32)]
                        if key is not None else [0, 0, 0, 0])
        if twords is not None:
            opts_kv += twords
        # 1. start the prefill stream
        psock = None
        try:
            psock = self._open_replica(pre, timeout)
            psock.settimeout(timeout)
            psock.sendall(struct.pack("<III", MAGIC, OP_PREFILL, 2))
            popts = [cache] + twords if twords is not None else [cache]
            send_arrays(psock, [prompt, np.asarray(popts, np.int32)])
            if conn is not None:
                # watch the CLIENT while the worker plans the stream —
                # same disconnect chain as the decode wait
                self._await_replica_or_client_gone(psock, conn, timeout)
            magic, status, n_records = struct.unpack(
                "<III", _recv_exact(psock, 12))
            if magic != MAGIC:
                raise ConnectionError(
                    f"bad magic from prefill worker {pre.replica_id}")
            if status != 0:
                msg = _recv_exact(psock, n_records).decode(
                    errors="replace")
                raise _classify_wire_error(msg)
        except (_ReplicaAppError, _ClientDisconnected):
            if psock is not None:
                psock.close()
            raise                    # identical on any route / nobody left
        except (ReplicaUnavailable, ConnectionError, socket.timeout,
                OSError) as e:
            if psock is not None:
                psock.close()
            metrics.counter("router.replica_errors").inc()
            if _should_evict(e):
                self._evict(pre, f"prefill: {type(e).__name__}: {e}")
            return None
        # 2. relay records to the decode replica as they are produced,
        #    then await its answer (client-disconnect watched)
        dsock = None
        with self._rlock:
            dec.outstanding += 1
            dec._g_out.set(dec.outstanding)
        try:
            try:
                dsock = self._open_replica(dec, timeout)
                dsock.settimeout(timeout)
                dsock.sendall(struct.pack("<III", MAGIC, OP_KV_STREAM,
                                          2 + int(n_records)))
                send_arrays(dsock, [np.asarray(opts_kv, np.int32), tag])
            except (ConnectionError, socket.timeout, OSError) as e:
                metrics.counter("router.replica_errors").inc()
                if _should_evict(e):
                    self._evict(dec, f"decode: {type(e).__name__}: {e}")
                return None
            try:
                for _ in range(int(n_records)):
                    try:
                        # the client-disconnect watch covers the RELAY
                        # too: a client hanging up 100 ms into a 30 s
                        # prefill must stop the fleet paying for it —
                        # dropping both sockets cancels the decode side
                        # (its disconnect watch) and orphans the prefill
                        # stream. _ClientDisconnected is not a wire
                        # error and propagates past the except below.
                        if conn is not None:
                            self._await_replica_or_client_gone(
                                psock, conn, timeout)
                        (rec,) = recv_arrays(psock, 1)
                    except (ConnectionError, socket.timeout, OSError,
                            struct.error) as e:
                        # MID-STREAM prefill-worker death: drop both
                        # sockets — the decode replica discards the
                        # partial stream with its pool at baseline —
                        # and fall back to symmetric prefill
                        metrics.counter("router.replica_errors").inc()
                        metrics.counter("router.stream_aborts").inc()
                        flight.record("router.stream_abort",
                                      request_id=rid_req,
                                      prefill=pre.replica_id,
                                      error=f"{type(e).__name__}: {e}")
                        self._evict(pre, f"prefill stream died: "
                                         f"{type(e).__name__}: {e}")
                        return None
                    try:
                        send_arrays(dsock, [rec])
                    except (ConnectionError, socket.timeout, OSError) \
                            as e:
                        # the DECODE wire died under the relay: that is
                        # the decode replica's failure, not the prefill
                        # worker's — evict the right breaker
                        metrics.counter("router.replica_errors").inc()
                        metrics.counter("router.stream_aborts").inc()
                        flight.record("router.stream_abort",
                                      request_id=rid_req,
                                      decode=dec.replica_id,
                                      error=f"{type(e).__name__}: {e}")
                        self._evict(dec, f"decode stream died: "
                                         f"{type(e).__name__}: {e}")
                        return None
            finally:
                psock.close()
                psock = None
            try:
                if conn is not None:
                    self._await_replica_or_client_gone(dsock, conn,
                                                       timeout)
                magic, status, n = struct.unpack(
                    "<III", _recv_exact(dsock, 12))
                if magic != MAGIC:
                    raise ConnectionError(
                        f"bad magic from decode replica "
                        f"{dec.replica_id}")
                if status != 0:
                    msg = _recv_exact(dsock, n).decode(errors="replace")
                    raise _classify_wire_error(msg)
                outs = recv_arrays(dsock, n)
            except _ReplicaAppError:
                raise      # DeadlineExceeded/Cancelled/validation: relay
            except (ReplicaUnavailable, ConnectionError, socket.timeout,
                    OSError) as e:
                metrics.counter("router.replica_errors").inc()
                if _should_evict(e):
                    self._evict(dec, f"decode: {type(e).__name__}: {e}")
                return None
        finally:
            if psock is not None:
                psock.close()
            if dsock is not None:
                dsock.close()
            with self._rlock:
                dec.outstanding -= 1
                dec._g_out.set(dec.outstanding)
        # success bookkeeping: the worker's store now holds this
        # prompt's pages — register them so the NEXT shared-prefix
        # request routes with affinity even before the STATS pull
        if hashes:
            self._directory.register(hashes, pre.replica_id)
        with self._rlock:
            for r in (pre, dec):
                r.consec_fail = 0
                if r.breaker == "half_open":
                    r.breaker = "closed"
                    metrics.counter("router.breaker_close").inc()
        dt = time.perf_counter() - t0
        metrics.counter("router.requests").inc()
        metrics.counter("router.replica_requests",
                        replica=dec.replica_id).inc()
        metrics.histogram("router.request_seconds").observe(dt)
        metrics.add_span("router.forward", t0, dt, cat="router",
                         args={"request_id": rid_req,
                               "replica": dec.replica_id,
                               "prefill": pre.replica_id},
                         trace_id=trace_id, parent=client_span,
                         span_id=router_span)
        return outs

    def _route_cancel(self, arrays) -> np.ndarray:
        """CANCEL op: the router is stateless about which replica holds a
        tag, so the cancel fans out to every non-open replica; the one
        holding live work answers 1 (docs/ROBUSTNESS.md). Probe-grade
        timeouts — a cancel must never cost a request timeout."""
        if len(arrays) != 1:
            raise ValueError(
                f"CANCEL wants one uint8 tag array, got {len(arrays)}")
        with self._rlock:
            # EVERY replica, open breakers included: a breaker opened by
            # an unrelated transient failure can still hold the live
            # request this cancel is for, and a cancel is cheap and
            # idempotent — a dead endpoint just times out at probe grade
            reps = list(self._replicas.values())
        hits: list[int] = []

        def _one(rep):
            try:
                out = self._replica_op(
                    rep, OP_CANCEL, arrays,
                    timeout=min(self._connect_deadline, 2.0) + 3.0)
                hits.append(int(np.asarray(out).reshape(-1)[0]))
            except (OSError, ConnectionError, RuntimeError):
                pass        # a cancel miss must never become an error
        # concurrent fan-out: cancellation latency is the slowest single
        # replica, not the sum — one wedged replica must not delay the
        # cancel reaching the replica actually holding the work
        ths = [threading.Thread(target=_one, args=(rep,), daemon=True)
               for rep in reps]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        metrics.counter("router.cancels").inc()
        return np.asarray([1 if any(hits) else 0], np.int32)

    # ------------------------------------------------------------ wire side

    def attach_fleet(self, fleet):
        """Feed ``fleet`` (an `observability.fleet.FleetMetrics`) from
        this router's STATS poll loop: every per-replica snapshot the
        loop pulls is ingested with its ``{role, replica}`` identity, so
        the fleet rollup rides the existing scrape instead of adding a
        second one. Returns ``self`` for chaining."""
        self._fleet = fleet
        return self

    def attach_slo(self, evaluator):
        """Evaluate ``evaluator`` (an `observability.slo.SLOEvaluator`,
        scope ``"fleet"``) against the fleet rollup after every stats
        poll. Needs `attach_fleet` — the rollup is the snapshot the
        evaluator windows over. Returns ``self`` for chaining."""
        self._slo = evaluator
        return self

    def attach_registry(self, lease):
        """Hold the ROUTER-ROLE registry lease this router registered
        under (node id ``router:<id>``, `elastic.router_node_id`):
        clients discover the redundant router set from these leases
        (`RemotePredictor(registry_dir=...)`), sibling routers and the
        replicas' peer discovery skip them by role. `stop()` deregisters
        so a cleanly stopped router leaves the failover set."""
        self._lease = lease
        return self

    def serve_forever(self):
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.5)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._conn_lock:
                self._conns.add(conn)
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()
        self._sock.close()

    def stop(self, hard=False):
        """Stop accepting. ``hard=True`` additionally severs every LIVE
        client connection — the router-kill drill's process-death
        equivalent: blocked clients see EOF and fail over to a surviving
        router (docs/ROBUSTNESS.md "Control-plane HA")."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._lease is not None:
            try:
                self._lease.leave()
            except OSError:
                pass
            self._lease = None
        if hard:
            with self._conn_lock:
                conns = list(self._conns)
            for c in conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass

    def _client_loop(self, conn):
        """Same protocol discipline as `InferenceServer._client_loop`:
        authed hello, then ops; any error mid-request reports and drops
        the connection (stream position is unknowable after a partial
        body). The framing/auth skeleton is intentionally a sibling copy
        of serve's loop for now — the op BODIES differ everywhere (local
        predictor/engine vs forwarding) and serve's loop is interwoven
        with them; extracting a shared protocol-server core is the
        follow-up that should ride the next wire-protocol change."""
        try:
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
                    # the ROUTER's registry: router.* counters, per-replica
                    # outstanding gauges, plus anything else this process
                    # recorded
                    conn.sendall(struct.pack("<III", MAGIC, 0, 1))
                    send_arrays(conn, [stats_payload(
                        {"role": "router",
                         "node": metrics.node_identity()})])
                    continue
                if op == OP_PROMETHEUS:
                    conn.sendall(struct.pack("<III", MAGIC, 0, 1))
                    send_arrays(conn, [np.frombuffer(
                        metrics.to_prometheus().encode(),
                        dtype=np.uint8).copy()])
                    continue
                if op == OP_TRACE_EXPORT:
                    # the router is a trace participant too: its
                    # router.forward spans stitch into the same fleet
                    # timeline the replicas export
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
                    recv_arrays(conn, n)
                    conn.sendall(struct.pack("<III", MAGIC, 0, 1))
                    send_arrays(conn, [debug_dump_payload()])
                    continue
                if op == OP_SHUTDOWN:
                    conn.sendall(struct.pack("<III", MAGIC, 0, 0))
                    self.stop()
                    return
                if faults.ENABLED and op == OP_GENERATE \
                        and faults.fire("router.crash"):
                    # deterministic router death at request accept
                    # (testing/faults.py): the listener closes, every
                    # live client connection severs, and this request is
                    # never forwarded — clients must fail over to a
                    # surviving router (docs/ROBUSTNESS.md)
                    self.stop(hard=True)
                    return
                try:
                    arrays = recv_arrays(conn, n)
                    if op == OP_RUN:
                        raise RuntimeError(
                            "router fronts GENERATE/CANCEL/STATS/"
                            "PROMETHEUS only; RUN needs a direct replica "
                            "connection")
                    if op == OP_CANCEL:
                        outs = [self._route_cancel(arrays)]
                    elif op == OP_GENERATE:
                        outs = self._route_generate(arrays, conn=conn)
                    else:
                        raise RuntimeError(f"unknown op {op}")
                    conn.sendall(
                        struct.pack("<III", MAGIC, 0, len(outs)))
                    send_arrays(conn, outs)
                except Exception as e:  # noqa: BLE001 — wire to client
                    metrics.counter("router.errors").inc()
                    # relay replica app errors VERBATIM: the client (or a
                    # second-tier router classifying by prefix) must see
                    # exactly what a direct replica connection would send.
                    # Router-raised typed errors (Overloaded,
                    # DeadlineExceeded) format as the same one-line
                    # "<Type>: <text>" a replica would send
                    msg = str(e) if isinstance(e, _ReplicaAppError) \
                        else f"{type(e).__name__}: {e}"
                    try:
                        self._send_err(conn, msg)
                    except OSError:
                        pass    # client already gone
                    return
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            conn.close()

    @staticmethod
    def _send_err(conn, msg):
        raw = msg.encode()
        conn.sendall(struct.pack("<III", MAGIC, 1, len(raw)) + raw)


def install_sigterm_stop(router: Router):
    """SIGTERM stops the router: it deregisters its lease, closes its
    listener and `serve_forever` returns, so the CLI exits 0. The router
    holds no request state of its own; a request in flight on a severed
    connection is the client's to resubmit. Returns the installed handler
    (tests invoke it directly)."""
    def _handler(signum, frame):  # noqa: ARG001 - signal handler signature
        router.stop()
    signal.signal(signal.SIGTERM, _handler)
    return _handler


def main(argv=None):
    ap = argparse.ArgumentParser("paddle_tpu_torch.serving.router")
    ap.add_argument("--registry-dir", default=None,
                    help="shared-filesystem elastic registry to watch for "
                         "replica membership (observer mode)")
    ap.add_argument("--registry-addr", default=None,
                    help="host:port of a TcpRegistryServer to watch "
                         "(needs PADDLE_ELASTIC_TOKEN)")
    ap.add_argument("--replica", action="append", default=[],
                    metavar="ID=HOST:PORT",
                    help="static replica entry (repeatable; composes with "
                         "the registry)")
    ap.add_argument("--policy", default="round_robin",
                    choices=sorted(POLICIES))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--auth-name", default=None,
                    help="router's client-facing auth secret; default "
                         "PADDLE_SERVE_TOKEN or a random token printed "
                         "once as 'TOKEN <hex>'")
    ap.add_argument("--replica-secret", default=None,
                    help="fleet-shared replica auth secret (each "
                         "replica's --auth-name); default "
                         "PADDLE_SERVE_TOKEN")
    ap.add_argument("--poll-interval", type=float, default=1.0)
    ap.add_argument("--max-resubmits", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=None,
                    help="fleet KV page size, keys the prefix-affinity "
                         "directory's prompt hashing (default: learned "
                         "from the first engine STATS pull)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="also serve GET /metrics (Prometheus text) from "
                         "a stdlib HTTP endpoint on this port")
    ap.add_argument("--fleet-port", type=int, default=None,
                    help="serve the FLEET metrics plane on this port: "
                         "GET /metrics is every replica's registry "
                         "re-labeled {role,replica} plus fleet rollups, "
                         "GET /fleet is the JSON snapshot the autoscaler "
                         "shares (docs/OBSERVABILITY.md)")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="NAME=OBJECTIVE[;OPTS]",
                    help="declare a fleet-scope SLO evaluated over the "
                         "fleet rollup after every stats poll (needs "
                         "--fleet-port); e.g. "
                         "'ttft=serve.ttft_seconds p99 < 2.0s;fast=60;"
                         "slow=300'. Repeatable. Alerts ride GET /alerts "
                         "on the fleet port (docs/OBSERVABILITY.md)")
    ap.add_argument("--dump", default=None, metavar="REPLICA_ID",
                    help="one-shot: pull REPLICA_ID's DEBUG_DUMP (flight "
                         "ring + metrics snapshot) through the replica "
                         "auth path, print the JSON, and exit")
    ap.add_argument("--router-id", default=None,
                    help="register THIS router in the registry under the "
                         "'router' role (node id router:<id>) so clients "
                         "discover the redundant router set "
                         "(RemotePredictor registry_dir=/registry_addr=); "
                         "default: watch-only, no self-registration")
    ap.add_argument("--advertise", default=None,
                    help="endpoint to publish with --router-id (default "
                         "<host>:<bound port>)")
    args = ap.parse_args(argv)
    replicas = {}
    for spec in args.replica:
        rid, _, ep = spec.partition("=")
        if not ep:
            ap.error(f"--replica wants ID=HOST:PORT, got {spec!r}")
        replicas[rid] = ep
    registry = None
    if args.registry_dir:
        registry = NodeRegistry(args.registry_dir)
    elif args.registry_addr:
        registry = TcpNodeRegistry(args.registry_addr)
    if registry is None and not replicas:
        ap.error("need --registry-dir, --registry-addr, or --replica")
    if args.router_id is not None and registry is None:
        ap.error("--router-id needs --registry-dir or --registry-addr "
                 "(the router role is a registry lease)")
    metrics.set_node_identity(
        role="router",
        node_id=router_node_id(args.router_id) if args.router_id
        else f"router-{os.getpid()}")
    router = Router(registry=registry, replicas=replicas,
                    policy=args.policy, host=args.host, port=args.port,
                    auth_name=args.auth_name,
                    replica_secret=args.replica_secret,
                    poll_interval_s=args.poll_interval,
                    max_resubmits=args.max_resubmits,
                    page_size=args.page_size)
    if args.dump is not None:
        # one-shot debug pull: membership was folded in synchronously by
        # the constructor, so a static or already-registered replica is
        # resolvable immediately
        import json as _json
        with router._rlock:
            rep = router._replicas.get(args.dump)
        if rep is None:
            router.stop()
            raise SystemExit(
                f"--dump: unknown replica {args.dump!r}; have "
                f"{router.replica_ids()}")
        payload = router._replica_op(rep, OP_DEBUG_DUMP)
        print(_json.dumps(_json.loads(payload.tobytes().decode()),
                          indent=2, sort_keys=True))
        router.stop()
        return
    if args.router_id is not None:
        nid = router_node_id(args.router_id)
        endpoint = args.advertise or f"{args.host}:{router.port}"
        if args.registry_dir:
            lease = NodeRegistry(args.registry_dir, nid, endpoint)
        else:
            lease = TcpNodeRegistry(args.registry_addr, nid, endpoint)
        lease.register()
        router.attach_registry(lease)
        print(f"REGISTERED {nid} {endpoint}", flush=True)
    install_sigusr1_dump()
    install_sigterm_stop(router)
    print(f"LISTENING {router.port}", flush=True)
    if router.generated_secret is not None:
        print(f"TOKEN {router.generated_secret}", flush=True)
    if args.metrics_port is not None:
        from paddle_tpu_torch.observability.prometheus import (
            start_http_exporter)
        exporter = start_http_exporter(host=args.host,
                                       port=args.metrics_port)
        print(f"METRICS {exporter.server_address[1]}", flush=True)
    if args.slo and args.fleet_port is None:
        ap.error("--slo needs --fleet-port (fleet-scope SLOs window the "
                 "fleet rollup and serve alerts from the fleet port)")
    if args.fleet_port is not None:
        from paddle_tpu_torch.observability.fleet import (
            FleetMetrics, start_fleet_exporter)
        fm = FleetMetrics()
        router.attach_fleet(fm)
        slo = None
        if args.slo:
            from paddle_tpu_torch.observability.slo import (SLOEvaluator,
                                                            parse_slo)
            slo = SLOEvaluator([parse_slo(s) for s in args.slo],
                               scope="fleet")
            router.attach_slo(slo)
        fexp = start_fleet_exporter(fm, host=args.host,
                                    port=args.fleet_port, slo=slo)
        print(f"FLEET {fexp.server_address[1]}", flush=True)
    router.serve_forever()


if __name__ == "__main__":
    main()
