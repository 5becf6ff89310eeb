"""Elastic autoscaling controller of the port (counterpart of
`paddle_tpu/serving/autoscale.py`; the port imports nothing from it): it
closes the loop the router leaves open. The router sees load and the
registry sees membership; this controller watches per-replica STATS plus
the router's own outstanding view and acts between ``min_replicas`` and
``max_replicas``:

- **Scale UP** when sustained pressure shows up — router outstanding per
  replica past ``up_outstanding_per_replica``, an engine queue past
  ``up_queue_depth``, a shed counter moving, or the degradation ladder at
  level >= 2 — by asking the pluggable LAUNCHER to spawn a replica and
  folding it into the router's rotation (`Router.add_static_replica`).
- **Scale DOWN** when the fleet is sustained-idle, by removing a
  launcher-owned replica from rotation FIRST and then draining it WITH
  LIVE MIGRATION (`InferenceServer.drain(migrate_peers=...)`): its
  in-flight requests export mid-decode as KV handoffs, resume
  token-identically on the surviving replicas, and the blocked clients see
  normal answers — scale-down costs zero client-visible errors
  (docs/SERVING.md "Live migration").

Flapping control is explicit: a decision needs ``hysteresis_ticks``
CONSECUTIVE agreeing observations, and each direction has its own
cooldown (``up_cooldown_s`` / ``down_cooldown_s``) measured from the last
action in EITHER direction — a spike can never bounce the fleet
up-down-up inside one cooldown window.

The launcher is deliberately pluggable (`CallbackLauncher`): tests and
`chip_smoke.py` spawn in-process `InferenceServer` replicas; a deployment
launcher starts pods/VMs that self-register in the elastic registry. The
controller never touches device state: it only talks wire ops and
router membership, as the router itself does.

Observability (docs/OBSERVABILITY.md): ``autoscaler.ticks``,
``autoscaler.scale_ups``, ``autoscaler.scale_downs``,
``autoscaler.errors`` counters; ``autoscaler.replicas`` and
``autoscaler.pressure`` (outstanding per healthy replica) gauges; one
flight-recorder event per decision.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass

from paddle_tpu_torch.inference.serve import RemotePredictor, auth_token
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import flight

__all__ = ["AutoscalePolicy", "Autoscaler", "CallbackLauncher"]


@dataclass
class AutoscalePolicy:
    """Thresholds + flap control for one `Autoscaler` (docs/SERVING.md
    "Autoscaling").

    min_replicas / max_replicas : the fleet-size clamp the controller acts
                   inside; scale-down never drops below min even when idle
    up_outstanding_per_replica : router-tracked in-flight requests per
                   healthy replica at/over which the fleet is under-sized
    up_queue_depth : any replica's engine queue depth at/over which the
                   fleet is under-sized (queues mean decode can't keep up)
    down_outstanding_per_replica : per-replica outstanding at/under which
                   the fleet counts as idle (with zero queue, zero shed
                   movement and a quiet degradation ladder)
    hysteresis_ticks : CONSECUTIVE agreeing observations a decision needs
                   — one noisy poll can never resize the fleet
    up_cooldown_s / down_cooldown_s : minimum wall-clock since the last
                   scaling action (either direction) before acting again;
                   down is deliberately slower than up — adding capacity
                   late sheds traffic, removing it late only costs chips
    reap_open_ticks : consecutive ticks a LAUNCHER-OWNED replica's
                   breaker must stay open before the controller reaps it
                   (removes it from rotation and has the launcher kill
                   it) — a spawned replica that crashed on its own would
                   otherwise wedge the fleet: never drained (scale-down
                   picks healthy victims) yet counted against
                   ``max_replicas`` forever. Generous by default so a
                   transient probe blip never kills live capacity
    """
    min_replicas: int = 1
    max_replicas: int = 4
    up_outstanding_per_replica: float = 4.0
    up_queue_depth: float = 4.0
    down_outstanding_per_replica: float = 0.5
    hysteresis_ticks: int = 2
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 15.0
    reap_open_ticks: int = 10


class CallbackLauncher:
    """Pluggable replica lifecycle for the autoscaler.

    ``spawn_fn()`` -> ``(replica_id, "host:port")`` starts a replica and
    returns its rotation entry; ``drain_fn(replica_id, endpoint,
    peer_endpoints)`` -> bool drains it WITH live migration (the in-process
    flavor calls ``server.drain(migrate_peers=peer_endpoints)``; a
    deployment flavor SIGTERMs a pod started with ``--migrate-on-drain``)
    and reports whether the drain was clean."""

    def __init__(self, spawn_fn, drain_fn):
        self._spawn_fn = spawn_fn
        self._drain_fn = drain_fn

    def spawn(self):
        return self._spawn_fn()

    def drain(self, replica_id, endpoint, peer_endpoints):
        return self._drain_fn(replica_id, endpoint, peer_endpoints)


class Autoscaler:
    """Fleet-size controller over the router tier + one launcher.

    >>> scaler = Autoscaler(router, launcher, AutoscalePolicy(
    ...     max_replicas=3, hysteresis_ticks=1))
    >>> scaler.start()        # or call scaler.tick() from your own loop
    ...
    >>> scaler.stop()

    ``router`` is one `Router` or a LIST of redundant routers
    (docs/ROBUSTNESS.md "Control-plane HA"): observations read from the
    first (all routers converge on the same registry-driven view), while
    membership mutations — spawn joins, scale-down removals, crash reaps
    — fan out to EVERY router, so a launcher-owned static replica exists
    in each rotation and a drain victim stops receiving traffic from the
    whole control plane, not just one front door. Registry-registered
    replicas need no fan-out (every router polls the registry itself).

    ``stats_fn(endpoint) -> dict | None`` overrides the per-replica STATS
    pull (the default opens one authed STATS exchange per healthy replica
    per tick using ``replica_secret``); tests inject deterministic
    snapshots. ``fleet`` is the higher-level form of the same injection:
    pass the `observability.fleet.FleetMetrics` the router's poll loop
    already feeds (`Router.attach_fleet`) and the controller reads its
    `snapshot_for` view instead of opening its own per-replica STATS
    connections — one scrape loop serves routing, the /metrics rollup AND
    scaling, with identical decisions (the snapshot schema is exactly a
    direct STATS pull's; a member the plane has not scraped yet reads as
    a failed pull, which the tick already tolerates). `tick()` is
    synchronous and returns the action taken (``"up"``/``"down"``/None)
    so chaos tests drive decisions without a timing-dependent thread."""

    def __init__(self, router, launcher, policy: AutoscalePolicy | None
                 = None, interval_s: float = 1.0, replica_secret=None,
                 stats_fn=None, fleet=None):
        self._routers = list(router) if isinstance(router, (list, tuple)) \
            else [router]
        if not self._routers:
            raise ValueError("need >= 1 router")
        self._router = self._routers[0]    # the observation view
        self._launcher = launcher
        self.policy = policy or AutoscalePolicy()
        self._interval = float(interval_s)
        if stats_fn is not None and fleet is not None:
            raise ValueError("pass stats_fn OR fleet, not both")
        if fleet is not None:
            stats_fn = fleet.snapshot_for
        self._stats_fn = stats_fn if stats_fn is not None \
            else self._pull_stats
        self._replica_token = auth_token(
            None if replica_secret is None else str(replica_secret))
        self._owned: dict[str, str] = {}   # spawned replica id -> endpoint
        # owned replicas removed from rotation whose drain FAILED: retried
        # every tick until the launcher succeeds — a replica the operator
        # pays for must never fall out of tracking (rid -> endpoint)
        self._pending_drain: dict[str, str] = {}
        # consecutive ticks each owned replica's breaker has been OPEN
        # (crash detection — see AutoscalePolicy.reap_open_ticks)
        self._open_streak: dict[str, int] = {}
        self._spawn_seq = 0
        self._up_votes = 0
        self._down_votes = 0
        self._last_action_t = float("-inf")
        # per-replica last-seen shed counters: a single fleet total would
        # corrupt the baseline whenever one replica's STATS pull failed
        # transiently (its counter vanishes from the sum, then reappears
        # as a phantom delta) — deltas are computed replica-by-replica
        # and a replica's first observation contributes zero
        self._last_shed: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._m_ticks = metrics.counter("autoscaler.ticks")
        self._m_ups = metrics.counter("autoscaler.scale_ups")
        self._m_downs = metrics.counter("autoscaler.scale_downs")
        self._m_errors = metrics.counter("autoscaler.errors")
        self._g_replicas = metrics.gauge("autoscaler.replicas")
        self._g_pressure = metrics.gauge("autoscaler.pressure")
        self._g_pending = metrics.gauge("autoscaler.pending_drains")

    # ----------------------------------------------------------- observing

    def _pull_stats(self, endpoint: str) -> dict | None:
        """One authed STATS exchange at probe-grade timeouts (single
        connect attempt, short deadline) through the wire client —
        the STATS framing lives in ONE module; None on any failure — a
        dead replica's stats must age out of the decision, not stall
        the control loop."""
        try:
            host, port = endpoint.rsplit(":", 1)
            cli = RemotePredictor(host, int(port), timeout=4.0,
                                  token=self._replica_token,
                                  connect_retries=1, retry_deadline_s=2.0)
        except (OSError, ConnectionError, ValueError):
            return None
        try:
            return cli.stats()
        except (OSError, ConnectionError, ValueError, struct.error,
                socket.timeout):
            return None
        finally:
            cli.close()

    def observe(self) -> dict:
        """One fleet observation: the router's outstanding view plus each
        healthy replica's engine-side pressure gauges. ``n`` counts the
        HEALTHY (breaker-closed) replicas — the capacity actually serving
        — while ``n_total`` counts every rotation entry PLUS any
        pending-drain replicas: the size clamps bound what the operator
        PAYS for, so neither a transiently-open breaker nor a
        not-yet-confirmed drain may let the controller spawn past
        ``max_replicas``."""
        full = self._router.replica_view()
        view = [r for r in full if r["breaker"] == "closed"]
        outstanding = sum(r["outstanding"] for r in view)
        queue_depth = 0.0
        degradation = 0.0
        shed_delta = 0.0
        in_view = set()
        # the pulls are independent blocking wire exchanges: fan them out
        # so one dead-but-breaker-closed replica (probe hasn't hit its
        # threshold yet) stalls the tick by ONE probe budget, not one per
        # corpse — a scale-up decision delayed is exactly the overload
        # the controller exists to prevent
        snaps: dict[str, dict | None] = {}
        if len(view) > 1:
            def _pull(rid, ep):
                snaps[rid] = self._stats_fn(ep)
            ths = [threading.Thread(target=_pull, daemon=True,
                                    args=(r["replica_id"], r["endpoint"]),
                                    name="pt-autoscale-stats")
                   for r in view]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=10.0)
        elif view:
            r = view[0]
            snaps[r["replica_id"]] = self._stats_fn(r["endpoint"])
        for r in view:
            in_view.add(r["replica_id"])
            snap = snaps.get(r["replica_id"])
            if not snap:
                continue            # failed pull: baseline left untouched
            g = snap.get("gauges", {})
            c = snap.get("counters", {})
            queue_depth = max(queue_depth,
                              float(g.get("engine.queue_depth") or 0))
            degradation = max(degradation,
                              float(g.get("engine.degradation_level") or 0))
            cur = float(c.get("engine.shed", 0))
            prev = self._last_shed.get(r["replica_id"], cur)
            shed_delta += max(0.0, cur - prev)
            self._last_shed[r["replica_id"]] = cur
        for rid in [k for k in self._last_shed if k not in in_view]:
            del self._last_shed[rid]    # departed replicas age out
        # pending-drain replicas left rotation but the launcher has not
        # confirmed them gone: still paid-for capacity, so they count
        # toward the total the UP clamp bounds — same rationale as
        # breaker-open entries (decide() docstring)
        return {"n": len(view),
                "n_total": len(full) + len(self._pending_drain),
                "outstanding": outstanding, "queue_depth": queue_depth,
                "degradation": degradation, "shed_delta": shed_delta}

    # ------------------------------------------------------------ deciding

    def decide(self, sig: dict) -> str | None:
        """Hysteresis + cooldown gate over one observation; returns
        ``"up"``/``"down"``/None. Pure bookkeeping — no IO — so chaos
        tests feed synthetic signals and assert the exact transitions."""
        p = self.policy
        n = max(1, int(sig["n"]))
        # the UP clamp bounds the TOTAL fleet — every rotation entry,
        # breaker-open ones included (an open breaker is a replica the
        # operator still pays for; spawning "around" it would exceed
        # max_replicas the moment the probe re-closes it). The DOWN clamp
        # stays on the HEALTHY count: draining the last healthy replica
        # because a broken one pads the total would be an outage — and
        # healthy > min implies total > min, so the cost floor holds too.
        # Pressure per replica likewise divides by the healthy count: the
        # capacity actually absorbing the load.
        n_total = int(sig.get("n_total", sig["n"]))
        per = sig["outstanding"] / n
        pressured = (per >= p.up_outstanding_per_replica
                     or sig["queue_depth"] >= p.up_queue_depth
                     or sig["shed_delta"] > 0
                     or sig["degradation"] >= 2)
        idle = (per <= p.down_outstanding_per_replica
                and sig["queue_depth"] == 0 and sig["shed_delta"] == 0
                and sig["degradation"] == 0)
        self._up_votes = self._up_votes + 1 if pressured else 0
        self._down_votes = self._down_votes + 1 if idle else 0
        now = time.monotonic()
        if pressured and n_total < p.max_replicas \
                and self._up_votes >= p.hysteresis_ticks \
                and now - self._last_action_t >= p.up_cooldown_s:
            return "up"
        if idle and sig["n"] > p.min_replicas \
                and self._down_votes >= p.hysteresis_ticks \
                and now - self._last_action_t >= p.down_cooldown_s:
            return "down"
        return None

    # -------------------------------------------------------------- acting

    def scale_up(self) -> str | None:
        """Spawn one replica through the launcher and put it in rotation.
        Returns the new replica id (None if the launcher declined or the
        fleet is already at ``max_replicas`` — this is public API, so the
        spend clamp holds here too, counting every rotation entry plus
        pending drains exactly like decide()'s ``n_total``)."""
        if len(self._router.replica_view()) + len(self._pending_drain) \
                >= self.policy.max_replicas:
            return None
        spawned = self._launcher.spawn()
        if spawned is None:
            return None
        rid, endpoint = spawned
        rid, endpoint = str(rid), str(endpoint)
        self._owned[rid] = endpoint
        for router in self._routers:
            router.add_static_replica(rid, endpoint)
        self._last_action_t = time.monotonic()
        self._up_votes = self._down_votes = 0
        self._m_ups.inc()
        flight.record("autoscaler.scale_up", replica=rid,
                      endpoint=endpoint)
        return rid

    def scale_down(self) -> str | None:
        """Retire one LAUNCHER-OWNED replica: out of rotation first (no
        new traffic lands on it mid-drain), then drain WITH live
        migration to the surviving replicas. Only owned replicas are
        candidates — the controller never kills capacity it didn't
        create (the seed fleet is the operator's). Returns the retired
        replica id (None when nothing was eligible). A drain the
        launcher FAILS (raised — e.g. a pod-delete API timeout) counts
        ``autoscaler.errors``, not ``scale_downs``, and parks the
        replica for retry every tick: it is already out of rotation, but
        the operator keeps paying for it until the launcher confirms it
        is gone."""
        view = self._router.replica_view()
        healthy = [r for r in view if r["breaker"] == "closed"]
        owned = [r for r in healthy if r["replica_id"] in self._owned]
        # the guard counts HEALTHY replicas, mirroring decide()'s down
        # clamp: a breaker-open corpse padding the rotation must never
        # argue for draining the last replica actually serving (this is
        # public API — callers may bypass decide())
        if not owned or len(healthy) <= self.policy.min_replicas:
            return None
        victim = min(owned, key=lambda r: (r["outstanding"],
                                           r["replica_id"]))
        rid = victim["replica_id"]
        for router in self._routers:
            router.remove_static_replica(rid)
        self._last_action_t = time.monotonic()
        self._up_votes = self._down_votes = 0
        self._drain_owned(rid)
        return rid

    def _drain_owned(self, rid: str) -> bool:
        """One launcher drain attempt for an owned, out-of-rotation
        replica; the surviving breaker-closed rotation is the migration
        peer set. Success (clean or not) releases ownership and counts
        the scale-down; a raise parks the replica in the retry set."""
        endpoint = self._owned[rid]
        # decode-capable peers only: a prefill-tier worker refuses
        # OP_MIGRATE typed (it must never decode — docs/SERVING.md
        # "Disaggregated serving"), so offering one just burns a
        # fallback attempt at the worst moment
        peers = [r["endpoint"] for r in self._router.replica_view()
                 if r["replica_id"] != rid and r["breaker"] == "closed"
                 and r.get("role", "both") != "prefill"]
        try:
            clean = self._launcher.drain(rid, endpoint, peers)
        except Exception:  # noqa: BLE001 — launcher failure must not leak
            self._pending_drain[rid] = endpoint
            self._m_errors.inc()
            flight.record("autoscaler.drain_failed", replica=rid,
                          peers=len(peers))
            return False
        self._owned.pop(rid, None)
        self._pending_drain.pop(rid, None)
        self._m_downs.inc()
        flight.record("autoscaler.scale_down", replica=rid,
                      peers=len(peers), clean=bool(clean))
        return True

    def _reap_crashed(self):
        """Detect and retire OWNED replicas that died on their own: a
        spawned replica whose breaker stays open ``reap_open_ticks``
        consecutive ticks is removed from rotation and handed to the
        launcher to kill — without this, a crashed spawn is never a
        scale-down victim (those are picked healthy) yet counts against
        ``max_replicas`` forever, wedging the fleet below capacity. The
        streak resets the moment the breaker leaves ``open`` (half-open
        probing or a re-close must never lose live capacity)."""
        seen = set()
        for r in self._router.replica_view():
            rid = r["replica_id"]
            if rid not in self._owned:
                continue
            seen.add(rid)
            if r["breaker"] != "open":
                self._open_streak.pop(rid, None)
                continue
            streak = self._open_streak.get(rid, 0) + 1
            self._open_streak[rid] = streak
            if streak >= max(1, int(self.policy.reap_open_ticks)):
                self._open_streak.pop(rid, None)
                for router in self._routers:
                    router.remove_static_replica(rid)
                metrics.counter("autoscaler.reaped").inc()
                flight.record("autoscaler.reap", replica=rid,
                              endpoint=self._owned[rid])
                self._drain_owned(rid)  # launcher confirms the kill;
                #                         a raise parks it for retry
        for rid in [k for k in self._open_streak if k not in seen]:
            del self._open_streak[rid]

    def tick(self) -> str | None:
        """One observe -> decide -> act cycle. Synchronous; the loop
        thread calls this, and tests call it directly. Failed drains
        retry FIRST — an orphaned replica is pure cost — then crashed
        spawns are reaped (`_reap_crashed`)."""
        self._m_ticks.inc()
        for rid in list(self._pending_drain):
            self._drain_owned(rid)
        self._reap_crashed()
        self._g_pending.set(len(self._pending_drain))
        sig = self.observe()
        self._g_replicas.set(sig["n"])
        self._g_pressure.set(sig["outstanding"] / max(1, sig["n"]))
        action = self.decide(sig)
        if action == "up":
            return "up" if self.scale_up() is not None else None
        if action == "down":
            return "down" if self.scale_down() is not None else None
        return None

    # ----------------------------------------------------------- lifecycle

    def start(self):
        """Run `tick()` every ``interval_s`` on a daemon thread. The loop
        survives any tick exception (``autoscaler.errors``) — a flaky
        STATS pull or a failed spawn must not end autoscaling forever."""
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pt-autoscaler")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — control loop must survive
                self._m_errors.inc()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 5.0)
            self._thread = None

    def next_replica_id(self, prefix: str = "as") -> str:
        """Convenience for launchers: monotonically unique replica ids
        (``as-1``, ``as-2``, ...) that never collide with a registry
        lease."""
        self._spawn_seq += 1
        return f"{prefix}-{self._spawn_seq}"
