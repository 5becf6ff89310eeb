"""Collective hang watchdog: per-step liveness heartbeats + guarded waits
(counterpart of `paddle_tpu/distributed/liveness.py`, the same files, key
names and texts; the port's key-value client is `collective.StoreKV` over
the fleet's TCPStore, in the place of the JAX coordination client).

A dead peer is the one training failure the runtime cannot surface by
itself: every survivor of a ``kill -9`` sits inside an allreduce waiting
for a contribution that will never arrive — no exception, no timeout the
loop owns, just silence. The serving plane already refuses that shape
(every request terminates with tokens or a typed error); this
module gives the TRAINING plane the same contract:

- :class:`LivenessMonitor` — per-rank heartbeat files in a shared
  directory (the same shared-filesystem substrate the elastic
  `NodeRegistry` leases use). Each rank calls ``beat(step)`` once per
  training step — a thread-free write, so a process wedged inside a
  collective stops beating by construction (a daemon-thread heartbeat
  would keep renewing through the hang and defeat the whole point).
  ``check()`` raises a typed :class:`PeerLost` naming every silent rank
  once its heartbeat age passes the deadline, after dumping the
  flight-recorder ring + the stalled-step context to a JSON post-mortem
  (`observability/flight_recorder.py`).
- :func:`guarded_get_bytes` — the key-value store's blocking read,
  sliced into short waits with a ``check()`` between slices: the
  would-be-infinite collective wait converts into ``PeerLost`` on every
  survivor within a bounded window. With no monitor installed the wait
  degrades to the plain single blocking call — zero behavior change for
  single-host runs.
- :func:`kv_barrier` — an arrival barrier over sequenced KV keys (the
  substrate `distributed/collective.py` uses),
  built on the guarded read so a barrier over a dead fleet also resolves
  typed. `CheckpointManager` uses it to order per-rank shard writes
  before the COMPLETE/LATEST publication (docs/ROBUSTNESS.md
  "Multi-host training").

Metrics: ``train.heartbeats``, ``train.peer_lost`` (docs/OBSERVABILITY.md).
Chaos: ``train.collective_stall`` (a rank stalls inside the collective —
armed via `testing/faults.py` at the allgather site), ``train.peer_dead``
(a rank SIGKILLs itself at a step boundary — `train/elastic.py`).
"""
from __future__ import annotations

import json
import os
import threading
import time

from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import dump_ring, flight

__all__ = ["PeerLost", "LivenessMonitor", "install", "uninstall", "current",
           "guarded_get_bytes", "kv_barrier", "kv_barrier_cleanup",
           "is_timeout"]


class PeerLost(RuntimeError):
    """A training peer went silent past the liveness deadline while the
    fleet was inside (or headed into) a collective. The raiser has
    already dumped the flight ring; its job now is to exit nonzero so
    the elastic controller can reform the mesh at the surviving world
    size and resume from the last fleet-complete checkpoint — iterating
    on a dead fleet cannot succeed (docs/ROBUSTNESS.md)."""


# poll period between presence checks; short enough that deadline ->
# typed-error latency is dominated by the deadline itself, long enough
# that a healthy wait costs a handful of RPCs
_POLL_S = 0.2

# marker namespace: every guarded payload key K gets an ASCII sidecar
# ``ptpu_mk/<K>`` set AFTER the payload. Guarded waiters poll the marker's
# parent DIRECTORY via key_value_dir_get (string-valued listing — safe over
# this namespace by construction) and only issue the blocking read once the
# marker is present, so the read returns immediately. The JAX package's
# client crashes when blocking gets EXPIRE under cross-process concurrency,
# and its dir_get chokes on binary values; the port keeps the protocol so
# the two packages' key traces read alike: no blocking get ever expires,
# no binary value is ever listed.
_MARK = "ptpu_mk/"


class LivenessMonitor:
    """Per-step heartbeat board for one training fleet.

    dir        : shared directory holding ``hb-<rank>.json`` files (the
                 checkpoint root's filesystem — every rank mounts it)
    rank, world: this process's coordinates
    deadline_s : a peer whose newest beat is older than this is LOST
    grace_s    : a peer with NO heartbeat file yet is only lost after
                 this window from monitor construction (fresh processes
                 need import/compile time before their first beat)
    """

    def __init__(self, dir, rank, world, *, deadline_s=30.0, grace_s=None):
        self.dir = str(dir)
        self.rank = int(rank)
        self.world = int(world)
        self.deadline_s = float(deadline_s)
        self.grace_s = float(grace_s) if grace_s is not None \
            else max(120.0, 4 * self.deadline_s)
        self._born = time.time()
        self.last_step = -1
        os.makedirs(self.dir, exist_ok=True)
        self._g_beats = metrics.counter("train.heartbeats")

    def _path(self, rank):
        return os.path.join(self.dir, f"hb-{rank}.json")

    def beat(self, step):
        """Record this rank's liveness at a step boundary (atomic write —
        a reader never sees a torn file)."""
        self.last_step = int(step)
        tmp = self._path(self.rank) + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "step": int(step),
                       "t": time.time()}, f)
        os.replace(tmp, self._path(self.rank))
        self._g_beats.inc()

    def rebeat(self):
        """Renew the heartbeat WITHOUT claiming progress (same step).
        Guarded waits call this each poll: a rank alive-but-waiting on a
        dead peer must not itself read as dead to the OTHER survivors —
        liveness is "process responsive", the flight watchdog owns
        "progress stalled"."""
        self.beat(self.last_step)

    def peers(self):
        """{rank: {"step", "t", "age_s"}} for every OTHER rank with a
        readable heartbeat file NEWER than this monitor's birth — a beat
        from before we existed is a stale file from a previous fleet
        incarnation, not a peer that died on us: it reads as ABSENT (the
        startup grace window governs it), so a reused heartbeat dir can
        never insta-kill a relaunched fleet."""
        now = time.time()
        out = {}
        for r in range(self.world):
            if r == self.rank:
                continue
            try:
                with open(self._path(r)) as f:
                    info = json.load(f)
                if float(info.get("t", 0.0)) < self._born:
                    continue           # pre-birth: a previous incarnation
                out[r] = {"step": info.get("step"), "t": info.get("t"),
                          "age_s": now - float(info.get("t", 0.0))}
            except (OSError, ValueError):
                continue
        return out

    def silent_peers(self):
        """Ranks whose heartbeat is stale past the deadline (or absent
        past the startup grace window)."""
        peers = self.peers()
        silent = []
        now = time.time()
        for r in range(self.world):
            if r == self.rank:
                continue
            info = peers.get(r)
            if info is None:
                if now - self._born > self.grace_s:
                    silent.append(r)
                continue
            if info["age_s"] > self.deadline_s:
                silent.append(r)
        return silent

    # ------------------------------------------------------- lost cascade
    #
    # The FIRST detector writes a ``lost-<rank>.json`` tombstone before it
    # raises; every other survivor's next check sees it and raises typed
    # WITHOUT waiting out its own deadline. Fast propagation is load-
    # bearing, not a nicety: the key-value store lives in rank 0's
    # process, and every survivor's store calls fail once it drops — so
    # survivors must all reach their typed exit within a beat of each
    # other, and the leader lingers (`wait_for_cascade`) until the fleet
    # has acknowledged.

    def mark_lost(self, silent):
        """Publish this rank's PeerLost verdict as a tombstone file."""
        tmp = os.path.join(self.dir,
                           f"lost-{self.rank}.json.tmp{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "silent": list(silent),
                       "step": self.last_step, "t": time.time()}, f)
        os.replace(tmp, os.path.join(self.dir, f"lost-{self.rank}.json"))

    def lost_peers(self):
        """Ranks (other than self) that published a PeerLost tombstone
        SINCE this monitor was born — like stale heartbeats, a previous
        incarnation's tombstones must not cascade into a relaunched
        fleet."""
        out = []
        for r in range(self.world):
            if r == self.rank:
                continue
            try:
                with open(os.path.join(self.dir, f"lost-{r}.json")) as f:
                    info = json.load(f)
            except (OSError, ValueError):
                continue
            if float(info.get("t", 0.0)) >= self._born:
                out.append(r)
        return out

    def wait_for_cascade(self, cap_s=None):
        """Block until every OTHER rank is accounted for — silent (dead)
        or tombstoned (exited typed) — capped at ``cap_s`` (default the
        deadline + slack). The fleet leader calls this before its own
        exit so laggard survivors are not hard-killed mid-detection by
        the key-value store's teardown."""
        cap = time.time() + (cap_s if cap_s is not None
                             else self.deadline_s + 3.0)
        rest = set(range(self.world)) - {self.rank}
        while time.time() < cap:
            if rest <= set(self.silent_peers()) | set(self.lost_peers()):
                return True
            time.sleep(0.1)
        return False

    def check(self, context=""):
        """Raise typed :class:`PeerLost` if any peer is silent past the
        deadline (or has published a PeerLost tombstone) — after writing
        this rank's own tombstone and dumping the flight ring + the
        stalled-step context (the post-mortem a hang never writes for
        itself)."""
        silent = self.silent_peers()
        cascade = self.lost_peers()
        if not silent and not cascade:
            return
        peers = self.peers()
        detail = {r: ({"step": peers[r]["step"],
                       "age_s": round(peers[r]["age_s"], 1)}
                      if r in peers else "no heartbeat") for r in silent}
        try:
            self.mark_lost(silent or cascade)
        except OSError:
            pass
        metrics.counter("train.peer_lost").inc()
        flight.record("train.peer_lost", rank=self.rank,
                      silent=list(silent), cascade=list(cascade),
                      at_step=self.last_step, context=str(context)[:120])
        path = None
        try:
            path = dump_ring(
                f"peer_lost_rank{self.rank}",
                stalled_step=self.last_step, silent_peers=detail,
                cascade_from=list(cascade),
                deadline_s=self.deadline_s, context=str(context)[:200])
        except OSError:
            pass                   # an unwritable dump dir must not mask
        via = (f"peer(s) {silent} silent past {self.deadline_s}s"
               if silent else f"peer(s) {cascade} reported PeerLost")
        raise PeerLost(
            f"rank {self.rank}: {via} at step {self.last_step}"
            f"{' in ' + context if context else ''} — last heartbeats "
            f"{detail}" + (f" (flight ring dumped to {path})" if path
                           else ""))


# ---------------------------------------------------------- installed hook
#
# collective.py's KV transport consults the installed monitor between wait
# slices; install/uninstall from the elastic worker loop. A lock guards the
# slot itself, not the monitor (beats/checks are single-threaded per rank).

_lock = threading.Lock()
_monitor: LivenessMonitor | None = None


def install(monitor: LivenessMonitor):
    global _monitor
    with _lock:
        _monitor = monitor
    return monitor


def uninstall():
    global _monitor
    with _lock:
        _monitor = None


def current() -> LivenessMonitor | None:
    return _monitor


def is_timeout(exc) -> bool:
    """True for a key-value deadline expiry (`collective.StoreKV` raises
    TimeoutError with the coordination service's ``DEADLINE_EXCEEDED``
    text — the string is the only contract) or this module's own
    TimeoutError."""
    s = str(exc)
    return "DEADLINE_EXCEEDED" in s or "timed out" in s.lower()


def set_with_marker(client, key, value):
    """Publish ``key`` then its readiness marker — the setter half of the
    guarded-read protocol. Guarded waiters poll the marker; plain waiters
    (no monitor) ignore it. Marker-after-payload ordering is the whole
    contract: the set RPCs are synchronous, so a visible marker implies a
    readable payload."""
    client.key_value_set_bytes(key, value)
    client.key_value_set_bytes(_MARK + key, b"1")


def clear_with_marker(client, key):
    """Best-effort delete of a payload and its marker."""
    for k in (key, _MARK + key):
        try:
            client.key_value_delete(k)
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            pass


def _marker_present(client, key) -> bool:
    marker = _MARK + key
    prefix = marker.rsplit("/", 1)[0] + "/"
    try:
        names = {k for k, _ in client.key_value_dir_get(prefix)}
    except Exception:  # noqa: BLE001 — transient listing failure: not there
        return False
    return marker in names


def guarded_get_bytes(client, key, timeout_ms, *, monitor=None, what=""):
    """``blocking_key_value_get_bytes`` with the liveness guard.

    No monitor (installed or passed): one plain blocking call — byte-for-
    byte the pre-guard behavior. With a monitor: poll the key's readiness
    MARKER (see module docstring) with a ``check()`` between polls, so a
    read whose WRITER died resolves as typed ``PeerLost`` within
    ~deadline; only once the marker is present does the blocking read
    run — and then it returns immediately. The writer must publish via
    :func:`set_with_marker`."""
    m = monitor if monitor is not None else current()
    if m is None:
        return client.blocking_key_value_get_bytes(key, int(timeout_ms))
    deadline = time.monotonic() + timeout_ms / 1e3
    while True:
        if _marker_present(client, key):
            return client.blocking_key_value_get_bytes(key, 30_000)
        m.rebeat()
        m.check(context=what or key)
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"KV read {key!r} timed out after {timeout_ms}ms with all "
                "peers still heartbeating")
        time.sleep(_POLL_S)


def kv_barrier(client, tag, *, rank, world, timeout_ms, monitor=None):
    """Arrival barrier over the fleet's key-value store.

    Every rank publishes ``ptpu_bar/<tag>/<rank>`` then POLLS the tag's
    directory listing until all ``world`` arrival keys are present:
    returns once the fleet arrived, raises typed ``PeerLost`` (via the
    monitor, when one is installed/passed) when a peer never does, plain
    TimeoutError otherwise. Pure polling — unlike the service's one-shot
    ``wait_at_barrier`` it composes with the liveness guard and never
    issues an expiring blocking read (see module docstring). Tags must be
    UNIQUE per rendezvous (keys are write-once); cleanup is deliberately
    deferred — a rank that passed barrier N may still be listing when
    another rank moves on, so only a LATER rendezvous proves everyone is
    past this one. Call :func:`kv_barrier_cleanup` with a tag from a
    previous, fully superseded rendezvous (`CheckpointManager` cleans
    save N-1's tags after save N's first barrier)."""
    world = int(world)
    if world <= 1:
        return
    m = monitor if monitor is not None else current()
    prefix = f"ptpu_bar/{tag}/"
    client.key_value_set_bytes(prefix + str(int(rank)), b"1")
    expected = {prefix + str(r) for r in range(world)}
    deadline = time.monotonic() + timeout_ms / 1e3
    while True:
        try:
            names = {k for k, _ in client.key_value_dir_get(prefix)}
        except Exception:  # noqa: BLE001 — transient listing failure
            names = set()
        if expected <= names:
            return
        if m is not None:
            m.rebeat()
            m.check(context=f"barrier {tag}")
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"barrier {tag!r} timed out after {timeout_ms}ms: "
                f"{sorted(expected - names)} never arrived")
        time.sleep(_POLL_S)


def kv_barrier_cleanup(client, tag):
    """Best-effort prefix delete of a SUPERSEDED barrier's keys (see
    :func:`kv_barrier` for when that is safe)."""
    try:
        client.key_value_delete(f"ptpu_bar/{tag}/")
    except Exception:  # noqa: BLE001 — cleanup is best-effort
        pass
