"""The node registries of the serving fleet (counterpart of the registry
half of `paddle_tpu/distributed/fleet/elastic.py`; the port imports nothing
from it): role-prefixed lease ids (`role_node_id`, `node_role`), the
shared-directory `NodeRegistry` (``node_<id>.json`` files) and the TCP
`TcpRegistryServer` / `TcpNodeRegistry` pair (newline-delimited JSON after
a 32-byte sha256 hello of ``PADDLE_ELASTIC_TOKEN``). The files and the
lines are the JAX package's, so JAX and port processes share one registry.
`inference/serve.py` registers replicas here and discovers migration
peers and routers; the elastic trainer (`train/elastic.py`) holds a
``trainer``-role lease.

Training's half: ``start_heartbeat(path)`` (a worker's file heartbeat,
started by `parallel.init_parallel_env` when ``PADDLE_HEARTBEAT_FILE`` is
set), `ElasticJobManager` (np-range membership decisions over a registry)
and `ElasticManager` (the controller's stale-heartbeat watcher).
"""
from __future__ import annotations

import os
import re
import threading
import time


def _check_registry_member(node_id, endpoint):
    """Shared observer-mode guard for both registry backends: a registry
    constructed without node_id/endpoint only watches membership."""
    if node_id is None or endpoint is None:
        raise RuntimeError(
            "observer-mode registry (no node_id/endpoint) cannot "
            "register or leave — it only watches membership")


# ------------------------------------------------------------ node roles
#
# Control-plane HA + disaggregated serving (docs/ROBUSTNESS.md
# "Control-plane HA", docs/SERVING.md "Disaggregated serving"): routers
# AND tiered replicas are registry citizens under distinct roles so
# nobody mistakes one for a plain engine replica. The role rides the
# node ID as a ``<role>:`` prefix — the registry value format (endpoint
# string) stays untouched, so every existing lease keeps working: an
# UNPREFIXED id IS a replica (legacy, test-pinned). One parser serves
# every role: ``router:<id>`` (control plane, never in any replica
# rotation), ``prefill:<id>`` / ``decode:<id>`` (the disaggregated
# serving tiers), and any future role a subsystem mints via
# `role_node_id` — `node_role` returns the prefix verbatim.

ROUTER_ROLE_PREFIX = "router:"

# a role token is a short lowercase word; anything else before a ":" is
# part of a legacy replica id (e.g. an id that embeds an endpoint), not
# a role — the conservative parse keeps every pre-role lease a replica
_ROLE_RE = re.compile(r"^[a-z][a-z0-9_-]{0,31}$")


def role_node_id(role, node_id) -> str:
    """Registry node id for a ``role`` lease: ``<role>:<id>``. The role
    must be a valid role token (lowercase word) — a typo'd role would
    otherwise silently parse back as a legacy replica."""
    role = str(role)
    if not _ROLE_RE.match(role):
        raise ValueError(f"invalid role token {role!r} "
                         f"(want a short lowercase word)")
    return f"{role}:{node_id}"


def router_node_id(router_id) -> str:
    """Registry node id for a router lease: ``router:<id>``."""
    return role_node_id("router", router_id)


def node_role(node_id) -> str:
    """The ``<role>:``-prefixed lease's role (``"router"``,
    ``"prefill"``, ``"decode"``, ...); ``"replica"`` for everything else
    — including every pre-role lease and any id whose colon prefix is
    not a role token (legacy ids are replicas, test-pinned)."""
    s = str(node_id)
    head, sep, _rest = s.partition(":")
    if sep and _ROLE_RE.match(head):
        return head
    return "replica"


def start_heartbeat(path, interval=2.0):
    """Touch `path` every `interval` seconds from a daemon thread."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat():
        while True:
            try:
                with open(path, "w") as f:
                    f.write(str(time.time()))
            except OSError:
                pass
            time.sleep(interval)

    t = threading.Thread(target=beat, daemon=True, name="paddle-heartbeat")
    t.start()
    return t


class NodeRegistry:
    """Multi-node membership registry (ref the etcd node registry,
    `fleet/elastic/manager.py:126,240-257`): every HOST publishes
    ``node_<id>.json`` {endpoint, ts} under a shared directory and renews it
    on a lease-like heartbeat; peers observe join/leave by polling mtime
    freshness. A shared filesystem (an NFS or object-store mount every host has)
    replaces etcd — the semantics map 1:1 (register = write, lease = mtime
    TTL, watch = poll, delete = leave).

    CONSTRAINT: this backend only coordinates
    hosts that mount the SAME directory. For clusters without one, use
    :class:`TcpNodeRegistry` against a :class:`TcpRegistryServer` — same
    surface, no filesystem assumption.

    OBSERVER MODE: a process that only WATCHES membership (the serving
    router, a controller) constructs the registry with ``node_id=None`` —
    ``alive_nodes()`` works, ``register()``/``leave()`` refuse."""

    def __init__(self, registry_dir, node_id=None, endpoint=None, ttl=30.0,
                 heartbeat_interval=2.0):
        self.dir = registry_dir
        self.node_id = None if node_id is None else str(node_id)
        self.endpoint = endpoint
        self.ttl = ttl
        self._interval = heartbeat_interval
        self._stop = threading.Event()
        self._thread = None
        os.makedirs(registry_dir, exist_ok=True)

    def _check_member(self):
        _check_registry_member(self.node_id, self.endpoint)

    def _path(self, node_id=None):
        return os.path.join(self.dir, f"node_{node_id or self.node_id}.json")

    def _write(self):
        import json
        tmp = self._path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"endpoint": self.endpoint, "ts": time.time(),
                       "ttl": self.ttl}, f)
        os.replace(tmp, self._path())

    def register(self):
        """Publish this node and keep renewing the lease (daemon thread)."""
        self._check_member()
        self._write()

        def renew():
            while not self._stop.wait(self._interval):
                try:
                    self._write()
                except OSError:
                    pass

        self._thread = threading.Thread(target=renew, daemon=True,
                                        name="paddle-node-lease")
        self._thread.start()
        return self

    def leave(self):
        self._check_member()
        self._stop.set()
        if self._thread is not None:
            # join before unlinking: an in-flight _write() could otherwise
            # land after the remove and resurrect the lease for a full TTL
            self._thread.join(timeout=self._interval + 1.0)
        try:
            os.remove(self._path())
        except OSError:
            pass

    def alive_nodes(self):
        """{node_id: endpoint} for every node with a fresh lease."""
        import json
        now = time.time()
        out = {}
        for name in sorted(os.listdir(self.dir)):
            if not (name.startswith("node_") and name.endswith(".json")):
                continue
            p = os.path.join(self.dir, name)
            try:
                with open(p) as f:
                    info = json.load(f)
                # per-lease TTL, like etcd leases (observer honors the
                # registrant's own renewal contract)
                if now - os.path.getmtime(p) > info.get("ttl", self.ttl):
                    continue
            except (OSError, ValueError):
                continue
            out[name[len("node_"):-len(".json")]] = info["endpoint"]
        return out


class ElasticJobManager:
    """np-range elasticity (ref ``--np 2:4`` + `manager.py` scale
    detection): watches the registry and tells the launch controller what
    to do — WAIT below np_min, RESCALE when the committed member set
    changed within [np_min, np_max] (rebuild PADDLE_TRAINER_ENDPOINTS and
    restart from the latest checkpoint — `train/fault_tolerance.py`
    resumes it), STEADY otherwise."""

    WAIT, STEADY, RESCALE = "wait", "steady", "rescale"

    def __init__(self, registry, np_min, np_max=None):
        self.registry = registry
        self.np_min = int(np_min)
        self.np_max = int(np_max or np_min)
        self._committed = None

    def endpoints(self, alive):
        return [alive[k] for k in sorted(alive)]

    def poll(self):
        alive = self.registry.alive_nodes()
        n = len(alive)
        if n < self.np_min:
            # forget the committed set: when quorum returns — even with the
            # IDENTICAL members — the stopped job must be relaunched
            # (RESCALE), not reported STEADY
            self._committed = None
            return self.WAIT, self.endpoints(alive)
        members = tuple(sorted(alive))[: self.np_max]
        eps = [alive[k] for k in members]
        if self._committed is None:
            self._committed = members
            return self.RESCALE, eps          # first commit = initial launch
        if members != self._committed:
            self._committed = members
            return self.RESCALE, eps
        return self.STEADY, eps


class ElasticManager:
    """Controller-side staleness watcher (ref `manager.py:126` liveness
    role) — single-pod fault detection; multi-node membership lives in
    :class:`NodeRegistry` + :class:`ElasticJobManager`."""

    def __init__(self, heartbeat_dir, world_size, timeout=30.0,
                 grace_period=60.0):
        self.dir = heartbeat_dir
        self.world_size = world_size
        self.timeout = timeout
        self._start = time.time()
        self.grace = grace_period

    def path_for(self, rank):
        return os.path.join(self.dir, f"heartbeat.{rank}")

    def reset(self):
        """Called by the controller before a pod restart: old heartbeat files
        must not instantly re-flag the fresh workers as stale, and the grace
        window restarts (new workers need import/init time)."""
        for rank in range(self.world_size):
            try:
                os.remove(self.path_for(rank))
            except OSError:
                pass
        self._start = time.time()

    def dead_workers(self):
        """Ranks whose heartbeat is stale. Within the startup grace period a
        missing file is not a death (workers may still be starting)."""
        now = time.time()
        dead = []
        for rank in range(self.world_size):
            p = self.path_for(rank)
            try:
                age = now - os.path.getmtime(p)
            except OSError:
                if now - self._start > self.grace:
                    dead.append(rank)
                continue
            if age > self.timeout:
                dead.append(rank)
        return dead

    def healthy(self):
        return not self.dead_workers()


# --------------------------------------------------------------- TCP backend

def _elastic_token() -> bytes:
    """Shared-secret digest for registry connections (same contract as
    `distributed/rpc.py`): set the SAME ``PADDLE_ELASTIC_TOKEN`` on every
    host. There is deliberately no default — the old constant fallback
    ("pt-elastic") let anyone who could reach the port tamper with
    membership, and a per-process random token cannot work
    for a registry whose whole point is cross-host agreement."""
    import hashlib
    secret = os.environ.get("PADDLE_ELASTIC_TOKEN")
    if not secret:
        raise RuntimeError(
            "PADDLE_ELASTIC_TOKEN is not set: the TCP elastic registry "
            "refuses to run with a well-known default secret. Export the "
            "same PADDLE_ELASTIC_TOKEN on the registry host and every "
            "agent host.")
    return hashlib.sha256(secret.encode()).digest()


class TcpRegistryServer:
    """In-memory lease store over TCP — the etcd-replacement for clusters
    WITHOUT a shared filesystem (the directory-based
    :class:`NodeRegistry` assumes every host mounts the same dir; the
    reference's etcd registry has no such constraint,
    `fleet/elastic/manager.py:126`). Run one instance next to the launch
    controller: ``python -m paddle_tpu_torch.distributed.fleet.elastic --port P``
    or ``TcpRegistryServer(port=...).start()``.

    Wire protocol (authed like rpc.py): 32-byte sha256 hello, then
    newline-delimited JSON requests {op: put|del|list, ...} -> JSON reply.
    Leases live in memory with per-entry TTLs; LIST filters stale."""

    def __init__(self, host="127.0.0.1", port=0):
        import socket
        self._nodes = {}          # node_id -> (endpoint, ts, ttl, nonce)
        self._tombstones = {}     # (node_id, nonce) -> del timestamp
        self._lock = threading.Lock()
        self._token = _elastic_token()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="pt-elastic-registry")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def _serve(self):
        import socket
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.5)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._client, args=(conn,),
                             daemon=True).start()

    def _client(self, conn):
        import hmac
        import json
        try:
            conn.settimeout(10.0)
            hello = b""
            while len(hello) < 32:
                chunk = conn.recv(32 - len(hello))
                if not chunk:
                    return
                hello += chunk
            if not hmac.compare_digest(hello, self._token):
                return
            f = conn.makefile("rwb")
            for line in f:
                try:
                    req = json.loads(line)
                except ValueError as e:
                    # authed but unparsable: reply per protocol, then drop
                    # (stream position after a bad line is unknowable)
                    f.write((json.dumps({"ok": False,
                                         "error": f"bad json: {e}"})
                             + "\n").encode())
                    f.flush()
                    return
                op = req.get("op")
                now = time.time()
                try:
                    with self._lock:
                        if op == "put":
                            nid = str(req["node_id"])
                            nonce = str(req.get("nonce", ""))
                            # a put whose SESSION was already deleted is a
                            # late in-flight renewal racing leave() — drop
                            # it (sequencing, not timing, closes the lease-
                            # resurrection race); a REJOIN uses a fresh
                            # nonce and registers normally
                            if (nid, nonce) in self._tombstones:
                                resp = {"ok": True, "stale": True}
                            else:
                                self._nodes[nid] = (
                                    req["endpoint"], now,
                                    float(req.get("ttl", 30)), nonce)
                                resp = {"ok": True}
                        elif op == "del":
                            nid = str(req["node_id"])
                            nonce = str(req.get("nonce", ""))
                            self._tombstones[(nid, nonce)] = now
                            cur = self._nodes.get(nid)
                            if cur is None or cur[3] == nonce or not nonce:
                                self._nodes.pop(nid, None)
                            resp = {"ok": True}
                        elif op == "list":
                            # prune expired leases + old tombstones
                            # (node-id churn across elastic restarts must
                            # not grow the dicts unboundedly)
                            dead = [k for k, (_, ts, ttl, _n)
                                    in self._nodes.items()
                                    if now - ts > ttl]
                            for k in dead:
                                del self._nodes[k]
                            for k in [k for k, ts in
                                      self._tombstones.items()
                                      if now - ts > 120.0]:
                                del self._tombstones[k]
                            resp = {"ok": True, "nodes": {
                                k: ep for k, (ep, ts, ttl, _n)
                                in self._nodes.items()}}
                        else:
                            resp = {"ok": False, "error": f"bad op {op!r}"}
                except (KeyError, TypeError, ValueError) as e:
                    # malformed-but-authed request: reply with the error the
                    # protocol promises instead of killing the handler
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                f.write((json.dumps(resp) + "\n").encode())
                f.flush()
        except OSError:
            pass
        finally:
            conn.close()


class TcpNodeRegistry:
    """Drop-in for :class:`NodeRegistry` backed by a
    :class:`TcpRegistryServer` instead of a shared directory — same
    register()/leave()/alive_nodes() surface (observer mode with
    ``node_id=None`` included), so :class:`ElasticJobManager` and the
    serving router work with either backend unchanged."""

    def __init__(self, server_addr, node_id=None, endpoint=None, ttl=30.0,
                 heartbeat_interval=2.0):
        host, port = server_addr.rsplit(":", 1)
        self._addr = (host, int(port))
        self.node_id = None if node_id is None else str(node_id)
        self.endpoint = endpoint
        self.ttl = ttl
        self._interval = heartbeat_interval
        self._stop = threading.Event()
        self._thread = None
        self._last_view: dict = {}
        self._nonce = os.urandom(8).hex()   # session id: dedupes vs rejoin

    def _call(self, req):
        import json
        import socket
        with socket.create_connection(self._addr, timeout=10.0) as s:
            s.sendall(_elastic_token())
            f = s.makefile("rwb")
            f.write((json.dumps(req) + "\n").encode())
            f.flush()
            line = f.readline()
            if not line:
                raise ConnectionError("registry closed (bad auth token?)")
            return json.loads(line)

    def _check_member(self):
        _check_registry_member(self.node_id, self.endpoint)

    def register(self):
        self._check_member()
        self._call({"op": "put", "node_id": self.node_id,
                    "endpoint": self.endpoint, "ttl": self.ttl,
                    "nonce": self._nonce})

        def renew():
            while not self._stop.wait(self._interval):
                try:
                    self._call({"op": "put", "node_id": self.node_id,
                                "endpoint": self.endpoint, "ttl": self.ttl,
                                "nonce": self._nonce})
                except (OSError, ValueError):
                    pass

        self._thread = threading.Thread(target=renew, daemon=True,
                                        name="paddle-node-lease-tcp")
        self._thread.start()
        return self

    def leave(self):
        self._check_member()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 1.0)
        try:
            # the del TOMBSTONES this session's nonce server-side, so even
            # a renewal still in flight (socket timeouts can hold one for
            # tens of seconds) cannot resurrect the lease — sequencing,
            # not join-timing, closes the race; a rejoining registry uses
            # a fresh nonce and is unaffected
            self._call({"op": "del", "node_id": self.node_id,
                        "nonce": self._nonce})
        except (OSError, ValueError):
            pass

    def alive_nodes(self):
        """Degrades like the file backend: a transient registry outage
        (server restarting, dropped connect) returns the LAST successful
        view instead of crashing the elastic controller — the controller
        holds steady through registry churn and reconverges on the next
        successful poll."""
        try:
            resp = self._call({"op": "list"})
        except (OSError, ValueError):
            return dict(self._last_view)
        self._last_view = dict(resp.get("nodes", {}))
        return dict(self._last_view)


def _registry_main(argv=None):
    import argparse
    ap = argparse.ArgumentParser("paddle_tpu_torch.distributed.fleet.elastic")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    srv = TcpRegistryServer(args.host, args.port).start()
    print(f"REGISTRY LISTENING {srv.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    _registry_main()
