"""The port's router (`paddle_tpu_torch/serving/router.py`) held against
the JAX package's (`paddle_tpu/serving/router.py`) in one process, on the
tiny float32 GPT of `tests/test_torch_serve.py` (both packages' weights
drawn by numpy from one seed).

Each scenario of the JAX router tests (`tests/test_router.py`: routing,
policies, failover, registry membership, graceful drain, the CLI's
parsing; `tests/test_chaos.py::TestRouterRobustness`) runs once with a
JAX router, JAX replicas and a JAX client and once with the port's,
through `both`: the records (tokens, typed error classes and texts,
``router.*`` / ``serve.*`` / ``engine.*`` counter deltas of each package's
own registry, each replica's request counts, breaker states) must be
equal, and the tokens equal an uninterrupted port engine's. Timing is
pinned as the JAX tests pin it (``engine.step_delay`` armed on the side
under test, every wait bounded); every router, server and engine thread
is stopped at the end of its scenario.

Across the packages: a router of either package in front of the other
package's replicas, and in front of a fleet with one replica of each.
The port's router CLI in a process of its own: ``LISTENING``, tokens,
STATS, Prometheus text, ``--dump``, and exit 0 on SIGTERM (the JAX CLI
has no SIGTERM handler; the port's stops the router and exits 0).

`Side` and `both` are shared with `tests/test_torch_router_fleet.py` and
`tests/test_torch_autoscale.py`.
"""
import json
import os
import signal
import socket
import struct
import threading
import time

import numpy as np
import pytest

import paddle_tpu.distributed.fleet.elastic as jel
import paddle_tpu.inference.engine as jeng
import paddle_tpu.inference.errors as jerr
import paddle_tpu.inference.serve as jserve
import paddle_tpu.serving.autoscale as jauto
import paddle_tpu.serving.disagg as jdisagg
import paddle_tpu.serving.router as jrouter
import paddle_tpu_torch.distributed.fleet.elastic as tel
import paddle_tpu_torch.inference.engine as teng
import paddle_tpu_torch.inference.errors as terr
import paddle_tpu_torch.inference.serve as tserve
import paddle_tpu_torch.serving.autoscale as tauto
import paddle_tpu_torch.serving.disagg as tdisagg
import paddle_tpu_torch.serving.router as trouter
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.testing import faults as tfaults
from tests.test_torch_serve import (_norm, _pair, _read_line, _ref, _spawn,
                                    _stop_server)
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


FLEET = "router-fleet"
FRONT = "router-front"
PKGS = ("jax", "torch")


@pytest.fixture(scope="module")
def models():
    return _pair(7)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    jfaults.disarm()
    tfaults.disarm()


def _wait_for(pred, timeout=30.0, msg="condition"):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.02)


def _dead_port():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def ep(srv):
    return f"127.0.0.1:{srv.port}"


def _outcome(fn):
    """``("ok", tokens)`` or ``("err", class name, normalized text)``."""
    try:
        return ("ok", np.asarray(fn()).tolist())
    except Exception as e:  # noqa: BLE001 - recorded for comparison
        return ("err", type(e).__name__, _norm(str(e)))


def _baseline(eng):
    return eng.allocator.free_pages == eng.allocator.num_pages - 1


class Side:
    """One package's half of a scenario: its serve, router, autoscale,
    disagg and registry modules, its faults, errors and registry deltas.
    Every replica, router and scaler it starts is stopped by `close`."""

    def __init__(self, name, models):
        self.jax = name == "jax"
        self.name = name
        self.serve = jserve if self.jax else tserve
        self.router_mod = jrouter if self.jax else trouter
        self.autoscale = jauto if self.jax else tauto
        self.disagg = jdisagg if self.jax else tdisagg
        self.elastic = jel if self.jax else tel
        self.faults = jfaults if self.jax else tfaults
        self.errors = jerr if self.jax else terr
        self.metrics = jmetrics if self.jax else tmetrics
        self.model = models[0 if self.jax else 1]
        self.servers, self.routers, self.scalers = [], [], []
        self.c0 = dict(self.metrics.snapshot()["counters"])

    def engine(self, **kw):
        cfg = {"page_size": 4, "max_slots": 2, "min_bucket": 8, **kw}
        if self.jax:
            return jeng.DecodeEngine(self.model, jeng.EngineConfig(**cfg))
        return teng.DecodeEngine(self.model, teng.EngineConfig(**cfg),
                                 device="cpu")

    def replica(self, role="both", port=0, **ekw):
        srv = self.serve.InferenceServer(None, port=port,
                                         engine=self.engine(**ekw),
                                         auth_name=FLEET, role=role)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        self.servers.append(srv)
        return srv

    def router(self, **kw):
        kw.setdefault("replica_secret", FLEET)
        kw.setdefault("auth_name", FRONT)
        router = self.router_mod.Router(**kw)
        router.accept_thread = threading.Thread(target=router.serve_forever,
                                                daemon=True)
        router.accept_thread.start()
        self.routers.append(router)
        return router

    def client(self, port, secret=FRONT, **kw):
        return self.serve.RemotePredictor(port=port, secret=secret, **kw)

    def counter(self, name):
        return self.metrics.snapshot()["counters"].get(name, 0)

    def delta(self, *names):
        now = self.metrics.snapshot()["counters"]
        return {k: now.get(k, 0) - self.c0.get(k, 0) for k in names}

    def close(self):
        for scaler in self.scalers:
            scaler.stop()
        for router in self.routers:
            stop_router(router)
        for srv in self.servers:
            _stop_server(srv)


def stop_router(router):
    """Stop a router and join its accept, poll, probe and stats threads."""
    router.stop()
    for name in ("accept_thread", "_poll_thread", "_probe_thread",
                 "_stats_thread"):
        t = getattr(router, name, None)
        if t is not None:
            t.join(timeout=10)
            assert not t.is_alive(), name


def both(models, scenario, **kw):
    """Run ``scenario(side, **kw)`` with the JAX package, then the port;
    the two records must be equal. Returns them."""
    recs = {}
    for name in PKGS:
        side = Side(name, models)
        try:
            recs[name] = scenario(side, **kw)
        finally:
            side.close()
    assert recs["jax"] == recs["torch"], recs
    return recs


# --------------------------------------------------------- retrying_connect


@pytest.mark.parametrize("pkg", PKGS)
def test_retrying_connect_gives_up_after_attempts(pkg):
    serve = jserve if pkg == "jax" else tserve
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="after 3 attempts"):
        serve.retrying_connect("127.0.0.1", _dead_port(), attempts=3,
                               base_delay_s=0.02, jitter=0.0)
    assert time.monotonic() - t0 >= 0.05     # two backoff sleeps


@pytest.mark.parametrize("pkg", PKGS)
def test_retrying_connect_deadline_caps_total_time(pkg):
    serve = jserve if pkg == "jax" else tserve
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        serve.retrying_connect("127.0.0.1", _dead_port(), attempts=1000,
                               base_delay_s=0.05, deadline_s=0.3)
    assert time.monotonic() - t0 < 2.0


@pytest.mark.parametrize("pkg", PKGS)
def test_retrying_connect_rides_out_a_restart(pkg):
    serve = jserve if pkg == "jax" else tserve
    port = _dead_port()
    box = {}

    def late_listen():
        time.sleep(0.25)
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.listen(1)
        box["s"] = s

    t = threading.Thread(target=late_listen, daemon=True)
    t.start()
    conn = serve.retrying_connect("127.0.0.1", port, attempts=30,
                                  base_delay_s=0.05, deadline_s=5.0)
    conn.close()
    t.join()
    box["s"].close()


# ------------------------------------------------------------------ routing


def sc_round_robin(s, prompts):
    s0, s1 = s.replica(), s.replica()
    router = s.router(replicas={"r0": ep(s0), "r1": ep(s1)})
    cli = s.client(router.port)
    toks = [cli.generate(p, max_new_tokens=6).tolist() for p in prompts]
    stats = cli.stats()
    cli.close()
    return {"tokens": toks, "role": stats["role"],
            "counters": s.delta("router.requests",
                                "router.replica_requests{replica=r0}",
                                "router.replica_requests{replica=r1}",
                                "router.resubmits", "serve.generate_requests",
                                "engine.requests")}


def test_round_robin_spreads_and_matches_reference(models):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 97, 4 + i).astype(np.int32) for i in range(4)]
    recs = both(models, sc_round_robin, prompts=prompts)
    rec = recs["torch"]
    assert rec["tokens"] == [_ref(models, p, 6) for p in prompts]
    assert rec["counters"]["router.replica_requests{replica=r0}"] == 2
    assert rec["counters"]["router.replica_requests{replica=r1}"] == 2
    assert rec["counters"]["router.requests"] == 4
    assert rec["role"] == "router"


def _policy_picks(mod):
    router = mod.Router.__new__(mod.Router)     # policy fns need ._rr only
    router._rr = -1
    a, b, c = (mod.ReplicaState(i, f"h:{n}")
               for n, i in enumerate(("a", "b", "c")))
    a.outstanding, b.outstanding, c.outstanding = 3, 1, 2
    rec = [mod.POLICIES["least_outstanding"](router, [a, b, c]).replica_id]
    a.stats = {"histograms": {"serve.tpot_seconds": {"p99": 0.004}}}
    b.stats = {"histograms": {"serve.tpot_seconds": {"p99": 0.009}}}
    # c has no stats yet: optimistic 0.0 beats both observed replicas
    rec.append(mod.POLICIES["slo_aware"](router, [a, b, c]).replica_id)
    c.stats = {"histograms": {"serve.tpot_seconds": {"p99": 0.007}}}
    rec.append(mod.POLICIES["slo_aware"](router, [a, b, c]).replica_id)
    rec += [mod.POLICIES["round_robin"](router, [a, b, c]).replica_id
            for _ in range(6)]
    roles = [mod.ReplicaState(i, "h:1").role
             for i in ("r0", "prefill:p0", "decode:d0", "router:x")]
    return rec, sorted(mod.POLICIES), roles


def test_policies_pick_as_documented():
    picks = {pkg: _policy_picks(mod)
             for pkg, mod in (("jax", jrouter), ("torch", trouter))}
    assert picks["jax"] == picks["torch"]
    assert picks["torch"][0] == ["b", "c", "a", "a", "b", "c", "a", "b",
                                 "c"]
    assert picks["torch"][2] == ["both", "prefill", "decode", "both"]


def sc_app_error(s):
    s0 = s.replica()
    router = s.router(replicas={"r0": ep(s0)})
    cli = s.client(router.port)
    rec = _outcome(lambda: cli.generate(
        np.arange(50, dtype=np.int32) % 97, max_new_tokens=60))
    cli.close()
    return {"outcome": rec, "counters": s.delta("router.resubmits",
                                                "router.errors",
                                                "router.replica_errors")}


def test_app_error_relays_without_resubmit(models):
    """A bad request fails identically everywhere: the replica's error is
    relayed verbatim (no router prefix) and burns no resubmit."""
    rec = both(models, sc_app_error)["torch"]
    assert rec["outcome"][:2] == ("err", "RuntimeError")
    assert rec["outcome"][2].startswith("ValueError:")
    assert "max_seq_len" in rec["outcome"][2]
    assert rec["counters"] == {"router.resubmits": 0, "router.errors": 1,
                               "router.replica_errors": 0}


# ----------------------------------------------------------------- failover


def sc_dead_from_start(s, prompts):
    s1 = s.replica()
    router = s.router(replicas={"dead": f"127.0.0.1:{_dead_port()}",
                                "live": ep(s1)},
                      connect_deadline_s=0.5, evict_cooldown_s=60.0)
    cli = s.client(router.port)
    toks = [cli.generate(p, max_new_tokens=5).tolist() for p in prompts]
    cli.close()
    return {"tokens": toks, "healthy": router.replica_ids(healthy_only=True),
            "breaker": router._replicas["dead"].breaker,
            "counters": s.delta("router.resubmits", "router.replica_errors",
                                "router.breaker_open",
                                "router.replica_requests{replica=live}")}


def test_dead_replica_from_start_is_routed_around(models):
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 97, 5 + i).astype(np.int32) for i in range(4)]
    rec = both(models, sc_dead_from_start, prompts=prompts)["torch"]
    assert rec["tokens"] == [_ref(models, p, 5) for p in prompts]
    assert rec["healthy"] == ["live"] and rec["breaker"] == "open"
    assert rec["counters"] == {"router.resubmits": 1,
                               "router.replica_errors": 1,
                               "router.breaker_open": 1,
                               "router.replica_requests{replica=live}": 4}


def sc_kill_mid_run(s, shorts, long_p):
    s0 = s.replica(prefill_chunk_tokens=8)
    s1 = s.replica(prefill_chunk_tokens=8)
    router = s.router(replicas={"r0": ep(s0), "r1": ep(s1)},
                      connect_deadline_s=0.5, evict_cooldown_s=60.0)
    outs, errs = {}, []

    def one(i, p, n):
        try:
            cli = s.client(router.port)
            outs[i] = cli.generate(p, max_new_tokens=n).tolist()
            cli.close()
        except Exception as e:  # noqa: BLE001 - recorded
            errs.append((i, f"{type(e).__name__}: {e}"))

    one(0, shorts[0], 6)
    one("long", long_p, 4)
    _stop_server(s0)          # a rolling-deploy kill: r0 gone mid-fleet
    ths = [threading.Thread(target=one, args=(i, p, 6))
           for i, p in enumerate(shorts[1:], start=1)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
        assert not t.is_alive()
    c = s.delta("router.resubmits", "router.requests")
    return {"tokens": [outs.get(i) for i in range(len(shorts))],
            "long": outs.get("long"), "errors": errs,
            "resubmitted": c["router.resubmits"] >= 1,
            "requests": c["router.requests"]}


def test_kill_replica_mid_run_zero_client_errors(models):
    rng = np.random.RandomState(5)
    shorts = [rng.randint(0, 97, 4).astype(np.int32) for _ in range(8)]
    long_p = rng.randint(0, 97, 40).astype(np.int32)
    rec = both(models, sc_kill_mid_run, shorts=shorts,
               long_p=long_p)["torch"]
    assert rec["errors"] == []
    assert rec["tokens"] == [_ref(models, p, 6) for p in shorts]
    assert rec["long"] == _ref(models, long_p, 4)
    assert rec["resubmitted"] and rec["requests"] == 9


RELAYED = (
    "ValueError: prompt 50 + max_new_tokens 60 exceeds engine "
    "max_seq_len=64",
    "RuntimeError: no decode engine attached (start with "
    "--gpt-config or engine=)",
    "DeadlineExceeded: request deadline (0.5s) passed after 3 "
    "generated tokens",
    "Cancelled: client disconnected",
)
RESUBMITTED = (
    "RuntimeError: engine draining: not accepting new requests",
    "RuntimeError: server draining: not accepting new requests",
    "RuntimeError: engine stopped: replica killed mid-run",
    "RuntimeError: some free-form abort reason",
    "TimeoutError: generation still running",
    "Overloaded: engine queue full: depth 8 >= max_queue_depth 8",
)


def _classify(mod):
    return [(type(mod._classify_wire_error(m)).__name__,
             str(mod._classify_wire_error(m)))
            for m in RELAYED + RESUBMITTED]


def test_wire_error_classification():
    """Relay or resubmit is decided by the replica's exception type, the
    same way in both packages."""
    recs = {"jax": _classify(jrouter), "torch": _classify(trouter)}
    assert recs["jax"] == recs["torch"]
    kinds = [k for k, _ in recs["torch"]]
    assert kinds == ["_ReplicaAppError"] * len(RELAYED) \
        + ["ReplicaUnavailable"] * len(RESUBMITTED)
    assert issubclass(trouter.ReplicaUnavailable, ConnectionError)


def _evictions(mod):
    cases = [mod.ReplicaUnavailable(
                 "RuntimeError: request needs 40 pages, pool has 16"),
             mod.ReplicaUnavailable("TimeoutError: generation still running"),
             mod.ReplicaUnavailable("Overloaded: engine queue full: depth 8 "
                                    ">= max_queue_depth 8"),
             mod.ReplicaUnavailable("RuntimeError: engine draining: not "
                                    "accepting new requests"),
             mod.ReplicaUnavailable("RuntimeError: engine stopped: replica "
                                    "killed mid-run"),
             ConnectionError("connection refused"),
             socket.timeout("timed out")]
    return [mod._should_evict(e) for e in cases]


def test_eviction_reserved_for_not_taking_work():
    assert _evictions(jrouter) == _evictions(trouter) \
        == [False, False, False, True, True, True, True]


def sc_recovers_after_cooldown(s):
    port = _dead_port()
    router = s.router(replicas={"r0": f"127.0.0.1:{port}"},
                      connect_deadline_s=0.3, evict_cooldown_s=0.5,
                      poll_interval_s=0.1)
    cli = s.client(router.port)
    first = _outcome(lambda: cli.generate(np.array([1, 2, 3], np.int32),
                                          max_new_tokens=2))
    cli.close()
    evicted = "r0" not in router.replica_ids(healthy_only=True)
    s.replica(port=port)        # back on the advertised endpoint
    _wait_for(lambda: "r0" in router.replica_ids(healthy_only=True),
              msg="cooldown re-admission")
    cli2 = s.client(router.port)
    out = cli2.generate(np.array([4, 5, 6], np.int32),
                        max_new_tokens=4).tolist()
    cli2.close()
    return {"first": first, "evicted": evicted, "tokens": out,
            "counters": s.delta("router.no_replica", "router.resubmits")}


def test_evicted_static_replica_recovers_after_cooldown(models):
    rec = both(models, sc_recovers_after_cooldown)["torch"]
    assert rec["first"][:2] == ("err", "RuntimeError")
    assert "no healthy replica" in rec["first"][2]
    assert rec["evicted"]
    assert rec["tokens"] == _ref(models, np.array([4, 5, 6]), 4)


# --------------------------------------------------- registry membership


def sc_joins_mid_stream(s, tmp):
    reg_dir = str(tmp / s.name)
    s0 = s.replica()
    regs = [s.elastic.NodeRegistry(reg_dir, "r0", ep(s0), ttl=30.0,
                                   heartbeat_interval=0.1).register()]
    router = s.router(registry=s.elastic.NodeRegistry(reg_dir),
                      poll_interval_s=0.05)
    _wait_for(lambda: "r0" in router.replica_ids(), msg="r0 discovery")
    rng = np.random.RandomState(6)
    cli = s.client(router.port)
    p = rng.randint(0, 97, 5).astype(np.int32)
    toks = [cli.generate(p, max_new_tokens=5).tolist()]
    s1 = s.replica()
    regs.append(s.elastic.NodeRegistry(reg_dir, "r1", ep(s1), ttl=30.0,
                                       heartbeat_interval=0.1).register())
    _wait_for(lambda: "r1" in router.replica_ids(), msg="r1 discovery")
    for i in range(4):
        p = rng.randint(0, 97, 4 + i).astype(np.int32)
        toks.append(cli.generate(p, max_new_tokens=4).tolist())
    cli.close()
    for reg in regs:
        reg.leave()
    return {"tokens": toks,
            "counters": s.delta("router.replica_requests{replica=r0}",
                                "router.replica_requests{replica=r1}",
                                "router.replica_joins")}


def test_replica_joins_mid_stream_and_gets_traffic(models, tmp_path):
    rec = both(models, sc_joins_mid_stream, tmp=tmp_path)["torch"]
    rng = np.random.RandomState(6)
    p = rng.randint(0, 97, 5).astype(np.int32)
    want = [_ref(models, p, 5)]
    for i in range(4):
        want.append(_ref(models, rng.randint(0, 97, 4 + i), 4))
    assert rec["tokens"] == want
    assert rec["counters"]["router.replica_requests{replica=r1}"] >= 1
    assert rec["counters"]["router.replica_joins"] == 2


def sc_heartbeat_expiry(s, tmp):
    reg_dir = str(tmp / s.name)
    s0 = s.replica()
    reg0 = s.elastic.NodeRegistry(reg_dir, "good", ep(s0), ttl=30.0,
                                  heartbeat_interval=0.1).register()
    # a crashed replica: one lease write (ttl 0.3 s), no renewals, nothing
    # listening on its endpoint
    dead = s.elastic.NodeRegistry(reg_dir, "crashed",
                                  f"127.0.0.1:{_dead_port()}", ttl=0.3)
    dead._write()
    router = s.router(registry=s.elastic.NodeRegistry(reg_dir),
                      poll_interval_s=0.05, connect_deadline_s=0.5)
    _wait_for(lambda: "good" in router.replica_ids(), msg="discovery")
    _wait_for(lambda: "crashed" not in router.replica_ids(),
              msg="stale lease expiry")
    rng = np.random.RandomState(7)
    cli = s.client(router.port)
    toks = [cli.generate(rng.randint(0, 97, 4 + i).astype(np.int32),
                         max_new_tokens=4).tolist() for i in range(3)]
    cli.close()
    # the membership that routed around the dead replica: read before the
    # good one leaves, which the router's poll would see 50 ms later
    ids = router.replica_ids()
    reg0.leave()
    return {"tokens": toks, "ids": ids}


def test_heartbeat_expiry_routes_around_dead_replica(models, tmp_path):
    rec = both(models, sc_heartbeat_expiry, tmp=tmp_path)["torch"]
    rng = np.random.RandomState(7)
    assert rec["tokens"] == [_ref(models, rng.randint(0, 97, 4 + i), 4)
                             for i in range(3)]
    assert rec["ids"] == ["good"]


# ------------------------------------------------------------ graceful drain


def sc_drain_inflight(s, tmp, prompt):
    reg_dir = str(tmp / s.name)
    srv = s.replica()
    reg = s.elastic.NodeRegistry(reg_dir, "d0", ep(srv), ttl=30.0,
                                 heartbeat_interval=0.1).register()
    srv.attach_registry(reg)
    result = {}

    def inflight():
        cli = s.client(srv.port, secret=FLEET)
        result["out"] = cli.generate(prompt, max_new_tokens=24).tolist()
        cli.close()

    t = threading.Thread(target=inflight, daemon=True)
    t.start()
    _wait_for(lambda: srv._engine._occupied() or result,
              msg="request admission")
    drained = {}
    dt = threading.Thread(target=lambda: drained.update(
        clean=srv.drain(deadline_s=30.0)), daemon=True)
    dt.start()
    _wait_for(lambda: srv._engine._draining, msg="drain flag")
    refused = _outcome(lambda: srv._engine.submit(prompt, max_new_tokens=2))
    t.join(timeout=60)
    dt.join(timeout=60)
    return {"clean": drained.get("clean"), "tokens": result.get("out"),
            "refused": refused,
            "registered": sorted(s.elastic.NodeRegistry(
                reg_dir).alive_nodes()),
            "stopped": srv._stop.is_set()}


def test_drain_finishes_inflight_refuses_new_deregisters(models, tmp_path):
    prompt = np.random.RandomState(8).randint(0, 97, 5).astype(np.int32)
    rec = both(models, sc_drain_inflight, tmp=tmp_path,
               prompt=prompt)["torch"]
    assert rec["clean"] is True and rec["stopped"]
    assert rec["tokens"] == _ref(models, prompt, 24)
    assert rec["refused"][:2] == ("err", "RuntimeError")
    assert "draining" in rec["refused"][2]
    assert rec["registered"] == []


def sc_sigterm_drain(s):
    srv = s.replica()
    prev = signal.getsignal(signal.SIGTERM)
    handler = s.serve.install_sigterm_drain(srv, deadline_s=10.0)
    try:
        installed = signal.getsignal(signal.SIGTERM) is handler
        os.kill(os.getpid(), signal.SIGTERM)
        _wait_for(lambda: srv._stop.is_set(), msg="SIGTERM drain")
        refused = _outcome(lambda: srv._engine.submit(
            np.array([1, 2, 3], np.int32), 2))
    finally:
        signal.signal(signal.SIGTERM, prev)
    return {"installed": installed, "refused": refused[:2],
            "refusal_typed": "draining" in refused[2]
            or "engine stopped" in refused[2]}


def test_sigterm_triggers_drain(models):
    rec = both(models, sc_sigterm_drain)["torch"]
    assert rec == {"installed": True, "refused": ("err", "RuntimeError"),
                   "refusal_typed": True}


# ------------------------------------------------------------------- the CLI


@pytest.mark.parametrize("argv", [["--replica", "not-a-spec"], [],
                                  ["--replica", "a=h:1", "--policy", "bogus"],
                                  ["--replica", "a=h:1", "--router-id", "x"]],
                         ids=["bad_spec", "no_membership", "bad_policy",
                              "router_id_without_registry"])
def test_cli_refusals_match(argv, capsys):
    errs = {}
    for pkg, mod in (("jax", jrouter), ("torch", trouter)):
        with pytest.raises(SystemExit) as ei:
            mod.main(list(argv))
        errs[pkg] = (ei.value.code,
                     capsys.readouterr().err.split("error:")[-1].strip())
    assert errs["jax"] == errs["torch"]
    assert errs["torch"][0] == 2


def test_cli_flags_match_the_jax_cli():
    """Every flag of the JAX router CLI, with its default, and no other."""
    def flags(mod):
        import argparse
        parsed = {}
        real = argparse.ArgumentParser.parse_args

        def capture(self, args=None, namespace=None):
            ns = real(self, args, namespace)
            parsed.update(vars(ns))
            raise SystemExit(0)
        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                mod.main(["--replica", "a=h:1"])
        finally:
            argparse.ArgumentParser.parse_args = real
        return parsed
    assert flags(jrouter) == flags(trouter)


def test_cli_dump_prints_replica_flight_ring(models, capsys):
    """``--dump`` pulls a replica's DEBUG_DUMP through the replica auth
    path; an unknown replica id is refused naming the known ones. The
    CLI names this process a router; its identity is restored after."""
    for pkg, mod in (("jax", jrouter), ("torch", trouter)):
        s = Side(pkg, models)
        ident = s.metrics.node_identity()
        try:
            srv = s.replica()
            mod.main(["--replica", f"r0={ep(srv)}", "--replica-secret",
                      FLEET, "--auth-name", FRONT, "--dump", "r0"])
            dump = json.loads(capsys.readouterr().out)
            assert set(dump) == {"node", "events", "metrics"}, pkg
            with pytest.raises(SystemExit, match="unknown replica"):
                mod.main(["--replica", f"r0={ep(srv)}", "--replica-secret",
                          FLEET, "--auth-name", FRONT, "--dump", "nope"])
        finally:
            s.metrics.set_node_identity(role=ident.get("role"),
                                        node_id=ident.get("node_id"))
            s.close()


def test_cli_routes_serves_stats_and_stops_on_sigterm(models, tmp_path):
    """The port's router CLI in a process of its own, in front of a JAX
    and a port replica (``least_outstanding``), registered under the
    router role (``--router-id``, ``--advertise``) with its Prometheus and
    fleet endpoints (``--metrics-port``, ``--fleet-port`` with ``--slo``):
    it prints ``REGISTERED``, ``LISTENING``, ``METRICS`` and ``FLEET``,
    answers with the in-process engine's tokens, serves STATS and
    Prometheus text, and on SIGTERM leaves the registry and exits 0."""
    import urllib.request
    sides = [Side(p, models) for p in PKGS]
    reps = {f"r{i}": ep(s.replica()) for i, s in enumerate(sides)}
    reg = tmp_path / "registry"
    args = ["paddle_tpu_torch.serving.router", "--port", "0",
            "--auth-name", FRONT, "--replica-secret", FLEET,
            "--policy", "least_outstanding", "--poll-interval", "0.2",
            "--registry-dir", str(reg), "--router-id", "R0",
            "--advertise", "127.0.0.1:9", "--metrics-port", "0",
            "--fleet-port", "0",
            "--slo", "ttft=serve.ttft_seconds p99 < 2.0s;fast=60;slow=300"]
    for rid, e in reps.items():
        args += ["--replica", f"{rid}={e}"]
    proc = _spawn(args, tmp_path / "router.err")
    try:
        assert _read_line(proc, "REGISTERED", 60) \
            == "REGISTERED router:R0 127.0.0.1:9"
        port = int(_read_line(proc, "LISTENING", 60).split()[1])
        mport = int(_read_line(proc, "METRICS", 60).split()[1])
        fport = int(_read_line(proc, "FLEET", 60).split()[1])
        assert jel.NodeRegistry(str(reg)).alive_nodes() \
            == {"router:R0": "127.0.0.1:9"}
        prompts = [np.arange(3, 9, dtype=np.int32),
                   (np.arange(11) * 7 % 97).astype(np.int32)]
        cli = tserve.RemotePredictor(port=port, secret=FRONT)
        outs = [cli.generate(p, max_new_tokens=6).tolist() for p in prompts]
        stats = cli.stats()
        prom = cli.prometheus()
        cli.close()
        assert outs == [_ref(models, p, 6) for p in prompts]
        assert stats["role"] == "router"
        assert stats["counters"]["router.requests"] == 2
        assert sum(v for k, v in stats["counters"].items()
                   if k.startswith("router.replica_requests")) == 2
        assert "router_requests 2" in prom
        assert b"router_requests 2" in urllib.request.urlopen(
            f"http://127.0.0.1:{mport}/metrics", timeout=10).read()
        _wait_for(lambda: set(json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{fport}/fleet", timeout=10).read())
            ["members"]) == {"r0", "r1"}, msg="the fleet plane's members")
        jcli = jserve.RemotePredictor(port=port, secret=FRONT)
        assert jcli.generate(prompts[0], max_new_tokens=6).tolist() \
            == outs[0]
        jcli.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, \
            (tmp_path / "router.err").read_text()[-2000:]
        assert jel.NodeRegistry(str(reg)).alive_nodes() == {}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for s in sides:
            s.close()


# -------------------------------------------------------- across packages


@pytest.mark.parametrize("router_pkg,fleet", [
    ("jax", ("torch", "torch")), ("torch", ("jax", "jax")),
    ("jax", ("jax", "torch")), ("torch", ("jax", "torch"))],
    ids=["jax_router_port_replicas", "port_router_jax_replicas",
         "jax_router_mixed_fleet", "port_router_mixed_fleet"])
def test_router_fronts_replicas_of_either_package(models, router_pkg,
                                                  fleet):
    sides = {p: Side(p, models) for p in PKGS}
    try:
        reps = {f"r{i}": ep(sides[p].replica()) for i, p in enumerate(fleet)}
        rs = sides[router_pkg]
        router = rs.router(replicas=reps)
        rng = np.random.RandomState(11)
        prompts = [rng.randint(0, 97, 4 + i).astype(np.int32)
                   for i in range(4)]
        cli = sides["torch" if router_pkg == "jax" else "jax"].client(
            router.port)
        outs = [cli.generate(p, max_new_tokens=6).tolist() for p in prompts]
        cli.close()
        assert outs == [_ref(models, p, 6) for p in prompts]
        assert rs.delta("router.replica_requests{replica=r0}",
                        "router.replica_requests{replica=r1}") \
            == {"router.replica_requests{replica=r0}": 2,
                "router.replica_requests{replica=r1}": 2}
    finally:
        for s in sides.values():
            s.close()


# ---------------------------------------------- tests/test_chaos.py routers


def sc_all_shedding(s):
    s0, s1 = s.replica(max_queue_depth=0), s.replica(max_queue_depth=0)
    router = s.router(replicas={"r0": ep(s0), "r1": ep(s1)})
    cli = s.client(router.port)
    rec = _outcome(lambda: cli.generate(np.arange(4, dtype=np.int32),
                                        max_new_tokens=2))
    cli.close()
    return {"outcome": rec,
            "healthy": sorted(router.replica_ids(healthy_only=True)),
            "counters": s.delta("router.shed", "router.resubmits",
                                "router.breaker_open")}


def test_all_replicas_shedding_is_one_typed_overloaded_line(models):
    rec = both(models, sc_all_shedding)["torch"]
    kind, cls, text = rec["outcome"]
    assert (kind, cls) == ("err", "Overloaded")
    assert "\n" not in text and "Traceback" not in text
    assert rec["healthy"] == ["r0", "r1"]
    assert rec["counters"] == {"router.shed": 1, "router.resubmits": 2,
                               "router.breaker_open": 0}


def sc_budget_exhausted(s):
    router = s.router(replicas={"d0": f"127.0.0.1:{_dead_port()}",
                                "d1": f"127.0.0.1:{_dead_port()}"},
                      connect_deadline_s=0.3, max_resubmits=1)
    cli = s.client(router.port)
    rec = _outcome(lambda: cli.generate(np.arange(4, dtype=np.int32),
                                        max_new_tokens=2))
    cli.close()
    return {"outcome": rec, "counters": s.delta("router.resubmits",
                                                "router.replica_errors")}


def test_resubmit_budget_exhaustion_is_one_clean_line(models):
    rec = both(models, sc_budget_exhausted)["torch"]
    kind, cls, text = rec["outcome"]
    assert (kind, cls) == ("err", "RuntimeError")
    assert "resubmit budget (1) exhausted" in text and "\n" not in text
    assert rec["counters"] == {"router.resubmits": 1,
                               "router.replica_errors": 2}


def sc_router_deadline(s):
    router = s.router(replicas={"d0": f"127.0.0.1:{_dead_port()}"},
                      connect_deadline_s=0.3, max_resubmits=3)
    cli = s.client(router.port)
    rec = _outcome(lambda: cli.generate(np.arange(4, dtype=np.int32),
                                        max_new_tokens=2, deadline_s=0.001))
    cli.close()
    return {"class": rec[:2], "one_line": "\n" not in rec[2],
            "text": rec[2].split(" exhausted")[0],
            "counters": s.delta("router.deadline_exceeded")}


def test_router_deadline_budget_exhaustion_counts_and_types(models):
    rec = both(models, sc_router_deadline)["torch"]
    assert rec == {"class": ("err", "DeadlineExceeded"), "one_line": True,
                   "text": "request deadline (1 ms)",
                   "counters": {"router.deadline_exceeded": 1}}


def sc_replica_deadline(s):
    s0 = s.replica(prefix_cache=False)
    router = s.router(replicas={"r0": ep(s0)})
    cli = s.client(router.port)
    warm = cli.generate(np.arange(6, dtype=np.int32),
                        max_new_tokens=2).tolist()
    r0 = s.counter("router.resubmits")
    with s.faults.scoped("engine.step_delay", times=-1, delay_s=0.05):
        rec = _outcome(lambda: cli.generate(np.arange(6, dtype=np.int32),
                                            max_new_tokens=50,
                                            deadline_s=0.3))
    cli.close()
    _wait_for(lambda: not s0._engine._has_work(), msg="engine quiesce")
    return {"warm": warm, "class": rec[:2],
            "resubmits": s.counter("router.resubmits") - r0,
            "baseline": _baseline(s0._engine)}


def test_replica_deadline_relayed_verbatim_no_resubmit(models):
    rec = both(models, sc_replica_deadline)["torch"]
    assert rec["class"] == ("err", "DeadlineExceeded")
    assert rec["resubmits"] == 0 and rec["baseline"]
    assert rec["warm"] == _ref(models, np.arange(6), 2)


def sc_breaker_walk(s):
    port = _dead_port()
    router = s.router(replicas={"r0": f"127.0.0.1:{port}"},
                      connect_deadline_s=0.3, evict_cooldown_s=0.4,
                      poll_interval_s=0.1)
    cli = s.client(router.port)
    first = _outcome(lambda: cli.generate(np.arange(4, dtype=np.int32),
                                          max_new_tokens=2))
    states = [router._replicas["r0"].breaker,
              "r0" in router.replica_ids(healthy_only=True)]
    s.replica(port=port)
    _wait_for(lambda: router._replicas["r0"].breaker == "closed",
              msg="probe re-close")
    cli2 = s.client(router.port)
    out = cli2.generate(np.arange(4, dtype=np.int32),
                        max_new_tokens=3).tolist()
    cli2.close()
    cli.close()
    c = s.delta("router.breaker_open", "router.breaker_close")
    return {"first": first[:2], "states": states, "tokens": out,
            "opened": c["router.breaker_open"] >= 1,
            "closed": c["router.breaker_close"] >= 1}


def test_breaker_opens_half_opens_closes(models):
    rec = both(models, sc_breaker_walk)["torch"]
    assert rec == {"first": ("err", "RuntimeError"),
                   "states": ["open", False],
                   "tokens": _ref(models, np.arange(4), 3),
                   "opened": True, "closed": True}


def sc_probe_opens(s):
    s0 = s.replica()
    router = s.router(replicas={"r0": ep(s0)}, connect_deadline_s=0.3,
                      poll_interval_s=0.1, breaker_threshold=2,
                      evict_cooldown_s=60.0)
    _wait_for(lambda: router._replicas["r0"].probe_at > 0,
              msg="first probe")
    _stop_server(s0)                   # dies with no traffic
    _wait_for(lambda: router._replicas["r0"].breaker == "open",
              msg="probe-driven breaker open")
    return {"healthy": router.replica_ids(healthy_only=True),
            "requests": s.delta("router.requests")}


def test_probe_failures_open_breaker_without_traffic(models):
    rec = both(models, sc_probe_opens)["torch"]
    assert rec == {"healthy": [], "requests": {"router.requests": 0}}


def sc_disconnect_chain(s):
    s0 = s.replica(prefix_cache=False)
    router = s.router(replicas={"r0": ep(s0)})
    base = s.counter("serve.disconnect_cancels")
    with s.faults.scoped("engine.step_delay", times=-1, delay_s=0.02):
        sock = socket.create_connection(("127.0.0.1", router.port),
                                        timeout=10)
        sock.sendall(struct.pack("<I", s.serve.MAGIC)
                     + s.serve.auth_token(FRONT))
        sock.sendall(struct.pack("<III", s.serve.MAGIC,
                                 s.serve.OP_GENERATE, 2))
        s.serve.send_arrays(sock, [np.arange(6, dtype=np.int32),
                                   np.asarray([50], np.int32)])
        _wait_for(lambda: s0._engine._occupied(), msg="request admitted")
        sock.close()                   # the client walks away mid-route
        _wait_for(lambda: s.counter("serve.disconnect_cancels") > base,
                  msg="cross-tier disconnect cancel")
    _wait_for(lambda: not s0._engine._has_work(), msg="engine quiesce")
    return {"counters": s.delta("serve.disconnect_cancels",
                                "router.disconnect_drops",
                                "engine.cancelled"),
            "baseline": _baseline(s0._engine)}


def test_client_disconnect_propagates_through_router(models):
    rec = both(models, sc_disconnect_chain)["torch"]
    assert rec == {"counters": {"serve.disconnect_cancels": 1,
                                "router.disconnect_drops": 1,
                                "engine.cancelled": 1},
                   "baseline": True}


def sc_cancel_broadcast(s):
    s0 = s.replica(prefix_cache=False)
    router = s.router(replicas={"r0": ep(s0)})
    res = {}
    with s.faults.scoped("engine.step_delay", times=-1, delay_s=0.02):
        def gen():
            cli = s.client(router.port)
            res["out"] = _outcome(lambda: cli.generate(
                np.arange(6, dtype=np.int32), max_new_tokens=50,
                tag="routed-tag"))
            cli.close()
        t = threading.Thread(target=gen, daemon=True)
        t.start()
        _wait_for(lambda: s0._engine._occupied(), msg="request admitted")
        cli2 = s.client(router.port)
        hit = cli2.cancel("routed-tag")
        cli2.close()
        t.join(timeout=60)
        alive = t.is_alive()
    _wait_for(lambda: not s0._engine._has_work(), msg="engine quiesce")
    return {"hit": hit, "hung": alive, "outcome": res.get("out"),
            "counters": s.delta("router.cancels", "serve.cancels"),
            "baseline": _baseline(s0._engine)}


def test_cancel_broadcast_through_router(models):
    rec = both(models, sc_cancel_broadcast)["torch"]
    assert rec["hit"] is True and not rec["hung"] and rec["baseline"]
    assert rec["outcome"][:2] == ("err", "Cancelled")
    assert rec["counters"] == {"router.cancels": 1, "serve.cancels": 1}


# ------------------------------------- several replicas in one process


def test_a_capture_counts_in_its_own_thread_only():
    """While one thread is inside `registry.capturing` (a replica capturing
    a step graph), the launches and dispatches another thread makes (a
    second replica of the process serving) still count; the capturing
    thread's count in its own tally only, which a replay adds later."""
    import torch

    from paddle_tpu_torch.kernels import _build, registry
    from paddle_tpu_torch.kernels.cuda import paged_attention  # noqa: F401
    k = _build.kernels()[0]
    saved = (k._fn, k.launches)
    k._fn = lambda *a: 0          # a launch that always succeeds
    name = "kernel.dispatch.paged_attention.plain"
    try:
        k.launches = 0
        c0 = registry.counts().get(name, 0)
        m0 = tmetrics.snapshot()["counters"].get(name, 0)
        inside, go, box = threading.Event(), threading.Event(), {}

        def capturer():
            with registry.capturing() as cap:
                k.launch()
                registry.dispatch("paged_attention", torch.zeros(1))
                inside.set()
                go.wait(10)
                k.launch()
            box["tally"], box["after"] = cap.tally, registry.tally()

        t = threading.Thread(target=capturer)
        t.start()
        assert inside.wait(10)
        k.launch()
        k.launch()
        registry.dispatch("paged_attention", torch.zeros(1))
        go.set()
        t.join(10)
        assert k.launches == 2
        assert box["tally"] == {"launches": {k: 2},
                                "dispatches": {name: 1}}
        assert box["after"] is None and registry.tally() is None
        assert registry.counts()[name] - c0 == 1
        assert tmetrics.snapshot()["counters"][name] - m0 == 1
    finally:
        k._fn, k.launches = saved


def test_each_capture_takes_its_own_tickets():
    """A graph's warm-up and capture runs (`registry.capturing`) take
    split-loop tickets of their own, numbered by `registry.capture_id`
    and kept for the graph's replays: another engine's graph warming up
    on the same capture stream meanwhile never shares them. Launches
    outside a capture share their stream's."""
    import torch

    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.kernels.cuda import paged_attention as cdec
    cpu = torch.device("cpu")
    plain = cdec._tickets(cpu, 8, 7)
    assert cdec._tickets(cpu, 8, 7, registry.capture_id()) is plain
    ids, tickets = [], []

    def capture():
        with registry.capturing() as cap:
            ids.append(cap.capture_id)
            tickets.append(cdec._tickets(cpu, 8, 7, registry.capture_id()))
            # the same graph's later launches find its tickets again
            assert cdec._tickets(cpu, 8, 7, registry.capture_id()) \
                is tickets[-1]

    ths = [threading.Thread(target=capture) for _ in range(3)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(10)
    capture()
    assert len(set(ids)) == 4 and None not in ids
    assert len({id(t) for t in tickets}) == 4
    assert all(t is not plain and int(t.abs().sum()) == 0 for t in tickets)
    assert registry.capture_id() is None


def sc_first_stats_pull(s):
    s0 = s.replica()
    # a STATS interval longer than this host's monotonic clock has run
    far = s.router(replicas={"r0": ep(s0)}, poll_interval_s=0.05,
                   stats_interval_s=time.monotonic() + 3600.0)
    near = s.router(replicas={"r0": ep(s0)}, poll_interval_s=0.05,
                    stats_interval_s=0.05)
    _wait_for(lambda: near._replicas["r0"].stats is not None,
              msg="the first STATS pull")
    time.sleep(0.3)
    return {"stats_at_starts": s.router_mod.ReplicaState("x", "h:1").stats_at,
            "far_pulled": far._replicas["r0"].stats is not None,
            "near_role": near._replicas["r0"].stats.get("role")}


def test_first_stats_pull_waits_for_the_monotonic_clock(models):
    """ROADMAP C13: a replica's STATS clock starts at 0.0, so a router
    pulls its first STATS only once the host's monotonic clock passes
    ``stats_interval_s``: on a host up for less than the interval the
    first pull waits. The port keeps the reference's behaviour."""
    rec = both(models, sc_first_stats_pull)["torch"]
    assert rec == {"stats_at_starts": 0.0, "far_pulled": False,
                   "near_role": "both"}
