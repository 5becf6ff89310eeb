"""The port's router in front of a fleet, held against the JAX package's
(`Side` and `both` of `tests/test_torch_router.py`: each scenario runs
once with the JAX package's routers, replicas and clients and once with
the port's; the records must be equal).

- `tests/test_disagg.py::TestPrefixDirectory` on each package's
  `PrefixDirectory`, and both directories through one sequence of
  registrations, replacements and invalidations giving equal lookups.
- `tests/test_disagg.py::TestDisaggFleet`: the two-phase route, the system
  prompt prefilled once fleet-wide through the directory's affinity, the
  mid-stream worker death (``serve.stream_drop``) and the
  ``router.stale_directory`` drill; a prefill worker and a decode replica
  of different packages behind either router.
- `tests/test_control_plane.py`: `TestRouterRoles` (router leases never
  in the rotation, clients discover routers, keyed placement equal across
  routers, a JAX router's and a port router's included),
  `TestExactlyOnce` through a router (``serve.ack_drop``),
  `TestRouterFailoverDrill` but its soak test (the ``router.crash``
  site).
- `tests/test_migration.py::TestWireMigration::
  test_routed_8_inflight_drain_zero_client_errors`.
- The router parts of `tests/test_fleet_observability.py`: the traced
  wire through a router (span chains, ack retry, two-phase and fallback),
  TRACE_EXPORT through a router and stitching, `Router.attach_fleet`.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu.observability.fleet as jfleet
import paddle_tpu.observability.tracing as jtracing
import paddle_tpu.serving.disagg as jdisagg
import paddle_tpu.serving.router as jrouter
import paddle_tpu_torch.observability.fleet as tfleet
import paddle_tpu_torch.observability.tracing as ttracing
import paddle_tpu_torch.serving.disagg as tdisagg
import paddle_tpu_torch.serving.router as trouter
from tests.test_torch_router import models  # noqa: F401 - the fixture
from tests.test_torch_router import (FLEET, FRONT, PKGS, Side, _baseline,
                                     _dead_port, _outcome, _ref, _wait_for,
                                     both, ep, stop_router)
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


KEY_A = bytes(range(16))
KEY_B = bytes(range(16, 32))


def _fleet_mod(s):
    return jfleet if s.jax else tfleet


def _tracing(s):
    return jtracing if s.jax else ttracing


# --------------------------------------------------------- prefix directory


@pytest.mark.parametrize("mod", [jdisagg, tdisagg], ids=PKGS)
def test_directory_longest_match_and_register(mod):
    d = mod.PrefixDirectory()
    h = [bytes([i]) * 16 for i in range(4)]
    d.register(h[:2], "p0")
    assert d.lookup(h) == ("p0", 2)
    d.register(h, "p1")              # a longer chain on another worker
    assert d.lookup(h) == ("p1", 4)
    assert d.lookup([b"z" * 16]) == (None, 0)


@pytest.mark.parametrize("mod", [jdisagg, tdisagg], ids=PKGS)
def test_directory_invalidate_and_replace(mod):
    d = mod.PrefixDirectory()
    h = [bytes([i]) * 16 for i in range(4)]
    d.register(h, "p0")
    d.replace("p0", h[:1])           # the store evicted pages 1..3
    assert d.lookup(h) == ("p0", 1)
    d.invalidate("p0")               # membership churn
    assert d.lookup(h) == (None, 0)
    assert len(d) == 0


@pytest.mark.parametrize("mod", [jdisagg, tdisagg], ids=PKGS)
def test_directory_bounded_lru(mod):
    d = mod.PrefixDirectory(capacity=3)
    hs = [bytes([i]) * 16 for i in range(5)]
    d.register(hs, "p0")
    assert len(d) == 3
    assert d.lookup(hs[:1]) == (None, 0)      # the oldest evicted
    assert d.lookup(hs) == ("p0", 5)


def _directory_trace(mod, seed):
    """One random sequence of directory operations over the prompts'
    page-hash chains; every lookup, spilled query and size along it."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 97, rng.randint(4, 40)).astype(np.int32)
               for _ in range(12)]
    chains = [mod.prompt_page_hashes(p, 4) for p in prompts]
    d = mod.PrefixDirectory(capacity=24)
    out = []
    for _ in range(200):
        op = rng.randint(4)
        c = chains[rng.randint(len(chains))]
        rid = f"p{rng.randint(3)}"
        if op == 0:
            d.register(c[:rng.randint(len(c) + 1)], rid)
        elif op == 1:
            keep = [h for h in c if rng.rand() < 0.7]
            d.replace(rid, keep, spilled=keep[:rng.randint(len(keep) + 1)])
        elif op == 2 and rng.rand() < 0.2:
            d.invalidate(rid)
        rid_hit, depth = d.lookup(c)
        out.append((rid_hit, depth, len(d), d.spilled_depth(rid),
                    depth > 0 and d.is_spilled(c[depth - 1], rid_hit)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_directories_give_equal_lookups(seed):
    assert _directory_trace(jdisagg, seed) == _directory_trace(tdisagg, seed)


# ------------------------------------------------------ disaggregated fleet


def _disagg_fleet(s, n_decode=1, **router_kw):
    pf = s.replica(role="prefill", prefill_chunk_tokens=4)
    dcs = [s.replica(role="decode") for _ in range(n_decode)]
    reps = {"prefill:p0": ep(pf)}
    reps.update({f"decode:d{i}": ep(d) for i, d in enumerate(dcs)})
    router_kw.setdefault("page_size", 4)
    return pf, dcs, s.router(replicas=reps, **router_kw)


def sc_two_phase(s, prompt):
    pf, dcs, router = _disagg_fleet(s)
    cli = s.client(router.port)
    out = cli.generate(prompt, max_new_tokens=6).tolist()
    no_prefill = not any(k[0] in ("prefill", "prefill_chunk")
                         for k in dcs[0]._engine._programs)
    # the deadline and the idempotency key ride the stream options
    out2 = cli.generate(prompt, max_new_tokens=6, deadline_s=30.0,
                        request_key=bytes(range(16))).tolist()
    cli.close()
    # a worker counts its stream after sending the last record
    _wait_for(lambda: s.delta("serve.prefill_streams")[
        "serve.prefill_streams"] >= 2, timeout=10, msg="stream counts")
    return {"tokens": [out, out2], "no_prefill_on_decode": no_prefill,
            "counters": s.delta("router.disagg_requests",
                                "router.disagg_fallbacks",
                                "serve.kv_stream_in", "serve.prefill_streams",
                                "router.replica_requests{replica=decode:d0}")}


def test_two_phase_token_identical_with_no_retrace_pin(models):
    prompt = (np.arange(11) % 60).astype(np.int32)
    rec = both(models, sc_two_phase, prompt=prompt)["torch"]
    assert rec["tokens"] == [_ref(models, prompt, 6)] * 2
    assert rec["no_prefill_on_decode"]
    assert rec["counters"] == {
        "router.disagg_requests": 2, "router.disagg_fallbacks": 0,
        "serve.kv_stream_in": 2, "serve.prefill_streams": 2,
        "router.replica_requests{replica=decode:d0}": 2}


def sc_shared_prefix(s, sys_prompt, tails):
    pf, dcs, router = _disagg_fleet(s, n_decode=2)
    cli = s.client(router.port)
    toks = [cli.generate(np.concatenate([sys_prompt, t]),
                         max_new_tokens=4).tolist() for t in tails]
    cli.close()
    return {"tokens": toks,
            "counters": s.delta("engine.prefill_tokens",
                                "router.affinity_hits",
                                "router.affinity_misses",
                                "router.disagg_requests")}


def test_shared_prefix_prefilled_once_fleet_wide(models):
    """A 2-page system prompt shared by 8 requests is prefilled once
    across the fleet: the first request pays 12 tokens, the other seven
    only their 4-token tails."""
    sys_prompt = (np.arange(8) % 60).astype(np.int32)
    tails = [(np.arange(4) + 10 * i).astype(np.int32) % 90 for i in range(8)]
    rec = both(models, sc_shared_prefix, sys_prompt=sys_prompt,
               tails=tails)["torch"]
    assert rec["tokens"] == [_ref(models, np.concatenate([sys_prompt, t]), 4)
                             for t in tails]
    assert rec["counters"] == {"engine.prefill_tokens": 12 + 7 * 4,
                               "router.affinity_hits": 7,
                               "router.affinity_misses": 1,
                               "router.disagg_requests": 8}


def sc_midstream_death(s, prompt):
    pf, dcs, router = _disagg_fleet(s)
    cli = s.client(router.port)
    baseline = dcs[0]._engine.allocator.free_pages
    fired = s.faults.fired("serve.stream_drop")
    with s.faults.scoped("serve.stream_drop", times=1):
        outs = [cli.generate(prompt, max_new_tokens=6).tolist()
                for _ in range(4)]
    cli.close()
    _wait_for(lambda: not dcs[0]._engine._has_work(), msg="decode idle")
    return {"tokens": outs,
            "fired": s.faults.fired("serve.stream_drop") - fired,
            "pool": dcs[0]._engine.allocator.free_pages == baseline,
            "counters": s.delta("router.disagg_fallbacks",
                                "router.stream_aborts",
                                "serve.stream_drops")}


@pytest.mark.chaos
def test_midstream_worker_death_falls_back_zero_errors(models):
    prompt = (np.arange(11) % 60).astype(np.int32)
    rec = both(models, sc_midstream_death, prompt=prompt)["torch"]
    assert rec["tokens"] == [_ref(models, prompt, 6)] * 4
    assert rec["fired"] == 1 and rec["pool"]
    assert rec["counters"]["router.disagg_fallbacks"] == 1
    assert rec["counters"]["router.stream_aborts"] == 1


def sc_stale_directory(s, prompt):
    pf, dcs, router = _disagg_fleet(s)
    cli = s.client(router.port)
    fired = s.faults.fired("router.stale_directory")
    with s.faults.scoped("router.stale_directory", times=1):
        out = cli.generate(prompt, max_new_tokens=5).tolist()
    cli.close()
    return {"tokens": out,
            "fired": s.faults.fired("router.stale_directory") - fired == 1,
            "counters": s.delta("router.stale_affinity",
                                "router.affinity_hits",
                                "router.disagg_requests")}


@pytest.mark.chaos
def test_stale_directory_drill_still_completes(models):
    prompt = (np.arange(9) % 60).astype(np.int32)
    rec = both(models, sc_stale_directory, prompt=prompt)["torch"]
    assert rec == {"tokens": _ref(models, prompt, 5), "fired": True,
                   "counters": {"router.stale_affinity": 1,
                                "router.affinity_hits": 1,
                                "router.disagg_requests": 1}}


@pytest.mark.parametrize("router_pkg,pre_pkg,dec_pkg", [
    ("torch", "jax", "torch"), ("torch", "torch", "jax"),
    ("jax", "torch", "jax"), ("jax", "jax", "torch")],
    ids=["port_router_jax_prefill", "port_router_jax_decode",
         "jax_router_port_prefill", "jax_router_port_decode"])
def test_disagg_across_packages(models, router_pkg, pre_pkg, dec_pkg):
    """A prefill worker of one package relays its records through either
    router to a decode replica of the other: the two-phase route, tokens
    equal, the directory's affinity on the second request."""
    sides = {p: Side(p, models) for p in PKGS}
    try:
        pf = sides[pre_pkg].replica(role="prefill", prefill_chunk_tokens=4)
        dc = sides[dec_pkg].replica(role="decode")
        rs = sides[router_pkg]
        router = rs.router(replicas={"prefill:p0": ep(pf),
                                     "decode:d0": ep(dc)}, page_size=4)
        cli = rs.client(router.port)
        prompts = [(np.arange(11) % 60).astype(np.int32),
                   (np.arange(13) % 60).astype(np.int32)]
        outs = [cli.generate(p, max_new_tokens=6).tolist() for p in prompts]
        cli.close()
        assert outs == [_ref(models, p, 6) for p in prompts]
        assert rs.delta("router.disagg_requests", "router.disagg_fallbacks",
                        "router.affinity_hits") \
            == {"router.disagg_requests": 2, "router.disagg_fallbacks": 0,
                "router.affinity_hits": 1}
        assert not any(k[0] in ("prefill", "prefill_chunk")
                       for k in dc._engine._programs)
    finally:
        for s in sides.values():
            s.close()


# ------------------------------------------------------------ router roles


def sc_router_lease(s, tmp):
    reg_dir = str(tmp / s.name)
    el = s.elastic
    roles = [el.node_role(el.router_node_id("x")), el.node_role("replica-1"),
             el.node_role("legacy-id")]
    s0 = s.replica()
    reg_rep = el.NodeRegistry(reg_dir, "r0", ep(s0), ttl=30.0,
                              heartbeat_interval=0.1).register()
    router = s.router(registry=el.NodeRegistry(reg_dir), poll_interval_s=0.05)
    lease = el.NodeRegistry(reg_dir, el.router_node_id("ra"),
                            ep(router), ttl=30.0,
                            heartbeat_interval=0.1).register()
    router.attach_registry(lease)
    _wait_for(lambda: "r0" in router.replica_ids(), msg="r0 join")
    time.sleep(0.2)           # a few poll cycles with both leases live
    ids = router.replica_ids()
    s0.attach_registry(reg_rep)
    peers = s0._discover_peers()
    stop_router(router)
    _wait_for(lambda: el.router_node_id("ra") not in
              el.NodeRegistry(reg_dir).alive_nodes(),
              msg="router lease removal")
    reg_rep.leave()
    return {"roles": roles, "ids": ids, "peers": peers}


def test_router_lease_never_enters_replica_rotation(models, tmp_path):
    rec = both(models, sc_router_lease, tmp=tmp_path)["torch"]
    assert rec == {"roles": ["router", "replica", "replica"], "ids": ["r0"],
                   "peers": []}


def sc_discover_routers(s, tmp):
    reg_dir = str(tmp / s.name)
    el = s.elastic
    s0 = s.replica()
    regs = [el.NodeRegistry(reg_dir, "r0", ep(s0), ttl=30.0,
                            heartbeat_interval=0.1).register()]
    router = s.router(registry=el.NodeRegistry(reg_dir), poll_interval_s=0.05)
    regs.append(el.NodeRegistry(reg_dir, el.router_node_id("ra"), ep(router),
                                ttl=30.0, heartbeat_interval=0.1).register())
    _wait_for(lambda: "r0" in router.replica_ids(), msg="r0 join")
    cli = s.serve.RemotePredictor(registry_dir=reg_dir, secret=FRONT)
    found = cli._endpoints == [("127.0.0.1", router.port)]
    out = cli.generate(np.arange(5, dtype=np.int32),
                       max_new_tokens=4).tolist()
    cli.close()
    for reg in regs:
        reg.leave()
    return {"found_router_only": found, "tokens": out}


def test_client_discovers_routers_from_registry(models, tmp_path):
    rec = both(models, sc_discover_routers, tmp=tmp_path)["torch"]
    assert rec == {"found_router_only": True,
                   "tokens": _ref(models, np.arange(5), 4)}


def _bare_router(mod, reps):
    r = mod.Router.__new__(mod.Router)
    r._rlock = threading.Lock()
    r._rr = -1
    r._policy = "round_robin"
    r._replicas = {k: mod.ReplicaState(k, v) for k, v in reps.items()}
    return r


def _keyed_picks(r):
    out = []
    for key in (KEY_A, KEY_B, b"\x00" * 16) + tuple(
            bytes([i]) * 16 for i in range(16)):
        first = r._pick(set(), key=key).replica_id
        out.append((first, r._pick({first}, key=key).replica_id))
    return out


def test_keyed_placement_is_identical_across_routers():
    """Rendezvous hashing: every router, of either package, picks the same
    replica for a key, and the same one after it when the first is out."""
    reps = {f"r{i}": f"h:{i}" for i in range(4)}
    picks = [_keyed_picks(_bare_router(mod, reps))
             for mod in (jrouter, jrouter, trouter, trouter)]
    assert picks[0] == picks[1] == picks[2] == picks[3]
    assert len({p for p, _ in picks[2]}) > 1          # keys spread
    assert [jrouter.Router._request_key([0, 0, np.asarray(
        [1, 1, 0, *np.frombuffer(KEY_A, np.int32)], np.int32)])] \
        == [trouter.Router._request_key([0, 0, np.asarray(
            [1, 1, 0, *np.frombuffer(KEY_A, np.int32)], np.int32)])] \
        == [KEY_A]


# ------------------------------------------------------------ exactly once


def sc_ack_drop_routed(s, prompt):
    srv = s.replica(max_slots=4)
    router = s.router(replicas={"r0": ep(srv)})
    cli = s.serve.RemotePredictor(endpoints=[ep(router)], secret=FRONT)
    with s.faults.scoped("serve.ack_drop", times=1):
        out = cli.generate(prompt, max_new_tokens=6).tolist()
    cli.close()
    return {"tokens": out,
            "healthy": router.replica_ids(healthy_only=True),
            "counters": s.delta("engine.requests", "router.ack_retries",
                                "engine.dedup_replays", "router.resubmits")}


def test_ack_drop_through_router_retries_same_replica(models):
    prompt = np.arange(5, dtype=np.int32)
    rec = both(models, sc_ack_drop_routed, prompt=prompt)["torch"]
    assert rec == {"tokens": _ref(models, prompt, 6), "healthy": ["r0"],
                   "counters": {"engine.requests": 1,
                                "router.ack_retries": 1,
                                "engine.dedup_replays": 1,
                                "router.resubmits": 0}}


# ------------------------------------------------------ router failover


def sc_kill_active_router(s):
    s0, s1 = s.replica(max_slots=8), s.replica(max_slots=8)
    reps = {"r0": ep(s0), "r1": ep(s1)}
    ra, rb = s.router(replicas=reps), s.router(replicas=reps)
    outs, errs = {}, []

    def one(i, prompt):
        try:
            cli = s.serve.RemotePredictor(endpoints=[ep(ra), ep(rb)],
                                          secret=FRONT)
            outs[i] = cli.generate(prompt, max_new_tokens=8).tolist()
            cli.close()
        except Exception as e:  # noqa: BLE001 - recorded
            errs.append((i, repr(e)))

    base = s.delta("engine.requests", "engine.dedup_hits",
                   "engine.dedup_replays", "router.failovers")
    s.faults.arm("engine.step_delay", times=-1, delay_s=0.05)
    ths = [threading.Thread(target=one, args=(
        i, (np.arange(4 + i) % 97).astype(np.int32))) for i in range(8)]
    for t in ths:
        t.start()
    _wait_for(lambda: sum(1 for r in (s0._engine._slot_req
                                      + s1._engine._slot_req)
                          if r is not None) >= 4, msg="requests in flight")
    ra.stop(hard=True)               # the active router dies
    for t in ths:
        t.join(timeout=120)
        assert not t.is_alive()
    s.faults.disarm("engine.step_delay")
    now = s.delta("engine.requests", "engine.dedup_hits",
                  "engine.dedup_replays", "router.failovers")
    d = {k: now[k] - base[k] for k in now}
    return {"tokens": [outs.get(i) for i in range(8)], "errors": errs,
            "executions": d["engine.requests"],
            "failovers_ge_8": d["router.failovers"] >= 8,
            "dedup_ge_8": d["engine.dedup_hits"]
            + d["engine.dedup_replays"] >= 8}


def test_kill_active_router_with_8_in_flight(models):
    rec = both(models, sc_kill_active_router)["torch"]
    assert rec["errors"] == []
    assert rec["tokens"] == [_ref(models, np.arange(4 + i) % 97, 8)
                             for i in range(8)]
    assert rec["executions"] == 8
    assert rec["failovers_ge_8"] and rec["dedup_ge_8"]


def sc_cancel_other_router(s, broadcast):
    srv = s.replica()
    reps = {"r0": ep(srv)}
    ra, rb = s.router(replicas=reps), s.router(replicas=reps)
    res = {}

    def gen():
        cli = s.client(ra.port)
        res["out"] = _outcome(lambda: cli.generate(
            np.arange(5, dtype=np.int32), max_new_tokens=48, tag=b"cp-tag"))
        cli.close()

    s.faults.arm("engine.step_delay", times=-1, delay_s=0.05)
    t = threading.Thread(target=gen)
    t.start()
    _wait_for(lambda: srv._tags, msg="tag registration on the replica")
    if broadcast:
        # the multi-endpoint client's own cancel fans out even when its
        # current endpoint is the standby
        canceller = s.serve.RemotePredictor(endpoints=[ep(rb), ep(ra)],
                                            secret=FRONT)
    else:
        canceller = s.client(rb.port)
    hit = canceller.cancel(b"cp-tag")
    canceller.close()
    t.join(timeout=60)
    s.faults.disarm("engine.step_delay")
    return {"hit": hit, "outcome": res["out"][:2]}


@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["through_router_b", "client_broadcast"])
def test_cancel_lands_through_a_different_router(models, broadcast):
    rec = both(models, sc_cancel_other_router, broadcast=broadcast)["torch"]
    assert rec == {"hit": True, "outcome": ("err", "Cancelled")}


def sc_connect_failover(s):
    srv = s.replica()
    cli = s.serve.RemotePredictor(
        endpoints=[f"127.0.0.1:{_dead_port()}", ep(srv)], secret=FLEET,
        connect_retries=1, retry_deadline_s=2.0)
    out = cli.generate(np.arange(4, dtype=np.int32),
                       max_new_tokens=4).tolist()
    cli.close()
    return out


def test_connect_failover_rotates_past_dead_endpoint(models):
    rec = both(models, sc_connect_failover)["torch"]
    assert rec == _ref(models, np.arange(4), 4)


def sc_router_crash(s):
    srv = s.replica()
    reps = {"r0": ep(srv)}
    ra, rb = s.router(replicas=reps), s.router(replicas=reps)
    cli = s.serve.RemotePredictor(endpoints=[ep(ra), ep(rb)], secret=FRONT)
    fired = s.faults.fired("router.crash")
    with s.faults.scoped("router.crash", times=1):
        out = cli.generate(np.arange(6, dtype=np.int32),
                           max_new_tokens=6).tolist()
    cli.close()
    return {"tokens": out, "a_stopped": ra._stop.is_set(),
            "b_stopped": rb._stop.is_set(),
            "fired": s.faults.fired("router.crash") - fired,
            "counters": s.delta("engine.requests", "engine.dedup_hits",
                                "router.failovers",
                                "router.replica_requests{replica=r0}")}


def test_router_crash_fault_site(models):
    """``router.crash``: the router dies at request accept, the request is
    never forwarded, and the client completes through the standby."""
    rec = both(models, sc_router_crash)["torch"]
    assert rec["tokens"] == _ref(models, np.arange(6), 6)
    assert rec["a_stopped"] and not rec["b_stopped"]
    assert rec["fired"] == 1
    assert rec["counters"] == {"engine.requests": 1, "engine.dedup_hits": 0,
                               "router.failovers": 1,
                               "router.replica_requests{replica=r0}": 1}


# ------------------------------------------------ tests/test_migration.py


def sc_routed_drain(s, prompts):
    a, b = s.replica(max_slots=8), s.replica(max_slots=8)
    router = s.router(replicas={"a": ep(a)}, evict_cooldown_s=600.0)
    outs, errs = {}, []

    def client(i):
        try:
            cli = s.client(router.port)
            outs[i] = cli.generate(prompts[i], max_new_tokens=40).tolist()
            cli.close()
        except Exception as e:  # noqa: BLE001 - recorded
            errs.append((i, f"{type(e).__name__}: {e}"))

    ths = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in ths:
        t.start()
    with s.faults.scoped("engine.step_delay", times=-1, delay_s=0.01):
        _wait_for(lambda: sum(
            1 for r in a._engine._slot_req
            if r is not None and len(r.generated) >= 2) == 8,
            msg="8 requests mid-decode on the victim")
        clean = a.drain(deadline_s=60.0, migrate_peers=[ep(b)])
    for t in ths:
        t.join(timeout=120)
        assert not t.is_alive()
    return {"tokens": [outs.get(i) for i in range(8)], "errors": errs,
            "clean": clean, "baseline": _baseline(a._engine),
            "counters": s.delta("serve.migrations_out", "serve.migrations_in",
                                "router.requests", "router.resubmits")}


@pytest.mark.chaos
def test_routed_8_inflight_drain_zero_client_errors(models):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 97, 4 + (i % 3)).astype(np.int32)
               for i in range(8)]
    rec = both(models, sc_routed_drain, prompts=prompts)["torch"]
    assert rec["errors"] == [] and rec["clean"] is True and rec["baseline"]
    assert rec["tokens"] == [_ref(models, p, 40) for p in prompts]
    assert rec["counters"] == {"serve.migrations_out": 8,
                               "serve.migrations_in": 8,
                               "router.requests": 8, "router.resubmits": 0}


# -------------------------------------------------- fleet observability


def _spans(s, tid):
    return s.metrics.spans_for_trace(tid)


def _by_name(s, tid, name):
    return [e for e in _spans(s, tid) if e["name"] == name]


def sc_reparent(s, prompt):
    srv = s.replica()
    router = s.router(replicas={"r0": ep(srv)})
    cli = s.client(router.port)
    tid, sc = _tracing(s).mint_trace()
    out = cli.generate(prompt, max_new_tokens=6, trace_id=tid,
                       parent_span=sc).tolist()
    cli.close()
    (fwd,) = _by_name(s, tid, "router.forward")
    reqs = [e for e in _spans(s, tid) if e["name"].startswith("request.")]
    return {"tokens": out, "fwd_parent_is_client": fwd["args"]["parent"] == sc,
            "fwd_span_new": bool(fwd["args"]["span"])
            and fwd["args"]["span"] != sc,
            "replica_under_router": bool(reqs) and {
                e["args"]["parent"] for e in reqs} == {fwd["args"]["span"]}}


def test_router_reparents_span_chain(models):
    prompt = np.arange(3, 9, dtype=np.int32)
    rec = both(models, sc_reparent, prompt=prompt)["torch"]
    assert rec == {"tokens": _ref(models, prompt, 6),
                   "fwd_parent_is_client": True, "fwd_span_new": True,
                   "replica_under_router": True}


def sc_ack_retry_traced(s, prompt):
    srv = s.replica()
    router = s.router(replicas={"r0": ep(srv)})
    cli = s.client(router.port)
    tid, sc = _tracing(s).mint_trace()
    with s.faults.scoped("serve.ack_drop", times=1):
        out = cli.generate(prompt, max_new_tokens=6,
                           request_key=bytes(range(16)), trace_id=tid,
                           parent_span=sc).tolist()
    cli.close()
    evs = _spans(s, tid)
    (fwd,) = _by_name(s, tid, "router.forward")
    reqs = [e for e in evs if e["name"].startswith("request.")]
    return {"tokens": out, "one_trace": all(
        e["args"]["trace_id"] == tid for e in evs),
        "under_router": bool(reqs) and {e["args"]["parent"] for e in reqs}
        == {fwd["args"]["span"]},
        "counters": s.delta("router.ack_retries")}


def test_ack_retry_replays_traced_keyed_request(models):
    prompt = np.arange(5, 11, dtype=np.int32)
    rec = both(models, sc_ack_retry_traced, prompt=prompt)["torch"]
    assert rec == {"tokens": _ref(models, prompt, 6), "one_trace": True,
                   "under_router": True,
                   "counters": {"router.ack_retries": 1}}


def sc_disagg_traced(s, prompt, drop):
    pf, dcs, router = _disagg_fleet(s)
    cli = s.client(router.port)
    tid, sc = _tracing(s).mint_trace()
    with s.faults.scoped("serve.stream_drop", times=drop):
        out = cli.generate(prompt, max_new_tokens=6, trace_id=tid,
                           parent_span=sc).tolist()
    cli.close()
    # the prefill replica's engine thread ends its export (and lands its
    # span) on its own time, after a dropped stream's fallback answer too
    _wait_for(lambda: _by_name(s, tid, "engine.prefill_stream"),
              timeout=10, msg="the prefill export")
    evs = _spans(s, tid)
    (fwd,) = _by_name(s, tid, "router.forward")
    rspan = fwd["args"]["span"]
    reqs = [e for e in evs if e["name"].startswith("request.")]
    rec = {"tokens": out,
           "one_trace": all(e["args"]["trace_id"] == tid for e in evs),
           "names": sorted({"client.generate", "router.forward",
                            "engine.prefill_stream", "request.e2e"}
                           & {e["name"] for e in evs}),
           "requests_under_router": {e["args"]["parent"]
                                     for e in reqs} == {rspan},
           "e2e": len(_by_name(s, tid, "request.e2e")),
           "counters": s.delta("router.disagg_requests",
                               "router.disagg_fallbacks")}
    if not drop:
        (pstream,) = _by_name(s, tid, "engine.prefill_stream")
        rec["stream_under_router"] = pstream["args"]["parent"] == rspan
    return rec


@pytest.mark.parametrize("drop", [0, 1], ids=["two_phase", "fallback"])
def test_disagg_spans_share_one_trace(models, drop):
    """Both tiers' spans are children of the router hop under the one
    minted trace id; after a mid-stream drop the symmetric fallback keeps
    the context."""
    prompt = (np.arange(11) % 60).astype(np.int32)
    rec = both(models, sc_disagg_traced, prompt=prompt, drop=drop)["torch"]
    assert rec["tokens"] == _ref(models, prompt, 6)
    assert rec["one_trace"] and rec["requests_under_router"]
    assert rec["e2e"] == 1
    assert rec["counters"] == {"router.disagg_requests": 1,
                               "router.disagg_fallbacks": drop}
    if not drop:
        assert rec["stream_under_router"]
        assert rec["names"] == ["client.generate", "engine.prefill_stream",
                                "request.e2e", "router.forward"]


def sc_trace_export(s):
    srv = s.replica()
    router = s.router(replicas={"r0": ep(srv)})
    cli = s.client(router.port)
    tid, sc = _tracing(s).mint_trace()
    cli.generate(np.arange(2, 8, dtype=np.int32), max_new_tokens=4,
                 trace_id=tid, parent_span=sc)
    body = cli.trace_export(tid)       # through the ROUTER connection
    cli.close()
    col = _fleet_mod(s).TraceCollector({"router:t": ep(router)},
                                       secret=FRONT)
    trace = col.collect(tid)
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    metas = [e for e in trace["traceEvents"] if e.get("ph") == "M"]
    return {"router_span": "router.forward" in {e["name"]
                                                for e in body["spans"]},
            "rebased": bool(xs) and min(e["ts"] for e in xs) == 0.0,
            "one_trace": all(e["args"]["trace_id"] == tid for e in xs),
            "meta": bool(metas) and metas[0]["name"] == "process_name"}


def test_trace_export_via_router_and_stitch(models):
    rec = both(models, sc_trace_export)["torch"]
    assert rec == {"router_span": True, "rebased": True, "one_trace": True,
                   "meta": True}


def sc_attach_fleet(s):
    srv = s.replica()
    fm = _fleet_mod(s).FleetMetrics()
    router = s.router(replicas={"r0": ep(srv)}, stats_interval_s=0.1,
                      poll_interval_s=0.1)
    assert router.attach_fleet(fm) is router
    cli = s.client(router.port)
    cli.generate(np.arange(2, 7, dtype=np.int32), max_new_tokens=4)
    cli.close()
    _wait_for(lambda: (fm.snapshot_for(ep(srv)) or {}).get(
        "counters", {}).get("serve.requests", 0) >= 1,
        msg="the router's poll to feed the fleet plane")
    mem = fm.members()["r0"]
    return {"role": mem["role"], "endpoint_ok": mem["endpoint"] == ep(srv),
            "unknown": fm.snapshot_for("127.0.0.1:9"),
            "stats_role": fm.snapshot_for(ep(srv)).get("role")}


def test_router_poll_feeds_fleet_plane(models):
    rec = both(models, sc_attach_fleet)["torch"]
    assert rec == {"role": "both", "endpoint_ok": True, "unknown": None,
                   "stats_role": "both"}
