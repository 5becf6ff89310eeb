"""The port's autoscaler (`paddle_tpu_torch/serving/autoscale.py`) held
against the JAX package's (`paddle_tpu/serving/autoscale.py`), every
scenario of `tests/test_autoscale.py` and the autoscaler's part of
`tests/test_fleet_observability.py`.

The policy is pure bookkeeping: each decision sequence runs through a JAX
and a port `Autoscaler` on the same synthetic signals and must give the
same decisions. The scaling actions run over real routers and in-process
replicas through `Side` / `both` of `tests/test_torch_router.py` (a JAX
router, replicas and launcher, then the port's): decisions, rotations,
``autoscaler.*`` counter deltas, tokens and client errors must be equal.
`tick()` is driven by hand, as the JAX tests drive it.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu.observability.fleet as jfleet
import paddle_tpu.serving.autoscale as jauto
import paddle_tpu_torch.observability.fleet as tfleet
import paddle_tpu_torch.serving.autoscale as tauto
from tests.test_torch_router import models  # noqa: F401 - the fixture
from tests.test_torch_router import (FLEET, FRONT, PKGS, Side, _ref, both,
                                     ep)
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


pytestmark = pytest.mark.chaos

AUTOSCALE = {"jax": jauto, "torch": tauto}


class _NullRouter:
    """decide() is pure; observe and act never run in the policy tests."""

    def replica_view(self):
        return []


def _scaler(mod, policy, **kw):
    kw.setdefault("stats_fn", lambda ep: None)
    return mod.Autoscaler(_NullRouter(), mod.CallbackLauncher(
        lambda: None, lambda *a: True), policy, **kw)


SIG_IDLE = dict(n=2, outstanding=0, queue_depth=0, degradation=0,
                shed_delta=0)
SIG_HOT = dict(n=2, outstanding=20, queue_depth=8, degradation=0,
               shed_delta=0)

# each case: the policy's fields, then the signals fed to ONE scaler in
# order (a fresh scaler per list); `just_acted` marks the last action now
POLICY_CASES = {
    "hysteresis_needs_consecutive_votes": (
        dict(max_replicas=4, hysteresis_ticks=3, up_cooldown_s=0.0),
        [[SIG_HOT, SIG_HOT, SIG_HOT]]),
    "one_calm_tick_resets_the_votes": (
        dict(max_replicas=4, hysteresis_ticks=2, up_cooldown_s=0.0),
        [[SIG_HOT, SIG_IDLE, SIG_HOT, SIG_HOT]]),
    "cooldown_blocks_back_to_back_actions": (
        dict(max_replicas=4, hysteresis_ticks=1, up_cooldown_s=3600.0),
        [["just_acted", SIG_HOT]]),
    "clamped_at_max_and_min": (
        dict(min_replicas=1, max_replicas=2, hysteresis_ticks=1,
             up_cooldown_s=0.0, down_cooldown_s=0.0),
        [[dict(SIG_HOT, n=2), dict(SIG_IDLE, n=1)], [dict(SIG_HOT, n=1)]]),
    "shed_and_degradation_are_up_signals": (
        dict(max_replicas=4, hysteresis_ticks=1, up_cooldown_s=0.0),
        [[dict(SIG_IDLE, n=1, shed_delta=3)],
         [dict(SIG_IDLE, n=1, degradation=2)]]),
    "down_requires_fully_quiet_fleet": (
        dict(min_replicas=1, hysteresis_ticks=1, down_cooldown_s=0.0),
        [[dict(SIG_IDLE, queue_depth=1)], [dict(SIG_IDLE, shed_delta=1)],
         [dict(SIG_IDLE, degradation=1)], [dict(SIG_IDLE, outstanding=4)],
         [SIG_IDLE]]),
    "up_clamped_exactly_at_max": (
        dict(max_replicas=3, hysteresis_ticks=1, up_cooldown_s=0.0),
        [[dict(SIG_HOT, n=3), dict(SIG_HOT, n=2)]]),
    "breaker_open_replica_still_counts_toward_max": (
        dict(max_replicas=3, hysteresis_ticks=1, up_cooldown_s=0.0),
        [[dict(SIG_HOT, n=2, n_total=3), dict(SIG_HOT, n=2, n_total=2)]]),
    "down_clamp_protects_the_last_healthy_replica": (
        dict(min_replicas=1, hysteresis_ticks=1, down_cooldown_s=0.0),
        [[dict(SIG_IDLE, n=1, n_total=2), dict(SIG_IDLE, n=2, n_total=2)]]),
}
WANT = {
    "hysteresis_needs_consecutive_votes": [[None, None, "up"]],
    "one_calm_tick_resets_the_votes": [[None, None, None, "up"]],
    "cooldown_blocks_back_to_back_actions": [[None]],
    "clamped_at_max_and_min": [[None, None], ["up"]],
    "shed_and_degradation_are_up_signals": [["up"], ["up"]],
    # any movement vetoes the down; a shed burst even argues up
    "down_requires_fully_quiet_fleet": [[None], ["up"], [None], [None],
                                        ["down"]],
    "up_clamped_exactly_at_max": [[None, "up"]],
    "breaker_open_replica_still_counts_toward_max": [[None, "up"]],
    "down_clamp_protects_the_last_healthy_replica": [[None, "down"]],
}


def _decisions(mod, fields, runs):
    out = []
    for run in runs:
        s = _scaler(mod, mod.AutoscalePolicy(**fields))
        got = []
        for sig in run:
            if sig == "just_acted":
                s._last_action_t = time.monotonic()
                continue
            got.append(s.decide(dict(sig)))
        out.append(got)
    return out


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_decisions_equal(case):
    fields, runs = POLICY_CASES[case]
    recs = {p: _decisions(AUTOSCALE[p], fields, runs) for p in PKGS}
    assert recs["jax"] == recs["torch"] == WANT[case]


def test_policy_defaults_equal():
    import dataclasses
    assert dataclasses.asdict(jauto.AutoscalePolicy()) \
        == dataclasses.asdict(tauto.AutoscalePolicy())


# ------------------------------------------------------------ fake routers


class _Rows:
    """A router stand-in over fixed rotation rows; records removals."""

    def __init__(self, rows):
        self.rows = [dict(r) for r in rows]
        self.removed, self.added = [], []

    def replica_view(self):
        return [dict(r) for r in self.rows]

    def remove_static_replica(self, rid):
        self.removed.append(rid)
        self.rows = [r for r in self.rows if r["replica_id"] != rid]

    def add_static_replica(self, rid, endpoint):
        self.added.append((rid, endpoint))


def _pending_clamp(mod):
    s = mod.Autoscaler(_Rows([{"replica_id": "r0",
                               "endpoint": "127.0.0.1:9000",
                               "breaker": "closed", "outstanding": 20}]),
                       mod.CallbackLauncher(lambda: None, lambda *a: True),
                       mod.AutoscalePolicy(max_replicas=2,
                                           hysteresis_ticks=1,
                                           up_cooldown_s=0.0),
                       stats_fn=lambda ep: None)
    s._owned["as-1"] = "127.0.0.1:9001"
    s._pending_drain["as-1"] = "127.0.0.1:9001"
    sig = s.observe()
    return sig, s.decide(sig)


def test_pending_drain_counts_toward_the_max_clamp():
    recs = {p: _pending_clamp(AUTOSCALE[p]) for p in PKGS}
    assert recs["jax"] == recs["torch"]
    sig, decision = recs["torch"]
    assert sig["n"] == 1 and sig["n_total"] == 2 and decision is None


def _down_guard(mod):
    drained = []
    s = mod.Autoscaler(_Rows([
        {"replica_id": "as-1", "endpoint": "127.0.0.1:9000",
         "breaker": "closed", "outstanding": 0},
        {"replica_id": "r-dead", "endpoint": "127.0.0.1:9001",
         "breaker": "open", "outstanding": 0}]),
        mod.CallbackLauncher(lambda: None,
                             lambda *a: drained.append(a) or True),
        mod.AutoscalePolicy(min_replicas=1), stats_fn=lambda ep: None)
    s._owned["as-1"] = "127.0.0.1:9000"
    return s.scale_down(), drained


def test_scale_down_guard_counts_healthy_not_total():
    recs = {p: _down_guard(AUTOSCALE[p]) for p in PKGS}
    assert recs["jax"] == recs["torch"] == (None, [])


def _up_clamp(mod):
    spawned = []
    rows = _Rows([{"replica_id": "r0", "endpoint": "e0",
                   "breaker": "closed", "outstanding": 0}])
    s = mod.Autoscaler(rows, mod.CallbackLauncher(
        lambda: spawned.append(1) or ("as-1", "e1"), lambda *a: True),
        mod.AutoscalePolicy(max_replicas=2), stats_fn=lambda ep: None)
    s._pending_drain["as-0"] = "e9"        # still paid for
    first = s.scale_up()
    n0 = len(spawned)
    s._pending_drain.clear()
    return first, n0, s.scale_up(), len(spawned), rows.added


def test_scale_up_clamped_at_max_even_called_directly():
    recs = {p: _up_clamp(AUTOSCALE[p]) for p in PKGS}
    assert recs["jax"] == recs["torch"] \
        == (None, 0, "as-1", 1, [("as-1", "e1")])


def _reap(mod):
    drained = []
    # mid-range load: neither the up nor the down signal fires, so the
    # only mover is the reap path
    fr = _Rows([{"replica_id": "r0", "endpoint": "e0", "breaker": "closed",
                 "outstanding": 2},
                {"replica_id": "as-1", "endpoint": "e1", "breaker": "open",
                 "outstanding": 0}])
    s = mod.Autoscaler(fr, mod.CallbackLauncher(
        lambda: None, lambda rid, ep, peers: drained.append(rid) or True),
        mod.AutoscalePolicy(reap_open_ticks=3), stats_fn=lambda ep: None)
    s._owned["as-1"] = "e1"
    s.tick()
    fr.rows[1]["breaker"] = "closed"         # a transient blip re-closes
    s.tick()
    trace = [(list(fr.removed), dict(s._open_streak))]
    fr.rows[1]["breaker"] = "open"           # now it is really dead
    for _ in range(3):
        trace.append(list(fr.removed))
        s.tick()
    return trace, fr.removed, drained, "as-1" in s._owned, \
        "as-1" in s._open_streak


def test_crashed_owned_replica_is_reaped_after_streak():
    recs = {p: _reap(AUTOSCALE[p]) for p in PKGS}
    assert recs["jax"] == recs["torch"]
    trace, removed, drained, owned, streak = recs["torch"]
    assert trace == [([], {}), [], [], []]
    assert removed == ["as-1"] and drained == ["as-1"]
    assert not owned and not streak


def _concurrent_observe(mod):
    rows = _Rows([{"replica_id": f"r{i}", "endpoint": f"127.0.0.1:{9000 + i}",
                   "breaker": "closed", "outstanding": 0} for i in range(3)])
    pulls = []

    def stats_fn(ep):
        pulls.append(threading.current_thread().name)
        time.sleep(0.2)
        return {"gauges": {}, "counters": {}}

    s = mod.Autoscaler(rows, mod.CallbackLauncher(
        lambda: None, lambda *a: True), stats_fn=stats_fn)
    t0 = time.monotonic()
    sig = s.observe()
    return sig, pulls, time.monotonic() - t0


@pytest.mark.parametrize("pkg", PKGS)
def test_observe_pulls_stats_concurrently(pkg):
    sig, pulls, wall = _concurrent_observe(AUTOSCALE[pkg])
    assert sig["n"] == 3 and len(pulls) == 3
    assert all(n == "pt-autoscale-stats" for n in pulls), pulls
    assert wall < 0.55, f"pulls ran serially ({wall:.2f}s for 3x0.2s)"


def _observe_via_fleet(mod, fleet_mod):
    rows = _Rows([{"replica_id": f"r{i}", "endpoint": f"127.0.0.1:{9000 + i}",
                   "breaker": "closed", "outstanding": 2} for i in range(2)])
    snaps = {f"127.0.0.1:{9000 + i}": {
        "counters": {"engine.shed": 3.0 * i},
        "gauges": {"engine.queue_depth": 5.0 + i,
                   "engine.degradation_level": float(i)},
        "histograms": {}} for i in range(2)}
    fm = fleet_mod.FleetMetrics()
    for i, (e, snap) in enumerate(sorted(snaps.items())):
        fm.ingest(f"r{i}", "both", e, snap)

    def scaler(**kw):
        return mod.Autoscaler(rows, mod.CallbackLauncher(
            lambda: None, lambda *a: True), mod.AutoscalePolicy(), **kw)
    direct = scaler(stats_fn=lambda e: snaps.get(e)).observe()
    shared = scaler(fleet=fm).observe()
    fm.drop("r1")             # a member the plane has not scraped
    dropped = scaler(fleet=fm).observe()
    try:
        scaler(stats_fn=lambda e: None, fleet=fm)
        refused = None
    except ValueError as e:
        refused = str(e)
    return direct, shared, dropped, refused


def test_autoscaler_observes_identically_via_fleet_snapshot():
    """The controller's observation through ``fleet=`` equals the one
    through a direct ``stats_fn``, in both packages."""
    recs = {"jax": _observe_via_fleet(jauto, jfleet),
            "torch": _observe_via_fleet(tauto, tfleet)}
    assert recs["jax"] == recs["torch"]
    direct, shared, dropped, refused = recs["torch"]
    assert direct == shared
    assert dropped["n"] == 2 and dropped["queue_depth"] == 5.0
    assert "stats_fn OR fleet" in refused


def test_next_replica_id_and_router_list():
    for mod in AUTOSCALE.values():
        with pytest.raises(ValueError, match="need >= 1 router"):
            mod.Autoscaler([], mod.CallbackLauncher(lambda: None,
                                                    lambda *a: True))
        a, b = _Rows([]), _Rows([])
        s = mod.Autoscaler([a, b], mod.CallbackLauncher(
            lambda: ("as-x", "e1"), lambda *a: True),
            mod.AutoscalePolicy(max_replicas=3), stats_fn=lambda e: None)
        assert [s.next_replica_id() for _ in range(2)] == ["as-1", "as-2"]
        assert s.next_replica_id("pool") == "pool-3"
        # spawn joins fan out to every router of the control plane
        assert s.scale_up() == "as-x"
        assert a.added == b.added == [("as-x", "e1")]


# ------------------------------------------------------- scaling actions


def _fleet(s):
    seed = s.replica()
    router = s.router(replicas={"r0": ep(seed)}, evict_cooldown_s=600.0)
    return seed, router


def _launcher(s, servers, holder, fail_first=False, deadline_s=10.0):
    fail = [fail_first]

    def spawn():
        srv = s.replica()
        rid = holder["scaler"].next_replica_id()
        servers[rid] = srv
        return rid, ep(srv)

    def drain(rid, endpoint, peers):
        if fail[0]:
            fail[0] = False
            raise TimeoutError("pod delete API timed out")
        return servers.pop(rid).drain(deadline_s=deadline_s,
                                      migrate_peers=peers)
    return s.autoscale.CallbackLauncher(spawn, drain)


def _scaler_on(s, router, launcher, holder, **policy):
    scaler = s.autoscale.Autoscaler(
        router, launcher, s.autoscale.AutoscalePolicy(**policy),
        stats_fn=lambda e: None)
    holder["scaler"] = scaler
    s.scalers.append(scaler)
    return scaler


def sc_scale_up_down(s):
    seed, router = _fleet(s)
    servers, holder = {}, {}
    scaler = _scaler_on(s, router, _launcher(s, servers, holder), holder,
                        max_replicas=2, hysteresis_ticks=1, up_cooldown_s=0.0,
                        down_cooldown_s=0.0)
    with router._rlock:
        router._replicas["r0"].outstanding = 8     # synthetic pressure
    up = scaler.tick()
    after_up = router.replica_ids(healthy_only=True)
    with router._rlock:
        router._replicas["r0"].outstanding = 0
    down = scaler.tick()
    return {"actions": [up, down], "after_up": after_up,
            "after_down": router.replica_ids(healthy_only=True),
            "left": sorted(servers),
            "counters": s.delta("autoscaler.scale_ups",
                                "autoscaler.scale_downs",
                                "autoscaler.ticks", "autoscaler.errors")}


def test_scale_up_adds_replica_to_rotation(models):
    rec = both(models, sc_scale_up_down)["torch"]
    assert rec == {"actions": ["up", "down"], "after_up": ["as-1", "r0"],
                   "after_down": ["r0"], "left": [],
                   "counters": {"autoscaler.scale_ups": 1,
                                "autoscaler.scale_downs": 1,
                                "autoscaler.ticks": 2,
                                "autoscaler.errors": 0}}


def sc_unowned(s):
    seed, router = _fleet(s)
    scaler = s.autoscale.Autoscaler(router, s.autoscale.CallbackLauncher(
        lambda: None, lambda *a: True), s.autoscale.AutoscalePolicy(
        min_replicas=0, hysteresis_ticks=1, down_cooldown_s=0.0),
        stats_fn=lambda e: None)
    s.scalers.append(scaler)
    return {"action": scaler.tick(), "ids": router.replica_ids()}


def test_scale_down_never_touches_unowned_replicas(models):
    rec = both(models, sc_unowned)["torch"]
    assert rec == {"action": None, "ids": ["r0"]}


def sc_failed_drain(s):
    seed, router = _fleet(s)
    servers, holder = {}, {}
    scaler = _scaler_on(s, router, _launcher(s, servers, holder,
                                             fail_first=True), holder,
                        max_replicas=2, hysteresis_ticks=1, up_cooldown_s=0.0,
                        down_cooldown_s=0.0)
    with router._rlock:
        router._replicas["r0"].outstanding = 8
    up = scaler.tick()
    with router._rlock:
        router._replicas["r0"].outstanding = 0
    c0 = s.delta("autoscaler.scale_downs", "autoscaler.errors")
    down = scaler.tick()                 # the rotation shrinks, the drain
    c1 = s.delta("autoscaler.scale_downs", "autoscaler.errors")
    parked = (sorted(scaler._pending_drain), sorted(scaler._owned),
              sorted(servers), router.replica_ids(healthy_only=True))
    scaler.tick()                        # the retry lands this time
    c2 = s.delta("autoscaler.scale_downs", "autoscaler.errors")
    return {"actions": [up, down], "parked": parked,
            "released": (sorted(scaler._pending_drain),
                         sorted(scaler._owned), sorted(servers)),
            "counts": [{k: c[k] - c0[k] for k in c} for c in (c1, c2)]}


def test_failed_drain_retries_until_released(models):
    rec = both(models, sc_failed_drain)["torch"]
    assert rec == {
        "actions": ["up", "down"],
        "parked": (["as-1"], ["as-1"], ["as-1"], ["r0"]),
        "released": ([], [], []),
        "counts": [{"autoscaler.scale_downs": 0, "autoscaler.errors": 1},
                   {"autoscaler.scale_downs": 1, "autoscaler.errors": 1}]}


def sc_scale_cycle(s, prompts, refs):
    seed, router = _fleet(s)
    servers, holder = {}, {}
    scaler = _scaler_on(s, router, _launcher(s, servers, holder,
                                             deadline_s=30.0), holder,
                        min_replicas=1, max_replicas=3,
                        up_outstanding_per_replica=1.0,
                        down_outstanding_per_replica=0.0,
                        hysteresis_ticks=1, up_cooldown_s=0.0,
                        down_cooldown_s=0.0)
    errs, wrong, stop_load = [], [], threading.Event()

    def client(i):
        try:
            cli = s.client(router.port, timeout=120.0)
            while not stop_load.is_set():
                out = cli.generate(prompts[i], max_new_tokens=16).tolist()
                if out != refs[i]:
                    wrong.append(i)
            cli.close()
        except Exception as e:  # noqa: BLE001 - the drill counts these
            errs.append(f"{type(e).__name__}: {e}")

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(len(prompts))]
    for t in ths:
        t.start()
    t_end = time.monotonic() + 60
    while len(router.replica_ids(healthy_only=True)) < 3 \
            and time.monotonic() < t_end:
        scaler.tick()
        time.sleep(0.05)
    peak = len(router.replica_ids(healthy_only=True))
    stop_load.set()
    for t in ths:
        t.join(timeout=120)
        assert not t.is_alive()
    t_end = time.monotonic() + 60
    while len(router.replica_ids(healthy_only=True)) > 1 \
            and time.monotonic() < t_end:
        scaler.tick()
        time.sleep(0.02)
    return {"peak": peak, "final": router.replica_ids(healthy_only=True),
            "errors": errs, "wrong_tokens": wrong, "left": sorted(servers),
            "counters": s.delta("autoscaler.scale_ups",
                                "autoscaler.scale_downs",
                                "autoscaler.errors")}


def test_scale_1_3_1_under_sustained_load_zero_errors(models):
    """Sustained load scales the fleet 1 -> 3, the load stops, and the
    fleet migrates its way back to 1: zero client errors, every answer
    the in-process engine's."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 97, 5).astype(np.int32) for _ in range(6)]
    refs = [_ref(models, p, 16) for p in prompts]
    rec = both(models, sc_scale_cycle, prompts=prompts, refs=refs)["torch"]
    assert rec == {"peak": 3, "final": ["r0"], "errors": [],
                   "wrong_tokens": [], "left": [],
                   "counters": {"autoscaler.scale_ups": 2,
                                "autoscaler.scale_downs": 2,
                                "autoscaler.errors": 0}}


def test_port_scaler_over_a_jax_router_and_the_reverse(models):
    """Each package's autoscaler drives the other package's router and
    replicas, its STATS pulls included: a spawn joins the rotation, a
    drain migrates it away."""
    for scaler_pkg, fleet_pkg in (("torch", "jax"), ("jax", "torch")):
        fs = Side(fleet_pkg, models)
        try:
            seed, router = _fleet(fs)
            servers, holder = {}, {}
            base = _launcher(fs, servers, holder)
            launcher = AUTOSCALE[scaler_pkg].CallbackLauncher(
                base._spawn_fn, base._drain_fn)
            scaler = AUTOSCALE[scaler_pkg].Autoscaler(
                router, launcher, AUTOSCALE[scaler_pkg].AutoscalePolicy(
                    max_replicas=2, hysteresis_ticks=1, up_cooldown_s=0.0,
                    down_cooldown_s=0.0), replica_secret=FLEET)
            holder["scaler"] = scaler
            with router._rlock:
                router._replicas["r0"].outstanding = 8
            assert scaler.tick() == "up"
            cli = fs.client(router.port, secret=FRONT)
            p = np.arange(3, 9, dtype=np.int32)
            assert [cli.generate(p, max_new_tokens=4).tolist()
                    for _ in range(2)] == [_ref(models, p, 4)] * 2
            cli.close()
            with router._rlock:
                router._replicas["r0"].outstanding = 0
            assert scaler.tick() == "down"
            assert router.replica_ids() == ["r0"] and not servers
        finally:
            fs.close()
