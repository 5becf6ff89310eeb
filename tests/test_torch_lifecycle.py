"""The port's request lifecycle (`paddle_tpu_torch/inference/engine.py`:
admission control, deadlines, cancellation, idempotent dedup, drain and
abort, the pressure ladder, the in-flight readback window, and the fault
sites of `paddle_tpu_torch/testing/faults.py`) held against the JAX
package's `DecodeEngine` on the same numpy-drawn weights (the tiny GPT of
`tests/test_torch_graphs.py`), scenario by scenario: the scenarios of the
JAX package's `tests/test_chaos.py`, `tests/test_control_plane.py::
TestEngineDedup`, `tests/test_engine.py::TestAbort` and
`test_readback_is_deferred_behind_inflight_window`.

Each scenario runs once on a JAX engine and once on the port's (``device=
"cpu"``) with the same `EngineConfig`, and what it records must be EQUAL:
tokens, typed errors (class name and text), counter deltas (the port's
``counters`` against the JAX ``engine.*`` metrics), gauges (the port's
``gauges`` against the JAX ``engine.*`` gauges), in-flight timelines step
by step, and the allocator's free pages. Each side arms its own package's
fault sites.
"""
import dataclasses
import time

import numpy as np
import pytest

from paddle_tpu.inference.engine import DecodeEngine as JEngine
from paddle_tpu.inference.engine import EngineConfig as JConfig
from paddle_tpu.observability import metrics
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.testing import faults as tfaults
from tests.test_torch_graphs import TINY, _pair
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


V = TINY["vocab_size"]
# the counters both engines keep: the port's name, the JAX metric's is
# "engine." + the name with "kvtier_" written "kvtier."
KEYS = ("requests", "shed", "dedup_hits", "dedup_replays", "cancelled",
        "deadline_exceeded", "steps", "h2d_transfers", "d2h_transfers",
        "prefill_tokens", "prefix_hit", "prefix_evictions",
        "prefix_evictions_demoted", "prefix_evictions_discarded",
        "spec_drafted", "kvtier_spill_fail", "kvtier_reupload_fail",
        "kvtier_refusals", "kvtier_reuploads_host", "kvtier_reuploads_disk")
GAUGES = ("degradation_level", "queue_depth", "steps_in_flight")
KEY_A = bytes(range(16))
KEY_B = bytes(range(16, 32))


@pytest.fixture(scope="module")
def models():
    return {11: _pair(11)}


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    """A failing scenario must never leave a fault armed."""
    yield
    jfaults.disarm()
    tfaults.disarm()


class Kit:
    """One side of a scenario: its engine, its package's fault module,
    and reads of its counters (deltas since the scenario began), gauges
    and free pages."""

    def __init__(self, eng):
        self.eng = eng
        self.jax = isinstance(eng, JEngine)
        self.faults = jfaults if self.jax else tfaults
        self.base = self._counters()

    def _counters(self):
        if self.jax:
            snap = metrics.snapshot()["counters"]
            return {k: snap.get("engine." + k.replace("kvtier_", "kvtier."),
                                0) for k in KEYS}
        return {k: self.eng.counters[k] for k in KEYS}

    def delta(self, *keys):
        now = self._counters()
        return {k: now[k] - self.base[k] for k in keys or KEYS}

    def gauges(self):
        if self.jax:
            snap = metrics.snapshot()["gauges"]
            return {k: snap.get("engine." + k) for k in GAUGES}
        return dict(self.eng.gauges)

    def free_pages(self):
        a = self.eng.allocator
        return a.free_pages, a.num_pages - 1


def outcome(req, timeout=30):
    """A finished request's tokens, or its typed error's class and text."""
    try:
        return ("tokens", req.result(timeout=timeout))
    except RuntimeError as e:
        return ("error", type(e).__name__, str(e))


def raised(fn):
    """The class name and text of what ``fn()`` raised, or None."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def same(got, want, path="record"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


def both(models, scenario, **ecfg):
    """Run ``scenario(engine, kit)`` on a JAX engine and on the port's, both
    of ``EngineConfig(**ecfg)``; assert that their records are equal and
    return the port's record and kit."""
    jm, tm = models[11]
    runs = {}
    for name, make in (("jax", lambda: JEngine(jm, JConfig(**ecfg))),
                       ("port", lambda: DecodeEngine(
                           tm, EngineConfig(**ecfg), device="cpu"))):
        eng = make()
        kit = Kit(eng)
        runs[name] = scenario(eng, kit), kit
    same(runs["port"][0], runs["jax"][0])
    return runs["port"]


def _ids(seed, n):
    return np.random.RandomState(seed).randint(0, V, n).astype(np.int32)


def chaos(**kw):
    """`tests/test_chaos.py::_engine`'s config."""
    return dict(dict(page_size=4, max_slots=2, min_bucket=8), **kw)


# -------------------------------------------------------------- config

def test_engine_config_takes_every_jax_field_with_its_default():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert port_fields == jax_fields
    assert list(port_fields) == list(jax_fields)     # positional order too
    cfg = EngineConfig(**{k: v for k, v in jax_fields.items()})
    assert cfg.inflight == 2 and cfg.dedup_capacity == 1024
    # donation is accepted with any value: the port always writes in place
    assert EngineConfig(donate=True).donate is True


def test_request_waiters_count_as_the_jax_request():
    """`add_waiter` / `remove_waiter` / `waiters` (the serve tier's
    disconnect-cancel reads them) and the deadline clock, on a port and a
    JAX `GenerateRequest`."""
    from paddle_tpu.inference.engine import GenerateRequest as JRequest
    from paddle_tpu_torch.inference.engine import GenerateRequest
    seen = []
    for cls in (JRequest, GenerateRequest):
        r = cls(np.arange(3, dtype=np.int32), 2, deadline_s=60.0,
                request_key=KEY_A)
        r.add_waiter()
        r.add_waiter()
        counts = [r.waiters, r.remove_waiter(), r.remove_waiter(),
                  r.remove_waiter(), r.waiters]
        seen.append((counts, r.expired(), r.expired(r.deadline_t),
                     r.request_key, r.imported,
                     r.request_id.startswith("req-")))
    assert seen[0] == seen[1] == ([2, 1, 0, 0, 0], False, True, KEY_A,
                                  False, True)


# -------------------------------------------------------- fault harness

@pytest.mark.parametrize("fx", [jfaults, tfaults], ids=["jax", "port"])
def test_faults_off_by_default_and_cheap(fx):
    assert fx.ENABLED is False
    assert fx.fire("engine.step_delay") is False


@pytest.mark.parametrize("fx", [jfaults, tfaults], ids=["jax", "port"])
def test_faults_times_and_fired_accounting(fx):
    base = fx.fired("t.site")
    fx.arm("t.site", times=2)
    assert fx.ENABLED
    assert fx.fire("t.site") and fx.fire("t.site")
    assert fx.fire("t.site") is False          # spent
    assert fx.fired("t.site") == base + 2
    assert fx.remaining("t.site") == 0
    fx.disarm("t.site")
    assert fx.ENABLED is False and fx.remaining("t.site") is None


@pytest.mark.parametrize("fx", [jfaults, tfaults], ids=["jax", "port"])
def test_faults_exception_and_scope(fx):
    with fx.scoped("t.crash", exc=fx.FaultInjected):
        with pytest.raises(fx.FaultInjected, match="t.crash"):
            fx.fire("t.crash")
    assert fx.ENABLED is False
    with pytest.raises(TypeError, match="exception class"):
        fx.arm("t.bad", exc="boom")


@pytest.mark.parametrize("fx", [jfaults, tfaults], ids=["jax", "port"])
def test_faults_env_spec_parsing(fx, monkeypatch):
    fx.arm_from_env("t.a:times=3:delay_s=0.0,t.b:exc=FaultInjected")
    try:
        assert fx.fire("t.a") and fx.remaining("t.a") == 2
        with pytest.raises(fx.FaultInjected):
            fx.fire("t.b")
    finally:
        fx.disarm()
    with pytest.raises(ValueError, match="unknown key"):
        fx.arm_from_env("t.c:bogus=1")
    with pytest.raises(ValueError, match="unknown exception"):
        fx.arm_from_env("t.d:exc=NoSuchError")
    fx.disarm()
    monkeypatch.setenv("PADDLE_FAULTS", "t.e:exc=KeyError")
    fx.arm_from_env()
    with pytest.raises(KeyError, match="t.e"):
        fx.fire("t.e")
    fx.disarm()


def _crash(eng, kit):
    r = eng.submit(_ids(1, 6), 4)
    with kit.faults.scoped("engine.crash", exc=kit.faults.FaultInjected):
        err = raised(eng.step)
    eng.run_until_idle(max_steps=40)
    return [err, outcome(r), kit.free_pages()]


def test_engine_crash_site_raises_from_step(models):
    rec, _ = both(models, _crash, **chaos(prefix_cache=False))
    assert rec[0] == ("FaultInjected", "fault injected at engine.crash")


# ------------------------------------------------------------ deadlines

def _expired_in_queue(eng, kit):
    r = eng.submit(_ids(2, 16), max_new_tokens=4, deadline_s=0.02)
    time.sleep(0.05)                      # expire while still queued
    eng.run_until_idle(max_steps=20)
    return [outcome(r, 5), kit.delta(), kit.free_pages(), kit.gauges()]


def test_deadline_expired_in_queue_never_prefills(models):
    rec, kit = both(models, _expired_in_queue, **chaos())
    assert rec[0][:2] == ("error", "DeadlineExceeded")
    assert "passed after 0 generated tokens" in rec[0][2]
    assert rec[1]["prefill_tokens"] == 0 and rec[1]["deadline_exceeded"] == 1
    assert rec[2][0] == rec[2][1]


class StepClock:
    """A monotonic clock that only the step-delay fault moves: put in
    place of the `time` module of both engines (their deadline clocks)
    and of both fault modules (the delay's sleep), it makes a deadline
    cut land on the same step whatever the host's load."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds

    perf_counter = staticmethod(time.perf_counter)


def _deadline_mid_decode(eng, kit):
    w = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=2)
    eng.run_until_idle(max_steps=40)
    out = [outcome(w)]
    # the steps start at 0.2, 0.4 and 0.6 s: the deadline passes between
    # the second step's harvest and the third step's reap
    with kit.faults.scoped("engine.step_delay", times=-1, delay_s=0.2):
        r = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=50,
                       deadline_s=0.5)
        eng.run_until_idle(max_steps=200)
    return out + [outcome(r, 5), kit.delta(), kit.free_pages()]


def test_deadline_cuts_off_mid_decode(models, monkeypatch):
    from paddle_tpu.inference import engine as jengine_mod
    from paddle_tpu_torch.inference import engine as tengine_mod
    clock = StepClock()
    for mod in (jengine_mod, tengine_mod, jfaults, tfaults):
        monkeypatch.setattr(mod, "time", clock)
    fired = tfaults.fired("engine.step_delay")
    rec, kit = both(models, _deadline_mid_decode,
                    **chaos(prefix_cache=False))
    assert rec[1] == ("error", "DeadlineExceeded", "request deadline "
                      "(0.5s) passed after 2 generated tokens")
    assert rec[2]["deadline_exceeded"] == 1
    assert rec[3][0] == rec[3][1]
    assert tfaults.fired("engine.step_delay") == fired + 3


def _validation(eng, kit):
    p = np.arange(4, dtype=np.int32)
    return [raised(lambda: eng.submit(p, 2, deadline_s=0.0)),
            raised(lambda: eng.submit(p, 2, deadline_s=-1)),
            raised(lambda: eng.submit(p, 2, request_key=b"short")),
            raised(lambda: eng.submit(p, 0, deadline_s=0.0)),
            kit.delta("requests"), kit.gauges()["queue_depth"]]


def test_submit_validates_deadline_and_key_in_the_jax_order(models):
    rec, _ = both(models, _validation, **chaos())
    assert rec[0][0] == "ValueError" and "deadline_s" in rec[0][1]
    assert "16 bytes" in rec[2][1]
    assert "max_new_tokens" in rec[3][1]      # checked before deadline_s


# --------------------------------------------------------- cancellation

def _cancel_queued(eng, kit):
    a = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=12)
    eng.step()                            # admit A (prefills 6 tokens)
    tok0 = kit.delta("prefill_tokens")["prefill_tokens"]
    b = eng.submit(np.arange(16, dtype=np.int32) % V, max_new_tokens=4)
    known = eng.cancel(b.request_id)
    eng.run_until_idle(max_steps=60)
    return [known, outcome(b, 5), outcome(a),
            kit.delta("prefill_tokens")["prefill_tokens"] - tok0,
            kit.delta(), kit.free_pages()]


def test_cancel_queued_skips_prefill(models):
    rec, _ = both(models, _cancel_queued,
                  **chaos(max_slots=1, prefix_cache=False))
    assert rec[0] is True and rec[1][:2] == ("error", "Cancelled")
    assert rec[3] == 0


def _cancel_mid_decode(eng, kit):
    r = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=40)
    for _ in range(3):
        eng.step()
    known = eng.cancel(r.request_id, reason="test says stop")
    eng.run_until_idle(max_steps=60)
    return [known, outcome(r, 5), eng.cancel(r.request_id), kit.delta(),
            kit.free_pages()]


def test_cancel_mid_decode_reclaims_slot_and_pages(models):
    rec, _ = both(models, _cancel_mid_decode, **chaos(prefix_cache=False))
    assert rec[0] is True and rec[2] is False
    assert rec[1] == ("error", "Cancelled", "test says stop")
    assert rec[3]["cancelled"] == 1 and rec[4][0] == rec[4][1]


def _cancel_shared_prefix(eng, kit):
    prompt = (np.arange(12, dtype=np.int32) * 5) % V        # 3 pages
    a = eng.submit(prompt, max_new_tokens=2)                # primes
    eng.run_until_idle(max_steps=60)
    out = [outcome(a)]
    b = eng.submit(prompt, max_new_tokens=20)
    d = eng.submit(prompt, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    out += [kit.delta("prefix_hit"), eng.cancel(b.request_id)]
    eng.run_until_idle(max_steps=100)
    out += [outcome(b, 5), outcome(d), kit.free_pages()]
    tok0 = kit.delta("prefill_tokens")["prefill_tokens"]
    c = eng.submit(prompt, max_new_tokens=8)
    eng.run_until_idle(max_steps=60)
    return out + [outcome(c), kit.delta("prefill_tokens")["prefill_tokens"]
                  - tok0, kit.delta(), kit.free_pages()]


def test_cancel_shared_prefix_pages_refcounts_not_freed(models):
    rec, _ = both(models, _cancel_shared_prefix, **chaos(prefix_cache=True))
    assert rec[1]["prefix_hit"] == 2 and rec[2] is True
    assert rec[3][:2] == ("error", "Cancelled")
    # the sharer's tokens are a cold run's: the re-hit's equal them
    np.testing.assert_array_equal(rec[4][1], rec[6][1])
    assert rec[7] == 4                    # only the uncached tail again
    assert rec[5][0] == rec[5][1] and rec[9][0] == rec[9][1]


def _cancel_mid_chunk(eng, kit):
    r = eng.submit(np.arange(24, dtype=np.int32) % V, max_new_tokens=4)
    eng.step()                            # admit + first chunk (4 tokens)
    mid = kit.delta("prefill_tokens")
    known = eng.cancel(r.request_id)
    eng.run_until_idle(max_steps=40)
    return [mid, known, outcome(r, 5), kit.delta(), kit.free_pages()]


def test_cancel_mid_chunked_prefill_runs_no_further_chunk(models):
    rec, _ = both(models, _cancel_mid_chunk,
                  **chaos(max_slots=1, prefix_cache=False,
                          prefill_chunk_tokens=4))
    assert rec[0]["prefill_tokens"] == 4 == rec[3]["prefill_tokens"]
    assert rec[2][:2] == ("error", "Cancelled")


# --------------------------------- admission control and the ladder

def _shed_depth(eng, kit):
    q1 = eng.submit(np.arange(4, dtype=np.int32), 4)
    q2 = eng.submit(np.arange(4, dtype=np.int32), 4)
    g = kit.gauges()["queue_depth"]
    err = raised(lambda: eng.submit(np.arange(4, dtype=np.int32), 4))
    eng.run_until_idle(max_steps=200)
    return [g, err, outcome(q1), outcome(q2), kit.delta(), kit.free_pages()]


def test_queue_depth_shed_is_typed_overloaded(models):
    rec, _ = both(models, _shed_depth,
                  **chaos(max_slots=1, max_queue_depth=2))
    assert rec[0] == 2
    assert rec[1] == ("Overloaded", "engine queue full: depth 2 >= "
                                    "max_queue_depth 2")
    assert rec[4]["shed"] == 1 and rec[4]["requests"] == 2


def _shed_tokens(eng, kit):
    a = eng.submit(np.arange(4, dtype=np.int32), 4)
    b = eng.submit(np.arange(16, dtype=np.int32) % V, 4)   # 20 queued
    err = raised(lambda: eng.submit(np.arange(8, dtype=np.int32), 4))
    eng.run_until_idle(max_steps=200)
    # an empty queue admits a prompt past the bound
    big = eng.submit(np.arange(30, dtype=np.int32) % V, 2)
    eng.run_until_idle(max_steps=200)
    return [err, outcome(a), outcome(b), outcome(big), kit.delta(),
            kit.free_pages()]


def test_queue_tokens_shed(models):
    rec, _ = both(models, _shed_tokens,
                  **chaos(max_slots=1, max_queue_tokens=20))
    assert rec[0][0] == "Overloaded" and "max_queue_tokens" in rec[0][1]
    assert rec[3][0] == "tokens"


def _ladder(eng, kit):
    rep = np.tile(np.arange(4, dtype=np.int32), 3)      # draftable
    a = eng.submit(rep, max_new_tokens=6)
    eng.run_until_idle(max_steps=60)
    out = [outcome(a), len(eng.prefix_hashes()), eng._deg]
    run = eng.submit(rep, max_new_tokens=30)
    eng.step()                                    # admit `run`
    out.append(kit.delta("spec_drafted"))
    queued = [eng.submit(rep, max_new_tokens=2) for _ in range(6)]
    timeline = []
    more = True
    while more:
        more = eng.step()
        timeline.append((eng._deg, kit.delta("spec_drafted"),
                         len(eng.prefix_hashes()),
                         kit.delta("prefix_evictions")))
        if len(timeline) == 1:
            out.append(kit.gauges()["degradation_level"])
    out += [timeline, kit.gauges()["degradation_level"], outcome(run),
            [outcome(q) for q in queued], kit.delta(), kit.free_pages()]
    return out


def test_degradation_ladder_spec_off_then_prefix_shrunk(models):
    rec, kit = both(models, _ladder,
                    **chaos(max_slots=1, max_queue_depth=8, speculate_k=2))
    pages_before, level0, drafted_mid, level_at_queue, timeline = rec[1:6]
    assert pages_before > 0 and level0 == 0 and drafted_mid["spec_drafted"]
    assert level_at_queue == 2 and timeline[0][0] == 2
    # level 2 dropped the idle cached page, and pages a live slot shares
    # keep their index
    assert timeline[0][2] < pages_before and timeline[0][3]["prefix_evictions"]
    assert {lvl for lvl, *_ in timeline} == {0, 1, 2}
    # no drafting while the ladder is at level 1 or above
    drafted = [drafted_mid] + [d for _, d, *_ in timeline]
    for (lvl, *_), prev, now in zip(timeline, drafted, drafted[1:]):
        if lvl >= 1:
            assert now == prev
    assert rec[6] == 0                    # back down after the queue drained
    assert rec[-1][0] == rec[-1][1]


# ------------------------------------------------------ injected faults

def _pressure_transient(eng, kit):
    a = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=12)
    eng.step()                            # A owns a slot
    f0 = kit.faults.fired("engine.pool_pressure")
    with kit.faults.scoped("engine.pool_pressure", times=2):
        b = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
        eng.run_until_idle(max_steps=100)
    return [outcome(b), outcome(a),
            kit.faults.fired("engine.pool_pressure") - f0, kit.delta(),
            kit.free_pages()]


def test_pool_pressure_transient_then_admits(models):
    rec, _ = both(models, _pressure_transient, **chaos(prefix_cache=False))
    assert rec[0][0] == "tokens" and rec[2] == 2


def _pressure_permanent(eng, kit):
    with kit.faults.scoped("engine.pool_pressure", times=-1):
        r = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
        eng.run_until_idle(max_steps=20)
    return [outcome(r, 5), kit.delta(), kit.free_pages()]


def test_pool_pressure_on_empty_engine_fails_fast(models):
    rec, _ = both(models, _pressure_permanent, **chaos(prefix_cache=False))
    assert rec[0][:2] == ("error", "RuntimeError")
    assert "pages, pool has" in rec[0][2]


def _tier_faults(eng, kit):
    """tests/test_kv_tiers.py::TestTierChaos on one engine: a failed spill
    is a plain discard, a failed re-upload a cold prefill, a corrupt disk
    entry a typed refusal read as a miss."""
    prompt = _ids(9, 17)
    outs, deltas = [], []

    def serve():
        r = eng.submit(prompt, max_new_tokens=6)
        eng.run_until_idle(max_steps=60)
        outs.append(outcome(r))
        deltas.append(kit.delta())

    serve()
    with kit.faults.scoped("kvtier.spill_fail"):
        eng._shrink_prefix()
    spill = kit.delta()
    serve()                               # cold: the pages were discarded
    eng._shrink_prefix()                  # spilled to the tiers
    with kit.faults.scoped("kvtier.reupload_fail"):
        serve()                           # cold again
    eng._shrink_prefix()
    with kit.faults.scoped("kvtier.disk_corrupt", times=1):
        serve()                           # the first disk entry refused
    eng._shrink_prefix()
    serve()                               # the pages the last run spilled
    return [outs, deltas, spill, kit.free_pages()]


def test_tier_fault_sites_degrade_to_discard_or_cold_prefill(models,
                                                            tmp_path):
    """The host tier (64 bytes) holds no page, so every spill lands on
    the disk tier."""
    rec, kit = both(models, _tier_faults,
                    **chaos(max_slots=2, kv_host_tier_bytes=64,
                            kv_disk_tier_bytes=1 << 20,
                            kv_disk_tier_dir=str(tmp_path)))
    outs, deltas, spill, pool = rec
    assert all(o[0] == "tokens" for o in outs)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[1], outs[0][1])
    assert spill["kvtier_spill_fail"] == 1
    assert spill["prefix_evictions_discarded"] == 4
    d = deltas[-1]
    assert d["kvtier_reupload_fail"] == 1 and d["kvtier_refusals"] == 1
    assert d["kvtier_reuploads_disk"] == 4
    # cold, cold, cold, cold (the refused entry breaks the chain), then a
    # re-upload of every full page: one token left to prefill
    assert [b["prefill_tokens"] - a["prefill_tokens"] for a, b in
            zip([{"prefill_tokens": 0}] + deltas, deltas)] == [17] * 4 + [1]
    assert pool[0] == pool[1]


# ---------------------------------------------------------------- dedup

def _dedup(**kw):
    return dict(dict(page_size=4, max_slots=4, min_bucket=8), **kw)


def _completed_key_replays(eng, kit):
    p = np.arange(5, dtype=np.int32)
    r1 = eng.submit(p, max_new_tokens=6, request_key=KEY_A)
    eng.run_until_idle()
    out1 = outcome(r1)
    r2 = eng.submit(p, max_new_tokens=6, request_key=KEY_A)
    return [r2 is r1, out1, outcome(r2, 1), kit.delta()]


def _in_flight_key_attaches(eng, kit):
    p = np.arange(6, dtype=np.int32)
    r1 = eng.submit(p, max_new_tokens=8, request_key=KEY_B)
    r2 = eng.submit(p, max_new_tokens=8, request_key=KEY_B)
    eng.run_until_idle()
    return [r2 is r1, outcome(r1), kit.delta()]


def _key_reuse_refused(eng, kit):
    p = np.arange(5, dtype=np.int32)
    eng.submit(p, max_new_tokens=4, request_key=KEY_A)
    out = [raised(lambda: eng.submit(p + 1, 4, request_key=KEY_A)),
           raised(lambda: eng.submit(p, 5, request_key=KEY_A)),
           raised(lambda: eng.submit(p, 4, request_key=b"short"))]
    eng.run_until_idle()
    return out + [kit.delta()]


def _cancelled_key_reexecutes(eng, kit):
    p = np.arange(4, dtype=np.int32)
    r1 = eng.submit(p, max_new_tokens=6, request_key=KEY_A)
    known = eng.cancel(r1.request_id)
    eng.run_until_idle()
    out1 = outcome(r1, 10)
    r2 = eng.submit(p, max_new_tokens=6, request_key=KEY_A)
    eng.run_until_idle()
    return [known, out1, r2 is not r1, outcome(r2), kit.delta()]


def _typed_error_replays(eng, kit):
    p = np.arange(4, dtype=np.int32)
    r1 = eng.submit(p, max_new_tokens=6, request_key=KEY_B, deadline_s=0.01)
    time.sleep(0.05)
    eng.run_until_idle()
    out1 = outcome(r1, 10)
    r2 = eng.submit(p, max_new_tokens=6, request_key=KEY_B)
    return [r2 is r1, out1, outcome(r2, 1), kit.delta()]


def _lru_bound(eng, kit):
    p = np.arange(4, dtype=np.int32)
    keys = [bytes([i] * 16) for i in range(3)]
    reqs = [eng.submit(p, max_new_tokens=2, request_key=k) for k in keys]
    eng.run_until_idle()
    r = eng.submit(p, max_new_tokens=2, request_key=keys[0])
    replay = eng.submit(p, max_new_tokens=2, request_key=keys[2])
    eng.run_until_idle()
    return [r is not reqs[0], replay is reqs[2], outcome(r), kit.delta()]


def _dedup_disabled(eng, kit):
    p = np.arange(4, dtype=np.int32)
    r1 = eng.submit(p, max_new_tokens=2, request_key=KEY_A)
    eng.run_until_idle()
    r2 = eng.submit(p, max_new_tokens=2, request_key=KEY_A)
    eng.run_until_idle()
    return [r2 is not r1, outcome(r1), outcome(r2), kit.delta()]


@pytest.mark.parametrize("scenario,kw", [
    (_completed_key_replays, {}), (_in_flight_key_attaches, {}),
    (_key_reuse_refused, {}), (_cancelled_key_reexecutes, {}),
    (_typed_error_replays, {}), (_lru_bound, {"dedup_capacity": 2}),
    (_dedup_disabled, {"dedup_capacity": 0})],
    ids=["completed_replays", "in_flight_attaches", "reuse_refused",
         "cancelled_reexecutes", "typed_error_replays", "lru_bound",
         "disabled"])
def test_engine_dedup(models, scenario, kw):
    rec, _ = both(models, scenario, **_dedup(**kw))
    counters = rec[-1]
    if scenario is _completed_key_replays:
        assert rec[0] and counters["requests"] == 1
        assert counters["dedup_replays"] == 1
    elif scenario is _in_flight_key_attaches:
        assert rec[0] and counters["dedup_hits"] == 1
    elif scenario is _key_reuse_refused:
        assert "request_key reused" in rec[0][1] == rec[1][1]
    elif scenario is _typed_error_replays:
        assert rec[0] and rec[1] == rec[2] and rec[1][1] == "DeadlineExceeded"
    elif scenario is _lru_bound:
        assert rec[0] and rec[1] and counters["requests"] == 4
    else:
        assert rec[0 if scenario is not _cancelled_key_reexecutes else 2]


# -------------------------------------------------------- drain / abort

def _abort(eng, kit):
    rng = np.random.RandomState(8)
    running = eng.submit(rng.randint(0, V, 4).astype(np.int32), 10)
    queued = eng.submit(rng.randint(0, V, 4).astype(np.int32), 10)
    eng.step()                            # running holds the slot
    window = kit.gauges()["steps_in_flight"]
    eng.abort("device fell over")
    return [window, outcome(running, 5), outcome(queued, 5),
            kit.free_pages(), kit.gauges(),
            raised(lambda: eng.submit(rng.randint(0, V, 4), 2)),
            eng.cancel(running.request_id), eng.step()]


def test_abort_fails_queued_and_in_flight_then_refuses_submits(models):
    rec, _ = both(models, _abort, **chaos(max_slots=1))
    assert rec[0] == 1                    # one step was in flight
    assert rec[1] == rec[2] == ("error", "RuntimeError", "device fell over")
    assert rec[3][0] == rec[3][1] and rec[4]["steps_in_flight"] == 0
    assert rec[5] == ("RuntimeError", "engine stopped: device fell over")


def _drain(eng, kit):
    p = np.arange(5, dtype=np.int32)
    a = eng.submit(p, 6, request_key=KEY_A)
    eng.step()
    eng.drain()
    out = [raised(lambda: eng.submit(p + 1, 3)),
           eng.submit(p, 6, request_key=KEY_A) is a]   # attach still works
    eng.run_until_idle(max_steps=60)
    return out + [outcome(a), kit.delta(), kit.free_pages()]


def test_drain_refuses_new_submits_and_finishes_accepted_work(models):
    rec, kit = both(models, _drain, **chaos())
    assert rec[0] == ("RuntimeError",
                      "engine draining: not accepting new requests")
    assert rec[1] is True and rec[2][0] == "tokens"
    assert kit.eng.counters["drains"] == 1
    # a migrating drain of the quiet engine exports nothing
    # (`tests/test_torch_handoff.py` holds migration against the JAX one)
    kit.eng.drain(migrate=True)
    kit.eng.step()
    assert kit.eng.take_migrated(timeout=5) == []


# ------------------------------------------------ the in-flight window

def _timeline(eng, kit):
    prompt = np.random.RandomState(11).randint(0, V, 4).astype(np.int32)
    req = eng.submit(prompt, max_new_tokens=10)
    steps = []
    more = True
    while more:
        more = eng.step()
        steps.append((len(eng._inflight), len(req.generated),
                      kit.gauges()["steps_in_flight"]))
    return [steps, outcome(req), kit.delta()]


def test_readback_is_deferred_behind_inflight_window(models):
    rec, _ = both(models, _timeline, page_size=4, max_slots=1, min_bucket=8,
                  inflight=3)
    steps = rec[0]
    assert steps[0][:2] == (1, 1)         # prefill + dispatch #1
    assert steps[1][:2] == (2, 1)         # dispatch #2, nothing harvested
    assert steps[2][:2] == (2, 2)         # window full: oldest harvested
    assert steps[-1][:2] == (0, 10)


WINDOW_CONFIGS = {
    "greedy": dict(eos_id=None),
    "sampled": dict(sampling=True),
    "int8": dict(kv_dtype="int8", weight_dtype="int8"),
    "chunked": dict(prefill_chunk_tokens=4)}


def _churn(eng, kit):
    """Five requests on three slots, two of them submitted mid-run, so that
    admissions and retirements (EOS among them) fall inside the window.
    Records every request's delivered token count after each step."""
    sampled = eng.ecfg.sampling
    reqs = []

    def submit(i, n, new):
        kw = dict(temperature=0.8, top_k=5, seed=i) if sampled and i % 2 \
            else {}
        reqs.append(eng.submit(_ids(20 + i, n), new, **kw))

    for i, (n, new) in enumerate(((5, 7), (11, 4), (3, 9))):
        submit(i, n, new)
    steps = []
    more = True
    while more:
        more = eng.step()
        steps.append([len(r.generated) for r in reqs])
        if len(steps) == 2:
            submit(3, 12, 6)
            submit(4, 7, 5)
            more = True
    return [steps, [outcome(r) for r in reqs], kit.delta(), kit.free_pages()]


def _window_cfg(name, inflight, eos_id=None):
    kw = dict(WINDOW_CONFIGS[name], page_size=4, max_slots=3, min_bucket=8,
              inflight=inflight)
    if name == "greedy":
        kw["eos_id"] = eos_id
    return kw


@pytest.fixture(scope="module")
def greedy_eos(models):
    """A token the greedy churn emits early in one request and not at its
    end, as ``eos_id``: EOS then retires a slot inside the window."""
    _, tm = models[11]
    eng = DecodeEngine(tm, EngineConfig(**_window_cfg("greedy", 1)),
                       device="cpu")
    outs = _churn(eng, Kit(eng))[1]
    tokens = outs[2][1][3:]                  # request 2's generated tokens
    return int(tokens[2])


@pytest.mark.parametrize("inflight", [1, 3])
def test_greedy_window_follows_the_jax_timeline(models, greedy_eos, inflight):
    """The greedy churn with EOS on both engines at windows 1 and 3 (2 is
    `test_window_gives_equal_tokens_at_every_depth`'s)."""
    rec, _ = both(models, _churn, **_window_cfg("greedy", inflight,
                                                greedy_eos))
    assert all(o[0] == "tokens" for o in rec[1])
    assert rec[3][0] == rec[3][1]


@pytest.mark.parametrize("name", list(WINDOW_CONFIGS))
def test_window_gives_equal_tokens_at_every_depth(models, greedy_eos, name):
    """The JAX timeline at the default window (2), and the port's tokens
    equal at windows 1, 2 and 3."""
    eos = greedy_eos if name == "greedy" else None
    rec, _ = both(models, _churn, **_window_cfg(name, 2, eos))
    _, tm = models[11]
    for inflight in (1, 3):
        eng = DecodeEngine(tm, EngineConfig(**_window_cfg(name, inflight,
                                                          eos)),
                           device="cpu")
        got = _churn(eng, Kit(eng))
        same(got[1], rec[1])
        assert got[3][0] == got[3][1]
        # one readback per decode step and one per prompt, whatever the
        # window
        assert got[2]["d2h_transfers"] == got[2]["steps"] + 5


def test_window_rings_hold_one_buffer_a_step_in_flight(models):
    """The pinned state and token rings have ``max(1, inflight)`` buffers
    (CPU tensors here, with no events), and each dispatch moves both
    cursors by one."""
    _, tm = models[11]
    for inflight, n in ((0, 1), (1, 1), (3, 3)):
        eng = DecodeEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                            inflight=inflight),
                           device="cpu")
        assert len(eng._state_ring) == len(eng._tok_ring) == n
        assert eng._state_uploaded == eng._tok_copied == [None] * n
    eng.submit(_ids(1, 5), 6)
    seen = []
    for _ in range(4):
        eng.step()
        seen.append((eng._state_i, eng._tok_i))
    assert seen == [(1, 1), (2, 2), (0, 0), (1, 1)]
