"""The port's serve engine and train step reporting to its observability
layer, held against the JAX package's engine and step on the same weights
(`tests/test_torch_graphs.py::_pair`, a 2-layer GPT of width 32 carried
across by the converter), on the CPU.

Every scenario of `tests/test_torch_lifecycle.py` (deadlines, cancels,
shedding, the ladder, pool pressure, tier faults, dedup, abort, drain, the
in-flight timelines) runs again on a JAX and a port engine, each request
submitted with its package's `RequestTrace`, and what each package's
observability layer recorded over the scenario must be equal:

- the delta of every ``engine.*``, ``usage.*`` and ``serve.*`` counter;
- every ``engine.*`` gauge (each set to -1 before the engine is built,
  or to a new engine's value where a scenario reads it, and restored
  after; ``engine.tokens_per_s`` is a rate of seconds and
  compared as set or not, and ``engine.spec_accept_rate``, which divides
  the process's cumulative counters, against its own registry's counts);
- the count delta of every histogram (their values are seconds);
- the flight events, kind by kind with their fields but ``seq`` and ``t``,
  request ids numbered in order of appearance and a program key without
  its impl (``("decode", "plain")`` is the JAX ``("decode", "auto")``);
- the usage records, times compared as present or not;
- the ``request.*`` span names of each request, and each trace's phase.

Also: `serve_loop` on a thread of its own with a watchdog, a stall under
the ``engine.step_delay`` fault dumped exactly once and a healthy loop
never (`tests/test_tracing.py:181-224`); the usage parity drill of
`tests/test_slo_usage.py:300-378`; metering adding no ``compile_count``;
and the train step's ``train.*`` series, flight events and watchdog
against the JAX `ScanTrainStep.step` (`tests/test_tracing.py:230-260`),
whose ``disable_x64`` import (ROADMAP C1) is answered for the test by
``jax.enable_x64(False)``, what that import did.
"""
import json
import re
import sys
import threading
import time
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.observability as jobs
import paddle_tpu_torch.observability as tobs
from paddle_tpu.inference.engine import DecodeEngine as JEngine
from paddle_tpu.inference.engine import EngineConfig as JConfig
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import tracing as jtr
from paddle_tpu.observability import usage as jusage
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.train import ScanTrainStep as JaxScanTrainStep
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import train_state_from_numpy
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import tracing as ttr
from paddle_tpu_torch.observability import usage as tusage
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.train import ScanTrainStep
from tests import test_torch_lifecycle as life
from tests.test_torch_graphs import TINY, _pair

JENGINE_DIR = Path(sys.modules[JEngine.__module__].__file__).parent

V = TINY["vocab_size"]
PREFIXES = ("engine.", "usage.", "serve.")
# the JAX engine's and KV tiers' gauges, read from their sources; before
# an engine is built each is set to -1, the three that the lifecycle
# scenarios read (`life.Kit.gauges`) to a new engine's values
START = {"engine.degradation_level": 0, "engine.queue_depth": 0,
         "engine.steps_in_flight": 0}
ENGINE_GAUGES = sorted({m for f in ("engine.py", "kv_tiers.py") for m in
                        re.findall(r'metrics\.gauge\("(engine\.[\w.]+)"',
                                   open(JENGINE_DIR / f).read())})
SIDE = {"jax": (jobs, jfr, jtr, jusage), "port": (tobs, tfr, ttr, tusage)}


@pytest.fixture(scope="module")
def models():
    return {11: _pair(11)}


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    jfaults.disarm()
    tfaults.disarm()


def _ids(seed, n):
    return np.random.RandomState(seed).randint(0, V, n).astype(np.int32)


# ------------------------------------------------------------ the capture

class Capture:
    """What one package's observability layer records around one engine's
    scenario: counter and histogram deltas, the engine gauges (sentinel
    -1 before the engine is built, restored by `close`), the flight events,
    the usage records and the spans of the traces handed out."""

    def __init__(self, name):
        self.obs, self.fr, self.tr, self.usage = SIDE[name]
        reg = self.obs.metrics
        self.saved = {k: reg.gauge(k).value for k in ENGINE_GAUGES}
        for k in ENGINE_GAUGES:
            reg.gauge(k).set(START.get(k, -1))
        snap = reg.snapshot()
        self.counters0 = snap["counters"]
        self.hists0 = {k: v["count"] for k, v in snap["histograms"].items()}
        self.seq0 = self._seq()
        self.used0 = self.usage.usage_log.emitted
        self.traces = []

    def _seq(self):
        evs = self.fr.flight.events()
        return evs[-1]["seq"] if evs else 0

    def trace(self):
        t = self.tr.RequestTrace()
        self.traces.append(t)
        return t

    def traced(self, eng):
        """``eng`` with every submit given a fresh trace of this package
        (an explicit one kept), as a server's acceptor passes it."""
        submit = eng.submit

        def with_trace(prompt_ids, max_new_tokens=32, trace=None, *a, **kw):
            return submit(prompt_ids, max_new_tokens,
                          trace if trace is not None else self.trace(),
                          *a, **kw)
        eng.submit = with_trace
        return eng

    def read(self):
        reg = self.obs.metrics
        snap = reg.snapshot()
        ids = {}

        def rid(r):
            return None if r is None else ids.setdefault(r, len(ids))

        counters = {k: v - self.counters0.get(k, 0)
                    for k, v in snap["counters"].items()
                    if k.startswith(PREFIXES)
                    and v != self.counters0.get(k, 0)}
        hists = {k: v["count"] - self.hists0.get(k, 0)
                 for k, v in snap["histograms"].items()
                 if k.startswith(PREFIXES)
                 and v["count"] != self.hists0.get(k, 0)}
        gauges = {}
        for k in ENGINE_GAUGES:
            v = snap["gauges"][k]
            if k == "engine.tokens_per_s":
                v = v != -1
            elif k == "engine.spec_accept_rate" and v != -1:
                c = snap["counters"]
                v = v == c["engine.spec_accepted"] / c["engine.spec_drafted"]
            gauges[k] = v
        events = []
        for e in self.fr.flight.events():
            if e["seq"] <= self.seq0:
                continue
            e = {k: v for k, v in e.items() if k not in ("seq", "t")}
            if "request_id" in e:
                e["request_id"] = rid(e["request_id"])
            if e["kind"] == "engine.compile_start":
                key = eval(e["program"])              # noqa: S307
                e["program"] = key if key[0] == "verify" else key[:-1]
            events.append(e)
        n_used = self.usage.usage_log.emitted - self.used0
        usage = []
        for r in self.usage.usage_log.records()[-n_used:] if n_used else ():
            r = {k: (v is None if k in ("queue_wait_s", "ttft_s", "e2e_s")
                     else v) for k, v in r.items() if k != "t"}
            r["request_id"] = rid(r["request_id"])
            usage.append(r)
        by_request = {}
        for e in reg.chrome_trace()["traceEvents"]:
            r = (e.get("args") or {}).get("request_id")
            if r in ids or r in {t.request_id for t in self.traces}:
                by_request.setdefault(rid(r), []).append(e["name"])
        traces = [(rid(t.request_id), t.phase(), t.n_tokens, t.error,
                   sorted(t.to_dict())) for t in self.traces]
        return {"counters": counters, "histograms": hists, "gauges": gauges,
                "events": events, "usage": usage, "spans": by_request,
                "traces": traces}

    def close(self):
        for k, v in self.saved.items():
            self.obs.metrics.gauge(k).set(v)


def observed(models, scenario, seed=11, **ecfg):
    """Run ``scenario(engine, kit)`` (a `tests/test_torch_lifecycle.py`
    scenario) on a traced JAX engine and a traced port engine of
    ``EngineConfig(**ecfg)``; assert that the scenarios' records and the
    captures are equal. Returns the port's record and capture."""
    jm, tm = models[seed]
    runs = {}
    for name, make in (("jax", lambda: JEngine(jm, JConfig(**ecfg))),
                       ("port", lambda: DecodeEngine(
                           tm, EngineConfig(**ecfg), device="cpu"))):
        cap = Capture(name)
        try:
            eng = cap.traced(make())
            rec = scenario(eng, life.Kit(eng))
            runs[name] = rec, cap.read()
        finally:
            cap.close()
    life.same(runs["port"][0], runs["jax"][0])
    got, want = runs["port"][1], runs["jax"][1]
    for part in want:
        assert got[part] == want[part], part
    return runs["port"]


SCENARIOS = {
    "crash": (life._crash, life.chaos(prefix_cache=False)),
    "expired_in_queue": (life._expired_in_queue, life.chaos()),
    "validation": (life._validation, life.chaos()),
    "cancel_queued": (life._cancel_queued,
                      life.chaos(max_slots=1, prefix_cache=False)),
    "cancel_mid_decode": (life._cancel_mid_decode,
                          life.chaos(prefix_cache=False)),
    "cancel_shared_prefix": (life._cancel_shared_prefix,
                             life.chaos(prefix_cache=True)),
    "cancel_mid_chunk": (life._cancel_mid_chunk,
                         life.chaos(max_slots=1, prefix_cache=False,
                                    prefill_chunk_tokens=4)),
    "shed_depth": (life._shed_depth, life.chaos(max_slots=1,
                                                max_queue_depth=2)),
    "shed_tokens": (life._shed_tokens, life.chaos(max_slots=1,
                                                  max_queue_tokens=20)),
    "pressure_transient": (life._pressure_transient,
                           life.chaos(prefix_cache=False)),
    "pressure_permanent": (life._pressure_permanent,
                           life.chaos(prefix_cache=False)),
    "abort": (life._abort, life.chaos(max_slots=1)),
    "drain": (life._drain, life.chaos()),
    "timeline": (life._timeline, dict(page_size=4, max_slots=1,
                                      min_bucket=8, inflight=3)),
    "dedup_completed": (life._completed_key_replays, life._dedup()),
    "dedup_in_flight": (life._in_flight_key_attaches, life._dedup()),
    "dedup_cancelled": (life._cancelled_key_reexecutes, life._dedup()),
    "dedup_typed_error": (life._typed_error_replays, life._dedup()),
    "dedup_lru": (life._lru_bound, life._dedup(dedup_capacity=2)),
}
SCENARIOS.update({f"churn_{name}": (life._churn, life._window_cfg(name, 2))
                  for name in life.WINDOW_CONFIGS})


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_lifecycle_scenario_reports_as_jax(models, name):
    scenario, ecfg = SCENARIOS[name]
    rec, cap = observed(models, scenario, **ecfg)
    if name == "pressure_permanent":
        # a failed request counts an error and lands in no SLO histogram
        assert cap["counters"]["serve.request_errors"] == 1
        assert "serve.e2e_seconds" not in cap["histograms"]
        assert [r["error"] for r in cap["usage"]] == ["Error"]
    if name == "timeline":
        steps = [e for e in cap["events"] if e["kind"] == "engine.step"]
        assert [e["inflight"] for e in steps][:3] == [0, 1, 2]
        assert cap["histograms"]["engine.device_ms"] == \
            cap["histograms"]["engine.step_seconds"]
    if name.startswith("churn"):
        assert set(cap["spans"][0]) == {"request.queue", "request.prefill",
                                        "request.decode", "request.e2e"}


def test_ladder_and_tier_faults_report_as_jax(models, tmp_path):
    """The pressure ladder (its ``engine.degradation`` events and gauge)
    and the tier fault sites (spill / re-upload failures, a refused disk
    entry, the tiers' counters, gauges and ``engine.kvtier.*`` events)."""
    _, cap = observed(models, life._ladder,
                      **life.chaos(max_slots=1, speculate_k=2,
                                   max_queue_depth=8,
                                   kv_host_tier_bytes=1 << 20))
    levels = [e["level"] for e in cap["events"]
              if e["kind"] == "engine.degradation"]
    assert levels and levels[-1] == 0 and max(levels) == 2
    _, cap = observed(models, life._tier_faults,
                      **life.chaos(max_slots=2, kv_host_tier_bytes=64,
                                   kv_disk_tier_bytes=1 << 20,
                                   kv_disk_tier_dir=str(tmp_path)))
    kinds = {e["kind"] for e in cap["events"]}
    assert {"engine.kvtier.spill", "engine.kvtier.spill_fail",
            "engine.kvtier.reupload", "engine.kvtier.reupload_fail",
            "engine.kvtier.refused"} <= kinds
    assert cap["counters"]["engine.kvtier.bytes_disk"] > 0
    assert cap["histograms"]["engine.kvtier.spill_ms"] >= 1


def test_deadline_mid_decode_reports_as_jax(models, monkeypatch):
    from paddle_tpu.inference import engine as jengine_mod
    from paddle_tpu_torch.inference import engine as tengine_mod
    clock = life.StepClock()
    for mod in (jengine_mod, tengine_mod, jfaults, tfaults):
        monkeypatch.setattr(mod, "time", clock)
    rec, cap = observed(models, life._deadline_mid_decode,
                        **life.chaos(prefix_cache=False))
    reaps = [e for e in cap["events"] if e["kind"] == "engine.reap"]
    assert [e["where"] for e in reaps] == ["slot"]
    assert cap["usage"][-1]["error"] == "DeadlineExceeded"


def _eight(eng, kit):
    """`tests/test_tracing.py`'s acceptance run: 8 concurrent requests."""
    rng = np.random.RandomState(0)
    reqs = [eng.submit(rng.randint(0, V, 3 + i % 5).astype(np.int32),
                       max_new_tokens=6) for i in range(8)]
    eng.run_until_idle()
    return [[life.outcome(r) for r in reqs],
            len({r.request_id for r in reqs}),
            [(r.trace.t_submit <= r.trace.t_admit <= r.trace.t_first_token
              <= r.trace.t_done, r.trace.n_tokens) for r in reqs]]


def test_eight_concurrent_requests_slo_series_and_spans(models):
    rec, cap = observed(models, _eight, page_size=4, min_bucket=4,
                        max_slots=8)
    assert rec[1] == 8 and rec[2] == [(True, 6)] * 8
    for k in ("serve.ttft_seconds", "serve.tpot_seconds",
              "serve.e2e_seconds"):
        assert cap["histograms"][k] == 8
    assert len(cap["spans"]) == 8
    for names in cap["spans"].values():
        assert names == ["request.queue", "request.prefill",
                         "request.decode", "request.e2e"]
    assert [t[1] for t in cap["traces"]] == ["done"] * 8
    # one device_ms observation a step that did work
    assert cap["histograms"]["engine.device_ms"] == \
        cap["histograms"]["engine.host_ms"] == \
        cap["histograms"]["engine.step_seconds"]
    assert cap["counters"]["engine.tokens"] == 48 == \
        cap["counters"]["usage.generated_tokens"]


def _usage_drill(eng, kit):
    """`tests/test_slo_usage.py::TestUsageParity`'s drill: a speculative
    decode, a prefix hit, a cancel while queued and a deadline expiry."""
    rep = np.tile(np.arange(4, dtype=np.int32), 2)
    other = np.random.RandomState(3).randint(0, V, 8).astype(np.int32)
    r1 = eng.submit(rep, max_new_tokens=6)
    eng.run_until_idle(max_steps=64)
    r2 = eng.submit(rep, max_new_tokens=4)
    eng.run_until_idle(max_steps=64)
    r3 = eng.submit(other, max_new_tokens=4)
    known = eng.cancel(r3.request_id)
    eng.run_until_idle(max_steps=16)
    r4 = eng.submit(other[::-1].copy(), max_new_tokens=4,
                    deadline_s=0.02)
    time.sleep(0.05)
    eng.run_until_idle(max_steps=16)
    return [known] + [life.outcome(r, 10) for r in (r1, r2, r3, r4)]


def test_usage_records_sum_to_the_engine_counters(models):
    rec, cap = observed(models, _usage_drill, page_size=4, max_slots=2,
                        min_bucket=8, speculate_k=2)
    recs, c = cap["usage"], cap["counters"]

    def total(field):
        return sum(r[field] for r in recs)
    assert len(recs) == 4 == c["usage.requests"] and c["usage.errors"] == 2
    assert total("prefill_computed") == c["engine.prefill_tokens"] == \
        c["usage.prefill_computed_tokens"]
    assert total("generated") == c["engine.tokens"] == \
        c["usage.generated_tokens"]
    assert total("spec_accepted") == c["engine.spec_accepted"]
    assert total("kv_page_steps") == c["usage.kv_page_steps"] > 0
    assert total("prompt_tokens") == 32 and recs[1]["prefill_saved"] > 0
    assert [r["error"] for r in recs] == [None, None, "Cancelled",
                                          "DeadlineExceeded"]


def test_metering_adds_no_compiles(models):
    """A warm engine serves more requests with its compile count frozen
    while a usage record lands for each."""
    _, tm = models[11]
    eng = DecodeEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                        min_bucket=8), device="cpu")
    rng = np.random.RandomState(5)
    eng.submit(rng.randint(0, V, 6).astype(np.int32), 2)
    eng.run_until_idle(max_steps=32)
    frozen = tobs.metrics.counter("engine.compile_count").value
    n0 = tusage.usage_log.emitted
    for _ in range(3):
        r = eng.submit(rng.randint(0, V, 6).astype(np.int32), 2,
                       ttr.RequestTrace())
        eng.run_until_idle(max_steps=32)
        r.result(timeout=30)
    assert tobs.metrics.counter("engine.compile_count").value == frozen
    assert eng.counters["compile_count"] == 2
    assert tusage.usage_log.emitted == n0 + 3


def test_finish_emits_one_usage_record_behind_its_latch(models):
    _, tm = models[11]
    eng = DecodeEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                        min_bucket=8), device="cpu")
    r = eng.submit(np.arange(5, dtype=np.int32), 2)
    n0 = tusage.usage_log.emitted
    eng.run_until_idle()
    r._finish("late second finish")
    assert tusage.usage_log.emitted == n0 + 1
    assert r.trace.error is None and r.trace.phase() == "done"


# ---------------------------------------------- serve_loop and watchdogs

def _serve_loop_stall(eng, side, tmp_path, monkeypatch):
    """`serve_loop` on its own thread with its watchdog (deadline 0.5 s);
    requests submitted from this thread; a step delayed 2 s by the
    ``engine.step_delay`` fault. Returns the dump count, the dumps'
    payload keys, event kinds and stalled requests' phases, and the
    outputs."""
    obs, fr, tr, _ = SIDE[side]
    faults = jfaults if side == "jax" else tfaults
    d = tmp_path / side
    monkeypatch.setenv("PADDLE_WATCHDOG_S", "0.5")
    monkeypatch.setenv("PADDLE_WATCHDOG_DIR", str(d))
    e0 = obs.metrics.snapshot()["counters"].get("engine.loop_errors", 0)
    warm = eng.submit(_ids(0, 5), 4)        # the JAX programs compile here
    eng.run_until_idle()
    warm.result(timeout=0)
    stop = threading.Event()
    loop = threading.Thread(target=eng.serve_loop, args=(stop, 0.01))
    loop.start()
    try:
        first = eng.submit(_ids(1, 5), 4, tr.RequestTrace())
        first.result(timeout=60)
        assert not d.exists()                # a healthy loop: no dump
        with faults.scoped("engine.step_delay", delay_s=2.0, times=1):
            stalled = eng.submit(_ids(2, 6), 6, tr.RequestTrace())
            out = stalled.result(timeout=60)
    finally:
        stop.set()
        loop.join(timeout=60)
    dumps = sorted(d.glob("watchdog_engine_*.json"))
    payloads = [json.load(open(p)) for p in dumps]
    late = []
    try:
        eng.submit(_ids(3, 4), 2)
    except RuntimeError as e:
        late.append(str(e))
    errors = obs.metrics.snapshot()["counters"].get("engine.loop_errors",
                                                    0) - e0
    return (len(dumps), [sorted(p) for p in payloads],
            [sorted({e["kind"] for e in p["events"]} & {
                "engine.submit", "engine.step", "engine.admit"})
             for p in payloads],
            [[t["phase"] for t in p["traces"]
              if t["request_id"] == stalled.request_id]
             for p in payloads],
            [p["stalled_for_s"] >= 0.5 for p in payloads],
            first.result(0).tolist(), out.tolist(), late, errors,
            loop.is_alive())


def test_serve_loop_watchdog_dumps_one_stall_as_jax(models, tmp_path,
                                                    monkeypatch):
    jm, tm = models[11]
    cfg = dict(page_size=4, max_slots=2, min_bucket=8)
    got = {}
    for side, eng in (("jax", JEngine(jm, JConfig(**cfg))),
                      ("port", DecodeEngine(tm, EngineConfig(**cfg),
                                            device="cpu"))):
        got[side] = _serve_loop_stall(eng, side, tmp_path, monkeypatch)
    assert got["port"] == got["jax"]
    n, keys, kinds, phases, long_enough, _, _, late, errors, alive = \
        got["port"]
    assert n == 1 and long_enough == [True] and not alive
    assert kinds == [["engine.admit", "engine.step", "engine.submit"]]
    assert phases[0] and phases[0][0] in ("decode", "prefill", "queued")
    assert "traces" in keys[0] and "slo" in keys[0]
    assert late == ["engine stopped: engine stopped (server shutdown)"]
    assert errors == 0


def test_serve_loop_dies_loudly_and_aborts_waiters(models):
    """A step raising inside `serve_loop` (the ``engine.crash`` fault)
    aborts every waiter with the loop's error, counts
    ``engine.loop_errors`` and re-raises on the loop's thread."""
    _, tm = models[11]
    eng = DecodeEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                        min_bucket=8), device="cpu")
    e0 = tobs.metrics.counter("engine.loop_errors").value
    raised = []

    def run():
        try:
            eng.serve_loop(threading.Event(), 0.01)
        except tfaults.FaultInjected as e:
            raised.append(e)
    tfaults.arm("engine.crash", exc=tfaults.FaultInjected, times=1)
    r = eng.submit(_ids(4, 5), 4)
    loop = threading.Thread(target=run)
    loop.start()
    loop.join(timeout=60)
    with pytest.raises(RuntimeError, match="engine loop died: "
                                           "FaultInjected"):
        r.result(timeout=5)
    assert raised and tobs.metrics.counter("engine.loop_errors").value \
        == e0 + 1


def test_engine_watchdog_idle_and_disabled(models, tmp_path, monkeypatch):
    _, tm = models[11]
    eng = DecodeEngine(tm, EngineConfig(page_size=4, max_slots=1),
                       device="cpu")
    wd = eng.start_watchdog(deadline_s=0.1, dump_dir=str(tmp_path),
                            interval_s=0.03)
    try:
        time.sleep(0.4)                   # no work: busy() is False
    finally:
        wd.stop()
    assert wd.dump_count == 0
    monkeypatch.setenv("PADDLE_WATCHDOG_S", "0")
    assert eng.start_watchdog() is None
    r = eng.submit(_ids(5, 5), 3)
    assert [t.request_id for t in eng.active_traces()] == [r.request_id]
    eng.run_until_idle()
    assert eng.active_traces() == []


# ------------------------------------------------------------- train step

SMALL = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=32,
             hidden_dropout=0.0, attention_dropout=0.0)
TRAIN_COUNTERS = ("train.steps", "train.microbatches", "train.tokens",
                  "train.bad_steps", "train.compile_count")
TRAIN_TIMED = ("train.compile_ms", "train.step_ms", "train.mfu",
               "train.goodput_tokens_per_s")


def _train_capture(obs, fr, run):
    snap = obs.metrics.snapshot()
    c0, h0 = snap["counters"], snap["histograms"]
    g = obs.metrics._gauges
    saved = {k: g[(k, ())].value for k in TRAIN_TIMED if (k, ()) in g}
    for k in saved:
        g[(k, ())].set(-1)
    seq0 = fr.flight.events()[-1]["seq"] if fr.flight.events() else 0
    try:
        losses = run()
        snap = obs.metrics.snapshot()
    finally:
        for k, v in saved.items():
            g[(k, ())].set(v)
    events = [{k: v for k, v in e.items() if k not in ("seq", "t", "ms",
                                                       "mfu", "loss")}
              for e in fr.flight.events() if e["seq"] > seq0
              and e["kind"].startswith("train.")]
    gauges = {k: snap["gauges"].get(k, -1) for k in TRAIN_TIMED}
    return {"counters": {k: snap["counters"].get(k, 0) - c0.get(k, 0)
                         for k in TRAIN_COUNTERS},
            "step_seconds": snap["histograms"]["train.step_seconds"][
                "count"] - h0.get("train.step_seconds", {}).get("count", 0),
            "set": {k: v != -1 for k, v in gauges.items()},
            "mfu": gauges["train.mfu"],
            "state": {k: snap["gauges"][k] for k in ("train.opt_state_bytes",
                                                     "train.zero1")},
            "events": events, "losses": losses}


def test_train_step_series_and_events_match_jax(tmp_path, monkeypatch):
    """Three steps on each package's step (the first its compile step, the
    third poisoned with NaN) under an armed watchdog: equal ``train.*``
    counter deltas, the same gauges set, ``train.step_seconds`` once,
    ``train.opt_state_bytes`` and ``train.zero1`` equal, the same flight
    events (losses within 1e-5), and no dump."""
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)
    lr, clip = 1e-3, 1.0
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL))
    jopt = paddle.optimizer.AdamW(learning_rate=lr,
                                  parameters=jm.parameters(),
                                  grad_clip=jnn.ClipGradByGlobalNorm(clip))
    js = JaxScanTrainStep(jm, jopt, microbatches=2)
    tree = lambda t: jax.tree_util.tree_map(np.array, t)   # noqa: E731
    params, opt_state = train_state_from_numpy(tree(js._params),
                                               tree(js._opt_state), "cpu")
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL))
    tm.load_state_dict(params)
    topt = AdamW(learning_rate=lr, clip_norm=clip)
    topt.state = opt_state
    ts = ScanTrainStep(tm, topt, microbatches=2, device="cpu")
    ids = np.random.RandomState(0).randint(0, SMALL["vocab_size"], (4, 17))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64)

    def jrun():
        wd = js.start_watchdog(deadline_s=60, dump_dir=str(tmp_path / "j"))
        out = [js.step(x, y), js.step(x, y)]
        with jfaults.scoped("train.step_nan"):
            out.append(js.step(x, y))
        wd.stop()
        return out, wd.dump_count

    def trun():
        wd = ts.start_watchdog(deadline_s=60, dump_dir=str(tmp_path / "t"))
        out = [ts.step(x, y), ts.step(x, y),
               ts.step(x, y, inject_nan=True)]
        wd.stop()
        return out, wd.dump_count

    want = _train_capture(jobs, jfr, jrun)
    got = _train_capture(tobs, tfr, trun)
    (jl, jd), (tl, td) = want.pop("losses"), got.pop("losses")
    assert jd == td == 0
    assert np.allclose(tl[:2], jl[:2], rtol=0, atol=1e-5) and \
        np.isnan(tl[2]) and np.isnan(jl[2])
    jmfu, tmfu = want.pop("mfu"), got.pop("mfu")
    assert got == want
    assert got["counters"] == {"train.steps": 3, "train.microbatches": 6,
                               "train.tokens": 128, "train.bad_steps": 1,
                               "train.compile_count": 1}
    assert [e["kind"] for e in got["events"]] == [
        "train.dispatch", "train.step", "train.dispatch", "train.step",
        "train.dispatch", "train.bad_step"]
    assert got["events"][-1]["injected"] is True
    # both divide by the JAX package's nominal 1e12 FLOP/s on the CPU
    assert 0 < tmfu <= 1 and 0 < jmfu <= 1
    assert ts.records[-1]["mfu"] is None        # a CPU record holds none


def test_train_watchdog_dumps_a_stalled_loop(models, tmp_path):
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL))
    ts = ScanTrainStep(tm, AdamW(learning_rate=1e-3), device="cpu")
    wd = ts.start_watchdog(deadline_s=0.1, dump_dir=str(tmp_path),
                           interval_s=0.02)
    try:
        for _ in range(500):
            if wd.dump_count:
                break
            time.sleep(0.02)
    finally:
        wd.stop()
    assert wd.dump_count == 1
    payload = json.load(open(wd.dump_paths[0]))
    assert payload["watchdog"] == "train" and payload["progress"] == 0
