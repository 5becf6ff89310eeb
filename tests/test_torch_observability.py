"""The port's observability modules (`paddle_tpu_torch/observability/`)
held against the JAX package's (`paddle_tpu/observability/`), module by
module, on the CPU: the same operation sequence is driven into one object
of each package and what each records must be equal.

- The metrics registry: counters, gauges, histograms (count, sum, min,
  max, mean and the reservoir's p50 / p99 and percentiles), timers, the
  labelled-series LRU, reset, spans and per-trace rings, snapshots, the
  Chrome trace (`tests/test_observability.py:30-135`).
- Prometheus text: byte-equal to the JAX text for the same registry
  content, and within the exposition grammar of
  `tests/test_tracing.py::check_exposition` (`:320-360`); the port's HTTP
  exporter serves it on localhost.
- `RequestTrace` (phases, `to_dict`, the `serve.*` SLO series and the
  locked `mark_done`), request ids and the trace-context wire words.
- Usage records and the `UsageLog` ring and JSONL rotation; SLO parsing
  and every burn-rate transition on an injected clock
  (`tests/test_slo_usage.py:66-300`, `:406-500`); the flight recorder and
  the watchdog's dump counts and payloads.

Time-valued readings (span timestamps and durations, a timer's histogram,
a trace's seconds) are compared by count and key set; everything else
exactly. Each registry compared is a fresh `MetricsRegistry`; the
process-wide ones are read as deltas, never reset.
"""
import json
import threading
import urllib.error
import urllib.request

import pytest

import paddle_tpu.observability as jobs
import paddle_tpu_torch.observability as tobs
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import prometheus as jprom
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import tracing as jtr
from paddle_tpu.observability import usage as jusage
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import prometheus as tprom
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.observability import tracing as ttr
from paddle_tpu_torch.observability import usage as tusage
from tests.test_tracing import check_exposition

SIDES = {"jax": (jobs, jprom, jtr, jusage, jslo, jfr),
         "port": (tobs, tprom, ttr, tusage, tslo, tfr)}


def each(fn):
    """``fn(*modules)`` for the JAX package's modules and the port's;
    returns ``(jax result, port result)``."""
    return fn(*SIDES["jax"]), fn(*SIDES["port"])


def equal(fn):
    got_jax, got_port = each(fn)
    assert got_port == got_jax
    return got_port


def untimed(snap, timed=()):
    """A snapshot with the histograms named in ``timed`` reduced to their
    count (their values are seconds)."""
    out = json.loads(json.dumps(snap))
    for k in timed:
        out["histograms"][k] = {"count": out["histograms"][k]["count"]}
    return out


# ---------------------------------------------------------------- registry

def test_registry_semantics_match_jax():
    def run(obs, *_):
        reg = obs.MetricsRegistry()
        c = reg.counter("x.count")
        c.inc()
        c.inc(4)
        reg.counter("x.count", op="a").inc(2)
        g = reg.gauge("x.gauge")
        g.set(3.5)
        g.inc()
        g.dec(0.5)
        h = reg.histogram("x.hist")
        for v in (1.0, 2.0, 3.0, 4.0):
            h.observe(v)
        reg.histogram("x.empty")
        with reg.timer("x.op", kind="k"):
            pass
        same_handle = reg.counter("x.count") is c
        other = reg.counter("x.count", op="a") is not c
        return (untimed(reg.snapshot(), ["x.op{kind=k}"]), same_handle,
                other, c.value, g.value, h.summary())
    snap, same_handle, other, cv, gv, s = equal(run)
    assert same_handle and other and cv == 5 and gv == 4.0
    assert snap["counters"]["x.count{op=a}"] == 2
    assert s["p99"] == 4.0 and s["mean"] == 2.5
    assert snap["histograms"]["x.empty"]["p50"] is None


@pytest.mark.parametrize("n", [1, 10, 600])
def test_histogram_percentiles_match_jax(n):
    """The reservoir keeps the last 512 observations; `percentile` and
    `summary` read one index (`_pct_index`)."""
    def run(obs, *_):
        h = obs.MetricsRegistry().histogram("p")
        for i in range(n):
            h.observe((i * 37 % 101) / 7.0)
        return (h.summary(), [h.percentile(q) for q in (0, 1, 25, 50, 90,
                                                         99, 100)],
                [obs._pct_index(n, q) for q in (0, 50, 99, 100)])
    s, pcts, _ = equal(run)
    assert s["count"] == n and pcts[3] == s["p50"] and pcts[5] == s["p99"]


def test_labelled_series_lru_matches_jax():
    """Past 256 labelled series the least recently used is evicted and
    counted in ``metrics.series_evictions``; unlabelled series never."""
    def run(obs, *_):
        reg = obs.MetricsRegistry()
        reg.counter("keep").inc()
        for i in range(300):
            reg.counter("lab", replica=i).inc(i)
            if i % 50 == 0:
                reg.counter("lab", replica=0).inc()     # stays recent
        snap = reg.snapshot()
        return sorted(snap["counters"].items())
    counters = dict(equal(run))
    assert counters["metrics.series_evictions"] == 300 - 256
    assert counters["lab{replica=0}"] == 6 and "keep" in counters
    assert "lab{replica=1}" not in counters


def test_reset_keeps_handles_and_threads_count_alike():
    def run(obs, *_):
        reg = obs.MetricsRegistry()
        c = reg.counter("r.count")
        c.inc(7)
        reg.reset()
        zero = reg.snapshot()["counters"]["r.count"]
        c.inc()

        def work():
            for _ in range(500):
                reg.counter("t.count").inc()
                reg.histogram("t.hist").observe(1.0)
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = reg.snapshot()
        return (zero, snap["counters"]["r.count"],
                snap["counters"]["t.count"],
                snap["histograms"]["t.hist"]["count"])
    assert equal(run) == (0, 1, 2000, 2000)


def test_spans_chrome_trace_and_trace_rings_match_jax(tmp_path):
    def run(obs, *_):
        reg = obs.MetricsRegistry()
        reg.set_node_identity(role="replica", node_id="r0")
        with reg.timer("span.a"):
            pass
        reg.add_span("span.b", obs._EPOCH, 1e-3, cat="test",
                     args={"request_id": "req-x"})
        for i in range(70):                      # 64 trace rings kept
            reg.add_span("hop", obs._EPOCH, 2e-6, cat="request",
                         trace_id=f"{i:032x}", parent="ab" * 8,
                         span_id="cd" * 8)
        reg.counter("c").inc(3)
        path = reg.export_chrome_trace(str(tmp_path / f"{obs.__name__}"
                                           / "trace.json"))
        data = json.load(open(path))
        events = [(e["name"], e["cat"], e["ph"], e.get("args"), e["dur"])
                  for e in data["traceEvents"] if e["name"] != "span.a"]
        kept = reg.spans_for_trace(f"{69:032x}")
        dropped = reg.spans_for_trace(f"{0:032x}")
        ident = reg.node_identity()
        return (sorted({e["name"] for e in data["traceEvents"]}), events,
                data["metrics"]["counters"], data["displayTimeUnit"],
                [(e["name"], e["args"], e["dur"]) for e in kept], dropped,
                (ident["role"], ident["node_id"]),
                reg.chrome_trace()["traceEvents"][0]["name"])
    names, events, counters, unit, kept, dropped, ident, first = equal(run)
    assert names == ["hop", "span.a", "span.b"] and first == "span.a"
    assert kept[0][1] == {"trace_id": f"{69:032x}", "parent": "ab" * 8,
                          "span": "cd" * 8}
    assert dropped == [] and counters["c"] == 3 and ident == ("replica",
                                                              "r0")


# -------------------------------------------------------------- prometheus

def _fill(obs):
    reg = obs.MetricsRegistry()
    reg.counter("promtest.count", mode="a b").inc(3)
    reg.counter("promtest.esc", path='a"b\\c\nd').inc()
    reg.counter("engine.kvtier.spills_host").inc(12)
    reg.counter("9weird-name!").inc(0.25)
    reg.gauge("promtest.gauge").set(-1.5)
    reg.gauge("promtest.big").set(1e16)
    reg.gauge("promtest.nan").set(float("nan"))
    reg.gauge("promtest.inf").set(float("inf"))
    reg.gauge("promtest.ninf").set(float("-inf"))
    h = reg.histogram("promtest.seconds")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    reg.histogram("promtest.empty_seconds")
    for i in range(700):
        reg.histogram("engine.device_ms").observe(i / 3.0)
    return reg


def test_prometheus_text_is_byte_equal_to_jax():
    def run(obs, prom, *_):
        reg = _fill(obs)
        return prom.render(reg), reg.to_prometheus(), prom.CONTENT_TYPE, \
            prom._name("engine.steps"), prom._name("9weird-name!")
    text, via_registry, ctype, n1, n2 = equal(run)
    assert via_registry == text
    typed = check_exposition(text)
    assert typed["promtest_count"] == "counter"
    assert typed["promtest_seconds"] == "summary"
    assert typed["engine_device_ms"] == "summary"
    assert 'promtest_count{mode="a b"} 3' in text
    assert 'path="a\\"b\\\\c\\nd"' in text
    assert 'promtest_seconds{quantile="0.5"} 0.2' in text
    assert "promtest_empty_seconds_count 0" in text
    assert "promtest_empty_seconds{quantile" not in text
    assert (n1, n2) == ("engine_steps", "_9weird_name_")
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"


def test_http_exporter_serves_the_port_registry():
    reg = _fill(tobs)
    srv = tprom.start_http_exporter(port=0, registry=reg)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == tprom.CONTENT_TYPE
            body = r.read().decode()
        assert body == tprom.render(reg) == jprom.render(_fill(jobs))
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/bogus",
                                   timeout=10)
    finally:
        srv.shutdown()


def test_process_registry_exposition_passes_the_grammar():
    """The port's process-wide registry, whatever the engines and steps of
    this process have written into it, renders within the grammar."""
    tobs.metrics.counter("promtest.port", mode="x").inc()
    check_exposition(tobs.to_prometheus())


# ----------------------------------------------------------------- tracing

def _hist_counts(obs, names):
    snap = obs.metrics.snapshot()["histograms"]
    return {n: snap.get(n, {}).get("count", 0) for n in names}


SLO_HISTS = ("serve.ttft_seconds", "serve.tpot_seconds", "serve.e2e_seconds")


def test_request_trace_matches_jax():
    """Phases through one request's life, its record's keys and what it
    lands in the SLO series: an ok request with 4 tokens (TPOT), one with
    one token (no TPOT), a failed one (an error count, no e2e)."""
    def run(obs, _, tr, *__):
        h0 = _hist_counts(obs, SLO_HISTS)
        e0 = obs.metrics.snapshot()["counters"].get("serve.request_errors",
                                                    0)
        phases, dicts = [], []
        for n, error in ((4, None), (1, None), (0, "Cancelled: gone")):
            t = tr.RequestTrace()
            ph = [t.phase()]
            t.mark_submit()
            ph.append(t.phase())
            t.mark_admitted()
            t.mark_admitted()                       # idempotent
            ph.append(t.phase())
            if n:
                t.mark_first_token()
                t.mark_tokens(n - 1)
                ph.append(t.phase())
            t.mark_done(error)
            t.mark_done("late")                     # the latch holds
            ph.append(t.phase())
            d = t.to_dict()
            dicts.append({k: (v if not k.startswith("t_") else v is None)
                          for k, v in d.items() if k != "request_id"})
            phases.append(ph)
            assert d["request_id"].startswith("req-")
        h1 = _hist_counts(obs, SLO_HISTS)
        e1 = obs.metrics.snapshot()["counters"]["serve.request_errors"]
        return (phases, dicts, {k: h1[k] - h0[k] for k in SLO_HISTS},
                e1 - e0)
    phases, dicts, hists, errors = equal(run)
    assert phases[0] == ["accepted", "queued", "prefill", "decode", "done"]
    assert phases[2][-1] == "error" and dicts[2]["error"] == \
        "Cancelled: gone"
    assert dicts[0]["n_tokens"] == 4
    assert hists == {"serve.ttft_seconds": 2, "serve.tpot_seconds": 1,
                     "serve.e2e_seconds": 2} and errors == 1


def test_mark_done_from_two_threads_accounts_once():
    for obs, _, tr, *__ in SIDES.values():
        e0 = _hist_counts(obs, ["serve.e2e_seconds"])["serve.e2e_seconds"]
        t = tr.RequestTrace()
        barrier = threading.Barrier(8)

        def close():
            barrier.wait()
            t.mark_done()
        threads = [threading.Thread(target=close) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert _hist_counts(obs, ["serve.e2e_seconds"])[
            "serve.e2e_seconds"] - e0 == 1


def test_trace_context_words_match_jax():
    tid, span = ttr.mint_trace()
    assert len(tid) == 32 and len(span) == 16 and len(ttr.new_span_id()) == 16
    for ctx in ((tid, span), (tid, None), (None, None)):
        words = ttr.trace_to_words(*ctx)
        assert words == jtr.trace_to_words(*ctx)
        assert len(words) == ttr.TRACE_WORDS == jtr.TRACE_WORDS
        assert ttr.words_to_trace(words) == jtr.words_to_trace(words) == ctx

    def attach(_, __, tr, *___):
        t = tr.RequestTrace(request_id="req-fixed")
        t.attach_context(tid, span)
        t.attach_context("ff" * 16, "ee" * 8)      # first context wins
        return t.request_id, t.trace_id, t.parent_span, len(t.span_id)
    assert equal(attach) == ("req-fixed", tid, span, 16)
    a, b = ttr.new_request_id(), ttr.new_request_id()
    assert a.startswith("req-") and int(b[4:]) == int(a[4:]) + 1


# ------------------------------------------------------------------- usage

class _Req:
    """The fields `emit_request` reads from an engine request."""

    def __init__(self, tr, n, error=None):
        import numpy as np
        self.trace = tr.RequestTrace(request_id=f"req-u{n}")
        self.trace.mark_submit()
        self.trace.mark_admitted()
        if error is None:
            self.trace.mark_first_token()
        self.trace.mark_done(error)
        self.prompt = np.arange(n, dtype=np.int32)
        self.tenant = None
        self.imported = False
        self.u_prefill_computed, self.u_prefill_saved = n - 4, 4
        self.u_generated, self.u_spec_accepted = 2 * n, n // 2
        self.u_page_steps, self.u_migrations = 3 * n, 0


def test_usage_records_and_counters_match_jax():
    names = ("requests", "errors", "prompt_tokens",
             "prefill_computed_tokens", "prefill_saved_tokens",
             "generated_tokens", "spec_accepted_tokens", "kv_page_steps",
             "migrations")

    def run(obs, _, tr, usage, *__):
        c0 = obs.metrics.snapshot()["counters"]
        log = usage.UsageLog(capacity=8)
        for n, err in ((8, None), (12, "DeadlineExceeded: late"),
                       (9, "?! weird: x")):
            usage.emit_request(_Req(tr, n, err), err, log=log)
        usage.emit_request(object(), None, log=log)   # never raises
        c1 = obs.metrics.snapshot()["counters"]
        recs = [{k: (v if k not in ("t", "queue_wait_s", "ttft_s", "e2e_s")
                     else v is None) for k, v in r.items()}
                for r in log.records()]
        return recs, {n: c1["usage." + n] - c0.get("usage." + n, 0)
                      for n in names}, log.emitted
    recs, deltas, emitted = equal(run)
    assert [r["error"] for r in recs[:3]] == [None, "DeadlineExceeded",
                                              "Error"]
    assert recs[1]["ttft_s"] is True and recs[0]["ttft_s"] is False
    assert deltas["requests"] == emitted == 4 and deltas["errors"] == 2
    assert deltas["prompt_tokens"] == 29


def test_usage_log_ring_and_rotation_match_jax(tmp_path):
    def run(_, __, ___, usage, *____):
        d = tmp_path / usage.__name__
        d.mkdir()
        path = str(d / "usage.jsonl")
        log = usage.UsageLog(capacity=4)
        log.configure(path, max_bytes=300, keep=2)
        for i in range(12):
            log.emit({"request_id": f"r{i:02d}", "prompt_tokens": i,
                      "pad": "x" * 40})
        files = {}
        for suffix in ("", ".1", ".2", ".3"):
            try:
                files[suffix] = open(path + suffix).read()
            except FileNotFoundError:
                pass
        log.configure(None)
        log.emit({"request_id": "after"})
        size = len(open(path).read())
        ring = [r["request_id"] for r in log.records()]
        last = log.last(2)
        log.reset()
        return files, size, ring, last, log.emitted, log.records()
    files, size, ring, last, emitted, after = equal(run)
    assert set(files) == {"", ".1", ".2"} and size == len(files[""])
    assert ring == ["r09", "r10", "r11", "after"] and emitted == 0
    assert after == [] and last[-1]["request_id"] == "after"


def test_typed_error_matches_jax():
    for err in (None, "", "Cancelled: client went away", "DeadlineExceeded",
                "?! weird: stuff", "Overloaded: engine queue full",
                "engine stopped: x"):
        assert tusage.typed_error(err) == jusage.typed_error(err)


# --------------------------------------------------------------------- SLO

RATIO = "serve.request_errors / serve.requests < 10%"


def _ratio_snap(errors, requests):
    return {"counters": {"serve.request_errors": errors,
                         "serve.requests": requests}}


def _hist_snap(count, p99, total=0.0):
    return {"histograms": {"serve.ttft_seconds": {
        "count": count, "total": total, "p50": p99 / 2, "p99": p99}}}


def test_slo_parsing_matches_jax():
    texts = ["err=" + RATIO, "ttft=serve.ttft_seconds p99 < 2.0s",
             "m=serve.e2e_seconds mean < 1.5;fast=5;slow=10;burn=2;"
             "pending=1;clear=3", "p=serve.tpot_seconds p50 < 0.2"]
    for text in texts:
        assert tslo.parse_slo(text).to_dict() == \
            jslo.parse_slo(text).to_dict()
    for bad in ("nonsense", "x=a / b < 1%;bogus=1", "=a p99 < 1",
                "x=a p75 < 1"):
        errs = []
        for slo in (jslo, tslo):
            with pytest.raises(ValueError) as e:
                slo.parse_slo(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    for slo in (jslo, tslo):
        with pytest.raises(ValueError, match="threshold"):
            slo.SLOSpec("z", "z", "ratio", 0.0)
        with pytest.raises(ValueError, match="fast window"):
            slo.SLOSpec("z", "z", "ratio", 1.0, fast_window_s=9,
                        slow_window_s=3)
        with pytest.raises(ValueError, match="duplicate"):
            slo.SLOEvaluator([slo.SLOSpec.parse("d", RATIO)] * 2)


# (spec keywords, [(snapshot, now), ...]): the lifecycle drills of
# tests/test_slo_usage.py::TestLifecycle
LIFECYCLES = {
    "fires_then_resolves": (
        ("err", RATIO, dict(fast_window_s=10, slow_window_s=30)),
        [(_ratio_snap(0, 0), 0.0), (_ratio_snap(50, 100), 40.0),
         (_ratio_snap(50, 200), 80.0)]),
    "pending_and_clear_dwell": (
        ("err", RATIO, dict(fast_window_s=10, slow_window_s=30,
                            pending_for_s=20, clear_for_s=20)),
        [(_ratio_snap(0, 0), 0.0), (_ratio_snap(50, 100), 40.0),
         (_ratio_snap(100, 200), 50.0), (_ratio_snap(150, 300), 61.0),
         (_ratio_snap(150, 400), 100.0), (_ratio_snap(150, 500), 110.0),
         (_ratio_snap(150, 600), 125.0)]),
    "pending_blip_reverts": (
        ("err", RATIO, dict(fast_window_s=10, slow_window_s=30,
                            pending_for_s=30)),
        [(_ratio_snap(0, 0), 0.0), (_ratio_snap(50, 100), 40.0),
         (_ratio_snap(50, 300), 60.0)]),
    "unknown_windows_never_fire": (
        ("err", RATIO, dict(fast_window_s=10, slow_window_s=30)),
        [(_ratio_snap(50, 100), 0.0), (_ratio_snap(90, 100), 5.0)]),
    "slow_window_suppresses_blip": (
        ("err", RATIO, dict(fast_window_s=10, slow_window_s=100)),
        [(_ratio_snap(0, 0), 0.0), (_ratio_snap(0, 1000), 90.0),
         (_ratio_snap(60, 1100), 101.0)]),
    "percentile": (
        ("ttft", "serve.ttft_seconds p99 < 2.0s",
         dict(fast_window_s=10, slow_window_s=30)),
        [(_hist_snap(0, 0.5), 0.0), (_hist_snap(10, 3.0), 40.0),
         (_hist_snap(10, 3.0), 80.0), (_hist_snap(20, 1.0), 120.0)]),
    "mean_with_burn": (
        ("mean", "serve.ttft_seconds mean < 1.0",
         dict(fast_window_s=10, slow_window_s=30, burn=2.0)),
        [(_hist_snap(0, 0, 0.0), 0.0), (_hist_snap(10, 1, 15.0), 40.0),
         (_hist_snap(20, 1, 45.0), 80.0), (_hist_snap(30, 1, 50.0),
                                           120.0)]),
}


@pytest.mark.parametrize("case", list(LIFECYCLES))
def test_slo_lifecycle_matches_jax(case):
    """Every evaluation's status, the transition ring, the alert metrics
    and the evaluator's exposition lines, on injected snapshots and an
    injected clock (no sleep, no thread)."""
    (name, objective, kw), drill = LIFECYCLES[case]

    def run(obs, _, __, ___, slo, fr):
        scope = f"{case}-{obs.__name__}"
        c0 = obs.metrics.snapshot()["counters"]
        ev = slo.SLOEvaluator([slo.SLOSpec.parse(name, objective, **kw)],
                              scope=scope)
        n0 = len(fr.flight.events())
        statuses = [ev.evaluate(snap, now=now) for snap, now in drill]
        c1 = obs.metrics.snapshot()["counters"]
        gauges = {k.replace(scope, "S"): v for k, v in
                  obs.metrics.snapshot()["gauges"].items() if scope in k}
        alerts = [e for e in fr.flight.events()[n0:]
                  if e["kind"] == "slo_alert"]
        return ([[{k: v for k, v in s.items() if k != "scope"}
                  for s in st] for st in statuses],
                [{k: v for k, v in e.items() if k != "scope"}
                 for e in ev.history()],
                [{k: v for k, v in a.items()
                  if k not in ("seq", "t", "scope")} for a in alerts],
                {k: c1.get(k, 0) - c0.get(k, 0) for k in
                 ("slo.alerts_fired", "slo.alerts_resolved",
                  "slo.evaluations")},
                gauges, ev.to_prometheus().replace(scope, "S"),
                {k: v for k, v in ev.alerts_payload().items()
                 if k not in ("scope", "active", "status", "history")})
    statuses, history, alerts, counts, gauges, prom, payload = equal(run)
    assert counts["slo.evaluations"] == len(drill)
    assert len(alerts) == len(history) == counts["slo.alerts_fired"] + \
        counts["slo.alerts_resolved"]
    assert prom.startswith("# TYPE slo_alert_firing gauge")
    if case == "fires_then_resolves":
        assert [s[0]["state"] for s in statuses] == ["ok", "firing", "ok"]
        assert [e["state"] for e in history] == ["firing", "resolved"]
    if case == "unknown_windows_never_fire":
        assert history == []


def test_active_alerts_and_recent_events_include_the_port_evaluator():
    ev = tslo.SLOEvaluator([tslo.SLOSpec.parse(
        "port_alert", RATIO, fast_window_s=10, slow_window_s=30)])
    ev.evaluate(_ratio_snap(0, 0), now=0.0)
    ev.evaluate(_ratio_snap(50, 100), now=40.0)
    assert any(a["slo"] == "port_alert" for a in tslo.active_alerts())
    assert any(e["slo"] == "port_alert" for e in tslo.recent_events())
    # the JAX package's evaluators are its own
    assert not any(a["slo"] == "port_alert" for a in jslo.active_alerts())


# ------------------------------------------------- flight recorder/watchdog

def test_flight_ring_matches_jax():
    def run(*mods):
        fr = mods[5].FlightRecorder(capacity=8)
        for i in range(20):
            fr.record("tick", i=i, tag="x")
        evs = fr.events()
        out = [{k: v for k, v in e.items() if k != "t"} for e in evs]
        fr.clear()
        return out, fr.events()
    evs, cleared = equal(run)
    assert [e["i"] for e in evs] == list(range(12, 20)) and cleared == []
    assert [e["seq"] for e in evs] == list(range(13, 21))


# (progress readings, busy flags, poll times): a stall, its persistence,
# progress resuming and a second stall; then an idle loop
WATCHDOG_POLLS = (
    [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2],
    [True] * 12,
    [0.0, 0.1, 0.2, 0.4, 0.9, 1.0, 1.1, 1.2, 1.5, 1.6, 2.0, 2.1])


@pytest.mark.parametrize("busy", [True, False], ids=["busy", "idle"])
def test_watchdog_dump_counts_match_jax(tmp_path, busy):
    """The one-dump-per-stall latch, driven by `check(now=)`: a stall past
    the deadline dumps once however long it lasts, progress re-arms it, a
    second stall dumps again; an idle loop never dumps."""
    progress, _, times = WATCHDOG_POLLS

    def run(obs, _, tr, __, slo, fr):
        d = tmp_path / fr.__name__ / str(busy)
        key = "watchdog.stalls{loop=unit}"
        s0 = obs.metrics.snapshot()["counters"].get(key, 0)
        state = {"i": 0}
        stalled = tr.RequestTrace(request_id="req-stalled")
        stalled.mark_submit()
        wd = fr.Watchdog("unit", progress=lambda: progress[state["i"]],
                         busy=lambda: busy, deadline_s=0.25,
                         dump_dir=str(d), traces=lambda: [stalled])
        counts = []
        for i, now in enumerate(times):
            state["i"] = i
            wd.check(now=now)
            counts.append(wd.dump_count)
        payloads = [json.load(open(p)) for p in wd.dump_paths]
        keys = [sorted(p) for p in payloads]
        shapes = [(p["watchdog"], p["progress"], p["deadline_s"],
                   [t["request_id"] for t in p["traces"]],
                   [t["phase"] for t in p["traces"]],
                   sorted(p["metrics"]), sorted(p["slo"]))
                  for p in payloads]
        stalls = obs.metrics.snapshot()["counters"].get(key, 0) - s0
        return counts, keys, shapes, stalls == wd.dump_count
    counts, keys, shapes, stalls = equal(run)
    if busy:
        assert counts == [0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2]
        assert shapes[0][:4] == ("unit", 0, 0.25, ["req-stalled"])
        assert keys[0] == ["deadline_s", "events", "metrics", "pid",
                           "progress", "slo", "stalled_for_s", "traces",
                           "wall_time", "watchdog"]
    else:
        assert counts[-1] == 0
    assert stalls


def test_watchdog_thread_and_dump_ring_match_jax(tmp_path, monkeypatch):
    """The polling thread dumps one stall; `dump_ring` writes the ring and
    the snapshot; ``PADDLE_WATCHDOG_S`` / ``PADDLE_WATCHDOG_DIR`` are read
    as the JAX package reads them."""
    monkeypatch.setenv("PADDLE_WATCHDOG_S", "12.5")
    monkeypatch.setenv("PADDLE_WATCHDOG_DIR", str(tmp_path / "env"))

    def run(obs, _, __, ___, slo, fr):
        d = tmp_path / fr.__name__
        with fr.Watchdog("thread", progress=lambda: 0, deadline_s=0.05,
                         dump_dir=str(d), interval_s=0.01) as wd:
            for _ in range(500):
                if wd.dump_count:
                    break
                threading.Event().wait(0.01)
            threading.Event().wait(0.1)          # the stall persists
        ring = fr.FlightRecorder(capacity=4)
        ring.record("probe", n=1)
        path = fr.dump_ring("unit", recorder=ring, reason="test")
        payload = json.load(open(path))
        return (wd.dump_count, fr.default_deadline(),
                path.startswith(str(tmp_path / "env")),
                sorted(payload), payload["label"],
                [e["kind"] for e in payload["events"]])
    got = equal(run)
    assert got[0] == 1 and got[1] == 12.5 and got[2]
    assert got[3] == ["events", "label", "metrics", "reason"]
    monkeypatch.setenv("PADDLE_WATCHDOG_S", "bogus")
    assert tfr.default_deadline(7.0) == jfr.default_deadline(7.0) == 7.0


def test_watchdog_dump_carries_the_port_slo_section(tmp_path):
    ev = tslo.SLOEvaluator([tslo.SLOSpec.parse(
        "dump_err", RATIO, fast_window_s=10, slow_window_s=30)])
    ev.evaluate(_ratio_snap(0, 0), now=0.0)
    ev.evaluate(_ratio_snap(50, 100), now=40.0)
    tusage.usage_log.emit({"request_id": "dump-probe", "prompt_tokens": 1})
    wd = tfr.Watchdog("slo_dump_test", progress=lambda: 0,
                      dump_dir=str(tmp_path))
    payload = json.load(open(wd.dump(stalled_s=1.0, progress=0)))
    assert any(a["slo"] == "dump_err" for a in payload["slo"]["firing"])
    assert any(e["slo"] == "dump_err" for e in payload["slo"]["events"])
    assert any(r.get("request_id") == "dump-probe"
               for r in payload["slo"]["usage"])
