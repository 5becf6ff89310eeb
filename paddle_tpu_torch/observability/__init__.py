"""Process-wide runtime telemetry of the port: the metrics registry every
layer reports to (counterpart of `paddle_tpu/observability/__init__.py`,
the port's own copy: it never touches the JAX package's registry).

One thread-safe, zero-dependency registry of counters, gauges and
histograms that the serve engine, its KV tiers, the kernel registry and
the train step write into under the JAX package's metric names, and that
tests, `chip_smoke.py` and a scraper (`prometheus.py`) read.

Design:
- **Counter**: monotonically increasing float/int (`inc`).
- **Gauge**: last-write-wins scalar (`set`).
- **Histogram**: count/sum/min/max plus a bounded reservoir of recent
  observations for p50/p99; `time()` returns a context manager that
  observes the elapsed seconds AND records a span for Chrome-trace export.
- Metrics are keyed by ``(name, sorted(labels))``; the flat snapshot key is
  ``name{k=v,...}`` (Prometheus-style).
- ``snapshot()`` -> plain dict (JSON-ready); ``to_json()`` serializes it;
  ``chrome_trace()`` / ``export_chrome_trace(path)`` emit the recorded spans
  in Chrome ``traceEvents`` format (load with `chrome://tracing` or
  Perfetto).

Everything here is stdlib-only ON PURPOSE: instrumented modules import this
at module scope, so it must never create an import cycle or pull in torch.

Counters count real calls: PyTorch runs eagerly, and a replayed CUDA graph
adds what its capture counted (`inference/graphs.py`).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
    "counter", "gauge", "histogram", "timer", "snapshot", "reset",
    "chrome_trace", "export_chrome_trace", "to_prometheus",
    "set_node_identity", "node_identity", "spans_for_trace",
]

# perf_counter origin for span timestamps — one epoch per process so spans
# from every subsystem land on a shared timeline
_EPOCH = time.perf_counter()
# wall clock at the same instant: per-trace span exports are rebased onto
# unix time so the fleet collector can stitch spans from MANY processes
# (each with its own perf_counter origin) onto one timeline
_EPOCH_UNIX_US = time.time() * 1e6

_RESERVOIR = 512       # recent observations kept per histogram (percentiles)
_MAX_SPANS = 20000     # bounded span ring: old spans drop, process never grows
_MAX_TRACES = 64       # per-trace span rings kept (LRU; fleet TRACE_EXPORT)
_MAX_TRACE_SPANS = 256  # spans kept per traced request
_MAX_LABELED_SERIES = 256  # LRU cap on LABELED series (membership churn)


def _pct_index(n: int, q: float) -> int:
    """Clamped nearest-rank reservoir index for the q-th percentile of n
    sorted values — the ONE place the index math lives, so
    ``Histogram.percentile`` and ``summary()`` can never drift."""
    return min(n - 1, max(0, int(round(q / 100.0 * (n - 1)))))


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _flatname(name: str, labelkey: tuple) -> str:
    if not labelkey:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labelkey)
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def reset(self):
        with self._lock:
            self._value = 0

    @property
    def value(self):
        return self._value


class Gauge:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    def reset(self):
        with self._lock:
            self._value = 0

    @property
    def value(self):
        return self._value


class Histogram:
    """count/sum/min/max + bounded reservoir of the most recent observations
    (enough for p50/p99 on step-time-scale series without unbounded memory)."""

    __slots__ = ("_lock", "count", "total", "min", "max", "_recent")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._recent = collections.deque(maxlen=_RESERVOIR)

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._recent.append(v)

    def reset(self):
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = self.max = None
            self._recent.clear()

    def percentile(self, q):
        with self._lock:
            vals = sorted(self._recent)
        if not vals:
            return None
        return vals[_pct_index(len(vals), q)]

    def summary(self):
        with self._lock:
            vals = sorted(self._recent)
            count, total, mn, mx = self.count, self.total, self.min, self.max
        out = {"count": count, "total": total, "min": mn, "max": mx,
               "mean": (total / count) if count else None}
        if vals:
            out["p50"] = vals[_pct_index(len(vals), 50.0)]
            out["p99"] = vals[_pct_index(len(vals), 99.0)]
        else:
            out["p50"] = out["p99"] = None
        return out


class _Timer:
    """Context manager: observes elapsed seconds into a histogram and records
    a span on the registry's Chrome-trace timeline."""

    __slots__ = ("_reg", "_hist", "_name", "_t0")

    def __init__(self, reg, hist, name):
        self._reg = reg
        self._hist = hist
        self._name = name
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        dt = time.perf_counter() - self._t0
        self._hist.observe(dt)
        self._reg.add_span(self._name, self._t0, dt)
        return False


class MetricsRegistry:
    """Process-wide metric store. Creation is locked; each metric carries its
    own lock, so hot-path updates never contend on the registry lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}
        self._spans = collections.deque(maxlen=_MAX_SPANS)
        self._span_lock = threading.Lock()
        # fleet tracing: trace-id-hex -> deque of spans, LRU-evicted so a
        # process pays a bounded footprint no matter how many traced
        # requests pass through (guarded by _span_lock)
        self._trace_spans = collections.OrderedDict()
        # LRU over LABELED series only: (kind, name, labelkey) -> store.
        # Unlabeled series are module-lifetime handles and never evict;
        # labeled ones (replica=..., op=...) churn with fleet membership
        # and must not grow without bound (guarded by _lock).
        self._labeled = collections.OrderedDict()
        self._series_evictions = Counter()
        self._counters[("metrics.series_evictions", ())] = \
            self._series_evictions
        # who this process is in the fleet (role + registry-lease id);
        # stamped by serve/router startup, exported with every trace pull
        self._node = {"role": None, "node_id": None}

    # ------------------------------------------------------------- identity

    def set_node_identity(self, role=None, node_id=None):
        """Record this process's fleet identity (role + replica/router id
        from its registry lease). Rides every TRACE_EXPORT / DEBUG_DUMP
        payload so the collector can label spans by process."""
        if role is not None:
            self._node["role"] = str(role)
        if node_id is not None:
            self._node["node_id"] = str(node_id)

    def node_identity(self) -> dict:
        return {"role": self._node["role"], "node_id": self._node["node_id"],
                "pid": os.getpid()}

    # -------------------------------------------------------------- creation

    def _get(self, store, kind, name, labels, factory):
        key = (name, _labelkey(labels))
        m = store.get(key)
        if m is None:
            with self._lock:
                m = store.get(key)
                if m is None:
                    m = store[key] = factory()
                    if key[1]:
                        self._labeled[(kind,) + key] = store
                        while len(self._labeled) > _MAX_LABELED_SERIES:
                            (_, n2, lk2), st2 = \
                                self._labeled.popitem(last=False)
                            st2.pop((n2, lk2), None)
                            self._series_evictions.inc()
        elif key[1]:
            # labeled hit: refresh recency so ACTIVE replicas' series
            # outlive departed ones (labeled access is request-rate at
            # worst, so the lock here never touches a step-loop hot path)
            with self._lock:
                lru_key = (kind,) + key
                if lru_key in self._labeled:
                    self._labeled.move_to_end(lru_key)
        return m

    def counter(self, name, **labels) -> Counter:
        return self._get(self._counters, "c", name, labels, Counter)

    def gauge(self, name, **labels) -> Gauge:
        return self._get(self._gauges, "g", name, labels, Gauge)

    def histogram(self, name, **labels) -> Histogram:
        return self._get(self._histograms, "h", name, labels, Histogram)

    def timer(self, name, **labels) -> _Timer:
        return _Timer(self, self.histogram(name, **labels),
                      _flatname(name, _labelkey(labels)))

    # ----------------------------------------------------------------- spans

    def add_span(self, name, t0_perf, dur_s, cat="host", args=None,
                 trace_id=None, parent=None, span_id=None):
        """Record one completed host-side range for Chrome-trace export.
        ``t0_perf`` is a time.perf_counter() value; timestamps are stored in
        microseconds relative to the process epoch. ``args`` (a small dict,
        e.g. ``{"request_id": "req-7"}``) lands on the Chrome-trace event's
        ``args`` field so Perfetto can group/filter spans by request.

        When ``trace_id`` (hex string) is given the span ALSO lands in that
        trace's bounded ring for the fleet collector (TRACE_EXPORT);
        ``parent``/``span_id`` are the upstream hop's span id and this
        process's own (hex). Untraced spans take the exact pre-fleet path —
        no ring lookup, no allocation beyond the one tuple."""
        entry = (name, cat, (t0_perf - _EPOCH) * 1e6,
                 dur_s * 1e6, threading.get_ident(), args)
        with self._span_lock:
            self._spans.append(entry)
            if trace_id is not None:
                ring = self._trace_spans.get(trace_id)
                if ring is None:
                    ring = self._trace_spans[trace_id] = \
                        collections.deque(maxlen=_MAX_TRACE_SPANS)
                    while len(self._trace_spans) > _MAX_TRACES:
                        self._trace_spans.popitem(last=False)
                else:
                    self._trace_spans.move_to_end(trace_id)
                ring.append(entry + (parent, span_id))

    def spans_for_trace(self, trace_id) -> list:
        """Chrome-trace events recorded under ``trace_id`` (hex string) by
        THIS process. Timestamps are unix-epoch microseconds (wall-rebased),
        so the fleet collector can merge exports from many processes onto
        one timeline without knowing their perf_counter origins."""
        with self._span_lock:
            ring = self._trace_spans.get(trace_id)
            spans = list(ring) if ring is not None else []
        events = []
        for name, cat, ts, dur, tid, args, parent, span_id in spans:
            a = dict(args) if args else {}
            a["trace_id"] = trace_id
            if parent is not None:
                a["parent"] = parent
            if span_id is not None:
                a["span"] = span_id
            events.append({"name": name, "cat": cat, "ph": "X",
                           "pid": os.getpid(), "tid": tid,
                           "ts": round(ts + _EPOCH_UNIX_US, 3),
                           "dur": round(dur, 3), "args": a})
        return events

    # --------------------------------------------------------------- exports

    def snapshot(self) -> dict:
        """Flat JSON-ready dict of everything the process has recorded."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {_flatname(n, lk): c.value
                         for (n, lk), c in counters.items()},
            "gauges": {_flatname(n, lk): g.value
                       for (n, lk), g in gauges.items()},
            "histograms": {_flatname(n, lk): h.summary()
                           for (n, lk), h in hists.items()},
        }

    def to_json(self, indent=None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def chrome_trace(self) -> dict:
        """Spans in Chrome ``traceEvents`` format plus the metric snapshot
        under the top-level ``metrics`` key."""
        with self._span_lock:
            spans = list(self._spans)
        events = []
        for name, cat, ts, dur, tid, args in spans:
            ev = {"name": name, "cat": cat, "ph": "X", "pid": os.getpid(),
                  "tid": tid, "ts": round(ts, 3), "dur": round(dur, 3)}
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metrics": self.snapshot()}

    def to_prometheus(self) -> str:
        """Zero-dependency Prometheus text exposition (format 0.0.4) of
        every counter/gauge/histogram — histograms render as summaries
        (p50/p99 quantiles + _sum/_count). Standard scrapers consume this
        through the stdlib http exporter (`observability/prometheus.py`)."""
        from paddle_tpu_torch.observability.prometheus import render
        return render(self)

    def export_chrome_trace(self, path) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def reset(self):
        """Zero every metric IN PLACE and drop the spans (tests / bench rung
        isolation). Metrics are zeroed rather than dropped because the
        instrumented modules cache their handles at import time — dropping
        entries would orphan those handles and silently lose their counts."""
        with self._lock:
            stores = (list(self._counters.values()),
                      list(self._gauges.values()),
                      list(self._histograms.values()))
        for store in stores:
            for m in store:
                m.reset()
        with self._span_lock:
            self._spans.clear()
            self._trace_spans.clear()


# the process-wide default registry every instrumented layer reports to
metrics = MetricsRegistry()

# module-level conveniences bound to the default registry
counter = metrics.counter
gauge = metrics.gauge
histogram = metrics.histogram
timer = metrics.timer
snapshot = metrics.snapshot
reset = metrics.reset
chrome_trace = metrics.chrome_trace
export_chrome_trace = metrics.export_chrome_trace
to_prometheus = metrics.to_prometheus
set_node_identity = metrics.set_node_identity
node_identity = metrics.node_identity
spans_for_trace = metrics.spans_for_trace
