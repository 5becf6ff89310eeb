"""SLO engine: declarative objectives judged over metric-snapshot deltas
(counterpart of `paddle_tpu/observability/slo.py`).

The registry (`observability/__init__.py`) *measures*; this module
*judges*. An :class:`SLOSpec` declares one objective in the shapes
production serving promises:

- a histogram percentile target: ``serve.ttft_seconds p99 < 2.0s`` (also
  ``p50`` and ``mean``);
- an error-ratio target: ``serve.request_errors / serve.requests < 0.1%``.

:class:`SLOEvaluator` evaluates a list of specs against successive
**snapshots** (``metrics.snapshot()`` dicts, or any dict of the same
``count/total/p50/p99`` histogram summary shape, such as a fleet rollup).
Windowed burn rates come from **differencing** snapshots: the registry's
counters and histogram count/total are cumulative, so the value over a
window is the delta between now and the newest sample at least that old.
Nothing here polls, sleeps or owns a thread: callers call
:meth:`SLOEvaluator.evaluate` on their own cadence with an optional
explicit ``now``, so every lifecycle test is deterministic with zero
sleeps (the same injectable-clock idiom as ``Watchdog.check``).

Alerting is the multi-window burn-rate scheme: an objective breaches only
when BOTH a fast window (catches sudden burns) and a slow window
(suppresses blips) exceed ``burn x threshold``, then walks a pending ->
firing -> resolved state machine with dwell-time hysteresis on both edges
(``pending_for_s`` before firing, ``clear_for_s`` before resolving).
Transitions land on a bounded alert ring, the process flight recorder and
``slo.*`` metrics; :func:`active_alerts` (the watchdog's stall-dump hook)
reads them back.

Stdlib-only, like everything under ``observability/``.
"""
from __future__ import annotations

import collections
import re
import threading
import time
import weakref

from paddle_tpu_torch.observability import metrics

__all__ = ["SLOSpec", "SLOEvaluator", "parse_slo", "active_alerts",
           "recent_events"]

# every live evaluator, so the watchdog stall dump can answer "what was
# the fleet promising when it froze" without plumbing references around
_EVALUATORS: "weakref.WeakSet[SLOEvaluator]" = weakref.WeakSet()

_RATIO_RE = re.compile(
    r"^\s*([\w.{}=,\-]+)\s*/\s*([\w.{}=,\-]+)\s*<\s*"
    r"([0-9.eE+\-]+)\s*(%?)\s*$")
_POINT_RE = re.compile(
    r"^\s*([\w.{}=,\-]+)\s+(p50|p99|mean)\s*<\s*"
    r"([0-9.eE+\-]+)\s*(s?)\s*$")


class SLOSpec:
    """One declarative objective.

    name          : alert identity (rides events, metrics labels, /alerts)
    objective     : the human-readable contract string (kept verbatim)
    kind          : 'ratio' | 'percentile' | 'mean'
    metric        : histogram name ('percentile'/'mean' kinds)
    num / den     : counter names ('ratio' kind)
    quantile      : 'p50' | 'p99' ('percentile' kind)
    threshold     : objective bound, post-'%'-scaling
    fast_window_s / slow_window_s : the two burn windows
    burn          : burn-rate multiplier — breach when value >
                    burn * threshold on BOTH windows (1.0 = the bound
                    itself)
    pending_for_s : breach dwell before pending promotes to firing
    clear_for_s   : clean dwell before firing resolves
    """

    __slots__ = ("name", "objective", "kind", "metric", "num", "den",
                 "quantile", "threshold", "fast_window_s", "slow_window_s",
                 "burn", "pending_for_s", "clear_for_s")

    def __init__(self, name, objective, kind, threshold, metric=None,
                 num=None, den=None, quantile=None, fast_window_s=60.0,
                 slow_window_s=300.0, burn=1.0, pending_for_s=0.0,
                 clear_for_s=0.0):
        self.name = str(name)
        self.objective = str(objective)
        self.kind = kind
        self.metric = metric
        self.num = num
        self.den = den
        self.quantile = quantile
        self.threshold = float(threshold)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn = float(burn)
        self.pending_for_s = float(pending_for_s)
        self.clear_for_s = float(clear_for_s)
        if self.threshold <= 0:
            raise ValueError(f"SLO {name!r}: threshold must be > 0")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(f"SLO {name!r}: fast window must be <= slow")

    @classmethod
    def parse(cls, name, objective, **kw):
        """Parse an objective string.

        ``serve.ttft_seconds p99 < 2.0s`` -> percentile target (trailing
        ``s`` optional); ``serve.request_errors / serve.requests < 0.1%``
        -> error-ratio target (``%`` divides the bound by 100). ``p50``,
        ``p99`` and ``mean`` are the supported points — the registry's
        bounded reservoir only surfaces those.
        """
        m = _RATIO_RE.match(objective)
        if m:
            num, den, bound, pct = m.groups()
            thr = float(bound) / (100.0 if pct else 1.0)
            return cls(name, objective, "ratio", thr, num=num, den=den,
                       **kw)
        m = _POINT_RE.match(objective)
        if m:
            metric, point, bound, _unit = m.groups()
            kind = "mean" if point == "mean" else "percentile"
            q = None if point == "mean" else point
            return cls(name, objective, kind, float(bound), metric=metric,
                       quantile=q, **kw)
        raise ValueError(
            f"unparseable SLO objective {objective!r} — expected "
            f"'<hist> p50|p99|mean < <bound>[s]' or "
            f"'<counter> / <counter> < <bound>[%]'")

    def to_dict(self):
        return {"name": self.name, "objective": self.objective,
                "kind": self.kind, "threshold": self.threshold,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s, "burn": self.burn,
                "pending_for_s": self.pending_for_s,
                "clear_for_s": self.clear_for_s}


def parse_slo(text):
    """CLI/config form: ``name=<objective>[;fast=60][;slow=300][;burn=1]
    [;pending=0][;clear=0]`` -> :class:`SLOSpec` (the ``--slo`` flag on
    serve and the router)."""
    head, _, opts = str(text).partition(";")
    name, sep, objective = head.partition("=")
    if not sep or not name.strip() or not objective.strip():
        raise ValueError(f"--slo needs 'name=<objective>', got {text!r}")
    kw = {}
    keys = {"fast": "fast_window_s", "slow": "slow_window_s",
            "burn": "burn", "pending": "pending_for_s",
            "clear": "clear_for_s"}
    for part in filter(None, (p.strip() for p in opts.split(";"))):
        k, sep, v = part.partition("=")
        if not sep or k.strip() not in keys:
            raise ValueError(f"unknown SLO option {part!r} in {text!r}")
        kw[keys[k.strip()]] = float(v)
    return SLOSpec.parse(name.strip(), objective.strip(), **kw)


def _read_cum(spec, snapshot):
    """The spec's CUMULATIVE reading from one snapshot: a tuple whose
    element-wise deltas over a window yield the windowed value."""
    if spec.kind == "ratio":
        ctr = snapshot.get("counters", {})
        return (float(ctr.get(spec.num, 0) or 0),
                float(ctr.get(spec.den, 0) or 0))
    s = snapshot.get("histograms", {}).get(spec.metric)
    if not s:
        return (0.0, 0.0)
    count = float(s.get("count", 0) or 0)
    if spec.kind == "mean":
        return (count, float(s.get("total", 0) or 0))
    # percentile: the reservoir reading is already windowed-recent; the
    # cumulative count gates it on "did traffic actually land in the
    # window" so a stale reading can't fire into silence
    reading = s.get(spec.quantile)
    return (count, float(reading) if reading is not None else None)


def _window_value(spec, samples, now, window_s):
    """Value of the spec over the trailing ``window_s``: delta between
    the newest sample and the newest sample at least ``window_s`` old.
    ``None`` = window unknown (no old-enough reference, or no traffic) —
    the conservative no-fire reading."""
    ref = None
    for t, cum in reversed(samples):
        if t <= now - window_s:
            ref = cum
            break
    if ref is None:
        return None
    cur = samples[-1][1]
    if spec.kind == "ratio":
        dden = cur[1] - ref[1]
        if dden <= 0:
            return None
        return max(0.0, cur[0] - ref[0]) / dden
    if spec.kind == "mean":
        dcount = cur[0] - ref[0]
        if dcount <= 0:
            return None
        return max(0.0, cur[1] - ref[1]) / dcount
    # percentile: gate the current reservoir reading on window traffic
    if cur[0] - ref[0] <= 0 or cur[1] is None:
        return None
    return cur[1]


class SLOEvaluator:
    """Evaluates specs against successive snapshots; owns no thread.

    registry : snapshot source when ``evaluate()`` gets none (default the
               process registry); fleet-scope callers pass rollups
               explicitly and leave this alone
    scope    : label riding alerts/metrics ('process' | 'fleet' | ...)
    clock    : default ``now`` source (``time.monotonic``); tests inject
               explicit ``now=`` instead and never sleep
    ring     : bounded alert-event history kept for /alerts + stall dumps
    """

    def __init__(self, specs, registry=None, scope="process", clock=None,
                 ring=128):
        self.specs = list(specs)
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.registry = registry
        self.scope = str(scope)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._samples = {s.name: collections.deque() for s in self.specs}
        self._state = {s.name: {"state": "ok", "breach_since": None,
                                "clear_since": None, "fired_at": None,
                                "value_fast": None, "value_slow": None}
                       for s in self.specs}
        self.events = collections.deque(maxlen=int(ring))
        self._m_fired = metrics.counter("slo.alerts_fired")
        self._m_resolved = metrics.counter("slo.alerts_resolved")
        self._m_evals = metrics.counter("slo.evaluations")
        _EVALUATORS.add(self)

    # ------------------------------------------------------------ evaluation

    def evaluate(self, snapshot=None, now=None):
        """One evaluation pass; returns the per-spec status list.

        ``snapshot`` defaults to ``registry.snapshot()`` (the process
        registry when none was given); fleet callers pass the rollup.
        ``now`` defaults to the evaluator's clock — pass explicit values
        for deterministic lifecycle tests.
        """
        if snapshot is None:
            reg = self.registry
            if reg is None:
                reg = metrics
            snapshot = reg.snapshot()
        now = float(self._clock() if now is None else now)
        out = []
        with self._lock:
            self._m_evals.inc()
            for spec in self.specs:
                out.append(self._eval_one(spec, snapshot, now))
        return out

    def _eval_one(self, spec, snapshot, now):
        samples = self._samples[spec.name]
        samples.append((now, _read_cum(spec, snapshot)))
        # prune: drop samples that can no longer be any window's
        # reference — everything older than the newest sample that is
        # itself older than the slow window
        while len(samples) >= 2 and samples[1][0] <= now - spec.slow_window_s:
            samples.popleft()

        v_fast = _window_value(spec, samples, now, spec.fast_window_s)
        v_slow = _window_value(spec, samples, now, spec.slow_window_s)
        bound = spec.burn * spec.threshold
        breaching = (v_fast is not None and v_fast > bound
                     and v_slow is not None and v_slow > bound)

        st = self._state[spec.name]
        st["value_fast"], st["value_slow"] = v_fast, v_slow
        if breaching:
            st["clear_since"] = None
            if st["state"] == "ok":
                st["state"] = "pending"
                st["breach_since"] = now
            if st["state"] == "pending" \
                    and now - st["breach_since"] >= spec.pending_for_s:
                st["state"] = "firing"
                st["fired_at"] = now
                self._transition(spec, st, now, "firing")
        else:
            st["breach_since"] = None if st["state"] != "firing" else \
                st["breach_since"]
            if st["state"] == "pending":
                st["state"] = "ok"
            elif st["state"] == "firing":
                if st["clear_since"] is None:
                    st["clear_since"] = now
                if now - st["clear_since"] >= spec.clear_for_s:
                    st["state"] = "ok"
                    st["breach_since"] = None
                    st["clear_since"] = None
                    self._transition(spec, st, now, "resolved")
        metrics.gauge("slo.alert_firing", slo=spec.name,
                      scope=self.scope).set(
                          1 if st["state"] == "firing" else 0)
        if v_fast is not None:
            metrics.gauge("slo.burn_rate", slo=spec.name, scope=self.scope,
                          window="fast").set(v_fast / spec.threshold)
        if v_slow is not None:
            metrics.gauge("slo.burn_rate", slo=spec.name, scope=self.scope,
                          window="slow").set(v_slow / spec.threshold)
        return self._status(spec, st)

    def _transition(self, spec, st, now, state):
        ev = {"t": now, "slo": spec.name, "scope": self.scope,
              "state": state, "objective": spec.objective,
              "threshold": spec.threshold,
              "value_fast": st["value_fast"],
              "value_slow": st["value_slow"]}
        self.events.append(ev)
        (self._m_fired if state == "firing" else self._m_resolved).inc()
        try:
            from paddle_tpu_torch.observability.flight_recorder import \
                flight
            flight.record("slo_alert", slo=spec.name, state=state,
                          scope=self.scope, objective=spec.objective,
                          value_fast=st["value_fast"],
                          value_slow=st["value_slow"])
        except Exception:  # noqa: BLE001 — alerting must not take the loop
            pass

    def _status(self, spec, st):
        return {"slo": spec.name, "scope": self.scope,
                "state": st["state"], "objective": spec.objective,
                "threshold": spec.threshold,
                "value_fast": st["value_fast"],
                "value_slow": st["value_slow"],
                "breach_since": st["breach_since"],
                "fired_at": st["fired_at"] if st["state"] == "firing"
                else None}

    # -------------------------------------------------------------- readback

    def active(self):
        """Currently-FIRING alerts (the /alerts + stall-dump payload)."""
        with self._lock:
            return [self._status(s, self._state[s.name])
                    for s in self.specs
                    if self._state[s.name]["state"] == "firing"]

    def status(self):
        """All specs' current status, firing or not."""
        with self._lock:
            return [self._status(s, self._state[s.name])
                    for s in self.specs]

    def history(self, n=None):
        with self._lock:
            evs = list(self.events)
        return evs if n is None else evs[-int(n):]

    def alerts_payload(self):
        """The GET /alerts body: specs + live status + transition ring."""
        return {"scope": self.scope,
                "specs": [s.to_dict() for s in self.specs],
                "active": self.active(),
                "status": self.status(),
                "history": self.history()}

    def to_prometheus(self):
        """Alert state as exposition lines (appended to the fleet
        exporter's /metrics body — names pre-sanitized, no registry
        round-trip so a fleet-scope evaluator exports even when its
        snapshots come from rollups)."""
        from paddle_tpu_torch.observability.prometheus import (_labels,
                                                               _value)
        lines = ["# TYPE slo_alert_firing gauge"]
        for s in self.status():
            lab = _labels((("scope", s["scope"]), ("slo", s["slo"])))
            lines.append(
                f"slo_alert_firing{lab} "
                f"{_value(1 if s['state'] == 'firing' else 0)}")
        burn = ["# TYPE slo_burn_rate gauge"]
        for s in self.status():
            for win, key in (("fast", "value_fast"), ("slow", "value_slow")):
                if s[key] is None:
                    continue
                lab = _labels((("scope", s["scope"]), ("slo", s["slo"]),
                               ("window", win)))
                burn.append(f"slo_burn_rate{lab} "
                            f"{_value(s[key] / s['threshold'])}")
        if len(burn) > 1:
            lines.extend(burn)
        return "\n".join(lines) + "\n"


def active_alerts():
    """Firing alerts across EVERY live evaluator in this process — the
    watchdog stall dump's 'what was the fleet promising' hook."""
    out = []
    for ev in list(_EVALUATORS):
        try:
            out.extend(ev.active())
        except Exception:  # noqa: BLE001 — dumps must never fail
            pass
    return out


def recent_events(n=32):
    """Most recent alert transitions across every live evaluator,
    time-ordered."""
    evs = []
    for ev in list(_EVALUATORS):
        try:
            evs.extend(ev.history())
        except Exception:  # noqa: BLE001
            pass
    evs.sort(key=lambda e: e.get("t", 0))
    return evs[-int(n):]
