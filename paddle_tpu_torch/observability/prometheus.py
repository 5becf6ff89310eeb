"""Prometheus text exposition for the port's metrics registry, zero
dependency (counterpart of `paddle_tpu/observability/prometheus.py`; the
text is byte for byte the JAX package's for the same registry content).

Two consumers:
- ``MetricsRegistry.to_prometheus()`` (delegates to :func:`render`): the
  exposition string;
- :func:`start_http_exporter`: an optional stdlib ``http.server`` endpoint
  (``GET /metrics``) so standard Prometheus scrapers work against any
  process of the port (a serving loop, a training script) with no custom
  client at all.

Mapping (exposition format 0.0.4):
- counters/gauges keep their values; names sanitize ``.`` and any other
  non-``[a-zA-Z0-9_:]`` byte to ``_`` (``engine.steps`` ->
  ``engine_steps``);
- histograms render as **summaries**: ``{quantile="0.5"|"0.99"}`` sample
  lines from the bounded reservoir plus ``_sum``/``_count``; the registry
  keeps a reservoir, not fixed buckets, so a summary is the honest
  translation (quantiles are over the last 512 observations).

Stdlib-only on purpose, like the rest of ``observability/``.
"""
from __future__ import annotations

import re
import threading

__all__ = ["render", "start_http_exporter"]

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _name(raw: str) -> str:
    n = _NAME_OK.sub("_", str(raw))
    if not n or n[0].isdigit():
        n = "_" + n
    return n


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n") \
                 .replace('"', '\\"')


def _labels(labelkey, extra=()) -> str:
    pairs = [(_LABEL_OK.sub("_", str(k)), _escape(v))
             for k, v in tuple(labelkey) + tuple(extra)]
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def _value(v) -> str:
    v = float(v)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render(registry=None) -> str:
    """The full exposition document for ``registry`` (default: the
    process-wide one). Groups samples by metric name with one ``# TYPE``
    header per group, Prometheus's required layout."""
    if registry is None:
        from paddle_tpu_torch.observability import metrics as registry
    with registry._lock:
        counters = dict(registry._counters)
        gauges = dict(registry._gauges)
        hists = dict(registry._histograms)

    by_name: dict = {}

    def _add(kind, name, line):
        by_name.setdefault((name, kind), []).append(line)

    for (raw, lk), c in sorted(counters.items()):
        n = _name(raw)
        _add("counter", n, f"{n}{_labels(lk)} {_value(c.value)}")
    for (raw, lk), g in sorted(gauges.items()):
        n = _name(raw)
        _add("gauge", n, f"{n}{_labels(lk)} {_value(g.value)}")
    for (raw, lk), h in sorted(hists.items()):
        n = _name(raw)
        s = h.summary()
        lines = []
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            if s[key] is not None:
                lines.append(
                    f"{n}{_labels(lk, (('quantile', q),))} {_value(s[key])}")
        lines.append(f"{n}_sum{_labels(lk)} {_value(s['total'])}")
        lines.append(f"{n}_count{_labels(lk)} {_value(s['count'])}")
        for ln in lines:
            _add("summary", n, ln)

    out = []
    for (n, kind), lines in sorted(by_name.items()):
        out.append(f"# TYPE {n} {kind}")
        out.extend(lines)
    return "\n".join(out) + ("\n" if out else "")


def start_http_exporter(host="127.0.0.1", port=0, registry=None):
    """Serve ``GET /metrics`` (and ``/``) from a daemon thread; returns the
    live ``ThreadingHTTPServer`` (``.server_address[1]`` is the bound port,
    ``.shutdown()`` stops it). Scrape with any Prometheus server:

        scrape_configs:
          - job_name: paddle_tpu_torch
            static_configs: [{targets: ["host:port"]}]
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            if self.path.split("?")[0].rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = render(registry).encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrapes must not spam stderr
            pass

    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="pt-metrics-exporter")
    t.start()
    return srv
