"""Fleet observability plane: cross-process traces + aggregated metrics
(counterpart of `paddle_tpu/observability/fleet.py`; the port imports
nothing from it, and its collector reads JAX and port processes alike:
the wire ops and the STATS JSON are the same).

Every process keeps its OWN registry (`observability/__init__`)
and answers the serve wire's STATS / PROMETHEUS / TRACE_EXPORT /
DEBUG_DUMP ops; this module is the pull side that turns those per-process
views into fleet-level ones (docs/OBSERVABILITY.md "Fleet tracing" and
"Fleet metrics plane"):

- :class:`TraceCollector` pulls each member's span buffer for ONE trace id
  (TRACE_EXPORT, op 11) and stitches the exports into a single Chrome
  trace: one ``pid`` lane per process, named ``role:node_id`` via
  ``process_name`` metadata, timestamps already wall-rebased by the
  exporting registry so the lanes line up without clock negotiation
  (microsecond-level NTP skew shifts lanes, never reorders a process's
  own spans).
- :class:`FleetMetrics` ingests per-member STATS snapshots — fed by the
  router's poll loop (`Router.attach_fleet`, `serving/router.py`) or
  this module's own scrape loop — and exposes: an exact counter-sum
  rollup, merged histograms (counts/totals exact, quantiles
  count-weighted estimates), per-replica operational gauges (pages in
  use, degradation level), one re-labeled ``{role,replica}`` Prometheus
  exposition, and a JSON
  snapshot API (`snapshot_for`) shaped exactly like a direct STATS pull
  so the autoscaler's ``stats_fn`` can ride the shared scrape instead of
  opening its own per-replica connections.
- :func:`start_fleet_exporter` serves both over stdlib HTTP
  (``GET /metrics`` and ``GET /fleet``); ``python -m
  paddle_tpu_torch.observability.fleet`` is the standalone CLI for fleets
  without a router in the loop.

Stdlib-only, like everything under ``observability/``.
"""
from __future__ import annotations

import argparse
import json
import threading
import time

__all__ = ["TraceCollector", "FleetMetrics", "start_fleet_exporter",
           "scrape_once", "main"]


def _wire_client(endpoint: str, secret=None, timeout=5.0):
    """One probe-grade authed wire client for ``endpoint`` (host:port).
    Import is lazy so the metrics plane never drags serve (and numpy and
    torch) into processes that only merge snapshots."""
    from paddle_tpu_torch.inference.serve import RemotePredictor
    host, port = str(endpoint).rsplit(":", 1)
    return RemotePredictor(host, int(port), timeout=timeout,
                           secret=secret, connect_retries=1,
                           retry_deadline_s=min(timeout, 3.0))


# ---------------------------------------------------------------- tracing


class TraceCollector:
    """Pull + stitch one request's spans from every fleet member.

    >>> col = TraceCollector({"r0": "127.0.0.1:7001",
    ...                       "router:a": "127.0.0.1:7000"},
    ...                      secret="fleet")
    >>> trace = col.collect(trace_id)     # ONE Chrome trace, all processes
    >>> json.dump(trace, open("trace.json", "w"))    # -> Perfetto
    """

    def __init__(self, members: dict, secret=None, timeout=5.0):
        self._members = dict(members)      # member id -> "host:port"
        self._secret = secret
        self._timeout = float(timeout)

    def pull(self, trace_id: str) -> list[dict]:
        """Every member's raw TRACE_EXPORT body for ``trace_id`` (hex).
        A dead or trace-less member contributes nothing — partial fleets
        still stitch (the trace just misses that process's lane)."""
        exports = []
        for mid, ep in sorted(self._members.items()):
            cli = None
            try:
                cli = _wire_client(ep, self._secret, self._timeout)
                body = cli.trace_export(trace_id)
            except (OSError, ConnectionError, ValueError, RuntimeError):
                continue
            finally:
                if cli is not None:
                    try:
                        cli.close()
                    except OSError:
                        pass
            if body.get("spans"):
                body.setdefault("member_id", mid)
                exports.append(body)
        return exports

    @staticmethod
    def stitch(exports: list[dict]) -> dict:
        """Merge TRACE_EXPORT bodies into ONE Chrome trace. Each export
        becomes one ``pid`` lane labeled ``role:node_id``; span timestamps
        are already unix-epoch microseconds, rebased here to the earliest
        span so the trace starts at t=0."""
        events = []
        t0 = min((ev["ts"] for ex in exports for ev in ex["spans"]),
                 default=0.0)
        for lane, ex in enumerate(sorted(
                exports, key=lambda e: (e.get("node") or {}).get(
                    "node_id") or "")):
            node = ex.get("node") or {}
            label = f"{node.get('role') or 'process'}:" \
                    f"{node.get('node_id') or node.get('pid') or lane}"
            events.append({"name": "process_name", "ph": "M", "pid": lane,
                           "tid": 0, "args": {"name": label}})
            for ev in ex["spans"]:
                ev = dict(ev)
                ev["pid"] = lane
                ev["ts"] = round(ev["ts"] - t0, 3)
                events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def collect(self, trace_id: str) -> dict:
        """`pull` + `stitch`: the one-call path."""
        return self.stitch(self.pull(trace_id))


# ---------------------------------------------------------------- metrics

# count-weighted mergeable summary fields; quantiles are estimated
# separately (a reservoir's exact quantiles do not merge)
_HIST_EXACT = ("count", "total")


def merge_histograms(summaries: list[dict]) -> dict:
    """Merge per-process histogram summaries: ``count``/``total`` are
    exact sums, ``min``/``max`` exact extrema, ``mean`` derived, and
    ``p50``/``p99`` count-weighted estimates (the per-process reservoirs
    cannot be merged exactly; the estimate is exact when one process
    dominates and bounded by the per-process values always)."""
    out = {"count": 0, "total": 0.0, "min": None, "max": None,
           "mean": None, "p50": None, "p99": None}
    wsum = {"p50": 0.0, "p99": 0.0}
    wcnt = {"p50": 0, "p99": 0}
    for s in summaries:
        c = int(s.get("count") or 0)
        out["count"] += c
        out["total"] += float(s.get("total") or 0.0)
        for k, pick in (("min", min), ("max", max)):
            v = s.get(k)
            if v is not None:
                out[k] = v if out[k] is None else pick(out[k], v)
        for q in ("p50", "p99"):
            v = s.get(q)
            if v is not None and c:
                wsum[q] += float(v) * c
                wcnt[q] += c
    if out["count"]:
        out["mean"] = out["total"] / out["count"]
    for q in ("p50", "p99"):
        if wcnt[q]:
            out[q] = wsum[q] / wcnt[q]
    return out


class FleetMetrics:
    """Rolling fleet view of per-member STATS snapshots.

    ``ingest`` is called by whoever scrapes (the router's poll loop via
    `Router.attach_fleet`, the standalone CLI, or a test directly);
    everything else is a read. Members age out after ``ttl_s`` without a
    fresh snapshot so a departed replica's counters stop inflating the
    rollup (its contribution is a VIEW, not a merged total — fleet
    counters are sums over currently-live members by design; a restart
    resets a member's counters exactly like a process restart resets its
    own registry)."""

    def __init__(self, ttl_s: float = 60.0):
        self._lock = threading.Lock()
        self._ttl = float(ttl_s)
        # member id -> {"role","endpoint","snapshot","t"}
        self._members: dict[str, dict] = {}

    # ------------------------------------------------------------- feeding

    def ingest(self, member_id: str, role: str | None, endpoint: str,
               snapshot: dict):
        """Fold one member's STATS snapshot in. ``snapshot`` is the STATS
        JSON body (``counters``/``gauges``/``histograms`` + extras); the
        member's self-declared role inside it wins over ``role``."""
        if not isinstance(snapshot, dict):
            raise TypeError("snapshot must be the STATS dict")
        srole = snapshot.get("role") or role or "replica"
        with self._lock:
            self._members[str(member_id)] = {
                "role": str(srole), "endpoint": str(endpoint),
                "snapshot": snapshot, "t": time.monotonic()}

    def drop(self, member_id: str):
        with self._lock:
            self._members.pop(str(member_id), None)

    def _live(self) -> dict[str, dict]:
        now = time.monotonic()
        with self._lock:
            for mid in [m for m, e in self._members.items()
                        if now - e["t"] > self._ttl]:
                del self._members[mid]
            return {mid: dict(e) for mid, e in self._members.items()}

    # ------------------------------------------------------------- reading

    def members(self) -> dict[str, dict]:
        """Live member id -> {role, endpoint, age_s}."""
        now = time.monotonic()
        return {mid: {"role": e["role"], "endpoint": e["endpoint"],
                      "age_s": round(now - e["t"], 3)}
                for mid, e in self._live().items()}

    def snapshot_for(self, endpoint: str) -> dict | None:
        """The latest ingested snapshot for the member at ``endpoint`` —
        the autoscaler's ``stats_fn(endpoint)`` contract (same JSON a
        direct STATS pull returns, None when the plane has no fresh view),
        so scaling decisions ride the shared scrape loop instead of a
        second per-replica pull fan-out."""
        for e in self._live().values():
            if e["endpoint"] == str(endpoint):
                return e["snapshot"]
        return None

    @property
    def stats_fn(self):
        """Bound `snapshot_for` — pass as ``AutoScaler(stats_fn=...)``."""
        return self.snapshot_for

    def rollup(self) -> dict:
        """Fleet-level aggregation over live members: exact counter sums,
        additive gauge sums, merged histograms, plus the operational
        ``fleet`` digest (aggregate tok/s, fleet TTFT/TPOT, per-replica
        pages-in-use and degradation level)."""
        live = self._live()
        counters: dict[str, float] = {}
        gauges: dict[str, float] = {}
        hists: dict[str, list] = {}
        per = {}
        for mid, e in sorted(live.items()):
            snap = e["snapshot"]
            for name, v in (snap.get("counters") or {}).items():
                counters[name] = counters.get(name, 0) + v
            for name, v in (snap.get("gauges") or {}).items():
                gauges[name] = gauges.get(name, 0) + v
            for name, s in (snap.get("histograms") or {}).items():
                hists.setdefault(name, []).append(s)
            g = snap.get("gauges") or {}
            per[mid] = {"role": e["role"],
                        "tokens_per_s": g.get("engine.tokens_per_s", 0.0),
                        "pages_in_use": g.get("engine.pages_in_use", 0),
                        "queue_depth": g.get("engine.queue_depth", 0),
                        "degradation_level":
                            g.get("engine.degradation_level", 0)}
        merged = {name: merge_histograms(ss) for name, ss in hists.items()}
        ttft = merged.get("serve.ttft_seconds", {})
        tpot = merged.get("serve.tpot_seconds", {})
        return {
            "members": self.members(),
            "counters": counters,
            "gauges": gauges,
            "histograms": merged,
            "per_replica": per,
            "fleet": {
                "tokens_per_s": sum(p["tokens_per_s"] for p in
                                    per.values()),
                "ttft_p50": ttft.get("p50"), "ttft_p99": ttft.get("p99"),
                "tpot_p50": tpot.get("p50"), "tpot_p99": tpot.get("p99"),
                "pages_in_use": {m: p["pages_in_use"]
                                 for m, p in per.items()},
                "degradation_level": {m: p["degradation_level"]
                                      for m, p in per.items()},
            },
        }

    def to_prometheus(self) -> str:
        """One exposition document for the whole fleet: every member's
        rows re-labeled with ``{role,replica}`` (a member's own labels are
        kept and extended), plus ``fleet_*`` rollup rows. Feed ONE scrape
        target this and Prometheus sees the fleet without per-replica
        service discovery."""
        from paddle_tpu_torch.observability.prometheus import (_labels,
                                                               _name,
                                                               _value)
        by_name: dict = {}

        def _add(kind, name, line):
            by_name.setdefault((name, kind), []).append(line)

        def _split(flat):
            # undo observability._flatname: "n{k=v,k2=v2}" -> (n, pairs)
            if "{" not in flat:
                return flat, ()
            base, _, inner = flat.partition("{")
            pairs = tuple(tuple(p.split("=", 1))
                          for p in inner.rstrip("}").split(",") if "=" in p)
            return base, pairs

        for mid, e in sorted(self._live().items()):
            snap = e["snapshot"]
            ident = (("role", e["role"]), ("replica", mid))

            def _ident(lk, extra=()):
                # a member's own labels win a name clash (e.g. the
                # router's per-replica series already carry `replica=`)
                own = {k for k, _ in lk}
                return tuple((k, v) for k, v in ident
                             if k not in own) + tuple(extra)

            for kind, key in (("counter", "counters"), ("gauge", "gauges")):
                for flat, v in sorted((snap.get(key) or {}).items()):
                    base, lk = _split(flat)
                    n = _name(base)
                    _add(kind, n,
                         f"{n}{_labels(lk, _ident(lk))} {_value(v)}")
            for flat, s in sorted((snap.get("histograms") or {}).items()):
                base, lk = _split(flat)
                n = _name(base)
                for q, key in ((0.5, "p50"), (0.99, "p99")):
                    if s.get(key) is not None:
                        _add("summary", n,
                             f"{n}{_labels(lk, _ident(lk, (('quantile', q),)))}"
                             f" {_value(s[key])}")
                _add("summary", n,
                     f"{n}_sum{_labels(lk, _ident(lk))} {_value(s['total'])}")
                _add("summary", n,
                     f"{n}_count{_labels(lk, _ident(lk))} "
                     f"{_value(s['count'])}")
        roll = self.rollup()
        _add("gauge", "fleet_members",
             f"fleet_members {_value(len(roll['members']))}")
        _add("gauge", "fleet_tokens_per_s",
             f"fleet_tokens_per_s {_value(roll['fleet']['tokens_per_s'])}")
        for stem in ("ttft", "tpot"):
            for q, key in ((0.5, "p50"), (0.99, "p99")):
                v = roll["fleet"][f"{stem}_{key}"]
                if v is not None:
                    n = f"fleet_{stem}_seconds"
                    _add("summary", n,
                         f"{n}{_labels((), (('quantile', q),))} "
                         f"{_value(v)}")
        out = []
        for (n, kind), lines in sorted(by_name.items()):
            out.append(f"# TYPE {n} {kind}")
            out.extend(lines)
        return "\n".join(out) + ("\n" if out else "")


# ------------------------------------------------------------ HTTP + CLI


def start_fleet_exporter(fleet: FleetMetrics, host="127.0.0.1", port=0,
                         slo=None):
    """Serve the fleet plane over stdlib HTTP from a daemon thread:
    ``GET /metrics`` is `FleetMetrics.to_prometheus`, ``GET /fleet`` (and
    ``/``) the `rollup` JSON. With an `SLOEvaluator` attached (``slo=``),
    ``GET /alerts`` answers its ``alerts_payload()`` (specs + live state
    + the bounded transition ring) and the alert series ride ``/metrics``
    as ``slo_*`` rows. Returns the live ``ThreadingHTTPServer``
    (``.server_address[1]`` is the bound port, ``.shutdown()`` stops
    it)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from paddle_tpu_torch.observability.prometheus import CONTENT_TYPE

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            path = self.path.split("?")[0].rstrip("/")
            if path == "/metrics":
                body = fleet.to_prometheus()
                if slo is not None:
                    body += slo.to_prometheus()
                body = body.encode()
                ctype = CONTENT_TYPE
            elif path == "/alerts" and slo is not None:
                body = json.dumps(slo.alerts_payload(),
                                  sort_keys=True).encode()
                ctype = "application/json"
            elif path in ("", "/fleet"):
                body = json.dumps(fleet.rollup(), sort_keys=True).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrapes must not spam stderr
            pass

    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="pt-fleet-exporter")
    t.start()
    return srv


def scrape_once(fleet: FleetMetrics, members: dict, secret=None,
                timeout=5.0) -> int:
    """Pull STATS from every member endpoint and ingest; returns how many
    answered. The standalone CLI's loop body, also handy in tests."""
    ok = 0
    for mid, ep in sorted(members.items()):
        cli = None
        try:
            cli = _wire_client(ep, secret, timeout)
            snap = cli.stats()
        except (OSError, ConnectionError, ValueError, RuntimeError):
            continue
        finally:
            if cli is not None:
                try:
                    cli.close()
                except OSError:
                    pass
        from paddle_tpu_torch.distributed.fleet.elastic import node_role
        fleet.ingest(mid, node_role(mid), ep, snap)
        ok += 1
    return ok


def _resolve_members(args) -> dict:
    members = {}
    for spec in args.member:
        mid, _, ep = spec.partition("=")
        if not ep:
            raise SystemExit(f"--member wants ID=HOST:PORT, got {spec!r}")
        members[mid] = ep
    registry = None
    if args.registry_dir:
        from paddle_tpu_torch.distributed.fleet.elastic import NodeRegistry
        registry = NodeRegistry(args.registry_dir)
    elif args.registry_addr:
        from paddle_tpu_torch.distributed.fleet.elastic import \
            TcpNodeRegistry
        registry = TcpNodeRegistry(args.registry_addr)
    if registry is not None:
        try:
            members.update({rid: str(ep) for rid, ep
                            in registry.alive_nodes().items()})
        except OSError:
            pass
    if not members:
        raise SystemExit("no members: need --member, --registry-dir or "
                         "--registry-addr")
    return members


def main(argv=None):
    ap = argparse.ArgumentParser(
        "paddle_tpu_torch.observability.fleet",
        description="standalone fleet metrics/tracing plane (router-less "
                    "fleets; routered ones get this via --fleet-port)")
    ap.add_argument("--registry-dir", default=None,
                    help="shared-filesystem elastic registry to enumerate")
    ap.add_argument("--registry-addr", default=None,
                    help="host:port of a TcpRegistryServer to enumerate")
    ap.add_argument("--member", action="append", default=[],
                    metavar="ID=HOST:PORT",
                    help="static member entry (repeatable; composes with "
                         "the registry)")
    ap.add_argument("--secret", default=None,
                    help="fleet-shared serve auth secret (default "
                         "PADDLE_SERVE_TOKEN)")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="scrape interval seconds")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port for /metrics + /fleet")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="NAME=OBJECTIVE",
                    help="fleet-scope SLO evaluated over the rollup each "
                         "scrape, e.g. 'ttft=serve.ttft_seconds p99 < "
                         "2.0s;fast=60;slow=300' (repeatable; alerts on "
                         "GET /alerts — docs/OBSERVABILITY.md)")
    ap.add_argument("--once", action="store_true",
                    help="one scrape, print the rollup JSON, exit")
    ap.add_argument("--trace", default=None, metavar="TRACE_ID",
                    help="one-shot: pull TRACE_ID from every member, "
                         "print the stitched Chrome trace JSON, exit")
    args = ap.parse_args(argv)
    members = _resolve_members(args)
    if args.trace:
        col = TraceCollector(members, secret=args.secret)
        print(json.dumps(col.collect(args.trace)))
        return
    fleet = FleetMetrics(ttl_s=max(30.0, 6 * args.interval))
    if args.once:
        scrape_once(fleet, members, secret=args.secret)
        print(json.dumps(fleet.rollup(), indent=2, sort_keys=True))
        return
    slo = None
    if args.slo:
        from paddle_tpu_torch.observability.slo import (SLOEvaluator,
                                                        parse_slo)
        slo = SLOEvaluator([parse_slo(s) for s in args.slo], scope="fleet")
    srv = start_fleet_exporter(fleet, host=args.host, port=args.port,
                               slo=slo)
    print(f"FLEET {srv.server_address[1]}", flush=True)
    try:
        while True:
            scrape_once(fleet, members, secret=args.secret)
            if slo is not None:
                slo.evaluate(fleet.rollup())
            time.sleep(args.interval)
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
