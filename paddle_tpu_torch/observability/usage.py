"""Per-request usage metering: what did ONE request actually cost?
(counterpart of `paddle_tpu/observability/usage.py`)

Aggregate counters answer "how busy is the engine"; multi-tenant serving,
QoS scheduling and billing need the per-request answer. Every request that
TERMINATES (tokens delivered, typed error, cancel, deadline expiry)
emits one usage record through :func:`emit_request`, called from the
single termination point (``GenerateRequest._finish`` in
`inference/engine.py`) on the FIRST completion only.

A record carries the token economy of the request:

- ``prompt_tokens``: the submitted prompt length;
- ``prefill_computed``: prompt tokens a prefill program actually ran over
  (mirroring ``engine.prefill_tokens``);
- ``prefill_saved``: prompt tokens answered from cache instead (prefix
  store hits and KV-tier re-uploads);
- ``generated`` / ``spec_accepted``: tokens delivered, and how many of
  them speculation contributed beyond the 1/step baseline;
- ``kv_page_steps``: KV pages held x decode steps held, the occupancy
  integral (computed at slot detach, no per-step work);
- queue wait / TTFT / e2e from the request's :class:`RequestTrace`;
- ``migrations`` and ``imported``: how many times the request moved;
- ``tenant``: reserved passthrough.

Records land in a bounded in-memory ring (always on; termination-rate
cost only) and fold into cumulative ``usage.*`` counters.
:meth:`UsageLog.configure` additionally appends each record to a
size-rotated JSONL file. Unconfigured, no file I/O ever happens and the
decode step path is untouched.

Stdlib-only, like everything under ``observability/``.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

from paddle_tpu_torch.observability import metrics

__all__ = ["UsageLog", "usage_log", "emit_request", "typed_error"]

_RING = 256            # records kept in memory (stall dumps, tests, smoke)


def typed_error(error):
    """The TYPE of a request's terminal error string — the ``'Cancelled:
    client went away'`` convention's head — or None for success."""
    if not error:
        return None
    head = str(error).split(":", 1)[0].strip()
    return head if head.replace("_", "").isalnum() else "Error"


class UsageLog:
    """Bounded ring + ``usage.*`` counters + optional rotating JSONL."""

    def __init__(self, capacity=_RING):
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=int(capacity))
        self._path = None
        self._max_bytes = 1 << 20
        self._keep = 3
        self._emitted = 0
        # handles cached once — emit() is termination-rate, but there is
        # no reason to pay registry lookups per record either
        self._m_requests = metrics.counter("usage.requests")
        self._m_errors = metrics.counter("usage.errors")
        self._m_prompt = metrics.counter("usage.prompt_tokens")
        self._m_computed = metrics.counter("usage.prefill_computed_tokens")
        self._m_saved = metrics.counter("usage.prefill_saved_tokens")
        self._m_generated = metrics.counter("usage.generated_tokens")
        self._m_spec = metrics.counter("usage.spec_accepted_tokens")
        self._m_page_steps = metrics.counter("usage.kv_page_steps")
        self._m_migrations = metrics.counter("usage.migrations")

    # ------------------------------------------------------------- configure

    def configure(self, path=None, max_bytes=1 << 20, keep=3):
        """Enable (path given) or disable (None) the JSONL file sink.
        When an append would push the file past ``max_bytes`` it rotates
        ``path -> path.1 -> ... -> path.<keep>`` (oldest dropped)."""
        with self._lock:
            self._path = os.fspath(path) if path else None
            self._max_bytes = int(max_bytes)
            self._keep = max(0, int(keep))

    # ----------------------------------------------------------------- emit

    def emit(self, rec):
        """Fold one record into the ring, the counters, and the file."""
        with self._lock:
            self._ring.append(rec)
            self._emitted += 1
            self._m_requests.inc()
            if rec.get("error"):
                self._m_errors.inc()
            self._m_prompt.inc(int(rec.get("prompt_tokens", 0) or 0))
            self._m_computed.inc(int(rec.get("prefill_computed", 0) or 0))
            self._m_saved.inc(int(rec.get("prefill_saved", 0) or 0))
            self._m_generated.inc(int(rec.get("generated", 0) or 0))
            self._m_spec.inc(int(rec.get("spec_accepted", 0) or 0))
            self._m_page_steps.inc(int(rec.get("kv_page_steps", 0) or 0))
            self._m_migrations.inc(int(rec.get("migrations", 0) or 0))
            path = self._path
            if path is None:
                return
            try:
                line = json.dumps(rec, default=str) + "\n"
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = 0
                if size and size + len(line) > self._max_bytes:
                    self._rotate(path)
                with open(path, "a") as f:
                    f.write(line)
            except Exception:  # noqa: BLE001 — metering must never kill serving
                pass

    def _rotate(self, path):
        if self._keep <= 0:
            os.replace(path, path + ".1")  # still bound the live file
            return
        for i in range(self._keep, 1, -1):
            src = f"{path}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{i}")
        os.replace(path, f"{path}.1")

    # -------------------------------------------------------------- readback

    def last(self, n=1):
        with self._lock:
            recs = list(self._ring)
        return recs[-int(n):]

    def records(self):
        with self._lock:
            return list(self._ring)

    @property
    def emitted(self):
        return self._emitted

    def reset(self):
        """Drop the ring (tests / bench rung isolation; counters are the
        registry's to reset)."""
        with self._lock:
            self._ring.clear()
            self._emitted = 0


# the process-wide log every engine reports into
usage_log = UsageLog()


def emit_request(req, error=None, log=None):
    """Build + emit the UsageRecord for one terminated engine request.

    Reads the ``u_*`` accounting fields the engine mirrors onto each
    `GenerateRequest` alongside its aggregate counters, plus the
    request's `RequestTrace` timing marks. Called exactly once per
    request from ``GenerateRequest._finish``; never raises.
    """
    try:
        tr = getattr(req, "trace", None)
        t_accept = getattr(tr, "t_accept", None)
        t_submit = getattr(tr, "t_submit", None) or t_accept
        t_admit = getattr(tr, "t_admit", None)
        t_first = getattr(tr, "t_first_token", None)
        t_done = getattr(tr, "t_done", None)

        def _span(a, b):
            return round(b - a, 6) if a is not None and b is not None \
                else None

        prompt = getattr(req, "prompt", None)
        rec = {
            "t": time.time(),
            "request_id": getattr(tr, "request_id", None),
            "tenant": getattr(req, "tenant", None),
            "prompt_tokens": int(getattr(prompt, "size", 0) or 0),
            "prefill_computed": int(getattr(req, "u_prefill_computed", 0)),
            "prefill_saved": int(getattr(req, "u_prefill_saved", 0)),
            "generated": int(getattr(req, "u_generated", 0)),
            "spec_accepted": int(getattr(req, "u_spec_accepted", 0)),
            "kv_page_steps": int(getattr(req, "u_page_steps", 0)),
            "migrations": int(getattr(req, "u_migrations", 0)),
            "imported": bool(getattr(req, "imported", False)),
            "queue_wait_s": _span(t_submit, t_admit),
            "ttft_s": _span(t_accept, t_first),
            "e2e_s": _span(t_accept, t_done),
            "error": typed_error(error),
        }
        (log if log is not None else usage_log).emit(rec)
    except Exception:  # noqa: BLE001 — metering must never kill serving
        pass
