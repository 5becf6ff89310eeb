"""Request-scoped tracing: where did THIS request's latency go?
(counterpart of `paddle_tpu/observability/tracing.py`)

The registry (`observability/__init__.py`) answers process-wide questions;
serving SLOs need per-request ones: queue wait against prefill against
decode, TTFT and TPOT percentiles.

One :class:`RequestTrace` rides each request from `DecodeEngine.submit`
(or an upstream acceptor that passes its own) through admission, prefill,
decode and retirement. Each phase transition:

- records a span on the registry's Chrome-trace ring with the shared
  ``request_id`` in the event ``args``: load the export in Perfetto and
  filter by ``request_id`` to see one request's whole life;
- feeds the derived SLO histograms that ``snapshot()`` and
  ``to_prometheus()`` expose:

  | histogram            | meaning                                        |
  |----------------------|------------------------------------------------|
  | `serve.ttft_seconds` | accept -> first generated token (TTFT)         |
  | `serve.tpot_seconds` | per-output-token time AFTER the first (TPOT):  |
  |                      | (t_done - t_first) / (n_tokens - 1) per request|
  | `serve.e2e_seconds`  | accept -> retirement                           |

Phase marks are monotonic (`time.perf_counter`) and each transition is
idempotent-guarded, so double-marking (an EOS retire during the harvest of
an already-finished entry) cannot double-count a histogram.

The fleet trace context (`mint_trace`, `trace_to_words`) is the JAX
package's wire encoding, kept here for the handoff and serving modules
still to be ported. Stdlib-only, like everything under ``observability/``.
"""
from __future__ import annotations

import itertools
import os
import struct
import threading
import time

from paddle_tpu_torch.observability import _EPOCH, metrics

__all__ = ["RequestTrace", "new_request_id", "mint_trace", "new_span_id",
           "trace_to_words", "words_to_trace", "TRACE_WORDS"]

_ids = itertools.count(1)


def new_request_id() -> str:
    """Process-unique monotonic request id (``req-<n>``); `itertools.count`
    is atomic under the GIL, so ids are unique across submitter threads."""
    return f"req-{next(_ids)}"


# ------------------------------------------------------------- fleet context
#
# A fleet trace context is a 16-byte random trace id plus the 8-byte span id
# of the upstream hop, minted once at ingress (`RemotePredictor.generate` or
# the router) and threaded through every wire hop. On the wire it rides as
# six little-endian int32 words appended to the existing int32 options
# vectors (GENERATE/PREFILL/KV_STREAM) — all-zero words mean "no trace",
# which a random 128-bit id never collides with in practice.

TRACE_WORDS = 6  # 4 words trace id + 2 words parent span id


def mint_trace() -> tuple[str, str]:
    """New (trace_id, span_id) hex pair for an ingress request."""
    return os.urandom(16).hex(), os.urandom(8).hex()


def new_span_id() -> str:
    """Fresh 8-byte span id (hex) for one process's hop within a trace."""
    return os.urandom(8).hex()


def trace_to_words(trace_id: str | None, parent: str | None) -> list[int]:
    """Encode a (trace_id, parent span) hex context as TRACE_WORDS signed
    int32 words for the wire options vectors. ``None`` encodes as zeros."""
    tb = bytes.fromhex(trace_id) if trace_id else b"\x00" * 16
    pb = bytes.fromhex(parent) if parent else b"\x00" * 8
    return list(struct.unpack("<4i", tb)) + list(struct.unpack("<2i", pb))


def words_to_trace(words) -> tuple[str | None, str | None]:
    """Decode TRACE_WORDS int32 words back to (trace_id, parent) hex;
    all-zero groups decode to ``None``."""
    tb = struct.pack("<4i", *(int(w) for w in words[:4]))
    pb = struct.pack("<2i", *(int(w) for w in words[4:6]))
    return (tb.hex() if any(tb) else None,
            pb.hex() if any(pb) else None)


class RequestTrace:
    """Phase marks for one generation request.

    Lifecycle (each mark records the span it closes):

        accept ──queue──> admitted ──prefill──> first_token ──decode──> done
           └────────────────────── e2e ───────────────────────────────────┘

    ``accept`` is wire-accept when serve creates the trace, or submit time
    when the engine creates it (`DecodeEngine.submit` with no trace given).
    """

    __slots__ = ("request_id", "t_accept", "t_submit", "t_admit",
                 "t_first_token", "t_done", "n_tokens", "error", "_lock",
                 "trace_id", "parent_span", "span_id")

    def __init__(self, request_id: str | None = None,
                 trace_id: str | None = None, parent_span: str | None = None):
        self.request_id = request_id or new_request_id()
        self._lock = threading.Lock()
        self.t_accept = time.perf_counter()
        self.t_submit = None
        self.t_admit = None
        self.t_first_token = None
        self.t_done = None
        self.n_tokens = 0
        self.error = None
        # fleet trace context (hex strings); absent on local-only requests
        self.trace_id = trace_id
        self.parent_span = parent_span
        self.span_id = new_span_id() if trace_id else None

    def attach_context(self, trace_id: str | None,
                       parent_span: str | None = None):
        """Adopt a wire-carried trace context AFTER construction (serve
        creates the trace before the options vector is parsed). Idempotent;
        a no-op when no context rode the request."""
        if trace_id and self.trace_id is None:
            self.trace_id = trace_id
            self.parent_span = parent_span
            self.span_id = new_span_id()

    # ------------------------------------------------------------ phase marks

    def _span(self, phase, t0, t1):
        metrics.add_span(f"request.{phase}", t0, max(0.0, t1 - t0),
                         cat="request", args={"request_id": self.request_id},
                         trace_id=self.trace_id, parent=self.parent_span,
                         span_id=self.span_id)

    def mark_submit(self):
        """Entered the scheduler queue (engine submit)."""
        if self.t_submit is None:
            self.t_submit = time.perf_counter()

    def mark_admitted(self):
        """Left the queue: slot + pages assigned, prefill about to run.
        Only the per-request span lands here — the aggregate queue-wait
        histogram already exists as `engine.queue_wait_seconds`."""
        if self.t_admit is not None:
            return
        self.t_admit = time.perf_counter()
        t0 = self.t_submit if self.t_submit is not None else self.t_accept
        self._span("queue", t0, self.t_admit)

    def mark_first_token(self):
        """Prefill produced the first generated token — the TTFT moment."""
        if self.t_first_token is not None:
            return
        self.t_first_token = time.perf_counter()
        self.n_tokens = max(self.n_tokens, 1)
        self._span("prefill", self.t_admit if self.t_admit is not None
                   else self.t_accept, self.t_first_token)
        metrics.histogram("serve.ttft_seconds").observe(
            self.t_first_token - self.t_accept)

    def mark_tokens(self, n=1):
        """``n`` more generated tokens delivered (decode harvest)."""
        self.n_tokens += int(n)

    def mark_done(self, error: str | None = None):
        """Retired (delivered, EOS, or failed): closes decode + e2e spans
        and lands the per-request TPOT/e2e observations. The done
        transition is locked — the engine thread (retirement) and a serve
        connection thread (result timeout) can race to close the same
        trace, and exactly one of them may account it."""
        with self._lock:
            if self.t_done is not None:
                return
            self.t_done = time.perf_counter()
            self.error = error
        if self.t_first_token is not None:
            self._span("decode", self.t_first_token, self.t_done)
        self._span("e2e", self.t_accept, self.t_done)
        if error is None:
            # SLO histograms take SUCCESSFUL requests only: an aborted
            # request's t_done is stamped whenever the failure surfaced,
            # and one stall must not corrupt the TPOT/e2e percentiles
            if self.t_first_token is not None and self.n_tokens > 1:
                metrics.histogram("serve.tpot_seconds").observe(
                    (self.t_done - self.t_first_token)
                    / (self.n_tokens - 1))
            metrics.histogram("serve.e2e_seconds").observe(
                self.t_done - self.t_accept)
        else:
            metrics.counter("serve.request_errors").inc()

    # --------------------------------------------------------------- exports

    @property
    def done(self) -> bool:
        return self.t_done is not None

    def phase(self) -> str:
        if self.t_done is not None:
            return "done" if self.error is None else "error"
        if self.t_first_token is not None:
            return "decode"
        if self.t_admit is not None:
            return "prefill"
        if self.t_submit is not None:
            return "queued"
        return "accepted"

    def to_dict(self) -> dict:
        """JSON-ready record (watchdog dumps, debugging). Times are
        process-epoch-relative seconds, matching the Chrome-trace ring."""
        d = {"request_id": self.request_id, "phase": self.phase(),
             "n_tokens": self.n_tokens, "error": self.error,
             "trace_id": self.trace_id, "parent": self.parent_span}
        for k in ("t_accept", "t_submit", "t_admit", "t_first_token",
                  "t_done"):
            v = getattr(self, k)
            # same epoch as the span ring (seconds vs its microseconds), so
            # a watchdog dump's times line up with the exported Chrome trace
            d[k] = round(v - _EPOCH, 6) if v is not None else None
        return d
