"""Flight recorder + watchdog: "why did the engine stop at 03:12?"
(counterpart of `paddle_tpu/observability/flight_recorder.py`; the port's
ring is its own, never the JAX package's).

Aggregates and traces explain latency; a HANG explains nothing: the
process just stops answering. Two pieces close that gap:

- :class:`FlightRecorder`: a bounded, thread-safe ring of recent
  structured events (request admissions and retirements, step sequence
  numbers, graph captures, train steps). Cheap enough to leave on
  permanently; old events fall off, memory never grows. The process-wide
  default ring is ``flight`` (mirroring ``metrics``).
- :class:`Watchdog`: a daemon thread that polls a *progress* reading
  (e.g. the engine's ``step_seq``). If the loop it guards is busy but
  progress has not advanced within the deadline, it dumps the event ring,
  the live per-request traces and the full metrics snapshot to a JSON
  file and notes the path on stderr: a post-mortem artifact instead of a
  silent hang. Exactly ONE dump per distinct stall: after dumping it
  re-arms only when progress advances again. It reads host state only,
  never the card.

Wired into `inference/engine.py` (`DecodeEngine.start_watchdog`, on by
default under `serve_loop`) and `train/scan_step.py`
(`ScanTrainStep.start_watchdog`). Knobs, the JAX package's own:
``PADDLE_WATCHDOG_S`` (deadline seconds, default 300; <= 0 disables the
serve-loop watchdog) and ``PADDLE_WATCHDOG_DIR`` (dump directory, default
the system temp dir).

Stdlib-only, like everything under ``observability/``.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time

from paddle_tpu_torch.observability import metrics

__all__ = ["FlightRecorder", "Watchdog", "flight", "dump_ring"]

_EVENTS = 2048          # default ring capacity


class FlightRecorder:
    """Bounded ring of recent structured events."""

    def __init__(self, capacity: int = _EVENTS):
        self._ring = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, kind: str, **fields):
        """Append one event. ``fields`` must be JSON-serializable scalars —
        the dump is a post-mortem artifact, keep entries small."""
        with self._lock:
            self._seq += 1
            self._ring.append({"seq": self._seq, "t": time.time(),
                               "kind": kind, **fields})

    def events(self) -> list:
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()


# the process-wide default ring every instrumented layer records into
flight = FlightRecorder()


def _default_dump_dir():
    return os.environ.get("PADDLE_WATCHDOG_DIR") or tempfile.gettempdir()


def dump_ring(label, out_dir=None, recorder=None, **extra) -> str:
    """Write the flight ring + the metrics snapshot (+ any ``extra``
    JSON-serializable context) to a post-mortem JSON file and return its
    path: the shared artifact writer for a first-failure dump; the
    watchdog keeps its own richer payload (per-request traces, stall
    metadata). ``PADDLE_WATCHDOG_DIR`` picks the directory like the
    watchdog's."""
    out_dir = out_dir or _default_dump_dir()
    os.makedirs(out_dir, exist_ok=True)
    rec = recorder if recorder is not None else flight
    path = os.path.join(
        out_dir, f"{label}_{os.getpid()}_{int(time.time())}.json")
    with open(path, "w") as f:
        json.dump({"label": str(label), **extra,
                   "events": rec.events(),
                   "metrics": metrics.snapshot()}, f, indent=1)
    return path


def _slo_section(n_usage: int = 32) -> dict:
    """The stall dump's "what was the fleet promising, and to whom" block:
    currently-firing SLO alerts (every live evaluator), recent alert
    transitions, and the last N usage records. Lazy imports + a blanket
    guard: the dump writer must survive anything."""
    out = {"firing": [], "events": [], "usage": []}
    try:
        from paddle_tpu_torch.observability.slo import (active_alerts,
                                                        recent_events)
        out["firing"] = active_alerts()
        out["events"] = recent_events()
    except Exception:  # noqa: BLE001 — post-mortems must always land
        pass
    try:
        from paddle_tpu_torch.observability.usage import usage_log
        out["usage"] = usage_log.last(n_usage)
    except Exception:  # noqa: BLE001
        pass
    return out


def default_deadline(fallback: float = 300.0) -> float:
    """Deadline seconds from ``PADDLE_WATCHDOG_S`` (<= 0 disables)."""
    try:
        return float(os.environ.get("PADDLE_WATCHDOG_S", fallback))
    except ValueError:
        return fallback


class Watchdog:
    """Stall detector for a step loop.

    name      : goes into the dump filename and payload
    progress  : () -> comparable — advances every loop iteration (a
                Counter.value read is the usual choice)
    busy      : () -> bool — True while the loop HAS work; no-progress
                while idle is not a stall (default: always busy)
    deadline_s: dump when busy and progress is frozen this long
    traces    : () -> list[RequestTrace] whose `to_dict()`s go in the dump
    recorder  : FlightRecorder to snapshot (default the process ring)
    interval_s: poll period (default deadline/4, floored at 10 ms)
    """

    def __init__(self, name, progress, *, busy=None, deadline_s=300.0,
                 dump_dir=None, traces=None, recorder=None, interval_s=None):
        self.name = str(name)
        self._progress = progress
        self._busy = busy or (lambda: True)
        self.deadline_s = float(deadline_s)
        self.dump_dir = dump_dir or _default_dump_dir()
        self._traces = traces or (lambda: [])
        self._recorder = recorder if recorder is not None else flight
        self._interval = max(0.01, interval_s if interval_s is not None
                             else self.deadline_s / 4.0)
        self._stop = threading.Event()
        self._thread = None
        self._armed_since = None     # first no-progress-while-busy sighting
        self._last_progress = None
        self._dumped_at = None       # progress value the last dump fired on
        self.dump_count = 0
        self.dump_paths: list[str] = []
        self._g_stalls = metrics.counter("watchdog.stalls", loop=self.name)

    # ---------------------------------------------------------------- thread

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"pt-watchdog-{self.name}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
        return False

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self.check()
            except Exception as e:  # noqa: BLE001 — the guard must survive
                print(f"[watchdog:{self.name}] check failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)

    # ----------------------------------------------------------------- logic

    def check(self, now=None):
        """One poll (the thread calls this; tests can call it directly)."""
        now = time.perf_counter() if now is None else now
        p = self._progress()
        if p != self._last_progress or not self._busy():
            # moving, or legitimately idle: reset the stall clock and
            # re-arm the one-dump-per-stall latch once progress resumes
            self._last_progress = p
            self._armed_since = None
            if p != self._dumped_at:
                self._dumped_at = None
            return
        if self._armed_since is None:
            self._armed_since = now
            return
        stalled = now - self._armed_since
        if stalled >= self.deadline_s and self._dumped_at is None:
            # latch only AFTER the dump lands: a failed write (unwritable
            # dir, transient IO error) propagates to _run's guard and the
            # next poll retries — a hard hang must not end up artifact-less
            # because the first attempt failed
            self.dump(stalled_s=stalled, progress=p)
            self._dumped_at = p
            self._g_stalls.inc()

    def dump(self, stalled_s=None, progress=None) -> str:
        """Write the post-mortem JSON; returns its path."""
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(
            self.dump_dir,
            f"watchdog_{self.name}_{os.getpid()}_{int(time.time())}"
            f"_{self.dump_count}.json")
        payload = {
            "watchdog": self.name,
            "pid": os.getpid(),
            "wall_time": time.time(),
            "stalled_for_s": round(stalled_s, 3) if stalled_s is not None
            else None,
            "progress": progress,
            "deadline_s": self.deadline_s,
            "events": self._recorder.events(),
            "traces": [t.to_dict() for t in self._traces()],
            "metrics": metrics.snapshot(),
            "slo": _slo_section(),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        self.dump_count += 1
        self.dump_paths.append(path)
        print(f"[watchdog:{self.name}] no progress for "
              f"{payload['stalled_for_s']}s — flight recorder dumped to "
              f"{path}", file=sys.stderr)
        return path
