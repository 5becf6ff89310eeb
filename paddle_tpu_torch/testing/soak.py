"""Soak harness: the deterministic fault-injection answer to soak testing
(counterpart of `paddle_tpu/testing/soak.py`, over the port's chaos suites
and engine).

Classic soak testing hammers a system with random load for hours and hopes
a race shows up. This repo's chaos suites are DETERMINISTIC (named fault
sites, exact fire counts — `testing/faults.py`), so the soak equivalent is
repetition with ROTATED orderings: run the chaos suites N times, each
iteration starting from a different suite, so cross-suite residue (a
leaked thread, an unarmed-but-counted fault, a metrics baseline
assumption) gets every adjacency. On the FIRST failure the harness dumps
the flight-recorder ring + the metrics snapshot to JSON — the post-mortem
a flaky CI retry throws away.

    python -m paddle_tpu_torch.testing.soak --iterations 5
    python -m paddle_tpu_torch.testing.soak --micro --device cpu

Two layers:

- `run()` — pytest over the port's chaos suites (engine lifecycle,
  train chaos, elastic multi-process training, handoff and migration,
  the router and control plane, disaggregated serving, the fleet
  collector, KV tiers, tracing), suite order rotated per iteration.
- `run_micro()` — a self-contained pytest-free micro-drill: one tiny
  engine per iteration driven through a rotated ordering of fault
  scenarios
  (slow steps, transient pool pressure, wire-blob corruption, page-stream
  corruption, peer-death liveness), asserting typed outcomes and a
  page-clean pool each time.

Both dump the ring via `dump_ring()` on first failure and stop — a soak
failure is a real bug with a fresh post-mortem, not a statistic.
"""
from __future__ import annotations

import argparse
import os

__all__ = ["CHAOS_SUITES", "rotated", "dump_ring", "peer_lost_drill",
           "run", "run_micro", "main"]

# the port's chaos suites, in their canonical order (rotation starts
# here), each the counterpart of the JAX suite at the same position
CHAOS_SUITES = (
    "tests/test_torch_lifecycle.py",
    "tests/test_torch_fault_tolerance.py",
    "tests/test_torch_elastic.py",
    "tests/test_torch_handoff.py",
    "tests/test_torch_router.py",
    "tests/test_torch_router_fleet.py",
    "tests/test_torch_fleet.py",
    "tests/test_torch_kv_tiers.py",
    "tests/test_torch_tracing.py",
)


def rotated(seq, i: int) -> list:
    """``seq`` rotated left by ``i`` (mod len) — iteration i's ordering."""
    seq = list(seq)
    if not seq:
        return seq
    i %= len(seq)
    return seq[i:] + seq[:i]


def dump_ring(out_dir: str = ".", label: str = "soak") -> str:
    """Write the flight-recorder ring + the metrics snapshot to a JSON
    post-mortem file and return its path. Delegates to the shared
    artifact writer (`observability/flight_recorder.py:dump_ring`), so
    the soak dump, the watchdog dump, and the liveness PeerLost dump all
    share one shape: {label, events, metrics}."""
    from paddle_tpu_torch.observability.flight_recorder import \
        dump_ring as _dump
    return _dump(label, out_dir=out_dir)


def run(iterations: int = 3, suites=None, out_dir: str = ".",
        pytest_args=()) -> int:
    """Run the chaos suites ``iterations`` times, suite order rotated per
    iteration. Stops at the FIRST failing iteration: dumps the flight
    ring to ``out_dir`` and returns the pytest exit code (0 = every
    iteration green)."""
    import pytest
    suites = list(CHAOS_SUITES if suites is None else suites)
    for i in range(int(iterations)):
        order = rotated(suites, i)
        print(f"SOAK iteration {i + 1}/{iterations}: {' '.join(order)}",
              flush=True)
        rc = pytest.main([*order, "-q", "-p", "no:cacheprovider",
                          "-p", "no:randomly", *pytest_args])
        if rc != 0:
            path = dump_ring(out_dir)
            print(f"SOAK FAILED at iteration {i + 1}; "
                  f"flight ring dumped to {path}", flush=True)
            return int(rc) or 1
    print(f"SOAK OK: {iterations} iteration(s)", flush=True)
    return 0


def peer_lost_drill(out_dir=None) -> bool:
    """One typed-PeerLost conversion on a 2-rank heartbeat board: the
    peer beats once, goes silent past the deadline, and ``check()`` must
    raise typed `PeerLost` (docs/ROBUSTNESS.md "Multi-host training").
    Returns True when the typed error fired. The micro-drill's
    ``peer_death`` scenario runs it."""
    import json
    import tempfile
    import time

    from paddle_tpu_torch.distributed.liveness import (LivenessMonitor,
                                                       PeerLost)
    d = out_dir or tempfile.mkdtemp(prefix="peer_lost_drill_")
    mon = LivenessMonitor(d, rank=0, world=2, deadline_s=0.02)
    # the beat lands AFTER the monitor's birth (pre-birth beats read as
    # stale files from a previous incarnation and fall under grace)
    with open(os.path.join(d, "hb-1.json"), "w") as f:
        json.dump({"rank": 1, "step": 3, "t": time.time()}, f)
    mon.beat(4)
    mon.check()                         # fresh peer: healthy
    time.sleep(0.06)                    # peer goes silent past deadline
    try:
        mon.check(context="peer-lost drill")
    except PeerLost:
        return True
    return False


# ------------------------------------------------------------ micro drill


def _micro_scenarios():
    """The pytest-free drill scenarios. Each takes a fresh tiny engine
    and must leave it page-clean; order is rotated per iteration."""
    import numpy as np

    from paddle_tpu_torch.testing import faults

    def slow_steps(eng):
        # slowed steps must change nothing but wall clock
        with faults.scoped("engine.step_delay", times=3, delay_s=0.005):
            r = eng.submit(np.arange(5, dtype=np.int32), 3,
                           request_key=bytes(range(16)))
            eng.run_until_idle(max_steps=64)
            assert r.result(timeout=10).shape == (8,)
        # and the idempotency replay answers without re-running
        r2 = eng.submit(np.arange(5, dtype=np.int32), 3,
                        request_key=bytes(range(16)))
        assert r2 is r

    def pool_pressure(eng):
        # one injected allocation failure defers admission while another
        # request occupies the engine; both still complete (prompt sizes
        # fit an 8-position model)
        a = eng.submit(np.arange(4, dtype=np.int32), 4)
        eng.step()
        with faults.scoped("engine.pool_pressure", times=1):
            b = eng.submit(np.arange(1, 5, dtype=np.int32), 3)
            eng.run_until_idle(max_steps=64)
        assert a.result(timeout=10) is not None
        assert b.result(timeout=10) is not None

    def blob_corrupt(eng):
        # a bit-flipped handoff blob must refuse typed, never decode
        from paddle_tpu_torch.inference.engine import KVHandoff
        from paddle_tpu_torch.inference.errors import HandoffCorrupt
        h = eng.prefill_export(np.arange(6, dtype=np.int32))
        blob = h.pack()
        KVHandoff.unpack(blob)                  # clean round trip
        bad = bytearray(blob)
        bad[-9] ^= 0x20
        try:
            KVHandoff.unpack(bytes(bad))
        except HandoffCorrupt:
            return
        raise AssertionError("corrupt blob was not refused")

    def stream_corrupt(eng):
        # the disaggregated page stream: a clean record sequence
        # assembles bit-identical, and a bit flip in a MID-STREAM chunk
        # refuses typed before any page is adopted
        from paddle_tpu_torch.inference.errors import HandoffCorrupt
        from paddle_tpu_torch.serving.disagg import (KVStreamAssembler,
                                                     stream_records)
        h = eng.prefill_export(np.arange(6, dtype=np.int32))
        recs = stream_records(h, pages_per_batch=1)
        asm = KVStreamAssembler()
        out = None
        for r in recs:
            out = asm.feed(r)
        assert out is not None and np.array_equal(out.prompt, h.prompt)
        asm2 = KVStreamAssembler()
        asm2.feed(recs[0])
        bad = bytearray(recs[1])
        bad[-5] ^= 0x04
        try:
            asm2.feed(bytes(bad))
        except HandoffCorrupt:
            return
        raise AssertionError("corrupt stream record was not refused")

    def peer_death(eng):
        # the multi-host liveness contract, engine-free: a 2-rank
        # heartbeat board whose peer went silent past the deadline must
        # raise typed PeerLost (never hang)
        del eng
        assert peer_lost_drill(), "silent peer was not typed PeerLost"

    return [slow_steps, pool_pressure, blob_corrupt, stream_corrupt,
            peer_death]


def run_micro(iterations: int = 2, model=None, out_dir: str = ".",
              device=None) -> int:
    """Self-contained soak drill (no pytest): per iteration, one tiny
    engine driven through a ROTATED ordering of the fault scenarios,
    pool asserted page-clean after each. Returns 0 on success; on the
    first failure dumps the flight ring and returns 1. ``model`` reuses
    a caller's tiny GPT; ``device`` is the engine's (None: the card)."""
    import torch

    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig

    if model is None:
        from paddle_tpu_torch import device as device_mod
        from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
        with device_mod.device_scope(device):
            model = GPTForCausalLM(GPTConfig(
                vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=32,
                hidden_dropout=0.0, attention_dropout=0.0),
                generator=torch.Generator().manual_seed(17))
    scenarios = _micro_scenarios()
    for i in range(int(iterations)):
        eng = DecodeEngine(model, EngineConfig(page_size=4, max_slots=2,
                                               min_bucket=8), device=device)
        try:
            for scenario in rotated(scenarios, i):
                scenario(eng)
                assert eng.allocator.free_pages \
                    == eng.allocator.num_pages - 1, (
                        f"{scenario.__name__} leaked pages")
        except Exception as e:  # noqa: BLE001 — dump, then report
            path = dump_ring(out_dir, label="soak_micro")
            print(f"SOAK MICRO FAILED at iteration {i + 1} "
                  f"({type(e).__name__}: {e}); ring dumped to {path}",
                  flush=True)
            return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "paddle_tpu_torch.testing.soak",
        description="repeat the deterministic chaos suites with rotated "
                    "orderings; dump the flight ring on first failure")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--suite", action="append", default=[],
                    help="suite path (repeatable; default: the chaos "
                         "suites)")
    ap.add_argument("--out-dir", default=".",
                    help="where a failure post-mortem JSON lands")
    ap.add_argument("--micro", action="store_true",
                    help="run the pytest-free micro drill instead")
    ap.add_argument("-k", default=None,
                    help="pytest -k selection forwarded to the suites")
    ap.add_argument("--device", default=None,
                    help="the micro drill's engine device (default: cuda)")
    args = ap.parse_args(argv)
    if args.micro:
        return run_micro(iterations=args.iterations, out_dir=args.out_dir,
                         device=args.device)
    extra = ("-k", args.k) if args.k else ()
    return run(iterations=args.iterations,
               suites=args.suite or None, out_dir=args.out_dir,
               pytest_args=extra)


if __name__ == "__main__":
    raise SystemExit(main())
