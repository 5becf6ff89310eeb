"""A drill of every eager collective across the processes of one fleet
(`distributed/collective.py`), for the two-process CPU test
(`tests/test_torch_collective.py`) and the card's world-2 arm
(`chip_smoke.py`'s ``quant_comms``).

Each rank process joins the fleet with `init_parallel_env` (the launch
env: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``),
runs every op on tensors of ``--device`` made from `inputs(rank)`, and
writes what it got to ``<out>/rank<r>.npz`` and ``<out>/rank<r>.json``
(each op's ``collective.calls`` / ``collective.bytes`` deltas, its
seconds a call, and the group bookkeeping). The caller holds the results
against closed forms of its own::

    PADDLE_TRAINER_ID=r PADDLE_TRAINERS_NUM=2 PADDLE_MASTER=127.0.0.1:PORT \\
        python -m paddle_tpu_torch.testing.collective_drill --device cpu \\
        --numel 1000 --out DIR

or `spawn(world, out, device, numel)` from Python. bfloat16 arrays are
written as float32 (numpy has no bfloat16).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

__all__ = ["inputs", "alltoall_single_splits", "P2P_ROUNDS", "QUANT_BLOCKS",
           "spawn", "main"]

P2P_ROUNDS = 3                  # send/recv pairs each way, keys in step
QUANT_BLOCKS = (None, 64)       # the default block and a small one


def inputs(rank: int, numel: int) -> np.ndarray:
    """Rank ``rank``'s float32 payload of ``numel`` values."""
    return np.random.RandomState(100 + rank).randn(numel).astype(np.float32)


def alltoall_single_splits(rank: int, world: int, rows: int):
    """Uneven ``(in_split_sizes, out_split_sizes)`` of an alltoall_single
    over ``rows`` rows a rank: rank r sends ``r + j + 1`` rows to rank j
    (the rest to the last rank)."""
    def sends(r):
        head = [r + j + 1 for j in range(world - 1)]
        return head + [rows - sum(head)]
    return sends(rank), [sends(r)[rank] for r in range(world)]


def _counts():
    from paddle_tpu_torch.observability import metrics
    snap = metrics.snapshot()["counters"]
    return {k: v for k, v in snap.items() if k.startswith("collective.")}


def _delta(before):
    now = _counts()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def run(device: str, numel: int, out: str) -> dict:
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.parallel import (get_rank,
                                                       get_world_size,
                                                       init_parallel_env)

    init_parallel_env()
    rank, world = get_rank(), get_world_size()
    dev = torch.device(device if device != "cuda" else "cuda:0")
    x = inputs(rank, numel)
    arrays, ops = {}, {}

    def t(a, dtype=None):
        return paddle.to_tensor(np.array(a, copy=True), dtype=dtype)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(name, fn):
        before = _counts()
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        ops[name] = {"seconds": time.perf_counter() - t0,
                     "counts": _delta(before)}
        return res

    def keep(name, tensors):
        for i, v in enumerate(tensors):
            arrays[f"{name}/{i}"] = v.numpy()

    with tdevice.device_scope(dev):
        for op in ("sum", "avg", "max", "min", "prod"):
            r = t(x)
            timed(f"all_reduce/{op}", lambda: C.all_reduce(r, op=op))
            keep(f"all_reduce/{op}", [r])
        for op in ("sum", "avg"):
            for block in QUANT_BLOCKS:
                r = t(x)
                name = f"all_reduce_quantized/{op}/{block or 'default'}"
                timed(name, lambda: C.all_reduce(r, op=op, quantized=True,
                                                 quant_block=block))
                keep(name, [r])
        for op in ("max", "min", "prod"):
            try:
                C.all_reduce(t(x), op=op, quantized=True)
                ops[f"quantized_refused/{op}"] = None
            except ValueError as e:
                ops[f"quantized_refused/{op}"] = str(e)
        r = t(x, "bfloat16")
        timed("all_reduce/sum_bf16", lambda: C.all_reduce(r))
        keep("all_reduce/sum_bf16", [r])
        gathered = timed("all_gather", lambda: C.all_gather([], t(x)))
        keep("all_gather", gathered)
        objs = timed("all_gather_object", lambda: C.all_gather_object(
            [], {"rank": rank, "tag": "r" * (rank + 1)}))
        r = t(x)
        timed("broadcast", lambda: C.broadcast(r, src=world - 1))
        keep("broadcast", [r])
        r = t(np.zeros(numel // world, np.float32))
        parts = [t(c) for c in np.split(x[:numel // world * world], world)]
        timed("scatter", lambda: C.scatter(r, parts if rank == 0 else None,
                                           src=0))
        keep("scatter", [r])
        r = t(np.zeros(numel // world, np.float32))
        timed("reduce_scatter", lambda: C.reduce_scatter(r, parts))
        keep("reduce_scatter", [r])
        res = timed("alltoall", lambda: C.alltoall(parts))
        keep("alltoall", res)
        rows = numel // world * world
        res = timed("alltoall_single", lambda: C.alltoall_single(
            t(x[:rows])))
        keep("alltoall_single", [res])
        ins, outs = alltoall_single_splits(rank, world, numel)
        r = t(np.zeros(sum(outs), np.float32))
        timed("alltoall_single_uneven", lambda: C.alltoall_single(
            t(x), r, in_split_sizes=ins, out_split_sizes=outs))
        keep("alltoall_single_uneven", [r])
        got = []
        for i in range(P2P_ROUNDS):
            peer = (rank + 1) % world
            src = (rank - 1) % world
            payload = t(x * (i + 1))
            r = t(np.zeros_like(x))
            if rank % 2 == 0:
                timed(f"send/{i}", lambda: C.send(payload, dst=peer))
                timed(f"recv/{i}", lambda: C.recv(r, src=src))
            else:
                timed(f"recv/{i}", lambda: C.recv(r, src=src))
                timed(f"send/{i}", lambda: C.send(payload, dst=peer))
            got.append(r)
        keep("p2p", got)
        payload = t(x + 1.0)
        r = t(np.zeros_like(x))
        peer, src = (rank + 1) % world, (rank - 1) % world
        if rank % 2 == 0:
            tasks = [C.isend(payload, peer), C.irecv(r, src)]
        else:
            tasks = [C.irecv(r, src), C.isend(payload, peer)]
        keep("isend_irecv", [r])
        C.wait(r)
        g = C.new_group(list(range(world)))
        halves = C.split_group(g, [1, world - 1])
        groups = {"new_group": g.ranks, "split": [h.ranks for h in halves],
                  "get_group": C.get_group(g.id).ranks,
                  "rank_in_halves": [h.rank for h in halves],
                  "world_in_g": get_world_size(g),
                  "rank_in_g": get_rank(g)}
        C.destroy_process_group(halves[0])
        groups["after_destroy"] = C.get_group(halves[0].id).id
        C.destroy_process_group()
        groups["after_destroy_all"] = C.get_group(g.id).id
    record = {"rank": rank, "world": world, "device": str(dev),
              "numel": numel, "ops": ops, "objects": objs,
              "tasks_done": [tk.wait() and tk.is_completed()
                             for tk in tasks],
              "groups": groups,
              "p2p_seq": {f"{a}to{b}": n
                          for (a, b), n in C._p2p_seq.items()}}
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    _leave(rank, world)
    return record


def _leave(rank, world):
    """Rank 0 hosts the store: it leaves only after every other rank has
    said that it no longer needs it."""
    import datetime

    from paddle_tpu_torch.distributed import parallel
    store = parallel._store
    if rank:
        store.set(f"ptpu_drill_left/{rank}", b"1")
    else:
        store.wait([f"ptpu_drill_left/{r}" for r in range(1, world)],
                   datetime.timedelta(seconds=120))


def spawn(world: int, out: str, device: str = "cpu", numel: int = 1000,
          env=None, timeout: float = 300.0) -> list[int]:
    """Run the drill in ``world`` local rank processes (a fresh store port)
    and wait for them; returns their exit codes. Each rank's output goes
    to ``<out>/rank<r>.log``."""
    from paddle_tpu_torch.train.elastic import _free_port
    os.makedirs(out, exist_ok=True)
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for rank in range(world):
        e = dict(os.environ if env is None else env)
        e.update(PADDLE_TRAINER_ID=str(rank), PADDLE_TRAINERS_NUM=str(world),
                 PADDLE_MASTER=f"127.0.0.1:{port}",
                 PYTHONPATH=repo + os.pathsep + e.get("PYTHONPATH", ""))
        e.pop("PADDLE_FAULTS", None)
        with open(os.path.join(out, f"rank{rank}.log"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.testing."
                 "collective_drill", "--device", device, "--numel",
                 str(numel), "--out", out], env=e, stdout=log,
                stderr=subprocess.STDOUT))
    deadline = time.time() + timeout
    try:
        return [p.wait(timeout=max(1.0, deadline - time.time()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--numel", type=int, default=1000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    run(args.device, args.numel, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
