"""Elastic multi-host training: bounded-time termination + restart
(counterpart of `paddle_tpu/train/elastic.py`: the same reducer payload,
exit codes, flight events, counters and drill CLI, plus ``--device``).

The training mirror of the serving plane's contract (docs/ROBUSTNESS.md):
every distributed training step terminates in bounded time with progress,
a checkpoint, or a TYPED error — never an indefinite collective hang.
Three pieces:

- :class:`FleetReducer` — cross-process data parallelism: each rank
  computes grads over ITS shard of the global batch
  (`ScanTrainStep(grad_reducer=...)` split mode), and the reducer averages
  loss+grads through the fleet store's KV allgather
  (`distributed/collective.py`), liveness-guarded so a dead
  peer resolves as typed :class:`PeerLost` within the heartbeat deadline.
  A fleet STOP VOTE rides the same payload: any rank's SIGTERM flag is
  max-reduced every step, so the whole fleet agrees to stop at the SAME
  step boundary and drains into one coordinated final checkpoint — the
  multi-host `install_sigterm` contract.
- :func:`run_elastic_worker` — the per-rank training loop: per-step
  heartbeats (`distributed/liveness.py`), a ``trainer``-role lease in the
  elastic registry (`fleet/elastic.py` — the same registry serving rides),
  multi-host `CheckpointManager` saves (barrier-published, "complete or
  invisible" fleet-wide), and the `train.peer_dead` chaos site (the armed
  rank SIGKILLs itself at a step boundary — the deterministic stand-in
  for spot reclaim).
- :class:`ElasticController` — the supervising relauncher: spawns the
  fleet, classifies exits (rc 0 = done; ``EXIT_PEER_LOST`` = a healthy
  survivor that detected a dead peer and aborted typed; anything else =
  the dead peer itself), reforms at the largest allowed world size the
  survivors support, and relaunches — the new fleet resumes from the
  last fleet-complete checkpoint.

Determinism note: the reducer's mean runs in f32 over the rank-ordered
[P, N] stack, so two dp=k runs from the same checkpoint produce
bit-identical trajectories where the step's own kernels repeat bit for
bit (tests/test_torch_elastic.py; on the card `chip_smoke.py`'s
``train_elastic`` reports it).
"""
from __future__ import annotations

import os
import signal
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.distributed.liveness import LivenessMonitor, PeerLost
from paddle_tpu_torch.distributed import liveness
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import flight
from paddle_tpu_torch.testing import faults

__all__ = ["FleetReducer", "run_elastic_worker", "elastic_worker_main",
           "ElasticController", "EXIT_PEER_LOST", "PeerLost",
           "spawn_local_fleet"]

# the exit code a SURVIVOR uses after detecting a dead peer: the process
# is healthy (it can be relaunched into the reformed fleet) — the
# controller distinguishes it from the dead peer's own exit (signal /
# traceback rc). 23 collides with no shell/timeout/signal convention.
EXIT_PEER_LOST = 23


class FleetReducer:
    """Average (loss, grads) across the training fleet + the stop vote.

    Packs every grad leaf, the loss, and this rank's stop flag into ONE
    f32 vector per step — one KV allgather, not one per leaf — then
    unpacks the rank-mean. ``fleet_stop`` reads True once ANY rank voted
    stop at this step boundary; every rank sees the identical vote, so
    the fleet stops (and checkpoints) together. All reads are
    liveness-guarded: a peer that dies mid-step surfaces as typed
    PeerLost on every survivor within the monitor deadline.

    The leaves pack in the order ``jax.tree_util`` flattens the JAX tree
    (sorted keys at every level), so the packed vector is the JAX
    reducer's. Leaves may be torch tensors (on any device) or arrays; the
    answer's leaves are float32 numpy arrays. ``timings`` holds the newest
    reduce's seconds by piece (``pack``: the copy to the host and the
    concatenation; ``publish``, ``read``, ``barrier``: the allgather's;
    ``unpack``: the mean and the split) and its ``bytes`` moved.
    """

    def __init__(self, monitor=None):
        self.monitor = monitor
        self.request_stop = False      # this rank's vote (set by SIGTERM)
        self.fleet_stop = False        # the fleet's agreed answer
        self.reduces = 0
        self.timings: dict = {}

    def __call__(self, loss, grads):
        from paddle_tpu_torch.distributed import collective
        t0 = time.perf_counter()
        paths, leaves = _flatten_tree(grads)
        flat = np.concatenate(
            [_host_f32(a).ravel() for a in leaves]
            + [_host_f32(loss).ravel(),
               np.asarray([1.0 if self.request_stop else 0.0], np.float32)])
        t1 = time.perf_counter()
        multi = collective._multiprocess()
        if multi:
            stacked = np.asarray(collective._proc_allgather(flat))
        else:
            stacked = flat[None]       # degenerate 1-rank fleet
        t2 = time.perf_counter()
        self.reduces += 1
        self.fleet_stop = bool(stacked[:, -1].max() > 0.0)
        # f32 mean over the rank-ordered stack: deterministic for a fixed
        # world size — the resume-parity contract depends on this
        mean = stacked[:, :-1].mean(axis=0, dtype=np.float32)
        out, pos = [], 0
        for a in leaves:
            n = int(np.prod(tuple(a.shape)))   # scalars pack as 1, EMPTY
            #                                    leaves as 0
            out.append(mean[pos:pos + n].reshape(tuple(a.shape)))
            pos += n
        ag = collective.last_allgather if multi else {}
        self.timings = {"pack": t1 - t0,
                        "publish": ag.get("publish_s", 0.0),
                        "read": ag.get("read_s", 0.0),
                        "barrier": ag.get("barrier_s", 0.0),
                        "unpack": time.perf_counter() - t2,
                        "bytes": ag.get("bytes", 0)}
        return mean[pos], _unflatten_tree(paths, out)


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def _flatten_tree(tree, prefix=()):
    """([key path, ...], [leaf, ...]) of a nested dict, keys sorted at
    every level (``jax.tree_util.tree_flatten``'s order for dicts)."""
    if not isinstance(tree, dict):
        return [prefix], [tree]
    paths, leaves = [], []
    for k in sorted(tree):
        p, lv = _flatten_tree(tree[k], prefix + (k,))
        paths += p
        leaves += lv
    return paths, leaves


def _unflatten_tree(paths, leaves):
    if paths == [()]:
        return leaves[0]
    out = {}
    for path, leaf in zip(paths, leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def _escalate_if_peer_dead(exc, monitor, *, wait_s=None):
    """A collective that failed with a NON-timeout transport error (a
    dead coordinator drops connections rather than timing out) is still
    usually a dead peer: give the heartbeat deadline a moment to confirm
    and convert to typed PeerLost; otherwise re-raise the original."""
    if monitor is None or isinstance(exc, PeerLost):
        raise exc
    deadline = time.time() + (wait_s if wait_s is not None
                              else monitor.deadline_s + 2.0)
    while time.time() < deadline:
        monitor.rebeat()
        monitor.check(context=f"after {type(exc).__name__}")
        time.sleep(0.25)
    raise exc


def run_elastic_worker(make_step, batch_fn, *, root, until_step, every=2,
                       keep=3, deadline_s=15.0, hb_dir=None,
                       registry_dir=None, on_step=None,
                       install_sigterm=True, barrier_timeout_s=60.0,
                       max_batches=None):
    """One rank of an elastic training fleet (docs/ROBUSTNESS.md
    "Multi-host training").

    make_step : ``make_step(grad_reducer) -> ScanTrainStep`` — the
                function receives the fleet reducer (None on a world-1
                fleet) so the step runs in split grads/apply mode.
    batch_fn  : ``batch_fn(cursor, rank, world) -> (x, y)`` — this
                rank's SHARD of global batch ``cursor``. The cursor is
                the global data clock; sharding by (rank, world) is the
                caller's contract so a resumed smaller fleet re-shards
                the same global stream.
    root      : shared checkpoint root (heartbeats live under
                ``<root>/hb`` unless ``hb_dir`` overrides; reusing the
                dir across relaunch attempts is safe — the monitor
                ignores heartbeats/tombstones from before its own birth
                — but per-attempt dirs keep post-mortems legible, see
                `spawn_local_fleet`).
    deadline_s: size it ABOVE the fleet's worst-case per-step SKEW —
                guarded waiters re-beat while waiting and shard writes
                re-beat per file, but a rank inside a long first step
                (kernel builds, the allocator's first touches) cannot
                beat, so that step's spread across ranks bounds the
                deadline from below.

    Returns {rank, world, resumed_step, losses, stopped}. Raises typed
    :class:`PeerLost` when a peer dies — the caller should exit
    ``EXIT_PEER_LOST`` (see :func:`elastic_worker_main`) so the
    controller can count it as a relaunchable survivor.
    """
    from paddle_tpu_torch.distributed.parallel import (get_rank,
                                                       get_world_size,
                                                       init_parallel_env)
    init_parallel_env()
    rank, world = get_rank(), get_world_size()
    monitor = None
    if world > 1:
        monitor = LivenessMonitor(hb_dir or os.path.join(str(root), "hb"),
                                  rank, world, deadline_s=deadline_s)
        liveness.install(monitor)
        monitor.beat(-1)               # visible before the first compile
    reducer = FleetReducer(monitor) if world > 1 else None
    step = make_step(reducer)
    from paddle_tpu_torch.train.fault_tolerance import CheckpointManager
    mgr = CheckpointManager(root, step, every=every, keep=keep,
                            world=(rank, world),
                            barrier_timeout_s=barrier_timeout_s)
    if install_sigterm:
        mgr.install_sigterm()
    lease = None
    if registry_dir:
        from paddle_tpu_torch.distributed.fleet.elastic import (
            NodeRegistry, role_node_id)
        lease = NodeRegistry(registry_dir,
                             node_id=role_node_id("trainer", str(rank)),
                             endpoint=f"rank-{rank}", ttl=4 * deadline_s)
        lease.register()
    flight.record("train.elastic_worker", rank=rank, world=world,
                  until=int(until_step))
    try:
        cursor = 0
        info = mgr.restore()
        resumed = 0
        if info is not None:
            resumed = info["step"]
            if info.get("data_cursor") is not None:
                cursor = int(info["data_cursor"])
        losses, consumed, stopped = [], 0, False
        while int(step.opt.global_step) < int(until_step):
            if max_batches is not None and consumed >= max_batches:
                break
            if faults.ENABLED and faults.fire("train.peer_dead") \
                    and faults.remaining("train.peer_dead") == 0:
                # spot reclaim, deterministically: the LAST armed charge
                # (``times=k`` = die at the k-th step boundary) SIGKILLs
                # this rank WITHOUT cleanup — peers must detect via
                # heartbeats, exactly like a real preemption
                os.kill(os.getpid(), signal.SIGKILL)
            if monitor is not None:
                monitor.beat(int(step.opt.global_step))
            if reducer is not None:
                reducer.request_stop = mgr.should_stop
            try:
                loss = step.step(*batch_fn(cursor, rank, world))
            except PeerLost:
                raise
            except Exception as e:  # noqa: BLE001 — classify (dead peer?)
                _escalate_if_peer_dead(e, monitor)
            cursor += 1
            consumed += 1
            losses.append(loss)
            if on_step is not None:
                on_step(int(step.opt.global_step), loss, step.last_step_ok)
            mgr.after_step(data_cursor=cursor)
            if (reducer.fleet_stop if reducer is not None
                    else mgr.should_stop):
                # the stop vote resolved true on EVERY rank at this same
                # boundary: drain together into one final checkpoint
                stopped = True
                break
        mgr.finalize(data_cursor=cursor)
        return {"rank": rank, "world": world, "resumed_step": resumed,
                "losses": losses, "stopped": stopped}
    except PeerLost:
        if monitor is not None and rank == 0:
            # rank 0 hosts the fleet's store: its exit breaks every
            # process still attached, so the leader LINGERS until
            # the other survivors have either gone silent or published
            # their own typed tombstone — staggered detection must not
            # turn typed survivor exits into SIGABRTs
            monitor.wait_for_cascade()
        raise
    finally:
        if lease is not None:
            try:
                lease.leave()
            except OSError:
                pass
        if monitor is not None:
            liveness.uninstall()


def _hard_exit_peer_lost(e):
    """Print the one-line typed error (the flight ring was already
    dumped by the monitor) and HARD-EXIT ``EXIT_PEER_LOST``: with a dead
    peer in the fleet, the store client's teardown can block or abort,
    which the controller would misread as a dead peer instead of a
    relaunchable survivor — the typed rc IS the contract, so skip
    interpreter teardown entirely."""
    print(f"PeerLost: {e}", flush=True)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(EXIT_PEER_LOST)


def elastic_worker_main(make_step, batch_fn, **kw) -> int:
    """CLI-shaped wrapper: run one rank; returns 0 on a clean finish.
    On a typed PeerLost it never returns — see
    :func:`_hard_exit_peer_lost`. Anything else propagates."""
    try:
        run_elastic_worker(make_step, batch_fn, **kw)
    except PeerLost as e:
        _hard_exit_peer_lost(e)
    return 0


class ElasticController:
    """Supervising relauncher: reform the fleet at the surviving world
    size and resume from the last fleet-complete checkpoint.

    spawn         : ``spawn(world_size, attempt) -> [proc, ...]`` — proc
                    needs ``poll() -> rc|None``, ``kill()``, ``wait()``
                    (subprocess.Popen qualifies). The spawner owns env
                    wiring (fresh coordinator port per attempt!) and the
                    per-rank command line.
    world_size    : the initial fleet size.
    allowed_sizes : world sizes the training math supports (e.g. divisors
                    of the global batch). Default: every size from
                    world_size down to 1. After a failure the controller
                    picks the LARGEST allowed size <= the survivor count.
    min_world     : below this, give up instead of limping.
    max_restarts  : relaunch budget.
    settle_s      : after the first failed exit, how long the rest get to
                    exit typed on their own before being killed (size it
                    above the workers' liveness deadline).
    registry_dir  : optional — observe the trainer-role leases for the
                    flight record at each decision point.

    ``run()`` returns the final fleet's exit code: 0 when an attempt
    finishes clean, 1 when restarts/min_world are exhausted.
    """

    def __init__(self, spawn, *, world_size, allowed_sizes=None,
                 min_world=1, max_restarts=2, settle_s=60.0,
                 registry_dir=None, poll_s=0.2):
        self.spawn = spawn
        self.world_size = int(world_size)
        self.allowed = sorted(set(allowed_sizes)
                              if allowed_sizes is not None
                              else range(1, self.world_size + 1))
        self.min_world = int(min_world)
        self.max_restarts = int(max_restarts)
        self.settle_s = float(settle_s)
        self.registry_dir = registry_dir
        self.poll_s = float(poll_s)
        self.attempts = []             # [(world, [rc, ...])] per attempt

    def _registry_view(self):
        if not self.registry_dir:
            return None
        try:
            from paddle_tpu_torch.distributed.fleet.elastic import \
                NodeRegistry
            return sorted(NodeRegistry(self.registry_dir).alive_nodes())
        except OSError:
            return None

    def _await(self, procs):
        """Collect every proc's rc. After the FIRST non-zero exit the
        rest get ``settle_s`` to finish their typed abort, then are
        killed — a survivor that NEVER detects the death would otherwise
        hang the controller exactly like the collective it replaced."""
        first_bad = None
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                return rcs
            if first_bad is None:
                if any(rc not in (None, 0) for rc in rcs):
                    first_bad = time.time()
            elif time.time() - first_bad > self.settle_s:
                for p, rc in zip(procs, rcs):
                    if rc is None:
                        try:
                            p.kill()
                        except OSError:
                            pass
                return [p.wait() for p in procs]
            time.sleep(self.poll_s)

    def decide_next_world(self, rcs):
        """Pure decision: the largest allowed world size the survivors
        (typed PeerLost exits — healthy, relaunchable) can field, or 0
        when none is acceptable."""
        survivors = sum(1 for rc in rcs if rc == EXIT_PEER_LOST)
        fit = [w for w in self.allowed if w <= survivors]
        nxt = max(fit) if fit else 0
        return nxt if nxt >= self.min_world else 0

    def run(self):
        world = self.world_size
        for attempt in range(self.max_restarts + 1):
            flight.record("train.elastic_launch", attempt=attempt,
                          world=world, registry=self._registry_view())
            procs = self.spawn(world, attempt)
            rcs = self._await(procs)
            self.attempts.append((world, rcs))
            if all(rc == 0 for rc in rcs):
                return 0
            nxt = self.decide_next_world(rcs)
            flight.record("train.elastic_failure", attempt=attempt,
                          world=world, rcs=[int(r) for r in rcs],
                          next_world=nxt)
            if nxt == 0 or attempt >= self.max_restarts:
                return 1
            metrics.counter("train.elastic_restarts").inc()
            world = nxt
        return 1


# --------------------------------------------------------------- drill CLI
#
# `python -m paddle_tpu_torch.train.elastic --root DIR --until-step N ...`
# (rank and world from the launch env) runs ONE rank of a self-contained
# tiny-GPT elastic worker — the drill entry the chaos tests share; the
# JAX flags plus ``--device`` (default ``cuda``). `spawn_local_fleet` is the matching controller-
# side spawner (fresh coordinator port per attempt, per-rank logs/env).


def _drill_batch_fn(batch, seq, vocab):
    """Deterministic GLOBAL batch stream, sharded by contiguous rows —
    the same global batch at any world size, so a reformed fleet
    re-shards the identical data stream."""
    def fn(cursor, rank, world):
        rng = np.random.RandomState(1000 + int(cursor))
        ids = rng.randint(0, vocab, (batch, seq + 1))
        shard = batch // world
        lo, hi = rank * shard, (rank + 1) * shard
        return (ids[lo:hi, :-1].astype(np.int32),
                ids[lo:hi, 1:].astype(np.int32))
    return fn


def _drill_main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        "paddle_tpu_torch.train.elastic",
        description="one rank of the elastic multi-host training drill "
                    "(tiny GPT; see docs/ROBUSTNESS.md 'Multi-host "
                    "training')")
    ap.add_argument("--root", required=True)
    ap.add_argument("--until-step", type=int, required=True)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--deadline-s", type=float, default=10.0)
    ap.add_argument("--registry-dir", default=None)
    ap.add_argument("--hb-dir", default=None,
                    help="heartbeat/tombstone dir — MUST be per-attempt "
                         "(a relaunched fleet must not read the previous "
                         "attempt's stale heartbeats or tombstones)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from paddle_tpu_torch import device as device_mod
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train.scan_step import ScanTrainStep

    def make_step(reducer):
        cfg = GPTConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                        num_layers=args.layers, num_heads=2,
                        intermediate_size=2 * args.hidden,
                        max_position_embeddings=args.seq,
                        hidden_dropout=0.0, attention_dropout=0.0)
        with device_mod.device_scope(args.device):
            model = GPTForCausalLM(
                cfg, generator=torch.Generator().manual_seed(args.seed))
        return ScanTrainStep(model, AdamW(learning_rate=1e-3),
                             microbatches=1, grad_reducer=reducer,
                             device=args.device)

    step_box = {}

    def make_and_box(reducer):
        step_box["step"] = make_step(reducer)
        return step_box["step"]

    try:
        out = run_elastic_worker(
            make_and_box, _drill_batch_fn(args.batch, args.seq, args.vocab),
            root=args.root, until_step=args.until_step, every=args.every,
            deadline_s=args.deadline_s, registry_dir=args.registry_dir,
            hb_dir=args.hb_dir,
            on_step=lambda n, loss, ok: print(f"STEP {n} {loss!r} t="
                                              f"{time.time():.3f}",
                                              flush=True))
    except PeerLost as e:
        _hard_exit_peer_lost(e)
    print(f"RESUMED {out['resumed_step']}", flush=True)
    s = step_box["step"]
    print(f"DONE {int(s.opt.global_step)} compiles={s.compile_count} "
          f"stopped={out['stopped']}", flush=True)
    return 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local_fleet(world, *, root, until_step, log_dir, every=2,
                      deadline_s=10.0, registry_dir=None, batch=4,
                      env_for_rank=None, attempt=0, extra_args=(),
                      device="cuda"):
    """Spawn ``world`` local drill ranks (the controller-side half of the
    CLI above): fresh coordinator port per call, per-rank
    ``rank<r>.a<attempt>.log`` files under ``log_dir``, launch-style env
    (``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``/``PADDLE_MASTER``).
    ``env_for_rank(rank) -> dict`` merges per-rank extras (e.g. arming
    ``PADDLE_FAULTS=train.peer_dead`` on the victim). Returns
    [subprocess.Popen, ...] — feed to :class:`ElasticController` via a
    closure over this function. ``device`` is each rank's ``--device``
    (the ranks of a ``cuda`` fleet share the card)."""
    import subprocess
    os.makedirs(log_dir, exist_ok=True)
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for rank in range(int(world)):
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_MASTER": f"127.0.0.1:{port}",
            "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
        })
        env.pop("PADDLE_FAULTS", None)
        if env_for_rank is not None:
            env.update(env_for_rank(rank) or {})
        cmd = [sys.executable, "-m", "paddle_tpu_torch.train.elastic",
               "--root", str(root), "--until-step", str(until_step),
               "--every", str(every), "--deadline-s", str(deadline_s),
               "--batch", str(batch), "--device", str(device),
               # per-ATTEMPT heartbeat dir: stale heartbeats/tombstones
               # from a previous attempt must not poison the new fleet
               "--hb-dir", os.path.join(str(root), f"hb-a{int(attempt)}"),
               *map(str, extra_args)]
        if registry_dir:
            cmd += ["--registry-dir", str(registry_dir)]
        log = open(os.path.join(log_dir, f"rank{rank}.a{attempt}.log"),
                   "ab")
        p = subprocess.Popen(cmd, env=env, stdout=log,
                             stderr=subprocess.STDOUT)
        p._ptpu_log = log              # closed by the caller's GC; handle
        #                                kept so the file outlives Popen
        procs.append(p)
    return procs


if __name__ == "__main__":
    raise SystemExit(_drill_main())
