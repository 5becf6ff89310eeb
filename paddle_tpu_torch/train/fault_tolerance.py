"""Preemption-safe fault-tolerant training (counterpart of
`paddle_tpu/train/fault_tolerance.py`: the same directories, markers,
counters, flight events and error texts, so a checkpoint either package's
manager publishes resumes in the other's).

On preemptible fleets the dominant training failure is not a bug — it is
the machine going away: SIGTERM with a grace window (pod eviction, spot
reclaim), SIGKILL with none, or a single non-finite step poisoning every
weight after it. `CheckpointManager` wraps a `ScanTrainStep` with the
three legs that survive all of them:

**Durable checkpoints.** Each checkpoint is a `save_sharded` directory
``<root>/step-<n>`` with per-shard content checksums (verified on load —
`distributed/checkpoint.py`), plus a ``COMPLETE`` marker and an atomic
``LATEST`` pointer written ONLY after every shard and index has landed: a
checkpoint is either complete or invisible, so a crash at any byte
boundary can never publish garbage. Retention keeps the newest
``keep`` complete checkpoints, never touching the one currently being
resumed from or written. Async saves block the step loop only for the
host snapshot (`async_save` copies device state synchronously, the write
overlaps the next steps); a failed background write surfaces on
the next `wait()`/`save()`, never vanishes in a daemon thread.

**Preemption + resume.** `maybe_save` checkpoints every ``every``
optimizer steps; `install_sigterm` turns SIGTERM into "finish the current
step, synchronous checkpoint, clean exit" (the training mirror of serve's
`install_sigterm_drain`); `restore` reloads params, ZeRO-1 dp-sharded
optimizer state, the optimizer step clock, the lr schedule's position,
the PRNG key chain, and the data cursor — bit-identically on a single
replica. (The port has no mesh yet: ZeRO-1 and the reshard on resume are
ROADMAP A6/A8.3. `hapi.Model.fit(checkpoint_manager=)` binds the manager
to its fused step and writes ``[epoch, batch]`` cursors, as the JAX
package's does.)

**Bad-step containment.** The step already skips the optimizer apply on
any non-finite loss/grad (`ScanTrainStep`);
`after_step` adds the ladder: count `train.bad_steps`, and after
``max_consecutive_bad`` in a row roll back to the last checkpoint and
raise a typed `TooManyBadSteps` instead of training on garbage.

Everything is counted (`train.checkpoint_seconds`, `train.checkpoints`,
`train.resumes`, `train.bad_steps`, `train.rollbacks` —
docs/OBSERVABILITY.md) and flight-recorded. Chaos coverage:
tests/test_torch_fault_tolerance.py drives the `ckpt.*`/`train.step_nan`
fault sites (`testing/faults.py`) beside the JAX manager.
"""
from __future__ import annotations

import os
import re
import shutil
import signal
import threading
import time

from paddle_tpu_torch.distributed.checkpoint import (CheckpointCorrupt,
                                                     CheckpointIncomplete,
                                                     async_save, load_sharded,
                                                     save_sharded)
from paddle_tpu_torch.distributed.liveness import PeerLost
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import flight
from paddle_tpu_torch.testing import faults

__all__ = ["CheckpointManager", "TooManyBadSteps", "CheckpointCorrupt",
           "CheckpointIncomplete", "PeerLost"]

# `step-<n>` plus optional rewrite generation `-r<k>`: re-saving at an
# unchanged step number (resume -> cursor-only advance -> finalize) writes
# a FRESH dir instead of degrading the live one, so the old checkpoint
# keeps its COMPLETE marker until the replacement is published
_DIR_RE = re.compile(r"^step-(\d{8})(?:-r\d+)?$")


class TooManyBadSteps(RuntimeError):
    """``max_consecutive_bad`` steps in a row produced non-finite
    loss/grads. The manager has already rolled the training state back to
    the last complete checkpoint (when one exists) — the raiser's job is
    to stop the loop loudly: whatever is producing NaNs (data corruption,
    an lr spike, broken hardware) will not fix itself by iterating."""


class CheckpointManager:
    """Drives preemption-safe checkpointing for one `ScanTrainStep`.

    root                : directory holding ``step-<n>`` checkpoints + LATEST
    step                : the ScanTrainStep (or `bind()` later)
    every               : checkpoint every N optimizer steps (0 = only
                          explicit `save()` calls)
    keep                : retention — newest N complete checkpoints survive
    max_consecutive_bad : bad-step ladder threshold (0 disables rollback)
    use_async           : background writes by default; `save(sync=True)`,
                          the SIGTERM path, and EVERY multihost save
                          force synchronous
    world               : (rank, size) — auto-detected from the launch
                          env. size > 1 turns on the fleet
                          publication protocol (key-partitioned shard
                          writes, pre-COMPLETE barrier, rank-0 publish;
                          docs/ROBUSTNESS.md "Multi-host training");
                          root must then be a SHARED filesystem
    barrier             : injectable rendezvous ``fn(tag)`` (tests);
                          None = the fleet store's KV barrier
    barrier_timeout_s   : barrier wait bound — past it the save raises
                          typed PeerLost and stays invisible
    """

    def __init__(self, root, step=None, *, every=0, keep=3,
                 max_consecutive_bad=3, use_async=True, world=None,
                 barrier=None, barrier_timeout_s=120.0):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._step = step
        self.every = int(every)
        self.keep = max(1, int(keep))
        self.max_consecutive_bad = int(max_consecutive_bad)
        self.use_async = bool(use_async)
        # multi-host publication (docs/ROBUSTNESS.md "Multi-host
        # training"): world=(rank, size) — auto-detected from the launch
        # env. Each rank writes its key-partition of the
        # state (distributed/checkpoint.py shard_owner); a pre-COMPLETE
        # barrier over the fleet store's KV orders every rank's
        # shards BEFORE rank 0 publishes COMPLETE -> LATEST, so "complete
        # or invisible" holds fleet-wide: a rank that dies mid-save stalls
        # the barrier, which resolves as typed PeerLost on every survivor
        # and the checkpoint stays invisible. The root must be a shared
        # filesystem (the same constraint as the registry's NodeRegistry).
        if world is None:
            from paddle_tpu_torch.distributed.parallel import (get_rank,
                                                               get_world_size)
            world = (get_rank(), get_world_size())
        self._rank, self._world_size = int(world[0]), int(world[1])
        self._barrier_fn = barrier          # injectable (tests); None = KV
        self.barrier_timeout_s = float(barrier_timeout_s)
        self._save_seq = 0                  # lockstep save counter (dir
        #                                     rendezvous key sequencing)
        self._kv_garbage = []               # superseded barrier tags / dir
        #                                     keys, cleaned after the NEXT
        #                                     save's first barrier
        self._lock = threading.Lock()   # LATEST/prune vs writer thread
        self._pending = None            # (thread, dir) of in-flight async
        self._stop = threading.Event()
        self._resumed_from = None       # never pruned while we depend on it
        self._last_saved = -1

    @property
    def multihost(self):
        return self._world_size > 1

    def bind(self, step):
        """Attach the ScanTrainStep to a manager constructed unbound."""
        self._step = step
        return self

    # ---------------------------------------------------- fleet rendezvous
    def _barrier(self, tag):
        """One fleet rendezvous (multihost only): every rank arrives or
        the wait resolves as typed PeerLost — a barrier that cannot
        complete means a peer died between its shard writes and
        publication, and the checkpoint must stay invisible. The
        ``ckpt.barrier_timeout`` chaos site forces exactly that outcome
        deterministically."""
        if faults.ENABLED and faults.fire("ckpt.barrier_timeout"):
            metrics.counter("train.peer_lost").inc()
            raise PeerLost(
                f"checkpoint barrier {tag!r} timed out (injected via "
                "ckpt.barrier_timeout) — a peer never arrived; the "
                "checkpoint stays unpublished")
        t0 = time.perf_counter()
        try:
            if self._barrier_fn is not None:
                self._barrier_fn(tag)
            else:
                from paddle_tpu_torch.distributed import liveness
                from paddle_tpu_torch.distributed.collective import _kv_client
                liveness.kv_barrier(
                    _kv_client(), tag, rank=self._rank,
                    world=self._world_size,
                    timeout_ms=int(self.barrier_timeout_s * 1e3))
        except PeerLost:
            raise
        except Exception as e:  # noqa: BLE001 — classify timeout as typed
            from paddle_tpu_torch.distributed.liveness import is_timeout
            if is_timeout(e):
                metrics.counter("train.peer_lost").inc()
                raise PeerLost(
                    f"checkpoint barrier {tag!r} timed out after "
                    f"{self.barrier_timeout_s}s — a peer never arrived "
                    f"({e})") from e
            raise
        metrics.histogram("train.barrier_seconds").observe(
            time.perf_counter() - t0)

    def _drain_kv_garbage(self):
        """Rank 0 deletes KV keys from the PREVIOUS save — provably
        unread once the current save's first barrier has completed (see
        liveness.kv_barrier's deferral contract)."""
        if self._rank != 0 or self._barrier_fn is not None:
            return
        with self._lock:
            garbage, self._kv_garbage = list(self._kv_garbage), []
        from paddle_tpu_torch.distributed import liveness
        from paddle_tpu_torch.distributed.collective import _kv_client
        client = _kv_client()
        for kind, val in garbage:
            if kind == "bar":
                liveness.kv_barrier_cleanup(client, val)
            else:
                liveness.clear_with_marker(client, val)

    # ------------------------------------------------------------ directory
    def _dir(self, n):
        return os.path.join(self.root, f"step-{n:08d}")

    @staticmethod
    def _step_of(name):
        m = _DIR_RE.match(os.path.basename(name.rstrip("/")))
        return int(m.group(1)) if m else None

    def _is_complete(self, path):
        return os.path.exists(os.path.join(path, "COMPLETE"))

    def complete_checkpoints(self):
        """Sorted [(step, path)] of COMPLETE checkpoints under root."""
        out = []
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return out
        for name in names:
            n = self._step_of(name)
            p = os.path.join(self.root, name)
            if n is not None and self._is_complete(p):
                out.append((n, p))
        return sorted(out)

    def latest(self):
        """(step, path) of the checkpoint LATEST points to, or None. A
        LATEST naming a non-complete dir (a crash mid-rewrite) falls back
        to the newest complete checkpoint instead of failing the resume."""
        lat = os.path.join(self.root, "LATEST")
        try:
            with open(lat) as f:
                name = f.read().strip()
        except FileNotFoundError:
            name = None
        if name:
            p = os.path.join(self.root, name)
            n = self._step_of(name)
            if n is not None and self._is_complete(p):
                return n, p
        done = self.complete_checkpoints()
        return done[-1] if done else None

    # ----------------------------------------------------------------- save
    def _state(self, data_cursor):
        import json as _json
        from paddle_tpu_torch.optimizer.lr import LRScheduler
        s = self._step
        if s is None:
            raise RuntimeError("CheckpointManager has no ScanTrainStep — "
                               "construct with step= or call bind()")
        meta = {"global_step": int(s.opt.global_step),
                "microbatches": int(s.microbatches),
                "rng": s.key_data()}
        if isinstance(s.opt.learning_rate, LRScheduler):
            # the schedule position is training state too: resuming a
            # warmup/decay schedule from epoch 0 would be a silently
            # wrong lr for the rest of the run
            meta["lr_sched"] = _json.dumps(
                s.opt.learning_rate.state_dict())
        if data_cursor is not None:
            meta["data_cursor"] = data_cursor
        params, opt_state = s.state_trees()
        return {"params": params, "opt": opt_state, "meta": meta}

    def _publish(self, path):
        """COMPLETE marker + atomic LATEST move-forward + retention — the
        single-writer half of publication (rank 0 in a fleet)."""
        with open(os.path.join(path, "COMPLETE"), "w") as f:
            f.write("ok\n")
        n = self._step_of(path)
        with self._lock:
            cur = self.latest()
            if cur is None or n >= cur[0]:
                tmp = os.path.join(self.root, "LATEST.tmp")
                with open(tmp, "w") as f:
                    f.write(os.path.basename(path) + "\n")
                os.replace(tmp, os.path.join(self.root, "LATEST"))
            self._prune(protect=path)

    def _finalize(self, path):
        """Publish a fully-written checkpoint: COMPLETE marker, atomic
        LATEST move-forward, retention. Runs on the WRITER thread for
        async saves — everything here happens after the last shard byte
        landed, which is the whole crash-consistency protocol.

        Multihost: a pre-COMPLETE barrier orders EVERY rank's shards
        before rank 0 publishes, and a post-publication barrier keeps any
        rank from racing ahead of the visible LATEST — either barrier
        failing (a dead peer, ``ckpt.barrier_timeout``) raises typed
        PeerLost with the checkpoint still invisible."""
        base = os.path.basename(path)
        if self.multihost:
            self._barrier(f"{base}/shards")
            # every rank is past the previous save's barriers now — its
            # KV keys are provably unread and safe to delete
            self._drain_kv_garbage()
            if self._rank == 0:
                self._publish(path)
            self._barrier(f"{base}/pub")
            if self._rank == 0:
                # only rank 0 drains the list — other ranks appending
                # would just grow dead weight forever
                with self._lock:
                    self._kv_garbage += [("bar", f"{base}/shards"),
                                         ("bar", f"{base}/pub")]
        else:
            self._publish(path)
        n = self._step_of(path)
        metrics.counter("train.checkpoints").inc()
        flight.record("train.checkpoint_complete", step=n, path=base,
                      rank=self._rank)

    def _prune(self, protect=None):
        """Keep the newest ``keep`` COMPLETE checkpoints. Never removes the
        LATEST target, the checkpoint being resumed from, the one just
        written, or an in-flight async target. Incomplete dirs older than
        the newest complete checkpoint are crash leftovers — invisible by
        protocol — and are swept too. Caller holds the lock."""
        done = self.complete_checkpoints()
        keepers = {p for _, p in done[-self.keep:]}
        lat = self.latest()
        if lat is not None:
            keepers.add(lat[1])
        for p in (protect, self._resumed_from,
                  self._pending[1] if self._pending else None):
            if p:
                keepers.add(p)
        newest_done = done[-1][0] if done else -1
        for name in os.listdir(self.root):
            n = self._step_of(name)
            if n is None:
                continue
            p = os.path.join(self.root, name)
            if p in keepers:
                continue
            if self._is_complete(p) or n < newest_done:
                shutil.rmtree(p, ignore_errors=True)

    def _choose_dir(self, n):
        """The save target for step ``n`` — `step-<n>` or a fresh
        ``-r<k>`` rewrite generation when the dir already exists. In a
        fleet the choice must be AGREED (two ranks scanning a shared dir
        mid-save would split the checkpoint across generations), so rank
        0 decides and publishes the basename under a sequenced KV key —
        the save counter advances in lockstep on every rank."""
        d = self._dir(n)

        def _occupied(p):
            if not self.multihost:
                return os.path.isdir(p)
            # fleet rule: a dir only counts as a PRIOR save once it wears
            # COMPLETE or the deciding rank's own index — another rank's
            # in-flight partial (it chose this name for the SAME save)
            # must not push the decider onto a fresh generation
            return os.path.exists(os.path.join(p, "COMPLETE")) \
                or os.path.exists(os.path.join(p, "index.p0.json"))

        def _scan():
            out = d
            if _occupied(out):
                k = 1
                while _occupied(f"{out}-r{k}"):
                    k += 1
                out = f"{out}-r{k}"
            return out

        if not self.multihost or self._barrier_fn is not None:
            # single host, or an injected-barrier harness (one process
            # emulating ranks): the local scan is already deterministic
            return _scan()
        from paddle_tpu_torch.distributed import liveness
        from paddle_tpu_torch.distributed.collective import _kv_client
        client = _kv_client()
        key = f"ptpu_ckpt_dir/{self._save_seq}"
        if self._rank == 0:
            d = _scan()
            if os.path.isdir(d):
                # exists but wears neither COMPLETE nor a rank-0 index: a
                # crash leftover, invisible by protocol — wipe it BEFORE
                # publishing the name, or its stale partial indexes
                # (possibly from a LARGER world) would merge into the
                # checkpoint this save is about to publish and overwrite
                # fresh shards with old-trajectory values. Safe exactly
                # because no rank writes before the rendezvous resolves.
                shutil.rmtree(d, ignore_errors=True)
            liveness.set_with_marker(client, key,
                                     os.path.basename(d).encode())
        else:
            raw = liveness.guarded_get_bytes(
                client, key, int(self.barrier_timeout_s * 1e3),
                what=f"checkpoint dir rendezvous {self._save_seq}")
            d = os.path.join(self.root, bytes(raw).decode())
        if self._rank == 0:             # rank 0 owns the KV cleanup
            with self._lock:
                self._kv_garbage.append(("key", key))
        return d

    def save(self, *, data_cursor=None, sync=None):
        """Write a checkpoint of the bound step's CURRENT state. Joins any
        outstanding async write first (propagating its failure). Async
        saves return after the host snapshot — `train.checkpoint_seconds`
        observes exactly that blocking stall. NEVER degrades an existing
        dir: a re-save at an unchanged step writes a fresh ``-r<k>``
        generation beside it; LATEST re-points only once the new one is
        COMPLETE, so a crash mid-rewrite leaves the old checkpoint fully
        durable. In a fleet every rank must call save at the same step
        (the training loop is lockstep by construction)."""
        self.wait()
        n = int(self._step.opt.global_step)
        self._save_seq += 1
        d = self._choose_dir(n)
        part = (self._rank, self._world_size) if self.multihost else None
        use_async = self.use_async if sync is None else not sync
        if self.multihost:
            # fleet saves are SYNCHRONOUS: the publication barrier is a
            # rendezvous every rank must reach at the same save, and a
            # writer thread's barrier would race the step loop's own KV
            # collectives on the one store client — the whole fleet pauses
            # at the boundary together, so there is nothing to overlap
            use_async = False
        t0 = time.perf_counter()
        state = self._state(data_cursor)
        if use_async:
            th = async_save(state, d, on_complete=self._finalize,
                            partition=part)
            self._pending = (th, d)
        else:
            save_sharded(state, d, partition=part)
            self._finalize(d)
        stall = time.perf_counter() - t0
        metrics.histogram("train.checkpoint_seconds").observe(stall)
        flight.record("train.checkpoint", step=n, sync=not use_async,
                      stall_ms=round(stall * 1e3, 3))
        self._last_saved = n
        return d

    def wait(self):
        """Join the outstanding async write, re-raising its error — the
        propagation contract for failed background saves."""
        p, self._pending = self._pending, None
        if p is not None:
            p[0].join()

    def maybe_save(self, data_cursor=None):
        """Periodic trigger: save once ``every`` optimizer steps have
        passed since the last save/restore. No-op when every=0."""
        if self.every <= 0 or self._step is None:
            return None
        n = int(self._step.opt.global_step)
        if n > 0 and n - max(self._last_saved, 0) >= self.every:
            return self.save(data_cursor=data_cursor)
        return None

    # -------------------------------------------------------------- restore
    def restore(self, *, require=False):
        """Load the LATEST complete checkpoint into the bound step: params,
        optimizer state (on the step's device), step clock, lr scheduler
        position, PRNG chain; then `sync_to_model` so eval/decode/state_dict
        consumers agree with the training state. A checkpoint that fails
        content verification (`CheckpointCorrupt` — bit rot, torn write)
        is SKIPPED and the next-newest complete checkpoint tried: keep-N
        retention exists exactly so one rotten file cannot brick the
        resume. Returns {step, data_cursor, path} or None when nothing is
        there (``require=True`` raises CheckpointIncomplete — the
        rollback path must fail loudly, not restart from init)."""
        self.wait()
        lat = self.latest()
        if lat is None:
            if require:
                raise CheckpointIncomplete(
                    f"no complete checkpoint (LATEST) under {self.root!r} "
                    "to resume from")
            return None
        candidates = [lat] + [c for c in reversed(self.complete_checkpoints())
                              if c[1] != lat[1]]
        first_err = None
        for n, d in candidates:
            try:
                return self._restore_one(n, d)
            except (CheckpointCorrupt, CheckpointIncomplete) as e:
                # bit rot OR a structurally broken dir that still wears a
                # COMPLETE marker (e.g. a prune interrupted mid-rmtree):
                # skip it and try the next-newest — a config mismatch
                # (missing/extra leaves) also walks the list and surfaces
                # as the newest checkpoint's error below
                first_err = first_err if first_err is not None else e
                metrics.counter("train.resume_corrupt_skipped").inc()
                flight.record("train.resume_skipped_corrupt", step=n,
                              error=str(e)[:200])
        raise first_err

    def _restore_one(self, n, d):
        s = self._step
        t0 = time.perf_counter()
        template = {"params": s._params, "opt": s._opt_state}
        loaded = load_sharded(d, template=template)
        # BOTH directions must refuse a mismatched checkpoint: leaves the
        # bound step needs but the checkpoint lacks would silently keep
        # their fresh random init (half-restored model, no error), and
        # extra checkpoint leaves would silently insert into the pytree
        # and make the next step retrace/crash untyped
        from paddle_tpu_torch.distributed.checkpoint import _flatten
        expected = set(_flatten(template))
        got = {k for k in loaded if k.startswith(("params/", "opt/"))}
        missing = sorted(expected - got)
        missing += [k for k in ("meta/global_step", "meta/rng")
                    if k not in loaded]
        if missing:
            raise CheckpointIncomplete(
                f"checkpoint {d!r} lacks {len(missing)} leaves the bound "
                f"step needs (different model/optimizer config?): "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
        extra = sorted(got - expected)
        if extra:
            raise CheckpointCorrupt(
                f"checkpoint {d!r} carries {len(extra)} leaves the bound "
                f"step has no slot for (different model/optimizer?): "
                f"{extra[:5]}{'...' if len(extra) > 5 else ''}")
        for key, arr in loaded.items():
            parts = key.split("/")
            if parts[0] == "params":
                s._params[parts[1]][parts[2]] = \
                    arr.detach().requires_grad_(True)
            elif parts[0] == "opt":
                s._opt_state[parts[1]][parts[2]][parts[3]] = arr
        s.opt.global_step = int(loaded["meta/global_step"])
        from paddle_tpu_torch.optimizer.lr import LRScheduler
        if isinstance(s.opt.learning_rate, LRScheduler):
            import json as _json
            if "meta/lr_sched" not in loaded:
                raise CheckpointIncomplete(
                    f"checkpoint {d!r} has no lr-scheduler state but the "
                    "bound optimizer drives one — resuming would restart "
                    "the schedule from epoch 0")
            s.opt.learning_rate.set_state_dict(
                _json.loads(loaded["meta/lr_sched"]))
        s.opt._sync_lr_tensor(s.opt.get_lr())
        s.set_key_data(loaded["meta/rng"])
        s.consecutive_bad_steps = 0
        s.last_step_ok = True
        s._dirty = True
        s.sync_to_model()
        self._resumed_from = d
        self._last_saved = n
        dt = time.perf_counter() - t0
        metrics.counter("train.resumes").inc()
        flight.record("train.resume", step=n, ms=round(dt * 1e3, 3),
                      path=os.path.basename(d))
        return {"step": n, "path": d,
                "data_cursor": loaded.get("meta/data_cursor")}

    def rollback(self):
        """Bad-step ladder tail: restore the last complete checkpoint
        (counted as `train.rollbacks`); raises CheckpointIncomplete when
        there is none."""
        metrics.counter("train.rollbacks").inc()
        flight.record("train.rollback",
                      at_step=int(self._step.opt.global_step))
        return self.restore(require=True)

    def after_step(self, data_cursor=None):
        """Call once after every `step()`: runs the bad-step ladder, then
        the periodic save. After ``max_consecutive_bad`` non-finite steps
        in a row, rolls back to the last checkpoint and raises
        `TooManyBadSteps` (state is already restored when it raises)."""
        s = self._step
        if 0 < self.max_consecutive_bad <= s.consecutive_bad_steps:
            bad = s.consecutive_bad_steps
            try:
                info = self.rollback()
            except CheckpointIncomplete as e:
                raise TooManyBadSteps(
                    f"{bad} consecutive non-finite steps and no checkpoint "
                    f"to roll back to: {e}") from e
            raise TooManyBadSteps(
                f"{bad} consecutive non-finite steps — rolled back to "
                f"step {info['step']} ({info['path']})")
        if s.last_step_ok:
            self.maybe_save(data_cursor=data_cursor)

    # ------------------------------------------------------------- SIGTERM
    def install_sigterm(self):
        """SIGTERM -> finish the current step, synchronous final
        checkpoint, clean exit (the training mirror of serve's
        `install_sigterm_drain`). The handler only sets a flag — the LOOP
        observes `should_stop` at the next step boundary, so the signal
        can never corrupt a half-applied update. Returns the handler."""
        def _handler(signum, frame):   # noqa: ARG001 — signal signature
            self._stop.set()
            flight.record("train.sigterm")
        signal.signal(signal.SIGTERM, _handler)
        return _handler

    @property
    def should_stop(self):
        return self._stop.is_set()

    def request_stop(self):
        """Programmatic preemption (tests, embedding loops)."""
        self._stop.set()

    # -------------------------------------------------------- managed loop
    def run(self, batch_fn, *, until_step, resume=True, data_cursor=0,
            max_batches=None, on_step=None, install_sigterm=False):
        """Preemption-safe training loop around the bound step.

        ``batch_fn(cursor)`` -> (x, y) or (x, y, loss_mask) for data
        cursor ``cursor`` — the cursor advances on EVERY consumed batch
        (bad steps included: a batch that produced NaNs is not retried),
        while the optimizer clock advances only on applied steps. Resumes
        from LATEST first (unless ``resume=False``; then ``data_cursor``
        seeds the cursor), stops cleanly at ``until_step`` or on SIGTERM,
        and always leaves a final synchronous checkpoint behind.
        ``max_batches`` bounds TOTAL batches consumed this invocation —
        the termination backstop when rollback is disabled
        (``max_consecutive_bad=0``) and persistent NaNs keep the step
        clock from ever reaching ``until_step``. Returns the list of
        per-step losses from THIS invocation. TooManyBadSteps propagates
        (state already rolled back)."""
        if install_sigterm:
            self.install_sigterm()
        cursor = int(data_cursor)
        if resume:
            info = self.restore()
            if info is not None and info.get("data_cursor") is not None:
                cur = info["data_cursor"]
                if isinstance(cur, (list, tuple)):
                    # Model.fit (hapi/model.py, either package's) writes
                    # [epoch, batch] — run() cannot map it onto
                    # batch_fn's flat index space
                    raise ValueError(
                        f"checkpoint at {info['path']} has data_cursor="
                        f"{cur!r}; CheckpointManager.run needs the flat "
                        "integer cursor it writes — resume fit-written "
                        "checkpoints with Model.fit(checkpoint_manager=)")
                cursor = int(cur)
        s = self._step
        losses, consumed = [], 0
        while s.opt.global_step < until_step and not self.should_stop:
            if max_batches is not None and consumed >= max_batches:
                flight.record("train.run_batch_budget", consumed=consumed)
                break
            batch = batch_fn(cursor)
            cursor += 1
            consumed += 1
            loss = s.step(*batch)
            losses.append(loss)
            if on_step is not None:
                on_step(int(s.opt.global_step), loss, s.last_step_ok)
            self.after_step(data_cursor=cursor)
        self.finalize(data_cursor=cursor)
        return losses

    def _saved_cursor(self, path):
        """The data cursor recorded in a checkpoint's index (literal-only
        read, no shard IO), or None when unreadable/absent."""
        from paddle_tpu_torch.distributed.checkpoint import read_literal
        return read_literal(path, "meta/data_cursor")

    def finalize(self, data_cursor=None):
        """Drain + final synchronous checkpoint. Skipped only when LATEST
        already captures BOTH the current optimizer step and the current
        data cursor — bad steps advance the cursor without advancing the
        step clock, and losing that advance would re-feed the same
        NaN-producing batches on every resume."""
        self.wait()
        lat = self.latest()
        if lat is None or lat[0] != int(self._step.opt.global_step) or (
                data_cursor is not None
                and self._saved_cursor(lat[1]) != data_cursor):
            self.save(data_cursor=data_cursor, sync=True)
