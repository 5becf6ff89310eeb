"""Deterministic fault injection for the port's serving and training
stacks (a copy of
`paddle_tpu/testing/faults.py`, kept identical in behaviour; the port
imports nothing from the JAX package).

Failure handling that is only exercised by hand-written kill tests rots:
the paths that matter (a slow step, the page pool running dry, a tier
spill or re-upload failing) fire rarely and never deterministically. This
module gives the engine NAMED injection sites that tests and drills arm
on demand:

    from paddle_tpu_torch.testing import faults
    with faults.scoped("engine.step_delay", delay_s=0.2, times=3):
        ...   # the next 3 engine steps each stall 200 ms

or through the environment for out-of-process drills
(``PADDLE_FAULTS="engine.step_delay:delay_s=0.2:times=3,engine.crash"``,
read when this module is first imported).

Design rules, the JAX package's:

- **Zero overhead when off.** Every call site guards on the module-level
  ``ENABLED`` flag (``faults.ENABLED and faults.fire(site)``), so an
  unarmed engine pays one attribute read and a falsy branch: no dict
  lookup, no lock.
- **Deterministic.** A site fires exactly ``times`` times (-1 =
  unlimited) in arming order; no randomness, no clocks. Tests assert on
  exact fire counts (`fired(site)`).
- **Typed actions.** A site can sleep (``delay_s``), raise (``exc``, a
  class, instantiated with a message naming the site), or simply report
  that it fired (the caller implements the fault, e.g. "return None from
  alloc"). `FaultInjected` is the default exception of crash sites so
  post-mortems tell injected failures from organic ones.

Sites wired in the port (the JAX package's names and places):

========================  ====================================================
``engine.step_delay``     `DecodeEngine.step` sleeps ``delay_s`` at its top
                          (a slow device or a long step; deadline tests)
``serve.slow_read``       serve's client loop stalls ``delay_s`` before
                          reading a request body (a slow client)
``serve.socket_drop``     serve's client loop drops the connection before
                          answering (a network partition mid-request)
``serve.ack_drop``        a GENERATE ran to the end and its answer is not
                          sent: the connection drops (the ambiguous window
                          a keyed resubmit replays from the dedup table)
``serve.migrate_drop``    a drain's ship of one item to one peer fails (a
                          peer dying mid-migration; the next peer takes it)
``serve.blob_corrupt``    a drain flips one byte of a ``PTMG1`` blob before
                          its first ship: the peer refuses it typed and the
                          sender re-packs the item and ships it once more
``serve.stream_drop``     serve's OP_PREFILL record loop drops the
                          connection mid-stream (a prefill worker's death;
                          the decode side discards the partial pages)
``router.crash``          `Router._client_loop` stops the router hard as it
                          accepts a GENERATE: the listener and every live
                          client connection close and the request is never
                          forwarded (clients fail over to another router)
``router.stale_directory``  the router's prefill pick routes on a stale
                          prefix-directory entry (the last prefill worker,
                          ``router.stale_affinity``): the worker prefills
                          the whole prompt, the answer is unchanged
``engine.crash``          `DecodeEngine.step` raises (engine-thread death)
``engine.pool_pressure``  `PageAllocator.alloc` reports exhaustion (forced
                          page-pool pressure without a giant workload)
``kvtier.spill_fail``     the prefix-page spill to the host/disk tier fails
                          (`DecodeEngine._spill_pages`): the eviction
                          degrades to a plain discard, counted in
                          ``kvtier_spill_fail``; the pool reclaim never fails
``kvtier.disk_corrupt``   the disk tier's read treats the entry as rotten
                          (`kv_tiers.KVTierStore.get`): a typed refusal
                          counted in ``kvtier_refusals``, reported upward as
                          a plain miss (the request prefills cold)
``kvtier.reupload_fail``  the batched tier re-upload into fresh pool pages
                          fails (`DecodeEngine._tier_reupload`): the request
                          keeps its fresh pages and prefills the whole
                          prompt (``kvtier_reupload_fail``)
``train.step_nan``        `ScanTrainStep.step` adds NaN to the loss before
                          the finite check (in split mode before the
                          reduce): the bad-step skip path runs
``ckpt.write_truncate``   `save_sharded` truncates the shard file it just
                          wrote (torn-write simulation; load must refuse by
                          checksum with `CheckpointCorrupt`)
``ckpt.crash_between_shards``  `save_sharded` dies between shard files (the
                          checkpoint must stay INVISIBLE: no index, no
                          COMPLETE, LATEST untouched)
``ckpt.barrier_timeout``  the multi-host checkpoint publication barrier
                          times out (a peer died between its shard writes
                          and COMPLETE): every survivor raises typed
                          `PeerLost`, the checkpoint stays invisible
                          fleet-wide (`train/fault_tolerance.py`)
``train.peer_dead``       the armed elastic-training rank SIGKILLs itself
                          at the ``times``-th step boundary (deterministic
                          spot reclaim; survivors must detect via
                          heartbeats — `train/elastic.py`)
``train.collective_stall``  a rank stalls ``delay_s`` INSIDE the KV
                          allgather before publishing its contribution
                          (wedged-peer simulation: its heartbeat goes
                          stale and survivors raise typed `PeerLost`)
``loader.stall``          `DataLoader`'s worker fetch behaves as if the
                          stall window elapsed: first fire re-enqueues the
                          in-flight batches (one bounded retry); a second
                          fire WITHOUT a delivery in between raises typed
                          `DataLoaderStalled` (any delivery re-arms the
                          retry — "twice" means twice in a row)
========================  ====================================================
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

__all__ = ["ENABLED", "FaultInjected", "arm", "disarm", "fire", "fired",
           "remaining", "scoped", "arm_from_env"]

# fast-path flag: call sites guard on this BEFORE calling fire(), so a
# production process with no faults armed never takes the lock below
ENABLED = False

_lock = threading.Lock()
_armed: dict[str, "_Fault"] = {}
_fired: dict[str, int] = {}


class FaultInjected(RuntimeError):
    """Raised by crash-style fault sites — distinguishable from organic
    failures in logs, watchdog dumps, and chaos-test assertions."""


class _Fault:
    __slots__ = ("times", "delay_s", "exc")

    def __init__(self, times: int, delay_s: float, exc):
        self.times = times          # remaining fires; -1 = unlimited
        self.delay_s = delay_s
        self.exc = exc              # exception CLASS to raise, or None


def arm(site: str, times: int = 1, delay_s: float = 0.0, exc=None):
    """Arm ``site`` to fire ``times`` times (−1 = until disarmed). Each
    fire sleeps ``delay_s`` then raises ``exc(...)`` if given, else
    returns True to the call site."""
    global ENABLED
    if exc is not None and not (isinstance(exc, type)
                                and issubclass(exc, BaseException)):
        raise TypeError(f"exc must be an exception class, got {exc!r}")
    with _lock:
        _armed[site] = _Fault(int(times), float(delay_s), exc)
        _fired.setdefault(site, 0)
        ENABLED = True


def disarm(site: str | None = None):
    """Disarm one site (or all of them) and drop the fast-path flag when
    nothing stays armed. Lifetime fire counts are kept — `fired` reports
    them so tests can delta around a scope."""
    global ENABLED
    with _lock:
        if site is None:
            _armed.clear()
        else:
            _armed.pop(site, None)
        ENABLED = bool(_armed)


def fire(site: str) -> bool:
    """Hot-path check: did ``site`` fire? Only call behind an ``ENABLED``
    guard. Applies the armed delay, raises the armed exception, or
    returns True; returns False when the site is not armed (or spent)."""
    with _lock:
        f = _armed.get(site)
        if f is None or f.times == 0:
            return False
        if f.times > 0:
            f.times -= 1
        _fired[site] = _fired.get(site, 0) + 1
        delay_s, exc = f.delay_s, f.exc
    if delay_s > 0:
        time.sleep(delay_s)
    if exc is not None:
        raise exc(f"fault injected at {site}")
    return True


def fired(site: str) -> int:
    """Lifetime fire count for ``site`` (0 if it never fired)."""
    with _lock:
        return _fired.get(site, 0)


def remaining(site: str):
    """Charges left on an ARMED site (−1 = unlimited), or None when the
    site is not armed. Lets a call site act on the LAST charge — e.g.
    ``train.peer_dead:times=k`` kills its rank at the k-th step boundary
    (`train/elastic.py`), not the first."""
    with _lock:
        f = _armed.get(site)
        return None if f is None else f.times


@contextmanager
def scoped(site: str, times: int = 1, delay_s: float = 0.0, exc=None):
    """Arm ``site`` for the body, disarm on exit — the chaos-test idiom
    (a failing assertion must never leave a fault armed for the next
    test)."""
    arm(site, times=times, delay_s=delay_s, exc=exc)
    try:
        yield
    finally:
        disarm(site)


def arm_from_env(spec: str | None = None):
    """Parse ``PADDLE_FAULTS`` (or an explicit spec): comma-separated
    sites, each ``site[:key=val[:key=val...]]`` with keys ``times``,
    ``delay_s``, ``exc`` (a builtin exception name, or ``FaultInjected``).
    Example: ``engine.step_delay:delay_s=0.2:times=3,engine.crash:exc=\
FaultInjected``. Unknown keys raise — a typo'd drill must fail loudly,
    not silently inject nothing."""
    spec = os.environ.get("PADDLE_FAULTS", "") if spec is None else spec
    for entry in filter(None, (s.strip() for s in spec.split(","))):
        parts = entry.split(":")
        site, kw = parts[0], {}
        for p in parts[1:]:
            k, _, v = p.partition("=")
            if k == "times":
                kw["times"] = int(v)
            elif k == "delay_s":
                kw["delay_s"] = float(v)
            elif k == "exc":
                exc = {"FaultInjected": FaultInjected}.get(v) \
                    or getattr(__import__("builtins"), v, None)
                if not (isinstance(exc, type)
                        and issubclass(exc, BaseException)):
                    raise ValueError(f"PADDLE_FAULTS: unknown exception "
                                     f"{v!r} for site {site!r}")
                kw["exc"] = exc
            else:
                raise ValueError(
                    f"PADDLE_FAULTS: unknown key {k!r} in {entry!r} "
                    f"(have times/delay_s/exc)")
        arm(site, **kw)


if os.environ.get("PADDLE_FAULTS"):
    arm_from_env()
