"""Batched decode engine: paged KV cache + bucketed or chunked prefill +
continuous batching (counterpart of `paddle_tpu/inference/engine.py`,
reduced to the serving slice of the port).

- **Paged KV cache**: one fixed pool of token pages
  (`kernels/paged_attention.py`) shared by all slots; the host-side
  refcounted allocator hands pages to a sequence at admission and takes
  them back at retirement.
- **Fixed-shape decode step**: every step runs `models.gpt.decode_step` on
  all ``max_slots`` slots, active or not. Slot churn changes only the
  contents of the page table and the active mask.
- **Bucketed prefill**: a prompt is padded to the next power-of-two bucket
  and prefilled in one `prefill_step`.
- **Decode-priority chunked prefill** (``EngineConfig.prefill_chunk_tokens``):
  a longer prompt is split into fixed-size chunks, ONE chunk per step,
  run AFTER the decode step, so running requests keep their token cadence.
- **One upload per step**: the per-slot host mirrors (token, length, flags,
  page-table row) go to the device in ONE packed int32 copy per step
  (``counters["h2d_transfers"]``); sampled tokens chain step to step on the
  device.
- **Quantized serving** (``EngineConfig.kv_dtype="int8"``,
  ``weight_dtype="int8"``): int8 KV pages with per-token-slot f32 scale
  pools, and weight-only int8 matmul leaves dequantized at use.
- **Fused sampling** (``EngineConfig.sampling``): per-request temperature,
  top-k and seed (``submit(..., temperature=, top_k=, seed=)``). Each
  slot's threefry key chain lives on the device in one ``[B+1, 2]`` buffer
  (the JAX layout: row B is its slotless prefills' scratch row), the
  per-slot parameters ride the step's one packed upload, and the sampler
  runs on the logits where they lie (`kernels/sampling.py`): sampled
  decode reads back tokens only, and a
  request's tokens equal the JAX package's `fast_generate` with the same
  (temperature, top_k, seed). Greedy requests on such an engine take the
  argmax and never move their chain.
- **Prefix cache** (``EngineConfig.prefix_cache``, on by default): full
  prompt pages are shared copy-on-write across requests. A submit whose
  leading pages hash-match an earlier prompt's (the rolling page-chain
  hashes of `serving/disagg.py`) attaches them by page-table reference and
  prefills only the uncached tail, through the chunk step at the tail's
  own bucket; refcount-0 cached pages stay resident and are LRU-evicted
  under pool pressure. Per request opt-out: ``submit(..., cache=False)``.
- **KV tiers** (``kv_host_tier_bytes``, ``kv_disk_tier_bytes``): an
  evicted prefix page demotes to host RAM, then disk
  (`inference/kv_tiers.py`), and a later chained miss past HBM re-uploads
  it (one batched scatter a pool) before the tail prefill.
- **Speculative decode** (``EngineConfig.speculate_k``): an n-gram
  drafter over each slot's own tokens (`_DraftIndex`) proposes up to k
  tokens, ONE verify step (`models/gpt.py::verify_step`) scores all k+1
  positions and accepts the longest matching prefix plus one corrected
  token, greedy or sampled, token for token what plain decode gives. The
  host rolls lengths back by not advancing them; one readback per verify
  step carries the emitted tokens and their count.
- **Step programs** (``DecodeEngine._compiled``, the JAX engine's program
  cache): one entry per key, ``("decode", impl)`` or ``("verify", K)``,
  ``("prefill", bucket, impl)``, ``("prefill_chunk", c, impl)``, counted
  as ``cache_hit`` / ``cache_miss`` / ``compile_count``. On the card every
  entry is a CUDA graph (`inference/graphs.py`), captured at `warmup` or
  first use and replayed at every use after; their inputs and
  outputs are buffers that keep their identity (the packed state, each
  prefill entry's packed upload and token buffer, the pools, the weights,
  the token, key and verify-output buffers), so `refresh_params` copies
  new weights in place and never recaptures. A prefill or chunk upload is
  the JAX engine's packed layout (``ids | length | row`` and ``ids |
  start | valid | row``, a sampling engine's with its sample tail) and the
  program picks the first token itself, so its one readback is that
  token. On the CPU an entry runs its step eagerly.

- **Deferred readback** (``EngineConfig.inflight``, default 2, the JAX
  engine's): up to ``inflight`` decode steps stay in flight before the
  host blocks on the oldest one's tokens (`_harvest_one`), so the host's
  admission and retirement work for step N+1 overlaps the card's step N.
  Each decode step's tokens are copied out of the one device buffer the
  graph writes (``_tok_dev``) into that step's slot of a pinned token
  ring right after its replay; each step's packed state is written into
  a ring of pinned host buffers, and every ring slot is guarded by a
  CUDA event (`_packed_state`, `_upload_state`). EOS is seen up to
  ``inflight`` steps late; the surplus tokens are discarded at harvest.
  A speculating engine reads each verify step back at once (its next
  drafts need the tokens), as the JAX engine does.
- **Request lifecycle**: admission control (``max_queue_depth``,
  ``max_queue_tokens``: a typed ``Overloaded`` refusal), per-request
  deadlines (``submit(deadline_s=)``: ``DeadlineExceeded``), cancellation
  (`cancel`: ``Cancelled``), idempotent resubmits (``submit(request_key=)``,
  an LRU dedup table of ``dedup_capacity`` keys), `drain` and `abort`,
  and the pressure ladder (`_apply_degradation`: level 1 stops drafting,
  level 2 returns idle prefix pages to the pool, demoting them to the KV
  tiers first). Cancellations and deadlines act between fixed-shape
  steps (`_reap`), so they never change a step program. The JAX fault
  sites fire here too (`testing/faults.py`).

One stream: every step, prefill, tier re-upload (`import_pages`) and
spill (`export_pages`, then a copy to the host) runs on the caller's
current stream; `kv_tiers.py` moves host bytes only and the port starts no
side stream outside graph capture (`inference/graphs.py`). Stream order is
what makes the window safe: a retired slot's pages may be handed to a new
request while a later step that still names them is queued, since that
step runs before anything the new request enqueues.

- **Observability** (`observability/`, the JAX package's names): every
  count goes both to ``DecodeEngine.counters`` (the names without
  ``engine.``) and, through one helper (`_count`), to the port's metrics
  registry as ``engine.*``; the registry also holds the JAX engine's gauges
  (set at events, where ``DecodeEngine.gauges`` reads three of them
  live), its histograms (queue wait, prefill, step, host and device ms a
  step, graph captures, tier spills and re-uploads) and its
  ``engine.dispatch`` / ``engine.step`` / ``engine.compile:{kind}`` spans.
  Each request carries a `RequestTrace` (``submit(trace=)`` or a fresh
  one: the ``request.*`` spans and the ``serve.*`` SLO histograms) and
  emits one usage record when it ends (`observability/usage.py`); the
  lifecycle's events land on the flight recorder's ring. ``engine.device_ms``
  is the JAX meaning, the time the host blocked on a readback (a harvest's
  event wait, a prefill's first token, a verify step's tokens): the
  metering adds no synchronization and no event. `serve_loop` drives the
  engine on a thread of its own under a stall watchdog
  (`start_watchdog`).

- **KV handoff and live migration**: `prefill_export` runs a prefill into
  borrowed pages and returns it as a detached `KVHandoff` (the ``PTKV1``
  blob of `inference/handoff.py`, an int8 pool's scales with its pages);
  `import_request` (at once) or `submit_import` (through the import
  mailbox, placed between steps) resumes decode from one on any engine of
  the same geometry and pool dtype, token for token what a local prefill
  gives. `submit_prefill_stream` runs a prefill between steps and streams
  its pages as ``PTKS1`` records (`serving/disagg.py`) as each chunk
  completes them. `drain(migrate=True)` exports every live request at the
  next step: decoding slots warm (their context's pages and the last
  token as the seed, a sampled slot's advanced key chain with them),
  queued and chunk-prefilling ones cold; `take_migrated` hands the items
  over. Slotless prefills write the key buffer's scratch row B; the pages
  move by `export_pages` / `import_pages` in place, so every captured graph
  reads them.

Not in this slice (see ROADMAP.md): a float KV pool of another dtype than
the weights (A9.1). The serve tier, the router and its prefix directory
are `inference/serve.py` and `serving/`.

Thread model: `submit()`, `cancel()`, `drain()`, `submit_import()`,
`submit_prefill_stream()` and `take_migrated()` are safe from any thread
and make no CUDA call; `step()` / `run_until_idle()` / `serve_loop()` /
`abort()`, `prefill_export()` and `import_request()` must all run on ONE
thread, the loop's owner (`serve_loop` enters the engine's device on it).
"""
from __future__ import annotations

import contextlib
import functools
import logging
import queue as _queue
import threading
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import torch_state
from paddle_tpu_torch.inference.errors import (Cancelled, DeadlineExceeded,
                                               HandoffCorrupt, Overloaded,
                                               from_wire)
from paddle_tpu_torch.inference.graphs import StepGraph
from paddle_tpu_torch.inference.handoff import (MIG_MAGIC, KVHandoff,
                                                MigrationItem, pack_migration,
                                                unpack_migration)
from paddle_tpu_torch.inference.kv_tiers import KVTierStore
from paddle_tpu_torch.inference.kv_tiers import dtype_name as _dtype_name
from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.kernels import sampling as smp
from paddle_tpu_torch.kernels.paged_attention import (KV_DTYPES, TRASH_PAGE,
                                                      export_pages,
                                                      import_pages)
from paddle_tpu_torch.models import gpt as gpt_mod
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import (Watchdog,
                                                            default_deadline,
                                                            flight)
from paddle_tpu_torch.observability.tracing import RequestTrace, new_span_id
from paddle_tpu_torch.observability.usage import emit_request as _emit_usage
from paddle_tpu_torch.quantization.serving import (QuantizedLeaf,
                                                   quantize_gpt_params)
from paddle_tpu_torch.serving.disagg import (pack_stream_final,
                                             pack_stream_header,
                                             pack_stream_pages,
                                             prompt_page_hashes)
from paddle_tpu_torch.testing import faults

__all__ = ["EngineConfig", "PageAllocator", "GenerateRequest", "DecodeEngine",
           "KVHandoff", "MigrationItem", "MIG_MAGIC", "DeadlineExceeded",
           "Cancelled", "Overloaded", "HandoffCorrupt", "pack_migration",
           "unpack_migration"]

_log = logging.getLogger(__name__)


def _metric_name(key: str) -> str | None:
    """The JAX engine's metric of one of ``DecodeEngine.counters``' names
    ("engine." + the name, ``kvtier_`` written ``kvtier.``), or None for
    the port's own ``prefills``, which the JAX engine does not keep."""
    if key == "prefills":
        return None
    return "engine." + key.replace("kvtier_", "kvtier.")

# packed slot-state upload layout: [B, _STATE_COLS + pages_per_slot] int32;
# the verify step's is [B, _SPEC_COLS + K + pages_per_slot] (a draft-length
# column and K drafted tokens), and a sampling engine appends two columns
# (temperature bits, top_k) to either: still one upload per step
_COL_TOKEN, _COL_LENGTH, _COL_FLAGS, _STATE_COLS = 0, 1, 2, 3
_COL_DRAFT, _SPEC_COLS = 3, 4
_FLAG_ACTIVE, _FLAG_FRESH = 1, 2
# a sampling engine's prefill uploads end in [slot, key0, key1, temperature
# bits, top_k], a chunk's in one more word, final (the JAX layouts)
_SAMPLE_TAIL = 5


@dataclass
class EngineConfig:
    """Scheduler settings.

    page_size    : tokens per KV page
    max_slots    : decode batch width B; every step computes all B slots
    max_seq_len  : per-sequence capacity (prompt + generated), rounded up
                   to whole pages; defaults to the model's position table
    num_pages    : total pool size; default fits max_slots full sequences
                   plus the reserved trash page
    min_bucket   : smallest prefill bucket (power-of-two padding starts here)
    eos_id       : optional token id that retires a slot early
    donate       : the JAX engine's buffer donation into its step programs.
                   Accepted with any value, so a JAX config constructs: the
                   port's step programs always write the pools and the
                   token and key buffers in place, which is what donation
                   buys
    inflight     : decode steps kept in flight before the host blocks on
                   the oldest step's sampled tokens (deferred readback; 1
                   restores the synchronous loop). Read at construction:
                   the engine keeps ``max(1, inflight)`` pinned state and
                   token buffers. EOS detection lags by up to this many
                   steps; the surplus tokens are discarded at harvest,
                   never delivered. A speculating engine reads each verify
                   step back at once, whatever this says
    prefill_chunk_tokens : prompts LONGER than this are prefilled in chunks
                   of this many tokens, one chunk per engine step after the
                   decode step; None keeps the one-shot bucketed prefill
    prefix_cache : share full prompt-prefix pages copy-on-write across
                   requests: a submit whose leading pages hash-match an
                   earlier prompt's attaches them by page-table reference
                   and prefills ONLY the uncached tail. Refcount-0 cached
                   pages stay resident and are LRU-evicted under pool
                   pressure. Per request opt-out: ``submit(..., cache=False)``
    kv_host_tier_bytes : bound on a host-RAM spill tier under the prefix
                   store: an evicted prefix page DEMOTES (its values and
                   int8 scales spill as a checksummed ``PTKT1`` blob under
                   its page-chain hash) instead of being discarded, and a
                   later submit that misses HBM but hits the tier
                   re-uploads the pages and prefills only the rest.
                   None/0 turns tiering off
    kv_disk_tier_bytes : bound on the disk tier below the host tier (host
                   overflow demotes here, disk overflow discards); works
                   alone too. None/0 turns it off
    kv_disk_tier_dir : directory of the disk tier's blobs, OWNED by the
                   store (stale ``.ptkt`` files are removed at
                   construction); None with a disk bound uses a fresh
                   temporary directory
    kv_dtype     : page-pool storage: "native" (the weights' dtype) or
                   "int8" (int8 pages plus per-token-slot per-head f32
                   scale pools [nl, P, ps, nh]); "f32" / "bf16" are
                   accepted where they equal the weights' dtype
    weight_dtype : "native" or "int8": the GPT matmul leaves become int8
                   with per-output-channel scales at construction
                   (`quantization/serving.py`), dequantized at use
    sampling     : the fused sampler: submit() takes temperature, top_k
                   and seed, each slot's key chain lives on the device; off,
                   the engine is greedy and refuses sampled parameters
    speculate_k  : when set (>= 1), each step drafts up to k tokens per slot
                   (n-gram lookup over the slot's own tokens) and verifies
                   all k+1 positions in one step, emitting 1..k+1 tokens,
                   the tokens plain decode gives; per request opt-out with
                   ``submit(..., speculate=False)``
    max_queue_depth  : admission control: a submit arriving with this many
                   requests already queued fails FAST with a typed
                   ``Overloaded`` error instead of joining an unbounded
                   queue (a router resubmits it elsewhere, the client gets
                   a bounded answer). None keeps the queue unbounded
    max_queue_tokens : the same, bounding the SUM of queued prompt tokens
                   (a few giant prompts can overload a queue long before
                   max_queue_depth does). Backlog only: an empty queue
                   always admits, so one prompt larger than the bound is
                   never shed with a retry-forever Overloaded
    dedup_capacity : bound on the idempotency dedup table: requests
                   submitted with a client-generated ``request_key`` are
                   remembered here. A resubmit of an IN-FLIGHT key attaches
                   to the existing request (``dedup_hits``), a resubmit of
                   a COMPLETED key replays its answer verbatim
                   (``dedup_replays``). LRU-evicted past the bound; 0
                   turns dedup off (every keyed submit executes)
    """
    page_size: int = 16
    max_slots: int = 8
    max_seq_len: int | None = None
    num_pages: int | None = None
    min_bucket: int = 16
    eos_id: int | None = None
    donate: bool | None = None
    inflight: int = 2
    prefill_chunk_tokens: int | None = None
    prefix_cache: bool = True
    kv_host_tier_bytes: int | None = None
    kv_disk_tier_bytes: int | None = None
    kv_disk_tier_dir: str | None = None
    speculate_k: int | None = None
    max_queue_depth: int | None = None
    max_queue_tokens: int | None = None
    kv_dtype: str = "native"
    weight_dtype: str = "native"
    sampling: bool = False
    dedup_capacity: int = 1024


class PageAllocator:
    """Host-side REFCOUNTED free list over the page pool. Page 0
    (TRASH_PAGE) is never handed out: it is the spill target for masked
    writes.

    The prefix cache shares pages copy-on-write across slots: `share` grows
    a page's refcount and `free` releases one owner's claim, reclaiming
    only at refcount 0. A page the engine's prefix store still indexes is
    RETAINED at refcount 0 (``retain_hook``) instead of rejoining the free
    list; under pool pressure `alloc` reclaims retained pages through
    ``evict_hook`` (LRU order, the engine's policy), so eviction never
    touches a live slot's pages."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 is reserved), got {num_pages}")
        self.num_pages = num_pages
        self._free = deque(range(1, num_pages))
        self._refcnt = [0] * num_pages
        self._retained: set[int] = set()
        self.retain_hook = None   # page -> bool: keep this refcount-0 page?
        self.evict_hook = None    # n -> list[page]: reclaim retained pages
        self._g_in_use = metrics.gauge("engine.pages_in_use")

    @property
    def free_pages(self) -> int:
        """Pages allocatable now: the free list plus the refcount-0 cached
        pages eviction can reclaim."""
        return len(self._free) + len(self._retained)

    def _update_gauge(self):
        self._g_in_use.set(self.num_pages - 1 - self.free_pages)

    def refcount(self, page: int) -> int:
        return self._refcnt[page]

    def alloc(self, n: int) -> list[int] | None:
        """n pages, or None when the pool cannot cover them (the caller
        keeps the request queued: admission waits, it never allocates
        part of a request). Evicts retained pages through ``evict_hook``
        when the free list alone is short."""
        if faults.ENABLED and faults.fire("engine.pool_pressure"):
            return None        # injected pool pressure (testing/faults.py)
        if n > self.free_pages:
            return None
        if n > len(self._free) and self.evict_hook is not None:
            for p in self.evict_hook(n - len(self._free)):
                if p not in self._retained or self._refcnt[p] != 0:
                    raise RuntimeError(
                        f"evict hook surrendered live page {p}")
                self._retained.discard(p)
                self._free.append(p)
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refcnt[p] = 1
        self._update_gauge()
        return pages

    def reclaim(self, pages: list[int]):
        """Return RETAINED pages to the free list: the prefix store
        dropping its index outside an eviction (a weight refresh)."""
        for p in pages:
            if p not in self._retained or self._refcnt[p] != 0:
                raise ValueError(f"reclaiming non-retained page {p}")
        for p in pages:
            self._retained.discard(p)
            self._free.append(p)
        self._update_gauge()

    def share(self, pages: list[int]):
        """Attach cached pages to ONE more owner (a prefix hit): retained
        pages come back to life, live shared pages gain a reference."""
        for p in pages:
            if not (0 < p < self.num_pages):
                raise ValueError(f"sharing bogus page {p}")
            if self._refcnt[p] == 0 and p not in self._retained:
                raise ValueError(f"sharing unallocated page {p}")
        for p in pages:
            self._retained.discard(p)
            self._refcnt[p] += 1
        self._update_gauge()

    def free(self, pages: list[int]):
        """Release one owner's claim on each page. Fails LOUDLY, before
        changing anything, on a double free, a duplicate page within the
        call, an out-of-pool id or the trash page: tolerating any of these
        would eventually hand one page to two live sequences."""
        seen = set()
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("freeing reserved trash page 0")
            if not (0 < p < self.num_pages):
                raise ValueError(f"freeing bogus page {p}")
            if p in seen:
                raise ValueError(f"duplicate page {p} in one free() call")
            seen.add(p)
            if self._refcnt[p] <= 0:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._refcnt[p] -= 1
            if self._refcnt[p] == 0:
                if self.retain_hook is not None and self.retain_hook(p):
                    self._retained.add(p)
                else:
                    self._free.append(p)
        self._update_gauge()


class GenerateRequest:
    """One queued or running generation. `result()` blocks until the
    sequence retires and returns prompt + generated ids. ``trace`` is the
    request's `RequestTrace` (an upstream acceptor's, so that TTFT and e2e
    start there), else a fresh one; its ``request_id`` is the request's.
    ``deadline_s`` starts the request's deadline clock HERE (construction =
    submit): past it the engine retires the request with a typed
    ``DeadlineExceeded`` at the next enforcement point (admission, step
    start or harvest, never inside a step program)."""

    def __init__(self, prompt: np.ndarray, max_new_tokens: int, trace=None,
                 cache: bool = True, speculate: bool = True,
                 deadline_s: float | None = None,
                 request_key: bytes | None = None,
                 temperature: float = 1.0, top_k: int = 0, seed: int = 0):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.trace = trace if trace is not None else RequestTrace()
        self.cache = bool(cache)          # prefix-cache participation
        self.speculate = bool(speculate)  # n-gram drafting participation
        self.page_hashes: list[bytes] = []  # rolling full-page prompt hashes
        # the fused sampler's parameters; the defaults are the greedy arm
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self._seed_key: np.ndarray | None = None   # PRNGKey(seed) words
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.deadline_t = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        # client-generated idempotency key (16 bytes): the engine's dedup
        # table attaches resubmits of this key to THIS request
        self.request_key = None if request_key is None \
            else bytes(request_key)
        self.imported = False           # resumed from a KV handoff
        self.tenant = None              # reserved multi-tenant identity
        # usage metering (`observability/usage.py`): per-request mirrors of
        # the engine's token counters, kept at admission, prefill, harvest
        # and slot detach (never in a step program) and folded into ONE
        # record at the first `_finish`
        self.u_prefill_computed = 0     # prompt tokens a prefill ran over
        self.u_prefill_saved = 0        # prompt tokens answered from cache
        self.u_generated = 0            # tokens delivered
        self.u_spec_accepted = 0        # of those, speculation's surplus
        self.u_page_steps = 0           # KV pages held x decode steps held
        self.u_migrations = 0           # times this request moved engines
        self.u_admit_step = None        # step_seq at slot placement
        self._usage_emitted = False
        self.generated: list[int] = []
        self.submit_t = time.perf_counter()
        self.first_token_t: float | None = None   # TTFT = this - submit_t
        self._waiters = 0               # live result() waiters (serve tier)
        self._wlock = threading.Lock()
        self._done = threading.Event()
        self._error: str | None = None

    def add_waiter(self):
        """One more party is blocked on this request (a serve connection
        thread, possibly a dedup-attached resubmit). A disconnect-cancel
        consults `waiters`, so one client hanging up cannot kill a
        generation another attached client still wants."""
        with self._wlock:
            self._waiters += 1

    def remove_waiter(self) -> int:
        """Detach one waiter; returns the REMAINING count. The decrement and
        the read are one atomic step, so two waits giving up at once elect
        exactly one canceller."""
        with self._wlock:
            self._waiters = max(0, self._waiters - 1)
            return self._waiters

    @property
    def waiters(self) -> int:
        with self._wlock:
            return self._waiters

    def expired(self, now: float | None = None) -> bool:
        return self.deadline_t is not None and \
            (time.monotonic() if now is None else now) >= self.deadline_t

    @property
    def request_id(self) -> str:
        return self.trace.request_id

    def _finish(self, error: str | None = None):
        """Every termination (retire, reap, abort, deadline) ends here: the
        trace is marked done, the future set, and the ONE usage record
        emitted behind a latch, so a second `_finish` never bills twice."""
        self.trace.mark_done(error)
        self._error = error
        self._done.set()
        with self._wlock:
            first = not self._usage_emitted
            self._usage_emitted = True
        if first:
            _emit_usage(self, error)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("generation still running")
        if self._error is not None:
            # typed where the error names a known type ("DeadlineExceeded:
            # ...", "Cancelled: ..."), RuntimeError otherwise
            raise from_wire(self._error)
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, self.prompt.dtype)])


_NGRAM_NS = (3, 2, 1)          # longest-match-first draft lookup order


class _DraftIndex:
    """Per-slot n-gram index of the self-drafting proposer: ``{n-gram ->
    most recent start position that has a following token}``, kept up in
    O(1) per generated token, so a draft costs O(k) host work, never a
    rescan of the context. An n-gram is registered once its follower
    exists, so a lookup always has a token to propose."""

    __slots__ = ("hist", "maps")

    def __init__(self, prompt):
        self.hist: list[int] = []
        self.maps = {n: {} for n in _NGRAM_NS}
        for t in prompt:
            self.append(int(t))

    def append(self, tok: int):
        h = self.hist
        p = len(h)
        h.append(int(tok))
        for n in _NGRAM_NS:
            if p >= n:                 # grams ending at p-1 gained a follower
                self.maps[n][tuple(h[p - n:p])] = p - n

    def draft(self, k: int) -> list[int]:
        """Up to k tokens that followed the most recent earlier occurrence
        of the longest suffix (3, 2, then 1 tokens) seen before."""
        h = self.hist
        for n in _NGRAM_NS:
            if len(h) <= n:
                continue
            j = self.maps[n].get(tuple(h[-n:]))
            if j is not None:
                return h[j + n:j + n + k]
        return []


class _PrefillEntry:
    """A prefill or chunk entry of the program cache: its program over
    buffers of its own, which keep their identity, ``dev`` (the packed
    upload on the device, copied from ``host``, pinned on the card) and
    ``tok`` [1] int32 (the first token); the program reads the engine's
    weights, pools and key chains. On the card the program is a
    `StepGraph` captured over these buffers, in the engine's prefill pool;
    on the CPU it is the eager body. The entry holds no reference to the
    engine.

    The warm-up and capture runs see the upload zeroed, so every write
    goes to the trash page (length or valid 0) and, on a sampling engine,
    a tail naming the key buffer's scratch row B with the greedy
    arm: building a graph mid-serving leaves every live slot's pages and
    key chain as they were.

    Buffer reuse: the copy from the pinned host buffer is asynchronous and
    a non-final chunk has no readback, so two chunks can follow one
    another with no synchronization between them. Each upload records an
    event, and `pack` waits on it before the host buffer is written again
    (one host buffer an entry; an in-flight window, ROADMAP A5.2, keeps
    this rule)."""

    def __init__(self, eng, size: int, body, chunk: bool):
        cuda = eng.device.type == "cuda"
        self.host = torch.zeros(size, dtype=torch.int32, pin_memory=cuda)
        self.host_np = self.host.numpy()
        self.dev = torch.zeros(size, dtype=torch.int32, device=eng.device)
        self.tok = torch.zeros(1, dtype=torch.int32, device=eng.device)
        self.body = functools.partial(body, packed=self.dev, tok=self.tok)
        self.uploaded = torch.cuda.Event() if cuda else None
        self.graph = None
        if cuda:
            if eng._sampling:
                tail = eng._sample_tail(eng.ecfg.max_slots, None,
                                        final=False if chunk else None)
                self.dev[size - tail.size:].copy_(torch.from_numpy(tail))
            self.graph = StepGraph(functools.partial(self.body, eng),
                                   eng.device, pool=eng._prefill_pool)

    def pack(self) -> np.ndarray:
        """The host buffer, zeroed, once the last upload from it is done."""
        if self.uploaded is not None:
            self.uploaded.synchronize()
        self.host_np[:] = 0
        return self.host_np

    def upload(self, eng, count=True):
        """The packed host buffer into ``dev``, on the current stream;
        counted in ``h2d_transfers`` unless ``count`` is False."""
        if count:
            eng._count("h2d_transfers")
        self.dev.copy_(self.host, non_blocking=True)
        if self.uploaded is not None:
            self.uploaded.record()

    def __call__(self, eng):
        """Upload the packed host buffer and run the program (a replay on
        the card). Returns the logits of the program's run."""
        self.upload(eng)
        return (self.graph or self.body)(eng)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A pool gather on the host as the wire blobs carry it: numpy, a
    bfloat16 tensor as int16 of the same bits."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _pool_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A handoff's page array as a CPU tensor of the pool's dtype (for a
    bfloat16 pool the array's 16-bit words, as `_host_array` gives
    them)."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DecodeEngine runs on the CUDA card by default and CUDA is "
                "not available here; pass device=\"cpu\" to serve with the "
                "plain PyTorch kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class DecodeEngine:
    """Continuous-batching decode (greedy, or sampled with
    ``EngineConfig(sampling=True)``, optionally speculative) over a paged KV
    cache for one GPT model.

    >>> eng = DecodeEngine(model)                    # on the card
    >>> reqs = [eng.submit(ids, max_new_tokens=32) for ids in prompts]
    >>> eng.run_until_idle()
    >>> outs = [r.result() for r in reqs]

    ``device=None`` means ``cuda`` and raises where CUDA is absent; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels. The
    engine computes in the model's parameter dtype and keeps its KV pools
    in that dtype, or in int8 with scale pools (``kv_dtype="int8"``).
    """

    def __init__(self, model, engine_config: EngineConfig | None = None,
                 device=None):
        ecfg = engine_config or EngineConfig()
        self.device = _resolve_device(device)
        self.cfg = model.cfg
        self.ecfg = ecfg
        self._params = self._load_params(model)
        self._cdtype = self._params["gpt.wte.weight"].dtype
        self._quant_kv = self._resolve_kv_dtype(ecfg.kv_dtype)
        nh = self.cfg.num_heads
        dh, nl = self.cfg.hidden_size // nh, self.cfg.num_layers
        if ecfg.prefill_chunk_tokens is not None \
                and int(ecfg.prefill_chunk_tokens) < 1:
            raise ValueError(f"prefill_chunk_tokens must be >= 1, "
                             f"got {ecfg.prefill_chunk_tokens}")

        ps = ecfg.page_size
        max_seq = ecfg.max_seq_len or self.cfg.max_position_embeddings
        max_seq = min(max_seq, self.cfg.max_position_embeddings)
        self.max_seq_len = max_seq
        self.pages_per_slot = -(-max_seq // ps)           # ceil
        self.slot_capacity = self.pages_per_slot * ps     # tokens per slot
        num_pages = ecfg.num_pages or 1 + ecfg.max_slots * self.pages_per_slot
        self.allocator = PageAllocator(num_pages)

        B, maxp = ecfg.max_slots, self.pages_per_slot
        pool_dtype = torch.int8 if self._quant_kv else self._cdtype
        self._kc = torch.zeros((nl, num_pages, ps, nh, dh),
                               dtype=pool_dtype, device=self.device)
        self._vc = torch.zeros_like(self._kc)
        # int8 pools: one f32 scale per token slot and head, written by the
        # same scatters as the values
        self._ks = self._vs = None
        if self._quant_kv:
            self._ks = torch.zeros((nl, num_pages, ps, nh),
                                   dtype=torch.float32, device=self.device)
            self._vs = torch.zeros_like(self._ks)
        # bytes one cached token costs across all layers: K and V values,
        # plus their scales when quantized
        self.kv_bytes_per_token = nl * 2 * (
            nh * dh * self._kc.element_size()
            + (nh * 4 if self._quant_kv else 0))
        metrics.gauge("engine.kv_bytes_per_token").set(
            self.kv_bytes_per_token)
        metrics.gauge("engine.page_size").set(ps)
        # host-side mirrors of the per-slot state, fused into ONE packed
        # int32 upload per step; sampled tokens live on the device and only
        # the _tokens column is consulted for freshly admitted slots
        self._page_table = np.full((B, maxp), TRASH_PAGE, np.int32)
        self._lengths = np.zeros(B, np.int32)
        self._tokens = np.zeros(B, np.int32)
        self._active = np.zeros(B, bool)      # dispatchable this step
        self._fresh = np.zeros(B, bool)       # admitted since last dispatch
        self._budget = np.zeros(B, np.int32)  # tokens left to dispatch
        self._slot_req: list[GenerateRequest | None] = [None] * B
        self._slot_pages: list[list[int]] = [[] for _ in range(B)]
        # the previous step's tokens, written in place by each decode step
        self._tok_dev = torch.zeros(B, dtype=torch.int32, device=self.device)
        # fused sampling: per-slot (temperature, top_k) host mirrors ride the
        # packed upload; the key chains stay on the device, threaded through
        # every step like _tok_dev. Row B is the scratch row of the
        # prefills without a slot (`prefill_export`, the prefill stream) and
        # of the warm-up and capture runs of a prefill graph, so neither
        # moves a live slot's chain
        self._sampling = bool(ecfg.sampling)
        self._temps = np.ones(B, np.float32)
        self._topks = np.zeros(B, np.int32)
        self._keys_dev = torch.zeros((B + 1, 2), dtype=torch.int64,
                                     device=self.device) \
            if self._sampling else None
        if ecfg.speculate_k is not None and int(ecfg.speculate_k) < 1:
            raise ValueError(
                f"speculate_k must be >= 1, got {ecfg.speculate_k}")
        self._spec = ecfg.speculate_k is not None
        self._spec_k = int(ecfg.speculate_k) if self._spec else 0
        self._slot_draft: list[_DraftIndex | None] = [None] * B
        # the decode or verify step's inputs and outputs, which keep their
        # identity (a captured graph reads and writes these very tensors):
        # the packed state's device buffer, and the verify step's [B, K+2]
        # tokens and counts
        lead = _SPEC_COLS + self._spec_k if self._spec else _STATE_COLS
        cols = lead + maxp + (2 if self._sampling else 0)
        self._state_dev = torch.zeros((B, cols), dtype=torch.int32,
                                      device=self.device)
        # the in-flight window: up to `_window` decode steps dispatched and
        # not yet harvested, one (token ring slot, [(slot, request)]) entry
        # each. Each step packs its state into the next of `_window` host
        # buffers (pinned on the card) and its tokens leave `_tok_dev` for
        # the next of `_window` token buffers right after its replay; an
        # event a buffer guards each reuse (`_packed_state`, `_dispatch`)
        self._window = max(1, int(ecfg.inflight))
        self._inflight: deque[tuple[int, list]] = deque()
        cuda = self.device.type == "cuda"
        self._state_ring = [torch.zeros((B, cols), dtype=torch.int32,
                                        pin_memory=cuda)
                            for _ in range(self._window)]
        self._state_uploaded = [torch.cuda.Event() if cuda else None
                                for _ in range(self._window)]
        self._state_i = 0
        self._state_host = self._state_ring[0]
        self._tok_ring = [torch.zeros(B, dtype=torch.int32, pin_memory=cuda)
                          for _ in range(self._window)]
        self._tok_copied = [torch.cuda.Event() if cuda else None
                            for _ in range(self._window)]
        self._tok_i = 0
        self._spec_out = torch.zeros((B, self._spec_k + 2),
                                     dtype=torch.int32, device=self.device) \
            if self._spec else None
        # the program cache (`_compiled`): the registry's impl on this
        # device keys it, as the JAX engine's impl flag does
        self._impl = "cuda" if self.device.type == "cuda" else "plain"
        self._programs: dict[tuple, object] = {}
        # one memory pool for this engine's prefill and chunk graphs
        # (`inference/graphs.py`); None gives each graph its own
        self._prefill_pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        # chunked-prefill progress: slot -> {"req", "done", "t0"}; these
        # slots are occupied (request and pages held) but NOT decode-active
        self._prefilling: dict[int, dict] = {}
        self.step_seq = 0             # advances once a step(): the usage
        #                               integral's clock, the watchdog's
        #                               progress reading
        self._blocked_s = 0.0         # readback waits within this step

        self._queue: deque[GenerateRequest] = deque()
        self._qlock = threading.Lock()
        self._work = threading.Condition(self._qlock)
        self._queue_tokens = 0        # sum of queued prompt tokens (_qlock)
        self._dead: str | None = None  # set by abort(); submits then fail
        self._draining = False        # drain(): refuse NEW submits only
        # cancellation mailbox: any thread posts request_id -> reason, the
        # loop's thread applies it between fixed-shape steps (`_reap`)
        self._cancels: dict[str, str] = {}
        # idempotency dedup table: request_key -> GenerateRequest, LRU
        # bounded at ecfg.dedup_capacity (_qlock)
        self._dedup: OrderedDict[bytes, GenerateRequest] = OrderedDict()
        # live migration: drain(migrate=True) posts a flag, the loop's
        # thread exports every live request into _migrated at the next
        # step and sets the event take_migrated() waits on. The inbound
        # side is a mailbox: submit_import() posts (handoff, request) from
        # any thread and the loop places it between steps (_apply_imports)
        self._migrate_requested = False
        self._migrated: list[MigrationItem] = []
        self._migrate_done = threading.Event()
        self._imports: deque = deque()
        # prefill-stream mailbox: submit_prefill_stream posts (ids, cache,
        # trace_ctx, sink) from any thread; the loop runs the prefill
        # between steps and puts the PTKS1 records into the sink
        self._prefill_jobs: deque = deque()
        self._deg = 0                 # applied degradation level (loop)
        # d2h_transfers: token readbacks, one per decode or verify step and
        # per finished prefill; logits are never read back. The program
        # cache's, prefix, tier and lifecycle counters carry the JAX
        # package's metric names without its "engine." prefix
        self.counters = dict.fromkeys((
            "requests", "shed", "dedup_hits", "dedup_replays", "cancelled",
            "deadline_exceeded", "drains",
            "cache_hit", "cache_miss", "compile_count", "steps", "tokens",
            "h2d_transfers", "d2h_transfers", "logits_readback", "prefills",
            "prefill_chunks", "prefill_tokens", "spec_steps", "spec_drafted",
            "spec_accepted", "prefix_hit", "prefix_miss",
            "prefix_pages_reused", "prefix_evictions",
            "prefix_evictions_demoted", "prefix_evictions_discarded",
            "kvtier_hits_host", "kvtier_hits_disk", "kvtier_spills_host",
            "kvtier_spills_disk", "kvtier_refusals", "kvtier_reuploads_host",
            "kvtier_reuploads_disk", "kvtier_spill_fail",
            "kvtier_reupload_fail", "kv_exports", "kv_imports",
            "kv_stream_exports", "migrations_out", "migrations_in"), 0)
        # the same counts in the metrics registry (`_count` writes both);
        # ``logits_readback`` stays 0 by design (no engine path reads
        # logits back)
        self._m = {k: metrics.counter(_metric_name(k))
                   for k in self.counters if _metric_name(k)}
        self._g_prefix_pages = metrics.gauge("engine.prefix_pages")
        self._g_prefix_bytes = metrics.gauge("engine.prefix_store_bytes")
        self._g_spec_rate = metrics.gauge("engine.spec_accept_rate")
        self._g_spec_tps = metrics.gauge("engine.spec_tokens_per_step")
        self._g_deg = metrics.gauge("engine.degradation_level")
        self._g_occupancy = metrics.gauge("engine.batch_occupancy")
        self._g_queue = metrics.gauge("engine.queue_depth")
        self._g_tps = metrics.gauge("engine.tokens_per_s")
        self._g_inflight = metrics.gauge("engine.steps_in_flight")
        self._h_wait = metrics.histogram("engine.queue_wait_seconds")
        self._h_step = metrics.histogram("engine.step_seconds")
        self._h_prefill = metrics.histogram("engine.prefill_seconds")
        self._h_host = metrics.histogram("engine.host_ms")
        self._h_device = metrics.histogram("engine.device_ms")
        self._h_spill = metrics.histogram("engine.kvtier.spill_ms")
        self._h_reupload = metrics.histogram("engine.kvtier.reupload_ms")

        # prefix cache: rolling full-page hash -> resident page, the reverse
        # map, and the LRU of refcount-0 ("idle") cached pages the
        # allocator retains for the store. Mutated on the driver thread
        # only (admission, retirement); submit() only computes hashes
        self._prefix_enabled = bool(ecfg.prefix_cache)
        self._prefix_pages: dict[bytes, int] = {}
        self._page_hash: dict[int, bytes] = {}
        self._prefix_idle: OrderedDict[int, None] = OrderedDict()
        # the hooks hold the engine weakly: a reference cycle through the
        # allocator would keep a dropped engine's pools on the card until a
        # garbage-collector pass
        retain = weakref.WeakMethod(self._retain_page)
        evict = weakref.WeakMethod(self._evict_prefix_pages)
        self.allocator.retain_hook = lambda page: retain()(page)
        self.allocator.evict_hook = lambda n: evict()(n)
        # KV tiers under the prefix store: eviction demotes page contents,
        # a tier hit re-uploads them
        self._tiers = None
        if self._prefix_enabled and (ecfg.kv_host_tier_bytes
                                     or ecfg.kv_disk_tier_bytes):
            self._tiers = KVTierStore(
                host_bytes=ecfg.kv_host_tier_bytes,
                disk_bytes=ecfg.kv_disk_tier_bytes,
                disk_dir=ecfg.kv_disk_tier_dir,
                page_shape=(nl, ps, nh, dh),
                dtype=_dtype_name(self._kc.dtype), scales=self._quant_kv,
                counters=self.counters)

    def _count(self, key: str, n: int = 1):
        """Count ``n`` under ``key`` in ``counters`` and under its JAX name
        in the metrics registry: the one place an engine count moves."""
        self.counters[key] += n
        m = self._m.get(key)
        if m is not None:
            m.inc(n)

    def _load_params(self, model) -> dict:
        """The model's weights on the engine's device, int8 matmul leaves
        under ``weight_dtype="int8"`` (quantized where the weights lie,
        then moved: the card and the CPU engines hold the same int8 values
        and scales). The engine owns its copies: `refresh_params` writes
        into them, never into the model's tensors."""
        params = torch_state(model)
        if self.ecfg.weight_dtype not in ("native", None):
            params = quantize_gpt_params(params, self.ecfg.weight_dtype)
        return {k: v.to(self.device) if isinstance(v, QuantizedLeaf)
                else v.to(self.device, copy=True) for k, v in params.items()}

    def refresh_params(self, model):
        """Copy ``model``'s current weights (re-quantized under int8
        weights: the int8 values and their scales) INTO the engine's weight
        tensors, which keep their identity: the step programs take them as
        inputs, so this never recaptures, and a replayed graph reads the
        new values. Then FLUSH the prefix store, host and disk tiers
        included: cached or spilled pages hold KV computed under the old
        weights. Steps in flight are harvested first."""
        self._drain_window()
        params = self._load_params(model)
        dt = params["gpt.wte.weight"].dtype
        if dt != self._cdtype:
            raise ValueError(f"refresh_params: the engine computes in "
                             f"{self._cdtype}, the new weights are {dt}")
        shapes = {k: tuple(v.shape) for k, v in self._params.items()}
        if {k: tuple(v.shape) for k, v in params.items()} != shapes:
            raise ValueError("refresh_params: the new weights' names or "
                             "shapes differ from the engine's model")
        for k, new in params.items():
            old = self._params[k]
            if isinstance(old, QuantizedLeaf):
                old.q.copy_(new.q)
                old.scale.copy_(new.scale)
            else:
                old.copy_(new)
        self._flush_prefix()

    def _resolve_kv_dtype(self, kvd) -> bool:
        """Check ``kv_dtype``; True for an int8 pool. A float dtype other
        than the weights' is not ported: the CUDA kernels take q and float
        pools of one dtype."""
        if kvd in ("native", None):
            return False
        if kvd not in KV_DTYPES:
            raise ValueError(f"kv_dtype={kvd!r}: expected 'native', "
                             f"{sorted(KV_DTYPES)}")
        if kvd == "int8":
            return True
        if KV_DTYPES[kvd] != self._cdtype:
            raise NotImplementedError(
                f"kv_dtype={kvd!r} under {self._cdtype} weights is not "
                "ported (ROADMAP A9.1: a float KV pool of another dtype "
                "than the weights); use 'native' or 'int8'")
        return False

    def _scales(self) -> dict:
        """The scale pools as step-function keywords, or {} (float pools)."""
        if not self._quant_kv:
            return {}
        return {"k_scale": self._ks, "v_scale": self._vs}

    # ------------------------------------------------------- prefix cache

    def prefix_hashes(self) -> list[str]:
        """Hex digests of every page the prefix store indexes."""
        return [h.hex() for h in list(self._prefix_pages)]

    def tier_hashes(self) -> list[str]:
        """Hex chain hashes of every spilled page, host tier first."""
        return [] if self._tiers is None else self._tiers.hashes()

    def _update_prefix_gauges(self):
        """The prefix store's size: indexed pages and the bytes they pin."""
        n = len(self._page_hash)
        self._g_prefix_pages.set(n)
        self._g_prefix_bytes.set(
            n * self.ecfg.page_size * self.kv_bytes_per_token)

    def _retain_page(self, page: int) -> bool:
        """Allocator retain hook: a refcount-0 page the store still indexes
        stays resident, most recently idled last in the LRU. Under
        degradation level >= 2 retention stops: the page goes straight
        back to the free list (capacity over cache warmth), its contents
        demoted to the tiers first when they are configured."""
        if self._deg >= 2:
            h = self._page_hash.pop(page, None)
            if h is not None and self._prefix_pages.get(h) == page:
                del self._prefix_pages[h]
            self._prefix_idle.pop(page, None)
            if h is not None:
                demoted = self._spill_pages([page], [h])
                self._count("prefix_evictions")
                self._count("prefix_evictions_demoted", demoted)
                self._count("prefix_evictions_discarded", 1 - demoted)
            self._update_prefix_gauges()
            return False
        if page in self._page_hash:
            self._prefix_idle[page] = None
            return True
        return False

    def _evict_prefix_pages(self, n: int) -> list[int]:
        """Allocator evict hook: surrender up to n LRU idle cached pages,
        dropping their store entries; live pages are never offered. With
        tiers their contents spill first (`_spill_pages`): a demotion."""
        out, hashes = [], []
        while len(out) < n and self._prefix_idle:
            page, _ = self._prefix_idle.popitem(last=False)
            h = self._page_hash.pop(page)
            if self._prefix_pages.get(h) == page:
                del self._prefix_pages[h]
            out.append(page)
            hashes.append(h)
        if out:
            demoted = self._spill_pages(out, hashes)
            self._count("prefix_evictions", len(out))
            self._count("prefix_evictions_demoted", demoted)
            self._count("prefix_evictions_discarded", len(out) - demoted)
        self._update_prefix_gauges()
        return out

    def _spill_pages(self, pages: list[int], hashes: list[bytes]) -> int:
        """Demote evicted pages into the tier store: ONE batched
        `export_pages` gather and one copy to the host, then a framed blob
        per page under its chain hash. Returns the pages demoted: 0 without
        tiers or when the spill failed, which makes the eviction a plain
        discard (an eviction never fails)."""
        if self._tiers is None or not pages:
            return 0
        t0 = time.perf_counter()
        try:
            if faults.ENABLED and faults.fire("kvtier.spill_fail"):
                raise faults.FaultInjected(
                    "injected spill failure (kvtier.spill_fail)")
            blobs = [t.cpu() for t in export_pages(
                self._kc, self._vc, pages,
                *((self._ks, self._vs) if self._quant_kv else ()))]
            for i, h in enumerate(hashes):
                self._tiers.put(h, *(b[:, i] for b in blobs[:2]),
                                *(b[:, i] for b in blobs[2:]))
        except Exception as e:  # noqa: BLE001 - a failed spill is a discard
            self._count("kvtier_spill_fail")
            flight.record("engine.kvtier.spill_fail", pages=len(pages),
                          error=f"{type(e).__name__}: {e}")
            _log.warning("KV tier spill of %d pages failed; they are "
                         "discarded", len(pages), exc_info=True)
            return 0
        self._h_spill.observe((time.perf_counter() - t0) * 1e3)
        flight.record("engine.kvtier.spill", pages=len(pages))
        return len(pages)

    def _tier_reupload(self, hashes: list[bytes], prompt_len: int,
                       shared: list[int], pages: list[int]) -> int:
        """Continue a prefix lookup PAST the HBM store into the tiers and
        re-upload the hits into this request's leading fresh ``pages``
        (one `import_pages` scatter a pool). Returns how many leading fresh
        pages now hold valid KV; the prefill starts after them. 0 on a
        miss or a failed re-upload: the request then prefills cold."""
        if self._tiers is None or not hashes or not pages:
            return 0
        limit = (int(prompt_len) - 1) // self.ecfg.page_size
        entries = []
        for h in hashes[len(shared):limit][:len(pages)]:
            e = self._tiers.get(h)
            if e is None:
                break                 # chained hashes: stop at first miss
            entries.append(e)
        if not entries:
            return 0
        n = len(entries)
        t0 = time.perf_counter()
        try:
            if faults.ENABLED and faults.fire("kvtier.reupload_fail"):
                raise faults.FaultInjected(
                    "injected re-upload failure (kvtier.reupload_fail)")
            blobs = [torch.stack([getattr(e, f) for e in entries], dim=1)
                     for f in (("k", "v", "ks", "vs") if self._quant_kv
                               else ("k", "v"))]
            import_pages(self._kc, self._vc, *blobs[:2], pages[:n],
                         *((self._ks, self._vs) if self._quant_kv else ()),
                         *blobs[2:])
        except Exception as e:  # noqa: BLE001 - a failed re-upload: cold
            self._count("kvtier_reupload_fail")
            flight.record("engine.kvtier.reupload_fail", pages=n,
                          error=f"{type(e).__name__}: {e}")
            _log.warning("KV tier re-upload of %d pages failed; the request "
                         "prefills cold", n, exc_info=True)
            return 0
        for e in entries:
            self._count("kvtier_reuploads_" + e.tier)
        self._h_reupload.observe((time.perf_counter() - t0) * 1e3)
        flight.record("engine.kvtier.reupload", pages=n,
                      from_host=sum(1 for e in entries if e.tier == "host"),
                      from_disk=sum(1 for e in entries if e.tier == "disk"))
        return n

    def _flush_prefix(self):
        """Drop EVERY store entry and flush the tiers: idle cached pages
        return to the free list now; pages of live slots lose their index
        (the retain hook declines them at retirement)."""
        idle = list(self._prefix_idle)
        self._prefix_idle.clear()
        self._prefix_pages.clear()
        self._page_hash.clear()
        if idle:
            self.allocator.reclaim(idle)
        if self._tiers is not None:
            self._tiers.flush()
        self._update_prefix_gauges()

    def _prefix_lookup(self, hashes: list[bytes]) -> list[int]:
        """Longest cached prefix: pages for the leading run of hash hits."""
        pages = []
        for h in hashes:
            p = self._prefix_pages.get(h)
            if p is None:
                break
            pages.append(p)
        return pages

    def _attach_prefix(self, pages: list[int]):
        """A hit: the shared pages gain an owner and leave the idle LRU."""
        self.allocator.share(pages)
        for p in pages:
            self._prefix_idle.pop(p, None)

    def _register_prefix(self, hashes: list[bytes], pages: list[int]):
        """Index a prefilled prompt's full pages (first writer wins: the
        shared leading pages of a hit are indexed already, and equal
        contents by construction)."""
        for h, p in zip(hashes, pages):
            if h in self._prefix_pages or p in self._page_hash:
                continue
            self._prefix_pages[h] = p
            self._page_hash[p] = h
        self._update_prefix_gauges()

    # ----------------------------------------------------------- prefill

    def _use_chunked(self, prompt_len: int) -> bool:
        c = self.ecfg.prefill_chunk_tokens
        return c is not None and prompt_len > int(c)

    def bucket_for(self, prompt_len: int) -> int:
        """Next power of two >= prompt_len (floor min_bucket, capped at the
        position table so wpe[:bucket] stays in range)."""
        b = max(self.ecfg.min_bucket, 1 << max(0, prompt_len - 1).bit_length())
        return min(b, self.cfg.max_position_embeddings)

    def warmup(self, prompt_lens=(1,), tail_lens=()):
        """Front-load what the first requests would otherwise pay for, the
        JAX engine's `warmup`: on the card build the CUDA kernels and
        capture the decode step's graph (the verify step's on a
        speculating engine), then the prefill entries covering
        ``prompt_lens`` (their buckets, or the chunk entry for prompts
        longer than ``prefill_chunk_tokens``) and the prefix-cache tail
        entries of ``tail_lens`` (one a tail bucket, or the chunk entry),
        each a graph on the card. The program cache then holds what the
        JAX engine's compiles for the same arguments, and no capture falls
        inside a request. Optional: every entry is also made on first
        use."""
        if self.device.type == "cuda":
            from paddle_tpu_torch.kernels import _build
            _build.build_all()
        if self._spec:
            self._verify_exe()
        else:
            self._decode_exe()
        need_chunk = False
        for n in prompt_lens:
            if self._use_chunked(int(n)):
                need_chunk = True
            else:
                self._prefill_exe(self.bucket_for(int(n)))
        for n in tail_lens:
            if self.ecfg.prefill_chunk_tokens is not None:
                need_chunk = True
            else:
                self._prefill_chunk_exe(self.bucket_for(int(n)))
        if need_chunk:
            self._prefill_chunk_exe()

    # ------------------------------------------------------------ programs

    def _compiled(self, key, build):
        """The program cache: ``build()`` once per key, counted as
        ``cache_miss`` and ``compile_count`` (a hit as ``cache_hit``), with
        an ``engine.compile_start`` event, the ``engine.compile_seconds``
        histogram and an ``engine.compile:{kind}`` span: on the card a
        miss is a graph capture. An entry is called as ``entry(engine,
        *inputs)``; it holds no reference to the engine, so a dropped
        engine frees its pools without a garbage-collector pass."""
        exe = self._programs.get(key)
        if exe is None:
            self._count("cache_miss")
            flight.record("engine.compile_start", program=str(key))
            t0 = time.perf_counter()
            exe = self._programs[key] = build()
            self._count("compile_count")
            dt = time.perf_counter() - t0
            metrics.histogram("engine.compile_seconds").observe(dt)
            metrics.add_span(f"engine.compile:{key[0]}", t0, dt,
                             cat="compile")
        else:
            self._count("cache_hit")
        return exe

    def _step_program(self, body):
        """The entry of the decode or verify key: on the card ``body``
        captured as a CUDA graph (`StepGraph`; a failed capture raises),
        on the CPU the eager ``body`` itself. The warm-up runs before the
        capture see a zeroed state: every slot inactive, so they write the
        trash page only and leave the tokens and key chains as they are."""
        if self.device.type != "cuda":
            return body
        self._state_dev.zero_()
        return StepGraph(functools.partial(body, self), self.device)

    def _decode_exe(self):
        return self._compiled(("decode", self._impl),
                              lambda: self._step_program(
                                  DecodeEngine._decode_body))

    def _verify_exe(self):
        return self._compiled(("verify", self._spec_k),
                              lambda: self._step_program(
                                  DecodeEngine._verify_body))

    def _prefill_exe(self, bucket: int):
        """The one-shot entry of ``bucket``: its upload is ``ids[bucket] |
        length | row[ | slot, key0, key1, temperature bits, top_k]``."""
        size = bucket + 1 + self.pages_per_slot \
            + (_SAMPLE_TAIL if self._sampling else 0)
        return self._compiled(
            ("prefill", bucket, self._impl),
            lambda: _PrefillEntry(self, size, functools.partial(
                DecodeEngine._prefill_program, bucket=bucket), chunk=False))

    def _prefill_chunk_exe(self, c: int | None = None):
        """The chunk entry serves decode-priority chunks (``c`` the
        configured chunk size) and prefix-cache tails (``c`` the tail's
        bucket), as in the JAX engine. Its upload is ``ids[c] | start |
        valid | row[ | slot, key0, key1, temperature bits, top_k, final]``,
        the sample tail on every chunk."""
        c = int(self.ecfg.prefill_chunk_tokens if c is None else c)
        size = c + 2 + self.pages_per_slot \
            + (_SAMPLE_TAIL + 1 if self._sampling else 0)
        return self._compiled(
            ("prefill_chunk", c, self._impl),
            lambda: _PrefillEntry(self, size, functools.partial(
                DecodeEngine._chunk_program, c=c), chunk=True))

    def _prefill_program(self, packed, tok, *, bucket):
        """The one-shot prefill program: from its uploaded ``packed`` buffer
        to the first token, written into ``tok`` [1] (`_first_token`).
        Returns the last real token's logits."""
        maxp = self.pages_per_slot
        logits = gpt_mod.prefill_step(
            self._params, packed[:bucket], packed[bucket],
            packed[bucket + 1:bucket + 1 + maxp], self._kc, self._vc,
            cfg=self.cfg, **self._scales())[0]
        self._first_token(logits, packed[bucket + 1 + maxp:], tok)
        return logits

    def _chunk_program(self, packed, tok, *, c):
        """One prefill chunk from its uploaded ``packed`` buffer, at the
        absolute position ``packed[c]`` with ``packed[c + 1]`` live tokens;
        its first token goes into ``tok`` as `_prefill_program`'s, read
        only after the final chunk. Returns the last live token's
        logits."""
        maxp = self.pages_per_slot
        logits = gpt_mod.prefill_chunk_step(
            self._params, packed[:c], packed[c], packed[c + 1],
            packed[c + 2:c + 2 + maxp], self._kc, self._vc, cfg=self.cfg,
            **self._scales())[0]
        tail = packed[c + 2 + maxp:]
        self._first_token(logits, tail, tok, final=tail[5:6])
        return logits

    def _first_token(self, logits, tail, tok, final=None):
        """Inside a prefill program: the prompt's first token from its last
        logits ``[V]`` into ``tok``, the argmax, or on a sampling engine
        the request's first draw from its seed key (``tail``: the upload's
        sample tail), the advanced key written into row ``slot`` of the key
        buffer. A chunk's ``final`` word keeps that row as it was unless it
        is set (the JAX ``jnp.where(final, new_key, keys[slot])``): only
        the final chunk moves the chain."""
        if not self._sampling:
            tok.copy_(logits.argmax(dim=-1))
            return
        slot = tail[0:1].long()
        key = (tail[1:3].long() & prng.M32)[None]
        drawn, new_key = smp.fused_sample(
            logits[None], key, tail[3:4].view(torch.float32), tail[4:5])
        if final is not None:
            new_key = torch.where(final != 0, new_key,
                                  self._keys_dev.index_select(0, slot))
        self._keys_dev.index_copy_(0, slot, new_key)
        tok.copy_(drawn)

    def _upload_state(self):
        """The step's one upload: the packed state (`_packed_state`, in the
        ring's current host buffer) into the device buffer the step program
        reads, on the current stream, ahead of the step. The copy from
        pinned memory is asynchronous, so it records the buffer's event,
        which `_packed_state` waits on before it writes that buffer again.
        ``_state_dev`` is one buffer (the graph's input keeps its
        identity): stream order keeps each replay ahead of the next
        copy."""
        self._count("h2d_transfers")
        self._state_dev.copy_(self._state_host, non_blocking=True)
        event = self._state_uploaded[self._state_i]
        if event is not None:
            event.record()

    def _sample_tail(self, slot, req, final=None) -> np.ndarray:
        """The ints that end a sampling engine's prefill upload: [slot,
        key0, key1, temperature bits, top_k], and on a chunk's one more,
        ``final``. The PRNGKey(seed) words are made once per request, on
        the host, and shipped only where they are used: the one-shot
        upload or the final chunk's (the JAX engine's tail). ``slot`` None
        names the key buffer's scratch row B (a prefill without a slot);
        ``req`` None rides the greedy arm with a zero key."""
        tail = np.zeros(_SAMPLE_TAIL + (final is not None), np.int32)
        tail[0] = self.ecfg.max_slots if slot is None else slot
        tail[3] = np.float32(1.0).view(np.int32)
        if req is not None:
            if final is None or final:
                if req._seed_key is None:
                    req._seed_key = prng.seed_words(req.seed)
                tail[1:3] = req._seed_key.view(np.int32)
            tail[3] = np.float32(req.temperature).view(np.int32)
            tail[4] = req.top_k
        if final is not None:
            tail[5] = int(bool(final))
        return tail

    def _pack_prefill(self, ids, row, slot, req):
        """``ids``' one-shot upload, packed into its entry's host buffer
        (the JAX layout); returns the entry."""
        s0, maxp = ids.size, self.pages_per_slot
        bucket = self.bucket_for(s0)
        entry = self._prefill_exe(bucket)
        packed = entry.pack()
        packed[:s0] = ids
        packed[bucket] = s0
        packed[bucket + 1:bucket + 1 + maxp] = row
        if self._sampling:
            packed[bucket + 1 + maxp:] = self._sample_tail(slot, req)
        return entry

    def _pack_chunk(self, ids, done, row, slot, req, c):
        """The upload of the chunk ``ids[done:done+c]``, packed into the
        chunk entry's host buffer (the JAX layout); returns the entry, the
        chunk's live tokens and whether it is the final chunk."""
        maxp = self.pages_per_slot
        chunk = ids[done:done + c]
        final = done + c >= ids.size
        entry = self._prefill_chunk_exe(c)
        packed = entry.pack()
        packed[:chunk.size] = chunk
        packed[c] = done
        packed[c + 1] = chunk.size
        packed[c + 2:c + 2 + maxp] = row
        if self._sampling:
            packed[c + 2 + maxp:] = self._sample_tail(slot, req, final=final)
        return entry, int(chunk.size), final

    def _tail_chunk(self, prompt_len: int, start: int) -> int:
        """The chunk size of a prefix hit's tail: the configured chunk
        size, else the tail's own bucket."""
        c = self.ecfg.prefill_chunk_tokens
        return int(c) if c is not None \
            else self.bucket_for(prompt_len - start)

    def _run_prefill(self, ids: np.ndarray, row: np.ndarray, slot=None,
                     req: GenerateRequest | None = None,
                     start: int = 0) -> int:
        """Prefill ``ids`` into ``row``'s pages from position ``start`` on
        and return the first token (its one readback): one-shot bucketed
        from 0, or chunk-program calls from ``start`` on, back to back (a
        prefix hit's tail, or a prompt longer than the configured chunk
        when the caller has no steps to interleave the chunks with), each
        of the configured chunk size, else of the tail's bucket
        (`_tail_chunk`). A tail's queries attend over the shared pages and
        their own writes, masked by absolute position. ``slot`` / ``req``
        None (`prefill_export`): the key buffer's scratch row B and the
        greedy first token, as in the JAX engine."""
        if start or self._use_chunked(ids.size):
            c = self._tail_chunk(ids.size, start)
            for done in range(start, ids.size, c):
                tok = self._run_chunk(ids, done, row, slot, req, c)
        else:
            entry = self._pack_prefill(ids, row, slot, req)
            entry(self)
            tok = entry.tok
            self._count("prefills")
            self._count("prefill_tokens", ids.size)
            if req is not None:
                req.u_prefill_computed += int(ids.size)
        tb = time.perf_counter()
        first = int(tok)                        # the prefill's one readback
        self._blocked_s += time.perf_counter() - tb
        self._count("d2h_transfers")
        return first

    def _run_chunk(self, ids: np.ndarray, done: int, row: np.ndarray,
                   slot=None, req: GenerateRequest | None = None,
                   c: int | None = None):
        """Run ONE prefill chunk (``ids[done:done+c]`` against page ``row``;
        ``c`` defaults to the configured chunk size) and return its first
        token on the device when it is the FINAL chunk (no readback here),
        else None: only the final chunk's draw is kept, so the chain
        advances once per emitted token."""
        c = int(self.ecfg.prefill_chunk_tokens if c is None else c)
        entry, n, final = self._pack_chunk(ids, done, row, slot, req, c)
        entry(self)
        self._count("prefill_chunks")
        self._count("prefill_tokens", n)
        if req is not None:
            req.u_prefill_computed += n
        return entry.tok if final else None

    # ---------------------------------------------------------- requests

    def submit(self, prompt_ids, max_new_tokens=32, trace=None, cache=True,
               speculate=True, deadline_s=None, request_key=None,
               temperature=1.0, top_k=0, seed=0) -> GenerateRequest:
        """Queue one prompt (1-D or [1, S] int array). Thread-safe. The
        parameters are the JAX engine's, in its order.

        ``trace``: a `RequestTrace` made upstream (a server's acceptor), so
        that the SLO clock starts there; by default it starts here.
        ``cache=False`` keeps this prompt out of the prefix cache (it
        neither reuses nor registers pages). ``speculate=False`` keeps this
        request out of n-gram drafting on a speculating engine.
        ``deadline_s`` bounds the request end to end: past it the engine
        retires it with a typed ``DeadlineExceeded`` (at admission, so an
        expired request never reaches a prefill program, at each step's
        start and at each harvest). Raises a typed ``Overloaded`` when the
        queue is past ``EngineConfig.max_queue_depth`` /
        ``max_queue_tokens``.

        ``request_key``: a client-generated 16-byte idempotency key. A
        resubmit of a key whose request is still IN FLIGHT returns the
        SAME `GenerateRequest` (``dedup_hits``); a key that COMPLETED
        replays the answer or typed error verbatim (``dedup_replays``); a
        key whose attempt was CANCELLED executes again. Dedup hits bypass
        admission control: attaching to work already paid for costs
        nothing, so a draining or shedding engine still answers them.

        ``temperature`` / ``top_k`` / ``seed`` need
        ``EngineConfig(sampling=True)``: the semantics and key chain of the
        JAX package's `fast_generate` (temperature before the top-k mask,
        one split of ``PRNGKey(seed)`` per sampled token). Sampled
        parameters on an engine without ``sampling`` raise ValueError:
        there is no host-sampled path."""
        ids = np.ascontiguousarray(np.asarray(prompt_ids)).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        if not np.issubdtype(ids.dtype, np.integer):
            raise ValueError(f"prompt ids must be integers, got {ids.dtype}")
        if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt ids must lie in [0, "
                             f"{self.cfg.vocab_size}), got [{ids.min()}, "
                             f"{ids.max()}]")
        ids = ids.astype(np.int32)
        n = int(max_new_tokens)
        if n < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n}: a "
                             "request that can never emit would occupy a "
                             "slot it can never retire from")
        if ids.size + n > self.max_seq_len:
            raise ValueError(
                f"prompt {ids.size} + max_new_tokens {n} exceeds engine "
                f"max_seq_len={self.max_seq_len}")
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self._check_sample_params(temperature, top_k)
        key = self._dedup_key(request_key)
        req = GenerateRequest(ids, n, trace=trace, cache=cache,
                              speculate=speculate, deadline_s=deadline_s,
                              request_key=key, temperature=temperature,
                              top_k=top_k, seed=seed)
        # double-checked admission: the first check fails a shed, dead or
        # draining submit fast, BEFORE the O(prompt) hash pass; the hash
        # then runs on the submitter's thread with no lock held, and the
        # second check, atomic with the enqueue, re-validates. The dedup
        # lookup runs before each check: an attach or a replay must succeed
        # on a draining or full engine
        sample = (float(temperature), int(top_k), int(seed))
        with self._qlock:
            prev = self._dedup_lookup(key, ids, n, sample)
            if prev is not None:
                return prev
            self._check_admission(ids.size)
        if self._prefix_enabled and req.cache:
            req.page_hashes = prompt_page_hashes(ids, self.ecfg.page_size)
        with self._work:
            # two concurrent resubmits of one key must not both enqueue
            prev = self._dedup_lookup(key, ids, n, sample)
            if prev is not None:
                return prev
            self._check_admission(ids.size)
            # trace marks and ring entries only for ACCEPTED submits: a
            # refused one must not leave a never-retired request in a
            # watchdog dump
            req.trace.mark_submit()
            flight.record("engine.submit", request_id=req.request_id,
                          prompt_len=int(ids.size), max_new_tokens=n)
            self._queue.append(req)
            self._queue_tokens += int(ids.size)
            self._g_queue.set(len(self._queue))
            self._register_dedup(key, req)
            self._count("requests")
            self._work.notify()
        return req

    def _check_sample_params(self, temperature, top_k):
        """Refuse sampling parameters the engine cannot honour: a silent
        greedy fallback would return tokens of the wrong distribution."""
        t, k = float(temperature), int(top_k)
        if not t > 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        if k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if (t != 1.0 or k != 0) and not self._sampling:
            raise ValueError(
                "sampled generation (temperature/top_k) needs "
                "EngineConfig(sampling=True): the fused sampler runs in the "
                "step on the device, not in a per-step host round trip")

    # ------------------------------------------------ idempotency dedup

    def _dedup_key(self, request_key) -> bytes | None:
        """Normalize and check one request key (None passes through;
        dedup turned off drops it)."""
        if request_key is None or not self.ecfg.dedup_capacity:
            return None
        key = bytes(request_key)
        if len(key) != 16:
            raise ValueError(
                f"request_key must be exactly 16 bytes, got {len(key)}")
        return key

    def _dedup_lookup(self, key: bytes | None, ids: np.ndarray, mnt: int,
                      sample: tuple) -> GenerateRequest | None:
        """One dedup probe (the caller holds ``_qlock``): the request to
        attach to or replay, or None for a miss. A key reused for another
        prompt, budget or (temperature, top_k, seed) is a client bug and
        raises: answering with another request's tokens would be worse
        than failing."""
        if key is None:
            return None
        prev = self._dedup.get(key)
        if prev is None:
            return None
        if not prev.imported and (
                prev.max_new_tokens != int(mnt)
                or not np.array_equal(prev.prompt, ids)
                or sample != (prev.temperature, prev.top_k, prev.seed)):
            raise ValueError(
                "request_key reused for a different request (prompt, "
                "max_new_tokens, or temperature/top_k/seed mismatch) — "
                "an idempotency key names ONE logical request")
        if not prev.done:
            self._dedup.move_to_end(key)
            self._count("dedup_hits")
            # a pending cancel of the first attempt is void: the resubmit
            # is the evidence that the client still wants the answer
            self._cancels.pop(prev.request_id, None)
            flight.record("engine.dedup_attach",
                          request_id=prev.request_id)
            return prev
        if prev._error is not None and prev._error.startswith("Cancelled"):
            # a cancelled attempt produced no answer: the resubmit is a
            # fresh attempt, registered anew
            del self._dedup[key]
            return None
        self._dedup.move_to_end(key)
        self._count("dedup_replays")
        flight.record("engine.dedup_replay", request_id=prev.request_id)
        return prev

    def _register_dedup(self, key: bytes | None, req: GenerateRequest):
        """Remember a freshly accepted keyed request (the caller holds
        ``_qlock``); LRU-evict past the configured bound."""
        if key is None:
            return
        self._dedup[key] = req
        self._dedup.move_to_end(key)
        while len(self._dedup) > int(self.ecfg.dedup_capacity):
            self._dedup.popitem(last=False)

    # ------------------------------------------------- admission control

    def _refuse_not_accepting(self):
        """The typed not-taking-work refusals (stopped, draining). The
        caller holds ``_qlock``."""
        if self._dead is not None:
            raise RuntimeError(f"engine stopped: {self._dead}")
        if self._draining:
            raise RuntimeError(
                "engine draining: not accepting new requests")

    def _check_admission(self, n_tokens: int):
        """Refuse or pass one submit (the caller holds ``_qlock``): the
        not-accepting refusals, then the SHED rung of the pressure ladder,
        a typed, resubmittable ``Overloaded`` past a queue bound."""
        self._refuse_not_accepting()
        mqd, mqt = self.ecfg.max_queue_depth, self.ecfg.max_queue_tokens
        if mqd is not None and len(self._queue) >= int(mqd):
            self._count("shed")
            raise Overloaded(
                f"engine queue full: depth {len(self._queue)} >= "
                f"max_queue_depth {int(mqd)}")
        # a backlog bound only: an EMPTY queue always admits
        if mqt is not None and self._queue and \
                self._queue_tokens + n_tokens > int(mqt):
            self._count("shed")
            raise Overloaded(
                f"engine queue full: {self._queue_tokens} queued + "
                f"{n_tokens} new tokens > max_queue_tokens {int(mqt)}")

    def cancel(self, request_id: str,
               reason: str = "cancelled by client") -> bool:
        """Cancel a queued or running request by id. Thread-safe: posts to
        the loop's cancellation mailbox; the loop's thread retires the request
        and frees its pages between fixed-shape steps (`_reap`; shared
        prefix pages through the per-owner refcounted free, never under a
        sharer). Returns True when the id names a request the engine still
        owes an answer, False for an unknown or finished one (a
        retirement racing the cancel is a no-op). The post is
        unconditional: a request caught mid-admission is in neither the
        queue nor a slot, and its cancel must still land. A migration
        import still in the mailbox (`submit_import`) is cancellable too."""
        with self._work:
            if self._dead is not None:
                return False
            self._cancels[request_id] = reason
            known = any(r.request_id == request_id for r in self._queue) \
                or any(r.request_id == request_id for _, r in self._imports)
            self._work.notify()
        # slot membership is the loop thread's; a stale True only means the
        # reap finds nothing
        return known or any(
            r is not None and r.request_id == request_id and not r.done
            for r in self._slot_req)

    def _reap(self):
        """The loop's enforcement point at each step's start, before
        admission and dispatch: apply posted cancellations and expire
        blown deadlines. A queued request leaves the queue before any
        prefill (``prefill_tokens`` does not move for it), and a
        migration import leaves the mailbox before it claims a slot; a
        slotted one, decoding or still chunk-prefilling, retires between
        steps and runs no further step or chunk."""
        with self._qlock:
            cancels, self._cancels = self._cancels, {}
            now = time.monotonic()
            drop = []
            for req in self._queue:
                if req.request_id in cancels:
                    drop.append((req, f"Cancelled: "
                                      f"{cancels[req.request_id]}"))
                elif req.expired(now):
                    drop.append((req, self._deadline_error(req)))
            for req, _ in drop:
                self._queue.remove(req)
                self._queue_tokens -= int(req.prompt.size)
            if drop:
                self._g_queue.set(len(self._queue))
            # filtered by request id, never `deque.remove`: equality of
            # two (KVHandoff, request) entries would compare page arrays
            drop_imports = [req for _, req in self._imports
                            if req.request_id in cancels]
            if drop_imports:
                keep = [(h, req) for h, req in self._imports
                        if req.request_id not in cancels]
                self._imports.clear()
                self._imports.extend(keep)
        for req, err in drop:
            self._count_reap(err)
            flight.record("engine.reap", request_id=req.request_id,
                          where="queue", error=err)
            req._finish(err)
        for req in drop_imports:
            err = f"Cancelled: {cancels[req.request_id]}"
            self._count_reap(err)
            flight.record("engine.reap", request_id=req.request_id,
                          where="import_mailbox", error=err)
            req._finish(err)
        now = time.monotonic()
        for slot in range(self.ecfg.max_slots):
            req = self._slot_req[slot]
            if req is None or req.done:
                continue
            if req.request_id in cancels:
                err = f"Cancelled: {cancels[req.request_id]}"
            elif req.expired(now):
                err = self._deadline_error(req)
            else:
                continue
            self._count_reap(err)
            flight.record("engine.reap", request_id=req.request_id,
                          where="slot", error=err)
            self._retire(slot, error=err)

    @staticmethod
    def _deadline_error(req: GenerateRequest) -> str:
        return (f"DeadlineExceeded: request deadline "
                f"({req.deadline_s:g}s) passed after "
                f"{len(req.generated)} generated tokens")

    def _count_reap(self, err: str):
        self._count("deadline_exceeded" if err.startswith(
            "DeadlineExceeded") else "cancelled")

    # ------------------------------------------------ degradation ladder

    def _pressure(self) -> float:
        """Queue pressure: the occupied fraction of whichever admission
        bound is closest to tripping (the caller holds ``_qlock``); 0.0
        without a bound (the ladder has no yardstick then)."""
        frac = 0.0
        if self.ecfg.max_queue_depth:
            frac = max(frac, len(self._queue)
                       / int(self.ecfg.max_queue_depth))
        if self.ecfg.max_queue_tokens:
            frac = max(frac, self._queue_tokens
                       / int(self.ecfg.max_queue_tokens))
        return frac

    def _apply_degradation(self):
        """Degrade before shedding: level 1 (pressure >= 0.5) stops
        drafting (the same warm verify step runs with no drafts), level 2
        (>= 0.75) also stops retaining prefix pages and returns the idle
        ones to the free list, demoting them to the KV tiers first when
        configured; level 3 (>= 1.0) is the shed threshold `submit`
        enforces. Levels fall back as the queue drains. Loop thread only."""
        with self._qlock:
            frac = self._pressure()
        target = 3 if frac >= 1.0 else 2 if frac >= 0.75 \
            else 1 if frac >= 0.5 else 0
        if target == self._deg:
            return
        if target >= 2 > self._deg:
            self._shrink_prefix()
        self._deg = target
        self._g_deg.set(target)
        flight.record("engine.degradation", level=target,
                      pressure=round(frac, 3))

    def _shrink_prefix(self):
        """Level >= 2: every IDLE cached page back to the free list, with
        the bookkeeping of a pressure eviction (a demotion when tiers are
        configured); live slots' pages only lose their index, through the
        retain hook declining them at retirement."""
        idle = self._evict_prefix_pages(len(self._prefix_idle))
        if idle:
            self.allocator.reclaim(idle)

    @property
    def gauges(self) -> dict:
        """The JAX engine's gauges of the lifecycle, under its names
        without ``engine.``: the applied degradation level, the queue's
        depth and the decode steps in flight."""
        return {"degradation_level": self._deg,
                "queue_depth": len(self._queue),
                "steps_in_flight": len(self._inflight)}

    def _free_slots(self):
        # occupancy, not the dispatch mask
        return [i for i in range(self.ecfg.max_slots)
                if self._slot_req[i] is None]

    def _occupied(self) -> bool:
        return any(r is not None for r in self._slot_req)

    def _admit(self):
        """Drain the queue into free slots while pages allow: assign a slot,
        attach the longest cached prefix, allocate fresh pages for the
        rest, re-upload what the KV tiers hold, prefill the uncached tail
        (or start a chunked prefill), seed the first token."""
        ps = self.ecfg.page_size
        while True:
            slots = self._free_slots()
            if not slots:
                return
            with self._qlock:
                if not self._queue:
                    self._g_queue.set(0)
                    return
                req = self._queue[0]
                if req.done or req.expired():
                    # finished (an abort) or expired while queued: skipped
                    # BEFORE any prefill runs, zero prefill tokens spent
                    self._queue.popleft()
                    self._queue_tokens -= int(req.prompt.size)
                    self._g_queue.set(len(self._queue))
                    if not req.done:
                        err = self._deadline_error(req)
                        self._count_reap(err)
                        flight.record("engine.reap",
                                      request_id=req.request_id,
                                      where="admission", error=err)
                        req._finish(err)
                    continue
                total = -(-(req.prompt.size + req.max_new_tokens) // ps)
                use_cache = self._prefix_enabled and req.cache
                shared: list[int] = []
                if use_cache:
                    # the page of the LAST prompt token is never shared: the
                    # tail prefill needs >= 1 token to give the first output
                    shared = self._prefix_lookup(req.page_hashes)[
                        :(req.prompt.size - 1) // ps]
                if shared:
                    # claim before alloc: alloc may evict idle cached
                    # pages, and claimed ones are live
                    self._attach_prefix(shared)
                pages = self.allocator.alloc(total - len(shared))
                if pages is None:
                    if shared:
                        self.allocator.free(shared)    # back to idle
                    if not (self._occupied() or self._inflight):
                        # nothing will ever retire to free pages: the pool
                        # itself is too small for this request
                        self._queue.popleft()
                        self._queue_tokens -= int(req.prompt.size)
                        self._g_queue.set(len(self._queue))
                        req._finish(error=f"request needs {total} pages, "
                                    f"pool has "
                                    f"{self.allocator.num_pages - 1}")
                        continue
                    return                 # wait for a retirement
                if use_cache:
                    self._count("prefix_hit" if shared
                                else "prefix_miss")
                    self._count("prefix_pages_reused", len(shared))
                self._queue.popleft()
                self._queue_tokens -= int(req.prompt.size)
                self._g_queue.set(len(self._queue))
            self._h_wait.observe(time.perf_counter() - req.submit_t)
            n_up = self._tier_reupload(req.page_hashes, req.prompt.size,
                                       shared, pages) if use_cache else 0
            self._place(req, slots[0], shared + pages, len(shared) + n_up)

    def _place(self, req: GenerateRequest, slot: int, pages: list[int],
               n_shared: int):
        """``pages``: the slot's allocation in token order, ``n_shared``
        leading pages already holding the prompt's KV (attached or
        re-uploaded). The prefill covers only the positions after them."""
        req.trace.mark_admitted()
        flight.record("engine.admit", request_id=req.request_id,
                      slot=slot, pages=len(pages), shared=n_shared,
                      prompt_len=int(req.prompt.size))
        cached = n_shared * self.ecfg.page_size
        row = np.full(self.pages_per_slot, TRASH_PAGE, np.int32)
        row[:len(pages)] = pages
        self._page_table[slot] = row
        self._slot_req[slot] = req
        self._slot_pages[slot] = pages
        # usage: the prompt tokens the caches answered, and the step clock
        # at placement (the page-step integral closes at `_detach_slot`)
        req.u_prefill_saved = min(cached, int(req.prompt.size))
        req.u_admit_step = self.step_seq
        if self._sampling:
            self._temps[slot] = req.temperature
            self._topks[slot] = req.top_k
        if self._use_chunked(req.prompt.size - cached):
            # decode-priority chunked prefill: the slot holds its pages but
            # stays decode-inactive; step() runs ONE chunk per step after
            # the decode step until the prompt is cached. A prefix hit
            # starts the chunk cursor after the shared pages
            self._lengths[slot] = 0
            self._prefilling[slot] = {"req": req, "done": cached,
                                      "t0": time.perf_counter()}
            return
        t0 = time.perf_counter()
        first = self._run_prefill(req.prompt, row, slot, req, start=cached)
        self._h_prefill.observe(time.perf_counter() - t0)
        self._seed_first_token(slot, req, first)

    def _seed_first_token(self, slot: int, req: GenerateRequest, first: int):
        """Prefill finished: activate the slot for decode and deliver the
        first generated token."""
        self._lengths[slot] = req.prompt.size
        self._tokens[slot] = first
        self._active[slot] = True
        self._fresh[slot] = True
        self._budget[slot] = req.max_new_tokens - 1
        if self._spec and req.speculate:
            # O(prompt) once here, O(1) per token after: the drafter never
            # rescans the history inside the step loop
            idx = _DraftIndex(req.prompt)
            idx.append(first)
            self._slot_draft[slot] = idx
        req.generated.append(first)
        req.first_token_t = time.perf_counter()
        req.trace.mark_first_token()
        req.u_generated += 1
        self._count("tokens")
        if self._prefix_enabled and req.cache:
            # the prompt's full pages are resident and final: index them
            # (a hit's shared leading pages are indexed already)
            self._register_prefix(req.page_hashes, self._slot_pages[slot])
        if req.max_new_tokens == 1 or first == self.ecfg.eos_id:
            self._retire(slot)

    def _advance_prefill(self) -> bool:
        """Run ONE prefill chunk for the oldest prefilling slot, after the
        decode step (decode-priority). Returns True when a chunk ran."""
        if not self._prefilling:
            return False
        slot = next(iter(self._prefilling))
        st = self._prefilling[slot]
        req = st["req"]
        c = int(self.ecfg.prefill_chunk_tokens)
        tok = self._run_chunk(req.prompt, st["done"], self._page_table[slot],
                              slot, req)
        st["done"] = min(st["done"] + c, req.prompt.size)
        if tok is not None:                    # the final chunk's token
            del self._prefilling[slot]
            tb = time.perf_counter()
            first = int(tok)                   # the prefill's one readback
            self._blocked_s += time.perf_counter() - tb
            self._count("d2h_transfers")
            self._h_prefill.observe(time.perf_counter() - st["t0"])
            self._seed_first_token(slot, req, first)
        return True

    def _detach_slot(self, slot: int):
        """Release a slot's pages and mirrors without touching the request
        future."""
        self._prefilling.pop(slot, None)
        req = self._slot_req[slot]
        if req is not None and req.u_admit_step is not None:
            # the occupancy integral, closed at once: pages held x steps
            # held, so the step loop never does usage work
            req.u_page_steps += len(self._slot_pages[slot]) * max(
                0, self.step_seq - req.u_admit_step)
            req.u_admit_step = None
        self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_req[slot] = None
        self._slot_draft[slot] = None
        self._active[slot] = False
        self._fresh[slot] = False
        self._budget[slot] = 0
        self._page_table[slot] = TRASH_PAGE
        self._lengths[slot] = 0
        self._temps[slot] = 1.0        # greedy defaults; the stale key row
        self._topks[slot] = 0          # is re-seeded at the next prefill

    def _retire(self, slot: int, error: str | None = None):
        req = self._slot_req[slot]
        self._detach_slot(slot)
        if req is not None:
            flight.record("engine.retire", request_id=req.request_id,
                          slot=slot, tokens=len(req.generated), error=error)
            req._finish(error)

    # -------------------------------------------------------------- step

    def _packed_state(self, drafts=None, draft_lens=None):
        """The step's one upload, written into the next host buffer of the
        ring, every column of it: per slot (token, length, flags[, draft
        length, K drafts], page-table row[, temperature bits, top_k])."""
        maxp = self.pages_per_slot
        lead = _STATE_COLS if drafts is None else _SPEC_COLS + self._spec_k
        # the next host buffer of the ring, once its last upload is done
        # (at most `_window` - 1 steps are in flight here and the buffer's
        # step was harvested, so on a card the wait returns at once)
        self._state_i = (self._state_i + 1) % self._window
        event = self._state_uploaded[self._state_i]
        if event is not None:
            event.synchronize()
        self._state_host = self._state_ring[self._state_i]
        packed = self._state_host.numpy()
        packed[:, _COL_TOKEN] = self._tokens
        packed[:, _COL_LENGTH] = self._lengths
        packed[:, _COL_FLAGS] = (self._active.astype(np.int32) * _FLAG_ACTIVE
                                 | self._fresh.astype(np.int32) * _FLAG_FRESH)
        if drafts is not None:
            packed[:, _COL_DRAFT] = draft_lens
            packed[:, _SPEC_COLS:lead] = drafts
        packed[:, lead:lead + maxp] = self._page_table
        if self._sampling:
            packed[:, lead + maxp] = self._temps.view(np.int32)
            packed[:, lead + maxp + 1] = self._topks

    def _unpack(self, state, lead):
        """Device views of an uploaded `_packed_state` whose page-table row
        starts at column ``lead``: (active, tokens with the fresh ones
        overridden, cache dict, (temperatures, top_ks) or None)."""
        maxp = self.pages_per_slot
        flags = state[:, _COL_FLAGS]
        active = (flags & _FLAG_ACTIVE) != 0
        fresh = (flags & _FLAG_FRESH) != 0
        toks = torch.where(fresh, state[:, _COL_TOKEN], self._tok_dev)
        cache = dict(k_pages=self._kc, v_pages=self._vc,
                     page_table=state[:, lead:lead + maxp].contiguous(),
                     lengths=state[:, _COL_LENGTH], **self._scales())
        params = None
        if self._sampling:
            temps = state[:, lead + maxp].contiguous().view(torch.float32)
            params = (temps, state[:, lead + maxp + 1])
        return active, toks, cache, params

    def _decode_body(self):
        """The decode step program: from the uploaded state to the next
        tokens, written into ``_tok_dev`` (and the advanced key chains into
        ``_keys_dev``) in place. Returns the logits [B, V]."""
        B = self.ecfg.max_slots
        active, toks, cache, sample = self._unpack(self._state_dev,
                                                   _STATE_COLS)
        logits, _ = gpt_mod.decode_step(self._params, toks, cache, active,
                                        cfg=self.cfg)
        if sample is None:
            nxt = logits.argmax(dim=-1)
        else:
            keys = self._keys_dev[:B]
            nxt, new_keys = smp.fused_sample(logits, keys, *sample)
            keys.copy_(torch.where(active[:, None], new_keys, keys))
        self._tok_dev.copy_(torch.where(active, nxt.to(torch.int32), toks))
        return logits

    def _dispatch(self):
        """Run ONE fixed-shape decode step from one fused upload, through
        the decode entry (a graph replay on the card), and queue its
        tokens' readback: right after the replay they are copied from
        ``_tok_dev``, which the next step overwrites, into the step's slot
        of the token ring, whose event `_harvest_one` waits on. The step
        joins the in-flight window with the slots to harvest."""
        exe = self._decode_exe()
        self._packed_state()
        self._upload_state()
        t0 = time.perf_counter()
        exe(self)
        j = self._tok_i = (self._tok_i + 1) % self._window
        self._tok_ring[j].copy_(self._tok_dev, non_blocking=True)
        if self._tok_copied[j] is not None:
            self._tok_copied[j].record()
        snapshot = [(int(i), self._slot_req[i])
                    for i in np.flatnonzero(self._active)]
        self._inflight.append((j, snapshot))
        self._g_inflight.set(len(self._inflight))
        # host bookkeeping for the step: each active slot advances one
        # position; a slot at its token budget stops being dispatched but
        # stays occupied until its tokens are harvested
        self._lengths[self._active] += 1
        self._budget[self._active] -= 1
        self._fresh[:] = False
        self._active &= self._budget > 0
        self._count("steps")
        metrics.add_span("engine.dispatch", t0, time.perf_counter() - t0,
                         cat="engine")

    def _harvest_one(self) -> int:
        """Block on the OLDEST in-flight step's tokens (its ring slot's
        event; the only blocking readback of the loop) and deliver them:
        append to each snapshot request, retire slots that hit
        max_new_tokens or EOS, or whose deadline passed. A token for a
        request already retired (EOS seen in an earlier step of the
        window, or a cancel) is discarded. Returns the tokens delivered."""
        j, snapshot = self._inflight.popleft()
        self._g_inflight.set(len(self._inflight))
        tb = time.perf_counter()
        if self._tok_copied[j] is not None:
            self._tok_copied[j].synchronize()
        toks = self._tok_ring[j].tolist()
        self._blocked_s += time.perf_counter() - tb
        self._count("d2h_transfers")
        n = 0
        for slot, req in snapshot:
            if req.done or self._slot_req[slot] is not req:
                continue
            tok = toks[slot]
            req.generated.append(tok)
            req.trace.mark_tokens(1)
            req.u_generated += 1
            n += 1
            if len(req.generated) >= req.max_new_tokens \
                    or tok == self.ecfg.eos_id:
                self._retire(slot)
            elif req.expired():
                # the tokens already cost device time, but nobody inside
                # the deadline will read them
                err = self._deadline_error(req)
                self._count_reap(err)
                self._retire(slot, error=err)
        self._count("tokens", n)
        return n

    def _drain_window(self):
        """Harvest every step in flight."""
        while self._inflight:
            self._harvest_one()

    # ------------------------------------------------------ speculative step

    def _drafts(self):
        """The n-gram drafts of the active slots for the next verify step:
        ``(drafts [B, K], draft_lens [B])`` int32, each slot's at most its
        budget less one; none from degradation level 1 on."""
        K, B = self._spec_k, self.ecfg.max_slots
        drafts = np.zeros((B, K), np.int32)
        draft_lens = np.zeros(B, np.int32)
        # degradation level >= 1: no drafts (the same warm verify step
        # emits one token a slot; the ladder never captures anything)
        active = () if self._deg >= 1 else np.flatnonzero(self._active)
        for slot in active:
            idx = self._slot_draft[slot]
            budget = int(self._budget[slot])   # tokens this step may emit
            if idx is None or budget <= 1:
                continue                       # <= 1 left: drafting is waste
            d = idx.draft(K)
            n = min(len(d), K, budget - 1)
            if n > 0:
                drafts[slot, :n] = d[:n]
                draft_lens[slot] = n
        return drafts, draft_lens

    def _dispatch_spec(self):
        """Run ONE verify step: draft on the host (n-gram), one fused upload,
        the verify entry on the device (a graph replay on the card).
        Returns the device handles of the emitted tokens and their counts
        (the [B, K+2] ``_spec_out``) and the slots to harvest; the harvest
        follows in the same step, since the next drafts need these
        tokens."""
        drafts, draft_lens = self._drafts()
        exe = self._verify_exe()
        self._packed_state(drafts, draft_lens)
        self._upload_state()
        t0 = time.perf_counter()
        out = exe(self)
        snapshot = [(int(i), self._slot_req[i])
                    for i in np.flatnonzero(self._active)]
        self._fresh[:] = False
        self._count("steps")
        self._count("spec_steps")
        self._count("spec_drafted", int(draft_lens.sum()))
        metrics.add_span("engine.dispatch", t0, time.perf_counter() - t0,
                         cat="engine")
        return out, snapshot

    def _verify_body(self):
        """The verify step program: from the uploaded state to the emitted
        tokens and their counts, written into ``_spec_out`` [B, K+2] (and
        the advanced key chains into ``_keys_dev``) in place. Returns
        ``_spec_out``."""
        K, B = self._spec_k, self.ecfg.max_slots
        state = self._state_dev
        active, tok0, cache, sample = self._unpack(state, _SPEC_COLS + K)
        tok_seq = torch.cat([tok0[:, None], state[:, _SPEC_COLS:_SPEC_COLS
                                                  + K]], dim=1)
        draft_len = state[:, _COL_DRAFT]
        if sample is None:
            emitted, n_emit, _ = gpt_mod.verify_step(
                self._params, tok_seq, draft_len, cache, active, cfg=self.cfg)
        else:
            keys = self._keys_dev[:B]
            emitted, n_emit, _, new_keys = gpt_mod.verify_step(
                self._params, tok_seq, draft_len, cache, active, cfg=self.cfg,
                sample_state=(keys, *sample))
            keys.copy_(new_keys)
        self._spec_out[:, :K + 1].copy_(emitted)
        self._spec_out[:, K + 1].copy_(n_emit)
        return self._spec_out

    def _harvest_spec(self, out_dev, snapshot):
        """Read the verify step's tokens back (ONE readback: the emitted
        tokens and their count) and apply them: 1..k+1 tokens a slot,
        clamped to its budget and cut after EOS. Lengths move forward by
        exactly what was kept, so rejected drafts sit past every live
        position until a later step writes them. The host is the authority
        on each slot's next token from here (``_fresh``), so the verify
        step leaves ``_tok_dev`` alone. Returns the tokens delivered."""
        tb = time.perf_counter()
        out = out_dev.cpu().numpy()
        self._blocked_s += time.perf_counter() - tb
        self._count("d2h_transfers")
        harvested = accepted = 0
        for slot, req in snapshot:
            if req.done or self._slot_req[slot] is not req:
                continue
            n = min(int(out[slot, -1]), int(self._budget[slot]))
            toks = [int(t) for t in out[slot, :n]]
            if self.ecfg.eos_id is not None and self.ecfg.eos_id in toks:
                toks = toks[:toks.index(self.ecfg.eos_id) + 1]
            n = len(toks)
            req.generated.extend(toks)
            idx = self._slot_draft[slot]
            if idx is not None:
                for t in toks:
                    idx.append(t)
            req.trace.mark_tokens(n)
            req.u_generated += n
            req.u_spec_accepted += n - 1
            harvested += n
            accepted += n - 1
            self._lengths[slot] += n
            self._budget[slot] -= n
            self._tokens[slot] = toks[-1]
            self._fresh[slot] = True
            if self._budget[slot] <= 0 or toks[-1] == self.ecfg.eos_id \
                    or len(req.generated) >= req.max_new_tokens:
                self._retire(slot)
            elif req.expired():
                err = self._deadline_error(req)
                self._count_reap(err)
                self._retire(slot, error=err)
        self._count("tokens", harvested)
        self._count("spec_accepted", accepted)
        # the JAX gauge: the registry's cumulative counts, every engine of
        # the process
        drafted = self._m["spec_drafted"].value
        if drafted:
            self._g_spec_rate.set(self._m["spec_accepted"].value / drafted)
        if snapshot:
            self._g_spec_tps.set(harvested / len(snapshot))
        return harvested

    def check_step_graph(self):
        """The next decode (or verify) step run twice from one state, to
        hold the card's captured graph against its eager body: first
        through the program entry (a graph replay), then, with every
        buffer the step writes restored, through the body run eagerly
        (steps in flight are harvested first).
        The buffers are restored again after, and no host mirror moves, so
        the engine serves on as if nothing ran. Returns ``(graph, eager)``,
        each ``{"tokens", "keys", "logits", "pools"}``: the tokens
        written (``_tok_dev``, or ``_spec_out`` [B, K+2]), the key chains
        (or None), the decode logits (None for a verify step) and the
        pools with their scales, copies on the engine's device."""
        self._drain_window()
        if not self._active.any():
            raise ValueError("check_step_graph: no slot is decoding")
        if self._spec:
            exe, body = self._verify_exe(), DecodeEngine._verify_body
            self._packed_state(*self._drafts())
        else:
            exe, body = self._decode_exe(), DecodeEngine._decode_body
            self._packed_state()

        def run(program):
            self._upload_state()
            logits = program(self)
            return None if self._spec else logits
        return self._from_one_state(
            self._spec_out if self._spec else self._tok_dev,
            (lambda: run(exe), lambda: run(body)))

    def _from_one_state(self, tokens, runs):
        """Each of ``runs`` (a function that uploads and runs a program and
        returns its logits, or None) from the engine's state as it is now:
        the pools, the key chains and ``tokens`` (the buffer the program
        writes its token(s) into) are restored before each run and after
        the last, so the engine serves on as if nothing ran. Returns one
        ``{"tokens", "keys", "logits", "pools"}`` a run, copies on the
        engine's device."""
        pools = [t for t in (self._kc, self._vc, self._ks, self._vs)
                 if t is not None]
        written = pools + [t for t in (tokens, self._keys_dev)
                           if t is not None]
        saved = [t.clone() for t in written]
        out = []
        for run in runs:
            for t, s in zip(written, saved):
                t.copy_(s)
            logits = run()
            out.append({
                "tokens": tokens.clone(),
                "keys": None if self._keys_dev is None
                else self._keys_dev.clone(),
                "logits": None if logits is None else logits.clone(),
                "pools": [t.clone() for t in pools]})
        for t, s in zip(written, saved):
            t.copy_(s)
        return tuple(out)

    def check_prefill_graph(self, prompt_ids, start: int = 0,
                            temperature: float = 1.0, top_k: int = 0,
                            seed: int = 0):
        """A prefill program run twice from one state, to hold the card's
        captured graph against its eager body as `check_step_graph` does
        for the step: the one-shot program over ``prompt_ids`` (``start``
        0), or ONE chunk from ``start`` at a prefix tail's chunk size
        (`_tail_chunk`; final when it reaches the prompt's end), for a
        request with these sampling parameters in slot 0 over pages 1.. of
        the pool, after the steps in flight are harvested. Every buffer the
        program writes (pools, key chains, the entry's token) is restored
        after, and neither a host mirror nor a
        counter moves, but the program cache's (an entry it builds
        stays). Returns ``(graph, eager)``, each ``{"tokens",
        "keys", "logits", "pools"}``, copies on the engine's device."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        self._check_sample_params(temperature, top_k)
        self._drain_window()
        req = GenerateRequest(ids, 1, temperature=temperature, top_k=top_k,
                              seed=seed)
        npages = -(-ids.size // self.ecfg.page_size)
        if npages > min(self.pages_per_slot, self.allocator.num_pages - 1):
            raise ValueError(f"check_prefill_graph: {ids.size} tokens need "
                             f"{npages} pages, more than a slot or the pool")
        row = np.full(self.pages_per_slot, TRASH_PAGE, np.int32)
        row[:npages] = np.arange(1, npages + 1)
        if start:
            entry = self._pack_chunk(ids, start, row, 0, req,
                                     self._tail_chunk(ids.size, start))[0]
        else:
            entry = self._pack_prefill(ids, row, 0, req)

        def run(program):
            entry.upload(self, count=False)
            return program(self)
        return self._from_one_state(
            entry.tok, (lambda: run(entry.graph or entry.body),
                        lambda: run(entry.body)))

    def step(self) -> bool:
        """One step, in the JAX engine's order: the fault sites, `_reap`
        (cancels, deadlines), a requested migration export
        (`_do_migrate_out`), the import and prefill-stream mailboxes
        (`_apply_imports`, `_apply_prefill_jobs`), `_apply_degradation`,
        `_admit` (prefills),
        the capacity tripwire, ONE batched decode step (a verify step on a
        speculating engine), at most one prefill chunk, then the harvest
        of the steps past the in-flight window (a verify step's at once).
        Returns False when idle. ``step_seq`` advances on every call; a
        step that did work observes ``engine.step_seconds``, ``host_ms``
        and ``device_ms`` (the time blocked on readbacks) and records an
        ``engine.step`` span and flight event."""
        t_step = time.perf_counter()
        self.step_seq += 1
        self._blocked_s = 0.0
        if faults.ENABLED:
            faults.fire("engine.step_delay")   # armed: sleeps delay_s
            faults.fire("engine.crash")        # armed with exc=: raises
        self._reap()
        if self._migrate_requested:
            self._do_migrate_out()
        self._apply_imports()
        self._apply_prefill_jobs()
        self._apply_degradation()
        self._admit()
        # capacity tripwire: a token at pos >= slot_capacity would spill to
        # the trash page; retire the sequence with an error instead
        for slot in np.flatnonzero(self._active &
                                   (self._lengths >= self.slot_capacity)):
            self._retire(int(slot), error=(
                f"sequence hit slot capacity {self.slot_capacity} "
                f"(pages_per_slot * page_size); token at position "
                f"{int(self._lengths[slot])} cannot be cached"))
        n_active = int(self._active.sum())
        self._g_occupancy.set(n_active)
        if n_active or self._inflight or self._prefilling:
            # idle polls stay out of the ring: an hour of an idle
            # serve_loop must not push out the events of the last work
            flight.record("engine.step", step_seq=self.step_seq,
                          occupancy=n_active, inflight=len(self._inflight))
        harvested = 0
        spec_out = snapshot = None
        if n_active:
            if self._spec:
                spec_out, snapshot = self._dispatch_spec()
            else:
                self._dispatch()
        # decode-priority: the chunk runs AFTER the decode step, so a long
        # prompt adds at most one chunk per step to the running decodes
        chunked = self._advance_prefill()
        if spec_out is not None:
            # the next drafts need these tokens: no window
            harvested += self._harvest_spec(spec_out, snapshot)
        elif n_active:
            while len(self._inflight) >= self._window:
                harvested += self._harvest_one()
        elif self._inflight:
            # nothing to dispatch: drain the window one step at a time so
            # budget-spent slots retire and free their pages
            harvested += self._harvest_one()
        elif not chunked:
            with self._qlock:
                return bool(self._queue) or bool(self._imports) \
                    or bool(self._prefill_jobs)
        dt = time.perf_counter() - t_step
        self._h_step.observe(dt)
        self._h_host.observe((dt - self._blocked_s) * 1e3)
        self._h_device.observe(self._blocked_s * 1e3)
        if harvested:
            self._g_tps.set(harvested / dt if dt > 0 else 0.0)
        metrics.add_span("engine.step", t_step, dt, cat="engine")
        return self._has_work()

    def _has_work(self) -> bool:
        with self._qlock:
            queued = bool(self._queue) or bool(self._imports) \
                or bool(self._prefill_jobs)
        return queued or bool(self._inflight) or bool(self._prefilling) \
            or self._occupied()

    def run_until_idle(self, max_steps: int | None = None):
        """Drive step() until the queue and the slots drain."""
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                raise RuntimeError(
                    f"engine still busy after {max_steps} steps")

    # ---------------------------------------------------------- KV handoff

    def _handoff_ids(self, prompt_ids) -> np.ndarray:
        """A prompt for a prefill without a slot (export or stream): 1-D
        int32, non-empty, with room for at least one token after it."""
        ids = np.ascontiguousarray(np.asarray(prompt_ids)).reshape(-1) \
            .astype(np.int32)
        if ids.size == 0:
            raise ValueError("empty prompt")
        if ids.size >= self.max_seq_len:
            raise ValueError(
                f"prompt {ids.size} leaves no room to decode within "
                f"max_seq_len={self.max_seq_len}")
        return ids

    def _borrow_pages(self, ids: np.ndarray, cache: bool, what: str):
        """Pages for a prefill without a slot, borrowed from the pool: the
        longest cached prefix attached (the last prompt token's page is
        always recomputed), fresh pages for the rest, and what the KV tiers
        hold re-uploaded into the leading fresh ones, counted as
        admission counts them. Returns ``(hashes, shared, pages,
        n_up)``: ``pages`` all of them in token order, of which
        ``len(shared) + n_up`` lead with valid KV. Raises RuntimeError when
        the pool cannot cover the prompt."""
        ps = self.ecfg.page_size
        n_src = -(-ids.size // ps)
        use_cache = self._prefix_enabled and cache
        hashes: list[bytes] = []
        shared: list[int] = []
        if use_cache:
            hashes = prompt_page_hashes(ids, ps)
            shared = self._prefix_lookup(hashes)[:(ids.size - 1) // ps]
            if shared:
                self._attach_prefix(shared)
        pages = self.allocator.alloc(n_src - len(shared))
        if pages is None:
            if shared:
                self.allocator.free(shared)
            raise RuntimeError(
                f"{what} needs {n_src} pages ({len(shared)} cached), "
                f"{self.allocator.free_pages} free")
        n_up = 0
        if use_cache:
            # counted once the prefill can proceed, as `_admit` counts
            self._count("prefix_hit" if shared else "prefix_miss")
            self._count("prefix_pages_reused", len(shared))
            n_up = self._tier_reupload(hashes, ids.size, shared, pages)
        return hashes, shared, shared + pages, n_up

    def _export_host(self, pages: list[int]):
        """The listed pages' K and V (and an int8 pool's scales, else None,
        None) gathered in one `export_pages` call and copied to the host,
        as numpy arrays in the wire blobs' layout ``[nl, n, page_size, nh,
        dh]`` (bfloat16 as int16 of the same bits). The copies synchronize
        with the engine's stream, as the JAX engine's `np.asarray` does."""
        blobs = [_host_array(b) for b in export_pages(
            self._kc, self._vc, pages,
            *((self._ks, self._vs) if self._quant_kv else ()))]
        return tuple(blobs) + ((None, None) if len(blobs) == 2 else ())

    def prefill_export(self, prompt_ids) -> KVHandoff:
        """Run this engine's prefill of ``prompt_ids`` and return it as a
        detached `KVHandoff` instead of entering decode: the prefill half
        of prefill/decode disaggregation. Pages are borrowed from the pool
        for the call (a prefix hit attaches cached ones, as `submit` does)
        and freed before it returns, the freshly prefilled ones staying
        indexed in the prefix store. The first token is the greedy one (a
        slotless prefill writes the key buffer's scratch row). On an int8
        pool the gather of values and scales and their copies to the host
        are observed as ``engine.quant_dequant_ms``. Loop thread only (it
        runs the prefill program)."""
        ids = self._handoff_ids(prompt_ids)
        ps = self.ecfg.page_size
        hashes, shared, pages, n_up = self._borrow_pages(
            ids, True, "prefill_export")
        row = np.full(self.pages_per_slot, TRASH_PAGE, np.int32)
        row[:len(pages)] = pages
        try:
            first = self._run_prefill(ids, row,
                                      start=(len(shared) + n_up) * ps)
            t0 = time.perf_counter()
            k, v, ks, vs = self._export_host(pages)
            if self._quant_kv:
                metrics.histogram("engine.quant_dequant_ms").observe(
                    (time.perf_counter() - t0) * 1e3)
            if self._prefix_enabled:
                # registered before the free, so the retain hook keeps the
                # pages resident: a local submit of the prompt then hits
                self._register_prefix(hashes, pages)
        finally:
            self.allocator.free(pages)
        self._count("kv_exports")
        return KVHandoff(prompt=ids, first_token=first, k_pages=k,
                         v_pages=v, page_size=int(ps),
                         cache_dtype=_dtype_name(self._kc.dtype),
                         k_scales=ks, v_scales=vs)

    # ------------------------------------------------- prefill page stream

    def submit_prefill_stream(self, prompt_ids, cache: bool = True,
                              trace_ctx=None):
        """The send side of disaggregated prefill, thread-safe: post one
        prompt to the prefill-job mailbox and return a `queue.Queue` that
        the loop fills as its prefill runs: ``("count", n_records)``
        first, then ``("rec", bytes)`` for each ``PTKS1`` record as its
        chunk's pages complete (header, page batches, the final record
        with the first token), then ``("done", None)``; a failure ends
        the stream with ``("err", "<Type>: <msg>")`` instead. The prefix
        cache applies as in `prefill_export` (cached leading pages are
        attached and exported without a prefill); ``cache=False`` keeps
        the prompt out of the store. ``trace_ctx``, an optional
        ``(trace_id, parent_span)`` hex pair, rides the header, and the
        job's wall is then recorded as an ``engine.prefill_stream`` span
        of that trace."""
        ids = self._handoff_ids(prompt_ids)
        sink: _queue.Queue = _queue.Queue()
        with self._work:
            self._refuse_not_accepting()
            self._prefill_jobs.append((ids, bool(cache), trace_ctx, sink))
            self._work.notify()
        return sink

    def _apply_prefill_jobs(self):
        """The loop's drain of the prefill-job mailbox, at each step's
        start: each posted job runs to its end, its records going into
        its sink. A job's failure goes to the sink as ``("err", ...)``,
        never onto the loop."""
        while True:
            with self._qlock:
                if not self._prefill_jobs:
                    return
                ids, cache, trace_ctx, sink = self._prefill_jobs.popleft()
            try:
                self._run_prefill_stream(ids, cache, sink, trace_ctx)
                sink.put(("done", None))
            except Exception as e:  # noqa: BLE001 - surface to the sender
                sink.put(("err", f"{type(e).__name__}: {e}"))

    def _run_prefill_stream(self, ids: np.ndarray, cache: bool, sink,
                            trace_ctx=None):
        """One prefill-stream job: chunk-program calls back to back from
        the first page without valid KV on, a ``PTKS1`` record put into
        ``sink`` as each chunk completes at least one page. The record
        plan is fixed before any device work: the header, one page batch
        for the cached and re-uploaded prefix, one per chunk that
        completes a page, and the final record with the first token and
        the tail. Each batch's pages are read back as its chunk completes
        them (a synchronization each, as the JAX engine's). Pages are
        borrowed and freed as in `prefill_export`."""
        t0 = time.perf_counter()
        ps = self.ecfg.page_size
        s0 = int(ids.size)
        n_src = -(-s0 // ps)
        hashes, shared, pages, n_up = self._borrow_pages(
            ids, cache, "prefill stream")
        n_res = len(shared) + n_up    # resident pages needing no prefill
        row = np.full(self.pages_per_slot, TRASH_PAGE, np.int32)
        row[:n_src] = pages
        start = n_res * ps
        c = self._tail_chunk(s0, start)
        chunk_starts = list(range(start, s0, c))
        batches, cursor = [], n_res
        for a in chunk_starts:
            done_pages = min(a + c, s0) // ps
            batches.append((cursor, done_pages - cursor))
            cursor = done_pages
        n_records = 2 + (1 if n_res else 0) \
            + sum(1 for _, n in batches if n > 0)
        sink.put(("count", n_records))
        nh = self.cfg.num_heads
        geom = [self.cfg.num_layers, ps, nh, self.cfg.hidden_size // nh]
        try:
            seq = 0
            sink.put(("rec", pack_stream_header(
                seq, ids, ps, _dtype_name(self._kc.dtype), geom, n_src,
                n_records, self._quant_kv, trace_ctx=trace_ctx)))
            seq += 1
            if n_res:
                sink.put(("rec", pack_stream_pages(
                    seq, 0, *self._export_host(pages[:n_res]))))
                seq += 1
            for a, (p0, n) in zip(chunk_starts, batches):
                tok = self._run_chunk(ids, a, row, None, None, c)
                if n > 0:
                    sink.put(("rec", pack_stream_pages(
                        seq, p0, *self._export_host(pages[p0:p0 + n]))))
                    seq += 1
            tb = time.perf_counter()
            first = int(tok)          # the stream's one token readback
            self._blocked_s += time.perf_counter() - tb
            self._count("d2h_transfers")
            sink.put(("rec", pack_stream_final(
                seq, first, cursor, *self._export_host(pages[cursor:]))))
            if self._prefix_enabled and cache:
                self._register_prefix(hashes, pages)
        finally:
            self.allocator.free(pages)
        self._count("kv_stream_exports")
        flight.record("engine.prefill_stream", prompt_len=s0,
                      records=n_records, cached_pages=len(shared),
                      reuploaded_pages=n_up)
        if trace_ctx:
            tid, parent = trace_ctx
            metrics.add_span(
                "engine.prefill_stream", t0, time.perf_counter() - t0,
                cat="engine", args={"prompt_len": s0, "records": n_records},
                trace_id=tid, parent=parent, span_id=new_span_id())

    # ------------------------------------------------------------ KV import

    def import_request(self, handoff: KVHandoff, max_new_tokens=32,
                       trace=None, cache=True,
                       speculate=True) -> GenerateRequest:
        """Resume decode from a `KVHandoff` exported on another engine:
        take a slot and pages here, scatter the handoff's pages in and
        decode on, token for token what a local prefill gives. Loop thread
        only, and placed at once: a full engine raises instead of
        queueing (the handoff path does its own admission upstream). Pass
        the originating request's ``trace`` to keep the SLO clock across
        the transfer; a fresh one measures only the import."""
        req = self._build_import_request(handoff, max_new_tokens,
                                         trace=trace, cache=cache,
                                         speculate=speculate)
        with self._work:
            self._refuse_not_accepting()
            req.trace.mark_submit()
        slots = self._free_slots()
        if not slots:
            raise RuntimeError("no free slot for KV import")
        need = -(-(int(req.prompt.size) + req.max_new_tokens)
                 // self.ecfg.page_size)
        pages = self.allocator.alloc(need)
        if pages is None:
            raise RuntimeError(
                f"KV import needs {need} pages, "
                f"{self.allocator.free_pages} free")
        self._place_import(req, handoff, slots[0], pages)
        return req

    def _build_import_request(self, handoff: KVHandoff, max_new_tokens,
                              deadline_s=None, trace=None, cache=True,
                              speculate=True,
                              request_key=None) -> GenerateRequest:
        """The checks both import paths share, on the calling thread (a
        refusal goes back to the sender, never onto the loop), and the
        request future. The caller applies `_refuse_not_accepting` under
        its own hold of ``_work``."""
        self._check_handoff(handoff)
        ids = np.ascontiguousarray(handoff.prompt).reshape(-1) \
            .astype(np.int32)
        n = int(max_new_tokens)
        if n < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n}")
        if ids.size + n > self.max_seq_len:
            raise ValueError(
                f"prompt {ids.size} + max_new_tokens {n} exceeds engine "
                f"max_seq_len={self.max_seq_len}")
        sample = handoff.sample or {}
        req = GenerateRequest(ids, n, trace=trace, cache=cache,
                              speculate=speculate, deadline_s=deadline_s,
                              request_key=self._dedup_key(request_key),
                              temperature=sample.get("temperature", 1.0),
                              top_k=sample.get("top_k", 0))
        req.imported = True
        if self._prefix_enabled and req.cache:
            # imported pages are cache-eligible (`_seed_first_token`
            # indexes them) unless the request opted out, on every engine
            req.page_hashes = prompt_page_hashes(ids, self.ecfg.page_size)
        return req

    def _check_handoff(self, handoff: KVHandoff):
        """The geometry and dtype refusals both import paths share: a
        mismatched handoff fails loudly on the posting thread, never casts
        on the loop's."""
        nh = self.cfg.num_heads
        nl, dh = self.cfg.num_layers, self.cfg.hidden_size // nh
        ps = self.ecfg.page_size
        dtype = _dtype_name(self._kc.dtype)
        if int(handoff.page_size) != int(ps):
            raise ValueError(
                f"page_size mismatch: handoff {handoff.page_size} vs "
                f"engine {ps}")
        if handoff.cache_dtype != dtype:
            raise ValueError(
                f"cache dtype mismatch: handoff {handoff.cache_dtype} vs "
                f"engine {dtype} — a silent cast would break bit-identical "
                f"decode (kv_dtype must match across a handoff)")
        if handoff.sample is not None and not self._sampling:
            raise ValueError(
                "handoff carries fused-sampler state but this engine was "
                "built without EngineConfig(sampling=True) — a greedy "
                "resume would silently change the request's distribution")
        if self._quant_kv and handoff.k_scales is None:
            raise ValueError(
                "int8 KV handoff is missing its scale blobs — refusing a "
                "silently mis-scaled import")
        if self._quant_kv and \
                tuple(handoff.k_scales.shape) != tuple(handoff.k_pages
                                                       .shape[:-1]):
            raise ValueError(
                f"KV handoff scales shape {handoff.k_scales.shape} does "
                f"not match pages shape {handoff.k_pages.shape}")
        h_nl, n_src, h_ps, h_nh, h_dh = handoff.k_pages.shape
        if (h_nl, h_ps, h_nh, h_dh) != (nl, ps, nh, dh):
            raise ValueError(
                f"cache geometry mismatch: handoff pages "
                f"{handoff.k_pages.shape} vs engine [nl={nl}, "
                f"ps={ps}, nh={nh}, dh={dh}]")
        if n_src != -(-int(handoff.prompt.size) // ps):
            raise ValueError(
                f"handoff has {n_src} pages for a {handoff.prompt.size}-"
                f"token prompt at page_size {ps}")

    def _place_import(self, req: GenerateRequest, handoff: KVHandoff,
                      slot: int, pages: list[int]):
        """Place a checked handoff (loop thread): its pages scattered into
        this pool's ``pages`` by `import_pages`, in place on the engine's
        stream, so the captured graphs read them; the slot published, a
        sampled request's advanced key chain written into the slot's row
        of the key buffer in place, and the first token seeded."""
        n_src = handoff.k_pages.shape[1]
        self._count("requests")
        req.trace.mark_admitted()
        flight.record("engine.kv_import", request_id=req.request_id,
                      slot=slot, pages=len(pages),
                      prompt_len=int(req.prompt.size))
        blobs = [_pool_tensor(handoff.k_pages, self._kc.dtype),
                 _pool_tensor(handoff.v_pages, self._kc.dtype)]
        scales = ()
        if self._quant_kv:
            scales = (self._ks, self._vs,
                      *(torch.from_numpy(np.ascontiguousarray(s, np.float32))
                        for s in (handoff.k_scales, handoff.v_scales)))
        import_pages(self._kc, self._vc, *blobs, pages[:n_src], *scales)
        row = np.full(self.pages_per_slot, TRASH_PAGE, np.int32)
        row[:len(pages)] = pages
        self._page_table[slot] = row
        self._slot_req[slot] = req
        self._slot_pages[slot] = pages
        # usage: the whole imported context arrived as resident KV, prefill
        # work this engine did not run
        req.u_prefill_saved = int(req.prompt.size)
        req.u_admit_step = self.step_seq
        if self._sampling:
            self._temps[slot] = req.temperature
            self._topks[slot] = req.top_k
            if handoff.sample is not None:
                # the chain as the exporter left it (an admission-rate
                # host write, never a per-step one)
                self._keys_dev[slot].copy_(torch.tensor(
                    [int(w) & prng.M32 for w in handoff.sample["key"]],
                    dtype=torch.int64))
        self._count("kv_imports")
        self._seed_first_token(slot, req, int(handoff.first_token))

    # ------------------------------------------------------ live migration

    def submit_import(self, handoff: KVHandoff, max_new_tokens=32,
                      deadline_s=None, trace=None, cache=True,
                      speculate=True, request_key=None) -> GenerateRequest:
        """The receive side of live migration, thread-safe: check the
        handoff on the posting thread (a geometry or dtype refusal goes
        back to the sender), post it to the import mailbox and return the
        request future at once. The loop places it between steps
        (`_apply_imports`), so a peer's threads never touch the device and
        no step program changes. Unlike `import_request` a full engine
        defers the placement; one that could never fit it answers a typed
        error. A ``request_key`` registers the resumed request in this
        engine's dedup table."""
        # double-checked like submit(): a draining or stopped engine fails
        # fast, before the O(context) hash pass; the second check, atomic
        # with the post, is the one that counts
        with self._work:
            self._refuse_not_accepting()
        req = self._build_import_request(handoff, max_new_tokens,
                                         deadline_s=deadline_s,
                                         trace=trace, cache=cache,
                                         speculate=speculate,
                                         request_key=request_key)
        with self._work:
            self._refuse_not_accepting()
            req.trace.mark_submit()
            flight.record("engine.migrate_in", request_id=req.request_id,
                          context_len=int(req.prompt.size),
                          max_new_tokens=req.max_new_tokens)
            self._imports.append((handoff, req))
            # the migration owns the key now: a resubmit after the drain
            # attaches instead of running the generation again
            self._register_dedup(req.request_key, req)
            self._work.notify()
        return req

    def _apply_imports(self):
        """The loop's drain of the import mailbox, at each step's start:
        each posted handoff into a free slot. No slot or pages now is a
        deferral while the engine has work that will retire; on an idle
        engine it is a typed failure (nothing will ever free room)."""
        retry = []
        while True:
            with self._qlock:
                if not self._imports:
                    break
                handoff, req = self._imports.popleft()
            if req.done:
                continue
            if req.expired():
                err = self._deadline_error(req)
                self._count_reap(err)
                req._finish(err)
                continue
            slots = self._free_slots()
            need = -(-(req.prompt.size + req.max_new_tokens)
                     // self.ecfg.page_size)
            pages = self.allocator.alloc(need) if slots else None
            if pages is None:
                if self._occupied() or self._inflight or self._prefilling:
                    retry.append((handoff, req))  # room will free up
                    continue
                req._finish(f"KV import needs a slot and {need} pages; "
                            f"engine has {len(slots)} free slots, "
                            f"{self.allocator.free_pages} free pages and "
                            f"no retiring work")
                continue
            self._count("migrations_in")
            self._place_import(req, handoff, slots[0], pages)
        if retry:
            with self._qlock:
                self._imports.extend(retry)

    @staticmethod
    def _cold_sample(req: GenerateRequest) -> dict | None:
        """A cold item's sampler parameters ({"temperature", "top_k",
        "seed"}): the peer restarts the chain from the seed, and since
        nothing was drawn yet the sequence is the uninterrupted one. None
        for a greedy request."""
        if req.temperature != 1.0 or req.top_k != 0:
            return {"temperature": float(req.temperature),
                    "top_k": int(req.top_k), "seed": int(req.seed)}
        return None

    @staticmethod
    def _deadline_ms_left(req: GenerateRequest,
                          now: float | None = None) -> int | None:
        if req.deadline_t is None:
            return None
        now = time.monotonic() if now is None else now
        return max(1, int((req.deadline_t - now) * 1000))

    def _migration_item(self, req: GenerateRequest, now: float,
                        handoff: KVHandoff | None = None,
                        max_new_tokens: int | None = None) -> MigrationItem:
        """A `MigrationItem` of ``req``: warm with ``handoff``, else cold
        with its prompt and sampler parameters."""
        return MigrationItem(
            max_new_tokens=req.max_new_tokens if max_new_tokens is None
            else max_new_tokens,
            handoff=handoff,
            prompt=req.prompt if handoff is None else None,
            deadline_ms=self._deadline_ms_left(req, now), request=req,
            cache=req.cache, speculate=req.speculate,
            request_key=req.request_key,
            sample=self._cold_sample(req) if handoff is None else None,
            trace_id=req.trace.trace_id, parent_span=req.trace.span_id)

    def _do_migrate_out(self):
        """The loop's migration export (`drain(migrate=True)`): harvest the
        whole in-flight window, so every token a step drew is delivered,
        then export each decoding slot as a warm `MigrationItem` (its
        context, the prompt and ``generated[:-1]``, whose KV is in the
        pool, with ``generated[-1]`` as the seed, and a sampled request's
        advanced key chain), detaching slots and pages without finishing
        the futures. Queued and chunk-prefilling requests leave cold, and
        imports still in the mailbox leave warm as they came.
        `take_migrated` hands the items over."""
        self._migrate_requested = False
        self._drain_window()
        items: list[MigrationItem] = []
        now = time.monotonic()
        for slot in range(self.ecfg.max_slots):
            req = self._slot_req[slot]
            if req is None or req.done:
                continue
            if req.expired(now):
                err = self._deadline_error(req)
                self._count_reap(err)
                self._retire(slot, error=err)
                continue
            if slot in self._prefilling or not req.generated:
                # mid chunked prefill: re-prefilling on the peer is cheaper
                # than shipping a partial page set
                item = self._migration_item(req, now)
            else:
                # the last token's KV is written by the next step, which
                # now runs on the peer
                ctx = int(self._lengths[slot])
                n_src = -(-ctx // self.ecfg.page_size)
                k, v, ks, vs = self._export_host(
                    self._slot_pages[slot][:n_src])
                handoff = KVHandoff(
                    prompt=np.concatenate([req.prompt, np.asarray(
                        req.generated[:-1], np.int32)]),
                    first_token=int(req.generated[-1]), k_pages=k,
                    v_pages=v, page_size=int(self.ecfg.page_size),
                    cache_dtype=_dtype_name(self._kc.dtype), k_scales=ks,
                    v_scales=vs)
                if self._sampling and (req.temperature != 1.0
                                       or req.top_k != 0):
                    key = self._keys_dev[slot].tolist()
                    handoff.sample = {
                        "temperature": float(req.temperature),
                        "top_k": int(req.top_k),
                        "key": [int(w) & prng.M32 for w in key]}
                # the seed is the peer's first token: the peer's budget is
                # what is left plus one
                item = self._migration_item(
                    req, now, handoff,
                    req.max_new_tokens - len(req.generated) + 1)
            flight.record("engine.migrate_out", request_id=req.request_id,
                          warm=item.handoff is not None,
                          delivered=len(req.generated))
            self._detach_slot(slot)
            items.append(item)
        with self._qlock:
            queued = list(self._queue)
            self._queue.clear()
            self._queue_tokens = 0
            self._g_queue.set(0)
            imports = list(self._imports)
            self._imports.clear()
        for req in queued:
            if req.done:
                continue
            if req.expired(now):
                err = self._deadline_error(req)
                self._count_reap(err)
                req._finish(err)
                continue
            items.append(self._migration_item(req, now))
        for handoff, req in imports:
            if not req.done:
                items.append(self._migration_item(req, now, handoff))
        self._count("migrations_out", len(items))
        for item in items:
            item.request.u_migrations += 1
        self._g_occupancy.set(0)
        with self._qlock:
            self._migrated.extend(items)
        flight.record("engine.migrated", count=len(items))
        self._migrate_done.set()

    def take_migrated(self, timeout: float | None = None) \
            -> list[MigrationItem]:
        """Block until the loop has made the export a `drain(migrate=True)`
        asked for, then hand the items over (their futures unfinished: the
        serving layer ships them to peers and answers the futures with the
        peers' tokens). Raises TimeoutError when the loop did not reach a
        step inside ``timeout``."""
        if not self._migrate_done.wait(timeout):
            raise TimeoutError(
                "migration export still pending (the loop has not reached "
                "a step boundary)")
        with self._qlock:
            items, self._migrated = self._migrated, []
        return items

    # ------------------------------------------------------ drain / abort

    def drain(self, migrate: bool = False):
        """Refuse NEW submits while everything already accepted runs to the
        end, the first half of a graceful shutdown; nothing is failed.
        Callers watch their requests (or `run_until_idle`) to know when the
        engine is quiet. ``migrate=True``: instead of waiting the
        generations out, the loop exports every live request at its next
        step (`_do_migrate_out`: decoding slots warm, queued and
        chunk-prefilling requests cold) without finishing the futures, and
        `take_migrated` hands the items to the serving layer, which ships
        them to a peer: scale-down costs a step and the transfer, not the
        longest generation."""
        with self._work:
            self._draining = True
            if migrate:
                self._migrate_requested = True
            self._work.notify()
        self._count("drains")

    def abort(self, reason: str):
        """Fail every queued and running request with ``reason``, free
        their pages and refuse later submits; blocked `result()` callers
        get the error at once, and so do imports still in the mailbox,
        prefill-stream jobs not yet run (an ``("err", reason)`` item) and
        migrated items never taken; a `take_migrated` waiter returns at
        once. The in-flight window is cleared: its tokens are never
        delivered, and its ring slots' events are simply recorded anew
        when the slots are reused."""
        with self._qlock:
            self._dead = reason
            queued = list(self._queue)
            self._queue.clear()
            self._queue_tokens = 0
            self._cancels.clear()
            self._g_queue.set(0)
            imports = list(self._imports)
            self._imports.clear()
            migrated = list(self._migrated)
            self._migrated.clear()
            prefill_jobs = list(self._prefill_jobs)
            self._prefill_jobs.clear()
        for req in queued:
            req._finish(reason)
        for _, req in imports:
            req._finish(reason)
        for *_, sink in prefill_jobs:
            sink.put(("err", reason))
        for item in migrated:
            # exported but never taken: nothing else will answer these
            if item.request is not None and not item.request.done:
                item.request._finish(reason)
        self._migrate_done.set()
        self._inflight.clear()
        self._g_inflight.set(0)
        for slot in range(self.ecfg.max_slots):
            if self._slot_req[slot] is not None:
                self._retire(slot, error=reason)
        self._g_occupancy.set(0)

    # -------------------------------------------- watchdog and serve loop

    def active_traces(self):
        """Traces of every request the engine still owes an answer: queued,
        slotted, or awaiting an in-flight harvest (what a watchdog dump
        lists as the stalled requests). Host state only."""
        with self._qlock:
            reqs = list(self._queue)
        reqs += [r for r in self._slot_req if r is not None]
        for _, snapshot in list(self._inflight):
            reqs += [r for _, r in snapshot]
        seen, traces = set(), []
        for r in reqs:
            if id(r) not in seen and not r.done:
                seen.add(id(r))
                traces.append(r.trace)
        return traces

    def start_watchdog(self, deadline_s=None, dump_dir=None,
                       interval_s=None):
        """Arm a stall watchdog over this engine's step loop: if the engine
        has work but ``step_seq`` stops advancing for ``deadline_s``
        (default ``PADDLE_WATCHDOG_S``, 300 s; <= 0 disables and returns
        None), the flight recorder's ring, the stalled requests' traces and
        the metrics snapshot are dumped to a JSON file
        (`observability/flight_recorder.py`). `serve_loop` arms one; a
        caller driving `step` / `run_until_idle` opts in here. The
        watchdog's thread reads host state only, never the card, so it
        can dump while a step waits on the device."""
        deadline = default_deadline() if deadline_s is None \
            else float(deadline_s)
        if deadline <= 0:
            return None
        return Watchdog("engine", progress=lambda: self.step_seq,
                        busy=self._has_work, deadline_s=deadline,
                        dump_dir=dump_dir, traces=self.active_traces,
                        interval_s=interval_s).start()

    def _on_device(self):
        """The engine's CUDA device as the current one of the calling
        thread (a null context on the CPU): a thread that did not build
        the engine captures and replays its graphs there."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self._tok_dev.device)

    def serve_loop(self, stop_event: threading.Event, idle_wait=0.05):
        """The engine's loop for a thread of its own: steps while there is
        work, parks on the submit condition when idle, on the engine's
        device. On exit, a clean stop or a step raising (a fault, a device
        error), every outstanding request is aborted, so no caller is left
        blocking on a request nobody will finish. A stall watchdog
        (`start_watchdog`) guards the loop: a step that wedges leaves a
        flight-recorder dump instead of a silent hang. Other threads only
        `submit` / `cancel` / `drain`, which make no CUDA call."""
        watchdog = self.start_watchdog()
        try:
            with self._on_device():
                while not stop_event.is_set():
                    if self.step():
                        continue
                    with self._work:
                        if not self._queue:
                            self._work.wait(idle_wait)
        except Exception as e:  # noqa: BLE001 - surface it to every waiter
            metrics.counter("engine.loop_errors").inc()
            self.abort(f"engine loop died: {type(e).__name__}: {e}")
            raise
        finally:
            if watchdog is not None:
                watchdog.stop()
        self.abort("engine stopped (server shutdown)")
