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

Harvest is synchronous: each step reads its sampled tokens back before the
next step is dispatched (the JAX engine keeps ``inflight`` steps in flight).
The tokens a request receives are the same either way.

Not in this slice (see ROADMAP.md): prefix cache, speculative decode, KV
tiers, handoff/migration, dedup, deadlines, cancel and degradation, the
fused sampler, metrics/tracing, a float KV pool of another dtype than the
weights (A9).

Thread model: `submit()` is safe from any thread; `step()` /
`run_until_idle()` must all run on ONE thread, the loop's owner.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from paddle_tpu_torch.inference.errors import from_wire
from paddle_tpu_torch.kernels.paged_attention import KV_DTYPES, TRASH_PAGE
from paddle_tpu_torch.models import gpt as gpt_mod
from paddle_tpu_torch.quantization.serving import quantize_gpt_params

__all__ = ["EngineConfig", "PageAllocator", "GenerateRequest", "DecodeEngine"]

# packed slot-state upload layout: [B, _STATE_COLS + pages_per_slot] int32
_COL_TOKEN, _COL_LENGTH, _COL_FLAGS, _STATE_COLS = 0, 1, 2, 3
_FLAG_ACTIVE, _FLAG_FRESH = 1, 2


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
    prefill_chunk_tokens : prompts LONGER than this are prefilled in chunks
                   of this many tokens, one chunk per engine step after the
                   decode step; None keeps the one-shot bucketed prefill
    kv_dtype     : page-pool storage: "native" (the weights' dtype) or
                   "int8" (int8 pages plus per-token-slot per-head f32
                   scale pools [nl, P, ps, nh]); "f32" / "bf16" are
                   accepted where they equal the weights' dtype
    weight_dtype : "native" or "int8": the GPT matmul leaves become int8
                   with per-output-channel scales at construction
                   (`quantization/serving.py`), dequantized at use
    """
    page_size: int = 16
    max_slots: int = 8
    max_seq_len: int | None = None
    num_pages: int | None = None
    min_bucket: int = 16
    eos_id: int | None = None
    prefill_chunk_tokens: int | None = None
    kv_dtype: str = "native"
    weight_dtype: str = "native"


class PageAllocator:
    """Host-side REFCOUNTED free list over the page pool. Page 0
    (TRASH_PAGE) is never handed out: it is the spill target for masked
    writes."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 is reserved), got {num_pages}")
        self.num_pages = num_pages
        self._free = deque(range(1, num_pages))
        self._refcnt = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n pages, or None when the pool cannot cover them (the caller
        keeps the request queued: admission waits, it never allocates
        part of a request)."""
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refcnt[p] = 1
        return pages

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
                self._free.append(p)


class GenerateRequest:
    """One queued or running generation. `result()` blocks until the
    sequence retires and returns prompt + generated ids."""

    def __init__(self, prompt: np.ndarray, max_new_tokens: int):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.generated: list[int] = []
        self.submit_t = time.perf_counter()
        self.first_token_t: float | None = None   # TTFT = this - submit_t
        self._done = threading.Event()
        self._error: str | None = None

    def _finish(self, error: str | None = None):
        self._error = error
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("generation still running")
        if self._error is not None:
            raise from_wire(self._error)
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, self.prompt.dtype)])


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
    """Continuous-batching greedy decode over a paged KV cache for one GPT
    model.

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
        params = {k: v.detach() for k, v in model.state_dict().items()}
        if ecfg.weight_dtype not in ("native", None):
            # quantized where the weights lie, then moved: the card and the
            # CPU engines hold the same int8 values and scales
            params = quantize_gpt_params(params, ecfg.weight_dtype)
        self._params = {k: v.to(self.device) for k, v in params.items()}
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
        self._tok_dev = torch.zeros(B, dtype=torch.int32, device=self.device)
        # chunked-prefill progress: slot -> {"req", "done"}; these slots are
        # occupied (request and pages held) but NOT decode-active
        self._prefilling: dict[int, dict] = {}

        self._queue: deque[GenerateRequest] = deque()
        self._qlock = threading.Lock()
        self.counters = {"steps": 0, "h2d_transfers": 0, "prefills": 0,
                         "prefill_chunks": 0}

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
                "ported (ROADMAP A9: a float KV pool of another dtype than "
                "the weights); use 'native' or 'int8'")
        return False

    def _scales(self) -> dict:
        """The scale pools as step-function keywords, or {} (float pools)."""
        if not self._quant_kv:
            return {}
        return {"k_scale": self._ks, "v_scale": self._vs}

    # ----------------------------------------------------------- prefill

    def _use_chunked(self, prompt_len: int) -> bool:
        c = self.ecfg.prefill_chunk_tokens
        return c is not None and prompt_len > int(c)

    def bucket_for(self, prompt_len: int) -> int:
        """Next power of two >= prompt_len (floor min_bucket, capped at the
        position table so wpe[:bucket] stays in range)."""
        b = max(self.ecfg.min_bucket, 1 << max(0, prompt_len - 1).bit_length())
        return min(b, self.cfg.max_position_embeddings)

    def warmup(self):
        """Build the CUDA kernels the engine launches (no-op on the CPU), so
        the first request does not pay the compile. Optional: they also
        build on first use."""
        if self.device.type == "cuda":
            from paddle_tpu_torch.kernels import _build
            _build.build_all()

    def _upload(self, packed: np.ndarray) -> torch.Tensor:
        self.counters["h2d_transfers"] += 1
        return torch.from_numpy(packed).to(self.device)

    def _run_prefill(self, ids: np.ndarray, row: np.ndarray) -> int:
        """One-shot bucketed prefill of ``ids`` into ``row``'s pages; returns
        the greedy first token."""
        s0, maxp = ids.size, self.pages_per_slot
        bucket = self.bucket_for(s0)
        packed = np.zeros(bucket + maxp, np.int32)   # ids | page row
        packed[:s0] = ids
        packed[bucket:] = row
        dev = self._upload(packed)
        logits = gpt_mod.prefill_step(
            self._params, dev[:bucket], s0, dev[bucket:], self._kc, self._vc,
            cfg=self.cfg, **self._scales())[0]
        self.counters["prefills"] += 1
        return int(logits.argmax(dim=-1))

    def _run_chunk(self, ids: np.ndarray, done: int, row: np.ndarray):
        """Run ONE prefill chunk (``ids[done:done+c]`` against page ``row``)
        and return its greedy token on the device (meaningful only for the
        final chunk; no readback here)."""
        c, maxp = int(self.ecfg.prefill_chunk_tokens), self.pages_per_slot
        chunk = ids[done:done + c]
        packed = np.zeros(c + maxp, np.int32)        # chunk ids | page row
        packed[:chunk.size] = chunk
        packed[c:] = row
        dev = self._upload(packed)
        logits = gpt_mod.prefill_chunk_step(
            self._params, dev[:c], done, int(chunk.size), dev[c:], self._kc,
            self._vc, cfg=self.cfg, **self._scales())[0]
        self.counters["prefill_chunks"] += 1
        return logits.argmax(dim=-1)

    # ---------------------------------------------------------- requests

    def submit(self, prompt_ids, max_new_tokens=32) -> GenerateRequest:
        """Queue one prompt (1-D or [1, S] int array). Thread-safe."""
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
        req = GenerateRequest(ids, n)
        with self._qlock:
            self._queue.append(req)
        return req

    def _free_slots(self):
        # occupancy, not the dispatch mask
        return [i for i in range(self.ecfg.max_slots)
                if self._slot_req[i] is None]

    def _occupied(self) -> bool:
        return any(r is not None for r in self._slot_req)

    def _admit(self):
        """Drain the queue into free slots while pages allow: assign a slot,
        allocate pages, prefill (or start a chunked prefill), seed the
        first token."""
        while True:
            slots = self._free_slots()
            if not slots:
                return
            with self._qlock:
                if not self._queue:
                    return
                req = self._queue[0]
                total = -(-(req.prompt.size + req.max_new_tokens)
                          // self.ecfg.page_size)
                pages = self.allocator.alloc(total)
                if pages is None:
                    if not self._occupied():
                        # nothing will ever retire to free pages: the pool
                        # itself is too small for this request
                        self._queue.popleft()
                        req._finish(error=f"request needs {total} pages, "
                                    f"pool has "
                                    f"{self.allocator.num_pages - 1}")
                        continue
                    return                 # wait for a retirement
                self._queue.popleft()
            self._place(req, slots[0], pages)

    def _place(self, req: GenerateRequest, slot: int, pages: list[int]):
        row = np.full(self.pages_per_slot, TRASH_PAGE, np.int32)
        row[:len(pages)] = pages
        self._page_table[slot] = row
        self._slot_req[slot] = req
        self._slot_pages[slot] = pages
        if self._use_chunked(req.prompt.size):
            # decode-priority chunked prefill: the slot holds its pages but
            # stays decode-inactive; step() runs ONE chunk per step after
            # the decode step until the prompt is cached
            self._lengths[slot] = 0
            self._prefilling[slot] = {"req": req, "done": 0}
            return
        self._seed_first_token(slot, req, self._run_prefill(req.prompt, row))

    def _seed_first_token(self, slot: int, req: GenerateRequest, first: int):
        """Prefill finished: activate the slot for decode and deliver the
        first generated token."""
        self._lengths[slot] = req.prompt.size
        self._tokens[slot] = first
        self._active[slot] = True
        self._fresh[slot] = True
        self._budget[slot] = req.max_new_tokens - 1
        req.generated.append(first)
        req.first_token_t = time.perf_counter()
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
        tok = self._run_chunk(req.prompt, st["done"], self._page_table[slot])
        st["done"] = min(st["done"] + c, req.prompt.size)
        if st["done"] >= req.prompt.size:
            del self._prefilling[slot]
            self._seed_first_token(slot, req, int(tok))   # final chunk only
        return True

    def _detach_slot(self, slot: int):
        """Release a slot's pages and mirrors without touching the request
        future."""
        self._prefilling.pop(slot, None)
        self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_req[slot] = None
        self._active[slot] = False
        self._fresh[slot] = False
        self._budget[slot] = 0
        self._page_table[slot] = TRASH_PAGE
        self._lengths[slot] = 0

    def _retire(self, slot: int, error: str | None = None):
        req = self._slot_req[slot]
        self._detach_slot(slot)
        if req is not None:
            req._finish(error)

    # -------------------------------------------------------------- step

    def _packed_state(self) -> np.ndarray:
        B, maxp = self.ecfg.max_slots, self.pages_per_slot
        packed = np.empty((B, _STATE_COLS + maxp), np.int32)
        packed[:, _COL_TOKEN] = self._tokens
        packed[:, _COL_LENGTH] = self._lengths
        packed[:, _COL_FLAGS] = (self._active.astype(np.int32) * _FLAG_ACTIVE
                                 | self._fresh.astype(np.int32) * _FLAG_FRESH)
        packed[:, _STATE_COLS:] = self._page_table
        return packed

    def _dispatch(self):
        """Run ONE fixed-shape decode step from one fused upload; the
        sampled tokens stay on the device. Returns the slots to harvest."""
        state = self._upload(self._packed_state())
        flags = state[:, _COL_FLAGS]
        active = (flags & _FLAG_ACTIVE) != 0
        fresh = (flags & _FLAG_FRESH) != 0
        toks = torch.where(fresh, state[:, _COL_TOKEN], self._tok_dev)
        cache = dict(k_pages=self._kc, v_pages=self._vc,
                     page_table=state[:, _STATE_COLS:].contiguous(),
                     lengths=state[:, _COL_LENGTH], **self._scales())
        logits, _ = gpt_mod.decode_step(self._params, toks, cache, active,
                                        cfg=self.cfg)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        self._tok_dev = torch.where(active, nxt, toks)
        snapshot = [(int(i), self._slot_req[i])
                    for i in np.flatnonzero(self._active)]
        # host bookkeeping for the step: each active slot advances one
        # position; a slot at its token budget stops being dispatched
        self._lengths[self._active] += 1
        self._budget[self._active] -= 1
        self._fresh[:] = False
        self._active &= self._budget > 0
        self.counters["steps"] += 1
        return snapshot

    def _harvest(self, snapshot):
        """Read the step's sampled token ids back and deliver them: append to
        each request, retire slots that hit max_new_tokens or EOS."""
        toks_np = self._tok_dev.cpu().numpy()
        for slot, req in snapshot:
            if req.done or self._slot_req[slot] is not req:
                continue
            tok = int(toks_np[slot])
            req.generated.append(tok)
            if len(req.generated) >= req.max_new_tokens \
                    or tok == self.ecfg.eos_id:
                self._retire(slot)

    def step(self) -> bool:
        """Admit waiting requests, run ONE batched decode step plus at most
        one prefill chunk, harvest the step. Returns False when idle."""
        self._admit()
        # capacity tripwire: a token at pos >= slot_capacity would spill to
        # the trash page; retire the sequence with an error instead
        for slot in np.flatnonzero(self._active &
                                   (self._lengths >= self.slot_capacity)):
            self._retire(int(slot), error=(
                f"sequence hit slot capacity {self.slot_capacity} "
                f"(pages_per_slot * page_size); token at position "
                f"{int(self._lengths[slot])} cannot be cached"))
        snapshot = self._dispatch() if self._active.any() else None
        # decode-priority: the chunk runs AFTER the decode step, so a long
        # prompt adds at most one chunk per step to the running decodes
        chunked = self._advance_prefill()
        if snapshot is not None:
            self._harvest(snapshot)
        elif not chunked:
            with self._qlock:
                return bool(self._queue)
        return self._has_work()

    def _has_work(self) -> bool:
        with self._qlock:
            queued = bool(self._queue)
        return queued or bool(self._prefilling) or self._occupied()

    def run_until_idle(self, max_steps: int | None = None):
        """Drive step() until the queue and the slots drain."""
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                raise RuntimeError(
                    f"engine still busy after {max_steps} steps")
