"""The port's prefix cache (`paddle_tpu_torch/inference/engine.py` with
``prefix_cache=True``, its default) held against the JAX package's
`DecodeEngine` on the same numpy-drawn weights and the same request trace:
tokens EQUAL (greedy, sampled, speculative, int8 KV; hits, misses,
evictions, chunked prefill, a weight refresh), the prefix counters equal
to the JAX metrics, only the uncached tail prefilled, and every page back
in the pool (cached ones as reclaimable) when the engine idles. Also the
page-chain hashes byte for byte and the refcounted allocator's semantics.

The port runs on the CPU (``device="cpu"``: the plain PyTorch versions of
its kernels); the JAX engine runs its CPU arms.
"""
import numpy as np
import pytest

from paddle_tpu.inference.engine import DecodeEngine as JEngine
from paddle_tpu.inference.engine import EngineConfig as JConfig
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import metrics
from paddle_tpu.serving.disagg import prompt_page_hashes as jax_hashes
from paddle_tpu_torch.inference.engine import (DecodeEngine, EngineConfig,
                                               PageAllocator)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.serving.disagg import prompt_page_hashes

SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=64)
ECFG = dict(page_size=4, max_slots=4, min_bucket=8)
PS = ECFG["page_size"]
# the port's counters that carry a JAX metric, "engine." + the name with
# "kvtier_" written "kvtier."
PREFIX_KEYS = ("prefix_hit", "prefix_miss", "prefix_pages_reused",
               "prefix_evictions", "prefix_evictions_demoted",
               "prefix_evictions_discarded", "prefill_tokens")
TIER_KEYS = ("kvtier_hits_host", "kvtier_hits_disk",
             "kvtier_reuploads_host", "kvtier_reuploads_disk",
             "kvtier_spill_fail", "kvtier_reupload_fail")


def _weights(seed):
    rng = np.random.RandomState(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    w = {}
    for k, v in jm.state_dict().items():
        base = 1.0 if k.endswith(("ln_1.weight", "ln_2.weight",
                                  "ln_f.weight")) else 0.0
        w[k] = (base + rng.randn(*v._data.shape) * 0.1).astype(np.float32)
    return w


def _pair(seed):
    w = _weights(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    jm.set_state_dict(w)
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL))
    tm.load_state_dict(params_from_numpy(w, "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return {11: _pair(11), 12: _pair(12)}


def _jax_counter(key):
    name = "engine." + key.replace("kvtier_", "kvtier.")
    return metrics.snapshot()["counters"].get(name, 0)


def _ids(seed, n):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], n).astype(np.int32)


def _wave(eng, reqs):
    """Submit ``reqs`` ((prompt, max_new_tokens, submit keywords) each),
    run the engine idle, return the outputs."""
    out = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in reqs]
    eng.run_until_idle(max_steps=400)
    return [r.result(timeout=30) for r in out]


def both(models, scenario, keys=PREFIX_KEYS, seed=11, jax_cfg=None, **kw):
    """Run ``scenario(engine)`` on a JAX engine and on the port's, both of
    ``EngineConfig(**ECFG, **kw)`` (``jax_cfg``: keywords for the JAX side
    only, such as its own disk directory) over the weights of ``seed``.
    Asserts equal outputs and equal counter deltas over ``keys``; returns
    the port's engine and the counters' deltas."""
    jm, tm = models[seed]
    cfg = dict(ECFG, **kw)
    before = {k: _jax_counter(k) for k in keys}
    jeng = JEngine(jm, JConfig(**dict(cfg, **(jax_cfg or {}))))
    want = scenario(jeng)
    jdelta = {k: _jax_counter(k) - before[k] for k in keys}
    eng = DecodeEngine(tm, EngineConfig(**cfg), device="cpu")
    got = scenario(eng)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    delta = {k: eng.counters[k] for k in keys}
    assert delta == jdelta
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    return eng, delta


# ------------------------------------------------------------------ hashes

@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("n", ["1", "ps-1", "ps", "ps+1", "3ps"])
def test_prompt_page_hashes_equal_jax(ps, n):
    length = {"1": 1, "ps-1": ps - 1, "ps": ps, "ps+1": ps + 1,
              "3ps": 3 * ps}[n]
    ids = _ids(length, length)
    got = prompt_page_hashes(ids, ps)
    assert got == jax_hashes(ids, ps)
    assert len(got) == length // ps
    assert all(isinstance(h, bytes) and len(h) == 16 for h in got)


# --------------------------------------------------------------- allocator

def _double_free(a):
    pages = a.alloc(2)
    a.free(pages)
    with pytest.raises(ValueError, match="double free"):
        a.free([pages[0]])


def _duplicate_ids(a):
    (p,) = a.alloc(1)
    with pytest.raises(ValueError, match="duplicate"):
        a.free([p, p])
    a.free([p])                  # the loud path changed nothing


def _trash_and_bogus(a):
    for bad, match in (([0], "trash page"), ([99], "bogus"), ([-1], "bogus")):
        with pytest.raises(ValueError, match=match):
            a.free(bad)


def _share_refcounts(a):
    pages = a.alloc(2)
    a.share(pages)
    assert a.refcount(pages[0]) == 2
    a.free(pages)
    assert a.refcount(pages[0]) == 1 and a.free_pages == 5
    a.free(pages)
    assert a.free_pages == 7
    with pytest.raises(ValueError, match="double free"):
        a.free(pages)


def _share_unallocated(a):
    with pytest.raises(ValueError, match="unallocated"):
        a.share([3])
    with pytest.raises(ValueError, match="bogus"):
        a.share([0])


def _retain_and_evict(a):
    kept = []
    a.retain_hook = lambda p: kept.append(p) or True
    a.evict_hook = lambda n: [kept.pop(0) for _ in range(min(n, len(kept)))]
    pages = a.alloc(5)
    a.free(pages)
    assert a.free_pages == 7             # retained counts as reclaimable
    got = a.alloc(4)                     # 2 free + 2 evicted
    assert got is not None and len(got) == 4 and len(kept) == 3
    a.share(kept[:1])                    # a retained page comes back to life
    assert a.refcount(kept[0]) == 1 and a.free_pages == 2


def _evict_hook_live_page(a):
    live = a.alloc(7)
    a.retain_hook = lambda p: True
    a.free(live[:1])                     # one retained page: alloc(1) fits
    a.evict_hook = lambda n: live[1:1 + n]
    with pytest.raises(RuntimeError, match="surrendered live page"):
        a.alloc(1)


def _reclaim(a):
    pages = a.alloc(2)
    with pytest.raises(ValueError, match="non-retained"):
        a.reclaim(pages[:1])
    a.retain_hook = lambda p: True
    a.free(pages)
    a.reclaim(pages)
    assert a.free_pages == 7 and a.alloc(7) is not None


@pytest.mark.parametrize("case", [_double_free, _duplicate_ids,
                                  _trash_and_bogus, _share_refcounts,
                                  _share_unallocated, _retain_and_evict,
                                  _evict_hook_live_page, _reclaim],
                         ids=lambda f: f.__name__[1:])
def test_page_allocator_semantics(case):
    case(PageAllocator(8))


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("n", [17, 16])
def test_resubmission_prefills_only_the_tail(models, n):
    prompt = _ids(0, n)

    def scenario(eng):
        return _wave(eng, [(prompt, 8, {})]) + _wave(eng, [(prompt, 8, {})])

    eng, d = both(models, scenario)
    shared = (n - 1) // PS             # the last token's page is recomputed
    assert d["prefix_hit"] == 1 and d["prefix_miss"] == 1
    assert d["prefix_pages_reused"] == shared
    assert d["prefill_tokens"] == n + (n - shared * PS)
    assert len(eng.prefix_hashes()) == n // PS


def test_concurrent_shared_prefix_refcounts(models):
    system = _ids(1, 16)
    prompts = [np.concatenate([system, _ids(20 + i, 3)]) for i in range(3)]
    seen = {}

    def scenario(eng):
        out = _wave(eng, [(system, 2, {})])
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.step()                        # all three admitted and decoding
        page = eng._prefix_lookup(reqs[0].page_hashes)[0]
        seen[type(eng)] = [eng.allocator.refcount(page)]
        eng.run_until_idle(max_steps=100)
        seen[type(eng)].append(eng.allocator.refcount(page))
        return out + [r.result(timeout=30) for r in reqs]

    _, d = both(models, scenario)
    assert seen[DecodeEngine] == seen[JEngine] == [3, 0]
    assert d["prefix_hit"] == 3 and d["prefix_pages_reused"] == 12


def test_eviction_never_takes_a_live_page(models, monkeypatch):
    rng = np.random.RandomState(2)
    # 11 usable pages: pa leaves 4 cached, the live request takes the other
    # 7, so the 4 pages of pb evict pa's while the live request runs
    pa, pl, pb = (rng.randint(0, 97, n).astype(np.int32) for n in (16, 16,
                                                                   9))
    state = {}

    def scenario(eng):
        out = _wave(eng, [(pa, 4, {})])     # 4 full pages left idle-cached
        state["live"] = live = eng.submit(pl, max_new_tokens=12)
        eng.step()
        big = eng.submit(pb, max_new_tokens=7)   # must evict
        eng.run_until_idle(max_steps=100)
        return out + [live.result(timeout=30), big.result(timeout=30)] \
            + _wave(eng, [(pa, 4, {})])      # the evicted prefix re-prefills

    evicted_while_live = []
    orig = DecodeEngine._evict_prefix_pages

    def spy(self, n):
        out = orig(self, n)
        owned = {p for ps in self._slot_pages for p in ps}
        assert not set(out) & owned, "evicted a page a slot holds"
        if not state["live"].done:
            evicted_while_live.extend(out)
        return out

    monkeypatch.setattr(DecodeEngine, "_evict_prefix_pages", spy)
    _, d = both(models, scenario, max_slots=2, num_pages=12, max_seq_len=40)
    assert d["prefix_evictions"] > 0 and evicted_while_live
    assert d["prefix_evictions_discarded"] == d["prefix_evictions"]


def test_cache_opt_out_never_registers_or_reuses(models):
    prompt = _ids(3, 16)

    def scenario(eng):
        return [o for _ in range(2)
                for o in _wave(eng, [(prompt, 4, {"cache": False})])]

    eng, d = both(models, scenario)
    assert not eng._prefix_pages and not eng._prefix_idle
    assert d["prefix_hit"] == d["prefix_miss"] == 0
    assert d["prefill_tokens"] == 32

    def plain(eng):
        return [o for _ in range(2) for o in _wave(eng, [(prompt, 4, {})])]

    eng, d = both(models, plain, prefix_cache=False)
    assert not eng._prefix_pages and d["prefix_hit"] == d["prefix_miss"] == 0


@pytest.mark.parametrize("tail", [1, 13], ids=["tail_one", "tail_chunked"])
def test_chunked_prefill_pages_are_cache_eligible(models, tail):
    """A prompt prefilled in chunks registers its pages; a hit whose tail
    fits one chunk runs it at once, a longer tail chunks on from the
    cached position."""
    first = _ids(4, 21 if tail == 1 else 16)
    second = first if tail == 1 else np.concatenate([first, _ids(5, tail)])

    def scenario(eng):
        return _wave(eng, [(first, 6, {})]) + _wave(eng, [(second, 6, {})])

    eng, d = both(models, scenario, prefill_chunk_tokens=8)
    assert d["prefix_hit"] == 1
    assert d["prefill_tokens"] == first.size + tail
    chunks = -(-first.size // 8) + -(-tail // 8)
    assert eng.counters["prefill_chunks"] == chunks


def test_refresh_params_flushes_and_follows_new_weights(models):
    prompt = _ids(13, 16)
    jm2, tm2 = models[12]

    def scenario(eng):
        out = _wave(eng, [(prompt, 4, {})])
        assert eng._prefix_pages
        eng.refresh_params(jm2 if isinstance(eng, JEngine) else tm2)
        assert not eng._prefix_pages and not eng._prefix_idle
        assert eng.allocator.free_pages == eng.allocator.num_pages - 1
        return out + _wave(eng, [(prompt, 4, {})])

    _, d = both(models, scenario)
    assert d["prefix_hit"] == 0 and d["prefix_miss"] == 2
    # the second run follows the new weights: a fresh engine agrees
    fresh = DecodeEngine(tm2, EngineConfig(**ECFG), device="cpu")
    want = _wave(fresh, [(prompt, 4, {})])[0]
    eng = DecodeEngine(models[11][1], EngineConfig(**ECFG), device="cpu")
    _wave(eng, [(prompt, 4, {})])
    eng.refresh_params(tm2)
    np.testing.assert_array_equal(_wave(eng, [(prompt, 4, {})])[0], want)


def test_hit_while_sampling(models):
    system = _ids(6, 12)
    a, b = np.concatenate([system, _ids(7, 5)]), np.concatenate(
        [system, _ids(8, 2)])
    sampled = {"temperature": 0.8, "top_k": 5, "seed": 3}

    def scenario(eng):
        return (_wave(eng, [(a, 6, sampled)])
                + _wave(eng, [(a, 6, sampled), (b, 6, dict(sampled, seed=9)),
                              (b, 6, {})]))

    _, d = both(models, scenario, sampling=True)
    assert d["prefix_hit"] == 3


def test_hit_while_speculating(models):
    prompt = np.tile(_ids(11, 4), 5)            # 20 tokens, 5 pages

    def scenario(eng):
        return [o for _ in range(2) for o in _wave(eng, [(prompt, 12, {})])]

    eng, d = both(models, scenario, speculate_k=3, max_slots=2)
    assert d["prefix_hit"] == 1 and eng.counters["spec_steps"] > 0


def test_int8_kv_hit(models):
    system = _ids(9, 16)
    prompts = [np.concatenate([system, _ids(30 + i, 2 + 3 * i)])
               for i in range(3)]

    def scenario(eng):
        return (_wave(eng, [(system, 3, {})])
                + _wave(eng, [(p, 6, {}) for p in prompts]))

    _, d = both(models, scenario, kv_dtype="int8")
    assert d["prefix_hit"] == 3 and d["prefix_pages_reused"] == 12


def test_prefix_counters_equal_jax_on_a_mixed_trace(models):
    """Hits, misses, an opt-out, evictions under a small pool and a
    re-prefill of an evicted prefix: every prefix counter equals the JAX
    metric over the same trace (asserted by `both`)."""
    rng = np.random.RandomState(17)
    system = rng.randint(0, 97, 12).astype(np.int32)
    tails = [rng.randint(0, 97, n).astype(np.int32) for n in (1, 5, 9)]
    other = rng.randint(0, 97, 20).astype(np.int32)

    def scenario(eng):
        out = _wave(eng, [(system, 2, {})])
        out += _wave(eng, [(np.concatenate([system, t]), 4, {})
                           for t in tails])
        out += _wave(eng, [(other, 8, {}), (system, 3, {"cache": False})])
        out += _wave(eng, [(other, 8, {}), (np.concatenate(
            [system, tails[2]]), 4, {})])
        return out

    _, d = both(models, scenario, max_slots=2, num_pages=14, max_seq_len=32)
    assert d["prefix_hit"] > 0 and d["prefix_miss"] > 0
    assert d["prefix_evictions"] > 0


def test_dropped_engine_is_freed_without_a_gc_pass(models):
    """The allocator's retain and evict hooks hold the engine weakly: an
    engine dropped by its last reference frees its pools at once, as it
    did before the prefix store, not at the next garbage collection."""
    import gc
    import weakref
    eng = DecodeEngine(models[11][1], EngineConfig(**ECFG), device="cpu")
    _wave(eng, [(_ids(21, 9), 3, {})])
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()
