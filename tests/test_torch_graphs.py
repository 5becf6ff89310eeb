"""The port's step programs (`paddle_tpu_torch/inference/engine.py::
_compiled`, the decode and verify steps that the card captures as CUDA
graphs) held against the JAX engine's AOT program cache, at the tiny
config of `tests/test_no_retrace.py` (vocab 64, 32 wide, 2 layers,
``page_size=4``, ``max_slots=3``) on the same numpy-drawn weights:

- the no-retrace scenarios, each run on both engines: slot churn, the
  verify step under draft churn, a prefix hit, a tier re-upload, int8 KV
  with int8 weights. After ``warmup(prompt_lens=[8])`` the port's
  ``compile_count`` stays frozen under the churn, its ``cache_hit`` /
  ``cache_miss`` / ``compile_count`` deltas equal the JAX engine's
  ``engine.*`` ones, and the tokens are equal;
- `refresh_params` copies the new weights into the engine's tensors (the
  same ``data_ptr()``s, the model's own tensors untouched) and the tokens
  after it equal the JAX engine's after its `refresh_params`;
- `submit` and `warmup` take the JAX parameter order (ROADMAP C9), and the
  one parameter that is not ported, ``trace`` (ROADMAP A5.4), raises.

The port runs on the CPU (``device="cpu"``), where each entry of the
program cache runs its step eagerly; the card's graphs are held in
`tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference.engine import DecodeEngine as JEngine
from paddle_tpu.inference.engine import EngineConfig as JConfig
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import metrics
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.quantization.serving import QuantizedLeaf

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64)
PROGRAM_KEYS = ("cache_hit", "cache_miss", "compile_count")


def _weights(seed):
    rng = np.random.RandomState(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    w = {}
    for k, v in jm.state_dict().items():
        base = 1.0 if k.endswith(("ln_1.weight", "ln_2.weight",
                                  "ln_f.weight")) else 0.0
        w[k] = (base + rng.randn(*v._data.shape) * 0.1).astype(np.float32)
    return w


def _pair(seed):
    w = _weights(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    jm.set_state_dict(w)
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY))
    tm.load_state_dict(params_from_numpy(w, "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return {11: _pair(11), 12: _pair(12)}


def _programs(eng):
    """The engine's program-cache counters, the JAX ones from its metrics
    (process-wide, so read as deltas around one engine's run)."""
    if isinstance(eng, JEngine):
        snap = metrics.snapshot()["counters"]
        return {k: snap.get("engine." + k, 0) for k in PROGRAM_KEYS}
    return {k: eng.counters[k] for k in PROGRAM_KEYS}


def _ids(rng, n):
    return rng.randint(0, TINY["vocab_size"], n).astype(np.int32)


def both(models, scenario, seed=11, **ecfg):
    """Run ``scenario(engine, rng)`` on a JAX engine and on the port's, both
    of ``EngineConfig(**ecfg)`` over the weights of ``seed``, each with
    its own ``RandomState(0)``. Asserts equal outputs and equal program
    counter deltas; returns the port's engine and those deltas."""
    jm, tm = models[seed]
    outs, deltas = {}, {}
    for name, eng in (("jax", JEngine(jm, JConfig(**ecfg))),
                      ("port", DecodeEngine(tm, EngineConfig(**ecfg),
                                            device="cpu"))):
        before = _programs(eng)
        outs[name] = scenario(eng, np.random.RandomState(0))
        deltas[name] = {k: v - before[k] for k, v in _programs(eng).items()}
    for got, want in zip(outs["port"], outs["jax"], strict=True):
        np.testing.assert_array_equal(got, want)
    assert deltas["port"] == deltas["jax"]
    return eng, deltas["port"]


def _results(reqs):
    return [r.result(timeout=30) for r in reqs]


def _serve(eng, *submits):
    """Submit ``(prompt, max_new_tokens)`` pairs, run the engine idle and
    return the outputs."""
    reqs = [eng.submit(p, n) for p, n in submits]
    eng.run_until_idle(max_steps=200)
    return _results(reqs)


def _slot_churn(eng, rng):
    """test_no_retrace.py::test_slot_churn_zero_recompiles."""
    eng.warmup(prompt_lens=[8])
    first = eng.submit(_ids(rng, 5), 3)
    eng.run_until_idle(max_steps=20)
    frozen = _programs(eng)["compile_count"]
    reqs = [eng.submit(_ids(rng, 3 + i), 2 + i) for i in range(3)]
    for _ in range(2):
        eng.step()
    reqs.append(eng.submit(_ids(rng, 8), 4))
    eng.run_until_idle(max_steps=100)
    assert _programs(eng)["compile_count"] == frozen
    return _results([first] + reqs)


def test_slot_churn_keeps_the_program_cache_frozen(models):
    eng, delta = both(models, _slot_churn, page_size=4, max_slots=3,
                      min_bucket=8)
    # decode + bucket 8 at warm-up, then one hit a decode step and a
    # prefill
    assert delta["compile_count"] == delta["cache_miss"] == 2
    assert delta["cache_hit"] == eng.counters["steps"] \
        + eng.counters["prefills"]
    assert set(eng._programs) == {("decode", "plain"),
                                  ("prefill", 8, "plain")}


def _draft_churn(eng, rng):
    """test_no_retrace.py::test_verify_step_compiles_once."""
    eng.warmup(prompt_lens=[8])
    first = eng.submit(_ids(rng, 5), 3)
    eng.run_until_idle(max_steps=30)
    frozen = _programs(eng)["compile_count"]
    reqs = [eng.submit(np.tile(_ids(rng, 2), 3), 8)]
    reqs += [eng.submit(_ids(rng, 3 + i), 4 + i) for i in range(2)]
    eng.step()
    reqs.append(eng.submit(_ids(rng, 7), 5))
    eng.run_until_idle(max_steps=120)
    assert _programs(eng)["compile_count"] == frozen
    return _results([first] + reqs)


def test_verify_step_is_one_program_under_draft_churn(models):
    eng, delta = both(models, _draft_churn, page_size=4, max_slots=3,
                      min_bucket=8, speculate_k=3, prefix_cache=False)
    assert eng.counters["spec_steps"] > 0 and eng.counters["spec_drafted"]
    assert delta["compile_count"] == 2
    assert ("verify", 3) in eng._programs


def _prefix_hit(eng, rng):
    """test_no_retrace.py::test_prefix_hit_skips_prefill_programs, after a
    warm-up."""
    eng.warmup(prompt_lens=[8])
    prompt = _ids(rng, 16)
    outs = []
    counts = []
    for _ in range(3):                   # miss, first hit, warm hit
        outs += _serve(eng, (prompt, 3))
        counts.append(_programs(eng)["compile_count"])
    assert counts[1] == counts[0] + 1    # the tail's chunk program
    assert counts[2] == counts[1]
    return outs


def test_prefix_hit_adds_one_tail_program_then_none(models):
    eng, delta = both(models, _prefix_hit, page_size=4, max_slots=2,
                      min_bucket=8)
    assert eng.counters["prefix_hit"] == 2
    assert ("prefill_chunk", 8, "plain") in eng._programs


def _demote_idle(eng):
    """Evict every idle cached page (demoting it to the tiers) and free
    it: the JAX engine's `_shrink_prefix`, the port's evict hook."""
    if isinstance(eng, JEngine):
        eng._shrink_prefix()
        return
    idle = eng._evict_prefix_pages(len(eng._prefix_idle))
    if idle:
        eng.allocator.reclaim(idle)


def _tier_reupload(eng, rng):
    """test_no_retrace.py::test_tier_reupload_zero_recompiles."""
    eng.warmup(prompt_lens=[8])
    prompt = _ids(rng, 16)
    outs = _serve(eng, (prompt, 3))               # miss: bucket 16
    outs += _serve(eng, (prompt, 3))              # HBM hit: the tail entry
    _demote_idle(eng)
    frozen = _programs(eng)["compile_count"]
    outs += _serve(eng, (prompt, 3))              # tier hit: re-upload
    assert _programs(eng)["compile_count"] == frozen
    return outs


def test_tier_reupload_adds_no_program(models):
    eng, _ = both(models, _tier_reupload, page_size=4, max_slots=2,
                  min_bucket=8, kv_host_tier_bytes=1 << 20)
    assert eng.counters["kvtier_reuploads_host"] > 0


def _int8_churn(eng, rng):
    """test_no_retrace.py::test_int8_engine_zero_recompiles_same_program_
    count, the int8 engine's half."""
    eng.warmup(prompt_lens=[8])
    first = eng.submit(_ids(rng, 5), 3)
    eng.run_until_idle(max_steps=30)
    frozen = _programs(eng)["compile_count"]
    reqs = [eng.submit(_ids(rng, 3 + i), 2 + i) for i in range(3)]
    for _ in range(2):
        eng.step()
    reqs.append(eng.submit(_ids(rng, 8), 4))
    eng.run_until_idle(max_steps=100)
    assert _programs(eng)["compile_count"] == frozen
    return _results([first] + reqs)


def test_int8_engine_keeps_the_float_engines_program_count(models):
    ecfg = dict(page_size=4, max_slots=3, min_bucket=8)
    float_eng, _ = both(models, _int8_churn, **ecfg)
    eng, _ = both(models, _int8_churn, kv_dtype="int8", weight_dtype="int8",
                  **ecfg)
    assert eng._quant_kv
    assert len(eng._programs) == len(float_eng._programs) == 2


@pytest.mark.parametrize("weight_dtype", ["native", "int8"])
def test_refresh_params_copies_in_place_and_follows_new_weights(
        models, weight_dtype):
    (jm, tm), (jm2, tm2) = models[11], models[12]
    model_before = {k: v.clone() for k, v in tm.state_dict().items()}
    ptrs = {}

    def tensors(eng):
        for k, v in eng._params.items():
            if isinstance(v, QuantizedLeaf):
                yield k + ".q", v.q
                yield k + ".scale", v.scale
            else:
                yield k, v

    def scenario(eng, rng):
        eng.warmup(prompt_lens=[8])
        prompts = [_ids(rng, 6), _ids(rng, 11)]
        outs = _serve(eng, *((p, 5) for p in prompts))
        frozen = _programs(eng)["compile_count"]
        if isinstance(eng, JEngine):
            eng.refresh_params(jm2)
        else:
            before = {k: t.data_ptr() for k, t in tensors(eng)}
            eng.refresh_params(tm2)
            ptrs.update(before=before, after={k: t.data_ptr()
                                              for k, t in tensors(eng)})
        outs += _serve(eng, *((p, 5) for p in prompts))
        assert _programs(eng)["compile_count"] == frozen
        return outs

    eng, _ = both(models, scenario, page_size=4, max_slots=3, min_bucket=8,
                  weight_dtype=weight_dtype)
    assert ptrs["after"] == ptrs["before"]
    for k, v in tm.state_dict().items():          # the first model untouched
        assert torch.equal(v, model_before[k]), k
    # the new weights are the second model's (its re-quantization under
    # int8 weights)
    fresh = DecodeEngine(tm2, EngineConfig(page_size=4, max_slots=3,
                                           weight_dtype=weight_dtype),
                         device="cpu")
    for (k, a), (_, b) in zip(tensors(eng), tensors(fresh), strict=True):
        assert torch.equal(a, b), k


def test_refresh_params_refuses_other_shapes(models):
    _, tm = models[11]
    eng = DecodeEngine(tm, EngineConfig(page_size=4, max_slots=3),
                       device="cpu")
    other = tgpt.GPTForCausalLM(tgpt.GPTConfig(**dict(TINY,
                                                      intermediate_size=96)))
    with pytest.raises(ValueError, match="shapes differ"):
        eng.refresh_params(other)
    with pytest.raises(ValueError, match="computes in"):
        eng.refresh_params(tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY)).to(
            torch.bfloat16))


def test_submit_and_warmup_take_the_jax_parameter_order(models):
    """ROADMAP C9: a third positional argument is ``trace`` in both
    engines, so ``submit(ids, 4, None)`` keeps the prefix cache on (the
    second submit of a prompt is a hit in both), and ``warmup((8,), ())``
    makes the same programs."""
    keys = ("prefix_hit", "prefix_miss", "prefill_tokens")

    def scenario(eng, rng):
        eng.warmup((8,), ())
        prompt = _ids(rng, 13)
        outs = []
        for _ in range(2):
            req = eng.submit(prompt, 4, None)
            eng.run_until_idle(max_steps=50)
            outs += _results([req])
        if isinstance(eng, JEngine):
            snap = metrics.snapshot()["counters"]
            counts = {k: snap.get("engine." + k, 0) for k in keys}
        else:
            counts = {k: eng.counters[k] for k in keys}
        return outs + [np.array([counts[k] for k in keys])]

    jm, _ = models[11]
    base = metrics.snapshot()["counters"]
    j0 = np.array([base.get("engine." + k, 0) for k in keys])
    outs = {}
    for name, eng in (("jax", JEngine(jm, JConfig(page_size=4, max_slots=3,
                                                  min_bucket=8))),
                      ("port", DecodeEngine(models[11][1], EngineConfig(
                          page_size=4, max_slots=3, min_bucket=8),
                          device="cpu"))):
        outs[name] = scenario(eng, np.random.RandomState(0))
    outs["jax"][-1] = outs["jax"][-1] - j0
    for got, want in zip(outs["port"], outs["jax"], strict=True):
        np.testing.assert_array_equal(got, want)
    assert outs["port"][-1][0] == 1                  # the second submit hit


@pytest.mark.parametrize("kw", [{"trace": object()}])
def test_submit_refuses_parameters_that_are_not_ported(models, kw):
    """``trace`` is ported: like the JAX engine, the port takes it in third
    place and refuses one that is not a request trace (AttributeError at
    its first mark) before anything is queued."""
    jm, tm = models[11]
    refused = []
    for eng in (JEngine(jm, JConfig(page_size=4, max_slots=3)),
                DecodeEngine(tm, EngineConfig(page_size=4, max_slots=3),
                             device="cpu")):
        with pytest.raises(AttributeError, match="mark_submit") as e:
            eng.submit(np.arange(5), 3, kw["trace"])
        refused.append(type(e.value))
        assert not eng._queue
    assert refused[0] is refused[1]


@pytest.mark.parametrize("ecfg", [{}, {"sampling": True},
                                  {"sampling": True, "speculate_k": 3},
                                  {"kv_dtype": "int8"}],
                         ids=["greedy", "sampled", "speculative", "int8"])
def test_check_step_graph_leaves_the_engine_as_it_was(models, ecfg):
    """`check_step_graph` (the card's graph-against-eager check) runs the
    next step twice from one state and restores it: on the CPU both runs
    are the eager body, equal, and the engine then serves the tokens it
    serves without the check."""
    _, tm = models[11]
    cfg = EngineConfig(page_size=4, max_slots=3, min_bucket=8,
                       prefix_cache=False, **ecfg)
    rng = np.random.RandomState(3)
    prompts = [np.tile(_ids(rng, 3), 3), _ids(rng, 5)]
    params = [dict(temperature=0.8, top_k=5, seed=1), {}] \
        if cfg.sampling else [{}, {}]
    outs = []
    for check in (False, True):
        eng = DecodeEngine(tm, cfg, device="cpu")
        reqs = [eng.submit(p, 8, **kw) for p, kw in zip(prompts, params)]
        eng.step()
        if check:
            graph, eager = eng.check_step_graph()
            for k in ("tokens", "keys", "logits"):
                if graph[k] is None:
                    assert eager[k] is None
                else:
                    assert torch.equal(graph[k], eager[k]), k
            assert all(torch.equal(a, b) for a, b in zip(graph["pools"],
                                                         eager["pools"]))
            assert (graph["logits"] is None) == bool(cfg.speculate_k)
        eng.run_until_idle(max_steps=100)
        outs.append(_results(reqs))
    for a, b in zip(*outs, strict=True):
        np.testing.assert_array_equal(a, b)


def test_step_graph_needs_a_card_and_replays_add_dispatch_counts():
    """A CUDA graph is refused for a CPU device (the CPU engine runs its
    entries eagerly), and `registry.add_counts`, what a replay adds for the
    dispatches it captured, adds to the counts without resetting them."""
    from paddle_tpu_torch.inference.graphs import StepGraph
    from paddle_tpu_torch.kernels import registry
    with pytest.raises(ValueError, match="CUDA device"):
        StepGraph(lambda: None, "cpu")
    name = "kernel.dispatch.paged_attention.cuda"
    before = registry.counts().get(name, 0)
    registry.add_counts({name: 12})
    registry.add_counts({name: 12})
    assert registry.counts()[name] == before + 24
    registry.add_counts({name: -24})
