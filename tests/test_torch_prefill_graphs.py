"""The port's prefill and chunk step programs (`paddle_tpu_torch/inference/
engine.py::_prefill_program` / `_chunk_program`, which the card captures as
CUDA graphs) held against the JAX engine's, at the tiny config of
`tests/test_no_retrace.py` (vocab 64, 32 wide, 2 layers, ``page_size=4``)
on the same numpy-drawn weights:

- one-shot, chunked (``prefill_chunk_tokens``), prefix-tail and sampling
  engines give the JAX engine's tokens; after ``warmup(prompt_lens=...,
  tail_lens=...)`` the program cache stays frozen under the traffic and its
  counter deltas equal the JAX ``engine.*`` ones;
- every prefill and chunk upload equals the JAX engine's packed array word
  for word (``ids | length | row[ | tail]``, ``ids | start | valid | row[ |
  tail]``);
- on a sampling engine a non-final chunk leaves the slot's key chain as it
  was and only the final chunk advances it, as in JAX;
- `gpt.prefill_step` / `prefill_chunk_step` and `_plain_prefill_attention`
  with 0-d tensor ``length`` / ``start`` / ``valid`` equal their int form
  exactly, and `check_prefill_graph` leaves the engine as it was.

The port runs on the CPU (``device="cpu"``), where each program entry runs
its body eagerly; the card's graphs are held in `tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.inference.engine as jengine
from paddle_tpu.inference.engine import DecodeEngine as JEngine
from paddle_tpu.inference.engine import EngineConfig as JConfig
from paddle_tpu_torch.inference import engine as tengine
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre
from paddle_tpu_torch.models import gpt as tgpt
from tests.test_torch_graphs import (TINY, _ids, _programs, _results,  # noqa
                                     both, models)
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.tensor import torch_state


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


ECFG = dict(page_size=4, max_slots=3, min_bucket=8)
SAMPLED = [dict(temperature=0.8, top_k=5, seed=1), {},
           dict(temperature=1.2, seed=4), dict(temperature=0.7, seed=9)]


@pytest.fixture
def uploads(monkeypatch):
    """Every prefill and chunk upload of both engines: the JAX engine's
    1-D int32 ``jax.device_put`` arrays (its decode state is 2-D), the
    port's entry host buffers as they are copied."""
    rec = {"jax": [], "port": []}
    put = jengine.jax.device_put

    def jax_put(x, *a, **k):
        if isinstance(x, np.ndarray) and x.ndim == 1 and x.dtype == np.int32:
            rec["jax"].append(x.copy())
        return put(x, *a, **k)

    upload = tengine._PrefillEntry.upload

    def port_upload(self, eng):
        rec["port"].append(self.host_np.copy())
        return upload(self, eng)

    monkeypatch.setattr(jengine.jax, "device_put", jax_put)
    monkeypatch.setattr(tengine._PrefillEntry, "upload", port_upload)
    return rec


def _same_uploads(rec):
    assert len(rec["port"]) == len(rec["jax"]) > 0
    for got, want in zip(rec["port"], rec["jax"]):
        np.testing.assert_array_equal(got, want)


def _traffic(prompt_lens, tail_lens=(), params=None, prompts=None):
    """A scenario: warm up for ``prompt_lens`` / ``tail_lens``, serve one
    request, freeze the compile count, then serve ``prompts`` (or prompts
    of ``prompt_lens``) staggered, with ``params`` per request, and check
    the count stayed frozen."""
    def scenario(eng, rng):
        eng.warmup(prompt_lens=prompt_lens, tail_lens=tail_lens)
        first = eng.submit(_ids(rng, prompt_lens[0]), 2)
        eng.run_until_idle(max_steps=50)
        outs = _results([first])
        frozen = _programs(eng)["compile_count"]
        ps = prompts(rng) if prompts else [_ids(rng, n) for n in prompt_lens]
        kws = params or [{}] * len(ps)
        reqs = [eng.submit(p, 4, **kw) for p, kw in zip(ps[:-1], kws)]
        eng.step()
        reqs.append(eng.submit(ps[-1], 5, **kws[len(ps) - 1]))
        eng.run_until_idle(max_steps=200)
        assert _programs(eng)["compile_count"] == frozen
        return outs + _results(reqs)
    return scenario


def _prefix_prompts(rng):
    system = _ids(rng, 12)
    return [np.concatenate([system, _ids(rng, n)]) for n in (2, 5, 7, 3)]


CASES = {
    # bucket 8 and 16, one-shot
    "one_shot": (dict(ECFG, prefix_cache=False), (5, 13, 8, 16), (), None,
                 None),
    # prompts past 8 tokens run in chunks of 8, one a step
    "chunked": (dict(ECFG, prefix_cache=False, prefill_chunk_tokens=8),
                (6, 13, 20, 9), (), None, None),
    # a 12-token system prompt: the first request misses, the rest prefill
    # only their tails, at the tail's bucket of 8
    "prefix_tail": (dict(ECFG, max_slots=2), (14,), (5,), None,
                    _prefix_prompts),
    "sampled": (dict(ECFG, prefix_cache=False, sampling=True),
                (5, 13, 8, 16), (), SAMPLED, None),
    "sampled_chunked": (dict(ECFG, prefix_cache=False, sampling=True,
                             prefill_chunk_tokens=8),
                        (6, 13, 20, 9), (), SAMPLED, None),
    "sampled_prefix_tail": (dict(ECFG, max_slots=2, sampling=True), (14,),
                            (5,), SAMPLED, _prefix_prompts),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_programs_match_the_jax_engine(models, uploads, case):
    ecfg, lens, tails, params, prompts = CASES[case]
    eng, delta = both(models, _traffic(lens, tails, params, prompts), **ecfg)
    _same_uploads(uploads)
    keys = {k[0] for k in eng._programs}
    assert delta["compile_count"] == delta["cache_miss"] == len(
        eng._programs)
    if "chunked" in case:
        assert eng.counters["prefill_chunks"] > eng.counters["prefills"] > 0
        assert ("prefill_chunk", 8, "plain") in eng._programs
    if "prefix" in case:
        assert eng.counters["prefix_hit"] >= 3
        assert keys == {"decode", "prefill", "prefill_chunk"}


def test_packed_layouts_are_the_jax_words(models, uploads):
    """One request of each upload kind, word by word: a one-shot prefill,
    then three chunks of a sampled chunked prefill (the sample tail on
    every chunk, the seed key and ``final`` only on the last)."""
    def scenario(eng, rng):
        reqs = [eng.submit(_ids(rng, 6), 2, temperature=0.9, top_k=3,
                           seed=7),
                eng.submit(_ids(rng, 19), 2, temperature=1.1, seed=5)]
        eng.run_until_idle(max_steps=50)
        return _results(reqs)

    both(models, scenario, **ECFG, prefix_cache=False, sampling=True,
         prefill_chunk_tokens=8)
    _same_uploads(uploads)
    one, *chunks = uploads["port"]
    maxp = 64 // 4
    assert one.size == 8 + 1 + maxp + 5 and one[8] == 6
    assert [c.size for c in chunks] == [8 + 2 + maxp + 6] * 3
    assert [(c[8], c[9], c[-1]) for c in chunks] == [(0, 8, 0), (8, 8, 0),
                                                    (16, 3, 1)]
    tail = 8 + 2 + maxp
    assert not chunks[0][tail + 1:tail + 3].any()      # no key words yet
    assert chunks[2][tail + 1:tail + 3].any()


def test_only_the_final_chunk_moves_the_key_chain(models):
    """A sampled request prefilled in three chunks: its slot's key row keeps
    a planted value through the two non-final chunks (the program writes
    it back as it was) and takes the request's first draw's key at the
    final one, equal to the JAX engine's row at every step."""
    jm, tm = models[11]
    ecfg = dict(ECFG, prefix_cache=False, sampling=True,
                prefill_chunk_tokens=8)
    prompt = _ids(np.random.RandomState(2), 20)
    planted = np.array([12345, 67890], np.uint32)
    rows = {}
    for name, eng in (("jax", JEngine(jm, JConfig(**ecfg))),
                      ("port", DecodeEngine(tm, EngineConfig(**ecfg),
                                            device="cpu"))):
        if name == "jax":
            eng._keys_dev = eng._keys_dev.at[0].set(planted)
            row = lambda: np.asarray(eng._keys_dev[0]).astype(np.int64)  # noqa
        else:
            eng._keys_dev[0] = torch.from_numpy(planted.astype(np.int64))
            row = lambda: eng._keys_dev[0].numpy().copy()  # noqa
        req = eng.submit(prompt, 3, temperature=0.8, top_k=5, seed=3)
        seen = []
        while eng.step():
            seen.append(row())
        assert req.done
        rows[name] = seen
    # the JAX engine's in-flight harvest may take one step more to idle
    n = len(rows["port"])
    assert n >= 4
    np.testing.assert_array_equal(rows["port"], rows["jax"][:n])
    # steps 1-2 run the non-final chunks, step 3 the final one
    assert (rows["port"][0] == planted).all()
    assert (rows["port"][1] == planted).all()
    assert not (rows["port"][2] == planted).all()


def _chunk_inputs(seed, c=8, quant=False):
    rng = np.random.RandomState(seed)
    nh, dh, ps, maxp = 2, 8, 4, 6
    kp = torch.from_numpy(rng.randn(1 + maxp, ps, nh, dh).astype(np.float32))
    vp = torch.from_numpy(rng.randn(1 + maxp, ps, nh, dh).astype(np.float32))
    q = torch.from_numpy(rng.randn(1, c, nh, dh).astype(np.float32))
    row = torch.from_numpy((1 + rng.permutation(maxp)).astype(np.int32))
    scales = ()
    if quant:
        (kp, ks), (vp, vs) = pa.quantize_kv(kp), pa.quantize_kv(vp)
        scales = (ks, vs)
    return q, kp, vp, row, scales


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("start,valid", [(0, 0), (0, 1), (0, 8), (5, 8),
                                         (13, 3), (16, 8)])
def test_plain_prefill_takes_device_scalars(quant, start, valid):
    q, kp, vp, row, sc = _chunk_inputs(start + valid, quant=quant)
    want = pa._plain_prefill_attention(q, kp, vp, row, start, valid, *sc)
    got = pa.prefill_attention(q, kp, vp, row, _i32(start), _i32(valid),
                               *sc)
    assert torch.equal(got, want)
    for coords in (pa.chunk_page_coords(row, start, valid, 8, 4),):
        for a, b in zip(coords, pa.chunk_page_coords(row, _i32(start),
                                                     _i32(valid), 8, 4)):
            assert torch.equal(a, b)


def _tiny_model():
    return tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY),
                               generator=torch.Generator().manual_seed(5))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_gpt_prefill_steps_take_device_scalars(quant):
    """The one-shot step with a 0-d ``length`` and the chunk step with 0-d
    ``start`` / ``valid`` equal their int form exactly: logits and pools."""
    model = _tiny_model()
    params = {k: v.detach() for k, v in torch_state(model).items()}
    cfg = model.cfg
    nh = cfg.num_heads
    shape = (cfg.num_layers, 9, 4, nh, cfg.hidden_size // nh)
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, 64, 16).astype(np.int32))
    row = torch.arange(1, 9, dtype=torch.int32)

    def pools():
        kp = torch.zeros(shape, dtype=torch.int8 if quant else torch.float32)
        sc = dict(k_scale=torch.zeros(shape[:4]),
                  v_scale=torch.zeros(shape[:4])) if quant else {}
        return kp, kp.clone(), sc

    for step, args in ((tgpt.prefill_step, (11,)),
                       (tgpt.prefill_chunk_step, (7, 9)),
                       (tgpt.prefill_chunk_step, (0, 16)),
                       (tgpt.prefill_chunk_step, (20, 1))):
        outs = []
        for form in (lambda x: x, _i32):
            kp, vp, sc = pools()
            out = step(params, ids, *map(form, args), row, kp, vp, cfg=cfg,
                       **sc)
            outs.append(out)
        for a, b in zip(*outs):
            assert torch.equal(a, b), (step.__name__, args)


def test_wrapper_checks_host_bounds_and_scalar_tensors():
    """The CUDA wrappers refuse a start/valid tensor that is not a
    one-element int32 tensor on q's device, and still range-check host
    ints, before any device is touched."""
    q, kp, vp, row, _ = _chunk_inputs(0)
    q = q[0]
    for bad, match in ((torch.tensor(3), "one-element int32"),
                       (torch.tensor([1, 2], dtype=torch.int32),
                        "one-element int32")):
        with pytest.raises(ValueError, match=match):
            cpre.paged_prefill(q, kp, vp, row, 0, bad)
        with pytest.raises(ValueError, match=match):
            cpre.paged_prefill(q, kp, vp, row, bad, 4)
    with pytest.raises(ValueError, match="out of range"):
        cpre.paged_prefill(q, kp, vp, row, _i32(0), 9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cpre.paged_prefill(q, kp, vp, row, _i32(0), _i32(4))


@pytest.mark.parametrize("ecfg", [{}, {"sampling": True},
                                  {"kv_dtype": "int8"},
                                  {"sampling": True,
                                   "prefill_chunk_tokens": 8}],
                         ids=["greedy", "sampled", "int8", "sampled_chunk"])
def test_check_prefill_graph_leaves_the_engine_as_it_was(models, ecfg):
    """`check_prefill_graph` (the card's graph-against-eager check of a
    prefill or chunk program) on the CPU: both runs are the eager body and
    agree, and the engine then serves the tokens and counters it serves
    without the check."""
    _, tm = models[11]
    cfg = EngineConfig(**ECFG, prefix_cache=False, **ecfg)
    rng = np.random.RandomState(4)
    prompts = [_ids(rng, 10), _ids(rng, 5)]
    kw = dict(temperature=0.8, top_k=5, seed=1) if cfg.sampling else {}
    outs, counts = [], []
    for check in (False, True):
        eng = DecodeEngine(tm, cfg, device="cpu")
        reqs = [eng.submit(p, 6, **kw) for p in prompts]
        eng.step()
        if check:
            for start in (0, 8):
                graph, eager = eng.check_prefill_graph(_ids(rng, 14), start,
                                                       **kw)
                for k in ("tokens", "keys", "logits"):
                    if graph[k] is None:
                        assert eager[k] is None
                    else:
                        assert torch.equal(graph[k], eager[k]), k
                assert all(torch.equal(a, b) for a, b in
                           zip(graph["pools"], eager["pools"]))
        eng.run_until_idle(max_steps=100)
        outs.append(_results(reqs))
        counts.append({k: v for k, v in eng.counters.items()
                       if k not in ("cache_hit", "cache_miss",
                                    "compile_count")})
    for a, b in zip(*outs, strict=True):
        np.testing.assert_array_equal(a, b)
    assert counts[0] == counts[1]
