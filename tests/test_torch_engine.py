"""`paddle_tpu_torch.inference.engine.DecodeEngine` held against the JAX
package's `DecodeEngine` and `fast_generate` on the same numpy-drawn
weights: greedy tokens must be EQUAL for mixed prompt lengths, more
requests than slots, page-boundary crossings, chunked prefill and EOS
retirement, and every page returns to the pool when the engine idles.

The port runs on the CPU here (``device="cpu"``: the plain PyTorch
versions of its kernels); the JAX engine runs its CPU arms.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import DecodeEngine as JEngine
from paddle_tpu.inference.engine import EngineConfig as JConfig
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=64)
ECFG = dict(page_size=4, max_slots=2, min_bucket=8)


def _weights(seed):
    rng = np.random.RandomState(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    w = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v._data.shape)
        base = 1.0 if k.endswith("ln_1.weight") or k.endswith(
            "ln_2.weight") or k.endswith("ln_f.weight") else 0.0
        w[k] = (base + rng.randn(*shape) * 0.1).astype(np.float32)
    return w


@pytest.fixture(scope="module")
def models():
    w = _weights(11)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    jm.set_state_dict(w)
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL))
    tm.set_state_dict(params_from_numpy(w, "cpu"))
    return jm, tm


PROMPT_LENS = (3, 13, 21, 5, 9)   # chunked (>8) and one-shot, 5 > 2 slots


def _prompts():
    rng = np.random.RandomState(12)
    return [rng.randint(0, SMALL["vocab_size"], n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, prompts, n):
    reqs = [engine.submit(p, max_new_tokens=n) for p in prompts]
    engine.run_until_idle(max_steps=400)
    return [r.result(timeout=30) for r in reqs]


def test_engine_matches_jax_engine_chunked_and_eos(models):
    jm, tm = models
    prompts = _prompts()
    kw = dict(ECFG, prefill_chunk_tokens=8)
    want = _serve(JEngine(jm, JConfig(**kw)), prompts, 7)
    eng = DecodeEngine(tm, EngineConfig(**kw), device="cpu")
    got = _serve(eng, prompts, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    assert eng.counters["prefill_chunks"] == sum(
        -(-n // 8) for n in PROMPT_LENS if n > 8)
    # one packed upload per decode step, per one-shot prefill, per chunk
    one_shot = sum(1 for n in PROMPT_LENS if n <= 8)
    assert eng.counters["prefills"] == one_shot
    assert eng.counters["h2d_transfers"] == (
        eng.counters["steps"] + one_shot + eng.counters["prefill_chunks"])

    # EOS: a token the third request emits mid-generation retires it early
    eos = int(got[2][PROMPT_LENS[2] + 3])
    want = _serve(JEngine(jm, JConfig(**kw, eos_id=eos)), prompts, 7)
    eng = DecodeEngine(tm, EngineConfig(**kw, eos_id=eos), device="cpu")
    got_eos = _serve(eng, prompts, 7)
    for g, w in zip(got_eos, want):
        np.testing.assert_array_equal(g, w)
    assert len(got_eos[2]) <= PROMPT_LENS[2] + 4 < len(got[2])
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1


def test_engine_matches_fast_generate(models):
    jm, tm = models
    eng = DecodeEngine(tm, EngineConfig(**ECFG), device="cpu")
    for p in _prompts()[:2]:     # crosses page boundaries while decoding
        want = np.asarray(jm.fast_generate(
            paddle.Tensor(p[None], _internal=True),
            max_new_tokens=6).numpy())[0]
        np.testing.assert_array_equal(_serve(eng, [p], 6)[0], want)


def test_submit_validation_and_pool_exhaustion(models):
    _, tm = models
    eng = DecodeEngine(tm, EngineConfig(**ECFG, max_seq_len=16),
                       device="cpu")
    for bad in (dict(prompt_ids=[], max_new_tokens=2),
                dict(prompt_ids=[1, 2], max_new_tokens=0),
                dict(prompt_ids=list(range(15)), max_new_tokens=2),
                dict(prompt_ids=[1, SMALL["vocab_size"]], max_new_tokens=2),
                dict(prompt_ids=np.array([2 ** 32 + 1]), max_new_tokens=2),
                dict(prompt_ids=[0.5, 1.0], max_new_tokens=2)):
        with pytest.raises(ValueError):
            eng.submit(**bad)
    small = DecodeEngine(tm, EngineConfig(**ECFG, num_pages=3),
                         device="cpu")
    r = small.submit(np.arange(9, dtype=np.int32), max_new_tokens=2)
    small.run_until_idle(max_steps=10)
    with pytest.raises(RuntimeError, match="pages"):
        r.result(timeout=5)


def test_model_dtype_sets_pool_dtype(models):
    _, tm = models
    eng = DecodeEngine(copy.deepcopy(tm).to(torch.bfloat16),
                       EngineConfig(**ECFG), device="cpu")
    assert eng._kc.dtype == torch.bfloat16
    out = _serve(eng, _prompts()[:1], 3)[0]
    assert out.shape == (PROMPT_LENS[0] + 3,)
    assert ((0 <= out) & (out < SMALL["vocab_size"])).all()
