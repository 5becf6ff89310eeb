"""`GPTForCausalLM.fast_generate` of the port (`paddle_tpu_torch/models/
gpt.py`) held against the JAX package's `fast_generate` on the same
weights, on the CPU, where the port runs its program eagerly (the card
replays it as one CUDA graph a signature; `chip_smoke.py`'s
``generate_fast``).

The model is JAX `TestFastGenerate`'s (`tests/test_models.py:175-182`:
vocab 97, hidden 32, 2 layers, 2 heads, 64 positions) from
``paddle.seed(7)``, its weights carried to the port with
`models/convert.py::layer_state_from_numpy`. The JAX `fast_generate` runs
here without the C1 work-around (it never reaches the eager attention);
the JAX eager `generate` does not, so the port's own `generate` and
`DecodeEngine` stand in for it where the JAX tests compare against the
eager loop.

Tolerance: none. Tokens are equal in float32 and in bfloat16, where the
port's tokens equal both its own eager `generate` (what the JAX test
asserts of its eager loop) and the JAX bf16 `fast_generate`'s.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import metrics as jmetrics

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.observability import metrics as tmetrics

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position_embeddings=64)
BF16_CFG = dict(CFG, vocab_size=64, max_position_embeddings=32)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


def _pair(seed=7, cfg=CFG, dtype=None):
    """The JAX model from ``paddle.seed(seed)`` (in ``dtype`` as the
    default dtype) and the port's model with its weights."""
    jp.seed(seed)
    prev = jp.get_default_dtype()
    if dtype:
        jp.set_default_dtype(dtype)
    try:
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(
            **cfg, hidden_dropout=0.0, attention_dropout=0.0))
    finally:
        jp.set_default_dtype(prev)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
    layer_state_from_numpy(tm, {k: np.asarray(v._data)
                                for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(seed, b, s, vocab=97):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _jfast(jm, ids, n, **kw):
    return np.asarray(jm.fast_generate(jp.Tensor(ids, _internal=True),
                                       max_new_tokens=n, **kw).numpy())


def _tfast(tm, ids, n, **kw):
    return tm.fast_generate(tp.to_tensor(ids), max_new_tokens=n,
                            **kw).numpy()


@pytest.fixture(scope="module")
def models():
    return _pair()


def test_greedy_tokens_equal_jax(models):
    jm, tm = models
    ids = _ids(0, 2, 8)
    want = _jfast(jm, ids, 12)
    got = _tfast(tm, ids, 12)
    assert got.dtype == np.int32 and got.shape == (2, 20)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature,top_k,seed", [(0.8, 5, 3),
                                                    (1.0, 0, 0),
                                                    (0.8, 5, 4)])
def test_sampled_tokens_equal_jax(models, temperature, top_k, seed):
    jm, tm = models
    ids = _ids(1, 3, 5)
    kw = dict(temperature=temperature, top_k=top_k, seed=seed)
    want = _jfast(jm, ids, 6, **kw)
    got = _tfast(tm, ids, 6, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got[:, :5] == ids).all()
    if seed == 4:        # another seed draws other tokens, on both sides
        other = _tfast(tm, ids, 6, temperature=temperature, top_k=top_k,
                       seed=3)
        assert not np.array_equal(got, other)
        assert not np.array_equal(want, _jfast(
            jm, ids, 6, temperature=temperature, top_k=top_k, seed=3))


def test_one_and_zero_new_tokens_and_the_position_limit(models):
    jm, tm = models
    ids = _ids(2, 2, 4)
    np.testing.assert_array_equal(_tfast(tm, ids, 1), _jfast(jm, ids, 1))
    t_in = tp.to_tensor(ids)
    assert tm.fast_generate(t_in, max_new_tokens=0) is t_in
    j_in = jp.Tensor(ids, _internal=True)
    assert jm.fast_generate(j_in, max_new_tokens=0) is j_in
    long_ids = _ids(3, 1, 60)
    with pytest.raises(ValueError) as want:
        jm.fast_generate(jp.Tensor(long_ids, _internal=True),
                         max_new_tokens=5)
    with pytest.raises(ValueError) as got:
        tm.fast_generate(tp.to_tensor(long_ids), max_new_tokens=5)
    assert str(got.value) == str(want.value)


def test_greedy_equals_the_ports_generate_and_engine(models):
    _, tm = models
    ids = _ids(0, 2, 8)
    fast = _tfast(tm, ids, 12)
    np.testing.assert_array_equal(
        tm.generate(tp.to_tensor(ids), max_new_tokens=12).numpy(), fast)
    eng = DecodeEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                        min_bucket=8), device="cpu")
    reqs = [eng.submit(row, max_new_tokens=12) for row in ids]
    eng.run_until_idle(max_steps=200)
    for r, want in zip(reqs, fast):
        np.testing.assert_array_equal(r.result(timeout=30), want)


def test_signature_cache_holds_eight_oldest_first():
    jm, tm = _pair()
    for s0 in range(1, 11):          # ten signatures: two evictions
        ids = _ids(s0, 1, s0)
        np.testing.assert_array_equal(_tfast(tm, ids, 2), _jfast(jm, ids, 2))
        assert list(tm._fast_decode_cache) == list(jm._fast_decode_cache)
    assert len(tm._fast_decode_cache) == 8
    assert [k[1] for k in tm._fast_decode_cache] == list(range(3, 11))
    _tfast(tm, _ids(5, 1, 5), 2)     # a hit keeps its place
    assert [k[1] for k in tm._fast_decode_cache] == list(range(3, 11))


@pytest.mark.parametrize("how", ["write", "set_state_dict"])
def test_weight_changes_seen_with_the_entry_kept(how):
    jm, tm = _pair()
    ids = _ids(3, 2, 6)
    before = _tfast(tm, ids, 4)
    np.testing.assert_array_equal(before, _jfast(jm, ids, 4))
    prog = tm._fast_decode_cache[(2, 6, 4, 1.0, 0, "float32")]
    # not a constant shift: layernorm and the argmax cancel one
    delta = np.random.RandomState(8).randn(97, 32).astype(np.float32)
    w = np.asarray(jm.gpt.wte.weight._data) + delta
    jm.gpt.wte.weight._write(jp.to_tensor(w)._data)
    if how == "write":
        t = tm.gpt.wte.weight
        t._write(t._data + torch.from_numpy(delta))
    else:
        tm.set_state_dict({"gpt.wte.weight": w})
    after = _tfast(tm, ids, 4)
    assert not np.array_equal(after, before)
    np.testing.assert_array_equal(after, _jfast(jm, ids, 4))
    np.testing.assert_array_equal(
        after, tm.generate(tp.to_tensor(ids), max_new_tokens=4).numpy())
    assert list(tm._fast_decode_cache.values()) == [prog]
    assert len(jm._fast_decode_cache) == 1


def test_bf16_model_decodes():
    jm, tm = _pair(9, BF16_CFG, "bfloat16")
    assert tm.gpt.wte.weight._data.dtype == torch.bfloat16
    ids = _ids(4, 2, 6, vocab=64)
    fast = _tfast(tm, ids, 8)
    np.testing.assert_array_equal(
        fast, tm.generate(tp.to_tensor(ids), max_new_tokens=8).numpy())
    want = _jfast(jm, ids, 8)
    assert list(tm._fast_decode_cache) == list(jm._fast_decode_cache)
    np.testing.assert_array_equal(fast, want)


def _generate_counts(reg):
    snap = reg.snapshot()
    out = {k: v for k, v in snap["counters"].items()
           if k.startswith("generate.")}
    out.update((k, h["count"]) for k, h in snap["histograms"].items()
               if k.startswith("generate."))
    return out


def test_generate_counters_move_as_jax():
    jm, tm = _pair()
    before = (_generate_counts(jmetrics), _generate_counts(tmetrics))
    for n, kw in ((3, {}), (3, {}), (5, dict(temperature=0.7, top_k=4)),
                  (0, {}), (3, {})):
        ids = _ids(n, 2, 4)
        _jfast(jm, ids, n, **kw)
        _tfast(tm, ids, n, **kw)
    deltas = [{k: v - b.get(k, 0) for k, v in _generate_counts(reg).items()}
              for reg, b in zip((jmetrics, tmetrics), before)]
    assert deltas[1] == deltas[0]
    assert deltas[1]["generate.compile_count"] == 2
    assert deltas[1]["generate.calls"] == 4
    assert deltas[1]["generate.tokens"] == 2 * (3 + 3 + 5 + 3)
    assert deltas[1]["generate.decode_seconds"] == 2
    assert tmetrics.snapshot()["gauges"]["generate.tokens_per_s"] > 0
