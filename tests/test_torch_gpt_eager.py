"""GPT-2 as a Paddle Layer on the port (`paddle_tpu_torch/models/gpt.py`:
GPTAttention, GPTMLP, GPTBlock, GPTModel, GPTForCausalLM) held against the
JAX package's eager Layers and its scanned forward, at 2 layers and 32
wide, on the CPU.

The JAX eager GPT reaches `F.scaled_dot_product_attention`, whose
``apply(..., x64_off=True)`` imports `jax.experimental.disable_x64`, which
jax 0.9 removed (ROADMAP C1). The `jax_eager` fixture answers it inside
the test with a scope that turns ``jax_enable_x64`` off and back; no file
of the JAX package changes. Both packages build their model after one
``paddle.seed``, so the weights are the same draws (within an ulp of
erfinv).

Tolerances (float32): logits and losses within 1e-5, gradients within
1e-4 (two independent backward passes through a dozen products), the
5-step AdamW loop of `tests/test_models.py:38-56` within 1e-5 a step
(its parameters within 1e-4), tokens equal.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jp
import paddle_tpu.core.autograd as jag
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.tensor import torch_state
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import AdamW as FunctionalAdamW
from paddle_tpu_torch.train.scan_step import ScanTrainStep


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


@contextlib.contextmanager
def _x64_off():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def jax_eager(monkeypatch):
    """The JAX package's scoped x64-off, answered for jax 0.9 (C1)."""
    monkeypatch.setattr(jag, "_x64_off_scope", _x64_off)


TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=32,
            hidden_dropout=0.0, attention_dropout=0.0)


def _pair(seed=0, **over):
    kw = dict(TINY, **over)
    jp.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**kw))
    tp.seed(seed)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**kw))
    return jm, tm


def _ids(seed=0, b=2, s=17):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int64)


def _err(a, b):
    return float(np.abs(np.asarray(a.numpy(), np.float64)
                        - np.asarray(b.numpy(), np.float64)).max())


def test_seeded_weights_equal_the_jax_draws():
    jm, tm = _pair()
    js, ts = jm.state_dict(), tm.state_dict()
    assert list(ts) == list(js)
    for k in js:
        assert ts[k].shape == js[k].shape
        assert _err(ts[k], js[k]) <= 1e-7, k
    assert all(isinstance(p, tp.Parameter) and not p.stop_gradient
               for p in tm.parameters())


def test_forward_logits_and_loss_match_scan_and_eager_jax(jax_eager):
    jm, tm = _pair(1)
    ids = _ids(1)
    x, y = ids[:, :-1], ids[:, 1:]
    tlog = tm(tp.to_tensor(x))
    jlog = jm(jp.to_tensor(x))
    assert tlog.shape == [2, 16, 128]
    assert _err(tlog, jlog) <= 1e-5
    # the scanned forward of the JAX package on the same weights (no shim)
    jstacked = jgpt.stack_gpt_params(
        {k: v._data for k, v in jm.state_dict().items()})
    slog = jgpt.scan_logits(jstacked, jax.numpy.asarray(x), jm.cfg)
    assert float(np.abs(tlog.numpy() - np.asarray(slog)).max()) <= 1e-5
    _, tl = tm(tp.to_tensor(x), labels=tp.to_tensor(y))
    _, jl = jm(jp.to_tensor(x), labels=jp.to_tensor(y))
    sl = jgpt.scan_loss(jstacked, jax.numpy.asarray(x), jax.numpy.asarray(y),
                        jm.cfg, training=False)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert abs(float(tl) - float(sl)) <= 1e-5


@pytest.mark.parametrize("fused_ce", [True, False])
def test_gradients_match_jax_eager(jax_eager, fused_ce):
    jm, tm = _pair(2, fused_ce=fused_ce)
    ids = _ids(2)
    m = (np.random.RandomState(3).rand(2, 16) > 0.3).astype(np.float32)
    _, tl = tm(tp.to_tensor(ids[:, :-1]), labels=tp.to_tensor(ids[:, 1:]),
               loss_mask=tp.to_tensor(m))
    _, jl = jm(jp.to_tensor(ids[:, :-1]), labels=jp.to_tensor(ids[:, 1:]),
               loss_mask=jp.to_tensor(m))
    assert abs(float(tl) - float(jl)) <= 1e-5
    tl.backward()
    jl.backward()
    for (n, tpar), jpar in zip(tm.named_parameters(), jm.parameters()):
        assert _err(tpar.grad, jpar.grad) <= 1e-4, n


def test_five_adamw_steps_match_jax(jax_eager):
    """`tests/test_models.py:38-56` on both packages from one seed."""
    jm, tm = _pair(0)
    jo = jp.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    to = tp.optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    ids = _ids(0)
    jx, jy = jp.to_tensor(ids[:, :-1]), jp.to_tensor(ids[:, 1:])
    tx, ty = tp.to_tensor(ids[:, :-1]), tp.to_tensor(ids[:, 1:])
    losses = []
    for _ in range(5):
        _, jl = jm(jx, labels=jy)
        jl.backward()
        jo.step()
        jo.clear_grad()
        _, tl = tm(tx, labels=ty)
        tl.backward()
        to.step()
        to.clear_grad()
        losses.append((float(tl), float(jl)))
    assert all(abs(t - j) <= 1e-5 for t, j in losses), losses
    assert losses[-1][0] < losses[0][0]
    # Adam's step is ~lr whatever the gradient's size, so a gradient near
    # zero that differs in its last bits moves its element by more than
    # the losses differ: parameters within 1e-4 after 5 steps of 1e-3
    for (n, tpar), jpar in zip(tm.named_parameters(), jm.parameters()):
        assert _err(tpar, jpar) <= 1e-4, n


@pytest.mark.parametrize("sampling", [dict(), dict(temperature=0.8, top_k=5,
                                                   seed=3)],
                         ids=["greedy", "sampled"])
def test_generate_tokens_equal_jax(jax_eager, sampling):
    jm, tm = _pair(5)
    prompt = np.array([[1, 2, 3, 4], [9, 8, 7, 6]], np.int64)
    registry.reset_counts()
    tout = tm.generate(tp.to_tensor(prompt), max_new_tokens=6, **sampling)
    jout = jm.generate(jp.to_tensor(prompt), max_new_tokens=6, **sampling)
    assert tout.shape == [2, 10]
    assert np.array_equal(tout.numpy(), jout.numpy())
    # the prompt step and one step a token, each layer's attention through
    # the flash op: Sq = 4, then Sq = 1 against the growing cache
    assert registry.counts()["kernel.dispatch.flash_attention.plain"] == 12
    assert not tm.training


def test_eager_loss_and_step_equal_scan_train_step():
    """The Layer's eager loss and AdamW step equal the port's own
    ScanTrainStep on the same weights (one update rule, two paths)."""
    _, tm = _pair(7)
    ids = _ids(7)
    x, y = ids[:, :-1], ids[:, 1:]
    ts = ScanTrainStep(tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY)),
                       FunctionalAdamW(learning_rate=1e-3), device="cpu")
    ts.model.set_state_dict(tm.state_dict())
    ts.refresh_from_model()
    opt = tp.optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    _, loss = tm(tp.to_tensor(x), labels=tp.to_tensor(y))
    loss.backward()
    opt.step()
    sloss = ts.step(x, y)
    assert abs(float(loss) - sloss) <= 1e-6
    ts.sync_to_model()
    want = torch_state(ts.model)
    for k, v in torch_state(tm).items():
        assert float((v - want[k]).abs().max()) <= 1e-6, k


def test_hidden_dropout_draws_the_seed_stream(jax_eager):
    """With hidden dropout 0.1 the port's eager forward equals the JAX
    package's under one seed when JAX runs with 64-bit types off (its
    float32 masks, ROADMAP C16); a second draw differs."""
    jm, tm = _pair(8, hidden_dropout=0.1)
    ids = _ids(8)
    with _x64_off():
        jp.seed(11)
        _, jl = jm(jp.to_tensor(ids[:, :-1]), labels=jp.to_tensor(ids[:, 1:]))
    tp.seed(11)
    _, tl = tm(tp.to_tensor(ids[:, :-1]), labels=tp.to_tensor(ids[:, 1:]))
    assert abs(float(tl) - float(jl)) <= 1e-5
    _, t2 = tm(tp.to_tensor(ids[:, :-1]), labels=tp.to_tensor(ids[:, 1:]))
    assert float(t2) != float(tl)
    tm.eval()
    _, e1 = tm(tp.to_tensor(ids[:, :-1]), labels=tp.to_tensor(ids[:, 1:]))
    _, e2 = tm(tp.to_tensor(ids[:, :-1]), labels=tp.to_tensor(ids[:, 1:]))
    assert float(e1) == float(e2)


def test_generator_weights_are_the_serving_draws():
    """``generator=`` (the port's extra) draws what the serving and
    scanned phases have always drawn: N(0, 0.02) on the host in
    named_parameters order, biases 0, layernorm scales 1."""
    g = torch.Generator().manual_seed(4)
    m = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY), generator=g)
    g2 = torch.Generator().manual_seed(4)
    for name, p in m.named_parameters():
        if name.endswith("bias"):
            assert float(p._data.detach().abs().max()) == 0.0
        elif p.ndim == 1:
            assert float((p._data.detach() - 1).abs().max()) == 0.0
        else:
            want = torch.empty(p.shape).normal_(0.0, 0.02, generator=g2)
            assert torch.equal(p._data, want), name


@pytest.mark.parametrize("over,match", [
    (dict(recompute=True), "A7.3"),
    (dict(recompute_granularity="mlp"), "A7.3")])
def test_eager_recompute_raises(over, match):
    _, tm = _pair(0, **over)
    ids = _ids(0)
    with pytest.raises(NotImplementedError, match=match):
        tm(tp.to_tensor(ids[:, :-1]), labels=tp.to_tensor(ids[:, 1:]))
    tm.eval()
    assert tm(tp.to_tensor(ids[:, :-1])).shape == [2, 16, 128]
    out = tm.fast_generate(tp.to_tensor(ids[:, :3]), max_new_tokens=4)
    assert out.shape == [2, 7]
    np.testing.assert_array_equal(out.numpy()[:, :3], ids[:, :3])
