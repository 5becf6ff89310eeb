"""BERT on the port (`paddle_tpu_torch/models/bert.py`) held against the
JAX package's `paddle_tpu/models/bert.py` on the CPU, at 2 layers and 32
wide: the seeded weights, the logits and pooled output (with and without
an attention mask), the loss and every gradient, 3 steps of the JAX bench's
BERT program (`bench.py:264-295`: AdamW, amp O2 bfloat16, ``to_static``),
and `models/convert.py` both ways.

Tolerances (float32): logits and pooled output within 1e-5, the loss and
gradients within 1e-4 (two independent backward passes through a dozen
products); under amp O2 bfloat16 the losses within 2e-3.
"""
import contextlib

import numpy as np
import pytest

import jax

import paddle_tpu as jp
import paddle_tpu.core.autograd as jag
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import convert

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=16,
            hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
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


def _pair(seed=0, **over):
    kw = dict(TINY, **over)
    out = {}
    for m, b in ((tp, tbert), (jp, jbert)):
        m.seed(seed)
        out[m] = b.BertForSequenceClassification(b.BertConfig(**kw),
                                                 num_classes=3)
    return out


def _ids(seed=0, b=3, s=12):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 64, (b, s)).astype(np.int32),
            rng.randint(0, 3, b).astype(np.int64))


def _err(a, b):
    return float(np.abs(np.asarray(a.numpy(), np.float64)
                        - np.asarray(b.numpy(), np.float64)).max())


def test_seeded_weights_equal_the_jax_draws():
    models = _pair()
    ts, js = models[tp].state_dict(), models[jp].state_dict()
    assert list(ts) == list(js)
    for k in js:
        assert ts[k].shape == js[k].shape
        assert _err(ts[k], js[k]) <= 1e-7, k


@pytest.mark.parametrize("masked", [False, True], ids=["flash", "mask"])
def test_logits_and_pooled_match_jax(jax_eager, masked):
    models = _pair(1)
    x, _ = _ids(1)
    mask = np.ones_like(x)
    mask[:, -4:] = 0
    out = {}
    for m in (tp, jp):
        model = models[m]
        model.eval()
        am = m.to_tensor(mask) if masked else None
        seq, pooled = model.bert(m.to_tensor(x), attention_mask=am)
        out[m] = (model(m.to_tensor(x), attention_mask=am), seq, pooled)
    for a, b in zip(out[tp], out[jp]):
        assert a.shape == b.shape
        assert _err(a, b) <= 1e-5


def test_loss_and_gradients_match_jax(jax_eager):
    models = _pair(2)
    x, y = _ids(2)
    res = {}
    for m in (tp, jp):
        model = models[m]
        _, loss = model(m.to_tensor(x), labels=m.to_tensor(y))
        loss.backward()
        res[m] = (loss, {k: p.grad for k, p in model.named_parameters()})
    assert _err(res[tp][0], res[jp][0]) <= 1e-4
    assert set(res[tp][1]) == set(res[jp][1])
    for k, g in res[tp][1].items():
        assert g is not None, k
        assert _err(g, res[jp][1][k]) <= 1e-4, k


def test_bench_program_o2_to_static_matches_jax(jax_eager):
    """`bench_bert`'s step: O2 bfloat16, the logits cast to float32 for
    the loss, three ``to_static`` calls."""
    models = _pair(3)
    x, y = _ids(3, b=4)
    losses = {}
    for m in (tp, jp):
        model = models[m]
        opt = m.optimizer.AdamW(learning_rate=2e-5,
                                parameters=model.parameters())
        model, opt = m.amp.decorate(model, opt, level="O2", dtype="bfloat16")

        @m.jit.to_static
        def train_step(a, b):
            with m.amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = model(a)
                loss = m.nn.functional.cross_entropy(
                    logits.astype("float32"), b)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        losses[m] = [float(train_step(m.to_tensor(x), m.to_tensor(y)))
                     for _ in range(3)]
    assert np.abs(np.subtract(losses[tp], losses[jp])).max() <= 2e-3
    assert all(np.isfinite(losses[tp]))


def test_convert_carries_weights_both_ways(jax_eager):
    """A JAX model's weights into a port model drawn from another seed,
    and the port's back into a JAX model: the logits follow."""
    x, _ = _ids(4)
    jp.seed(7)
    jm = jbert.BertForSequenceClassification(jbert.BertConfig(**TINY), 3)
    tm = _pair(8)[tp]
    convert.layer_state_from_numpy(
        tm, {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    for model in (jm, tm):
        model.eval()
    assert _err(tm(tp.to_tensor(x)), jm(jp.to_tensor(x))) <= 1e-5
    back = _pair(9)[jp]
    back.eval()
    back.set_state_dict({k: jp.to_tensor(v) for k, v in
                         convert.layer_state_to_numpy(tm).items()})
    assert _err(back(jp.to_tensor(x)), jm(jp.to_tensor(x))) == 0.0
    with pytest.raises(KeyError, match="missing"):
        convert.layer_state_from_numpy(tm, {})
