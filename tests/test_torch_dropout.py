"""Hidden dropout, block recompute and loss masks in the PyTorch port's
training (`paddle_tpu_torch/kernels/prng.py` `split` / `bernoulli`,
`kernels/dropout.py::hidden_dropout`, `models/gpt.py` scan_*,
`train/scan_step.py`) held against the JAX package on the CPU.

The JAX step traces its program with 64-bit types off, so its masks draw
float32 uniforms against ``float32(1 - p)``; every JAX call here runs
inside ``jax.enable_x64(False)`` for the same reason (`import paddle_tpu`
turns them on). The JAX flash op runs its authored Pallas kernels in
interpret mode, as in `tests/test_torch_train.py`.

Tolerances: the keys, masks and dropout outputs and gradients bit for bit
(the same integer hash, and one IEEE division by the same rounded
divisor); losses within 1e-5 and gradients within 1e-5 of the largest
gradient of their leaf, as `tests/test_torch_train.py` holds them (float32
sums in another order in each framework); a recomputed run equal to the
same run without recompute bit for bit (the same ops on the same inputs).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.train import ScanTrainStep as JaxScanTrainStep
from paddle_tpu_torch.kernels import prng, registry
from paddle_tpu_torch.kernels.dropout import hidden_dropout
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import (params_from_numpy,
                                             train_state_from_numpy)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.train import ScanTrainStep
from tests.test_torch_train import (_maxabs, _np, _weights,  # noqa: F401
                                    authored_flash)
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


SMALL = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=32,
             hidden_dropout=0.1, attention_dropout=0.0)
SEEDS = (0, 7, 2 ** 33 + 5, -1)
SHAPES = ((5,), (3, 7), (2, 3, 5, 7), (16, 32))
RECOMPUTE = {"full_block": {"recompute": True},
             "mlp": {"recompute_granularity": "mlp"},
             "mlp_up": {"recompute_granularity": "mlp_up"}}


def _keys(seed):
    """(JAX raw key, port key) of ``PRNGKey(seed)`` with 64-bit seeds."""
    words = prng.seed_words(seed)
    return (jnp.asarray(words, jnp.uint32),
            torch.from_numpy(words.astype(np.int64)))


def _bits(a):
    """The raw bits of a float32 or bfloat16 torch tensor or JAX array, for
    bit-for-bit comparisons."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.view({torch.float32: torch.int32,
                       torch.bfloat16: torch.int16}[a.dtype]).numpy()
    a = np.asarray(a)
    return a.view({4: np.int32, 2: np.int16}[a.itemsize])


def _batch(seed, b, s, vocab):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s + 1))
    mask = (rng.rand(b, s) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0                          # no row without a token
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32), mask


# ------------------------------------------------------------- the key chain


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [3, (4, 2), (2, 3, 5)])
def test_shaped_split_matches_jax(seed, shape):
    jk, tk = _keys(seed)
    with jax.enable_x64(False):
        want = np.asarray(jax.random.key_data(jax.random.split(jk, shape)))
        # a batch of keys: each row split on its own, as vmap does
        jbatch = jax.random.key_data(jax.random.split(jk, 3))
        want_b = np.asarray(jax.vmap(lambda k: jax.random.key_data(
            jax.random.split(jax.random.wrap_key_data(k), shape)))(jbatch))
    got = prng.split(tk, shape)
    lead = (shape,) if isinstance(shape, int) else shape
    assert tuple(got.shape) == (*lead, 2)
    assert (got.numpy().astype(np.uint32) == want).all()
    got_b = prng.split(prng.split(tk, 3), shape)
    assert (got_b.numpy().astype(np.uint32) == want_b).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [0.9, 0.5, 0.123])
def test_bernoulli_matches_jax(seed, shape, p):
    jk, tk = _keys(seed)
    with jax.enable_x64(False):
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        keys = jax.random.split(jk, 3)
        want_b = np.asarray(jax.vmap(
            lambda k: jax.random.bernoulli(k, p, shape))(keys))
    got = prng.bernoulli(tk, p, shape)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    assert (got.numpy() == want).all()
    got_b = prng.bernoulli(prng.split(tk, 3), p, shape)
    assert (got_b.numpy() == want_b).all()


# ------------------------------------------------------------- the op


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hidden_dropout_matches_fdropout(seed, shape, dtype):
    """Output and gradient bit for bit: the mask, the divisor rounded to
    the dtype first (bf16(0.9) = 0.8984375), one IEEE division."""
    jk, tk = _keys(seed)
    rng = np.random.RandomState(abs(seed) % 1000)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    with jax.enable_x64(False):
        jx, jct = jnp.asarray(x).astype(jdt), jnp.asarray(ct).astype(jdt)
        want, vjp = jax.vjp(lambda v: jgpt._fdropout(v, jk, 0.1), jx)
        want_g, = vjp(jct)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    registry.reset_counts()
    got = hidden_dropout(tx, tk, 0.1)
    got.backward(torch.from_numpy(ct).to(tdt))
    assert got.dtype == tdt and tx.grad.dtype == tdt
    assert (_bits(got) == _bits(want)).all()
    assert (_bits(tx.grad) == _bits(want_g)).all()
    assert registry.counts() == {"kernel.dispatch.fused_dropout.plain": 2}


def test_hidden_dropout_rounds_the_divisor_to_bf16_first():
    x = torch.full((64,), 3.0, dtype=torch.bfloat16)
    out = hidden_dropout(x, prng.prng_key(0), 0.1)
    kept = out[out != 0]
    # 3 / 0.8984375 = 3.339..., rounded to bf16; 3 / 0.9 would give 3.328125
    assert kept.numel() > 0 and (kept == 3.34375).all()


def test_hidden_dropout_rate_zero_is_the_identity_and_dispatches_nothing():
    x = torch.randn(4, 8)
    registry.reset_counts()
    assert hidden_dropout(x, prng.prng_key(0), 0.0) is x
    assert registry.counts() == {}


@pytest.mark.parametrize("case,match", [
    ("rate", "outside"), ("key_shape", "key must be"),
    ("key_dtype", "key must be")])
def test_hidden_dropout_refuses_bad_input(case, match):
    x, key, p = torch.randn(4, 8), prng.prng_key(0), 0.1
    if case == "rate":
        p = 1.0
    elif case == "key_shape":
        key = prng.split(key, 2)
    elif case == "key_dtype":
        key = key.int()
    with pytest.raises(ValueError, match=match):
        hidden_dropout(x, key, p)


# ------------------------------------------------------------- scan_loss


def _jax_loss_and_grads(w, x, y, cfg, key, mask=None):
    with jax.enable_x64(False):
        stacked = jgpt.stack_gpt_params({k: jnp.asarray(v)
                                         for k, v in w.items()})
        return jax.value_and_grad(lambda p: jgpt.scan_loss(
            p, jnp.asarray(x), jnp.asarray(y), jgpt.GPTConfig(**cfg),
            loss_mask=None if mask is None else jnp.asarray(mask),
            training=True, dropout_key=key))(stacked)


def _port_loss_and_grads(w, x, y, cfg, key, mask=None):
    """(loss, {(group, leaf): grad}, dispatch counts)."""
    stacked = tgpt.stack_gpt_params(params_from_numpy(w, "cpu"))
    leaves = [(g, k) for g in ("blocks", "top") for k in stacked[g]]
    for g, k in leaves:
        stacked[g][k].requires_grad_(True)
    registry.reset_counts()
    loss = tgpt.scan_loss(
        stacked, torch.from_numpy(x), torch.from_numpy(y),
        tgpt.GPTConfig(**cfg), training=True, dropout_key=key,
        loss_mask=None if mask is None else torch.from_numpy(mask))
    loss.backward()
    return (loss, {(g, k): stacked[g][k].grad for g, k in leaves},
            registry.counts())


def _assert_close_to_jax(loss, grads, jl, jg):
    assert abs(loss.item() - float(jl)) <= 1e-5
    for (g, k), got in grads.items():
        ref = _np(jg[g][k])
        assert _maxabs(_np(got), ref) <= \
            1e-5 * max(1.0, np.abs(ref).max()), (g, k)


@pytest.mark.parametrize("use_flash,fused_ce", [(True, True), (False, False)])
def test_scan_loss_with_dropout_matches_jax(authored_flash, use_flash,
                                            fused_ce):
    cfg = dict(SMALL, use_flash=use_flash, fused_ce=fused_ce)
    w = _weights(0, cfg)
    x, y, _ = _batch(1, 3, 16, cfg["vocab_size"])
    jk, tk = _keys(11)
    jl, jg = _jax_loss_and_grads(w, x, y, cfg, jk)
    loss, grads, counts = _port_loss_and_grads(w, x, y, cfg, tk)
    _assert_close_to_jax(loss, grads, jl, jg)
    nl = cfg["num_layers"]
    # the embedding's and each layer's two masks, forward and backward
    want = {"kernel.dispatch.fused_dropout.plain": 2 * (1 + 2 * nl)}
    if use_flash:
        want["kernel.dispatch.flash_attention.plain"] = nl
    assert counts == want
    # another key draws other masks: the key reaches the dropout
    other = _port_loss_and_grads(w, x, y, cfg, _keys(12)[1])[0]
    assert other.item() != loss.item()


def test_scan_loss_needs_a_key_to_train_with_dropout():
    cfg = tgpt.GPTConfig(**SMALL)
    stacked = tgpt.stack_gpt_params(params_from_numpy(_weights(0, SMALL),
                                                      "cpu"))
    ids = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="dropout_key"):
        tgpt.scan_loss(stacked, ids, ids, cfg, training=True)
    # evaluation draws no mask and needs no key
    tgpt.scan_loss(stacked, ids, ids, cfg, training=False)
    with pytest.raises(ValueError, match="dropout_keys"):
        tgpt.scan_blocks(stacked["blocks"], torch.zeros(1, 4, 32), cfg,
                         training=True)


@pytest.mark.parametrize("name", list(RECOMPUTE))
def test_recompute_matches_jax_and_the_run_without_it(authored_flash,
                                                      monkeypatch, name):
    """Each recompute setting against JAX with the same setting, and equal
    bit for bit to the port's run without recompute; the counts show what
    the backward reran: the whole block (flash and the block dropouts
    twice a layer), ln_2 and the MLP, or the MLP alone."""
    base = dict(SMALL)
    cfg = dict(SMALL, **RECOMPUTE[name])
    w = _weights(3, cfg)
    x, y, _ = _batch(4, 2, 16, cfg["vocab_size"])
    jk, tk = _keys(5)
    jl, jg = _jax_loss_and_grads(w, x, y, cfg, jk)
    ref_loss, ref_grads, ref_counts = _port_loss_and_grads(w, x, y, base, tk)
    calls = {"_mlp_ln": 0, "_mlp_up": 0}
    for fn in calls:
        orig = getattr(tgpt, fn)

        def counted(*a, _fn=fn, _orig=orig):
            calls[_fn] += 1
            return _orig(*a)
        monkeypatch.setattr(tgpt, fn, counted)
    loss, grads, counts = _port_loss_and_grads(w, x, y, cfg, tk)
    _assert_close_to_jax(loss, grads, jl, jg)
    assert torch.equal(loss, ref_loss)
    for k, g in grads.items():
        assert torch.equal(g, ref_grads[k]), k
    nl = cfg["num_layers"]
    if name == "full_block":
        assert counts == {"kernel.dispatch.flash_attention.plain": 2 * nl,
                          "kernel.dispatch.fused_dropout.plain":
                          2 * (1 + 2 * nl) + 2 * nl}
        assert calls == {"_mlp_ln": 2 * nl, "_mlp_up": 2 * nl}
    else:
        assert counts == ref_counts
        assert calls == {"_mlp_ln": (2 if name == "mlp" else 1) * nl,
                         "_mlp_up": 2 * nl}


def test_recompute_granularity_is_validated():
    with pytest.raises(ValueError, match="recompute_granularity"):
        tgpt.GPTForCausalLM(tgpt.GPTConfig(
            **dict(SMALL, recompute_granularity="attn")))
    with pytest.raises(ValueError, match="recompute_granularity"):
        jgpt.GPTForCausalLM(jgpt.GPTConfig(
            **dict(SMALL, recompute_granularity="attn")))


def test_loss_mask_matches_jax(authored_flash):
    cfg = dict(SMALL)
    w = _weights(6, cfg)
    x, y, mask = _batch(7, 3, 16, cfg["vocab_size"])
    jk, tk = _keys(2)
    jl, jg = _jax_loss_and_grads(w, x, y, cfg, jk, mask)
    loss, grads, _ = _port_loss_and_grads(w, x, y, cfg, tk, mask)
    _assert_close_to_jax(loss, grads, jl, jg)
    unmasked = _port_loss_and_grads(w, x, y, cfg, tk)[0]
    assert abs(unmasked.item() - loss.item()) > 1e-4


def test_use_loss_mask_needs_a_mask():
    cfg = tgpt.GPTConfig(**SMALL)
    ts = ScanTrainStep(tgpt.GPTForCausalLM(cfg), AdamW(), device="cpu",
                       use_loss_mask=True)
    x, y, _ = _batch(0, 2, 8, SMALL["vocab_size"])
    key = ts._key.clone()
    with pytest.raises(ValueError, match="loss_mask"):
        ts.step(x, y)
    # refused before the key chain moved, as in the JAX step
    assert torch.equal(ts._key, key)


# ------------------------------------------------------------- train steps


def test_train_steps_with_dropout_match_jax_step_program(authored_flash):
    """Five steps with dropout, two microbatches, a loss mask and one
    NaN-poisoned step, against the JAX `ScanTrainStep._jit` fed the key
    chain its `step()` builds: ``PRNGKey(seed)``, split every step."""
    cfg = dict(SMALL)
    lr, clip, steps, poisoned, seed = 1e-3, 1.0, 5, 2, 3
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    jopt = paddle.optimizer.AdamW(
        learning_rate=lr, parameters=jm.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(clip))
    js = JaxScanTrainStep(jm, jopt, microbatches=2, use_loss_mask=True,
                          seed=seed)
    tree = lambda t: jax.tree_util.tree_map(np.array, t)   # noqa: E731
    params, opt_state = train_state_from_numpy(tree(js._params),
                                               tree(js._opt_state), "cpu")
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
    model.set_state_dict(params)
    opt = AdamW(learning_rate=lr, clip_norm=clip)
    opt.state = opt_state
    ts = ScanTrainStep(model, opt, microbatches=2, use_loss_mask=True,
                       seed=seed, device="cpu")
    x, y, mask = _batch(5, 4, 16, cfg["vocab_size"])
    xs, ys, ms = (jnp.asarray(a.reshape(2, 2, 16)) for a in (x, y, mask))
    jkey = js._key
    assert (ts._key.numpy() == np.asarray(jkey)).all()
    registry.reset_counts()
    t = 1
    for i in range(1, steps + 1):
        with jax.enable_x64(False):
            jkey, sub = jax.random.split(jkey)
            jl, jok, js._params, js._opt_state = js._jit(
                js._params, js._opt_state, xs, ys, ms, jnp.float32(lr),
                jnp.float32(t), jax.random.key_data(sub),
                jnp.float32(float("nan") if i == poisoned else 0.0))
        tl = ts.step(x, y, mask, inject_nan=i == poisoned)
        # every step advances the chain, the skipped one too
        assert (ts._key.numpy() == np.asarray(jkey)).all(), i
        assert bool(jok) == ts.last_step_ok == (i != poisoned)
        if i == poisoned:
            assert np.isnan(float(jl)) and np.isnan(tl)
            continue
        t += 1
        assert abs(tl - float(jl)) <= 1e-5, (i, tl, float(jl))
    assert ts.bad_steps == 1 and opt.global_step == steps - 1
    nl = cfg["num_layers"]
    assert registry.counts() == {
        "kernel.dispatch.flash_attention.plain": nl * 2 * steps,
        "kernel.dispatch.fused_dropout.plain": 2 * (1 + 2 * nl) * 2 * steps}


def test_grads_default_to_the_next_steps_keys():
    """`_grads` without keys draws the keys the next step will, and leaves
    the chain where it is: the loss it gives is that step's."""
    cfg = tgpt.GPTConfig(**SMALL)
    model = tgpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(1))
    ts = ScanTrainStep(model, AdamW(learning_rate=1e-3), microbatches=2,
                       seed=4, device="cpu")
    x, y, _ = _batch(8, 4, 8, SMALL["vocab_size"])
    xs, ys = (torch.from_numpy(a).reshape(2, 2, 8) for a in (x, y))
    key = ts._key.clone()
    loss, _ = ts._grads(xs, ys)
    assert torch.equal(ts._key, key)
    assert ts.step(x, y) == loss.item()
    assert not torch.equal(ts._key, key)
