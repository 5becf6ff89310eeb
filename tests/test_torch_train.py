"""GPT-2 training of the PyTorch port (`paddle_tpu_torch/kernels/fused_ce.py`,
`models/gpt.py` scan_*, `optimizer/`, `train/scan_step.py`) held against
the JAX package on the same weights and inputs, on the CPU.

- The fused LM-head cross-entropy and its gradients against
  `paddle_tpu/kernels/fused_ce.py` (labels -100 and V included).
- `scan_loss` and its per-leaf gradients against the JAX `scan_loss` under
  `jax.value_and_grad`, with the JAX flash op forced to its authored Pallas
  kernels (`FLAGS_tpu_flash_impl="authored"`, interpret mode here).
- Train steps of the port's `ScanTrainStep` against the JAX
  `ScanTrainStep._jit` called directly with the arguments `step()` would
  build (`step()` itself stops at the `disable_x64` import here, ROADMAP
  C1): two microbatches, the global-norm clip on, one step poisoned with
  NaN so that both skip it.

Tolerances (float32 throughout): losses within 1e-5; gradients within
1e-5 of the largest gradient of their leaf (sums in another order in each
framework), and the fused cross-entropy's within one bf16 step of it
(2^-8: its dlogits are rounded to bf16 on both sides). After Adam steps
the parameters are compared through the losses, plus two bounds: Adam
turns a gradient near zero into a step of about +-lr whose sign the last
float32 bit decides, so an element may differ by up to 2 * lr per step
however close the gradients are; all but 0.1% of the elements must agree
within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.framework.flags import flag_value, set_flags
from paddle_tpu.kernels.fused_ce import \
    fused_linear_cross_entropy as j_flce
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import metrics
from paddle_tpu.train import ScanTrainStep as JaxScanTrainStep
from paddle_tpu_torch.kernels import prng, registry
from paddle_tpu_torch.kernels.fused_ce import fused_linear_cross_entropy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import (params_from_numpy,
                                             train_state_from_numpy)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.train import ScanTrainStep, ScanUnsupported
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.tensor import torch_state


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


SMALL = dict(vocab_size=8192, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=32,
             hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture
def authored_flash():
    """The JAX flash op on its authored Pallas kernels, as the port's
    kernels replace them; the flag is restored afterwards."""
    old = flag_value("tpu_flash_impl")
    set_flags({"FLAGS_tpu_flash_impl": "authored"})
    yield
    set_flags({"FLAGS_tpu_flash_impl": old})


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _weights(seed, cfg=SMALL):
    rng = np.random.RandomState(seed)
    h, f = cfg["hidden_size"], cfg["intermediate_size"]

    def n(*shape, std=0.1):
        return (rng.randn(*shape) * std).astype(np.float32)

    w = {"gpt.wte.weight": n(cfg["vocab_size"], h),
         "gpt.wpe.weight": n(cfg["max_position_embeddings"], h),
         "gpt.ln_f.weight": 1 + n(h), "gpt.ln_f.bias": n(h)}
    for i in range(cfg["num_layers"]):
        p = f"gpt.h.{i}."
        w.update({p + "ln_1.weight": 1 + n(h), p + "ln_1.bias": n(h),
                  p + "attn.qkv_proj.weight": n(h, 3 * h),
                  p + "attn.qkv_proj.bias": n(3 * h),
                  p + "attn.out_proj.weight": n(h, h),
                  p + "attn.out_proj.bias": n(h),
                  p + "ln_2.weight": 1 + n(h), p + "ln_2.bias": n(h),
                  p + "mlp.fc_in.weight": n(h, f),
                  p + "mlp.fc_in.bias": n(f),
                  p + "mlp.fc_out.weight": n(f, h),
                  p + "mlp.fc_out.bias": n(h)})
    return w


def _batch(seed, b, s, vocab):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


# ------------------------------------------------------------- fused CE


@pytest.mark.parametrize("vocab", [97, 12288])        # 1 and 3 vocab chunks
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_fused_ce_matches_jax(vocab, wdtype):
    rng = np.random.RandomState(vocab)
    n, hid = 24, 32
    h = rng.randn(n, hid).astype(np.float32)
    w = (rng.randn(vocab, hid) * 0.3).astype(np.float32)
    labels = rng.randint(0, vocab, n).astype(np.int32)
    labels[[3, 11]] = -100                  # ignore_index padding
    labels[7] = vocab                       # out of range
    dl = rng.rand(n).astype(np.float32)
    jw = jnp.asarray(w).astype(getattr(jnp, wdtype))

    def jloss(h_, w_):
        return jnp.sum(j_flce(h_, w_, jnp.asarray(labels)) * dl)

    jl = j_flce(jnp.asarray(h), jw, jnp.asarray(labels))
    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jw)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).to(getattr(torch, wdtype)).requires_grad_(True)
    tl = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels))
    (tl * torch.from_numpy(dl)).sum().backward()
    assert tl.dtype == torch.float32 and tw.grad.dtype == tw.dtype
    assert _maxabs(_np(tl), _np(jl)) <= 1e-5
    assert (_np(tl)[[3, 7, 11]] == 0).all()
    assert (_np(th.grad)[[3, 7, 11]] == 0).all()
    for got, ref in ((th.grad, jdh), (tw.grad, jdw)):
        ref = _np(ref)
        # dlogits are rounded to bf16 on both sides, and a dlogit one f32
        # bit from a rounding boundary can round one bf16 step apart;
        # bf16 weights also round dw to bf16
        tol = (2.0 ** -8 if wdtype == "float32" else 2.0 ** -7) \
            * np.abs(ref).max()
        assert _maxabs(_np(got), ref) <= tol


# ------------------------------------------------------------- scan_loss


@pytest.mark.parametrize("use_flash,fused_ce", [(True, True), (False, False)])
def test_scan_loss_and_grads_match_jax(authored_flash, use_flash, fused_ce):
    cfg = dict(SMALL, use_flash=use_flash, fused_ce=fused_ce)
    w = _weights(0, cfg)
    x, y = _batch(1, 3, 24, cfg["vocab_size"])
    jcfg, tcfg = jgpt.GPTConfig(**cfg), tgpt.GPTConfig(**cfg)
    jstacked = jgpt.stack_gpt_params({k: jnp.asarray(v)
                                      for k, v in w.items()})
    jl, jg = jax.value_and_grad(
        lambda p: jgpt.scan_loss(p, jnp.asarray(x), jnp.asarray(y), jcfg,
                                 training=True))(jstacked)
    stacked = tgpt.stack_gpt_params(params_from_numpy(w, "cpu"))
    leaves = [(g, k) for g in ("blocks", "top") for k in stacked[g]]
    for g, k in leaves:
        stacked[g][k].requires_grad_(True)
    registry.reset_counts()
    tl = tgpt.scan_loss(stacked, torch.from_numpy(x), torch.from_numpy(y),
                        tcfg, training=True)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5
    want = {"kernel.dispatch.flash_attention.plain": cfg["num_layers"]} \
        if use_flash else {}
    assert registry.counts() == want
    for g, k in leaves:
        ref = _np(jg[g][k])
        assert _maxabs(_np(stacked[g][k].grad), ref) <= \
            1e-5 * max(1.0, np.abs(ref).max()), (g, k)


def test_scan_logits_and_layout_match_jax(authored_flash):
    w = _weights(2)
    x, _ = _batch(3, 2, 16, SMALL["vocab_size"])
    jcfg, tcfg = jgpt.GPTConfig(**SMALL), tgpt.GPTConfig(**SMALL)
    jstacked = jgpt.stack_gpt_params({k: jnp.asarray(v)
                                      for k, v in w.items()})
    stacked = tgpt.stack_gpt_params(params_from_numpy(w, "cpu"))
    for g in ("blocks", "top"):
        assert set(stacked[g]) == set(jstacked[g])
        for k in stacked[g]:
            assert tuple(stacked[g][k].shape) == jstacked[g][k].shape
    assert set(tgpt.unstack_gpt_params(stacked)) == set(w)
    jl = jgpt.scan_logits(jstacked, jnp.asarray(x), jcfg)
    tl = tgpt.scan_logits(stacked, torch.from_numpy(x), tcfg)
    assert _maxabs(_np(tl), _np(jl)) <= 1e-5
    for c in (tcfg, tgpt.GPTConfig()):
        assert tgpt.analytic_param_count(c) == jgpt.analytic_param_count(c)
        assert tgpt.analytic_flops_per_token(c, 1024) == \
            jgpt.analytic_flops_per_token(c, 1024)
    model = tgpt.GPTForCausalLM(tcfg)
    assert tgpt.analytic_param_count(tcfg) == sum(
        p.numel() for p in model.parameters())


@pytest.mark.parametrize("over,match", [
    ({"attention_dropout": 0.1}, "dropout")])
def test_training_refuses_what_is_not_ported(over, match):
    cfg = tgpt.GPTConfig(**dict(SMALL, **over))
    stacked = tgpt.stack_gpt_params(params_from_numpy(_weights(0), "cpu"))
    ids = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=match):
        tgpt.scan_loss(stacked, ids, ids, cfg, training=True)
    # evaluation does not train: dropout and recompute do not apply
    tgpt.scan_loss(stacked, ids, ids, cfg, training=False)
    with pytest.raises(ScanUnsupported, match=match):
        ScanTrainStep(tgpt.GPTForCausalLM(cfg), AdamW(), device="cpu")


@pytest.mark.parametrize("over", [
    {"hidden_dropout": 0.1}, {"recompute": True},
    {"hidden_dropout": 0.1, "recompute_granularity": "mlp_up"}],
    ids=["hidden_dropout", "recompute", "dropout_mlp_up"])
def test_training_trains_what_the_port_no_longer_refuses(over):
    """The configs the port refused before hidden dropout and recompute
    were ported: trained a few steps on the CPU, losses finite and falling,
    the dropout drawn (a loss with dropout differs from one without)."""
    cfg = tgpt.GPTConfig(**dict(SMALL, vocab_size=256, **over))
    model = tgpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    ts = ScanTrainStep(model, AdamW(learning_rate=3e-3, clip_norm=1.0),
                       microbatches=2, device="cpu")
    x, y = _batch(7, 4, 16, 256)
    registry.reset_counts()
    losses = [ts.step(x, y) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert ts.bad_steps == 0
    dropped = registry.counts().get("kernel.dispatch.fused_dropout.plain", 0)
    assert (dropped > 0) == bool(cfg.hidden_dropout)
    stacked = tgpt.stack_gpt_params(params_from_numpy(_weights(0), "cpu"))
    ids = torch.from_numpy(x[:2])
    plain = tgpt.scan_loss(stacked, ids, ids, tgpt.GPTConfig(**SMALL),
                           training=True)
    trained = tgpt.scan_loss(stacked, ids, ids, tgpt.GPTConfig(
        **dict(SMALL, **over)), training=True, dropout_key=prng.prng_key(1))
    assert (trained.item() != plain.item()) == bool(cfg.hidden_dropout)


def test_train_step_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ScanTrainStep(model, AdamW())


# ------------------------------------------------------------- train steps


def _jax_step(cfg, lr, clip):
    paddle.seed(0)
    m = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    opt = paddle.optimizer.AdamW(
        learning_rate=lr, parameters=m.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(clip))
    return JaxScanTrainStep(m, opt, microbatches=2)


def test_train_steps_match_jax_step_program(authored_flash):
    cfg = dict(SMALL, vocab_size=512)
    lr, clip, steps, poisoned = 1e-3, 1.0, 5, 2
    js = _jax_step(cfg, lr, clip)
    tree = lambda t: jax.tree_util.tree_map(np.array, t)   # noqa: E731
    params, opt_state = train_state_from_numpy(tree(js._params),
                                               tree(js._opt_state), "cpu")
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
    model.set_state_dict(params)
    opt = AdamW(learning_rate=lr, clip_norm=clip)
    opt.state = opt_state
    ts = ScanTrainStep(model, opt, microbatches=2, device="cpu")
    assert ts._opt_state["top"]["gpt.wte.weight"].keys() == {"moment1",
                                                             "moment2"}

    x, y = _batch(5, 4, 16, cfg["vocab_size"])
    xs, ys = jnp.asarray(x.reshape(2, 2, 16)), jnp.asarray(y.reshape(2, 2, 16))
    ms = jnp.zeros((2, 1), jnp.float32)
    key = jax.random.key_data(jax.random.PRNGKey(0))
    start = metrics.snapshot()["counters"].get(
        "kernel.dispatch.flash_attention.authored", 0)
    registry.reset_counts()
    t = 1
    for i in range(1, steps + 1):
        poison = float("nan") if i == poisoned else 0.0
        jl, jok, js._params, js._opt_state = js._jit(
            js._params, js._opt_state, xs, ys, ms, jnp.float32(lr),
            jnp.float32(t), key, jnp.float32(poison))
        tl = ts.step(x, y, inject_nan=i == poisoned)
        assert bool(jok) == ts.last_step_ok == (i != poisoned)
        if i == poisoned:
            assert np.isnan(float(jl)) and np.isnan(tl)
            continue
        t += 1
        assert abs(tl - float(jl)) <= 1e-5, (i, tl, float(jl))
    assert ts.bad_steps == 1 and opt.global_step == steps - 1
    assert metrics.snapshot()["counters"][
        "kernel.dispatch.flash_attention.authored"] > start
    assert registry.counts() == {"kernel.dispatch.flash_attention.plain":
                                 cfg["num_layers"] * 2 * steps}
    assert [r["step"] for r in ts.records] == list(range(1, steps))
    assert all(r["mfu"] is None and r["step_ms"] > 0 for r in ts.records)

    # parameters: every element within the most 4 Adam steps can separate
    # it, and all but 0.1% within 1e-5 (a wrong update moves most of them);
    # written back into the model and into the optimizer's state
    ts.sync_to_model()
    got = torch_state(model)
    jp = jgpt.unstack_gpt_params(js._params)
    diff = np.concatenate([np.abs(_np(got[n]) - _np(ref)).ravel()
                           for n, ref in jp.items()])
    assert diff.max() <= 2 * lr * (steps - 1)
    assert np.quantile(diff, 0.999) <= 1e-5
    assert set(opt.state) == set(jp)
    assert opt.state["gpt.h.1.mlp.fc_in.weight"]["moment2"].shape == (32, 64)


def test_bf16_params_train_on_float32_masters():
    cfg = tgpt.GPTConfig(**dict(SMALL, vocab_size=256))
    model = tgpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    master0 = {k: v.clone() for k, v in torch_state(model).items()}
    model = model.to(torch.bfloat16)
    ts = ScanTrainStep(model, AdamW(learning_rate=1e-3, clip_norm=1.0),
                       microbatches=2, device="cpu")
    st = ts._opt_state["blocks"]["mlp.fc_in.weight"]
    assert set(st) == {"moment1", "moment2", "master"}
    assert st["master"].dtype == torch.float32
    x, y = _batch(7, 4, 16, 256)
    losses = [ts.step(x, y) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    ts.sync_to_model()
    for name, p in torch_state(model).items():
        assert p.dtype == torch.bfloat16
        # the bf16 weights are the rounded masters
        assert torch.equal(p, torch_state(ts.model)[name])
    leaf = ts._opt_state["blocks"]["mlp.fc_in.weight"]["master"]
    assert torch.equal(leaf.to(torch.bfloat16),
                       ts._params["blocks"]["mlp.fc_in.weight"].detach())
    assert not torch.equal(leaf[0], master0["gpt.h.0.mlp.fc_in.weight"])


def test_microbatch_count_must_divide_the_batch():
    cfg = tgpt.GPTConfig(**dict(SMALL, vocab_size=64))
    ts = ScanTrainStep(tgpt.GPTForCausalLM(cfg), AdamW(), microbatches=3,
                       device="cpu")
    x, y = _batch(0, 4, 8, 64)
    with pytest.raises(ValueError, match="not divisible"):
        ts.step(x, y)
