"""GPT-2 serving math of the PyTorch port (`paddle_tpu_torch/models/`) held
against the JAX package's step functions on the same weights and inputs:
`decode_step`, `prefill_step` and `prefill_chunk_step` give the same logits
and write the same K/V into the pools (max-abs 1e-5 in float32; the trash
page is left out, since padding rows land there in an unspecified order on
both sides). Also: the weight layout carries across as a copy, and the
port's margin-gated parity check agrees with the JAX package's.

The JAX side runs its default CPU arms (the XLA gather reference); the
port runs the plain PyTorch versions of its kernels, which is what a CPU
tensor takes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.tensor import torch_state


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


TOL = 1e-5
SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=64)


def _weights(seed, cfg=SMALL):
    """GPT state_dict arrays drawn with numpy. Non-trivial layernorm scales
    and biases, so every parameter reaches the logits."""
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


def _both(seed=0):
    w = _weights(seed)
    return ({k: jnp.asarray(v) for k, v in w.items()},
            params_from_numpy(w, "cpu"),
            jgpt.GPTConfig(**SMALL), tgpt.GPTConfig(**SMALL))


def _pools(rng, num_pages=12, ps=4):
    shape = (SMALL["num_layers"], num_pages, ps, SMALL["num_heads"],
             SMALL["hidden_size"] // SMALL["num_heads"])
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _check_pools(tk, tv, jk, jv):
    # page 0 is the trash page: duplicate writes land there in either order
    assert _maxabs(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:]) <= TOL
    assert _maxabs(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:]) <= TOL


def test_decode_step_matches_jax():
    jp, tp, jcfg, tcfg = _both(0)
    rng = np.random.RandomState(1)
    kp, vp = _pools(rng)
    # 4 slots: ragged cached lengths, a page crossing, one inactive slot
    table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [0, 0, 0]], np.int32)
    lengths = np.array([3, 4, 9, 11], np.int32)
    mask = np.array([True, True, True, False])
    ids = rng.randint(0, SMALL["vocab_size"], 4).astype(np.int32)
    jl, jc = jgpt.decode_step(
        jp, jnp.asarray(ids),
        dict(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp),
             page_table=jnp.asarray(table), lengths=jnp.asarray(lengths)),
        jnp.asarray(mask), cfg=jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tc = tgpt.decode_step(
        tp, torch.from_numpy(ids),
        dict(k_pages=tk, v_pages=tv, page_table=torch.from_numpy(table),
             lengths=torch.from_numpy(lengths)),
        torch.from_numpy(mask), cfg=tcfg)
    assert tl.shape == (4, SMALL["vocab_size"]) and tl.dtype == torch.float32
    assert _maxabs(tl, jl) <= TOL
    assert tc["k_pages"] is tk               # written in place
    _check_pools(tk, tv, jc["k_pages"], jc["v_pages"])
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


@pytest.mark.parametrize("length,bucket", [(11, 16), (8, 8), (1, 8)])
def test_prefill_step_matches_jax(length, bucket):
    jp, tp, jcfg, tcfg = _both(2)
    rng = np.random.RandomState(3)
    kp, vp = _pools(rng)
    row = np.array([5, 2, 9, 0], np.int32)
    ids = np.zeros(bucket, np.int32)
    ids[:length] = rng.randint(0, SMALL["vocab_size"], length)
    jl, jk, jv = jgpt.prefill_step(jp, jnp.asarray(ids), jnp.int32(length),
                                   jnp.asarray(row), jnp.asarray(kp),
                                   jnp.asarray(vp), cfg=jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, _, _ = tgpt.prefill_step(tp, torch.from_numpy(ids), length,
                                 torch.from_numpy(row), tk, tv, cfg=tcfg)
    assert _maxabs(tl, jl) <= TOL
    _check_pools(tk, tv, jk, jv)


@pytest.mark.parametrize("start,valid,c", [(8, 5, 8), (6, 8, 8), (0, 3, 4)])
def test_prefill_chunk_step_matches_jax(start, valid, c):
    jp, tp, jcfg, tcfg = _both(4)
    rng = np.random.RandomState(5)
    kp, vp = _pools(rng)    # positions < start hold earlier chunks' K/V
    row = np.array([3, 7, 1, 10], np.int32)
    ids = np.zeros(c, np.int32)
    ids[:valid] = rng.randint(0, SMALL["vocab_size"], valid)
    jl, jk, jv = jgpt.prefill_chunk_step(
        jp, jnp.asarray(ids), jnp.int32(start), jnp.int32(valid),
        jnp.asarray(row), jnp.asarray(kp), jnp.asarray(vp), cfg=jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, _, _ = tgpt.prefill_chunk_step(tp, torch.from_numpy(ids), start,
                                       valid, torch.from_numpy(row), tk, tv,
                                       cfg=tcfg)
    assert _maxabs(tl, jl) <= TOL
    _check_pools(tk, tv, jk, jv)


def test_state_dict_layout_matches_jax_and_loads_as_a_copy():
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    jstate = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL),
                             generator=torch.Generator().manual_seed(0))
    tstate = torch_state(tm)
    assert list(tstate) == list(jstate)
    assert all(tuple(tstate[k].shape) == jstate[k].shape for k in jstate)
    tm.set_state_dict(params_from_numpy(jstate, "cpu"))
    for k, v in torch_state(tm).items():
        np.testing.assert_array_equal(v.numpy(), jstate[k])
    # bf16 arrays (ml_dtypes) carry across bit for bit
    b16 = np.asarray(jnp.asarray(jstate["gpt.wte.weight"], jnp.bfloat16))
    t16 = params_from_numpy({"w": b16}, "cpu")["w"]
    assert t16.dtype == torch.bfloat16
    np.testing.assert_array_equal(t16.float().numpy(),
                                  b16.astype(np.float32))


def test_gpt2_small_config_matches_jax():
    j, t = jgpt.GPTConfig(), tgpt.GPTConfig()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "max_position_embeddings",
              "initializer_range"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.vocab_size, t.hidden_size, t.num_layers) == (50304, 768, 12)


@pytest.mark.parametrize("noise,bound", [(1e-4, 5e-4), (0.05, 0.5),
                                         (2.0, 0.5), (1e-3, 5e-4)])
def test_margin_gated_parity_matches_jax(noise, bound):
    from paddle_tpu.quantization.serving import margin_gated_parity as jmgp
    from paddle_tpu_torch.quantization.serving import margin_gated_parity
    rng = np.random.RandomState(6)
    ref = rng.randn(3, 5, 40).astype(np.float32)
    got = ref + (rng.randn(*ref.shape) * noise).astype(np.float32)
    jd, jok = jmgp(jnp.asarray(ref), jnp.asarray(got), bound=bound)
    td, tok = margin_gated_parity(torch.from_numpy(ref),
                                  torch.from_numpy(got), bound)
    assert tok == jok
    assert abs(td - jd) <= 1e-6
