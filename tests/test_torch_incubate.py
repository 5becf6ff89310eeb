"""The incubate.nn slice of the PyTorch port (`paddle_tpu_torch/incubate/nn`,
`nn/`, `kernels/fused_layernorm.py`, `kernels/rotary.py`) held against the
JAX package on the same inputs and, for the layers, the same weights
(carried over with `models/convert.py::layer_state_from_numpy`).

The port runs its plain PyTorch versions here, which is what a CPU tensor
takes; its layers are Paddle Layers on Paddle Tensors (a torch tensor
passed in is wrapped). The JAX side runs its Pallas kernels in interpret mode, as the JAX
package's own tests run them on the CPU. Tolerances (float32): the plain
layernorm's y, mean and rstd within 1e-5 of the interpret-mode forward
kernel, dx, dgamma and dbeta within 1e-4 of the backward kernel and of
`jax.grad`; with bfloat16 x both sides round an f32 result to bfloat16, so
y and dx within one bfloat16 step of the largest value. The plain rope
within 1e-6. Layers within 1e-5 where one matrix product separates the
two sides and 1e-4 for the blocks and stacks (several products and
layernorms in a row).

The JAX package's attention with no mask fails under jax 0.9, which
removed `jax.experimental.disable_x64` (ROADMAP C1), so the layers are
compared with a mask, and the no-mask (flash) arm of the port's SDPA
against the JAX ``_sdpa_xla`` called directly.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import incubate as jinc
from paddle_tpu.kernels.pallas import fused_layernorm as jfl
from paddle_tpu.kernels.pallas import rotary as jrot
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import _sdpa_xla
from paddle_tpu.nn.layers.common import Linear as JLinear
from paddle_tpu.nn.layers.norm import LayerNorm as JLayerNorm
from paddle_tpu.nn.layers.transformer import \
    MultiHeadAttention as JMultiHeadAttention

import paddle_tpu_torch as tp
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.kernels import fused_layernorm as tfl
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.kernels import rotary as trot
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "numpy") and not isinstance(a, np.ndarray):
        a = a.numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _err(got, ref):
    return float(np.abs(_np(got) - _np(ref)).max())


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(a, stop_gradient=True):
    """The same array as a JAX package Tensor and a torch tensor."""
    return (paddle.to_tensor(a, stop_gradient=stop_gradient),
            torch.from_numpy(a.copy()))


def _carry(jlayer, tlayer):
    """Load the JAX layer's weights into the port's layer by key."""
    state = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    assert set(state) == set(tlayer.state_dict())
    return layer_state_from_numpy(tlayer, state)


# --- the fused layernorm against the interpret-mode Pallas kernels --------

LN_CASES = [(300, 64, "float32"), (37, 48, "float32"), (512, 96, "float32"),
            (300, 64, "bfloat16")]


def _ln_inputs(n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = _rand(rng, n, d, scale=2.0) + 0.5
    g, b, dy = _rand(rng, d), _rand(rng, d), _rand(rng, n, d)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    j = (jnp.asarray(x).astype(jdt), jnp.asarray(g), jnp.asarray(b),
         jnp.asarray(dy).astype(jdt))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(g),
         torch.from_numpy(b), torch.from_numpy(dy).to(tdt))
    return j, t


def _tol(dtype, ref, f32_tol):
    big = float(np.abs(_np(ref)).max())
    return f32_tol if dtype == "float32" else max(f32_tol, 2.0 ** -7 * big)


@pytest.mark.parametrize("n,d,dtype", LN_CASES)
def test_plain_layernorm_forward_matches_interpret_kernel(n, d, dtype):
    (jx, jg, jb, _), (x, g, b, _) = _ln_inputs(n, d, dtype)
    jy, jmu, jrs = jfl._fwd(jx, jg, jb, 1e-5, 256, True)
    y, mu, rstd = tfl._plain_ln_fwd(x, g, b, 1e-5)
    assert y.dtype == x.dtype and mu.shape == rstd.shape == (n, 1)
    assert _err(y, jy) <= _tol(dtype, jy, 1e-5)
    assert _err(mu, jmu) <= 1e-5
    assert _err(rstd, jrs) <= 1e-5


@pytest.mark.parametrize("n,d,dtype", LN_CASES)
def test_plain_layernorm_backward_matches_interpret_kernel(n, d, dtype):
    """n = 300 and 512 leave a last block of 44 rows past a full 256 (and
    512 none): the padded rows must not reach dgamma / dbeta."""
    (jx, jg, jb, jdy), (x, g, b, dy) = _ln_inputs(n, d, dtype, seed=1)
    _, jmu, jrs = jfl._fwd(jx, jg, jb, 1e-5, 256, True)
    jdx, jdg, jdb = jfl._bwd(jx, jg, jmu, jrs, jdy, 256, True)
    mu, rstd = (torch.from_numpy(np.array(a)) for a in (jmu, jrs))
    dx, dgp, dbp = tfl._plain_ln_bwd(x, g, mu, rstd, dy)
    assert dx.dtype == x.dtype and dgp.shape == (-(-n // min(256, n)), d)
    assert _err(dx, jdx) <= _tol(dtype, jdx, 1e-4)
    assert _err(dgp.sum(0), jdg) <= 1e-4
    assert _err(dbp.sum(0), jdb) <= 1e-4


def test_fused_layer_norm_autograd_matches_jax_grad():
    rng = np.random.default_rng(2)
    x, g, b = _rand(rng, 2, 150, 48), _rand(rng, 48), _rand(rng, 48)
    w = _rand(rng, 2, 150, 48)

    def jloss(x, g, b):
        return jnp.sum(jfl.fused_layer_norm(x, g, b, interpret=True) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    y = tfl.fused_layer_norm(*ts)
    (y * torch.from_numpy(w)).sum().backward()
    jy = jfl.fused_layer_norm(*map(jnp.asarray, (x, g, b)), interpret=True)
    assert _err(y, jy) <= 1e-5
    for t, jg in zip(ts, jgrads):
        assert t.grad.dtype == torch.float32
        assert _err(t.grad, jg) <= 1e-4


def test_fused_layer_norm_counts_one_plain_dispatch_per_call():
    x = torch.randn(4, 8, 16, requires_grad=True)
    g, b = torch.ones(16), torch.zeros(16)
    registry.reset_counts()
    tfl.fused_layer_norm(x, g, b).sum().backward()
    tfl.fused_layer_norm(x, g, b)
    assert registry.counts() == {"kernel.dispatch.fused_layernorm.plain": 2}


# --- the fused rope --------------------------------------------------------

def _rope_inputs(s=300, d=16, seed=3):
    rng = np.random.default_rng(seed)
    q, k = _rand(rng, 1, 2, s, d), _rand(rng, 1, 2, s, d)
    inv = 1.0 / 10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d)
    ang = np.arange(s, dtype=np.float32)[:, None] * inv[None, :]
    return q, k, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rope_matches_interpret_kernel(dtype):
    """S = 300: the Pallas kernel's block of 256 does not divide S."""
    arrs = _rope_inputs()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, jk = (jnp.asarray(a).astype(jdt) for a in arrs[:2])
    jqo, jko = jrot.apply_rotary_emb(jq, jk, jnp.asarray(arrs[2]),
                                     jnp.asarray(arrs[3]), interpret=True)
    q, k = (torch.from_numpy(a).to(tdt) for a in arrs[:2])
    registry.reset_counts()
    qo, ko = trot.apply_rotary_emb(q, k, *map(torch.from_numpy, arrs[2:]))
    assert registry.counts() == {"kernel.dispatch.fused_rope.plain": 1}
    assert qo.dtype == ko.dtype == tdt
    for got, ref in ((qo, jqo), (ko, jko)):
        assert _err(got, ref) <= _tol(dtype, ref, 1e-6)


def test_rope_has_no_gradient_in_either_package():
    """The reference's fused rope cannot be differentiated (ROADMAP C4):
    JAX raises ValueError through `apply`'s `jax.vjp`; the port raises
    NotImplementedError rather than invent a backward. Without an input
    that needs a gradient both run and agree."""
    q, k, cos, sin = _rope_inputs(s=20, d=8)
    jq = paddle.to_tensor(q, stop_gradient=False)
    with pytest.raises(ValueError, match="reverse-mode"):
        jinc.nn.fused_rotary_position_embedding(
            jq, paddle.to_tensor(k), paddle.to_tensor(cos),
            paddle.to_tensor(sin))
    tq = tp.to_tensor(q, stop_gradient=False)
    tk, tc, ts = map(tp.to_tensor, (k, cos, sin))
    with pytest.raises(NotImplementedError, match="ROADMAP C4"):
        tinc.nn.fused_rotary_position_embedding(tq, tk, tc, ts)
    jo = jinc.nn.fused_rotary_position_embedding(
        *(paddle.to_tensor(a) for a in (q, k, cos, sin)))
    with tp.no_grad():
        to = tinc.nn.fused_rotary_position_embedding(tq, tk, tc, ts)
    for got, ref in zip(to, jo):
        assert _err(got, ref) <= 1e-6


@pytest.mark.parametrize("case,match", [
    ("kdtype", "share one shape and dtype"), ("odd_d", "D even"),
    ("cos_shape", "cos must be"), ("f16", "not supported"),
    ("cos_f16", "cos and sin must share")])
def test_rope_refuses_bad_input(case, match):
    q, k, cos, sin = map(torch.from_numpy, _rope_inputs(s=8, d=8))
    if case == "kdtype":
        k = k.double()
    elif case == "odd_d":
        q = k = torch.zeros(1, 2, 8, 7)
    elif case == "cos_shape":
        cos = cos[:4]
    elif case == "f16":
        q, k = q.half(), k.half()
    elif case == "cos_f16":
        cos, sin = cos.half(), sin.half()
    with pytest.raises(ValueError, match=match):
        trot.apply_rotary_emb(q, k, cos, sin)


# --- functionals -----------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("relu", {}), ("gelu", {}), ("gelu", {"approximate": True}),
    ("silu", {}), ("tanh", {}), ("sigmoid", {})])
def test_activations_match_jax(name, kw):
    a = _rand(np.random.default_rng(4), 3, 40, scale=3.0)
    ja, ta = _pair(a)
    assert _err(getattr(TF, name)(ta, **kw), getattr(JF, name)(ja, **kw)) \
        <= 1e-6


@pytest.mark.parametrize("shape", [[16], [4, 16]])
def test_functional_layer_norm_matches_jax(shape):
    rng = np.random.default_rng(5)
    x = _rand(rng, 3, 4, 16, scale=3.0) + 1.0
    w, b = _rand(rng, *shape), _rand(rng, *shape)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x), _pair(w), _pair(b)
    assert _err(TF.layer_norm(tx, shape, tw, tb),
                JF.layer_norm(jx, shape, jw, jb)) <= 1e-5
    assert _err(TF.layer_norm(tx, shape), JF.layer_norm(jx, shape)) <= 1e-5


def test_functional_linear_matches_jax():
    rng = np.random.default_rng(6)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(_rand(rng, *s))
                                    for s in ((2, 5, 8), (8, 6), (6,)))
    assert _err(TF.linear(tx, tw, tb), JF.linear(jx, jw, jb)) <= 1e-5
    assert _err(TF.linear(tx, tw), JF.linear(jx, jw)) <= 1e-5


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_dropout_deterministic_arms_match_jax(p):
    a = _rand(np.random.default_rng(7), 4, 9)
    ja, ta = _pair(a)
    for mode in ("upscale_in_train", "downscale_in_infer"):
        assert _err(TF.dropout(ta, p, training=False, mode=mode),
                    JF.dropout(ja, p, training=False, mode=mode)) == 0.0
    if p in (0.0, 1.0):
        assert _err(TF.dropout(ta, p, training=True),
                    JF.dropout(ja, p, training=True)) == 0.0


@contextlib.contextmanager
def _x64_off():
    """JAX with 64-bit types off, as its train step traces: its dropout
    then draws float32 uniforms, the port's mask (ROADMAP C16)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_dropout_in_training_draws_the_seed_stream():
    """Dropout in training takes its key from the global generator: after
    one seed the port's F.dropout and nn.Dropout equal the JAX package's
    (64-bit types off) bit for bit; in eval the layer is the identity."""
    a = _rand(np.random.default_rng(8), 4, 16)
    with _x64_off():
        paddle.seed(3)
        jo = [JF.dropout(paddle.to_tensor(a), 0.3, training=True),
              paddle.nn.Dropout(0.5)(paddle.to_tensor(a))]
    tp.seed(3)
    layer = tnn.Dropout(0.5)
    assert layer.training
    to = [TF.dropout(tp.to_tensor(a), 0.3, training=True),
          layer(tp.to_tensor(a))]
    for t, j in zip(to, jo):
        assert np.array_equal(t.numpy(), j.numpy())
    x = tp.to_tensor(a)
    assert layer.eval()(x) is x


def _qkv(seed, b=2, sq=6, sk=6, h=2, d=8):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, sq, h, d), _rand(rng, b, sk, h, d),
            _rand(rng, b, sk, h, d))


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_no_mask_runs_flash_and_matches_jax_xla_arm(causal):
    q, k, v = _qkv(8, sq=5, sk=9)
    ref = _sdpa_xla(*map(jnp.asarray, (q, k, v)), None, 0.0, causal, None)
    registry.reset_counts()
    out = TF.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                          is_causal=causal)
    assert registry.counts() == {"kernel.dispatch.flash_attention.plain": 1}
    assert _err(out, ref) <= 1e-5


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_sdpa_with_mask_matches_jax(kind):
    q, k, v = _qkv(9, sq=5, sk=7)
    rng = np.random.default_rng(10)
    if kind == "bool":
        m = rng.random((2, 1, 5, 7)) > 0.3
        m[..., 0] = True
    else:
        m = _rand(rng, 2, 1, 5, 7)
    js = [paddle.to_tensor(a) for a in (q, k, v, m)]
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, m)]
    ref = JF.scaled_dot_product_attention(*js[:3], attn_mask=js[3])
    registry.reset_counts()
    out = TF.scaled_dot_product_attention(*ts[:3], attn_mask=ts[3])
    assert registry.counts() == {}
    assert _err(out, ref) <= 1e-5
    # attention dropout in training: the probabilities' mask from the
    # global seed stream, the JAX package's with 64-bit types off
    with _x64_off():
        paddle.seed(4)
        ref = JF.scaled_dot_product_attention(*js[:3], attn_mask=js[3],
                                              dropout_p=0.1)
    tp.seed(4)
    out = TF.scaled_dot_product_attention(*ts[:3], attn_mask=ts[3],
                                          dropout_p=0.1)
    assert _err(out, ref) <= 1e-5


# --- layers on the same weights --------------------------------------------

@pytest.mark.parametrize("bias_attr", [None, False])
def test_linear_matches_jax(bias_attr):
    jl = JLinear(8, 6, bias_attr=bias_attr)
    tl = _carry(jl, tnn.Linear(8, 6, bias_attr=bias_attr))
    assert tuple(tl.weight.shape) == (8, 6)
    jx, tx = _pair(_rand(np.random.default_rng(11), 2, 5, 8))
    assert _err(tl(tx), jl(jx)) <= 1e-5


def test_layer_norm_layer_matches_jax():
    jl = JLayerNorm(16, epsilon=1e-6)
    tl = tnn.LayerNorm(16, epsilon=1e-6)
    rng = np.random.default_rng(12)
    state = {"weight": _rand(rng, 16), "bias": _rand(rng, 16)}
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    layer_state_from_numpy(tl, state)
    jx, tx = _pair(_rand(rng, 3, 7, 16, scale=2.0))
    assert _err(tl(tx), jl(jx)) <= 1e-5


def _mask(rng, b, sq, sk):
    return _rand(rng, b, 1, sq, sk)


def test_multi_head_attention_with_mask_matches_jax():
    jm = JMultiHeadAttention(16, 4)
    tm = _carry(jm, tnn.MultiHeadAttention(16, 4))
    rng = np.random.default_rng(13)
    (jq, tq), (jk, tk) = _pair(_rand(rng, 2, 5, 16)), _pair(
        _rand(rng, 2, 7, 16))
    (jmask, tmask) = _pair(_mask(rng, 2, 5, 7))
    assert _err(tm(tq, tk, tk, attn_mask=tmask),
                jm(jq, jk, jk, attn_mask=jmask)) <= 1e-5
    bmask = rng.random((2, 1, 5, 5)) > 0.2
    bmask[..., 0] = True
    assert _err(tm(tq, attn_mask=torch.from_numpy(bmask)),
                jm(jq, attn_mask=paddle.to_tensor(bmask))) <= 1e-5


def test_multi_head_attention_with_cache_matches_jax():
    """A Cache grows by this call's keys and values; a StaticCache holds
    what the JAX package's gen_cache puts there (ROADMAP C6)."""
    jm = JMultiHeadAttention(16, 4)
    tm = _carry(jm, tnn.MultiHeadAttention(16, 4))
    rng = np.random.default_rng(14)
    (jx, tx), (jy, ty) = _pair(_rand(rng, 2, 3, 16)), _pair(
        _rand(rng, 2, 4, 16))
    jc, tc = jm.gen_cache(jx), tm.gen_cache(tx)
    assert tuple(tc.k.shape) == tuple(jc.k.shape) == (2, 0, 4, 4)
    (jmask, tmask) = _pair(_mask(rng, 2, 3, 3))
    jo, jc = jm(jx, attn_mask=jmask, cache=jc)
    to, tc = tm(tx, attn_mask=tmask, cache=tc)
    assert isinstance(tc, tnn.MultiHeadAttention.Cache)
    (jmask, tmask) = _pair(_mask(rng, 2, 4, 7))
    jo, jc = jm(jy, attn_mask=jmask, cache=jc)
    to, tc = tm(ty, attn_mask=tmask, cache=tc)
    assert _err(to, jo) <= 1e-5
    assert _err(tc.k, jc.k) <= 1e-5 and _err(tc.v, jc.v) <= 1e-5
    js = jm.gen_cache(jx, type=jm.StaticCache)
    ts = tm.gen_cache(tx, type=tm.StaticCache)
    assert _err(ts.k, js.k) <= 1e-5 and _err(ts.v, js.v) <= 1e-5
    with pytest.raises(ValueError):
        jm.gen_cache(jx, jx)
    with pytest.raises(ValueError, match="ROADMAP C6"):
        tm.gen_cache(tx, tx)
    jo, jsc = jm(jx, attn_mask=_pair(_mask(rng, 2, 3, 3))[0], cache=js)
    assert type(jsc).__name__ == "StaticCache"
    assert tm(tx, attn_mask=tmask[..., :3, :3], cache=ts)[1] is ts


def test_fused_layer_norm_layer_matches_jax_forward_and_grads():
    jl = jinc.nn.FusedLayerNorm(48)
    tl = tinc.nn.FusedLayerNorm([48])
    assert tl.weight.dtype == tl.bias.dtype == torch.float32
    rng = np.random.default_rng(15)
    state = {"weight": _rand(rng, 48), "bias": _rand(rng, 48)}
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    layer_state_from_numpy(tl, state)
    x, w = _rand(rng, 3, 70, 48, scale=2.0), _rand(rng, 3, 70, 48)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = tp.to_tensor(x, stop_gradient=False)
    jy, ty = jl(jx), tl(tx)
    assert _err(ty, jy) <= 1e-5
    (jy * paddle.to_tensor(w)).sum().backward()
    (ty * tp.to_tensor(w)).sum().backward()
    for got, ref in ((tx.grad, jx.grad), (tl.weight.grad, jl.weight.grad),
                     (tl.bias.grad, jl.bias.grad)):
        assert _err(got, ref) <= 1e-4
    with pytest.raises(ValueError, match="last axis only"):
        tinc.nn.FusedLayerNorm([4, 48])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_fused_multi_head_attention_matches_jax(normalize_before):
    """Both at the default 0.5 dropout rates, in eval."""
    jm = jinc.nn.FusedMultiHeadAttention(
        16, 4, normalize_before=normalize_before)
    tm = _carry(jm, tinc.nn.FusedMultiHeadAttention(
        16, 4, normalize_before=normalize_before))
    jm.eval()
    tm.eval()
    rng = np.random.default_rng(16)
    (jx, tx), (jmask, tmask) = _pair(_rand(rng, 2, 6, 16)), _pair(
        _mask(rng, 2, 6, 6))
    assert _err(tm(tx, attn_mask=tmask), jm(jx, attn_mask=jmask)) <= 1e-5


@pytest.mark.parametrize("activation", ["relu", "gelu", "silu", "tanh",
                                        "sigmoid"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_fused_feed_forward_matches_jax(activation, normalize_before):
    jm = jinc.nn.FusedFeedForward(16, 40, activation=activation,
                                  normalize_before=normalize_before)
    tm = _carry(jm, tinc.nn.FusedFeedForward(
        16, 40, activation=activation, normalize_before=normalize_before,
        ))
    jm.eval()
    tm.eval()
    jx, tx = _pair(_rand(np.random.default_rng(17), 2, 6, 16))
    assert _err(tm(tx), jm(jx)) <= 1e-5


def test_fused_transformer_encoder_layer_matches_jax():
    jm = jinc.nn.FusedTransformerEncoderLayer(16, 4, 40, activation="gelu")
    tm = _carry(jm, tinc.nn.FusedTransformerEncoderLayer(
        16, 4, 40, activation="gelu"))
    jm.eval()
    tm.eval()
    rng = np.random.default_rng(18)
    (jx, tx), (jmask, tmask) = _pair(_rand(rng, 2, 6, 16)), _pair(
        _mask(rng, 2, 6, 6))
    assert _err(tm(tx, src_mask=tmask), jm(jx, src_mask=jmask)) <= 1e-4


def _transformers(num_layers=2):
    jm = jinc.nn.FusedMultiTransformer(32, 4, 64, num_layers=num_layers)
    tm = tinc.nn.FusedMultiTransformer(32, 4, 64, num_layers=num_layers)
    assert list(tm.state_dict()) == list(jm.state_dict())
    return jm, _carry(jm, tm)


def test_fused_multi_transformer_matches_jax():
    jm, tm = _transformers()
    assert len(tm.state_dict()) == 32
    rng = np.random.default_rng(19)
    (jx, tx), (jmask, tmask) = _pair(_rand(rng, 2, 9, 32)), _pair(
        _mask(rng, 2, 9, 9))
    assert _err(tm(tx, attn_mask=tmask), jm(jx, attn_mask=jmask)) <= 1e-4


def test_fused_multi_transformer_drops_its_caches_as_the_reference():
    """ROADMAP C5: each layer attends over its cache, and the extended
    caches come back as []."""
    jm, tm = _transformers()
    rng = np.random.default_rng(20)
    (jx, tx), (jmask, tmask) = _pair(_rand(rng, 2, 3, 32)), _pair(
        _mask(rng, 2, 3, 5))
    kv = [_rand(rng, 2, 2, 4, 8) for _ in range(4)]
    jc = [JMultiHeadAttention.Cache(paddle.to_tensor(kv[2 * i]),
                                    paddle.to_tensor(kv[2 * i + 1]))
          for i in range(2)]
    tc = [tnn.MultiHeadAttention.Cache(torch.from_numpy(kv[2 * i]),
                                       torch.from_numpy(kv[2 * i + 1]))
          for i in range(2)]
    jo, jnew = jm(jx, attn_mask=jmask, caches=jc)
    to, tnew = tm(tx, attn_mask=tmask, caches=tc)
    assert jnew == [] and tnew == []
    assert _err(to, jo) <= 1e-4


def test_fused_multi_transformer_is_pre_ln_only():
    with pytest.raises(NotImplementedError, match="pre-LN"):
        tinc.nn.FusedMultiTransformer(32, 4, 64, normalize_before=False)


def test_fused_multi_transformer_no_mask_takes_flash_once_per_layer():
    """The JAX stack cannot run without a mask (ROADMAP C1): the port's
    no-mask forward equals its own forward with an all-zero additive mask,
    which takes the plain softmax arm."""
    _, tm = _transformers(num_layers=3)
    tm.eval()
    x = torch.from_numpy(_rand(np.random.default_rng(21), 2, 9, 32))
    registry.reset_counts()
    with torch.no_grad():
        out = tm(x)
    assert registry.counts() == {"kernel.dispatch.flash_attention.plain": 3}
    with torch.no_grad():
        ref = tm(x, attn_mask=torch.zeros(2, 1, 9, 9))
    assert _err(out, ref) <= 1e-5


# --- carry-over and the device rule ----------------------------------------

def test_layer_state_from_numpy_is_strict_and_keeps_dtypes():
    tl = tnn.Linear(4, 3)
    w = np.ones((4, 3), jnp.bfloat16)
    layer_state_from_numpy(tl, {"weight": w, "bias": np.zeros(3, np.float32)})
    assert tl.weight.dtype == torch.bfloat16 and tl.bias.dtype == torch.float32
    with pytest.raises(KeyError, match=r"missing \['bias'\], unexpected "
                                       r"\['extra'\]"):
        layer_state_from_numpy(tl, {"weight": w, "extra": w})


@pytest.mark.parametrize("make", [
    lambda kw: tnn.Linear(4, 4, **kw),
    lambda kw: tnn.LayerNorm(4, **kw),
    lambda kw: tnn.MultiHeadAttention(8, 2, **kw),
    lambda kw: tinc.nn.FusedLayerNorm(8, **kw),
    lambda kw: tinc.nn.FusedMultiHeadAttention(8, 2, **kw),
    lambda kw: tinc.nn.FusedFeedForward(8, 16, **kw),
    lambda kw: tinc.nn.FusedTransformerEncoderLayer(8, 2, 16, **kw),
    lambda kw: tinc.nn.FusedMultiTransformer(8, 2, 16, **kw)],
    ids=["Linear", "LayerNorm", "MultiHeadAttention", "FusedLayerNorm",
         "FusedMultiHeadAttention", "FusedFeedForward",
         "FusedTransformerEncoderLayer", "FusedMultiTransformer"])
def test_layers_default_to_the_card(make, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with monkeypatch.context() as m:
        m.setattr(tdevice, "_current", None)      # no set_device yet
        with pytest.raises(RuntimeError, match='set_device\\("cpu"\\)'):
            make({})
    layer = make({})
    assert all(p.place.is_cpu_place() for p in layer.parameters())


def test_fresh_weights_follow_the_generator():
    """Fresh weights come from the global generator: one seed, one set of
    weights, and the JAX package's under the same seed."""
    def make(seed):
        tp.seed(seed)
        return tinc.nn.FusedMultiTransformer(8, 2, 16, num_layers=2
                                             ).state_dict()
    a, b, c = make(0), make(0), make(1)
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)
    assert not np.array_equal(a["layer_1.ffn.linear1.weight"].numpy(),
                              c["layer_1.ffn.linear1.weight"].numpy())
    paddle.seed(0)
    j = jinc.nn.FusedMultiTransformer(8, 2, 16, num_layers=2).state_dict()
    assert all(_err(a[k], j[k]) <= 1e-6 for k in j)
