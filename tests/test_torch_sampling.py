"""The port's threefry key chain (`paddle_tpu_torch/kernels/prng.py`), its
fused sampler (`kernels/sampling.py`) and the sampled `DecodeEngine` held
against the JAX package and `jax.random` (jax 0.9.0, threefry
partitionable, 64-bit types on as `paddle_tpu` sets them) on the same
numpy-drawn inputs:

- key words, splits, 32-bit random bits and uniforms are bit-identical;
- Gumbel draws within 2 ulp of the value's scale floored at 1: each of
  the two logs may round one place apart (XLA's CPU log against
  PyTorch's), and near g = 0 that error is absolute, not relative;
- sampled tokens and key chains are equal, a greedy slot's chain never
  moves, the accept test gives the JAX table;
- the sampled engine's tokens equal JAX `fast_generate` for the same
  (temperature, top_k, seed), one-shot and chunked, and a sampled step
  reads back tokens only, once per step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.kernels import sampling as jsmp
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.kernels import prng, registry
from paddle_tpu_torch.kernels import sampling as tsmp
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


SEEDS = (0, 1, 42, 2 ** 40 + 5, -3)
SHAPES = ((3,), (4, 7), (1, 50257))
# the (temperature, top_k) set of tests/test_fused_sampler.py
PARAMS = [(1.0, 0), (0.8, 0), (1.0, 5), (0.7, 3), (2.5, 1)]
GUMBEL_ULPS = 2


def _words(a):
    """A JAX uint32 array as int64, the port's carrier of key words."""
    return np.asarray(a).astype(np.int64)


def _tkey(jkey):
    return torch.from_numpy(_words(jkey))


def _gumbel_ulps(got, want):
    """|got - want| in units of the last place at max(|want|, 1)."""
    want = np.asarray(want, np.float32)
    scale = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    return float(np.max(np.abs(np.asarray(got, np.float64) - want) / scale))


# ------------------------------------------------------------- key chain

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_bit_identical_to_jax(seed, shape):
    jkey = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), _words(jkey))
    np.testing.assert_array_equal(prng.seed_words(seed), np.asarray(jkey))
    for num in (2, 3):
        np.testing.assert_array_equal(prng.split(tkey, num).numpy(),
                                      _words(jax.random.split(jkey, num)))
    np.testing.assert_array_equal(
        prng.random_bits(tkey, shape).numpy(),
        _words(jax.random.bits(jkey, shape, dtype=jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (np.finfo(np.float32).tiny, 1.0),
                   (-2.0, 3.5)):
        want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32,
                                             minval=lo, maxval=hi))
        got = prng.uniform(tkey, shape, minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_2_ulp_of_jax(seed, shape):
    want = jax.random.gumbel(jax.random.PRNGKey(seed), shape, jnp.float32,
                             mode="low")
    got = prng.gumbel(prng.prng_key(seed), shape).numpy()
    assert _gumbel_ulps(got, want) <= GUMBEL_ULPS


def test_batched_keys_draw_each_row_from_its_own_key():
    """Keys [B, 2] against counters 0..V-1 in one pass equal B separate
    [1, V] draws, the JAX vmap of per-slot draws."""
    jkeys = [jax.random.split(jax.random.PRNGKey(s))[1] for s in SEEDS]
    tkeys = torch.stack([_tkey(k) for k in jkeys])
    bits = prng.random_bits(tkeys, (1, 97)).numpy()
    split = prng.split(tkeys).numpy()
    for i, k in enumerate(jkeys):
        np.testing.assert_array_equal(bits[i], _words(jax.random.bits(
            k, (1, 97), dtype=jnp.uint32)))
        np.testing.assert_array_equal(split[i], _words(jax.random.split(k)))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_matches_jax(seed):
    rng = np.random.RandomState(seed + 7)
    logits = rng.randn(3, 64).astype(np.float32)
    jkey = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits)))
    got = prng.categorical(prng.prng_key(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- sampler

@pytest.mark.parametrize("v", [64, 50257])
@pytest.mark.parametrize("t,k", PARAMS)
def test_sample_one_chain_matches_jax(t, k, v):
    """Five chained draws: tokens and keys equal to the JAX `sample_one`
    and to `_make_sampler` (`fast_generate`'s sampler) at B=1."""
    rng = np.random.RandomState(int(t * 10) + k)
    host = jgpt._make_sampler(t, k)
    thost = tgpt._make_sampler(t, k)
    jk = hk = jax.random.PRNGKey(42)
    tk = th = prng.prng_key(42)
    for _ in range(5):
        lg = rng.randn(1, v).astype(np.float32)
        a, hk = host(jnp.asarray(lg), hk)
        b, jk = jsmp.sample_one(jnp.asarray(lg[0]), jk, jnp.float32(t),
                                jnp.int32(k))
        c, tk = tsmp.sample_one(torch.from_numpy(lg[0]), tk, t, k)
        d, th = thost(torch.from_numpy(lg), th)
        assert int(a[0]) == int(b) == int(c) == int(d[0])
        np.testing.assert_array_equal(tk.numpy(), _words(jk))
        np.testing.assert_array_equal(th.numpy(), _words(hk))


@pytest.mark.parametrize("t,k", PARAMS)
def test_make_sampler_one_key_over_rows_matches_jax(t, k):
    """`_make_sampler` on [N, V] logits with ONE key (the fast_generate
    shape): every row's noise comes from that key's counters."""
    lg = np.random.RandomState(k + 3).randn(3, 64).astype(np.float32)
    a, ka = jgpt._make_sampler(t, k)(jnp.asarray(lg), jax.random.PRNGKey(5))
    b, kb = tgpt._make_sampler(t, k)(torch.from_numpy(lg), prng.prng_key(5))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(kb.numpy(), _words(ka))


def test_fused_sample_batched_mixed_params_matches_jax():
    rng = np.random.RandomState(1)
    t = np.array([1.0, 0.5, 1.0, 2.0, 0.8, 1.0], np.float32)
    k = np.array([0, 4, 7, 0, 1, 0], np.int32)
    jkeys = jnp.stack([jax.random.PRNGKey(i) for i in range(6)])
    tkeys = torch.from_numpy(_words(jkeys))
    registry.reset_counts()
    for _ in range(5):
        lg = rng.randn(6, 64).astype(np.float32)
        jt, jkeys = jsmp.fused_sample(jnp.asarray(lg), jkeys,
                                      jnp.asarray(t), jnp.asarray(k))
        tt, tkeys = tsmp.fused_sample(torch.from_numpy(lg), tkeys,
                                      torch.from_numpy(t), torch.from_numpy(k))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tkeys.numpy(), _words(jkeys))
    assert registry.counts()["kernel.dispatch.fused_sampling.torch"] == 5
    # greedy rows (0 and 5) kept their seed keys through all five steps
    for i in (0, 5):
        np.testing.assert_array_equal(tkeys[i].numpy(),
                                      _words(jax.random.PRNGKey(i)))


def test_greedy_never_advances_the_chain():
    lg = torch.from_numpy(np.random.RandomState(0).randn(64)
                          .astype(np.float32))
    key = prng.prng_key(7)
    tok, nk = tsmp.sample_one(lg, key, 1.0, 0)
    assert int(tok) == int(lg.argmax())
    assert torch.equal(nk, key)


def test_accept_drafts_table_and_jax_parity():
    drafts = np.array([[5, 6], [5, 6], [9, 9], [1, 1]], np.int32)
    out = np.array([[5, 6, 7], [5, 9, 7], [1, 9, 7], [1, 1, 1]], np.int32)
    dl = np.array([2, 2, 2, 0], np.int32)
    on = np.ones(4, bool)

    def port(d, o, n, m):
        return tsmp.accept_drafts(*(torch.from_numpy(x)
                                    for x in (d, o, n, m))).numpy()
    # full accept + 1, first match + 1, first mismatch rejects the rest,
    # zero drafts -> exactly one token; inactive slots emit nothing
    assert port(drafts, out, dl, on).tolist() == [3, 2, 1, 1]
    assert port(drafts, out, dl, ~on).tolist() == [0, 0, 0, 0]
    rng = np.random.RandomState(3)
    for _ in range(4):
        d = rng.randint(0, 3, (6, 4)).astype(np.int32)
        o = rng.randint(0, 3, (6, 5)).astype(np.int32)
        n = rng.randint(0, 5, 6).astype(np.int32)
        m = rng.rand(6) < 0.8
        want = jsmp.accept_drafts(jnp.asarray(d), jnp.asarray(o),
                                  jnp.asarray(n), jnp.asarray(m))
        np.testing.assert_array_equal(port(d, o, n, m), np.asarray(want))


# ---------------------------------------------------------------- engine

SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=64)
ECFG = dict(page_size=4, max_slots=3, min_bucket=8)
CASES = [(0.8, 5, 7), (1.3, 0, 3), (1.0, 4, 11), (1.0, 0, 0)]


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(11)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    w = {}
    for name, v in jm.state_dict().items():
        base = 1.0 if name.endswith(("ln_1.weight", "ln_2.weight",
                                     "ln_f.weight")) else 0.0
        w[name] = (base + rng.randn(*v._data.shape) * 0.1).astype(np.float32)
    jm.set_state_dict(w)
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL))
    tm.set_state_dict(params_from_numpy(w, "cpu"))
    return jm, tm


def _fast_generate(jm, prompt, t, k, s, n):
    return np.asarray(jm.fast_generate(
        paddle.Tensor(prompt[None], _internal=True), max_new_tokens=n,
        temperature=t, top_k=k, seed=s).numpy())[0]


def _serve(eng, prompt, cases, n):
    reqs = [eng.submit(prompt, max_new_tokens=n, temperature=t, top_k=k,
                       seed=s) for t, k, s in cases]
    eng.run_until_idle(max_steps=400)
    return [r.result(timeout=0) for r in reqs]


@pytest.mark.parametrize("chunk", [None, 4], ids=["one_shot", "chunked"])
def test_sampled_engine_matches_fast_generate(models, chunk):
    """Concurrent requests with mixed (temperature, top_k, seed), a greedy
    one among them, more requests than slots: each equals JAX
    `fast_generate` alone with its parameters."""
    jm, tm = models
    prompt = np.random.RandomState(1).randint(0, 97, 11).astype(np.int32)
    eng = DecodeEngine(tm, EngineConfig(**ECFG, sampling=True,
                                        prefill_chunk_tokens=chunk),
                       device="cpu")
    for (t, k, s), got in zip(CASES, _serve(eng, prompt, CASES, 8)):
        np.testing.assert_array_equal(got,
                                      _fast_generate(jm, prompt, t, k, s, 8))
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1


def test_greedy_on_sampling_engine_matches_plain_engine(models):
    _, tm = models
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 97, n).astype(np.int32) for n in (9, 3, 14)]
    outs = []
    for sampling in (False, True):
        eng = DecodeEngine(tm, EngineConfig(**ECFG, sampling=sampling,
                                            prefill_chunk_tokens=8),
                           device="cpu")
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_idle(max_steps=200)
        outs.append([r.result(timeout=0) for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_chunked_prefill_samples_the_final_chunk_only(models):
    """A 14-token prompt in 4-token chunks: every chunk runs the one chunk
    program, which draws (as the JAX chunk program does), but only the
    final chunk's draw is kept: the slot's key row stays as it was and no
    token is emitted until then, and the row then holds the seed key split
    once."""
    jm, tm = models
    prompt = np.random.RandomState(3).randint(0, 97, 14).astype(np.int32)
    eng = DecodeEngine(tm, EngineConfig(**ECFG, sampling=True,
                                        prefill_chunk_tokens=4),
                       device="cpu")
    req = eng.submit(prompt, max_new_tokens=6, temperature=0.7, top_k=3,
                     seed=5)
    registry.reset_counts()
    before = eng._keys_dev.clone()
    for _ in range(3):                 # chunks 1-3 of 4: no draw is kept
        eng.step()
    assert registry.counts()["kernel.dispatch.fused_sampling.torch"] == 3
    assert not req.generated and torch.equal(eng._keys_dev, before)
    eng.step()                         # the final chunk's draw is kept
    assert registry.counts()["kernel.dispatch.fused_sampling.torch"] == 4
    assert len(req.generated) == 1
    np.testing.assert_array_equal(
        eng._keys_dev[0].numpy(),
        _words(jax.random.split(jax.random.PRNGKey(5))[0]))
    eng.run_until_idle(max_steps=50)
    np.testing.assert_array_equal(req.result(timeout=0),
                                  _fast_generate(jm, prompt, 0.7, 3, 5, 6))


@pytest.mark.parametrize("bad,match", [
    (dict(temperature=0.7), "sampling=True"),
    (dict(top_k=3), "sampling=True"),
    (dict(temperature=0.0), "temperature must be > 0"),
    (dict(temperature=float("nan")), "temperature must be > 0"),
    (dict(top_k=-1), "top_k must be >= 0")])
def test_sampled_parameters_refused(models, bad, match):
    _, tm = models
    sampling = "sampling" not in match
    eng = DecodeEngine(tm, EngineConfig(**ECFG, sampling=sampling),
                       device="cpu")
    with pytest.raises(ValueError, match=match):
        eng.submit([1, 2, 3], max_new_tokens=2, **bad)


class _Readbacks:
    """Records every tensor the code under test reads to the host: ``.cpu()``,
    ``int()``, ``.item()``, ``.tolist()`` (``.numpy()`` takes a CPU tensor,
    so on the card it follows a ``.cpu()`` already counted)."""

    METHODS = ("cpu", "__int__", "item", "tolist")

    def __init__(self, monkeypatch):
        self.reads = []
        for name in self.METHODS:
            orig = getattr(torch.Tensor, name)

            def wrap(t, *a, _orig=orig, **kw):
                self.reads.append((t.dtype, t.numel()))
                return _orig(t, *a, **kw)
            monkeypatch.setattr(torch.Tensor, name, wrap)


@pytest.mark.parametrize("chunk,spec", [(None, None), (4, None), (4, 3)],
                         ids=["one_shot", "chunked", "speculative"])
def test_one_token_readback_per_step_and_never_logits(models, monkeypatch,
                                                      chunk, spec):
    """One integer readback per decode or verify step (a verify step's
    emitted tokens and their count together) and one per prompt."""
    _, tm = models
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 97, n).astype(np.int32) for n in (5, 11, 7)]
    eng = DecodeEngine(tm, EngineConfig(**ECFG, sampling=True,
                                        prefill_chunk_tokens=chunk,
                                        speculate_k=spec),
                       device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=5, temperature=0.9, top_k=4, seed=i)
    rb = _Readbacks(monkeypatch)
    eng.run_until_idle(max_steps=200)
    c = eng.counters
    # one per decode step and one per prompt (its first token)
    assert c["d2h_transfers"] == c["steps"] + 3 == len(rb.reads)
    assert c["spec_steps"] == (c["steps"] if spec else 0)
    width = 3 * (spec + 2) if spec else 3      # [B, K+2] or [B]
    assert all(not dt.is_floating_point and n <= width
               for dt, n in rb.reads)
