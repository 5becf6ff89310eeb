"""Speculative decode in the port held against the JAX package on the same
numpy-drawn weights and inputs:

- `verify_page_coords` and `verify_step` (greedy, a static ``sampler=``,
  the fused ``sample_state=``; float and int8 pools) against the JAX
  functions: the model's token at every window position, n_emitted,
  lengths and key chains equal; pools within 1e-5 (float) or, over int8
  pools, scales within 1e-6 relative and values equal but for a few one
  quantization step apart (products summed in another order land on the
  other side of a rounding boundary);
- `_DraftIndex` against a brute-force suffix search;
- the speculating `DecodeEngine`, greedy and sampled, gives the tokens of
  the non-speculative engine and of the JAX engine with ``speculate_k``,
  also with an EOS inside an accepted run and with a request that opts out
  of drafting; ``speculate_k < 1`` is refused.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.engine import DecodeEngine as JEngine
from paddle_tpu.inference.engine import EngineConfig as JConfig
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference import engine as teng
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import params_from_numpy

TOL = 1e-5
SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=64)
NL, NH, DH, PS = 2, 2, 16, 4


def _weights(seed):
    rng = np.random.RandomState(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    w = {}
    for name, v in jm.state_dict().items():
        base = 1.0 if name.endswith(("ln_1.weight", "ln_2.weight",
                                     "ln_f.weight")) else 0.0
        w[name] = (base + rng.randn(*v._data.shape) * 0.1).astype(np.float32)
    return w, jm


def _words(a):
    return np.asarray(a).astype(np.int64)


# ------------------------------------------------------------ verify step

# 4 slots, 3 pages of 4 tokens each (capacity 12), window K+1 = 4: a page
# crossing, a partly wrong draft, a window running past the capacity (its
# last two writes go to the trash page), and an inactive slot
TABLE = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [12, 13, 0]], np.int32)
LENGTHS = np.array([3, 5, 10, 2], np.int32)
DRAFT_LEN = np.array([3, 2, 3, 1], np.int32)
MASK = np.array([True, True, True, False])
K = 3


def test_verify_page_coords_matches_jax():
    pos = LENGTHS[:, None] + np.arange(K + 1)[None]
    valid = MASK[:, None] & (np.arange(K + 1)[None] <= DRAFT_LEN[:, None])
    jp, jo = jpa.verify_page_coords(jnp.asarray(TABLE), jnp.asarray(pos),
                                    jnp.asarray(valid), PS)
    tp, to = tpa.verify_page_coords(torch.from_numpy(TABLE),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(valid), PS)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert (tp.numpy()[2, 2:] == tpa.TRASH_PAGE).all()    # past capacity


def _pools(seed, quant):
    rng = np.random.RandomState(seed)
    shape = (NL, 14, PS, NH, DH)
    if not quant:
        return [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    return [rng.randint(-127, 128, shape).astype(np.int8),
            rng.randint(-127, 128, shape).astype(np.int8),
            rng.uniform(0.001, 0.02, shape[:4]).astype(np.float32),
            rng.uniform(0.001, 0.02, shape[:4]).astype(np.float32)]


def _cache(pools, lib):
    names = ("k_pages", "v_pages", "k_scale", "v_scale")
    if lib == "jax":
        c = {n: jnp.asarray(p) for n, p in zip(names, pools)}
        c.update(page_table=jnp.asarray(TABLE), lengths=jnp.asarray(LENGTHS))
    else:
        c = {n: torch.from_numpy(p.copy()) for n, p in zip(names, pools)}
        c.update(page_table=torch.from_numpy(TABLE),
                 lengths=torch.from_numpy(LENGTHS))
    return c


KEY_SEEDS = (3, 8, 0, 5)
TEMPS = np.array([0.8, 1.0, 1.3, 0.9], np.float32)
TOPKS = np.array([5, 0, 0, 2], np.int32)


def _jax_verify(jp, cfg, tok_seq, pools, arm):
    keys = jnp.stack([jax.random.PRNGKey(s) for s in KEY_SEEDS])
    kw = {"sampler": dict(sampler=jgpt._make_sampler(0.8, 3), keys=keys),
          "fused": dict(sample_state=(keys, jnp.asarray(TEMPS),
                                      jnp.asarray(TOPKS))),
          "greedy": {}}[arm]
    return jgpt.verify_step(jp, jnp.asarray(tok_seq), jnp.asarray(DRAFT_LEN),
                            _cache(pools, "jax"), jnp.asarray(MASK),
                            cfg=cfg, **kw)


def _port_verify(tp, cfg, tok_seq, pools, arm):
    keys = torch.stack([torch.from_numpy(_words(jax.random.PRNGKey(s)))
                        for s in KEY_SEEDS])
    kw = {"sampler": dict(sampler=tgpt._make_sampler(0.8, 3), keys=keys),
          "fused": dict(sample_state=(keys, torch.from_numpy(TEMPS),
                                      torch.from_numpy(TOPKS))),
          "greedy": {}}[arm]
    cache = _cache(pools, "torch")
    return cache, tgpt.verify_step(tp, torch.from_numpy(tok_seq),
                                   torch.from_numpy(DRAFT_LEN), cache,
                                   torch.from_numpy(MASK), cfg=cfg, **kw)


def _check_int8(tpools, jpools):
    tk, tv, tks, tvs = (t.numpy()[:, 1:] for t in tpools)
    jk, jv, jks, jvs = (np.asarray(a)[:, 1:] for a in jpools)
    for t, j in ((tks, jks), (tvs, jvs)):
        assert np.all(np.abs(t - j) <= 1e-6 * np.abs(j))
    steps = [np.abs(t.astype(np.int32) - j.astype(np.int32))
             for t, j in ((tk, jk), (tv, jv))]
    assert max(int(s.max()) for s in steps) <= 1
    assert sum(int((s > 0).sum()) for s in steps) <= 4


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arm", ["greedy", "sampler", "fused"])
def test_verify_step_matches_jax(arm, quant):
    w, _ = _weights(0)
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = params_from_numpy(w, "cpu")
    jcfg, tcfg = jgpt.GPTConfig(**SMALL), tgpt.GPTConfig(**SMALL)
    pools = _pools(1, quant)
    rng = np.random.RandomState(2)
    tok_seq = rng.randint(0, 97, (4, K + 1)).astype(np.int32)
    # drafts the model accepts: K rounds of feeding its own tokens back,
    # then one wrong draft in slot 1 (accepted 1, then rejected)
    for _ in range(K):
        out = np.asarray(_jax_verify(jp, jcfg, tok_seq, pools, arm)[0])
        tok_seq[:, 1:] = out[:, :K]
    tok_seq[1, 2] = (tok_seq[1, 2] + 1) % 97
    want = _jax_verify(jp, jcfg, tok_seq, pools, arm)
    cache, got = _port_verify(tp, tcfg, tok_seq, pools, arm)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].tolist() == [4, 2, 4, 0]
    np.testing.assert_array_equal(got[2]["lengths"].numpy(),
                                  np.asarray(want[2]["lengths"]))
    if arm == "greedy":
        assert len(got) == 3
    else:
        np.testing.assert_array_equal(got[3].numpy(), _words(want[3]))
        # the inactive slot's chain did not move
        np.testing.assert_array_equal(
            got[3][3].numpy(), _words(jax.random.PRNGKey(KEY_SEEDS[3])))
    names = ("k_pages", "v_pages", "k_scale", "v_scale")[:len(pools)]
    assert got[2]["k_pages"] is cache["k_pages"]          # in place
    if quant:
        _check_int8([cache[n] for n in names],
                    [want[2][n] for n in names])
    else:
        for n in names:
            d = np.abs(cache[n].numpy()[:, 1:]
                       - np.asarray(want[2][n])[:, 1:]).max()
            assert d <= TOL


def test_verify_step_refuses_both_samplers():
    w, _ = _weights(0)
    keys = torch.zeros(4, 2, dtype=torch.int64)
    cache = _cache(_pools(1, False), "torch")
    args = (params_from_numpy(w, "cpu"), torch.zeros(4, 2, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), cache, torch.from_numpy(MASK))
    with pytest.raises(ValueError, match="OR"):
        tgpt.verify_step(*args, cfg=tgpt.GPTConfig(**SMALL),
                         sampler=tgpt._make_sampler(0.5, 0), keys=keys,
                         sample_state=(keys, torch.ones(4),
                                       torch.zeros(4, dtype=torch.int32)))
    with pytest.raises(ValueError, match="go together"):
        tgpt.verify_step(*args, cfg=tgpt.GPTConfig(**SMALL),
                         sampler=tgpt._make_sampler(0.5, 0))


# --------------------------------------------------------------- drafter

def _brute_draft(hist, k):
    """The longest suffix (3, 2, then 1 tokens) that occurred before with a
    follower; the tokens after its most recent such occurrence."""
    for n in (3, 2, 1):
        if len(hist) <= n:
            continue
        suf = hist[-n:]
        for j in range(len(hist) - n - 1, -1, -1):
            if hist[j:j + n] == suf:
                return hist[j + n:j + n + k]
    return []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draft_index_matches_brute_force(seed):
    rng = np.random.RandomState(seed)
    toks = [int(t) for t in rng.randint(0, 4 + 3 * seed, 60)]
    idx = teng._DraftIndex(toks[:5])
    for i in range(5, len(toks)):
        for k in (1, 3, 6):
            assert idx.draft(k) == _brute_draft(toks[:i], k), (i, k)
        idx.append(toks[i])


# ---------------------------------------------------------------- engine

ECFG = dict(page_size=4, max_slots=3, min_bucket=8, prefill_chunk_tokens=8)


@pytest.fixture(scope="module")
def models():
    w, jm = _weights(11)
    jm.set_state_dict(w)
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL))
    tm.load_state_dict(params_from_numpy(w, "cpu"))
    return jm, tm


def _prompts():
    """Tiled patterns (the drafter finds them), 8 and 12 tokens one-shot,
    16 chunked; four requests for three slots."""
    rng = np.random.RandomState(4)
    return [np.tile(rng.randint(0, 97, m), r).astype(np.int32)
            for m, r in ((4, 3), (3, 4), (2, 4), (8, 2))]


def _serve(eng, prompts, params, n=12):
    reqs = [eng.submit(p, max_new_tokens=n, **kw)
            for p, kw in zip(prompts, params)]
    eng.run_until_idle(max_steps=400)
    return [r.result(timeout=0) for r in reqs]


GREEDY = [{}] * 4
SAMPLED = [dict(temperature=0.9, top_k=4, seed=2), {},
           dict(temperature=1.4, seed=9), dict(top_k=2, seed=1)]


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_speculative_equals_plain_and_jax_engines(models, sampled):
    jm, tm = models
    prompts, params = _prompts(), (SAMPLED if sampled else GREEDY)
    kw = dict(ECFG, sampling=sampled)
    plain = _serve(DecodeEngine(tm, EngineConfig(**kw), device="cpu"),
                   prompts, params)
    eng = DecodeEngine(tm, EngineConfig(**kw, speculate_k=3), device="cpu")
    spec = _serve(eng, prompts, params)
    jax_spec = _serve(JEngine(jm, JConfig(**kw, speculate_k=3)), prompts,
                      params)
    for a, b, c in zip(spec, plain, jax_spec):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    c = eng.counters
    assert c["spec_steps"] == c["steps"] > 0
    assert 0 < c["spec_accepted"] <= c["spec_drafted"]
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1


def test_speculative_int8_pools_equal_plain(models):
    _, tm = models
    prompts = _prompts()
    kw = dict(ECFG, kv_dtype="int8", sampling=True)
    plain = _serve(DecodeEngine(tm, EngineConfig(**kw), device="cpu"),
                   prompts, SAMPLED)
    spec = _serve(DecodeEngine(tm, EngineConfig(**kw, speculate_k=2),
                               device="cpu"), prompts, SAMPLED)
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_speculative_eos_inside_an_accepted_run(models, monkeypatch,
                                                sampled):
    """Drafts from an oracle (the plain run's own continuation) are all
    accepted, so each verify step emits a run of K+1 tokens: generated
    tokens 1-4 come from the first. EOS is a request's token 2 or 3, its
    first occurrence there: the request stops right after it, inside the
    run, as plain decode stops."""
    _, tm = models
    prompts, params = _prompts(), (SAMPLED if sampled else GREEDY)
    kw = dict(ECFG, sampling=sampled)
    full = _serve(DecodeEngine(tm, EngineConfig(**kw), device="cpu"),
                  prompts, params)
    eos = None
    for p, seq in zip(prompts, full):
        gen = [int(t) for t in seq[p.size:]]
        for g in (2, 3):
            if gen[g] not in gen[:g]:
                eos, stop = gen[g], (p, g)
                break
        if eos is not None:
            break
    assert eos is not None, "no fresh token at generated index 2 or 3"

    def oracle(self, k):
        for p, seq in zip(prompts, full):
            if self.hist[:p.size] == p.tolist():
                return [int(t) for t in seq[len(self.hist):len(self.hist)
                                               + k]]
        raise AssertionError("draft for an unknown prompt")
    monkeypatch.setattr(teng._DraftIndex, "draft", oracle)
    plain = _serve(DecodeEngine(tm, EngineConfig(**kw, eos_id=eos),
                                device="cpu"), prompts, params)
    eng = DecodeEngine(tm, EngineConfig(**kw, eos_id=eos, speculate_k=3),
                       device="cpu")
    spec = _serve(eng, prompts, params)
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)
    p, g = stop
    got = spec[[q is p for q in prompts].index(True)]
    assert got.size == p.size + g + 1 and got[-1] == eos
    assert eng.counters["spec_accepted"] >= 3


def test_request_opts_out_of_drafting(models):
    _, tm = models
    prompts = _prompts()
    plain = _serve(DecodeEngine(tm, EngineConfig(**ECFG), device="cpu"),
                   prompts, GREEDY)
    eng = DecodeEngine(tm, EngineConfig(**ECFG, speculate_k=3), device="cpu")
    out = _serve(eng, prompts, [dict(speculate=False)] * 4)
    assert eng.counters["spec_steps"] > 0
    assert eng.counters["spec_drafted"] == 0    # every step a plain one
    mixed = _serve(DecodeEngine(tm, EngineConfig(**ECFG, speculate_k=3),
                                device="cpu"), prompts,
                   [dict(speculate=False), {}, {}, dict(speculate=False)])
    for a, b, c in zip(out, mixed, plain):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("k", [0, -1])
def test_speculate_k_below_one_refused(models, k):
    _, tm = models
    with pytest.raises(ValueError, match="speculate_k must be >= 1"):
        DecodeEngine(tm, EngineConfig(**ECFG, speculate_k=k), device="cpu")
