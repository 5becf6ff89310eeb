"""`jit.to_static` on the port (`paddle_tpu_torch/jit/static_function.py`)
held against the JAX package's `to_static` on the CPU, where the port runs
its state protocol without a graph: a tiny GPT (2 layers, 32 wide) trained
by the JAX bench's program (`bench.py:155-196`), the ``jit.*`` counters
over a sequence that changes the signature and the ``.grad`` presence, a
decorated Layer, ``multi_steps`` and its errors, a scheduler stepped
between calls, the dropout stream, and the refusals naming ROADMAP A10.

The JAX eager GPT needs the C1 answer of `tests/test_torch_gpt_eager.py`
(a scoped ``jax_enable_x64=False`` for `jax.experimental.disable_x64`),
copied here as the `jax_eager` fixture; no file of the JAX package
changes.

Tolerances: float32 losses and parameters within 1e-5 a step, at the
bench's rate of 1e-4 (the key part of each qkv bias has a gradient that is
zero but for rounding, which Adam normalizes into steps of about the rate
in either direction: at 1e-3 that alone moves it 1.3e-5 apart in 7 steps,
eagerly as much as under to_static); under amp O2
bfloat16 the losses within 2e-3 and the float32 master weights within two
AdamW steps of the rate (each update moves a weight by about the rate; a
bfloat16 rounding that differs between the packages can flip one), as
`chip_smoke.py`'s ``train_eager`` gates its parameters. The dropout
stream is held against the port's own eager run, bit for bit: with 64-bit
types on the JAX package draws other masks (ROADMAP C16).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jp
import paddle_tpu.core.autograd as jag
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import metrics as jmetrics

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.ops.random import default_generator

COUNTERS = ("jit.cache_hit", "jit.cache_miss", "jit.compile_count")
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=32,
            hidden_dropout=0.0, attention_dropout=0.0)
LR = 1e-4                # the JAX bench's AdamW rate (bench.py:168)


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


def _bench_program(m, gpt_mod, seed=0, amp=False, lr=LR, **over):
    """`bench_gpt2`'s program on package ``m``: a model, AdamW, O2
    decoration when ``amp``, and the ``to_static`` step."""
    m.seed(seed)
    model = gpt_mod.GPTForCausalLM(gpt_mod.GPTConfig(**dict(TINY, **over)))
    opt = m.optimizer.AdamW(learning_rate=lr, parameters=model.parameters())
    if amp:
        model, opt = m.amp.decorate(model, opt, level="O2", dtype="bfloat16")

    @m.jit.to_static
    def train_step(x, y):
        with m.amp.auto_cast(enable=amp, level="O2", dtype="bfloat16"):
            _, loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, train_step


def _batch(seed=0, b=2, s=16, k=None):
    ids = np.random.RandomState(seed).randint(0, 128, (b, s + 1))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64)
    if k is not None:
        x = np.broadcast_to(x, (k,) + x.shape).copy()
        y = np.broadcast_to(y, (k,) + y.shape).copy()
    return x, y


def _f64(t):
    return np.asarray(t.numpy(), np.float64)


def _counts(metrics):
    return {n: metrics.counter(n).value for n in COUNTERS}


def _delta(before, metrics):
    now = _counts(metrics)
    return {n: now[n] - before[n] for n in COUNTERS}


def _master_err(topt, jopt, tmodel, jmodel):
    """Largest difference of the float32 master weights, by name."""
    tparams = dict(tmodel.named_parameters())
    jparams = dict(jmodel.named_parameters())
    err = 0.0
    for name, p in tparams.items():
        tm = topt._master_weights[id(p)]
        jm = jopt._master_weights[id(jparams[name])]
        err = max(err, float(np.abs(tm.double().numpy()
                                    - np.asarray(jm._data, np.float64)).max()))
    return err


def _param_err(tmodel, jmodel):
    js = jmodel.state_dict()
    return max(float(np.abs(_f64(v) - _f64(js[k])).max())
               for k, v in tmodel.state_dict().items())


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "o2_bf16"])
def test_bench_program_matches_jax(jax_eager, amp):
    """3 ``to_static`` steps, then ``multi_steps(4)``, from one seed: the
    losses a step, and the parameters after."""
    progs = {m: _bench_program(m, g, amp=amp)
             for m, g in ((tp, tgpt), (jp, jgpt))}
    x, y = _batch()
    losses = {m: [float(progs[m][2](m.to_tensor(x), m.to_tensor(y)))
                  for _ in range(3)] for m in (tp, jp)}
    xk, yk = _batch(k=4)
    for m in (tp, jp):
        ks = progs[m][2].multi_steps(4)(m.to_tensor(xk), m.to_tensor(yk))
        assert ks.shape == [4]
        losses[m] += list(np.asarray(ks.numpy(), np.float64))
    tol = 2e-3 if amp else 1e-5
    diffs = np.abs(np.subtract(losses[tp], losses[jp]))
    assert diffs.max() <= tol, (losses[tp], losses[jp])
    assert losses[tp][-1] < losses[tp][0]
    tmodel, topt, _ = progs[tp]
    jmodel, jopt, _ = progs[jp]
    if amp:
        assert all(p.dtype == torch.bfloat16 for p in tmodel.parameters())
        assert _master_err(topt, jopt, tmodel, jmodel) <= 2 * 7 * LR
    else:
        assert _param_err(tmodel, jmodel) <= 1e-5


def test_counter_deltas_equal_jax(jax_eager):
    """The same calls on both packages move ``jit.cache_hit``,
    ``cache_miss`` and ``compile_count`` alike: a repeated signature, a new
    batch shape, a grad-accumulation step whose ``.grad`` presence
    changes between calls, and ``multi_steps``."""
    deltas = {}
    for m, g in ((tp, tgpt), (jp, jgpt)):
        metrics = tmetrics if m is tp else jmetrics
        before = _counts(metrics)
        model, opt, step = _bench_program(m, g)

        @m.jit.to_static
        def accumulate(x, y):
            _, loss = model(x, labels=y)
            loss.backward()
            return loss

        x, y = _batch()
        x2, y2 = _batch(1, b=3, s=8)
        for a, b in ((x, y), (x, y), (x2, y2), (x, y)):
            step(m.to_tensor(a), m.to_tensor(b))
        for _ in range(3):
            accumulate(m.to_tensor(x), m.to_tensor(y))
        opt.step()
        opt.clear_grad()
        xk, yk = _batch(k=2)
        ks = step.multi_steps(2)
        for _ in range(2):
            ks(m.to_tensor(xk), m.to_tensor(yk))
        deltas[m] = _delta(before, metrics)
    assert deltas[tp] == deltas[jp], deltas
    assert deltas[tp]["jit.cache_miss"] >= 4


def test_decorated_layer_forward(jax_eager):
    """``to_static(layer)``: the Layer's forward becomes static; its
    logits equal the eager forward's and the JAX static Layer's."""
    logits = {}
    for m, g in ((tp, tgpt), (jp, jgpt)):
        m.seed(3)
        model = g.GPTForCausalLM(g.GPTConfig(**TINY))
        model.eval()
        x, _ = _batch(3)
        eager = model(m.to_tensor(x))
        static = m.jit.to_static(model)
        assert static is model
        outs = [model(m.to_tensor(x)) for _ in range(2)]
        for o in outs:
            assert np.array_equal(o.numpy(), eager.numpy()) or \
                np.abs(_f64(o) - _f64(eager)).max() <= 1e-6
        logits[m] = outs[-1]
    assert np.abs(_f64(logits[tp]) - _f64(logits[jp])).max() <= 1e-5


def test_multi_steps_errors_match_jax():
    for m in (tp, jp):
        with pytest.raises(ValueError, match=r"multi_steps k must be >= 1, "
                                             r"got 0"):
            m.jit.to_static(lambda x: x * 2).multi_steps(0)
    texts = {}
    for m in (tp, jp):
        ks = m.jit.to_static(lambda x: x * 2).multi_steps(3)
        with pytest.raises(ValueError) as e:
            ks(m.to_tensor(np.zeros((2, 4), np.float32)))
        texts[m] = str(e.value)
    assert texts[tp] == texts[jp]
    assert "leading axis of size 3" in texts[tp]


def test_multi_steps_refuses_a_step_that_leaves_grads():
    """A step that turns absent gradients into present ones cannot run k
    times a call (the JAX package's scan-carry TypeError)."""
    for m in (tp, jp):
        w = m.to_tensor(np.ones(4, np.float32), stop_gradient=False)

        @m.jit.to_static
        def micro(x):
            loss = (w * x).sum()
            loss.backward()
            return loss

        with pytest.raises(TypeError, match="changes which tensors carry "
                                            "a .grad"):
            micro.multi_steps(2)(m.to_tensor(np.ones((2, 4), np.float32)))


def test_scheduler_between_calls_reaches_the_next_step(jax_eager):
    """A StepDecay stepped between calls changes the rate the next call
    uses, in both packages alike (losses within 1e-5, parameters too)."""
    x, y = _batch(5)
    losses, models = {}, {}
    for m, g in ((tp, tgpt), (jp, jgpt)):
        sched = m.optimizer.lr.StepDecay(learning_rate=1e-3, step_size=1,
                                         gamma=0.1)
        model, opt, step = _bench_program(m, g, lr=sched)
        out = []
        for _ in range(4):
            out.append(float(step(m.to_tensor(x), m.to_tensor(y))))
            sched.step()
        losses[m], models[m] = out, model
    assert np.abs(np.subtract(losses[tp], losses[jp])).max() <= 1e-5
    assert _param_err(models[tp], models[jp]) <= 1e-5
    # a frozen rate would keep the first step's 1e-3: the drops shrink
    d = np.diff(losses[tp])
    assert abs(d[-1]) < abs(d[0])


def test_dropout_stream_equals_the_eager_run():
    """With hidden dropout on, 3 static steps equal 3 eager steps from the
    same seed bit for bit, consecutive calls draw other masks, and the key
    chain ends where the eager run's does."""
    x, y = _batch(7)
    runs = {}
    for static in (False, True):
        tp.seed(11)
        model = tgpt.GPTForCausalLM(tgpt.GPTConfig(
            **dict(TINY, hidden_dropout=0.1)))
        opt = tp.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters())

        def step(a, b):
            _, loss = model(a, labels=b)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        fn = tp.jit.to_static(step) if static else step
        losses = [fn(tp.to_tensor(x), tp.to_tensor(y)).numpy()
                  for _ in range(3)]
        runs[static] = (losses, tp.get_rng_state()[0].numpy(),
                        {k: v.numpy() for k, v in model.state_dict().items()})
    (el, ek, ep), (sl, sk, sp) = runs[False], runs[True]
    assert [a.tobytes() for a in el] == [a.tobytes() for a in sl]
    assert np.array_equal(ek, sk)
    assert all(np.array_equal(ep[k], sp[k]) for k in ep)

    @tp.jit.to_static
    def drop(a):
        return tp.nn.functional.dropout(a, p=0.5)

    tp.seed(2)
    ones = tp.to_tensor(np.ones((4, 64), np.float32))
    masks = [drop(ones).numpy() for _ in range(3)]
    assert not np.array_equal(masks[0], masks[1])
    assert not np.array_equal(masks[1], masks[2])
    tp.seed(2)
    eager = [tp.nn.functional.dropout(ones, p=0.5).numpy()
             for _ in range(3)]
    assert all(np.array_equal(a, b) for a, b in zip(masks, eager))


def test_state_rebound_between_calls_reaches_the_step():
    """``paddle.seed`` and ``set_lr`` between calls reach the next call
    (every slot rebound since is copied into the storage the step
    reads)."""
    lin = tp.nn.Linear(4, 4)
    opt = tp.optimizer.SGD(learning_rate=0.5, parameters=lin.parameters())

    @tp.jit.to_static
    def step(a):
        loss = tp.nn.functional.dropout(lin(a), p=0.5).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    a = tp.to_tensor(np.ones((2, 4), np.float32))
    for _ in range(3):
        step(a)
    tp.seed(5)
    tp.nn.functional.dropout(a, p=0.5)
    after_one_draw = tp.get_rng_state()[0].numpy()
    tp.seed(5)
    opt.set_lr(0.0)
    w0 = lin.weight.numpy().copy()
    step(a)
    assert np.array_equal(tp.get_rng_state()[0].numpy(), after_one_draw)
    assert np.array_equal(lin.weight.numpy(), w0)


def test_refusals_name_a10():
    for name in ("save", "load", "cond", "while_loop", "ifelse",
                 "whileloop", "convert_to_static"):
        with pytest.raises(NotImplementedError, match="A10"):
            getattr(tp.jit, name)(None)
    with pytest.raises(NotImplementedError, match="A10"):
        tp.jit.TranslatedLayer()

    @tp.jit.to_static
    def branchy(a):
        if a.sum() > 0:
            return a * 2
        return a

    with pytest.raises(tp.jit.DataDependentControlFlowError, match="A10"):
        branchy(tp.to_tensor(np.ones(3, np.float32)))

    @tp.jit.to_static
    def indexy(a):
        return [1, 2, 3][a.sum().astype("int64")]

    with pytest.raises(tp.jit.DataDependentIndexError):
        indexy(tp.to_tensor(np.ones(1, np.float32)))


def test_discovery_finds_the_step_state():
    """The hooks find a step's state: every parameter (with its ``.grad``
    presence), the optimizer's rate and step tensors, each accumulator and
    master copy under O2, and the key chain; the arguments and the step's
    temporaries are not state. On the card the graph reads and writes
    exactly these slots, so one missed here would replay a stale value."""
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(
        **dict(TINY, hidden_dropout=0.1)))
    opt = tp.optimizer.AdamW(learning_rate=LR, parameters=model.parameters())
    model, opt = tp.amp.decorate(model, opt, level="O2", dtype="bfloat16")

    @tp.jit.to_static
    def step(a, b):
        with tp.amp.auto_cast(level="O2", dtype="bfloat16"):
            _, loss = model(a, labels=b)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    x, y = (tp.to_tensor(a) for a in _batch(9))
    for _ in range(2):
        step(x, y)
    prog = step.concrete_program(x, y)
    held = {(id(h), k) for h, k, _ in prog.slots.values()}
    params = model.parameters()
    assert {(id(p), "_data") for p in params} <= held
    assert (id(opt._step_tensor), "_data") in held
    assert (id(opt._lr_tensor), "_data") in held
    gen = default_generator()
    assert (id(gen), "_key") in held
    for name in ("moment1", "moment2"):
        store = opt._accumulators[name]
        assert {(id(store), id(p)) for p in params} <= held
    assert {(id(opt._master_weights), id(p)) for p in params} <= held
    assert (id(x), "_data") not in held and (id(y), "_data") not in held
    assert [id(t) for t in prog.leaves] == [id(p) for p in params]
    assert prog.grad_mask == (False,) * len(params)
    steps = float(opt._step_tensor)
    step(x, y)
    assert float(opt._step_tensor) == steps + 1
