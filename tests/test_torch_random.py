"""The port's Paddle seed stream (`paddle_tpu_torch/ops/random.py` over
`kernels/prng.py`) held against the JAX package's, on the CPU: after one
``paddle.seed`` the draws of ``rand``, ``randint``, ``bernoulli``,
``randperm``, ``uniform`` and the dropout masks are bit-equal, ``randn``
/ ``normal`` within 1e-6 of max(1, |value|) (erfinv is the one function
computed differently), the generator state words equal, and the
initializers' draws equal (within 1e-6 where they pass through erfinv).

The JAX package runs with 64-bit types on, so its default int is int64
and a Python ``p`` draws float64 uniforms; both are compared as such. Its
dropout masks are compared with 64-bit types off, as its train step
traces (ROADMAP C16)."""
import contextlib

import numpy as np
import pytest

import jax

import paddle_tpu as jp
from paddle_tpu.nn import initializer as JI

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.nn import initializer as TI


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


def _draw(m, fn, seed=7, times=2):
    m.seed(seed)
    return [np.asarray(fn(m).numpy()) for _ in range(times)]


EXACT = {
    "rand": lambda m: m.rand([3, 5]),
    "rand_f64": lambda m: m.rand([4], dtype="float64"),
    "uniform": lambda m: m.uniform([6], min=-2.0, max=3.0),
    "randint": lambda m: m.randint(3, 1000, [8]),
    "randint_int32": lambda m: m.randint(-5, 77, [8], dtype="int32"),
    "randperm": lambda m: m.randperm(20),
    "bernoulli": lambda m: m.bernoulli(m.full([10], 0.3)),
    "bernoulli_": lambda m: m.zeros([10]).bernoulli_(0.4),
    "shuffle": lambda m: m.shuffle(m.arange(12).reshape([4, 3])),
    "randint_like": lambda m: m.randint_like(m.zeros([5], dtype="int64"),
                                             0, 9),
}


@pytest.mark.parametrize("name", list(EXACT))
def test_draws_are_bit_equal_to_jax(name):
    got, want = _draw(tp, EXACT[name]), _draw(jp, EXACT[name])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1]) or got[0].size == 1


CLOSE = {
    "randn": lambda m: m.randn([4, 8]),
    "normal": lambda m: m.normal(1.0, 2.0, [16]),
    "normal_tensor": lambda m: m.normal(m.ones([5]), m.full([5], 0.5)),
    "standard_normal_f64": lambda m: m.standard_normal([6], "float64"),
    "normal_": lambda m: m.zeros([8]).normal_(0.5, 3.0),
    "exponential_": lambda m: m.zeros([8]).exponential_(2.0),
    "gumbel_softmax": lambda m: m.nn.functional.gumbel_softmax(
        m.to_tensor(np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4))),
    "multinomial": lambda m: m.multinomial(m.to_tensor(np.array(
        [[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)), 2),
    "multinomial_replace": lambda m: m.multinomial(m.to_tensor(np.array(
        [0.1, 0.2, 0.3, 0.4], np.float32)), 6, replacement=True),
}


@pytest.mark.parametrize("name", list(CLOSE))
def test_draws_match_jax(name):
    for g, w in zip(_draw(tp, CLOSE[name]), _draw(jp, CLOSE[name])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))


def test_rng_state_words_and_restore():
    tp.seed(11)
    jp.seed(11)
    tp.rand([3])
    jp.rand([3])
    ts, js = tp.get_rng_state()[0], jp.get_rng_state()[0]
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                  np.asarray(js.numpy()).astype(np.uint32))
    a = tp.rand([4]).numpy()
    tp.set_rng_state([ts])                # a snapshot: restoring it repeats
    np.testing.assert_array_equal(tp.rand([4]).numpy(), a)
    assert tp.default_generator().initial_seed() == 11


@pytest.mark.parametrize("mode,axis", [("upscale_in_train", None),
                                       ("downscale_in_infer", None),
                                       ("upscale_in_train", [0])])
def test_dropout_masks_equal_jax_without_64_bit_types(mode, axis):
    x = np.random.RandomState(0).rand(6, 16).astype(np.float32) + 0.5
    with _x64_off():
        jp.seed(5)
        j = [jp.nn.functional.dropout(jp.to_tensor(x), 0.3, axis=axis,
                                      mode=mode).numpy() for _ in range(2)]
    tp.seed(5)
    t = [tp.nn.functional.dropout(tp.to_tensor(x), 0.3, axis=axis,
                                  mode=mode).numpy() for _ in range(2)]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(t[0], t[1])


INITS = {
    "Normal": (lambda I: I.Normal(0.5, 0.02), 1e-6),
    "TruncatedNormal": (lambda I: I.TruncatedNormal(0.0, 1.0), 1e-6),
    "Uniform": (lambda I: I.Uniform(-0.3, 0.7), 0.0),
    "XavierUniform": (lambda I: I.XavierUniform(), 0.0),
    "XavierNormal": (lambda I: I.XavierNormal(), 1e-6),
    "KaimingUniform": (lambda I: I.KaimingUniform(), 0.0),
    "KaimingNormal": (lambda I: I.KaimingNormal(), 1e-6),
    "Constant": (lambda I: I.Constant(0.25), 0.0),
}


@pytest.mark.parametrize("name", list(INITS))
def test_initializer_draws_equal_jax(name):
    make, tol = INITS[name]
    tp.seed(9)
    jp.seed(9)
    got = [make(TI)((16, 24), "float32") for _ in range(2)]
    want = [make(JI)((16, 24), np.float32) for _ in range(2)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype.is_floating_point
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
