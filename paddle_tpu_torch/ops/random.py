"""Random ops and the global generator (counterpart of
`paddle_tpu/ops/random.py`).

The generator's state is a threefry key (`kernels/prng.py`), two uint32
words held in an int64 tensor on the host. ``seed(s)`` sets it to
``PRNGKey(s)``; every draw splits it, keeps the first half and draws from
the second, as the JAX package's ``Generator.next_key`` does, so
``seed`` followed by ``rand`` / ``randint`` / ``bernoulli`` / ``randperm``
/ dropout masks gives the JAX package's bits, and ``randn`` / ``normal``
its values within an ulp of erfinv. The drawn key moves to the device the
draw lands on. ``poisson`` is the one draw whose algorithm differs from
the JAX package's (inversion of the CDF on the stream's uniforms, not
jax's rejection sampler).
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core import tensor as tensor_mod
from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.ops.common import ensure_tensor

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state", "rand", "randn", "standard_normal", "normal",
           "uniform", "uniform_", "normal_", "randint", "randint_like",
           "randperm", "shuffle", "bernoulli", "bernoulli_", "poisson",
           "multinomial", "exponential_", "gumbel_softmax"]


class Generator:
    """The stateful key chain (``paddle.framework.Generator``)."""

    def __init__(self, seed=0):
        self._seed = int(seed)
        self._key = prng.prng_key(self._seed)

    def manual_seed(self, seed):
        self._seed = int(seed)
        self._key = prng.prng_key(self._seed)
        return self

    def initial_seed(self):
        return self._seed

    def get_state(self):
        """A copy of the key: two uint32 words in an int64 [2] tensor."""
        return Tensor(self._key.clone(), _internal=True)

    def set_state(self, state):
        k = state._data if isinstance(state, Tensor) else \
            torch.as_tensor(np.asarray(state).astype(np.int64))
        self._key = k.detach().to("cpu", torch.int64).clone()

    def next_key(self, device=None) -> torch.Tensor:
        """Split the state; keep the first half, return the second (a [2]
        int64 key) on ``device`` (the host when None). The split runs
        where the state lives: the host, or the card once a `to_static`
        step there has moved it (`move_to`), so that a captured graph
        splits it in place on every replay."""
        tensor_mod.note_write(self, "_key")
        k = prng.split(self._key)
        self._key = k[0]
        sub = k[1]
        return sub if device is None else sub.to(device)

    def move_to(self, device):
        """Keep the state on ``device`` from now on (the same two words:
        the chain's draws do not depend on where it is split)."""
        device = torch.device(device)
        if self._key.device != device:
            self._key = self._key.to(device)


_default_generator = Generator(np.random.randint(0, 2**31 - 1))


def default_generator() -> Generator:
    return _default_generator


def seed(value):
    """Set the global seed (``paddle.seed``)."""
    _default_generator.manual_seed(value)
    return _default_generator


def get_rng_state():
    return [_default_generator.get_state()]


def set_rng_state(state_list):
    _default_generator.set_state(state_list[0])


def _float_dtype(dtype):
    return dtype_mod.convert_dtype(dtype) if dtype is not None \
        else dtype_mod.get_default_dtype()


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _key(device=None):
    return _default_generator.next_key(device or
                                       device_mod.current_device())


def _new(t):
    return Tensor(t, _internal=True)


def rand(shape, dtype=None, name=None):
    return _new(prng.uniform(_key(), _shape(shape),
                             dtype=_float_dtype(dtype)))


def randn(shape, dtype=None, name=None):
    return _new(prng.normal(_key(), _shape(shape), _float_dtype(dtype)))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None):
    dt = dtype_mod.get_default_dtype()
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        ts = [t for t in (mean, std) if isinstance(t, Tensor)]
        shp = _shape(shape) if shape is not None else tuple(ts[0].shape)
        key = _key(ts[0]._data.device)

        def prim(*arrs):
            it = iter(arrs)
            mm = next(it) if isinstance(mean, Tensor) else mean
            ss = next(it) if isinstance(std, Tensor) else std
            return mm + ss * prng.normal(key, shp, dt)

        return apply(prim, *ts, op_name="normal")
    shp = _shape(shape) if shape is not None else ()
    return _new(mean + std * prng.normal(_key(), shp, dt))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    key = _key() if seed == 0 else \
        prng.prng_key(seed, device_mod.current_device())
    lo = min.item() if isinstance(min, Tensor) else min
    hi = max.item() if isinstance(max, Tensor) else max
    return _new(prng.uniform(key, _shape(shape), lo, hi, _float_dtype(dtype)))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    x._write(uniform(x.shape, dtype=x.dtype, min=min, max=max,
                     seed=seed)._data.to(x._data.device))
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    key = _key(x._data.device)
    x._write(mean + std * prng.normal(key, tuple(x.shape), x.dtype))
    return x


def _int_width(d):
    return torch.iinfo(d).bits


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    d = dtype_mod.convert_dtype(dtype)
    out = prng.randint(_key(), _shape(shape), int(low), int(high),
                       _int_width(d))
    return _new(out.to(d))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = ensure_tensor(x)
    return randint(low, high, tuple(x.shape),
                   dtype if dtype is not None else x.dtype)


def randperm(n, dtype="int64", name=None):
    return _new(prng.permutation(_key(), int(n)).to(
        dtype_mod.convert_dtype(dtype)))


def shuffle(x, axis=0):
    x = ensure_tensor(x)
    key = _key(x._data.device)
    return apply(lambda a: torch.index_select(
        a, axis, prng.permutation(key, a.shape[axis])), x, op_name="shuffle")


def bernoulli(x, name=None):
    """A draw of 0 or 1 per element with probability ``x``, in x's dtype."""
    x = ensure_tensor(x)
    key = _key(x._data.device)
    return apply(lambda a: (prng.uniform(key, a.shape, dtype=a.dtype) < a)
                 .to(a.dtype), x, op_name="bernoulli")


def bernoulli_(x, p=0.5, name=None):
    """Fill x with 0 / 1 draws of probability ``p`` (a Python float, drawn
    against float64 uniforms as the JAX package's 64-bit types do)."""
    key = _key(x._data.device)
    x._write(prng.bernoulli(key, p, tuple(x.shape), torch.float64)
             .to(x.dtype))
    return x


def poisson(x, name=None):
    """Poisson draws of rate ``x`` by inverting the CDF on uniforms of the
    global stream (reproducible under ``paddle.seed``; the JAX package's
    rejection sampler draws other bits)."""
    x = ensure_tensor(x)
    key = _key(x._data.device)

    def prim(a):
        lam = a.double()
        u = prng.uniform(key, a.shape, dtype=torch.float64)
        k = torch.zeros_like(lam)
        p = torch.exp(-lam)
        cdf = p.clone()
        limit = int(max(20.0, float(lam.max()) * 4 + 20)) if a.numel() else 0
        for i in range(1, limit):
            more = u > cdf
            if not bool(more.any()):
                break
            k = torch.where(more, k + 1, k)
            p = p * lam / i
            cdf = cdf + p
        return k.to(a.dtype)

    return apply(prim, x, op_name="poisson")


def multinomial(x, num_samples=1, replacement=False, name=None):
    """``jax.random.choice`` over the last axis with probabilities ``x``
    (normalized): with replacement, inverse-CDF draws; without, the top
    ``num_samples`` of Gumbel-perturbed log-probabilities. Rows of a 2-D
    ``x`` draw from the key's split, one key a row."""
    x = ensure_tensor(x)
    key = _key(x._data.device)

    def one(k, pr):
        if replacement:
            cum = torch.cumsum(pr, 0)
            r = cum[-1] * (1 - prng.uniform(k, (num_samples,),
                                            dtype=pr.dtype))
            return torch.searchsorted(cum, r)
        g = prng.gumbel(k, (pr.shape[0],), pr.dtype) + torch.log(pr)
        return torch.topk(g, num_samples).indices

    def prim(a):
        p = a / torch.sum(a, dim=-1, keepdim=True)
        if a.dim() == 1:
            return one(key, p).to(torch.int64)
        ks = prng.split(key, a.shape[0])
        return torch.stack([one(ks[i], p[i]) for i in range(a.shape[0])]
                           ).to(torch.int64)

    return apply(prim, x, op_name="multinomial")


def exponential_(x, lam=1.0, name=None):
    key = _key(x._data.device)
    x._write(prng.exponential(key, tuple(x.shape), x.dtype) / lam)
    return x


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    x = ensure_tensor(x)
    key = _key(x._data.device)

    def prim(a):
        g = prng.gumbel(key, a.shape, a.dtype)
        y = torch.softmax((a + g) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            hard_y = torch.zeros_like(y).scatter(axis, idx, 1.0)
            y = hard_y + y - y.detach()
        return y

    return apply(prim, x, op_name="gumbel_softmax")

