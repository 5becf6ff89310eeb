"""The threefry-2x32 key chain of `jax.random`, in torch integer ops on any
device: the port's own copy of what the JAX package's sampler and its
training forward call (`jax.random.PRNGKey`, `split`, `bits`, `uniform`,
`bernoulli`, `gumbel`, `categorical`), bit for bit as jax does it with
``jax_threefry_partitionable`` on (the default since jax 0.5) and 64-bit
types on (``paddle_tpu`` turns them on at import, so its seeds are int64).

- A key is two uint32 words. They are carried in int64 tensors and every
  result is masked with ``0xFFFFFFFF``: torch's uint32 lacks shifts and
  wrapping adds on some devices, int64 has both everywhere.
- The fold-like form: ``split(key, n)`` and ``random_bits(key, shape)`` hash
  the hi and lo words of each output's flat index with the key; a split's
  new key ``i`` is the hash pair at counter ``i``, 32 random bits are the
  two hash words xored.
- Keys batch: a key tensor ``[..., 2]`` draws ``[..., *shape]``, each row
  from its own key against counters ``0 .. prod(shape)-1``, which is what a
  `vmap` over per-row keys gives in JAX, in ONE pass.

Nothing here reads a value back to the host, so a step that samples can be
captured whole. These are plain PyTorch ops on both devices: the JAX
package computes them in XLA, outside any Pallas kernel. The training
forward's hidden dropout draws `bernoulli`'s bits inside its own Hopper
kernel on the card (`kernels/dropout.py`); `bernoulli` is its plain
version's mask.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["threefry2x32", "seed_words", "prng_key", "split", "random_bits",
           "uniform", "bernoulli", "gumbel", "categorical"]

M32 = 0xFFFFFFFF
# the two rotation schedules, alternating every 4 rounds (prng.py:893)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000          # 1.0f: exponent of [1, 2), mantissa 0
_F32_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 words held in int64 tensors
    (broadcasting): key ``(k0, k1)``, counters ``(x0, x1)`` -> the two hash
    words, each in ``[0, 2**32)``.

    Only the right shift of a rotation reads above bit 31, so ``x1`` is
    masked after every round and ``x0`` (whose growth stays far below 2**63)
    only at the end: the low 32 bits are those of the uint32 arithmetic."""
    k2 = k0 ^ k1 ^ _KS_PARITY
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            y = x1 << r
            x1 = ((y | (y >> 32)) ^ x0) & M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & M32
    return x0 & M32, x1


def seed_words(seed: int) -> np.ndarray:
    """The two uint32 words of ``jax.random.PRNGKey(seed)``, on the host:
    the int64 seed's high and low halves (two's complement, so -1 gives
    both words 0xFFFFFFFF)."""
    seed = int(seed)
    return np.array([(seed >> 32) & M32, seed & M32], np.uint32)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a ``[2]`` int64 key tensor."""
    return torch.from_numpy(seed_words(seed).astype(np.int64)).to(device)


def _counters(shape, device):
    """The hi and lo words of each element's flat index in ``shape``."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & M32


def _hash(key, shape):
    """Both hash words for counters over ``shape``: key ``[..., 2]`` ->
    two ``[..., *shape]`` tensors."""
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    k0 = key[..., 0].reshape(*lead, *pad)
    k1 = key[..., 1].reshape(*lead, *pad)
    hi, lo = _counters(tuple(shape), key.device)
    return threefry2x32(k0, k1, hi, lo)


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split`` (fold-like form): key ``[..., 2]`` -> ``[...,
    *shape, 2]`` new keys, ``shape`` being ``(num,)`` for an int ``num``
    and ``num`` itself for a tuple (``split(key, (nl, 2))``)."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    b0, b1 = _hash(key, shape)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: key ``[..., 2]`` -> ``[..., *shape]``
    int64 holding uint32 values, the two hash words xored."""
    b0, b1 = _hash(key, tuple(shape))
    return b0 ^ b1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled to [minval, maxval) and floored at
    minval (random.py:435).

    XLA fuses the scale and shift into one multiply-add rounded once, so
    they run in float64 here (the product of two float32 values is exact
    there) and round to float32 at the end. For the sampler's [tiny, 1)
    nothing rounds at all. The bounds stay Python scalars: a tensor copied
    to the card would wait for its stream."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
    f = f - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    y = (f.double() * float(span) + float(lo)).float()
    return y.clamp_min(float(lo))


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` in mode "low" with a float32 ``p`` (64-bit
    types off, as the JAX train step traces): ``uniform(key, shape) <
    float32(p)``, a bool tensor ``[..., *shape]``."""
    return uniform(key, shape) < float(np.float32(p))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low": ``-log(-log(u))`` with
    ``u`` uniform on [tiny, 1)."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: argmax (the first
    maximum) of ``logits + gumbel``. The key's batch dims lead ``logits``'
    dims: key ``[2]`` draws all of ``logits`` [..., V] from one key, keys
    ``[B, 2]`` draw each ``logits[b]`` from its own key."""
    g = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(g + logits, dim=-1)
