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
           "uniform", "bernoulli", "gumbel", "categorical", "normal",
           "truncated_normal", "randint", "permutation", "exponential"]

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


def random_bits(key: torch.Tensor, shape, width: int = 32) -> torch.Tensor:
    """``jax.random.bits``: key ``[..., 2]`` -> ``[..., *shape]`` int64.
    At 32 bits (the default) the uint32 values, the two hash words xored;
    at 8 and 16 the low bits of that xor; at 64 the first word above the
    second, as a two's-complement int64."""
    b0, b1 = _hash(key, tuple(shape))
    if width == 64:
        return (b0 << 32) | b1
    x = b0 ^ b1
    return x if width == 32 else x & ((1 << width) - 1)


# (bits, mantissa bits, int dtype of the same width, the bits of 1.0) per
# float dtype
_FLOAT_LAYOUT = {torch.float16: (16, 10, torch.int16, 0x3C00),
                 torch.bfloat16: (16, 7, torch.int16, 0x3F80),
                 torch.float32: (32, 23, torch.int32, _F32_ONE_BITS),
                 torch.float64: (64, 52, torch.int64, 0x3FF0000000000000)}


def _unit_floats(key, shape, dtype):
    """The floats in [0, 1) of ``jax.random.uniform`` before its scaling:
    the top mantissa bits of the random bits under the exponent of 1.0,
    minus 1. Dtypes with fewer than 8 mantissa bits draw 8 bits."""
    nbits, nmant, idt, one = _FLOAT_LAYOUT[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits)
    if nbits == 64:
        # a logical right shift of the int64 pattern
        mant = (bits >> 12) & ((1 << 52) - 1)
    else:
        mant = bits >> (rng_bits - nmant)
    return (mant | one).to(idt).view(dtype) - 1.0


_NP_FLOAT = {torch.float16: np.float16, torch.float32: np.float32,
             torch.float64: np.float64}


def _round_to(x, dtype) -> float:
    """``x`` rounded to ``dtype``, on the host (numpy; bfloat16 through a
    host tensor), as a Python float."""
    if dtype in _NP_FLOAT:
        return float(_NP_FLOAT[dtype](x))
    return float(torch.tensor(float(x), dtype=dtype).float())


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """``jax.random.uniform``: the top mantissa bits as the mantissa of a
    float in [1, 2), minus 1, scaled to [minval, maxval) and floored at
    minval (random.py:435). The bounds round to ``dtype`` first.

    XLA fuses the scale and shift into one multiply-add rounded once, so
    below float64 they run in float64 here (the product of two float32
    values is exact there) and round to ``dtype`` at the end. For the
    sampler's [tiny, 1) nothing rounds at all. The bounds stay Python
    scalars: a tensor copied to the card would wait for its stream."""
    f = _unit_floats(key, tuple(shape), dtype)
    lo = _round_to(minval, dtype)
    span = _round_to(_round_to(maxval, dtype) - lo, dtype)
    if dtype == torch.float64:
        y = f * span + lo
    else:
        y = (f.double() * span + lo).to(dtype)
    return y.clamp_min(lo)


def normal(key: torch.Tensor, shape, dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
    [nextafter(-1, 0), 1) in ``dtype``."""
    lo = -1.0 + torch.finfo(dtype).eps / 2       # nextafter(-1, 0)
    u = uniform(key, shape, lo, 1.0, dtype)
    return erfinv(u) * _sqrt2(dtype)


# Giles' single-precision erfinv, the polynomial XLA evaluates for float32
# (torch's own erfinv differs by up to 1.5e-5 near +-1)
_ERFINV_W5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv``: XLA's polynomial in float32 (float16 and bfloat16
    computed in float32), torch's erfinv in float64."""
    if x.dtype == torch.float64:
        return torch.special.erfinv(x)
    t = x.float()
    w = -torch.log1p(-t * t)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_W5, _ERFINV_W_GT5):
        c = torch.where(lt, torch.full((), a, device=x.device),
                        torch.full((), b, device=x.device))
        p = c if p is None else c + p * w
    out = torch.where(t.abs() == 1.0, t * float("inf"), p * t)
    return out.to(x.dtype)


def _sqrt2(dtype):
    return torch.tensor(math.sqrt(2.0), dtype=dtype).item()


def truncated_normal(key: torch.Tensor, lower: float, upper: float, shape,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.truncated_normal``: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform between ``erf(lower / sqrt(2))`` and ``erf(upper / sqrt(2))``,
    clipped just inside (lower, upper)."""
    s2 = torch.tensor(math.sqrt(2.0), dtype=dtype)
    lo = torch.tensor(float(lower), dtype=dtype)
    hi = torch.tensor(float(upper), dtype=dtype)
    a = torch.special.erf(lo / s2).item()
    b = torch.special.erf(hi / s2).item()
    u = uniform(key, shape, a, b, dtype)
    out = erfinv(u) * s2.item()
    inf = torch.tensor(float("inf"), dtype=dtype)
    return out.clamp(torch.nextafter(lo, inf).item(),
                     torch.nextafter(hi, -inf).item())


def _rem_u64(bits, span):
    """``uint64(bits) % span`` for an int64 bit pattern and 0 < span <
    2**31, from its two 32-bit halves."""
    hi = (bits >> 32) & M32
    lo = bits & M32
    return ((hi % span) * ((1 << 32) % span) + lo % span) % span


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            width: int = 64) -> torch.Tensor:
    """``jax.random.randint`` for a ``width``-bit signed integer dtype (64:
    int64, as the JAX package draws with 64-bit types on): two draws of
    random bits from the key's split, folded into [minval, maxval) with
    the multiplier ``2**width % span``, as random.py's ``_randint``.
    Returns int64; spans of 2**31 or more raise NotImplementedError."""
    span = int(maxval) - int(minval)
    if span <= 0:
        span = 1
    if span >= 1 << 31:
        raise NotImplementedError(
            f"randint over a span of {span} (>= 2**31) is not ported")
    k = split(key)
    hb = random_bits(k[..., 0, :], shape, width)
    lb = random_bits(k[..., 1, :], shape, width)
    mult = pow(2, width // 2, span)
    mult = (mult * mult) % span
    if width == 64:
        hr, lr = _rem_u64(hb, span), _rem_u64(lb, span)
    else:
        hr, lr = hb % span, lb % span
    off = (hr * mult + lr) % span
    return int(minval) + off


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` sorted (stably) by
    fresh 32-bit random keys, in as many rounds as its heuristic asks."""
    x = torch.arange(n, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    for _ in range(rounds):
        k = split(key)
        key, sub = k[0], k[1]
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def exponential(key: torch.Tensor, shape, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(key, shape, dtype=dtype))


def bernoulli(key: torch.Tensor, p: float, shape,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.bernoulli`` in mode "low" with ``p`` of ``dtype``
    (float32 unless asked: a Python ``p`` with 64-bit types off, as the JAX
    train step traces): ``uniform(key, shape) < p`` in that dtype, a bool
    tensor ``[..., *shape]``."""
    return uniform(key, shape, dtype=dtype) < _round_to(p, dtype)


def gumbel(key: torch.Tensor, shape, dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """``jax.random.gumbel``, mode "low": ``-log(-log(u))`` with ``u``
    uniform on [tiny, 1) (float32 unless ``dtype``)."""
    tiny = _F32_TINY if dtype == torch.float32 else torch.finfo(dtype).tiny
    u = uniform(key, shape, minval=tiny, maxval=1.0, dtype=dtype)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: argmax (the first
    maximum) of ``logits + gumbel``. The key's batch dims lead ``logits``'
    dims: key ``[2]`` draws all of ``logits`` [..., V] from one key, keys
    ``[B, 2]`` draw each ``logits[b]`` from its own key."""
    g = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(g + logits, dim=-1)
