"""Blockwise abs-max int8 codec for quantized collectives (counterpart of
`paddle_tpu/quantization/comms.py`, EQuARX-style, arxiv 2506.17615).

`absmax_int8` is the one abs-max quantizer of the port: the KV page writes
reduce the head dim (`kernels/paged_attention.py::quantize_kv`), the
weight leaves reduce the contraction axis (`quantization/serving.py`) and
the comms codec below reduces within blocks. The codec flattens a payload,
splits it into fixed-size blocks (the tail zero-padded), quantizes each
block against its own abs-max and carries one f32 scale per block; the
collective half is `distributed/collective.py::all_reduce(...,
quantized=True)`: quantize, move the int8 blocks and their scales,
dequantize each participant's blocks, reduce in f32, cast back.

Error bound: one quantize/dequantize round trip errs by at most half a
step, ``absmax_block / 254``, per element (`roundtrip_bound`); a SUM over P
participants by at most the sum of their per-block bounds.

Values and scales are the JAX codec's bit for bit on the CPU: the same
operation order in f32 (`absmax_int8`), the same padding and the same
reshapes; on the card within an ulp of a scale (ROADMAP C25).
These are plain PyTorch ops on either device; the JAX codec is plain
``jnp`` too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["QMAX", "DEFAULT_BLOCK", "absmax_int8", "quantize_blockwise",
           "dequantize_blockwise", "quantized_payload_nbytes",
           "roundtrip_bound"]

DEFAULT_BLOCK = 256
QMAX = 127.0


def absmax_int8(x, axis, keepdims=False):
    """``s = max(|x|, axis) / 127`` clamped at 1e-8 (before the divide),
    ``q = clip(round(x / s), -127, 127)``; returns (q int8, s float32).

    The operation order is the JAX one, so values and scales are bit for
    bit JAX's on the CPU: the maximum in f32, one division by 127, one
    division of each value by its scale, and round half to even
    (`torch.round`, like `jnp.round`). Multiplying by ``127 / max``
    instead rounds differently. On the card the division by the host
    scalar 127 is a product with its reciprocal (CUDA's), so a scale can
    sit an ulp off the CPU's (ROADMAP C25).
    """
    f = x.float()
    s = f.abs().amax(dim=axis, keepdim=True).clamp_min(1e-8) / QMAX
    q = torch.round(f / s).clamp(-QMAX, QMAX).to(torch.int8)
    return q, (s if keepdims else s.squeeze(axis))


def quantize_blockwise(x, block_size: int = DEFAULT_BLOCK):
    """Flatten ``x`` and quantize it in blocks of ``block_size``.

    Returns ``(q, scales, meta)``: ``q`` int8 ``[nblocks, block_size]``
    (zero-padded tail), ``scales`` f32 ``[nblocks]`` and ``meta = (shape,
    n, dtype)``, what `dequantize_blockwise` needs to invert. The padding
    cannot grow a block's abs-max and dequantizes to exact zero."""
    shape, dtype = tuple(x.shape), x.dtype
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    nblocks = -(-max(n, 1) // block_size)
    flat = F.pad(flat, (0, nblocks * block_size - n))
    q, scales = absmax_int8(flat.reshape(nblocks, block_size), axis=1)
    return q, scales.float(), (shape, n, dtype)


def dequantize_blockwise(q, scales, meta):
    """Invert `quantize_blockwise`. ``q`` may carry leading batch axes (a
    gathered ``[P, nblocks, block_size]``) when ``scales`` carries the same
    ones: each block is scaled by its own scale."""
    shape, n, dtype = meta
    deq = q.float() * scales[..., None]
    lead = tuple(q.shape[:-2])
    return deq.reshape(lead + (-1,))[..., :n].reshape(lead + tuple(shape)) \
        .to(dtype)


def quantized_payload_nbytes(q, scales) -> int:
    """Wire bytes of the quantized form (int8 values and f32 scales): what
    `collective.bytes` records for a quantized call."""
    return int(q.numel()) * 1 + int(scales.numel()) * 4


def roundtrip_bound(x, block_size: int = DEFAULT_BLOCK):
    """Per element, the worst ``|x - dq(q(x))|`` of one round trip: half a
    quantization step of its block, with ``x``'s shape and dtype."""
    q, scales, meta = quantize_blockwise(x, block_size)
    per_elem = (scales / 2.0)[:, None].expand(q.shape)
    return dequantize_blockwise(per_elem, torch.ones_like(scales), meta)
