"""`scaled_dot_product_attention` (counterpart of
`paddle_tpu/nn/functional/attention.py:19-37, 90-122`), on the Paddle
layout [B, S, H, D].

With no mask and no dropout it runs the port's flash-attention op
(`kernels/flash_attention.py::flash_attention_fn`: the registry op
``flash_attention``, whose CUDA arm is the ``flash_fwd`` kernel and its
backward pair), as the JAX package sends that case to its Pallas flash
kernel. With a mask it is the plain softmax attention of the JAX
``_sdpa_xla``, which the JAX package computes outside any Pallas kernel:
f32 softmax, scores set to -1e30 where a bool mask is False, an additive
mask added otherwise.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.kernels.flash_attention import (NEG_INF,
                                                      flash_attention_fn)

__all__ = ["scaled_dot_product_attention"]


def _sdpa_plain(q, k, v, mask, is_causal, scale):
    """The JAX ``_sdpa_xla`` without dropout: q [B, Sq, H, D], k, v
    [B, Sk, H, D] -> [B, Sq, H, D]."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * s
    if is_causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(qlen, klen, dtype=torch.bool,
                        device=q.device).tril(klen - qlen)
        logits = logits.masked_fill(~cm, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, NEG_INF)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 training=True, name=None):
    """Attention on [B, S, H, D]. Attention dropout in training (``dropout_p
    > 0``) raises NotImplementedError: its mask keys come from Paddle's
    global seed stream (``paddle.seed``), which is not ported (ROADMAP
    A7); the threefry chain itself is (`kernels/prng.py`)."""
    if attn_mask is None and dropout_p == 0.0:
        return flash_attention_fn(causal=is_causal, scale=scale)(
            query, key, value)
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            f"attention dropout with p={dropout_p} in training: the mask "
            "keys come from Paddle's global seed stream (paddle.seed), "
            "which is not ported (ROADMAP A7); the threefry chain is "
            "(kernels/prng.py). Call .eval() or set the rate to 0")
    return _sdpa_plain(query, key, value, attn_mask, is_causal, scale)
