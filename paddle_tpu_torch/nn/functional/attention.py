"""`scaled_dot_product_attention` (counterpart of
`paddle_tpu/nn/functional/attention.py:19-37, 90-122`), on the Paddle
layout [B, S, H, D].

With no mask and no dropout it runs the port's flash-attention op
(`kernels/flash_attention.py::flash_attention_fn`: the registry op
``flash_attention``, whose CUDA arm is the ``flash_fwd`` kernel and, in the
backward, ``flash_dq`` and ``flash_dkv``), as the JAX package sends that
case to its Pallas flash kernel. Otherwise it is the plain softmax
attention of the JAX ``_sdpa_xla``, which the JAX package computes outside
any Pallas kernel: f32 softmax, scores set to -1e30 where a bool mask is
False, an additive mask added otherwise, and in training with
``dropout_p > 0`` the probabilities dropped with a key from the global
generator (``bernoulli(key, 1 - p)`` over [B, H, Sq, Sk]).
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.kernels.flash_attention import (NEG_INF,
                                                      flash_attention_fn)
from paddle_tpu_torch.ops.common import ensure_tensor
from paddle_tpu_torch.ops.random import default_generator

__all__ = ["scaled_dot_product_attention", "sdpa_plain"]


def sdpa_plain(q, k, v, mask, is_causal, scale, dropout_p=0.0, key=None):
    """The JAX ``_sdpa_xla`` on torch tensors: q [B, Sq, H, D], k, v
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
    if dropout_p > 0.0 and key is not None:
        keep = prng.bernoulli(key, 1.0 - dropout_p, probs.shape)
        c = torch.full((), 1.0 - dropout_p, dtype=probs.dtype,
                       device=probs.device)
        probs = torch.where(keep, probs / c, torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 training=True, name=None):
    query, key, value = (ensure_tensor(query), ensure_tensor(key),
                         ensure_tensor(value))
    if attn_mask is None and dropout_p == 0.0:
        return apply(flash_attention_fn(causal=is_causal, scale=scale),
                     query, key, value, op_name="flash_attention")
    ts = [query, key, value]
    has_mask = attn_mask is not None
    if has_mask:
        ts.append(ensure_tensor(attn_mask))
    use_drop = dropout_p > 0.0 and training
    rkey = default_generator().next_key(query._data.device) \
        if use_drop else None

    def prim(q, k, v, *rest):
        return sdpa_plain(q, k, v, rest[0] if rest else None, is_causal,
                          scale, dropout_p if use_drop else 0.0, rkey)

    return apply(prim, *ts, op_name="scaled_dot_product_attention")
