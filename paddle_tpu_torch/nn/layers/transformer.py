"""`MultiHeadAttention` (counterpart of `paddle_tpu/nn/layers/transformer.py:19-91`).
The encoder and decoder stacks of that module wait for ROADMAP A7."""
from __future__ import annotations

import collections

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers.common import Linear, resolve_device

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(nn.Module):
    """Multi-head attention on [B, S, embed_dim] through
    `nn.functional.scaled_dot_product_attention` ([B, S, H, D]; the flash op
    with no mask and no dropout). A ``Cache`` (from ``gen_cache``) is
    extended by this call's keys and values along the sequence and returned
    beside the output; a ``StaticCache`` is returned as given. Attention
    dropout applies in training only."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device, "MultiHeadAttention")
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=dev, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _split_heads(self, t):
        return t.reshape(t.shape[0], -1, self.num_heads, self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        if cache is not None and isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):
        """An empty ``Cache`` ([B, 0, H, D] keys and values in key's dtype),
        or, with ``type=StaticCache`` (or a ``value`` and no ``type``), a
        ``StaticCache`` of ``key`` as the JAX package builds it: its ``k``
        is q_proj(key) and its ``v`` k_proj(key), split into heads (ROADMAP
        C6). On that arm a ``value`` raises ValueError, as the JAX
        package's truth test ``value or key`` of a tensor does."""
        if type == self.StaticCache or (value is not None and type is None):
            if value is not None:
                raise ValueError(
                    "gen_cache(key, value): the JAX package tests `value or "
                    "key`, and a tensor of more than one element has no "
                    "truth value (ROADMAP C6)")
            q, k, _, _ = self._prepare_qkv(key, key, key)
            return self.StaticCache(q, k)
        empty = key.new_zeros(key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        dropout_p = self.dropout if self.training else 0.0
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             dropout_p=dropout_p,
                                             training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], -1, self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)
