"""Fused sampling and the speculative accept test (counterpart of
`paddle_tpu/kernels/sampling.py`), dispatched by `kernels/registry.py` as
op ``fused_sampling``.

- Temperature, the top-k mask and the categorical draw run on the logits
  where they lie, with per-slot (temperature, top_k): one step serves every
  request's parameters.
- Each slot carries its own key chain (`kernels/prng.py`): one split per
  SAMPLED token, none for a greedy slot, so a chain reproduces the JAX
  package's `fast_generate` for the same seed bit for bit.
- :func:`accept_drafts` is the one accept test of speculative decode
  (`models/gpt.py::verify_step`, greedy and sampled).

The order is the JAX package's: temperature divides first (a division by
1.0 is exact), the k-th largest tempered logit, read from a full descending
sort at ``clip(top_k - 1, 0, V - 1)``, is the cutoff, masked logits become
-1e30, and a greedy slot (t == 1, k == 0) takes the argmax (first maximum)
of the UNSCALED logits. Each slot draws its Gumbel noise on its own
``[1, V]`` row from its own key, as the JAX `vmap` of `sample_one` does.

The one impl is ``torch``, plain PyTorch ops on either device: the JAX
package's one impl is ``xla``, computed outside any Pallas kernel, so there
is no kernel to port and nothing to fall back from.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import prng, registry

__all__ = ["NEG_INF", "perturbed_logits", "sample_one", "fused_sample",
           "sample_chain", "accept_drafts"]

NEG_INF = -1e30


def perturbed_logits(logits, subkeys, temperatures, top_ks):
    """What a sampled row takes the argmax of: ``[N, V]`` f32 logits
    divided by their row's temperature, masked to -1e30 below the top-k
    cutoff, plus the Gumbel noise of the row's draw key (``[N, 2]``, the
    second half of its split); ``[N]`` f32 temperatures, ``[N]`` int64
    top-ks."""
    v = logits.shape[-1]
    lt = logits / temperatures[:, None]
    desc = torch.sort(lt, dim=-1, descending=True).values
    kth = desc.gather(1, (top_ks - 1).clamp(0, v - 1)[:, None])
    masked = torch.where((top_ks > 0)[:, None] & (lt < kth), NEG_INF, lt)
    return prng.gumbel(subkeys, (v,)) + masked


def _sample_rows(logits, subkeys, temperatures, top_ks):
    """The sampler after the split (arguments as `perturbed_logits`) ->
    ``[N]`` int64 tokens. Greedy rows take the argmax of their unscaled
    logits and ignore their key."""
    sampled = (top_ks > 0) | (temperatures != 1.0)
    cat = perturbed_logits(logits, subkeys, temperatures, top_ks).argmax(-1)
    return torch.where(sampled, cat, logits.argmax(dim=-1))


def _torch_sample_chain(logits, keys, temperatures, top_ks):
    """``[B, W, V]`` logits, one chain per slot through its W positions: the
    splits run in turn (each needs the key before it), the W draws of all
    slots in one ``[B * W, V]`` pass."""
    b, w, v = logits.shape
    top_ks = top_ks.long()
    sampled = ((top_ks > 0) | (temperatures != 1.0))[:, None]
    subs, after, key = [], [], keys
    for _ in range(w):
        split = prng.split(key)                    # [B, 2, 2]
        subs.append(split[:, 1])
        key = torch.where(sampled, split[:, 0], key)
        after.append(key)
    toks = _sample_rows(logits.reshape(b * w, v),
                        torch.stack(subs, 1).reshape(b * w, 2),
                        temperatures.repeat_interleave(w),
                        top_ks.repeat_interleave(w))
    return toks.reshape(b, w), torch.stack(after, 1)


_IMPLS = {"torch": _torch_sample_chain}


def sample_chain(logits, keys, temperatures, top_ks):
    """Each slot samples W positions in a row along its own key chain:
    ``[B, W, V]`` f32 logits, ``[B, 2]`` int64 key words, ``[B]`` f32
    temperatures, ``[B]`` int top-ks -> ``(tokens [B, W] int64, keys after
    each position [B, W, 2])``. Position j draws with the chain advanced j
    times, exactly as W single steps would. Counted as
    ``kernel.dispatch.fused_sampling.*``."""
    impl = registry.dispatch("fused_sampling", logits)
    return _IMPLS[impl](logits, keys, temperatures, top_ks)


def fused_sample(logits, keys, temperatures, top_ks):
    """Batched fused sampler: ``[B, V]`` f32 logits, ``[B, 2]`` int64 key
    words, ``[B]`` f32 temperatures, ``[B]`` int top-ks -> ``(tokens [B]
    int64, new keys [B, 2])``. A sampled slot's key moves one split, a
    greedy slot's stays."""
    toks, after = sample_chain(logits[:, None], keys, temperatures, top_ks)
    return toks[:, 0], after[:, 0]


def sample_one(logits, key, temperature, top_k):
    """One slot: ``[V]`` f32 logits, ``[2]`` key, scalar temperature and
    top_k -> ``(token, new key)``, as :func:`fused_sample` on a batch of
    one."""
    t = torch.full((1,), temperature, dtype=torch.float32,
                   device=logits.device)
    k = torch.full((1,), top_k, dtype=torch.int64, device=logits.device)
    tok, new_key = fused_sample(logits[None], key[None], t, k)
    return tok[0], new_key[0]


def accept_drafts(drafts, out, draft_len, slot_mask):
    """The speculative accept test.

    drafts    : [B, K] drafted tokens (columns past ``draft_len`` are
                padding)
    out       : [B, K+1] the model's own token at every position (column i
                conditions on drafts 1..i)
    draft_len : [B] true drafted tokens per slot
    slot_mask : [B] bool, inactive slots emit 0
    returns   : n_emitted [B] int32 in 0..K+1: the longest draft prefix
                equal to the model's own choices plus ONE corrected token
    """
    b, k = drafts.shape
    if k > 0:
        cols = torch.arange(k, device=drafts.device)
        match = (drafts == out[:, :-1]) & (cols[None] < draft_len[:, None])
        n_acc = torch.cumprod(match.int(), dim=1).sum(dim=1)
    else:
        n_acc = torch.zeros(b, dtype=torch.int64, device=drafts.device)
    return torch.where(slot_mask, n_acc + 1, 0).int()
