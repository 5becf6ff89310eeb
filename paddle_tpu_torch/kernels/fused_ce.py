"""Fused LM-head + softmax cross-entropy (counterpart of
`paddle_tpu/kernels/fused_ce.py`).

The [N, V] logits are never held whole: the vocab is cut into at most 4
chunks (`_pick_chunks`), each chunk's logits come from bf16-rounded h and w
with float32 results, and the chunks merge into one logsumexp. The
backward recomputes each chunk's logits, rounds dlogits to bf16 and feeds
the two gradient products. Out-of-range labels (the conventional -100
padding, or V) give zero loss and zero gradient.

The products are plain PyTorch matrix products, as the JAX package left
them to XLA, with float32 results from bf16 operands (`_mm_f32`):
`torch.mm(..., out_dtype=torch.float32)` on the card (present in the torch
2.11 of the H100 machine, checked there), which accumulates a bf16 x bf16
product in f32 and returns it unrounded; f32 operands holding the
bf16-rounded values on the CPU, where that overload has no kernel. A plain
bf16 `torch.matmul` would return bf16 and round the logits.
"""
from __future__ import annotations

import torch

__all__ = ["fused_linear_cross_entropy"]


def _pick_chunks(v: int) -> int:
    """Chunk count <= 4 that divides the (padded) vocab, chunks >= 4096."""
    for nc in (4, 3, 2):
        if v % nc == 0 and v // nc >= 4096:
            return nc
    return 1


def _mm_f32(a, b):
    """a @ b of bf16 operands with float32 results (see the module doc)."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _flce_fwd(h, w, labels):
    """Per-row losses [N] f32 and the rows' logsumexp [N] f32."""
    v = w.shape[0]
    nc = _pick_chunks(v)
    vc = v // nc
    ms, ls, picks = [], [], []
    for c in range(nc):
        logits = _mm_f32(h, w[c * vc:(c + 1) * vc].t())     # [N, vc] f32
        m_c = logits.amax(dim=-1)
        ls.append(torch.exp(logits - m_c[:, None]).sum(dim=-1))
        ms.append(m_c)
        idx = labels - c * vc
        in_chunk = (idx >= 0) & (idx < vc)
        got = logits.gather(1, torch.where(in_chunk, idx, 0)[:, None])[:, 0]
        picks.append(torch.where(in_chunk, got, -torch.inf))
    m = ms[0]
    for m_c in ms[1:]:
        m = torch.maximum(m, m_c)
    l = ls[0] * torch.exp(ms[0] - m)
    for m_c, l_c in zip(ms[1:], ls[1:]):
        l = l + l_c * torch.exp(m_c - m)
    picked = picks[0]
    for pk in picks[1:]:
        picked = torch.maximum(picked, pk)
    lse = m + torch.log(l)
    valid = (labels >= 0) & (labels < v)
    return torch.where(valid, lse - picked, 0.0), lse


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels):
        labels = labels.long()
        loss, lse = _flce_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        h, w, labels, lse = ctx.saved_tensors
        v = w.shape[0]
        nc = _pick_chunks(v)
        vc = v // nc
        valid = (labels >= 0) & (labels < v)
        dl = dloss.float() * valid.float()
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dws = []
        cols = torch.arange(vc, device=h.device)
        for c in range(nc):
            w_c = w[c * vc:(c + 1) * vc]
            logits = _mm_f32(h, w_c.t())                      # recompute
            p = torch.exp(logits - lse[:, None])
            idx = labels - c * vc
            onehot = (cols[None, :] == idx[:, None]) & \
                ((idx >= 0) & (idx < vc))[:, None]
            dlogits = ((p - onehot.float()) * dl[:, None]).to(torch.bfloat16)
            dh = dh + _mm_f32(dlogits, w_c)
            dws.append(_mm_f32(dlogits.t(), h))
        dw = torch.cat(dws, dim=0).to(w.dtype)
        return dh.to(h.dtype), dw, None


def fused_linear_cross_entropy(h, w, labels):
    """Per-row losses [N] f32 of softmax(h @ w^T) against ``labels``.

    h [N, H]; w [V, H] (the tied token table); labels [N] int, rows with a
    label outside [0, V) give 0 loss and 0 gradient. Differentiable in h and
    w; the gradients come back in their tensors' dtypes.
    """
    return _FusedLinearCE.apply(h, w, labels)
