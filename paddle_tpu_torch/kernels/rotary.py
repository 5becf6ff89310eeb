"""Fused rotary position embedding of q and k (counterpart of
`paddle_tpu/kernels/pallas/rotary.py::apply_rotary_emb`).

GPT-NeoX half split: with ``x1, x2 = x[..., :D/2], x[..., D/2:]`` the
output is ``[x1 * cos - x2 * sin, x2 * cos + x1 * sin]``, computed in f32
and stored in q's dtype; q and k [B, H, S, D] share one shape and dtype,
cos and sin are [S, D/2].

Forward only, as in the JAX package: its kernel has no ``custom_vjp``, so
the reference cannot take a gradient through it (ROADMAP C4). A call with
any input that requires grad while grad mode is on raises
NotImplementedError instead of inventing a backward.

`kernels/registry.py` op ``fused_rope`` picks the arm per call by q's
device: a CPU tensor takes the plain PyTorch version below, a CUDA tensor
the hand-written kernel `kernels/csrc/rotary.cu` through
`kernels/cuda/rotary.py` (one launch for q and k), and never the plain
version.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.kernels.cuda.rotary import check_rope_args

__all__ = ["apply_rotary_emb"]


def _plain_rope(q, k, cos, sin):
    """(q_rot, k_rot) in q's dtype."""
    c, s = cos.float(), sin.float()
    half = q.shape[-1] // 2

    def rot(x):
        xf = x.float()
        x1, x2 = xf[..., :half], xf[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                         dim=-1).to(q.dtype)

    return rot(q), rot(k)


def apply_rotary_emb(q, k, cos, sin):
    """Rotate q and k [B, H, S, D] by cos, sin [S, D/2] in one pass.
    Returns (q_rot, k_rot)."""
    check_rope_args("apply_rotary_emb", q, k, cos, sin)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, cos, sin)):
        raise NotImplementedError(
            "apply_rotary_emb is forward only: the JAX package's fused rope "
            "has no reverse-mode gradient (ROADMAP C4); call it under "
            "torch.no_grad() or on tensors that do not require grad")
    if registry.dispatch("fused_rope", q) == "cuda":
        from paddle_tpu_torch.kernels.cuda.rotary import rotary
        return rotary(q.contiguous(), k.contiguous(), cos.contiguous(),
                      sin.contiguous())
    return _plain_rope(q, k, cos, sin)
