"""Flash attention, forward and backward (counterpart of
`paddle_tpu/kernels/pallas/flash_attention.py` and of the op entry
`paddle_tpu/kernels/flash_attention.py::flash_attention_fn`).

Three functions over the kernels' layout [B*H, S, D]:

- forward: out and the row logsumexp ``lse`` (f32), online softmax in f32;
- dq: recomputes the probabilities from ``lse`` and uses
  ``delta = rowsum(dO * O)``;
- dk/dv: the same, per key.

The causal diagonal is aligned bottom-right: query row ``i`` sees key
``j`` when ``j <= i + (Sk - Sq)``. Masked scores are -1e30 and the row sum
is clamped at 1e-30, as in the Pallas kernels. Inputs are float32 or
bfloat16 and are computed in float32; outputs take the inputs' dtype,
``lse`` is float32. (The plain versions also take float64, computed in
float64, for gradient checks.)

`kernels/registry.py` op ``flash_attention`` picks the arm once per forward
call by the tensor's device, and the backward follows it: a CPU tensor
takes the plain PyTorch versions below (written from the JAX math, not
block by block), a CUDA tensor takes the hand-written kernels
`kernels/csrc/flash_{fwd,dq,dkv}.cu` through `kernels/cuda/flash_attention.py`,
forward and backward, and never the plain versions.

Not ported: the JAX op's ``xla``/``dense``/``splash``/``mosaic`` arms and
its autotuner (``splash`` and ``mosaic`` are kernels bundled with jax, not
this repository's); see ROADMAP.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.kernels import registry

__all__ = ["NEG_INF", "flash_attention", "flash_attention_fn"]

NEG_INF = -1e30


def _f(t):
    """t in the compute dtype: float32, or float64 for float64 input (so
    that `torch.autograd.gradcheck` can check the plain math)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _visible(sq, sk, causal, device):
    """[Sq, Sk] bool: which keys each query row sees (bottom-right causal
    diagonal), or None when every key is visible."""
    if not causal:
        return None
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    return kpos <= qpos + (sk - sq)


def _scores(q, k, sm_scale, causal):
    """f32 scores (q * scale) k^T, masked to -1e30; and the visibility
    mask (None when not causal)."""
    s = torch.matmul(_f(q) * sm_scale, _f(k).transpose(-1, -2))
    mask = _visible(q.shape[-2], k.shape[-2], causal, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    return s, mask


def _plain_flash_fwd(q, k, v, sm_scale, causal):
    """q [BH, Sq, D], k/v [BH, Sk, D] -> (out [BH, Sq, D] in q.dtype,
    lse [BH, Sq] f32)."""
    s, _ = _scores(q, k, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, _f(v)) / l
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _probs(q, k, lse, sm_scale, causal):
    """P = exp(s - lse), 0 where masked: the backward's recomputation."""
    s, mask = _scores(q, k, sm_scale, causal)
    p = torch.exp(s - lse[..., None])
    return p if mask is None else p.masked_fill(~mask, 0.0)


def _plain_flash_dq(q, k, v, do, lse, delta, sm_scale, causal):
    """dQ [BH, Sq, D] in q.dtype from the saved lse and delta [BH, Sq]."""
    p = _probs(q, k, lse, sm_scale, causal)
    dp = torch.matmul(_f(do), _f(v).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    return (torch.matmul(ds, _f(k)) * sm_scale).to(q.dtype)


def _plain_flash_dkv(q, k, v, do, lse, delta, sm_scale, causal):
    """(dK, dV) [BH, Sk, D] in k's / v's dtype."""
    p = _probs(q, k, lse, sm_scale, causal)
    dof = _f(do)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, _f(v).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), _f(q)) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _arm(impl):
    """(fwd, dq, dkv) of one impl."""
    if impl == "cuda":
        from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
        return cfa.flash_fwd, cfa.flash_dq, cfa.flash_dkv
    return _plain_flash_fwd, _plain_flash_dq, _plain_flash_dkv


class _Flash(torch.autograd.Function):
    """Flash attention on [BH, S, D] with the kernels' backward (the JAX
    `_flash` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        impl = registry.dispatch("flash_attention", q)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _arm(impl)[0](q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.impl, ctx.sm_scale, ctx.causal = impl, sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        _, dq_fn, dkv_fn = _arm(ctx.impl)
        # delta = rowsum(dO * O) in f32, outside the kernels (JAX `_bwd`)
        delta = (_f(do) * _f(out)).sum(dim=-1)
        dq = dq_fn(q, k, v, do, lse, delta, ctx.sm_scale, ctx.causal)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=False, sm_scale=None):
    """Flash attention on [B, H, S, D] tensors, differentiable.

    ``sm_scale`` defaults to 1/sqrt(D). Causal attention with Sq > Sk
    raises NotImplementedError: with the bottom-right diagonal some rows
    would see no key at all.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if causal and sq > sk:
        raise NotImplementedError(
            "causal flash_attention requires seq_q <= seq_k "
            f"(got {sq} > {sk})")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = _Flash.apply(q.reshape(b * h, sq, d), k.reshape(b * h, sk, d),
                       v.reshape(b * h, sk, d), float(sm_scale), bool(causal))
    return out.reshape(b, h, sq, d)


def flash_attention_fn(causal=False, scale=None):
    """A function ``fn(q, k, v)`` on the model's [B, S, H, D] layout."""

    def fn(q, k, v):
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              sm_scale=scale)
        return out.transpose(1, 2)

    return fn
