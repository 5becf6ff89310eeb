"""Fused layernorm over the last axis, forward and backward (counterpart of
`paddle_tpu/kernels/pallas/fused_layernorm.py`).

- forward: per row of x [n, d], mean and variance in f32, ``rstd =
  rsqrt(var + eps)``, ``y = (x - mean) * rstd * gamma + beta`` in x's
  dtype; mean and rstd [n, 1] f32 are saved for the backward;
- backward: ``xhat = (x - mean) * rstd``, ``wdy = dy * gamma``, the row
  means ``c1 = mean(wdy)``, ``c2 = mean(wdy * xhat)``, ``dx = (wdy - c1 -
  xhat * c2) * rstd`` in x's dtype, and dgamma / dbeta as per-block
  partials [nb, d] f32 (sums over each block of ``block_rows`` rows of
  ``dy * xhat`` and ``dy``), which the op sums over the blocks afterwards,
  as the JAX package's `_bwd` does (`:107`), and casts to gamma's dtype.

`kernels/registry.py` op ``fused_layernorm`` picks the arm once per forward
call by the tensor's device, and the backward follows it: a CPU tensor
takes the plain PyTorch versions below, a CUDA tensor the hand-written
kernels `kernels/csrc/fused_layernorm_{fwd,bwd}.cu` through
`kernels/cuda/fused_layernorm.py`, and never the plain versions. The two
arms cut the backward's rows into blocks of different sizes (256 here, as
the Pallas kernel; 16 in the CUDA kernel), which changes only the order
of the f32 sums of dgamma and dbeta.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import registry

__all__ = ["BLOCK_ROWS", "fused_layer_norm"]

BLOCK_ROWS = 256    # rows per grid step of the Pallas kernel


def _plain_ln_fwd(x, gamma, beta, eps):
    """x [n, d] -> (y [n, d] in x's dtype, mu [n, 1] f32, rstd [n, 1] f32)."""
    xf = x.float()
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mu, rstd


def _plain_ln_bwd(x, gamma, mu, rstd, dy, block_rows=BLOCK_ROWS):
    """(dx [n, d] in x's dtype, dgamma and dbeta partials [nb, d] f32), one
    partial row per block of ``block_rows`` rows (at most n); the rows a
    last partial block lacks count as zeros, the Pallas kernel's masked
    padding."""
    n, d = x.shape
    br = min(int(block_rows), n)
    nb = -(-n // br)
    xhat = (x.float() - mu) * rstd
    dyf = dy.float()
    wdy = dyf * gamma.float()
    c1 = wdy.mean(dim=1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd
    pad = nb * br - n

    def partials(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        return t.reshape(nb, br, d).sum(dim=1)

    return dx.to(x.dtype), partials(dyf * xhat), partials(dyf)


def _arm(impl):
    """(fwd, bwd) of one impl."""
    if impl == "cuda":
        from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln
        return cln.fused_layernorm_fwd, cln.fused_layernorm_bwd
    return _plain_ln_fwd, _plain_ln_bwd


class _LayerNorm(torch.autograd.Function):
    """Layernorm on rows [n, d] with the kernels' backward (the JAX `_ln`
    custom VJP)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        impl = registry.dispatch("fused_layernorm", x)
        x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
        y, mu, rstd = _arm(impl)[0](x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mu, rstd)
        ctx.impl = impl
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mu, rstd = ctx.saved_tensors
        dx, dg, db = _arm(ctx.impl)[1](x, gamma, mu, rstd, dy.contiguous())
        return dx, dg.sum(0).to(gamma.dtype), db.sum(0).to(gamma.dtype), None


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """Layernorm of ``x`` [..., d] over its last axis with ``gamma`` and
    ``beta`` [d], differentiable in all three. Statistics in f32; the output
    and dx in x's dtype, dgamma and dbeta in gamma's."""
    shape = x.shape
    d = shape[-1]
    out = _LayerNorm.apply(x.reshape(-1, d), gamma, beta, float(eps))
    return out.reshape(shape)
