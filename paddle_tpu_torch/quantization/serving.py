"""Weight-only int8 for serving, and the serving parity check (counterpart
of `paddle_tpu/quantization/serving.py`).

The GPT matmul leaves (qkv and out projections, MLP up and down) convert to
int8 with per-output-channel f32 scales, and the step functions dequantize
each leaf where they use it (`models/gpt.py::_deq`). Embeddings and
layernorm parameters stay full width: the token table doubles as the LM
head, where its error would land on every logit.
"""
from __future__ import annotations

import time

import torch

from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.quantization.comms import absmax_int8

__all__ = ["QuantizedLeaf", "quantize_gpt_params", "GPT_MATMUL_SUFFIXES",
           "QUANT_LOGIT_BOUND", "margin_gated_parity"]

# the int8-vs-float logit contract of the JAX package's docs/QUANTIZATION.md
QUANT_LOGIT_BOUND = 0.5

# the state_dict matmul leaves that convert ([in, out] per layer, or
# [nl, in, out] stacked); everything else passes through untouched
GPT_MATMUL_SUFFIXES = (
    "attn.qkv_proj.weight", "attn.out_proj.weight",
    "mlp.fc_in.weight", "mlp.fc_out.weight",
)


def margin_gated_parity(lg_ref, lg, bound=QUANT_LOGIT_BOUND):
    """-> ``(max_abs_diff, ok)``: ``lg`` within ``bound`` of the reference
    logits ``lg_ref``, and top-1 tokens identical wherever the reference's
    top-2 margin clears twice the bound (a margin inside 2x the bound means
    the allowed noise could legitimately flip the argmax, so those rows are
    not evidence either way). Accepts any ``[..., vocab]`` shape; gates per
    trailing row. Both tensors are compared in float32 on the CPU."""
    ref = lg_ref.detach().float().cpu()
    got = lg.detach().float().cpu()
    diff = float((ref - got).abs().max())
    flat_ref = ref.reshape(-1, ref.shape[-1])
    flat = got.reshape(-1, got.shape[-1])
    top2 = flat_ref.topk(2, dim=-1).values
    gated = (top2[:, 0] - top2[:, 1]) > 2 * bound
    same = flat_ref.argmax(dim=-1) == flat.argmax(dim=-1)
    ok = diff <= bound and bool((same | ~gated).all())
    return diff, ok


class QuantizedLeaf:
    """An int8 weight and its per-output-channel f32 scale, shaped to
    broadcast back onto it (``[..., 1, out]``). ``dequant()`` gives the
    weight back in its original dtype; the step functions call it at every
    use."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, dtype_name: str):
        self.q = q                   # int8, the weight's shape
        self.scale = scale           # float32, [..., 1, out]
        self.dtype_name = dtype_name

    def dequant(self) -> torch.Tensor:
        return (self.q.float() * self.scale).to(self.dtype)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype consumers compute in, not the storage dtype."""
        return getattr(torch, self.dtype_name)

    @property
    def shape(self):
        return self.q.shape

    def to(self, device) -> "QuantizedLeaf":
        return QuantizedLeaf(self.q.to(device), self.scale.to(device),
                             self.dtype_name)

    def unbind(self, dim=0) -> list["QuantizedLeaf"]:
        """Per-layer leaves of a stacked ``[nl, in, out]`` leaf: each keeps
        its layer's int8 values and scale."""
        if dim != 0:
            raise ValueError("a quantized leaf unbinds along its layer axis "
                             "(dim 0) only")
        return [QuantizedLeaf(q, s, self.dtype_name)
                for q, s in zip(self.q.unbind(0), self.scale.unbind(0))]

    def __repr__(self):
        return (f"QuantizedLeaf(shape={tuple(self.q.shape)}, "
                f"dtype={self.dtype_name})")


def _quantize_leaf(w: torch.Tensor) -> QuantizedLeaf:
    """Per-output-channel abs-max int8: reduce ONLY the contraction axis
    (second to last), so a stacked ``[nl, in, out]`` leaf keeps one scale
    per layer and output channel."""
    q, s = absmax_int8(w.detach(), axis=-2, keepdims=True)
    return QuantizedLeaf(q, s, str(w.dtype).replace("torch.", ""))


def _is_matmul_key(key: str) -> bool:
    return any(key.endswith(suf) for suf in GPT_MATMUL_SUFFIXES)


def quantize_gpt_params(params, dtype: str = "int8"):
    """A GPT params dict with its matmul leaves replaced by
    :class:`QuantizedLeaf`. Accepts both layouts: the per-layer state_dict
    (``gpt.h.<i>.attn.qkv_proj.weight`` ...) the step functions take, and
    the stacked ``{"blocks": {suffix: [nl, ...]}, "top": {...}}`` layout of
    `models/gpt.py::stack_gpt_params`. Returns a NEW dict of the same
    layout; every other leaf is passed through by reference. The
    conversion's wall time is observed as ``engine.quant_dequant_ms``, as
    the JAX package observes it."""
    if dtype != "int8":
        raise ValueError(f"weight_dtype={dtype!r}: only 'int8' is "
                         "implemented")
    t0 = time.perf_counter()
    if set(params.keys()) == {"blocks", "top"}:
        out = {"blocks": {suf: (_quantize_leaf(v) if suf in
                                GPT_MATMUL_SUFFIXES else v)
                          for suf, v in params["blocks"].items()},
               "top": dict(params["top"])}
    else:
        out = {k: (_quantize_leaf(v) if _is_matmul_key(k) else v)
               for k, v in params.items()}
    metrics.histogram("engine.quant_dequant_ms").observe(
        (time.perf_counter() - t0) * 1e3)
    return out
