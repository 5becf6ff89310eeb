"""incubate.nn fused layers of the port (counterpart of
`paddle_tpu/incubate/nn/__init__.py`): FusedMultiHeadAttention,
FusedFeedForward, FusedTransformerEncoderLayer, FusedLayerNorm,
fused_rotary_position_embedding and FusedMultiTransformer.

`FusedLayerNorm` runs the fused layernorm op (`kernels/fused_layernorm.py`:
the ``fused_layernorm_fwd`` / ``fused_layernorm_bwd`` kernels on the card)
and `fused_rotary_position_embedding` the fused rope op
(`kernels/rotary.py`: the ``rotary`` kernel), each dispatched per call by
the tensor's device. The attention layers stand on `nn.MultiHeadAttention`,
whose attention with no mask and no dropout is the flash op (the
``flash_fwd`` kernel). The layers are Paddle `nn.Layer`s with the JAX
state_dict keys, on Paddle Tensors; they create their parameters where
`device.set_device` says, drawn from the global seed stream.

Kept as the reference has them (ROADMAP C5): a FusedMultiHeadAttention
drops the cache its attention returns, so `FusedMultiTransformer` given
``caches`` returns ``(out, [])``; `FusedMultiTransformer` is pre-LN only
and ignores its ``epsilon``; the layers ignore their ``*_attr``, ``nranks``
and ``ring_id`` arguments.
"""
from __future__ import annotations

from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.kernels.fused_layernorm import fused_layer_norm
from paddle_tpu_torch.kernels.rotary import apply_rotary_emb
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Dropout, Linear
from paddle_tpu_torch.nn.layers.norm import LayerNorm
from paddle_tpu_torch.nn.layers.transformer import MultiHeadAttention
from paddle_tpu_torch.ops.common import ensure_tensor

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedLayerNorm",
           "fused_rotary_position_embedding", "FusedMultiTransformer"]

ACTIVATIONS = ("relu", "gelu", "silu", "tanh", "sigmoid")


class FusedMultiHeadAttention(Layer):
    """Attention block: ``out = residual + dropout(attn(x))`` with ``x`` the
    query, layer-normed first when ``normalize_before`` (pre-LN), the sum
    layer-normed after otherwise (post-LN). ``kdim`` / ``vdim`` are
    ignored, as in the reference."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.attn = MultiHeadAttention(embed_dim, num_heads,
                                       dropout=attn_dropout_rate)
        self.ln = LayerNorm(embed_dim, epsilon=epsilon)
        self.dropout = Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        residual = query
        x = self.ln(query) if self.normalize_before else query
        out = self.attn(x, key, value, attn_mask, cache)
        # the attention's (out, cache) loses its cache here (ROADMAP C5)
        out = residual + self.dropout(out if not isinstance(out, tuple)
                                      else out[0])
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedFeedForward(Layer):
    """Feed-forward block: ``out = residual + dropout(linear2(act_dropout(
    activation(linear1(x)))))``, pre- or post-LN as
    `FusedMultiHeadAttention`. ``activation`` names one of
    `nn.functional`'s: relu, gelu (erf), silu, tanh or sigmoid."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"FusedFeedForward: activation {activation!r} is"
                             f" not ported; expected one of {ACTIVATIONS}")
        self.normalize_before = normalize_before
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.ln = LayerNorm(d_model, epsilon=epsilon)
        self.dropout = Dropout(dropout_rate)
        self.act_dropout = Dropout(act_dropout_rate if act_dropout_rate
                                   is not None else dropout_rate)
        self.activation = getattr(F, activation)

    def forward(self, src):
        residual = src
        x = self.ln(src) if self.normalize_before else src
        x = self.linear2(self.act_dropout(self.activation(self.linear1(x))))
        out = residual + self.dropout(x)
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedTransformerEncoderLayer(Layer):
    """`FusedMultiHeadAttention` (self-attention) then `FusedFeedForward`."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate,
            attn_dropout_rate if attn_dropout_rate is not None
            else dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate, activation=activation,
            act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        out = self.fused_attn(src, attn_mask=src_mask, cache=cache)
        return self.ffn(out)


class FusedLayerNorm(Layer):
    """Layernorm over the last axis through the fused layernorm op, with
    float32 ``weight`` (ones) and ``bias`` (zeros) [d]; differentiable in x,
    weight and bias. A ``normalized_shape`` of more than one axis raises
    ValueError."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        if len(normalized_shape) != 1:
            raise ValueError("FusedLayerNorm fuses over the last axis only")
        d = int(normalized_shape[0])
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            (d,), attr=ParamAttr(initializer=I.Constant(1.0)),
            dtype="float32")
        self.bias = self.create_parameter((d,), dtype="float32",
                                          is_bias=True)

    def forward(self, x):
        return apply(lambda a, g, b: fused_layer_norm(a, g, b,
                                                      eps=self.epsilon),
                     ensure_tensor(x), self.weight, self.bias,
                     op_name="fused_layer_norm")


def fused_rotary_position_embedding(q, k, cos, sin, name=None):
    """The fused rope op on q, k [B, H, S, D] with cos, sin [S, D/2]:
    (q_rot, k_rot), on the tensors' device. Forward only (ROADMAP C4)."""
    return apply(apply_rotary_emb, *map(ensure_tensor, (q, k, cos, sin)),
                 op_name="fused_rope")


class FusedMultiTransformer(Layer):
    """``num_layers`` pre-LN `FusedTransformerEncoderLayer`s (default
    activation gelu, erf form), registered as ``layer_{i}`` as the JAX
    package's state_dict has them. ``forward(src, attn_mask, caches)``
    returns the output, or ``(out, [])`` when ``caches`` are given: each
    layer attends over its cache's keys and values too, but the extended
    caches are dropped (ROADMAP C5)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, epsilon=1e-5, **kwargs):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError(
                "FusedMultiTransformer is pre-LN only (ref constraint)")
        self.layers = []
        for i in range(num_layers):
            blk = FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward, dropout_rate,
                activation=activation, normalize_before=True)
            self.add_sublayer(f"layer_{i}", blk)
            self.layers.append(blk)

    def forward(self, src, attn_mask=None, caches=None, **kwargs):
        out = src
        for i, blk in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            out = blk(out, src_mask=attn_mask, cache=cache)
        # FusedMultiHeadAttention drops the extended cache (ROADMAP C5)
        return (out, []) if caches is not None else out
