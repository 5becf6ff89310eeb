"""`LayerNorm` (counterpart of `paddle_tpu/nn/layers/norm.py:114-141`). The
batch, group, instance, local-response and spectral norm layers wait for
ROADMAP A7.2."""
from __future__ import annotations

from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    """`nn.functional.layer_norm` over the trailing ``normalized_shape``
    axes with a ``weight`` (ones) and ``bias`` (zeros) of that shape;
    ``weight_attr=False`` / ``bias_attr=False`` drop them."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            attr = ParamAttr._to_attr(weight_attr)
            if attr is None:
                attr = ParamAttr(initializer=I.Constant(1.0))
            elif isinstance(attr, ParamAttr) and attr.initializer is None:
                attr.initializer = I.Constant(1.0)
            self.weight = self.create_parameter(self._normalized_shape,
                                                attr=attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                self._normalized_shape, attr=ParamAttr._to_attr(bias_attr),
                is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
