"""Norm layers (counterpart of `paddle_tpu/nn/layers/norm.py:13-141`): the
BatchNorms and `LayerNorm`. The group, instance, local-response and
spectral norm layers wait for ROADMAP A7.2.

A BatchNorm's running statistics are the float32 buffers ``_mean`` and
``_variance`` (zeros and ones); `amp.decorate` casts its weight and bias
with the other parameters and leaves the buffers as they are, as in the
JAX package."""
from __future__ import annotations

import torch

from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
        else:
            attr = ParamAttr._to_attr(weight_attr)
            if attr is None:
                attr = ParamAttr(initializer=I.Constant(1.0))
            elif isinstance(attr, ParamAttr) and attr.initializer is None:
                attr.initializer = I.Constant(1.0)
            self.weight = self.create_parameter((num_features,), attr=attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                (num_features,), attr=ParamAttr._to_attr(bias_attr),
                is_bias=True)
        dev = device_mod.current_device()
        self.register_buffer("_mean", Tensor(
            torch.zeros(num_features, dtype=torch.float32, device=dev),
            _internal=True))
        self.register_buffer("_variance", Tensor(
            torch.ones(num_features, dtype=torch.float32, device=dev),
            _internal=True))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The fluid-style BatchNorm: ``act`` names a functional applied to
    the output."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Cross-rank batch norm. At one rank it is `BatchNorm`, as in the
    JAX package. Training across more than one rank raises, naming
    ROADMAP A12: the JAX `SyncBatchNorm` is `BatchNorm` and reduces over
    the global batch only under GSPMD; in an eager multi-process run it
    takes each rank's own statistics, which the port neither copies nor
    replaces with a cross-rank sync of its own."""

    def forward(self, x):
        from paddle_tpu_torch.distributed.parallel import get_world_size
        if self.training and not self._use_global_stats and \
                get_world_size() > 1:
            raise NotImplementedError(
                "SyncBatchNorm across ranks is not ported (ROADMAP A12: "
                "SyncBatchNorm across ranks); at one rank it is BatchNorm")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        for name, sub in list(layer._sub_layers.items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format)
            if layer.weight is not None:
                out.weight = layer.weight
            if layer.bias is not None:
                out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
        return out


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
