"""Conv layers (counterpart of `paddle_tpu/nn/layers/conv.py`).

The weight is drawn by ``KaimingUniform(fan_in, negative_slope=sqrt(5),
"leaky_relu")`` and the bias by ``Uniform(-1 / sqrt(fan_in), 1 /
sqrt(fan_in))`` from ``paddle.seed``'s stream, in the JAX package's order,
so a seeded layer's weights equal the JAX draws."""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n,
                 transposed=False, stride=1, padding=0, output_padding=0,
                 dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = _ntuple(stride, n)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _ntuple(dilation, n)
        self._groups = groups
        self._data_format = data_format
        self._n = n
        if transposed:
            shape = (in_channels, out_channels // groups) + self._kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self._kernel_size
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        attr = ParamAttr._to_attr(weight_attr)
        if attr is None:
            attr = ParamAttr(initializer=I.KaimingUniform(
                fan_in=fan_in, negative_slope=np.sqrt(5.0),
                nonlinearity="leaky_relu"))
        elif isinstance(attr, ParamAttr) and attr.initializer is None:
            attr.initializer = I.KaimingUniform(
                fan_in=fan_in, negative_slope=np.sqrt(5.0),
                nonlinearity="leaky_relu")
        self.weight = self.create_parameter(shape, attr=attr)
        if bias_attr is False:
            self.bias = None
        else:
            battr = ParamAttr._to_attr(bias_attr)
            bound = 1.0 / np.sqrt(fan_in)
            if battr is None:
                battr = ParamAttr(initializer=I.Uniform(-bound, bound))
            elif isinstance(battr, ParamAttr) and battr.initializer is None:
                battr.initializer = I.Uniform(-bound, bound)
            self.bias = self.create_parameter((out_channels,), attr=battr,
                                              is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)
