"""Activation layers (counterpart of `paddle_tpu/nn/layers/activation.py`)."""
from __future__ import annotations

from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer


def _simple(fname, cls_name, **fixed):
    def forward(self, x):
        return getattr(F, fname)(x, **fixed, **self._kwargs)

    def __init__(self, *args, name=None, **kwargs):
        Layer.__init__(self)
        self._kwargs = kwargs
        for a, k in zip(args, _ARG_NAMES.get(cls_name, [])):
            self._kwargs[k] = a

    return type(cls_name, (Layer,), {"__init__": __init__, "forward": forward})


_ARG_NAMES = {
    "LeakyReLU": ["negative_slope"],
    "ELU": ["alpha"],
    "CELU": ["alpha"],
    "GELU": ["approximate"],
    "Hardshrink": ["threshold"],
    "Softshrink": ["threshold"],
    "Hardtanh": ["min", "max"],
    "Softplus": ["beta", "threshold"],
    "ThresholdedReLU": ["threshold", "value"],
    "Softmax": ["axis"],
    "LogSoftmax": ["axis"],
    "Maxout": ["groups", "axis"],
    "GLU": ["axis"],
}

ReLU = _simple("relu", "ReLU")
ReLU6 = _simple("relu6", "ReLU6")
Sigmoid = _simple("sigmoid", "Sigmoid")
Tanh = _simple("tanh", "Tanh")
LeakyReLU = _simple("leaky_relu", "LeakyReLU")
ELU = _simple("elu", "ELU")
CELU = _simple("celu", "CELU")
SELU = _simple("selu", "SELU")
GELU = _simple("gelu", "GELU")
Hardshrink = _simple("hardshrink", "Hardshrink")
Hardsigmoid = _simple("hardsigmoid", "Hardsigmoid")
Hardswish = _simple("hardswish", "Hardswish")
Hardtanh = _simple("hardtanh", "Hardtanh")
Mish = _simple("mish", "Mish")
Silu = _simple("silu", "Silu")
Swish = _simple("swish", "Swish")
Softplus = _simple("softplus", "Softplus")
Softshrink = _simple("softshrink", "Softshrink")
Softsign = _simple("softsign", "Softsign")
Tanhshrink = _simple("tanhshrink", "Tanhshrink")
ThresholdedReLU = _simple("thresholded_relu", "ThresholdedReLU")
LogSigmoid = _simple("log_sigmoid", "LogSigmoid")
Softmax = _simple("softmax", "Softmax")
LogSoftmax = _simple("log_softmax", "LogSoftmax")
Maxout = _simple("maxout", "Maxout")
GLU = _simple("glu", "GLU")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        attr = ParamAttr._to_attr(weight_attr)
        if attr is None:
            attr = ParamAttr(initializer=I.Constant(init))
        elif isinstance(attr, ParamAttr) and attr.initializer is None:
            attr.initializer = I.Constant(init)
        self._weight = self.create_parameter((num_parameters,), attr=attr)
        self._data_format = data_format

    @property
    def weight(self):
        return self._weight

    def forward(self, x):
        return F.prelu(x, self._weight, data_format=self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)
