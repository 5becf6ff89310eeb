"""Common layers (counterpart of `paddle_tpu/nn/layers/common.py`):
Linear, Identity, Embedding, the Dropouts, Flatten, Unflatten, Bilinear,
CosineSimilarity, PairwiseDistance, the Pads and the pixel and channel
shuffles. The Upsample layers wait for ``F.interpolate`` (ROADMAP A7.2)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.ops.manipulation import flatten, reshape

__all__ = ["Linear", "Identity", "Embedding", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Flatten", "Unflatten", "Bilinear",
           "CosineSimilarity", "PairwiseDistance", "Pad1D", "Pad2D", "Pad3D",
           "ZeroPad2D", "PixelShuffle", "PixelUnshuffle", "ChannelShuffle"]


class Linear(Layer):
    """y = xW + b with W: [in_features, out_features] (paddle convention,
    ref `python/paddle/nn/layer/common.py` Linear)."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=ParamAttr._to_attr(weight_attr))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                (out_features,), attr=ParamAttr._to_attr(bias_attr), is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx if padding_idx is None or padding_idx >= 0 \
            else num_embeddings + padding_idx
        attr = ParamAttr._to_attr(weight_attr)
        if attr is None or (isinstance(attr, ParamAttr) and attr.initializer is None):
            init = I.Normal(0.0, 1.0)
            if isinstance(attr, ParamAttr):
                attr.initializer = init
            else:
                attr = ParamAttr(initializer=init)
        self.weight = self.create_parameter((num_embeddings, embedding_dim),
                                            attr=attr)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight._data[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        shp = list(x.shape)
        shp[self.axis: self.axis + 1] = list(self.shape)
        return reshape(x, shp)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features),
            attr=ParamAttr._to_attr(weight_attr))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                (out_features,), attr=ParamAttr._to_attr(bias_attr), is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return apply(lambda a, b: torch.sum(
            torch.abs(a - b + self.epsilon) ** self.p, dim=-1,
            keepdim=self.keepdim) ** (1.0 / self.p), x, y,
            op_name="pairwise_distance")


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCDHW",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
