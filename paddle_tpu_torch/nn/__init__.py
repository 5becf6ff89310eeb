"""paddle.nn of the port (counterpart of `paddle_tpu/nn/`): `Layer` and
its containers, initializers, activations, the common, convolution,
pooling, batch and layer norm, loss and transformer layers, and
`functional`. The group, instance, local-response and spectral norms,
recurrent layers, ``utils`` and gradient clipping wait for ROADMAP
A7.2."""
from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn import initializer  # noqa: F401
from paddle_tpu_torch.nn.layer import Layer  # noqa: F401
from paddle_tpu_torch.nn.layers.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, SELU, Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign,
    Swish, Tanh, Tanhshrink, ThresholdedReLU)
from paddle_tpu_torch.nn.layers.common import (  # noqa: F401
    AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
    Dropout2D, Dropout3D, Embedding, Flatten, Identity, Linear, Pad1D, Pad2D,
    Pad3D, PairwiseDistance, PixelShuffle, PixelUnshuffle, Unflatten,
    ZeroPad2D)
from paddle_tpu_torch.nn.layers.container import (  # noqa: F401
    LayerDict, LayerList, ParameterList, Sequential)
from paddle_tpu_torch.nn.layers.conv import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose,
    Conv3DTranspose)
from paddle_tpu_torch.nn.layers.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss, MarginRankingLoss,
    MSELoss, NLLLoss, SmoothL1Loss, TripletMarginLoss)
from paddle_tpu_torch.nn.layers.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm,
    SyncBatchNorm)
from paddle_tpu_torch.nn.layers.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from paddle_tpu_torch.nn.layers.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)
