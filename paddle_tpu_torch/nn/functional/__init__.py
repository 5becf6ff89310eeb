"""paddle.nn.functional of the port (counterpart of
`paddle_tpu/nn/functional/`): activations, the common functionals,
layer_norm, attention and the losses. Convolution, pooling, the other
norms, vision and interpolation wait for ROADMAP A7.2."""
from paddle_tpu_torch.nn.functional.activation import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.attention import (  # noqa: F401
    scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.loss import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.norm import layer_norm  # noqa: F401
from paddle_tpu_torch.ops.random import gumbel_softmax  # noqa: F401
