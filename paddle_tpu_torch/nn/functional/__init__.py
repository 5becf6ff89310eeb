"""paddle.nn.functional of the port (counterpart of
`paddle_tpu/nn/functional/`): activations, the common functionals,
convolution, pooling, batch_norm and layer_norm, attention and the
losses. The other norms, vision and interpolation wait for ROADMAP
A7.2."""
from paddle_tpu_torch.nn.functional.activation import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.attention import (  # noqa: F401
    scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.conv import (  # noqa: F401
    conv1d, conv2d, conv3d, conv1d_transpose, conv2d_transpose,
    conv3d_transpose)
from paddle_tpu_torch.nn.functional.loss import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.norm import (  # noqa: F401
    batch_norm, layer_norm)
from paddle_tpu_torch.nn.functional.pooling import *  # noqa: F401,F403
from paddle_tpu_torch.ops.random import gumbel_softmax  # noqa: F401
