"""Paddle nn functionals of the port (counterpart of
`paddle_tpu/nn/functional/`), reduced to what the `incubate.nn` fused layers
call. Plain PyTorch op for op as the JAX package computes them, except
`scaled_dot_product_attention` with no mask and no dropout, which runs the
port's flash-attention op."""
from paddle_tpu_torch.nn.functional.activation import (  # noqa: F401
    gelu, relu, sigmoid, silu, tanh)
from paddle_tpu_torch.nn.functional.attention import (  # noqa: F401
    scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import dropout, linear  # noqa: F401
from paddle_tpu_torch.nn.functional.norm import layer_norm  # noqa: F401
