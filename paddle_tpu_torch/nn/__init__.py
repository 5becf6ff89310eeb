"""Paddle nn layers of the port (counterpart of `paddle_tpu/nn/`), reduced
to what the `incubate.nn` fused layers stand on: `Linear`, `Dropout`,
`LayerNorm`, `MultiHeadAttention` and the functionals under
`nn.functional`. They are `torch.nn.Module`s with the JAX package's
attribute names, parameter shapes (``Linear.weight`` is [in, out]) and
state_dict keys, so a JAX ``Layer.state_dict()`` loads by key
(`models/convert.py::layer_state_from_numpy`). The rest of the Paddle nn
surface waits for ROADMAP A7."""
from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn.layers.common import Dropout, Linear  # noqa: F401
from paddle_tpu_torch.nn.layers.norm import LayerNorm  # noqa: F401
from paddle_tpu_torch.nn.layers.transformer import (  # noqa: F401
    MultiHeadAttention)
