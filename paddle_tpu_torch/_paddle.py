"""The Paddle front end the package's top level exports (loaded on first
use by `paddle_tpu_torch.__getattr__`): dtypes, `Tensor`, `to_tensor`,
`Parameter`, the grad switches, every op, the seed functions, the device
functions, `nn`, `optimizer`, `autograd`, `PyLayer`, `amp`, `jit`,
`vision`, `io`, `metric`, the flags (`get_flags` / `set_flags`) and hapi's
`Model`, `callbacks` and `summary`."""
from paddle_tpu_torch.core.dtype import (  # noqa: F401
    bool_ as bool, uint8, int8, int16, int32, int64, float16, bfloat16,
    float32, float64, complex64, complex128, set_default_dtype,
    get_default_dtype, finfo, iinfo)
from paddle_tpu_torch.core.tensor import (  # noqa: F401
    Tensor, to_tensor, Parameter)
from paddle_tpu_torch.core.autograd import (  # noqa: F401
    no_grad, enable_grad, set_grad_enabled, is_grad_enabled, grad)
from paddle_tpu_torch.ops import *  # noqa: F401,F403
from paddle_tpu_torch.ops import __all__ as _ops_all
from paddle_tpu_torch.ops.random import (  # noqa: F401
    seed, get_rng_state, set_rng_state)
from paddle_tpu_torch import device  # noqa: F401
from paddle_tpu_torch.device import (  # noqa: F401
    CPUPlace, CUDAPlace, TPUPlace, CUDAPinnedPlace, set_device, get_device,
    is_compiled_with_cuda, is_compiled_with_rocm, is_compiled_with_xpu)
from paddle_tpu_torch import nn  # noqa: F401
from paddle_tpu_torch import optimizer  # noqa: F401
from paddle_tpu_torch import autograd  # noqa: F401
from paddle_tpu_torch.autograd import PyLayer  # noqa: F401
from paddle_tpu_torch import amp  # noqa: F401
from paddle_tpu_torch import jit  # noqa: F401
from paddle_tpu_torch import vision  # noqa: F401
from paddle_tpu_torch import io  # noqa: F401
from paddle_tpu_torch import metric  # noqa: F401
from paddle_tpu_torch.framework.flags import get_flags, set_flags  # noqa: F401
from paddle_tpu_torch.hapi.model import Model  # noqa: F401
from paddle_tpu_torch.hapi import callbacks, summary  # noqa: F401

__all__ = (["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
            "bfloat16", "float32", "float64", "complex64", "complex128",
            "set_default_dtype", "get_default_dtype", "finfo", "iinfo",
            "Tensor", "to_tensor", "Parameter", "no_grad", "enable_grad",
            "set_grad_enabled", "is_grad_enabled", "grad", "seed",
            "get_rng_state", "set_rng_state", "device", "CPUPlace",
            "CUDAPlace", "TPUPlace", "CUDAPinnedPlace", "set_device",
            "get_device", "is_compiled_with_cuda", "is_compiled_with_rocm",
            "is_compiled_with_xpu", "nn", "optimizer", "autograd", "PyLayer",
            "amp", "jit", "vision", "io", "metric", "get_flags", "set_flags",
            "Model", "callbacks", "summary"]
           + [n for n in _ops_all if n not in ("seed", "get_rng_state",
                                               "set_rng_state")])
