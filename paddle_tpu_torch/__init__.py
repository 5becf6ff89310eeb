"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for an NVIDIA H100.

The JAX package `paddle_tpu` stays the reference; this package imports
nothing from it and nothing of JAX. Each Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper (`kernels/csrc/`), beside a
plain PyTorch version that runs on the CPU.

The Paddle eager front end is this package's top level, as the JAX
package's is (`_paddle.py`): dtypes, `Tensor` (a wrapper over a torch
tensor), autograd on torch's engine, the ops, `nn`, `optimizer`,
`autograd` and the device functions. New tensors go to the card unless
`set_device("cpu")` says otherwise. The names load on first use, so a
stdlib-only subpackage (`observability`) imports without torch. ROADMAP.md
lists what of the JAX package is ported and what waits.
"""
import importlib as _importlib


_SUBPACKAGES = ("device", "nn", "optimizer", "autograd", "amp", "jit",
                "vision", "io", "metric", "hapi")


def __getattr__(name):
    if name in _SUBPACKAGES:
        return _importlib.import_module(f"paddle_tpu_torch.{name}")
    api = _importlib.import_module("paddle_tpu_torch._paddle")
    if name in api.__all__:
        globals().update({n: getattr(api, n) for n in api.__all__})
        return globals()[name]
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")


def __dir__():
    api = _importlib.import_module("paddle_tpu_torch._paddle")
    return sorted(set(globals()) | set(api.__all__))
