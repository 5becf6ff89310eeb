"""paddle.jit on the port (counterpart of `paddle_tpu/jit/__init__.py`).

``to_static`` runs a Paddle step as one program a call: a captured CUDA
graph on the card, the same state protocol without a graph on the CPU
(`jit/static_function.py`). The JAX package's dy2static AST conversion
(``cond``, ``while_loop``, ``ifelse``, ``whileloop``,
``convert_to_static``) and its program export (``save``, ``load``,
``TranslatedLayer``) are not ported: they raise, naming ROADMAP A10.
"""
from paddle_tpu_torch.jit.static_function import (  # noqa: F401
    to_static, StaticFunction, MultiStepFunction, not_to_static,
    ignore_module, DataDependentControlFlowError, DataDependentIndexError)

__all__ = ["to_static", "StaticFunction", "MultiStepFunction",
           "not_to_static", "ignore_module", "save", "load",
           "TranslatedLayer", "cond", "while_loop", "ifelse", "whileloop",
           "convert_to_static", "DataDependentControlFlowError",
           "DataDependentIndexError"]


def _not_ported(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"paddle.jit.{name} is not ported: dy2static's AST conversion, "
            "jit.cond / while_loop and jit.save / load are ROADMAP A10")
    refuse.__name__ = name
    return refuse


save = _not_ported("save")
load = _not_ported("load")
cond = _not_ported("cond")
while_loop = _not_ported("while_loop")
ifelse = _not_ported("ifelse")
whileloop = _not_ported("whileloop")
convert_to_static = _not_ported("convert_to_static")


class TranslatedLayer:
    """A loaded `jit.save` program (not ported: ROADMAP A10)."""

    def __init__(self, *args, **kwargs):
        _not_ported("TranslatedLayer")()
