"""paddle.optimizer of the port (counterpart of `paddle_tpu/optimizer/`):
the Optimizer base, SGD, Momentum, Adam, AdamW, Adagrad, Adamax, Adadelta,
RMSProp, Lamb, LarsMomentum and the LR schedulers of `lr.py`."""
from paddle_tpu_torch.optimizer import lr  # noqa: F401
from paddle_tpu_torch.optimizer.optimizer import Optimizer
from paddle_tpu_torch.optimizer.optimizers import (
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, LarsMomentum,
    Momentum, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adamax", "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "lr"]
