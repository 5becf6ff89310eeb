"""Optimizers of the port (counterpart of `paddle_tpu/optimizer/`): AdamW,
the one the training slice uses, and the LR schedulers of `lr.py`."""
from paddle_tpu_torch.optimizer.optimizers import AdamW
from paddle_tpu_torch.optimizer import lr  # noqa: F401

__all__ = ["AdamW", "lr"]
