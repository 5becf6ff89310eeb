"""Optimizers of the port (counterpart of `paddle_tpu/optimizer/`): AdamW,
the one the training slice uses."""
from paddle_tpu_torch.optimizer.optimizers import AdamW

__all__ = ["AdamW"]
