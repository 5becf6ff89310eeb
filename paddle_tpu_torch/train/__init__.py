"""Training of the port (counterpart of `paddle_tpu/train/`): the GPT train
step."""
from paddle_tpu_torch.train.scan_step import H100_BF16_PEAK, ScanTrainStep

__all__ = ["H100_BF16_PEAK", "ScanTrainStep"]
