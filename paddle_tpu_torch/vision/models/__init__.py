"""Model zoo of the port (counterpart of `paddle_tpu/vision/models/`): the
ResNet family; the other families wait for ROADMAP A7.5."""
from paddle_tpu_torch.vision.models.resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext101_32x4d,
    wide_resnet50_2, wide_resnet101_2)
