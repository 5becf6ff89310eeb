"""paddle.vision of the port (counterpart of `paddle_tpu/vision/`): the
ResNet family in `models`, `datasets` and `transforms`. The other model
families (LeNet, VGG, MobileNet, AlexNet and SqueezeNet, DenseNet,
GoogLeNet and Inception, ShuffleNet) and ``ops`` wait for ROADMAP
A7.5.3."""
from paddle_tpu_torch.vision import models  # noqa: F401
from paddle_tpu_torch.vision import transforms  # noqa: F401
from paddle_tpu_torch.vision import datasets  # noqa: F401


def set_image_backend(backend):
    pass


def get_image_backend():
    return "numpy"
