"""paddle.vision of the port (counterpart of `paddle_tpu/vision/`): the
ResNet family in `models`. The other model families (LeNet, VGG,
MobileNet, AlexNet and SqueezeNet, DenseNet, GoogLeNet and Inception,
ShuffleNet), ``datasets``, ``transforms`` and ``ops`` wait for ROADMAP
A7.5."""
from paddle_tpu_torch.vision import models  # noqa: F401
