"""paddle.incubate of the port (counterpart of `paddle_tpu/incubate/`):
the fused layers of `incubate.nn`. The rest of the JAX package's
`incubate` (its distributed, MoE, ASP, autograd and optimizer parts) waits
for ROADMAP A7."""
from paddle_tpu_torch.incubate import nn  # noqa: F401
