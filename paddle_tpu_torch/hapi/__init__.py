"""paddle.hapi of the port (counterpart of `paddle_tpu/hapi/`; ref
`python/paddle/hapi/`): `Model`, `callbacks` and `summary`."""
from paddle_tpu_torch.hapi.model import Model  # noqa: F401
from paddle_tpu_torch.hapi import callbacks  # noqa: F401


def summary(net, input_size=None, dtypes=None, input=None):
    """Layer summary (ref: `python/paddle/hapi/model_summary.py`)."""
    import numpy as np
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total += n
        if not p.stop_gradient:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=10) + 2
    lines = [f"{'Param':<{width}}{'Shape':<20}{'Count':>12}"]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<20}{n:>12,}")
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
