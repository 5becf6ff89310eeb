"""`linear` and `dropout` (counterpart of
`paddle_tpu/nn/functional/common.py`)."""
from __future__ import annotations

import torch

__all__ = ["linear", "dropout"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` [in, out] (the Paddle layout);
    the bias is cast to x's dtype, as in the JAX package."""
    out = torch.matmul(x, weight)
    if bias is None:
        return out
    return out + bias.to(x.dtype)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """The deterministic arms of the JAX ``dropout``: the identity when not
    training or ``p == 0`` (times ``1 - p`` in eval under
    ``mode="downscale_in_infer"``), zeros for ``p == 1`` in training. With
    ``0 < p < 1`` in training it raises NotImplementedError: the threefry
    chain and its bernoulli are ported (`kernels/prng.py`, and the hidden
    dropout of training, `kernels/dropout.py`), but the eager layer draws
    its keys from Paddle's global seed stream (``paddle.seed``), which is
    not (ROADMAP A7)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}; expected "
                         "'upscale_in_train' or 'downscale_in_infer'")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    raise NotImplementedError(
        f"dropout with p={p} in training: the eager layer draws its mask "
        "keys from Paddle's global seed stream (paddle.seed), which is not "
        "ported (ROADMAP A7); the threefry chain is (kernels/prng.py). Call "
        ".eval() or set the rate to 0")
