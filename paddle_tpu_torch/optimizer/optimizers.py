"""AdamW with decoupled weight decay (counterpart of
`paddle_tpu/optimizer/optimizers.py::AdamW` and its pure update
`_adam_update`, which the JAX train step fuses).

`_adam_update` repeats the JAX update with ``decouple=True`` op for op, in
the same order and in float32: `torch.optim.AdamW` applies the decay before the moments and adds
eps in another place, which would cost parity. The scalar coefficients
(1 - beta, beta ** t) are computed in float32 as JAX computes them, then
passed to the tensor ops as the Python floats holding those float32 values.
"""
from __future__ import annotations

import torch

__all__ = ["AdamW"]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _adam_update(p, g, m, v, lr, beta1, beta2, eps, t, wd):
    """One AdamW step (decoupled decay) on float32 p, g, m, v. lr, beta1,
    beta2, eps, t and wd are 0-dim float32 tensors. Returns (new_p, m,
    v)."""
    c1 = float(1 - beta1)
    c2 = float(1 - beta2)
    b1, b2 = float(beta1), float(beta2)
    g32 = g.to(m.dtype)
    p32 = p.to(m.dtype)
    m = b1 * m + c1 * g32
    v = b2 * v + c2 * g32 * g32
    mhat = m / float(1 - beta1 ** t)
    vv = v / float(1 - beta2 ** t)
    denom = torch.sqrt(vv) + float(eps)
    upd = mhat / denom
    upd = upd + float(wd) * p32
    new_p = (p32 - float(lr) * upd).to(p.dtype)
    return new_p, m, v


class AdamW:
    """AdamW's hyperparameters and its state, kept per parameter name of the
    model's state_dict: ``state[name] = {"moment1", "moment2"[, "master"]}``
    (float32; "master" for parameters held in a lower precision). A train
    step (`train/scan_step.py`) seeds its state from here and writes it back
    with ``sync_to_model``. Weight decay applies to every parameter, as the
    JAX AdamW does without ``apply_decay_param_fun``; ``clip_norm`` is the
    global-norm clip (the JAX ``ClipGradByGlobalNorm``), None for none."""

    state_names = ("moment1", "moment2")

    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, clip_norm=None):
        self.learning_rate = float(learning_rate)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.epsilon = float(epsilon)
        self.weight_decay = float(weight_decay)
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        self.global_step = 0
        self.state: dict[str, dict[str, torch.Tensor]] = {}

    def get_lr(self) -> float:
        return self.learning_rate

    def update(self, p32, g32, states, t):
        """(new_p32, [moment1, moment2]) for float32 p32, g32 and states at
        step ``t`` (1-based). Elementwise, so it takes stacked leaves."""
        new_p, m, v = _adam_update(
            p32, g32, states[0], states[1], _f32(self.get_lr()),
            _f32(self.beta1), _f32(self.beta2), _f32(self.epsilon), _f32(t),
            _f32(self.weight_decay))
        return new_p, [m, v]
