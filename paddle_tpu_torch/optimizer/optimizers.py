"""The optimizers (counterpart of `paddle_tpu/optimizer/optimizers.py`):
SGD, Momentum, Adam, AdamW, Adagrad, Adamax, Adadelta, RMSProp, Lamb and
LarsMomentum.

Each elementwise optimizer's ``_fused_update`` is the JAX package's
``_fused_update`` op for op, in float32. Adam and AdamW share `_adam_update`,
the scanned train step's update too (`Optimizer.functional_update`): its
scalar coefficients (1 - beta, beta ** t) are computed in float32 as JAX
computes them, then passed to the tensor ops as the Python floats holding those
float32 values (`torch.optim.AdamW` applies the decay before the moments
and adds eps in another place, which would cost parity). Lamb and
LarsMomentum need per-tensor norms and update one parameter at a time.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer, f32

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Adamax",
           "Adadelta", "RMSProp", "Lamb", "LarsMomentum"]


def _adam_update(p32, g32, m, v, vhat, lr, beta1, beta2, eps, t, wd,
                 decouple, amsgrad):
    """One Adam / AdamW step on float32 p32, g32, m, v (and vhat with
    ``amsgrad``); beta1, beta2, eps and wd are 0-d float32 tensors on the
    host, lr and t 0-d float32 tensors on the host or on p32's device (the
    optimizer's `_lr_step`, which a captured step reads on the card).
    Returns (new_p32, m, v, vhat)."""
    c1, c2 = float(1 - beta1), float(1 - beta2)
    b1, b2 = float(beta1), float(beta2)
    if not decouple:
        g32 = g32 + float(wd) * p32
    m = b1 * m + c1 * g32
    v = b2 * v + c2 * g32 * g32
    mhat = m / (1 - torch.pow(b1, t))
    vv = v / (1 - torch.pow(b2, t))
    if amsgrad:
        vhat = torch.maximum(vhat, vv)
        denom = torch.sqrt(vhat) + float(eps)
    else:
        denom = torch.sqrt(vv) + float(eps)
    upd = mhat / denom
    if decouple:
        upd = upd + float(wd) * p32
    return p32 - lr * upd, m, v, vhat


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _fused_update(self, p32, g32, states, lr, wd, t):
        return p32 - lr * (g32 + wd * p32), []


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _fused_state_names(self):
        return ["velocity"]

    def _fused_update(self, p32, g32, states, lr, wd, t):
        g = g32 + wd * p32
        v = self._momentum * states[0] + g
        if self._use_nesterov:
            return p32 - (g + self._momentum * v) * lr, [v]
        return p32 - lr * v, [v]


class Adam(Optimizer):
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _fused_state_names(self):
        return (["moment1", "moment2", "moment2_max"] if self._amsgrad
                else ["moment1", "moment2"])

    def _fused_update(self, p32, g32, states, lr, wd, t):
        vhat = states[2] if self._amsgrad else None
        new_p, m, v, vhat = _adam_update(
            p32, g32, states[0], states[1], vhat, lr, f32(self._beta1),
            f32(self._beta2), f32(self._epsilon), t, wd, self._decoupled,
            self._amsgrad)
        return new_p, ([m, v, vhat] if self._amsgrad else [m, v])


class AdamW(Adam):
    """Adam with decoupled weight decay (0.01 unless given), optionally only
    where ``apply_decay_param_fun(param.name)`` holds, and a per-parameter
    ``lr_ratio(param)``. ``clip_norm`` is the global-norm clip as a number,
    the spelling `train/scan_step.py::ScanTrainStep`'s callers use."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None, clip_norm=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        if clip_norm is not None:
            self.clip_norm = float(clip_norm)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _lr_wd_of(self, p, lr):
        lr, wd = super()._lr_wd_of(p, lr)
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(p.name):
            wd = 0.0
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        return lr, wd


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _fused_state_names(self):
        return ["moment"]

    def _functional_state_init(self, name, like):
        return torch.full(like.shape, float(self._init_acc),
                          dtype=torch.float32, device=like.device)

    def _fused_update(self, p32, g32, states, lr, wd, t):
        g = g32 + wd * p32
        moment = states[0] + g * g
        return p32 - lr * g / (torch.sqrt(moment) + self._epsilon), [moment]


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _fused_state_names(self):
        return ["moment", "inf_norm"]

    def _fused_update(self, p32, g32, states, lr, wd, t):
        g = g32 + wd * p32
        m = self._beta1 * states[0] + (1 - self._beta1) * g
        inf = torch.maximum(self._beta2 * states[1], torch.abs(g))
        new_p = p32 - (lr / (1 - self._beta1 ** t)) * m / \
            (inf + self._epsilon)
        return new_p, [m, inf]


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _fused_state_names(self):
        return ["avg_squared_grad", "avg_squared_update"]

    def _fused_update(self, p32, g32, states, lr, wd, t):
        g = g32 + wd * p32
        avg_sq = self._rho * states[0] + (1 - self._rho) * g * g
        upd = torch.sqrt(states[1] + self._epsilon) / \
            torch.sqrt(avg_sq + self._epsilon) * g
        avg_upd = self._rho * states[1] + (1 - self._rho) * upd * upd
        return p32 - lr * upd, [avg_sq, avg_upd]


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _fused_state_names(self):
        return ["mean_square", "momentum", "mean_grad"]

    def _fused_update(self, p32, g32, states, lr, wd, t):
        rho, eps, mom_c = f32(self._rho), f32(self._epsilon), f32(self._momentum)
        g = g32 + wd * p32
        mean_sq = rho * states[0] + (1 - rho) * g * g
        mean_g = states[2]
        if self._centered:
            mean_g = rho * mean_g + (1 - rho) * g
            denom = torch.sqrt(mean_sq - mean_g * mean_g + eps)
        else:
            denom = torch.sqrt(mean_sq + eps)
        mom = mom_c * states[1] + lr * g / denom
        return p32 - mom, [mean_sq, mom, mean_g]


class Lamb(Optimizer):
    """LAMB: Adam moments and a per-tensor trust ratio ``|p| / |r|``."""

    _FUSABLE = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _fused_state_names(self):
        return ["moment1", "moment2"]

    def _update_param(self, p, g, lr, wd, t):
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = f32(0.0)
        m = self._accumulator("moment1", p)
        v = self._accumulator("moment2", p)
        b1, b2 = f32(self._beta1), f32(self._beta2)
        p32, g32 = self._src(p), g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        r = mhat / (torch.sqrt(vhat) + f32(self._epsilon)) + wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        self._set_accumulator("moment1", p, m)
        self._set_accumulator("moment2", p, v)
        self._commit(p, p32 - lr * trust * r)


class LarsMomentum(Momentum):
    """LARS: Momentum with a per-tensor local rate ``lr * coeff * |p| /
    (|g| + wd |p| + eps)``."""

    _FUSABLE = False

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        super().__init__(learning_rate, momentum, parameters,
                         weight_decay=lars_weight_decay, grad_clip=grad_clip)
        self._lars_coeff = lars_coeff
        self._lars_epsilon = epsilon

    def _update_param(self, p, g, lr, wd, t):
        p32 = self._src(p)
        w_norm = torch.linalg.vector_norm(p._data.float())
        g_norm = torch.linalg.vector_norm(g.float())
        scaled = lr * self._lars_coeff * w_norm / (
            g_norm + wd * w_norm + self._lars_epsilon)
        local_lr = torch.where((w_norm > 0) & (g_norm > 0), scaled,
                               lr.to(scaled.device))
        # the JAX Momentum update with the local rate, in the parameter's
        # dtype (float32 here)
        vel = self._accumulator("velocity", p)
        gg = g.float() + wd * p32
        v = self._momentum * vel + gg
        if self._use_nesterov:
            new_p = p32 - (gg + self._momentum * v) * local_lr
        else:
            new_p = p32 - local_lr * v
        self._set_accumulator("velocity", p, v)
        self._commit(p, new_p)
