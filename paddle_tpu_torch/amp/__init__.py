"""paddle.amp: ``auto_cast``, ``decorate`` and ``GradScaler`` (counterpart
of `paddle_tpu/amp/__init__.py`).

``auto_cast`` sets the state the cast sites read (`amp/state.py`).
``decorate(level="O2")`` casts a model's floating parameters to the AMP
dtype and keeps a float32 copy of each (``p._master``), from which the
optimizer makes its master weights (`optimizer/optimizer.py::_src`), as
the JAX package does. The GradScaler is the JAX package's: per optimizer
INIT / UNSCALED / STEPPED states, dynamic loss scaling, eager only (its
overflow check reads the gradients on the host).

float16 on the card: the flash kernels take float32 and bfloat16 only, so
a float16 autocast that reaches attention on the card raises before any
launch (`kernels/flash_attention.py`); the float16 arms are ROADMAP A10.
"""
from __future__ import annotations

import contextlib

import torch

from paddle_tpu_torch.amp.state import amp_state, WHITE_LIST, BLACK_LIST  # noqa: F401
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler",
           "WHITE_LIST", "BLACK_LIST"]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    st = amp_state()
    prev = (st.enabled, st.level, st.dtype, st.custom_white, st.custom_black)
    st.enabled = enable
    st.level = level
    st.dtype = dtype_mod.convert_dtype(dtype)
    st.custom_white = set(custom_white_list or ())
    st.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (st.enabled, st.level, st.dtype, st.custom_white, st.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast each model's floating parameters to ``dtype``, keeping the
    float32 value as ``p._master``, and switch the optimizers to master
    weights. O1 changes nothing. Returns ``models`` or ``(models,
    optimizers)``."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        d = dtype_mod.convert_dtype(dtype)
        for m in model_list:
            for p in m.parameters():
                if p._data.is_floating_point():
                    p._master = Tensor(p._data.detach().clone(),
                                       _internal=True)     # fp32 master copy
                    p._write(p._data.detach().to(d))
        if optimizers is not None:
            opt_list = [optimizers] if not isinstance(optimizers,
                                                      (list, tuple)) \
                else list(optimizers)
            for opt in opt_list:
                opt._use_master_weights = True
    if optimizers is None:
        return models
    return models, optimizers


class _OptState:
    """Per-optimizer scaler state (ref `amp/grad_scaler.py` OptimizerState)."""
    INIT, UNSCALED, STEPPED = 0, 1, 2


class GradScaler:
    """Dynamic loss scaler (ref: `python/paddle/amp/grad_scaler.py:26`).

    Tracks per-optimizer INIT/UNSCALED/STEPPED state, so the documented
    ``unscale_(); clip; step(); update()`` pattern never double-unscales,
    and step-after-step raises. ``update()`` resets the states and is left
    to the caller (``minimize`` bundles step + update). Eager only: the
    overflow check reads the gradients on the host, so a `to_static` step
    uses bfloat16 autocast without a scaler."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False            # any optimizer overflowed this round
        self._optimizer_states: dict[int, int] = {}
        self._found_inf_per_opt: dict[int, bool] = {}

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        st = self._optimizer_states.get(id(optimizer), _OptState.INIT)
        if st == _OptState.UNSCALED:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer since "
                "the last update()")
        if st == _OptState.STEPPED:
            raise RuntimeError("unscale_() is being called after step()")
        inv = 1.0 / self._scale
        found = False
        with torch.no_grad():
            for p in optimizer._parameter_list or ():
                g = p._data.grad
                if g is not None:
                    g.mul_(inv)
                    found = found or not bool(torch.isfinite(g).all())
        self._found_inf_per_opt[id(optimizer)] = found
        self._found_inf = self._found_inf or found
        self._optimizer_states[id(optimizer)] = _OptState.UNSCALED

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        st = self._optimizer_states.get(id(optimizer), _OptState.INIT)
        if st == _OptState.STEPPED:
            raise RuntimeError(
                "step() has already been called since the last update()")
        if st == _OptState.INIT:
            self.unscale_(optimizer)
        # the skip decision is per optimizer: another optimizer's finite
        # unscale must not launder THIS optimizer's inf grads into a step
        if not self._found_inf_per_opt.get(id(optimizer), self._found_inf):
            optimizer.step()
        self._optimizer_states[id(optimizer)] = _OptState.STEPPED

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        if not self._enable:
            return
        if self._dynamic:
            if self._found_inf:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every_n:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every_n_steps:
                    self._scale *= self._incr_ratio
                    self._good_steps = 0
        self._found_inf = False
        self._optimizer_states.clear()
        self._found_inf_per_opt.clear()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
