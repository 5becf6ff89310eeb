"""Optimizer base (counterpart of `paddle_tpu/optimizer/optimizer.py`).

An optimizer built with ``parameters=`` (a Layer's Paddle Parameters, or
param groups) updates them eagerly: ``step()`` reads each ``.grad``, clips
by global norm when asked, and applies the optimizer's update under
``no_grad``, writing the new value into the parameter's torch leaf in
place. The update is the optimizer's ``_fused_update(p32, g32, states, lr,
wd, t)``, the JAX package's fused rule (float32 values and states, with
Python-float coefficients where the JAX rule has them), applied one
parameter at a time: it is elementwise, so the JAX package's flat
concatenation gives the same numbers. The same rule is the scanned train
step's (`functional_update`), so one update serves both paths.

Built without ``parameters`` an optimizer is the functional form a
`train/scan_step.py::ScanTrainStep` drives: the step keeps the parameters
and reads the hyperparameters and ``state`` (``{state_dict name: {state
name: tensor}}``) from here; ``step()`` then raises.

The learning rate and the step count reach the update as 0-d float32
tensors on the parameters' device, ``_lr_tensor`` and ``_step_tensor``
(the JAX package's, `paddle_tpu/optimizer/optimizer.py:64-66`): outside a
`jit.to_static` step ``step()`` writes the host's values into them; inside
one the step count advances on the device and the rate is what was last
synced (``set_lr``, a bound scheduler's ``step()``), so a captured CUDA
graph bakes neither. ``amp.decorate(level="O2")`` sets
``_use_master_weights``: a parameter that is not float32 is then updated
through a float32 master copy, made from the copy ``decorate`` kept
(``p._master``). Every read and rebind of an accumulator or master copy
goes through the capture hooks of `core/tensor.py`, so `jit.to_static`
finds them as the step's state.

``grad_clip`` (any object with a ``clip_norm`` attribute, such as the JAX
package's ``ClipGradByGlobalNorm``; `AdamW` also takes the number as
``clip_norm``) clips by global norm: ``g * clip / max(norm, clip)`` over the
parameters whose ``need_clip`` is not False. Learning rates are a float or
an `optimizer/lr.py` scheduler.
"""
from __future__ import annotations

import collections

import torch

from paddle_tpu_torch.core import tensor as tensor_mod
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Optimizer", "f32"]


def f32(x) -> torch.Tensor:
    """A 0-d float32 tensor on the host: the update's scalar inputs, which
    multiply tensors on either device without a copy."""
    return torch.tensor(float(x), dtype=torch.float32)


class Optimizer:
    _FUSABLE = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._parameter_list = None if parameters is None \
            else list(parameters)
        self._param_groups = None
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            self._param_groups = self._parameter_list
            self._parameter_list = [p for g in self._param_groups
                                    for p in g["params"]]
        self._learning_rate = learning_rate
        self._l1_decay = 0.0
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
        else:
            # a regularizer object: L2 rides the update's decay term, L1
            # adds sign(p) * coeff to the gradient
            coeff = float(getattr(weight_decay, "_coeff",
                                  getattr(weight_decay, "coeff", 0.0)))
            if getattr(weight_decay, "_kind", "l2") == "l1":
                self._l1_decay, self._weight_decay = coeff, 0.0
            else:
                self._weight_decay = coeff
        clip_norm = None
        if grad_clip is not None:
            clip_norm = getattr(grad_clip, "clip_norm", None)
            if clip_norm is None:
                raise NotImplementedError(
                    f"grad_clip={type(grad_clip).__name__}: only global-norm "
                    "clipping (an object with clip_norm) is ported")
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        self._accumulators: dict = collections.defaultdict(dict)
        self._master_weights: dict = {}
        self._use_master_weights = False
        self._global_step = 0
        # made at the first step, on the parameters' device
        self._lr_tensor = None
        self._step_tensor = None
        self._name = name or type(self).__name__
        self.state: dict = {}
        if isinstance(self._learning_rate, LRScheduler):
            self._learning_rate._bind_optimizer(self)

    # ------------------------------------------------------------- lr

    @property
    def learning_rate(self):
        return self._learning_rate

    @learning_rate.setter
    def learning_rate(self, value):
        self._learning_rate = value

    @property
    def global_step(self) -> int:
        return self._global_step

    @global_step.setter
    def global_step(self, value):
        self._global_step = int(value)

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when the lr is an "
                               "LRScheduler; call scheduler.step() instead")
        self._learning_rate = float(value)
        self._sync_lr_tensor(self._learning_rate)

    def _sync_lr_tensor(self, value):
        if self._lr_tensor is not None and not tensor_mod.in_capture():
            self._lr_tensor._data.fill_(float(value))

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler
        scheduler._bind_optimizer(self)

    # ------------------------------------------------------------- rules

    def _fused_state_names(self):
        return []

    def _functional_state_init(self, name, like: torch.Tensor):
        return torch.zeros(like.shape, dtype=torch.float32,
                           device=like.device)

    def _fused_update(self, p32, g32, states, lr, wd, t):
        """(new_p32, new_states) for float32 p32, g32 and states; lr, wd and
        t are 0-d float32 tensors. Elementwise."""
        raise NotImplementedError

    def functional_update(self):
        """(state_names, update_fn) of the pure update, which the scanned
        train step applies to stacked leaves."""
        if not self._FUSABLE:
            raise ValueError(
                f"{type(self).__name__} has no pure fused update (per-tensor "
                "trust ratios etc.); the scanned train step cannot fuse it")
        return list(self._fused_state_names()), self._fused_update

    # ------------------------------------------------------------- state

    def _accumulator(self, name, p, init=None):
        store = self._accumulators[name]
        if id(p) not in store:
            tensor_mod.note_write(store, id(p))
            store[id(p)] = self._functional_state_init(name, p._data) \
                if init is None else init
        else:
            tensor_mod.note_read(store, id(p))
        return store[id(p)]

    def _set_accumulator(self, name, p, value):
        store = self._accumulators[name]
        tensor_mod.note_write(store, id(p))
        store[id(p)] = value

    def _src(self, p):
        """The float32 value the update runs on: the master copy of a
        parameter that has one (made here under master weights from the
        copy `amp.decorate` kept), else the parameter."""
        store = self._master_weights
        if id(p) not in store and self._use_master_weights and \
                p._data.dtype != torch.float32:
            kept = getattr(p, "_master", None)
            tensor_mod.note_write(store, id(p))
            store[id(p)] = (kept._data if kept is not None
                            else p._data).detach().float()
        m = store.get(id(p))
        if m is None:
            return p._data.detach().float()
        tensor_mod.note_read(store, id(p))
        return m

    def _commit(self, p, new32):
        if id(p) in self._master_weights:
            tensor_mod.note_write(self._master_weights, id(p))
            self._master_weights[id(p)] = new32
        p._data.copy_(new32.to(p._data.dtype))

    def _lr_step(self):
        """(lr, t): the rate and the step count as 0-d float32 tensors on
        the parameters' device. Outside a `to_static` step they take the
        host's values; inside one the count advances on the device."""
        if self._lr_tensor is None:
            dev = self._parameter_list[0]._data.device
            self._lr_tensor = Tensor(torch.tensor(
                self.get_lr(), dtype=torch.float32, device=dev),
                _internal=True)
            self._step_tensor = Tensor(torch.tensor(
                self._global_step - 1, dtype=torch.int64, device=dev),
                _internal=True)
            self._lr_tensor.persistable = True
            self._step_tensor.persistable = True
        if tensor_mod.in_capture():
            self._step_tensor._write(self._step_tensor._data + 1)
        else:
            self._lr_tensor._data.fill_(self.get_lr())
            self._step_tensor._data.fill_(self._global_step)
        tensor_mod.note_read(self._lr_tensor)
        return self._lr_tensor._data, self._step_tensor._data.float()

    # ------------------------------------------------------------- step

    def _param_group_of(self, p):
        if self._param_groups is None:
            return None
        for g in self._param_groups:
            if any(q is p for q in g["params"]):
                return g
        return None

    def _lr_wd_of(self, p, lr):
        group = self._param_group_of(p)
        wd = self._weight_decay
        if group is not None:
            lr = lr * float(group.get("learning_rate", 1.0))
            gwd = group.get("weight_decay", wd)
            wd = float(gwd) if gwd is not None else wd
        if hasattr(p, "optimize_attr"):
            lr = lr * float(p.optimize_attr.get("learning_rate", 1.0))
        return lr, wd

    def _params_grads(self):
        if self._parameter_list is None:
            raise RuntimeError(
                f"{type(self).__name__} was built without parameters= (the "
                "functional form a ScanTrainStep drives); pass "
                "parameters=model.parameters() to step eagerly")
        for p in self._parameter_list:
            tensor_mod.note_read(p)
        return [(p, p._data.grad) for p in self._parameter_list
                if not p.stop_gradient and p._data.grad is not None]

    def _clip(self, pgs):
        if self.clip_norm is None:
            return pgs
        clipped = [g for p, g in pgs if getattr(p, "need_clip", True)]
        if not clipped:
            return pgs
        sq = sum(torch.sum(g.float() ** 2) for g in clipped)
        c = self.clip_norm
        scale = c / torch.clamp(torch.sqrt(sq), min=c)
        return [(p, (g * scale).to(g.dtype)
                 if getattr(p, "need_clip", True) else g) for p, g in pgs]

    @torch.no_grad()
    def step(self):
        pgs = self._params_grads()
        if self._l1_decay:
            c = self._l1_decay
            pgs = [(p, g + c * torch.sign(p._data).to(g.dtype))
                   for p, g in pgs]
        pgs = self._clip(pgs)
        self._global_step += 1
        if not pgs:
            return
        lr, t = self._lr_step()
        for p, g in pgs:
            plr, wd = self._lr_wd_of(p, lr)
            self._update_param(p, g, plr, f32(wd), t)

    def _update_param(self, p, g, lr, wd, t):
        names = self._fused_state_names()
        states = [self._accumulator(n, p) for n in names]
        new_p, new_states = self._fused_update(self._src(p), g.float(),
                                               states, lr, wd, t)
        for n, s in zip(names, new_states):
            self._set_accumulator(n, p, s)
        self._commit(p, new_p)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    def clear_grad(self, set_to_zero=False):
        """Drop every parameter's gradient (the JAX package's default), or
        zero it in place with ``set_to_zero``."""
        for p in self._parameter_list or ():
            p.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    # ------------------------------------------------------------- ckpt

    def _param_keys(self):
        """Per-parameter checkpoint keys: each parameter's name, positional
        where it has none or shares one."""
        keys, seen = [], set()
        for i, p in enumerate(self._parameter_list or ()):
            k = getattr(p, "name", "") or f"param_{i}"
            if k in seen:
                k = f"{k}__{i}"
            seen.add(k)
            keys.append(k)
        return keys

    def state_dict(self):
        """``{f"{param name}_{state}_0": Tensor, "global_step": int,
        "__param_keys__": [...], "LR_Scheduler": ...}``, the JAX package's
        layout."""
        sd = {}
        pkeys = self._param_keys()
        for name, store in self._accumulators.items():
            for pk, p in zip(pkeys, self._parameter_list or ()):
                if id(p) in store:
                    sd[f"{pk}_{name}_0"] = Tensor(store[id(p)],
                                                  _internal=True)
        for pk, p in zip(pkeys, self._parameter_list or ()):
            if id(p) in self._master_weights:
                sd[f"{pk}_master_0"] = Tensor(self._master_weights[id(p)],
                                              _internal=True)
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["global_step"] = self._global_step
        sd["__param_keys__"] = pkeys
        return sd

    def set_state_dict(self, state_dict):
        """Load a `state_dict` (this package's or the JAX package's: values
        may be Tensors of either, torch tensors or arrays), matching
        entries to parameters by name, or by position in the saved
        ``__param_keys__`` where the names differ."""
        pkeys = self._param_keys()
        params = self._parameter_list or []

        def as_torch(v, p):
            if isinstance(v, Tensor):
                v = v._data
            elif not isinstance(v, torch.Tensor):
                import numpy as np
                v = torch.from_numpy(np.array(np.asarray(v)))
            return v.detach().to(p._data.device).clone()

        saved = state_dict.get("__param_keys__")
        groups = list(saved) if saved is not None else pkeys
        by_param = {pk: {} for pk in groups}
        ordered = sorted(by_param, key=len, reverse=True)
        for key, v in state_dict.items():
            if key in ("LR_Scheduler", "global_step", "__param_keys__") \
                    or not key.endswith("_0"):
                continue
            for pk in ordered:
                if key.startswith(f"{pk}_"):
                    by_param[pk][key[len(pk) + 1:-2]] = v
                    break
        for i, (pk, p) in enumerate(zip(pkeys, params)):
            entries = by_param.get(pk)
            if not entries and saved is not None and i < len(saved):
                entries = by_param.get(saved[i], {})
            for name, v in (entries or {}).items():
                if name == "master":
                    self._master_weights[id(p)] = as_torch(v, p).float()
                else:
                    self._accumulators[name][id(p)] = as_torch(v, p)
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        self._global_step = int(state_dict.get("global_step", 0))
        if self._step_tensor is not None:
            self._step_tensor._data.fill_(self._global_step)
            self._sync_lr_tensor(self.get_lr())

    load_state_dict = set_state_dict
