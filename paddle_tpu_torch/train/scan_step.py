"""The GPT train step (counterpart of
`paddle_tpu/train/scan_step.py::ScanTrainStep`).

One call of `step` is the JAX step's one program, run eagerly:

- forward and backward of `models/gpt.py::scan_loss` over the STACKED
  block leaves, once per microbatch, the gradients accumulated in float32
  and the loss and gradients averaged over the microbatches; with
  ``use_loss_mask`` each microbatch's loss is averaged over its mask;
- the JAX step's key chain: the step holds ``PRNGKey(seed)`` on its
  device and splits it once every step, before anything runs (a step the
  finite check then skips has still advanced it); the step key splits
  into one key per microbatch, each of them `scan_loss`'s ``dropout_key``
  (hidden dropout, `kernels/dropout.py`);
- an all-finite check over the loss and the raw gradients: a step that
  fails it changes nothing, is not counted as an optimizer step, and
  counts in ``bad_steps``;
- the global-norm clip ``clip_norm / max(norm, clip_norm)``;
- the AdamW update of each stacked leaf in float32, on float32 master
  weights where the parameters are held in bfloat16, at ``t = global_step
  + 1``.

Each taken step appends its time, tokens/s and MFU to ``records`` (the
per-step table `chip_smoke.py` reads). MFU is ``analytic_flops_per_token *
tokens / (seconds * peak)`` with the H100 SXM bf16 dense peak from
NVIDIA's data sheet; a CPU step's record holds no MFU.

With ``grad_reducer`` (cross-process data parallelism, the JAX step's
split mode: `train/elastic.py::FleetReducer`) the step hands the loss and
the float32 gradients, before the clip, to the reducer on the host and
runs the finite check, the clip and the update over the values it returns,
so every rank of a fleet skips or applies identically. Without one the
step is what it was. The ``train.step_nan`` fault site (`testing/faults.py`)
poisons the loss as ``inject_nan`` does; in reducer mode the NaN travels
through the reduce, so one rank's injected NaN skips the step on every rank.

`CheckpointManager` (`train/fault_tolerance.py`) reads the state under the
JAX manager's names: `state_trees` gives the parameter and optimizer
trees in the order the JAX step holds them, `key_data` / `set_key_data`
the key chain's two uint32 words (``meta/rng``).

The step also reports to the port's metrics registry and flight recorder
under the JAX step's names (`observability/`): a ``train.dispatch`` event
before any work, ``train.steps`` / ``train.microbatches`` on every step,
``train.bad_steps`` and a ``train.bad_step`` event on a skipped one,
``train.tokens`` and a ``train.step`` event on a taken one. The first step
at an input signature is the JAX step's compile step (here: kernel builds
and the allocator's first touches): ``train.compile_count``,
``train.compile_ms`` and a ``train.compile`` span; every later taken step
sets ``train.step_ms``, ``train.mfu`` and ``train.goodput_tokens_per_s``
and observes ``train.step_seconds``. ``train.mfu`` divides by
``H100_BF16_PEAK`` on the card and by the JAX package's nominal 1e12
FLOP/s on the CPU. `start_watchdog` arms a stall watchdog over the loop.

`Model.fit` (`hapi/model.py`) drives the step over an eager optimizer
(built with ``parameters=``): the step then reads and writes that
optimizer's accumulators and master copies, where the functional form's
live in ``optimizer.state``. `refresh_from_model` re-pulls both after an
update made outside the step; ``dirty`` says the step holds updates the
model has not seen. A (model, optimizer) the step cannot take raises
`ScanUnsupported`, a ValueError, under the JAX step's conditions: not a
`GPTForCausalLM`, attention dropout, an optimizer with no pure update,
L1 decay, or learning rates or weight decays that differ across the
layers of one stacked leaf.

Not ported yet (ROADMAP A8): ZeRO-1 (A8.3), the CUDA graph of the whole
step (A8.4), the other arms of the flash op (A8.5).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from paddle_tpu_torch.core import tensor as tensor_mod
from paddle_tpu_torch.core.tensor import unwrap
from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import (Watchdog,
                                                            default_deadline,
                                                            flight)
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         analytic_flops_per_token, scan_loss,
                                         stack_gpt_params, unstack_gpt_params)
from paddle_tpu_torch.optimizer.optimizer import f32
from paddle_tpu_torch.testing import faults

__all__ = ["H100_BF16_PEAK", "ScanTrainStep", "ScanUnsupported"]

H100_BF16_PEAK = 989e12     # FLOP/s, H100 SXM bf16 dense (NVIDIA data sheet)
CPU_NOMINAL_PEAK = 1e12     # FLOP/s, the JAX package's nominal non-TPU peak


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ScanTrainStep runs on the CUDA card by default and CUDA is "
                "not available here; pass device=\"cpu\" to train with the "
                "plain PyTorch kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class ScanUnsupported(ValueError):
    """(model, optimizer, config) cannot take the scanned fused train-step
    path; callers (`Model.fit`) take the eager route instead."""


def _leaf_keys(tree):
    for grp in ("blocks", "top"):
        for k in tree[grp]:
            yield grp, k


def _leaf_names(grp, key, num_layers):
    """The state_dict names a stacked leaf holds, in layer order."""
    return ([f"gpt.h.{i}.{key}" for i in range(num_layers)]
            if grp == "blocks" else [key])


class ScanTrainStep:
    """Train step for a `models/gpt.py::GPTForCausalLM` (a Paddle Layer,
    whose weights it reads through its ``state_dict``) with a fusable
    optimizer: `optimizer.AdamW` in its functional form (no
    ``parameters``), or any optimizer built over the model's parameters.

    The step holds a copy of the parameters stacked, as leaves on
    ``device``, and the optimizer state beside them, both seeded from the
    model and the optimizer when it is built; ``sync_to_model`` writes them
    back. It holds the dropout key chain ``PRNGKey(seed)`` on ``device``
    too. With ``use_loss_mask`` every step needs a ``loss_mask``.
    ``device=None`` means ``cuda`` and raises where CUDA is absent.
    ``grad_reducer``: optional ``(loss, grads) -> (loss, grads)`` host
    hook over the pre-clip float32 values (``grads`` the
    ``{"blocks", "top"}`` tree), as the JAX step's.
    """

    def __init__(self, model, optimizer, *, microbatches=1,
                 use_loss_mask=False, seed=0, device=None,
                 grad_reducer=None):
        if not isinstance(model, GPTForCausalLM):
            raise ScanUnsupported(
                f"scan train step needs GPTForCausalLM, got "
                f"{type(model).__name__}")
        if model.cfg.attention_dropout:
            raise ScanUnsupported(
                "attention_dropout > 0 has no scan-path implementation "
                "(the JAX scan step refuses it too; ROADMAP A8.1)")
        if not getattr(optimizer, "_FUSABLE", False) or \
                not hasattr(optimizer, "functional_update"):
            raise ScanUnsupported(
                f"{type(optimizer).__name__} has no pure fused update")
        if getattr(optimizer, "_l1_decay", 0.0):
            raise ScanUnsupported("L1 decay is not scan-fusable")
        self.device = _resolve_device(device)
        self.model, self.opt, self.cfg = model, optimizer, model.cfg
        self._state_names, self._update = optimizer.functional_update()
        self.microbatches = max(1, int(microbatches))
        self.use_loss_mask = bool(use_loss_mask)
        self._key = prng.prng_key(seed, self.device)
        self.bad_steps = 0
        self.consecutive_bad_steps = 0
        self.last_step_ok = True
        self.records: list[dict] = []
        self._seen_sigs: set = set()
        self._compiles = 0
        self._ran = False          # any step taken: JAX holds sorted trees
        self._grad_reducer = grad_reducer
        self._dirty = False
        self.refresh_from_model()

    @property
    def dirty(self) -> bool:
        """Steps were taken since the last `sync_to_model` /
        `refresh_from_model`: the model does not hold the step's state."""
        return self._dirty

    @property
    def compile_count(self) -> int:
        """Compile steps counted (one per input signature)."""
        return self._compiles

    def key_data(self) -> np.ndarray:
        """The key chain's two words as uint32, ``jax.random.key_data``
        of the JAX step's key."""
        return self._key.cpu().numpy().astype(np.uint32)

    def set_key_data(self, words):
        """Set the key chain from two uint32 words (a checkpoint's
        ``meta/rng``)."""
        w = np.asarray(words.cpu() if isinstance(words, torch.Tensor)
                       else words).astype(np.int64)
        self._key = torch.from_numpy(w).to(self.device)

    def state_trees(self):
        """(params, optimizer state): the step's trees keyed as the JAX
        step's, in its order — the stacking order before the first step,
        sorted keys after it (a jitted step returns sorted pytrees), so a
        checkpoint's index lists the leaves as the JAX manager's does."""
        if not self._ran:
            return self._params, self._opt_state

        def srt(d):
            return {k: srt(d[k]) for k in sorted(d)} \
                if isinstance(d, dict) else d
        return srt(self._params), srt(self._opt_state)

    def _peak(self) -> float:
        """The MFU denominator of the ``train.mfu`` gauge."""
        return H100_BF16_PEAK if self.device.type == "cuda" \
            else CPU_NOMINAL_PEAK

    def opt_state_bytes(self) -> int:
        """The optimizer state's footprint on the device (one replica)."""
        return sum(v.numel() * v.element_size()
                   for grp in self._opt_state.values()
                   for st in grp.values() for v in st.values())

    # ------------------------------------------------------------- state io

    def _eager_opt(self) -> bool:
        """The optimizer holds parameters (``parameters=``): its state lives
        in its accumulators and master copies, not in ``state``."""
        return self.opt._parameter_list is not None

    def _saved_state(self, name, pobj) -> dict:
        """``{state name: tensor or None}`` the optimizer holds for the
        parameter ``pobj`` (state_dict name ``name``)."""
        if not self._eager_opt():
            return self.opt.state.get(name, {})
        out = {s: self.opt._accumulators.get(s, {}).get(id(pobj))
               for s in self._state_names}
        master = self.opt._master_weights.get(id(pobj))
        if master is None and getattr(pobj, "_master", None) is not None:
            master = pobj._master._data
        out["master"] = master
        return out

    def _leaf_meta(self, objs):
        """Per stacked leaf: the learning-rate multiplier and the weight
        decay the optimizer gives its parameters (one pair for all of a
        leaf's layers, else `ScanUnsupported`), and whether the global-norm
        clip counts its gradient."""
        nl = self.cfg.num_layers
        meta = {}
        for grp, key in _leaf_keys(self._params):
            pobjs = [objs[n] for n in _leaf_names(grp, key, nl)]
            lws = {self.opt._lr_wd_of(p, 1.0) for p in pobjs}
            if len(lws) != 1:
                raise ScanUnsupported(
                    f"per-layer lr/weight-decay differ across the stacked "
                    f"leaf {key!r}: {sorted(lws)} — the scanned step "
                    "updates all layers of a leaf with one (lr, wd)")
            lr_mult, wd = lws.pop()
            meta[(grp, key)] = {
                "lr_mult": float(lr_mult), "wd": float(wd),
                "need_clip": all(getattr(p, "need_clip", True)
                                 for p in pobjs)}
        return meta

    def refresh_from_model(self):
        """(Re)pull the model's parameters onto the device as stacked
        leaves, and stack the optimizer's state beside them: zero moments
        where a parameter has none, and float32 masters (the parameters'
        values where a parameter has none) unless every parameter is
        float32. Called at init and after any update made outside the
        step (hapi's eager batches, ``set_state_dict``, `Model.load`)."""
        objs = dict(self.model.state_dict())
        params = {n: unwrap(t).detach().to(self.device, copy=True)
                  for n, t in objs.items()}
        names = list(self._state_names)
        if any(p.dtype != torch.float32 for p in params.values()):
            names.append("master")
        per_state = {s: {} for s in names}
        for n, p in params.items():
            saved = self._saved_state(n, objs[n])
            for s in names:
                v = saved.get(s)
                if v is None:
                    v = p if s == "master" else torch.zeros_like(p)
                per_state[s][n] = v.to(self.device, torch.float32)
        stacked = {s: stack_gpt_params(d) for s, d in per_state.items()}
        self._params = stack_gpt_params(params)
        self._meta = self._leaf_meta(objs)
        self._opt_state = {"blocks": {}, "top": {}}
        for grp, key in _leaf_keys(self._params):
            self._params[grp][key].requires_grad_(True)
            self._opt_state[grp][key] = {s: stacked[s][grp][key]
                                         for s in names}
        self._dirty = False
        metrics.gauge("train.opt_state_bytes").set(self.opt_state_bytes())
        metrics.gauge("train.zero1").set(0.0)      # ZeRO-1 is ROADMAP A8.3

    def sync_to_model(self):
        """Write the step's parameters into the model and its optimizer
        state into the optimizer: its accumulators and master copies (the
        eager form), or ``optimizer.state`` per state_dict name."""
        params = unstack_gpt_params(self._params)
        objs = dict(self.model.state_dict())
        with torch.no_grad():
            for name, t in objs.items():
                unwrap(t).copy_(params[name])
        nl = self.cfg.num_layers
        for grp, key in _leaf_keys(self._opt_state):
            st = self._opt_state[grp][key]
            for i, n in enumerate(_leaf_names(grp, key, nl)):
                vals = {s: (v[i] if grp == "blocks" else v).detach().clone()
                        for s, v in st.items()}
                if not self._eager_opt():
                    self.opt.state[n] = vals
                    continue
                p = objs[n]
                for s in self._state_names:
                    self.opt._set_accumulator(s, p, vals[s])
                if "master" in vals:
                    tensor_mod.note_write(self.opt._master_weights, id(p))
                    self.opt._master_weights[id(p)] = vals["master"]
        self._dirty = False

    # ------------------------------------------------------------- the step

    def _grads(self, xs, ys, ms=None, keys=None):
        """(mean loss f32, mean f32 grads in `_leaf_keys` order) over the
        microbatches ``xs``, ``ys`` [m, b, S] with masks ``ms`` (or None)
        and dropout keys ``keys`` [m, 2]. Without ``keys``, the keys the
        next `step` will draw, leaving the chain where it is."""
        if keys is None:
            keys = prng.split(prng.split(self._key)[1], xs.shape[0])
        leaves = [self._params[g][k] for g, k in _leaf_keys(self._params)]

        def one(j):
            loss = scan_loss(self._params, xs[j], ys[j], self.cfg,
                             loss_mask=None if ms is None else ms[j],
                             training=True, dropout_key=keys[j])
            return loss.detach(), torch.autograd.grad(loss, leaves)

        if xs.shape[0] == 1:
            loss, g = one(0)
            return loss, [a.float() for a in g]
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        for j in range(xs.shape[0]):
            loss, g = one(j)
            gsum = [a + b.float() for a, b in zip(gsum, g)]
            lsum = lsum + loss
        inv = 1.0 / xs.shape[0]
        return lsum * inv, [a * inv for a in gsum]

    def _reduce(self, loss, grads):
        """The split mode's host leg: the reducer over the loss and the
        ``{"blocks", "top"}`` tree of float32 gradients, its answer back on
        the device in `_leaf_keys` order."""
        keys = list(_leaf_keys(self._params))
        tree = {"blocks": {}, "top": {}}
        for (grp, k), g in zip(keys, grads):
            tree[grp][k] = g
        rloss, rtree = self._grad_reducer(loss, tree)

        def dev(a):
            if isinstance(a, torch.Tensor):
                return a.to(self.device, torch.float32)
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
        return dev(rloss), [dev(rtree[grp][k]) for grp, k in keys]

    @torch.no_grad()
    def _apply(self, grads, t):
        """Global-norm clip, then the AdamW update of every leaf in place."""
        keys = list(_leaf_keys(self._params))
        clip = self.opt.clip_norm
        if clip is not None:
            sq = torch.zeros((), dtype=torch.float32, device=self.device)
            for gk, g in zip(keys, grads):
                if self._meta[gk]["need_clip"]:
                    sq = sq + torch.sum(g ** 2)
            scale = clip / torch.clamp(torch.sqrt(sq), min=clip)
            grads = [g * scale for g in grads]
        names = self._state_names
        lr = f32(self.opt.get_lr())
        t = f32(t)
        for (grp, k), g in zip(keys, grads):
            p, st = self._params[grp][k], self._opt_state[grp][k]
            mt = self._meta[(grp, k)]
            p32 = st["master"] if "master" in st else p
            new_p32, new_st = self._update(p32, g, [st[n] for n in names],
                                           lr * mt["lr_mult"], f32(mt["wd"]),
                                           t)
            st.update(zip(names, new_st))
            if "master" in st:
                st["master"] = new_p32
            p.copy_(new_p32.to(p.dtype))

    def step(self, x, y, loss_mask=None, microbatches=None, *,
             inject_nan=False):
        """One train step. x: [B, S] int token ids, y: [B, S] int labels,
        loss_mask: [B, S] (tensors or arrays; the mask is required with
        ``use_loss_mask`` and ignored without); B must divide by the
        microbatch count (``microbatches``, else the step's own).
        ``inject_nan`` adds NaN to the loss, as the armed
        ``train.step_nan`` fault site does, to drive the skip. Returns the
        mean f32 loss as a Python float."""
        x = torch.as_tensor(x).to(self.device)
        y = torch.as_tensor(y).to(self.device)
        m = self.microbatches if microbatches is None else int(microbatches)
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        xs = x.reshape(m, b // m, *x.shape[1:])
        ys = y.reshape(m, b // m, *y.shape[1:])
        ms = None
        if self.use_loss_mask:
            if loss_mask is None:
                raise ValueError("step built with use_loss_mask=True needs a "
                                 "loss_mask")
            mask = torch.as_tensor(loss_mask).to(self.device)
            ms = mask.reshape(m, b // m, *mask.shape[1:])
        self._key, sub = prng.split(self._key)
        # the dispatch marker comes BEFORE the work: if the step wedges, a
        # watchdog dump's last event shows where
        flight.record("train.dispatch", step=self.opt.global_step + 1,
                      shape=str(tuple(xs.shape)))
        # train.step_nan chaos site: a NaN rides the loss into the finite
        # check (and, in reducer mode, through the reduce)
        injected = bool(inject_nan) or (faults.ENABLED
                                        and faults.fire("train.step_nan"))
        self._ran = True
        t0 = time.perf_counter()
        loss, grads = self._grads(xs, ys, ms, prng.split(sub, m))
        if injected:
            loss = loss + float("nan")
        if self._grad_reducer is not None:
            loss, grads = self._reduce(loss, grads)
        with torch.no_grad():
            ok = torch.stack([torch.isfinite(loss)]
                             + [torch.isfinite(g).all() for g in grads]).all()
        lossf, okb = float(loss), bool(ok)
        self.last_step_ok = okb
        if okb:
            self._apply(grads, self.opt.global_step + 1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        tokens = int(x.numel())
        flops = analytic_flops_per_token(self.cfg, int(x.shape[-1])) * tokens
        mfu = min(1.0, flops / (max(dt, 1e-9) * self._peak()))
        # one compile step per input signature, as the JAX step counts
        # when it cannot read its program cache
        sig = (tuple(xs.shape), tuple(ys.shape), str(xs.dtype))
        compiled = sig not in self._seen_sigs
        self._seen_sigs.add(sig)
        if compiled:
            self._compiles += 1
            metrics.counter("train.compile_count").inc()
            metrics.gauge("train.compile_ms").set(dt * 1e3)
            metrics.add_span("train.compile", t0, dt, cat="compile")
        elif okb:
            # steady steps only: a compile step's time would read as a
            # collapsed MFU
            metrics.gauge("train.step_ms").set(dt * 1e3)
            metrics.histogram("train.step_seconds").observe(dt)
            metrics.gauge("train.mfu").set(mfu)
            metrics.gauge("train.goodput_tokens_per_s").set(
                tokens / max(dt, 1e-9))
        metrics.counter("train.steps").inc()
        metrics.counter("train.microbatches").inc(m)
        if not okb:
            # the step never happened as far as the optimizer clock goes
            self.bad_steps += 1
            self.consecutive_bad_steps += 1
            metrics.counter("train.bad_steps").inc()
            flight.record("train.bad_step", step=self.opt.global_step + 1,
                          loss=lossf, consecutive=self.consecutive_bad_steps,
                          injected=injected)
            return lossf
        self.records.append({
            "step": self.opt.global_step + 1, "loss": lossf,
            "step_ms": dt * 1e3, "tokens_per_s": tokens / dt,
            "mfu": mfu if self.device.type == "cuda" else None})
        self.consecutive_bad_steps = 0
        metrics.counter("train.tokens").inc(tokens)
        flight.record("train.step", step=self.opt.global_step + 1,
                      loss=lossf, ms=round(dt * 1e3, 3),
                      mfu=round(mfu, 5), compiled=bool(compiled))
        self.opt.global_step += 1
        self.opt._sync_lr_tensor(self.opt.get_lr())
        self._dirty = True
        return lossf

    def start_watchdog(self, deadline_s=None, dump_dir=None,
                       interval_s=None):
        """Arm a stall watchdog over the train loop: if `step` stops
        completing (a wedged device call) for ``deadline_s`` (default
        ``PADDLE_WATCHDOG_S``; <= 0 disables and returns None), the flight
        recorder's ring and the metrics snapshot are dumped to a JSON
        file. The caller owns its life: arm it before the loop and
        ``.stop()`` it after; it treats the loop as always busy, so it
        must not outlive a pause longer than the deadline."""
        deadline = default_deadline() if deadline_s is None \
            else float(deadline_s)
        if deadline <= 0:
            return None
        return Watchdog("train", progress=lambda: self.opt.global_step,
                        deadline_s=deadline, dump_dir=dump_dir,
                        interval_s=interval_s).start()
