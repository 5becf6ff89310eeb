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

Not ported yet (ROADMAP A8): ZeRO-1 and the cross-process grad reducer
(A8.3), the CUDA graph of the whole step (A8.4), the other arms of the
flash op (A8.5).
"""
from __future__ import annotations

import time

import torch

from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import (Watchdog,
                                                            default_deadline,
                                                            flight)
from paddle_tpu_torch.models.gpt import (analytic_flops_per_token,
                                         check_trainable, scan_loss,
                                         stack_gpt_params, unstack_gpt_params)

__all__ = ["H100_BF16_PEAK", "ScanTrainStep"]

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


def _leaf_keys(tree):
    for grp in ("blocks", "top"):
        for k in tree[grp]:
            yield grp, k


class ScanTrainStep:
    """Train step for a `models/gpt.py::GPTForCausalLM` with an
    `optimizer.AdamW`.

    The step holds a copy of the parameters stacked, as leaves on
    ``device``, and the optimizer state beside them, both seeded from the
    model and the optimizer when it is built; ``sync_to_model`` writes them
    back. It holds the dropout key chain ``PRNGKey(seed)`` on ``device``
    too. With ``use_loss_mask`` every step needs a ``loss_mask``.
    ``device=None`` means ``cuda`` and raises where CUDA is absent.
    """

    def __init__(self, model, optimizer, *, microbatches=1,
                 use_loss_mask=False, seed=0, device=None):
        self.device = _resolve_device(device)
        check_trainable(model.cfg)
        self.model, self.opt, self.cfg = model, optimizer, model.cfg
        self.microbatches = max(1, int(microbatches))
        self.use_loss_mask = bool(use_loss_mask)
        self._key = prng.prng_key(seed, self.device)
        self.bad_steps = 0
        self.consecutive_bad_steps = 0
        self.last_step_ok = True
        self.records: list[dict] = []
        self._seen_sigs: set = set()
        self._load_state()

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

    def _load_state(self):
        """Copy the model's parameters onto the device as stacked leaves, and
        stack the optimizer state beside them from ``optimizer.state``:
        zero moments where a name has none, and float32 masters (the
        parameters' values where a name has none) unless every parameter
        is float32."""
        params = {n: t.detach().to(self.device, copy=True)
                  for n, t in self.model.state_dict().items()}
        names = list(self.opt.state_names)
        if any(p.dtype != torch.float32 for p in params.values()):
            names.append("master")
        per_state = {s: {} for s in names}
        for n, p in params.items():
            saved = self.opt.state.get(n, {})
            for s in names:
                v = saved.get(s)
                if v is None:
                    v = p if s == "master" else torch.zeros_like(p)
                per_state[s][n] = v.to(self.device, torch.float32)
        stacked = {s: stack_gpt_params(d) for s, d in per_state.items()}
        self._params = stack_gpt_params(params)
        self._opt_state = {"blocks": {}, "top": {}}
        for grp, key in _leaf_keys(self._params):
            self._params[grp][key].requires_grad_(True)
            self._opt_state[grp][key] = {s: stacked[s][grp][key]
                                         for s in names}
        metrics.gauge("train.opt_state_bytes").set(self.opt_state_bytes())
        metrics.gauge("train.zero1").set(0.0)      # ZeRO-1 is ROADMAP A8.3

    def sync_to_model(self):
        """Write the step's parameters into the model and its optimizer state
        into ``optimizer.state``, per state_dict name."""
        params = unstack_gpt_params(self._params)
        with torch.no_grad():
            for name, t in self.model.state_dict().items():
                t.copy_(params[name])
        nl = self.cfg.num_layers
        for grp, key in _leaf_keys(self._opt_state):
            st = self._opt_state[grp][key]
            names = ([f"gpt.h.{i}.{key}" for i in range(nl)]
                     if grp == "blocks" else [key])
            for i, n in enumerate(names):
                self.opt.state[n] = {
                    s: (v[i] if grp == "blocks" else v).detach().clone()
                    for s, v in st.items()}

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

    @torch.no_grad()
    def _apply(self, grads, t):
        """Global-norm clip, then the AdamW update of every leaf in place."""
        keys = list(_leaf_keys(self._params))
        clip = self.opt.clip_norm
        if clip is not None:
            sq = torch.zeros((), dtype=torch.float32, device=self.device)
            for g in grads:
                sq = sq + torch.sum(g ** 2)
            scale = clip / torch.clamp(torch.sqrt(sq), min=clip)
            grads = [g * scale for g in grads]
        names = list(self.opt.state_names)
        for (grp, k), g in zip(keys, grads):
            p, st = self._params[grp][k], self._opt_state[grp][k]
            p32 = st["master"] if "master" in st else p
            new_p32, new_st = self.opt.update(p32, g,
                                              [st[n] for n in names], t)
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
        ``inject_nan`` adds NaN to the loss, the counterpart of the JAX
        step's ``train.step_nan`` fault, to drive the skip. Returns the mean
        f32 loss as a Python float."""
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
        t0 = time.perf_counter()
        loss, grads = self._grads(xs, ys, ms, prng.split(sub, m))
        if inject_nan:
            loss = loss + float("nan")
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
                          injected=bool(inject_nan))
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
