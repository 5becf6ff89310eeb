"""High-level Model API of the port (counterpart of `paddle_tpu/hapi/model.py`;
ref `python/paddle/hapi/model.py:1004` — Model.fit :1696, train_batch :1145;
the dygraph adapter :732 is the only execution path here).

`fit` takes one of two routes, as the JAX `Model.fit` does:

- **fused**: a `models/gpt.py::GPTForCausalLM` trained on its own
  causal-LM loss (no loss fn, no streaming metrics) with a scan-fusable
  optimizer goes through `train/scan_step.py::ScanTrainStep` on the
  network's device: ``accumulate_grad_batches`` loader batches make one
  step of that many microbatches (a ragged group one microbatch), and a
  `CheckpointManager` makes the loop preemption-safe with ``[epoch,
  batch]`` cursors. Where the step refuses the configuration
  (`ScanUnsupported`), fit takes the eager route.
- **eager**: `train_batch` a loader batch, gradients accumulated over
  ``accumulate_grad_batches`` with the loss divided by it; a partial group
  at an epoch's end is rescaled to its own mean before the update.

``prepare(amp_configs=)`` is accepted and unused, as in the JAX package
(ROADMAP C28). `save` / `load` write and read ``PDTPU001`` files
(`framework/io.py`), so each package loads the other's.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.core.autograd import no_grad
from paddle_tpu_torch.io import DataLoader, Dataset

__all__ = ["Model"]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._fused_step = None        # ScanTrainStep when the GPT route took
        self._fused_stale = False      # eager updates happened since capture

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]
        return self

    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            return outputs
        if isinstance(labels, (list, tuple)):
            return self._loss(outputs, *labels)
        return self._loss(outputs, labels)

    def train_batch(self, inputs, labels=None, update=True, loss_divisor=1):
        """One eager train step. ``update=False`` leaves the accumulated
        grads in place (gradient accumulation across calls); pass the
        accumulation count as ``loss_divisor`` so the effective gradient is
        the mean over the k batches, like one k-times-larger batch. The
        reported loss is always the UNdivided per-batch loss."""
        self._sync_fused()
        self._fused_stale = True       # eager update: fused state goes stale
        self.network.train()
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        (loss / float(loss_divisor) if loss_divisor != 1 else loss).backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = []
        for m in self._metrics:
            m.update(m.compute(outputs, labels))
            metrics.append(m.accumulate())
        return ([float(loss.numpy())], metrics) if metrics else \
            [float(loss.numpy())]

    # ---------------------------------------------- fused scanned GPT route

    def _network_computes_loss(self):
        """Networks whose forward(input, labels=...) returns (out, loss) —
        the GPT causal-LM family — evaluate on their OWN loss when no loss
        fn was prepared."""
        from paddle_tpu_torch.models.gpt import GPTForCausalLM
        return isinstance(self.network, GPTForCausalLM)

    def _device(self):
        """The device of the network's parameters: where the fused step
        runs."""
        for p in self.network.parameters():
            return p._data.device
        return None

    def _maybe_fused_step(self, k):
        """A ScanTrainStep when (network, loss, optimizer) fit its envelope:
        a GPTForCausalLM whose OWN causal-LM loss is the objective (loss
        fn None), no streaming metrics (they need logits the fused step
        never materializes). k loader batches concatenate into one step of
        k microbatches (one optimizer apply)."""
        if self._loss is not None or self._metrics or self._optimizer is None:
            return None
        from paddle_tpu_torch.models.gpt import GPTForCausalLM
        from paddle_tpu_torch.train import ScanTrainStep, ScanUnsupported
        if not isinstance(self.network, GPTForCausalLM):
            return None
        if self._fused_step is not None:
            if self._fused_step.microbatches != k:
                self._sync_fused()
                self._fused_step = None
            elif self._fused_stale:
                self._fused_step.refresh_from_model()
                self._fused_stale = False
        if self._fused_step is None:
            try:
                self._fused_step = ScanTrainStep(
                    self.network, self._optimizer, microbatches=k,
                    device=self._device())
                self._fused_stale = False
            except ScanUnsupported:
                return None
        return self._fused_step

    def _sync_fused(self):
        if self._fused_step is not None and self._fused_step.dirty:
            self._fused_step.sync_to_model()

    def _fused_apply(self, fused, buf):
        """Run one fused step over the buffered loader batches. Equal
        batch sizes go as microbatches; a ragged group (drop_last=False
        short final batch) runs as ONE microbatch — still a single
        optimizer apply over all its tokens."""
        arrs = [(np.asarray(ins[0].numpy() if isinstance(ins[0], Tensor)
                            else ins[0]),
                 np.asarray(lab.numpy() if isinstance(lab, Tensor)
                            else lab)) for ins, lab in buf]
        xs = np.concatenate([a for a, _ in arrs])
        ys = np.concatenate([b for _, b in arrs])
        sizes = {a.shape[0] for a, _ in arrs}
        m = len(buf) if len(sizes) == 1 else 1
        return fused.step(xs, ys, microbatches=m)

    @no_grad()
    def eval_batch(self, inputs, labels=None):
        self._sync_fused()
        self.network.eval()
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        if self._loss is None and labels is not None and \
                self._network_computes_loss():
            lab = labels[0] if isinstance(labels, (list, tuple)) else labels
            if not isinstance(lab, Tensor):
                lab = Tensor(np.asarray(lab), place=self._device())
            outputs, loss = self.network(*inputs, labels=lab)
        else:
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels)
        metrics = []
        for m in self._metrics:
            m.update(m.compute(outputs, labels))
            metrics.append(m.accumulate())
        return ([float(loss.numpy())], metrics) if metrics else \
            [float(loss.numpy())]

    @no_grad()
    def predict_batch(self, inputs):
        self._sync_fused()
        self.network.eval()
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        out = self.network(*inputs)
        return [out.numpy()] if isinstance(out, Tensor) else \
            [o.numpy() for o in out]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None,
            checkpoint_manager=None):
        """``checkpoint_manager``: a `train.CheckpointManager` makes the
        fit loop preemption-safe on the fused GPT route — it binds to the
        scanned step, resumes from LATEST (restoring params, optimizer
        state, rng, and the [epoch, batch] cursor; already-consumed
        batches of the resume epoch are skipped, which assumes a
        deterministic loader order — pass shuffle=False or a seeded
        sampler), checkpoints every ``manager.every`` optimizer steps, and
        on SIGTERM (`manager.install_sigterm()`) finishes the current
        accumulation group, writes a final synchronous checkpoint, and
        stops training cleanly. `TooManyBadSteps` from the bad-step ladder
        propagates to the caller with the state already rolled back."""
        from paddle_tpu_torch.hapi.callbacks import config_callbacks
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data

        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=self._len_or_none(train_loader),
                                log_freq=log_freq, save_freq=save_freq,
                                save_dir=save_dir, verbose=verbose,
                                metrics=["loss"] + self._metric_names())
        k = max(1, int(accumulate_grad_batches or 1))
        fused = self._maybe_fused_step(k)
        mgr = checkpoint_manager
        resume_epoch, resume_batch, mgr_cursor = 0, -1, None
        if mgr is not None:
            if fused is None:
                raise ValueError(
                    "checkpoint_manager needs the fused scanned GPT route "
                    "(GPTForCausalLM training on its own causal-LM loss "
                    "with a scan-fusable optimizer and no streaming "
                    "metrics) — the eager per-batch path has no "
                    "preemption-safe capture")
            if isinstance(train_data, Dataset) and shuffle:
                # resume skips batches BY LOADER INDEX: a reshuffled
                # restart would skip different samples than were trained,
                # silently double-training some and dropping others
                raise ValueError(
                    "checkpoint_manager resume replays the loader by "
                    "batch index — pass shuffle=False (or supply your own "
                    "deterministically-ordered DataLoader)")
            mgr.bind(fused)
            restored = mgr.restore()
            if restored is not None:
                cur = restored.get("data_cursor")
                if not (isinstance(cur, (list, tuple)) and len(cur) == 2):
                    # an int cursor (CheckpointManager.run) or a
                    # cursor-less manual save: fit cannot know which
                    # loader batches were consumed — resuming from epoch 0
                    # would silently double-train them
                    raise ValueError(
                        f"checkpoint at {restored['path']} has data_cursor="
                        f"{cur!r}; Model.fit resume needs the [epoch, "
                        "batch] cursor fit itself writes — resume this "
                        "checkpoint with CheckpointManager.run instead")
                resume_epoch, resume_batch = int(cur[0]), int(cur[1])
        logs = {}
        cbks.on_begin("train")
        for epoch in range(epochs):
            if self.stop_training:
                break
            if mgr is not None and epoch < resume_epoch:
                continue          # fully consumed before the preemption
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            buf, pending, last_loss = [], 0, None
            consumed = -1          # last loader index actually trained on
            for step, batch in enumerate(train_loader):
                if num_iters is not None and step >= num_iters:
                    break
                if mgr is not None and epoch == resume_epoch \
                        and step <= resume_batch:
                    continue      # consumed before the preemption (the
                    # cursor lands on group boundaries, so no partial
                    # accumulation group is ever split across a resume)
                consumed = step
                cbks.on_batch_begin("train", step, logs)
                ins, labels = self._split_batch(batch)
                if fused is not None:
                    buf.append((ins, labels))
                    if len(buf) == k:
                        last_loss = self._fused_apply(fused, buf)
                        buf = []
                        if mgr is not None:
                            mgr_cursor = [epoch, step]
                            mgr.after_step(data_cursor=mgr_cursor)
                            if mgr.should_stop:
                                self.stop_training = True
                    # before the first apply there IS no loss yet: omit the
                    # key rather than poison callbacks with NaN
                    logs = (self._result_to_logs([last_loss], step,
                                                 batch_size)
                            if last_loss is not None
                            else {"step": step, "batch_size": batch_size})
                else:
                    update = k == 1 or (step + 1) % k == 0
                    pending = 0 if update else pending + 1
                    result = self.train_batch(ins, labels, update=update,
                                              loss_divisor=k)
                    logs = self._result_to_logs(result, step, batch_size)
                cbks.on_batch_end("train", step, logs)
                if self.stop_training:
                    break         # SIGTERM preemption: group boundary
                    # reached, buf is empty, final checkpoint below
            if fused is not None and buf:
                # leftover partial accumulation group at epoch end
                last_loss = self._fused_apply(fused, buf)
                logs["loss"] = last_loss
                if mgr is not None:
                    # the leftover apply is an optimizer step like any
                    # other: move the cursor past its batches (the last
                    # CONSUMED index) and run the ladder and periodic save,
                    # honouring the stop flag here too
                    mgr_cursor = [epoch, consumed]
                    mgr.after_step(data_cursor=mgr_cursor)
                    if mgr.should_stop:
                        self.stop_training = True
            elif pending:
                # flush generic-path leftover grads: they accumulated as
                # sum(g_i)/k over only `pending` batches — rescale to the
                # mean over the partial group (k/pending) so the final
                # update is not silently undersized
                scale = float(k) / float(pending)
                with no_grad():
                    for p in self._optimizer._parameter_list:
                        g = p._data.grad
                        if g is not None:
                            p._data.grad = g * scale
                self._optimizer.step()
                self._optimizer.clear_grad()
                pending = 0
            if fused is not None:
                self._sync_fused()   # state_dict/parameters see the epoch
            if eval_loader is not None and (epoch + 1) % eval_freq == 0 \
                    and not (mgr is not None and mgr.should_stop):
                # draining on SIGTERM: don't spend the eviction grace
                # window on eval — the final checkpoint below is the
                # contract, the eval can rerun after the resume
                eval_logs = self._run_eval(eval_loader, batch_size)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
        cbks.on_end("train", logs)
        if mgr is not None:
            # drain any in-flight async write and leave a final complete
            # checkpoint — on the SIGTERM path this IS the graceful-drain
            # contract: rc 0 with the trained state durably on disk
            mgr.finalize(data_cursor=mgr_cursor)
        return self

    def _run_eval(self, eval_loader, batch_size):
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in eval_loader:
            ins, labels = self._split_batch(batch)
            result = self.eval_batch(ins, labels)
            loss = result[0] if isinstance(result, tuple) else result
            losses.append(loss[0])
        logs = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            name = m.name()
            acc = m.accumulate()
            if isinstance(name, list):
                for n, a in zip(name, acc if isinstance(acc, list) else [acc]):
                    logs[n] = a
            else:
                logs[name] = acc
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        if isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data
        return self._run_eval(eval_loader, batch_size)

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = test_data
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, predict=True)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    def _split_batch(self, batch, predict=False):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return list(batch[:-1]), batch[-1]
        return [batch], None

    def _metric_names(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _result_to_logs(self, result, step, batch_size):
        logs = {"step": step, "batch_size": batch_size}
        if isinstance(result, tuple):
            loss, metrics = result
            logs["loss"] = loss[0]
            for name, v in zip(self._metric_names(), metrics):
                logs[name] = v
        else:
            logs["loss"] = result[0]
        return logs

    def _len_or_none(self, loader):
        try:
            return len(loader)
        except Exception:
            return None

    def save(self, path, training=True):
        from paddle_tpu_torch.framework import io as fio
        self._sync_fused()
        fio.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        import os
        from paddle_tpu_torch.framework import io as fio
        self.network.set_state_dict(fio.load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(fio.load(opt_path))
        if self._fused_step is not None:
            # re-pull the loaded state NOW (refresh also clears the dirty
            # flag — a later _sync_fused must not write pre-load weights
            # back over the checkpoint we just loaded)
            self._fused_step.refresh_from_model()
        self._fused_stale = False

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from paddle_tpu_torch.hapi import summary as s
        return s(self.network, input_size, dtypes=dtype)
