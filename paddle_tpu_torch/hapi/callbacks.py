"""Callbacks of the port's `Model` (counterpart of
`paddle_tpu/hapi/callbacks.py`; ref `python/paddle/hapi/callbacks.py` —
ProgBarLogger, ModelCheckpoint, EarlyStopping, LRScheduler, VisualDL).
`LRScheduler` steps the port's `optimizer/lr.py` schedulers; `VisualDL`
writes JSON lines and reads the port's metrics registry
(`observability`)."""
from __future__ import annotations

import numbers
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin", lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end", lambda s, l=None: None)(step, logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            c.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            c.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_begin(mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_end(mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self.epoch = 0
        self._start = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = []
            for k, v in (logs or {}).items():
                if isinstance(v, numbers.Number) and k not in ("step",
                                                               "batch_size"):
                    items.append(f"{k}: {v:.4f}")
            print(f"Epoch {self.epoch} step {step} " + " ".join(items),
                  flush=True)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            items = [f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                     if isinstance(v, numbers.Number) and k not in (
                         "step", "batch_size")]
            print(f"Epoch {epoch} done in {dt:.1f}s " + " ".join(items),
                  flush=True)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and epoch % self.save_freq == 0:
            import os
            path = os.path.join(self.save_dir, str(epoch))
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            import os
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.cmp = lambda cur, best: cur > best + self.min_delta
        else:
            self.cmp = lambda cur, best: cur < best - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            cur = (logs or {}).get(f"eval_{self.monitor}")
        if cur is None:
            return
        if self.best is None or self.cmp(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        from paddle_tpu_torch.optimizer.lr import LRScheduler as Sched
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                   "metrics": metrics or []})
    return cl


class VisualDL(Callback):
    """Scalar-metrics logging callback (ref `hapi/callbacks.py:880`
    VisualDL). The reference writes VisualDL event files; this build keeps
    the callback contract (same tags ``train/<metric>`` per train step,
    ``eval/<metric>`` per epoch, rank-0-only writes) but logs to plain
    JSON-lines files under ``log_dir`` — readable by anything, no
    visualdl dependency. One line per scalar:
    ``{"tag": "train/loss", "step": 12, "value": 0.53}``.

    Also reads the process metrics registry
    (paddle_tpu_torch.observability): at each epoch end the counters and
    gauges land as ``metrics/<name>`` scalars, so compile counts, cache hit rates, collective bytes and dataloader
    latency ride the same scalar stream as the losses."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self.epoch = 0
        self.train_step = 0
        self._fh = None
        self._last_registry_step = None

    def _is_write(self):
        from paddle_tpu_torch.distributed.parallel import get_rank
        return get_rank() == 0

    def _writer(self):
        if self._fh is None:
            import os
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "scalars.jsonl"),
                            "a", buffering=1)
        return self._fh

    def _updates(self, logs, mode, step):
        if not self._is_write():
            return
        import json
        fh = self._writer()
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)) and v:
                v = v[0]
            if not isinstance(v, numbers.Number) or k in ("step",
                                                          "batch_size"):
                continue
            fh.write(json.dumps({"tag": f"{mode}/{k}", "step": int(step),
                                 "value": float(v)}) + "\n")

    def _emit_registry(self, step):
        """Registry counters + gauges as ``metrics/<name>`` scalar lines
        (histograms land as their mean) — rank-0-only like every write.
        At most once per step: the final epoch's emit and on_train_end land
        on the same step, and duplicating every line there would break
        consumers keying on unique (tag, step)."""
        if not self._is_write() or step == self._last_registry_step:
            return
        self._last_registry_step = step
        import json
        from paddle_tpu_torch.observability import metrics
        snap = metrics.snapshot()
        fh = self._writer()
        for name, v in snap.get("counters", {}).items():
            fh.write(json.dumps({"tag": f"metrics/{name}", "step": int(step),
                                 "value": float(v)}) + "\n")
        for name, v in snap.get("gauges", {}).items():
            fh.write(json.dumps({"tag": f"metrics/{name}", "step": int(step),
                                 "value": float(v)}) + "\n")
        for name, h in snap.get("histograms", {}).items():
            if h.get("count"):
                fh.write(json.dumps(
                    {"tag": f"metrics/{name}.mean", "step": int(step),
                     "value": float(h["mean"])}) + "\n")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        self.train_step += 1
        self._updates(logs, "train", self.train_step)

    def on_epoch_end(self, epoch, logs=None):
        self._emit_registry(self.train_step)

    def on_eval_end(self, logs=None):
        self._updates(logs, "eval", self.epoch)

    def on_train_end(self, logs=None):
        self._emit_registry(self.train_step)
        if self._fh is not None:
            self._fh.close()
            self._fh = None
