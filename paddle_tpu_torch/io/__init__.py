"""paddle.io of the port (counterpart of `paddle_tpu/io/__init__.py`) —
datasets, samplers, DataLoader.

Ref: `python/paddle/fluid/reader.py:312` (DataLoader), `fluid/dataloader/*`
(Dataset/IterableDataset/BatchSampler/DistributedBatchSampler, worker
subprocesses with shared-memory transport at `dataloader_iter.py:375`).
Here: an in-process iterator, an iterable-dataset iterator, and worker
processes over an `mp.Queue` or the native shared-memory ring
(`native_queue.py`). The default collate makes Tensors on the current
device (the card unless ``set_device("cpu")``); workers never touch the
card: they fetch and collate under ``device_scope("cpu")`` and send tagged
numpy, and the parent rebuilds each tagged node as a Tensor on its own
device.

The host's random draws are the JAX package's, in its order: the samplers
and `random_split` draw from numpy's global state,
`DistributedBatchSampler` from ``RandomState(epoch)``, so seeding
``np.random`` gives both packages the same indices.
"""
from __future__ import annotations

import bisect
import itertools
import math
import multiprocessing as mp
import os as _os
import queue as queue_mod
import threading
import time

import numpy as np

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.observability import metrics as _metrics

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "default_collate_fn", "DataLoader", "DataLoaderStalled",
           "get_worker_info"]

# batch-fetch telemetry (docs/OBSERVABILITY.md): fetch latency is the stall a
# training loop would see per next(loader) — the pipeline-health number
_M_BATCHES = _metrics.counter("dataloader.batches")
_M_FETCH_S = _metrics.histogram("dataloader.fetch_seconds")
_M_STALL_RETRIES = _metrics.counter("dataloader.stall_retries")


class DataLoaderStalled(RuntimeError):
    """The worker fetch pipeline produced NOTHING for ``stall_timeout``
    seconds twice in a row (one bounded retry re-enqueued the in-flight
    batches in between): a wedged worker pool must surface as a typed
    error at the training loop, never hang ``fit()`` forever
    (docs/ROBUSTNESS.md "Fault sites": ``loader.stall``)."""


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (tuple, list)) else [sample])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = bisect.bisect_right(self.cum, idx)
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        lengths = [int(math.floor(n * l)) for l in lengths]
        lengths[0] += n - sum(lengths)
    perm = np.random.permutation(sum(lengths))
    out = []
    offset = 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices across ranks (ref
    `fluid/dataloader/batch_sampler.py` DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from paddle_tpu_torch.distributed import parallel as dist
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else \
            dist.get_world_size()
        self.local_rank = rank if rank is not None else dist.get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate(
            [indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (Tensor,)):
        import torch
        return Tensor(torch.stack([s._data for s in batch]), _internal=True)
    if isinstance(sample, np.ndarray):
        return Tensor(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return Tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn([s[i] for s in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    return batch


def _to_np_tree(o):
    # Tensors are tagged so the parent restores exactly the nodes that were
    # Tensors — a custom collate returning plain ndarrays stays numpy on the
    # other side (matching the single-process iterator, which yields the
    # collate output untouched)
    if isinstance(o, Tensor):
        return ("__pt_tensor__", o.numpy())
    if isinstance(o, (list, tuple)):
        return type(o)(_to_np_tree(v) for v in o)
    if isinstance(o, dict):
        return {k: _to_np_tree(v) for k, v in o.items()}
    return o


def _produce_loop(dataset, index_queue, collate_fn, put):
    """Shared worker body; `put(seq, batch_or_None, exc_or_None)` is the
    transport (mp.Queue or native shm ring). Fetch and collate run under
    ``device_scope("cpu")``: a worker never starts a CUDA context."""
    from paddle_tpu_torch.device import device_scope
    while True:
        item = index_queue.get()
        if item is None:
            break
        seq, indices = item
        try:
            with device_scope("cpu"):
                batch = _to_np_tree(collate_fn([dataset[i] for i in indices]))
            put(seq, batch, None)
        except Exception as e:  # propagate worker errors to the main process
            put(seq, None, e)


def _worker_loop(dataset, index_queue, data_queue, collate_fn):
    _produce_loop(dataset, index_queue, collate_fn,
                  lambda seq, b, e: data_queue.put((seq, b, e)))


def _worker_loop_shm(dataset, index_queue, shm_name, slot_bytes, collate_fn):
    """Worker for the native shared-memory transport: batches are encoded
    straight into the shm ring (no pickling through pipes)."""
    import pickle as _p
    from paddle_tpu_torch.io.native_queue import ShmQueue, encode_batch
    q = ShmQueue(slot_bytes=slot_bytes, name=shm_name, create=False)

    def put(seq, batch, exc):
        if exc is None:
            q.push(encode_batch((seq, batch, None)))
            return
        try:
            q.push(encode_batch((seq, None, _p.dumps(exc))))
        except Exception:
            q.push(encode_batch((seq, None,
                                 _p.dumps(RuntimeError(repr(exc))))))

    _produce_loop(dataset, index_queue, collate_fn, put)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False,
                 shm_slot_bytes=64 << 20, stall_timeout=300.0):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.shm_slot_bytes = shm_slot_bytes
        self.timeout = timeout
        # worker-fetch stall ladder (docs/ROBUSTNESS.md): no batch for
        # this long -> ONE bounded retry (re-enqueue the in-flight batch
        # indices), a second silent window -> typed DataLoaderStalled.
        # 0/None disables. Distinct from ``timeout`` (a hard overall
        # deadline the caller opted into): the stall ladder is ON by
        # default because the alternative is fit() hanging forever.
        self.stall_timeout = stall_timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no fixed length")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _effective_workers(self):
        """On a single-core host the worker pipeline competes with the
        training loop for the one core, so multi-worker mode falls back
        to in-process there, as the JAX package's does.
        FLAGS_dataloader_auto_fallback=False forces workers regardless —
        for measurement, or on multi-core hosts where overlap wins."""
        if self.num_workers <= 0:
            return 0
        from paddle_tpu_torch.framework.flags import flag_value
        if not flag_value("dataloader_auto_fallback"):
            return self.num_workers
        if (_os.cpu_count() or 1) <= 1:
            import warnings
            warnings.warn(
                f"DataLoader: num_workers={self.num_workers} on a "
                "single-core host measurably loses to the in-process "
                "path (in pump AND compute-overlap shapes); using the "
                "in-process iterator instead. Set "
                "FLAGS_dataloader_auto_fallback=False to force workers "
                "regardless (e.g. for measurement)",
                RuntimeWarning, stacklevel=3)
            return 0
        return self.num_workers

    def __iter__(self):
        if self._iterable_mode:
            inner = self._iter_iterable()
        elif self._effective_workers() > 0:
            inner = self._iter_multiprocess()
        else:
            inner = self._iter_single()
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(inner)
            except StopIteration:
                return
            _M_FETCH_S.observe(time.perf_counter() - t0)
            _M_BATCHES.inc()
            yield batch

    def _iter_single(self):
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
            return
        for indices in self.batch_sampler:
            samples = [self.dataset[i] for i in indices]
            yield self.collate_fn(samples)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            if self.batch_size is None:
                yield sample
                continue
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last and self.batch_size is not None:
            yield self.collate_fn(batch)

    def _iter_multiprocess(self):
        # spawn, not fork: the parent runs torch's threads and may hold a
        # CUDA context, and os.fork() from it can deadlock (CPython
        # RuntimeWarning). Workers only produce numpy batches, so a fresh
        # interpreter is safe; the cost is that dataset/collate_fn must be
        # picklable (same contract as the reference's spawn mode,
        # fluid/dataloader/dataloader_iter.py).
        from paddle_tpu_torch.framework.flags import flag_value
        method = flag_value("dataloader_mp_method")
        if method != "fork":
            import sys as _sys
            main_mod = _sys.modules.get("__main__")
            main_file = getattr(main_mod, "__file__", None)
            not_reimportable = (
                # pseudo-file parent: "<stdin>" heredoc and friends
                (main_file is not None and main_file.startswith("<"))
                # interactive REPL / python -c: no file and no module spec —
                # __main__-defined datasets can never unpickle in a spawn child
                or (main_file is None
                    and getattr(main_mod, "__spec__", None) is None))
            if not_reimportable:
                # spawn bootstrap re-runs the parent's __main__ by path, so
                # workers would die at startup — fork is the only viable
                # context there. Real paths (including zipapp members) stay
                # on spawn.
                import warnings
                warnings.warn(
                    "DataLoader: parent __main__ is not re-importable"
                    f" (file={main_file!r}); falling back to fork workers",
                    RuntimeWarning)
                method = "fork"
        ctx = mp.get_context(method)
        index_queue = ctx.Queue()
        shmq = None
        if self.use_shared_memory:
            # native C++ shm ring (io/native/shm_queue.cpp); falls back to
            # mp.Queue pickling when the toolchain/library is unavailable
            try:
                from paddle_tpu_torch.io.native_queue import ShmQueue
                shmq = ShmQueue(slots=max(self.num_workers *
                                          self.prefetch_factor, 4),
                                slot_bytes=self.shm_slot_bytes)
            except Exception:
                shmq = None
        data_queue = ctx.Queue() if shmq is None else None
        workers = []
        for _ in range(self.num_workers):
            if shmq is not None:
                w = ctx.Process(
                    target=_worker_loop_shm,
                    args=(self.dataset, index_queue, shmq.name,
                          shmq.slot_bytes, self.collate_fn), daemon=True)
            else:
                w = ctx.Process(target=_worker_loop,
                                args=(self.dataset, index_queue, data_queue,
                                      self.collate_fn), daemon=True)
            w.start()
            workers.append(w)

        # stall ladder state (docs/ROBUSTNESS.md "Fault sites",
        # ``loader.stall``): shared between get_result and the consumer
        # loop below via closure
        stall = {"last": time.monotonic(), "retried": False}

        def _on_stall(why):
            """One bounded retry: re-enqueue every in-flight batch index
            (a recovered/other worker picks them up; duplicate deliveries
            are discarded by seq), then typed failure on the second
            silent window."""
            from paddle_tpu_torch.observability.flight_recorder import flight
            if stall["retried"]:
                raise DataLoaderStalled(
                    f"DataLoader worker fetch produced nothing for "
                    f"{self.stall_timeout}s twice in a row ({why}); "
                    f"one retry already re-enqueued the in-flight "
                    f"batches — the worker pool is wedged")
            stall["retried"] = True
            stall["last"] = time.monotonic()
            pend = [i for i in range(next_yield, next_send)
                    if i not in reorder]
            _M_STALL_RETRIES.inc()
            flight.record("dataloader.stall_retry", pending=len(pend),
                          why=str(why))
            for i in pend:
                index_queue.put((i, batches[i]))

        def get_result():
            # bounded waits so a crashed worker pool raises instead of
            # hanging the consumer forever (e.g. spawn bootstrap failures)
            from paddle_tpu_torch.testing import faults
            # the stall window measures silence WHILE FETCHING: reset at
            # entry so time the consumer spent suspended between next()
            # calls (a long eval, a synchronous fleet checkpoint) never
            # counts as a worker stall
            stall["last"] = time.monotonic()
            deadline = (time.monotonic() + self.timeout) if self.timeout \
                else None
            while True:
                if faults.ENABLED and faults.fire("loader.stall"):
                    # deterministic stand-in for a silent stall_timeout
                    # window: drive the SAME ladder the timer would
                    # (times=1 exercises the retry; times=2 burns both
                    # charges before any delivery -> the typed raise)
                    _on_stall("injected via loader.stall")
                if self.stall_timeout and \
                        time.monotonic() - stall["last"] > self.stall_timeout:
                    _on_stall(f"no batch for {self.stall_timeout}s")
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise TimeoutError("DataLoader timed out")
                    wait = min(1.0, left)
                else:
                    wait = 1.0
                if shmq is None:
                    try:
                        return data_queue.get(timeout=wait)
                    except queue_mod.Empty:
                        pass
                else:
                    from paddle_tpu_torch.io.native_queue import decode_batch
                    try:
                        raw = shmq.pop(timeout=wait)
                    except TimeoutError:
                        raw = None
                    if raw is not None:
                        seq, data, err = decode_batch(raw)
                        if err is not None:
                            import pickle as _p
                            err = _p.loads(err)
                        return seq, data, err
                if all(not w.is_alive() for w in workers):
                    codes = [w.exitcode for w in workers]
                    raise RuntimeError(
                        "DataLoader workers exited unexpectedly (exitcodes "
                        f"{codes}); if the parent has no importable __main__ "
                        "set FLAGS_dataloader_mp_method=fork")

        try:
            batches = list(self.batch_sampler)
            n = len(batches)
            inflight = 0
            next_send = 0
            max_inflight = self.num_workers * self.prefetch_factor
            reorder: dict[int, object] = {}
            next_yield = 0
            while next_send < n and inflight < max_inflight:
                index_queue.put((next_send, batches[next_send]))
                next_send += 1
                inflight += 1
            while next_yield < n:
                while next_yield in reorder:
                    yield reorder.pop(next_yield)
                    next_yield += 1
                if next_yield >= n:
                    break
                seq, data, err = get_result()
                # ANY delivery (duplicates included) proves the pipeline
                # is alive again: re-arm the retry so "twice" means twice
                # IN A ROW, not twice per epoch — a transient hiccup at
                # hour 1 must not arm hour 5's into a typed failure
                stall["retried"] = False
                if err is not None:
                    raise err
                if seq < next_yield or seq in reorder:
                    # duplicate delivery: the stall retry re-enqueued an
                    # in-flight batch whose ORIGINAL then also arrived —
                    # it was already accounted, drop this copy
                    continue
                inflight -= 1
                if next_send < n:
                    index_queue.put((next_send, batches[next_send]))
                    next_send += 1
                    inflight += 1

                def to_tensor(o):
                    if (isinstance(o, tuple) and len(o) == 2
                            and isinstance(o[0], str)
                            and o[0] == "__pt_tensor__"):
                        return Tensor(o[1])
                    if isinstance(o, list):
                        return [to_tensor(v) for v in o]
                    if isinstance(o, tuple):
                        return tuple(to_tensor(v) for v in o)
                    if isinstance(o, dict):
                        return {k: to_tensor(v) for k, v in o.items()}
                    return o

                reorder[seq] = to_tensor(data)
        finally:
            for _ in workers:
                index_queue.put(None)
            if shmq is not None:
                # close FIRST so pushers blocked on a full ring wake up and
                # exit — SIGKILLing a worker mid-push would leave the
                # process-shared mutex locked forever
                shmq.close()
            for w in workers:
                w.join(timeout=1)
                if w.is_alive():
                    w.terminate()
            if shmq is not None:
                shmq.release()


def get_worker_info():
    return None
