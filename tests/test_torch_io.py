"""`paddle_tpu_torch.io` (datasets, samplers, collate, DataLoader, the
shared-memory transport) and `framework/flags.py` held against the JAX
package's `paddle_tpu.io` and `paddle_tpu.framework.flags` on the CPU.

Indices, collated values and dtypes, codec bytes and error texts are held
exactly: both packages draw from numpy's global state in the same order,
so one ``np.random.seed`` before each side gives the same permutations.
Worker tests run ``fork`` workers (one ``spawn`` case, the default) over
numpy-only datasets, so a child never starts JAX or a CUDA context.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu.framework import flags as jflags
from paddle_tpu.io import native_queue as jnq
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.testing import faults as jfaults

import paddle_tpu_torch as tp
import paddle_tpu_torch.io as tio
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.io import native_queue as tnq
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.vision.datasets import FakeData

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors go to the CPU here (its default is the
    card)."""
    with tdevice.device_scope("cpu"):
        yield


@pytest.fixture
def fork_workers():
    """Worker tests run fork workers on any host (the auto-fallback would
    run a one-core host in-process)."""
    tflags.set_flags({"FLAGS_dataloader_mp_method": "fork",
                      "FLAGS_dataloader_auto_fallback": False})
    yield
    tflags.set_flags({"FLAGS_dataloader_mp_method": "spawn",
                      "FLAGS_dataloader_auto_fallback": True})


class Rows:
    """A map-style dataset of numpy rows, the same object for both
    packages (module-level: it pickles into spawn workers)."""

    def __init__(self, n=24):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((3,), i, np.float32), np.array([i * i], np.int64),
                {"id": i, "w": np.float32(i) / 2})


class Slow(Rows):
    """Every item takes longer than the test waits: the pool never
    delivers."""

    def __getitem__(self, i):
        time.sleep(5)
        return super().__getitem__(i)


def stream(m, n):
    """An iterable dataset of ``n`` rows, of package ``m``'s class."""
    class Stream(m.IterableDataset):
        def __iter__(self):
            return iter(Rows(n)[i] for i in range(n))
    return Stream()


def _np(x):
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _same_tree(a, b):
    """Equal values, dtypes and structure (Tensors of either package,
    numpy, Python scalars)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not hasattr(a, "numpy"):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert hasattr(a, "numpy") == hasattr(b, "numpy"), (a, b)
        x, y = _np(a), _np(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (x, y)
        np.testing.assert_array_equal(x, y)


def _both(make, seed=3):
    """``make(pkg)`` for each package after the same numpy seed."""
    np.random.seed(seed)
    j = make(jio)
    np.random.seed(seed)
    t = make(tio)
    return j, t


# ------------------------------------------------------------ datasets


def test_datasets_and_random_split_give_equal_indices():
    rows = Rows(10)
    arrs = [np.arange(10) * 2, np.arange(10) * 3]
    for name, make in [
        ("tensor", lambda m: [m.TensorDataset(arrs)[i] for i in range(10)]),
        ("compose", lambda m: [m.ComposeDataset([rows, rows])[i]
                               for i in (0, 5, 9)]),
        ("chain", lambda m: [s for s in m.ChainDataset([stream(m, 2),
                                                         stream(m, 3)])]),
        ("concat", lambda m: [m.ConcatDataset([Rows(3), Rows(4)])[i]
                              for i in (0, 2, 3, 6, -1)]),
        ("subset", lambda m: [m.Subset(rows, [7, 1, 4])[i]
                              for i in range(3)]),
        ("split", lambda m: [s.indices for s in m.random_split(rows,
                                                               [3, 7])]),
        ("split_frac", lambda m: [s.indices for s in m.random_split(
            Rows(11), [0.5, 0.25, 0.25])])]:
        j, t = _both(make)
        assert repr(j) == repr(t), name


def test_samplers_give_equal_indices():
    rows = Rows(10)
    cases = {
        "sequence": lambda m: list(m.SequenceSampler(rows)),
        "random": lambda m: list(m.RandomSampler(rows)),
        "random_repl": lambda m: list(m.RandomSampler(
            rows, replacement=True, num_samples=7)),
        "random_n": lambda m: list(m.RandomSampler(rows, num_samples=4)),
        "weighted": lambda m: list(m.WeightedRandomSampler(
            [1, 2, 3, 4], 6)),
        "weighted_norepl": lambda m: list(m.WeightedRandomSampler(
            [1, 2, 3, 4], 3, replacement=False)),
        "batch": lambda m: list(m.BatchSampler(rows, batch_size=3)),
        "batch_shuffle": lambda m: list(m.BatchSampler(
            rows, shuffle=True, batch_size=4, drop_last=True)),
        "batch_len": lambda m: [len(m.BatchSampler(rows, batch_size=b,
                                                   drop_last=d))
                                for b in (3, 5) for d in (False, True)],
    }
    for name, make in cases.items():
        j, t = _both(make)
        assert j == t, name
    for world, rank, shuffle, drop in [(3, 0, False, False),
                                       (3, 2, True, False),
                                       (4, 1, True, True)]:
        def dist(m):
            s = m.DistributedBatchSampler(Rows(10), 2, num_replicas=world,
                                          rank=rank, shuffle=shuffle,
                                          drop_last=drop)
            out = [list(s), len(s)]
            s.set_epoch(5)
            return out + [list(s)]
        j, t = _both(dist)
        assert j == t, (world, rank, shuffle, drop)


def test_default_collate_equal_values_and_dtypes():
    batch = [Rows()[i] for i in range(4)]
    _same_tree(jio.default_collate_fn(batch), tio.default_collate_fn(batch))
    nested = [[np.ones((2, 2), np.int32) * i, [1.5 * i, i], "s"]
              for i in range(3)]
    _same_tree(jio.default_collate_fn(nested),
               tio.default_collate_fn(nested))
    # Tensors of the port stack into one Tensor on their device
    ts = [tp.to_tensor(np.full((2,), i, np.float32)) for i in range(3)]
    out = tio.default_collate_fn(ts)
    assert isinstance(out, tp.Tensor) and out.shape == [3, 2]


def test_dataloader_in_process_equals_jax():
    def run(m):
        ds = Rows(22)
        return [list(m.DataLoader(ds, batch_size=4, shuffle=True,
                                  drop_last=dl))
                for dl in (False, True)] + [
            list(m.DataLoader(ds, batch_size=None))[:3],
            list(m.DataLoader(stream(m, 7), batch_size=3)),
            list(m.DataLoader(stream(m, 7), batch_size=3, drop_last=True)),
            len(m.DataLoader(ds, batch_size=5))]
    j, t = _both(run)
    _same_tree(j[:-1], t[:-1])
    assert j[-1] == t[-1]
    assert all(x.place.is_cpu_place() for x in t[0][0][:2])


@pytest.mark.parametrize("shm", [False, True], ids=["mp_queue", "shm"])
def test_workers_give_the_in_process_batches(fork_workers, shm):
    ds = Rows(37)
    np.random.seed(4)
    want = list(tio.DataLoader(ds, batch_size=5, shuffle=True))
    np.random.seed(4)
    got = list(tio.DataLoader(ds, batch_size=5, shuffle=True,
                              num_workers=2, use_shared_memory=shm))
    _same_tree(want, got)


def test_spawn_workers_fakedata_equal_in_process():
    """The default start method: spawn children import the port, never
    JAX, and deliver the in-process batches."""
    tflags.set_flags({"FLAGS_dataloader_auto_fallback": False})
    try:
        ds = FakeData(size=12, image_shape=(3, 8, 8), num_classes=5)
        want = list(tio.DataLoader(ds, batch_size=4, shuffle=False))
        got = list(tio.DataLoader(ds, batch_size=4, num_workers=2,
                                  use_shared_memory=True))
    finally:
        tflags.set_flags({"FLAGS_dataloader_auto_fallback": True})
    _same_tree(want, got)


def test_worker_error_propagates(fork_workers):
    class Bad(Rows):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("boom-5")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="boom-5"):
        list(tio.DataLoader(Bad(12), batch_size=4, num_workers=2))


# ------------------------------------------------------- shm transport


def test_codec_bytes_equal_both_ways():
    obj = (3, {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
               "y": [np.int64(4), np.array([1, 2], np.int16)]},
           ("__pt_tensor__", np.ones((2, 2), np.float64)), None,
           np.array(["a", None], dtype=object))
    jb, tb = jnq.encode_batch(obj), tnq.encode_batch(obj)
    assert jb == tb
    for dec in (jnq.decode_batch, tnq.decode_batch):
        for buf in (jb, tb):
            back = dec(buf)
            assert tnq.encode_batch(back) == tb


def test_jax_created_queue_opens_in_the_port():
    jq = jnq.ShmQueue(slots=4, slot_bytes=1 << 16)
    try:
        tq = tnq.ShmQueue(slot_bytes=1 << 16, name=jq.name, create=False)
        jq.push(b"from-jax")
        assert tq.pop(timeout=5) == b"from-jax"
        tq.push(tnq.encode_batch((1, [np.arange(3)], None)))
        seq, arrs, err = jnq.decode_batch(jq.pop(timeout=5))
        assert seq == 1 and err is None
        np.testing.assert_array_equal(arrs[0], np.arange(3))
        assert tq.qsize() == jq.qsize() == 0
        tq.close()
        with pytest.raises(EOFError):
            jq.pop(timeout=1)
    finally:
        jq.release()


# ------------------------------------------------- stalls and metrics


def _deltas(reg, before):
    snap = reg.snapshot()
    return {"batches": snap["counters"].get("dataloader.batches", 0)
            - before["batches"],
            "retries": snap["counters"].get("dataloader.stall_retries", 0)
            - before["retries"],
            "fetches": snap["histograms"].get(
                "dataloader.fetch_seconds", {}).get("count", 0)
            - before["fetches"]}


def _zero(reg):
    return _deltas(reg, {"batches": 0, "retries": 0, "fetches": 0})


def _np_collate(batch):
    """A collate that stays numpy, so a forked JAX worker never runs a
    JAX op."""
    return [np.stack([s[0] for s in batch]), np.stack([s[1] for s in batch])]


def test_stall_ladder_and_metrics_equal_jax(fork_workers):
    jflags.set_flags({"FLAGS_dataloader_mp_method": "fork",
                      "FLAGS_dataloader_auto_fallback": False})
    try:
        out = {}
        for name, m, reg, fl in (("jax", jio, jmetrics, jfaults),
                                 ("port", tio, tmetrics, tfaults)):
            b0 = _zero(reg)
            inproc = list(m.DataLoader(Rows(10), batch_size=4))
            with fl.scoped("loader.stall", times=1):
                retried = list(m.DataLoader(Rows(16), batch_size=4,
                                            num_workers=2,
                                            collate_fn=_np_collate))
            d1 = _deltas(reg, b0)
            with fl.scoped("loader.stall", times=2):
                with pytest.raises(m.DataLoaderStalled) as e:
                    list(m.DataLoader(Slow(16), batch_size=4,
                                      num_workers=1,
                                      collate_fn=_np_collate))
            out[name] = (inproc, retried, d1, _deltas(reg, b0), str(e.value))
    finally:
        jflags.set_flags({"FLAGS_dataloader_mp_method": "spawn",
                          "FLAGS_dataloader_auto_fallback": True})
    j, t = out["jax"], out["port"]
    _same_tree(j[0], t[0])
    _same_tree(j[1], t[1])
    assert np.concatenate([b[0] for b in t[1]])[:, 0].tolist() == \
        list(range(16))
    assert j[2] == t[2] == {"batches": 7, "retries": 1, "fetches": 7}
    assert j[3] == t[3] == {"batches": 7, "retries": 2, "fetches": 7}
    assert j[4] == t[4] and "twice in a row" in t[4]


def test_get_worker_info_is_none():
    assert tio.get_worker_info() is None and jio.get_worker_info() is None


# ------------------------------------------------------------------ flags


def test_flags_names_defaults_and_parsing_equal():
    jreg, treg = jflags._REGISTRY, tflags._REGISTRY
    assert list(jreg) == list(treg)
    for n in jreg:
        assert treg[n].default == jreg[n].default, n
        assert type(treg[n].value) is type(jreg[n].value), n
        for text in ("1", "0", "true", "off", "7", "2.5", "auto"):
            try:
                want = jreg[n].parser(text)
            except ValueError:
                with pytest.raises(ValueError):
                    treg[n].parser(text)
                continue
            assert treg[n].parser(text) == want, (n, text)
    assert tflags.get_flags(["FLAGS_benchmark", "seed"]) == \
        jflags.get_flags(["FLAGS_benchmark", "seed"])
    for mod in (jflags, tflags):
        with pytest.raises(ValueError, match="unknown flag nope"):
            mod.get_flags("nope")
        with pytest.raises(ValueError, match="unknown flag nope"):
            mod.set_flags({"FLAGS_nope": 1})
    # set from text parses; a refused arm is not stored
    tflags.set_flags({"FLAGS_paddle_num_threads": "3"})
    assert tflags.flag_value("paddle_num_threads") == 3
    tflags.set_flags({"FLAGS_paddle_num_threads": 1})
    for name, bad in [("tpu_flash_impl", "xla"), ("tpu_paged_impl", "pallas"),
                      ("tpu_prefill_impl", "xla"), ("moe_dispatch", "scatter"),
                      ("autotune_verbose", True),
                      ("dy2static_max_trip_count", 8)]:
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            tflags.set_flags({f"FLAGS_{name}": bad})
        assert tflags.flag_value(name) == jflags._REGISTRY[name].default


_ENV_PROBE = r"""
import importlib, json, os
from paddle_tpu_torch.framework import flags
import paddle_tpu_torch.core.autograd as ag
got = [flags.get_flags(["check_nan_inf", "paddle_num_threads",
                        "eager_delete_tensor_gb", "log_level",
                        "dataloader_mp_method"]), ag._DEBUG_CHECKS]
os.environ["FLAGS_tpu_flash_impl"] = "splash"
try:
    importlib.reload(flags)
    got.append("accepted")
except NotImplementedError as e:
    got.append(str(e))
print(json.dumps(got))
"""


def test_flags_from_the_environment():
    """``FLAGS_*`` read at import, with their wiring; an unported arm in
    the environment refuses the import."""
    env = dict(os.environ, PYTHONPATH=str(REPO), FLAGS_check_nan_inf="yes",
               FLAGS_paddle_num_threads="4", FLAGS_eager_delete_tensor_gb="1.5",
               FLAGS_log_level="DEBUG", FLAGS_dataloader_mp_method="fork")
    r = subprocess.run([sys.executable, "-c", _ENV_PROBE], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got, debug, refused = json.loads(r.stdout)
    want = {"FLAGS_check_nan_inf": True, "FLAGS_paddle_num_threads": 4,
            "FLAGS_eager_delete_tensor_gb": 1.5, "FLAGS_log_level": "DEBUG",
            "FLAGS_dataloader_mp_method": "fork"}
    assert got == want
    assert {k: jflags._REGISTRY[k[6:]].parser(env[k]) for k in want} == want
    assert debug is True
    assert "ROADMAP A8.5" in refused


def test_check_nan_inf_and_bf16_matmul_flags_drive_the_port():
    x = tp.to_tensor(np.array([-1.0, 4.0], np.float32))
    tflags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="non-finite"):
            tp.sqrt(x)
    finally:
        tflags.set_flags({"FLAGS_check_nan_inf": False})
    assert np.isnan(tp.sqrt(x).numpy()[0])
    a = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    b = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    tflags.set_flags({"FLAGS_use_bfloat16_matmul": True})
    try:
        got = tp.matmul(tp.to_tensor(a), tp.to_tensor(b)).numpy()
    finally:
        tflags.set_flags({"FLAGS_use_bfloat16_matmul": False})
    ab = torch.from_numpy(a).bfloat16().float()
    bb = torch.from_numpy(b).bfloat16().float()
    np.testing.assert_array_equal(got, (ab @ bb).numpy())
    assert np.abs(got - a @ b).max() > 0
