"""`paddle_tpu_torch.metric` and `paddle_tpu_torch.hapi` (`Model`,
callbacks, `summary`) held against the JAX package's on the CPU, with the
scan step's fit hooks (`ScanUnsupported`, `refresh_from_model`, ``dirty``)
and `CheckpointManager`'s ``[epoch, batch]`` cursors.

- The metrics: equal values on the same inputs, ties included (top-k
  keeps the lower index, as ``jnp.argsort`` does).
- The fused route: a 2-layer GPT fit on both packages from the same
  weights, losses and parameters within 1e-5 (the JAX step's C1 import,
  `jax.experimental.disable_x64`, is answered test-locally as in
  `tests/test_torch_fault_tolerance.py`).
- The JAX hapi cases of `tests/test_scan_train.py` and the two fit cases
  of `tests/test_train_chaos.py` on the port; the resumed fit bit-equal to
  the uninterrupted one.
- The eager route: a conv + batch norm + linear net with a metric and a
  partial accumulation group, losses, metrics and parameters within 1e-5
  of the JAX fit (the `jax_eager` C1 fixture).
- Callbacks, `Model.save` files loaded by the other package both ways,
  and `summary`'s counts.
"""
import contextlib
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.experimental

import paddle_tpu as jp
import paddle_tpu.core.autograd as jag
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi.model import Model as JModel
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.train import ScanTrainStep as JStep
from paddle_tpu.train import ScanUnsupported as JUnsupported

import paddle_tpu_torch as tp
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.metric as tmetric
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.distributed.checkpoint import load_sharded
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.hapi.model import Model as TModel
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.train import CheckpointManager, ScanUnsupported
from paddle_tpu_torch.train import ScanTrainStep as TStep

TINY = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            intermediate_size=32, max_position_embeddings=8,
            hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    with tdevice.device_scope("cpu"):
        yield


@contextlib.contextmanager
def _x64_off():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture(autouse=True)
def _c1(monkeypatch):
    """The JAX scan step's and eager autograd's x64-off scopes, answered
    for jax 0.9 (C1)."""
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)
    monkeypatch.setattr(jag, "_x64_off_scope", _x64_off)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _state(net):
    return {k: _np(v) for k, v in net.state_dict().items()}


def _close(a, b, tol):
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert float(np.abs(a[k].astype(np.float64)
                            - b[k].astype(np.float64)).max()) <= tol, k


class Record(tcb.Callback):
    """The train batch logs (both packages' callbacks take duck-typed
    callback objects)."""

    def __init__(self):
        super().__init__()
        self.logs = []

    def on_batch_end(self, mode, step, logs=None):
        self.logs.append(dict(logs or {}))


# ---------------------------------------------------------------- metrics


def test_metrics_equal_with_ties():
    rng = np.random.RandomState(0)
    pred = rng.rand(12, 5).astype(np.float32)
    pred[0] = [0.3, 0.3, 0.3, 0.1, 0.0]        # ties at the top
    pred[1] = [0.2, 0.5, 0.5, 0.5, 0.1]
    label = rng.randint(0, 5, (12, 1)).astype(np.int64)
    label[0], label[1] = 1, 3
    p1 = rng.rand(16).astype(np.float32)
    y1 = (rng.rand(16) > 0.4).astype(np.int64)
    out = {}
    for name, m, mk in (("jax", jmetric, jp.to_tensor),
                        ("port", tmetric, tp.to_tensor)):
        acc = m.Accuracy(topk=(1, 3))
        r = [acc.update(acc.compute(mk(pred), mk(label))),
             acc.update(acc.compute(pred[:5], label[:5])),
             acc.accumulate(), acc.name(), m.Accuracy().name()]
        pr, rc, auc = m.Precision(), m.Recall(), m.Auc(num_thresholds=63)
        for met in (pr, rc, auc):
            met.update(mk(p1), mk(y1))
            met.update(p1[::-1].copy(), y1)
        auc.update(np.stack([1 - p1, p1], 1), y1)
        r += [pr.accumulate(), rc.accumulate(), auc.accumulate(), pr.name(),
              rc.name(), auc.name()]
        r += [float(m.accuracy(mk(pred), mk(label), k=k).numpy())
              for k in (1, 2, 3)]
        r.append(float(m.accuracy(mk(pred[:2]), mk(label[:2, 0])).numpy()))
        out[name] = r
    assert out["jax"] == out["port"]
    # the tie rows: top-1 is the lower index of the tie (0 and 1)
    assert out["port"][-1] == 0.0


# ----------------------------------------------------------- fused route


class _Rows:
    """[S + 1]-token rows as (ids, labels) (the chaos tests' `Toy`)."""

    def __init__(self, n=8, seed=0):
        rng = np.random.RandomState(seed)
        self.rows = [rng.randint(0, 64, 9).astype(np.int32)
                     for _ in range(n)]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i][:-1], self.rows[i][1:].astype(np.int64)


def _toy(m, n=8, seed=0):
    """`_Rows` as package ``m``'s io.Dataset."""
    rows = _Rows(n, seed)

    class Toy(m.Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i]
    return Toy()


def _jax_gpt(seed=5, **over):
    jp.seed(seed)
    return jgpt.GPTForCausalLM(jgpt.GPTConfig(**dict(TINY, **over)))


def _port_gpt(seed=5, like=None, **over):
    tp.seed(seed)
    net = tgpt.GPTForCausalLM(tgpt.GPTConfig(**dict(TINY, **over)))
    if like is not None:
        net.set_state_dict(_state(like))
    return net


def test_fused_fit_equals_jax():
    jnet = _jax_gpt()
    tnet = _port_gpt(like=jnet)
    recs = {}
    for name, net, pkg, M in (("jax", jnet, jp, JModel),
                              ("port", tnet, tp, TModel)):
        opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=net.parameters())
        model = M(net).prepare(optimizer=opt)
        rec = Record()
        np.random.seed(11)
        model.fit(_toy(jio if pkg is jp else tio, n=8), batch_size=2,
                  epochs=2, accumulate_grad_batches=2, verbose=0,
                  shuffle=True, callbacks=[rec])
        assert model._fused_step is not None
        assert opt._global_step == 4          # 2 x 2 groups
        ev = model.evaluate(_toy(jio if pkg is jp else tio, n=4, seed=1),
                            batch_size=2)
        recs[name] = ([r.get("loss") for r in rec.logs], ev["loss"])
    (jl, jev), (tl, tev) = recs["jax"], recs["port"]
    assert [x is None for x in jl] == [x is None for x in tl]
    assert max(abs(a - b) for a, b in zip(jl, tl) if a is not None) <= 1e-5
    assert abs(jev - tev) <= 1e-5
    _close(_state(jnet), _state(tnet), 1e-5)


def _port_model(seed=5, **opt_kw):
    net = _port_gpt(seed)
    opt = tp.optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                             **opt_kw)
    return TModel(net).prepare(optimizer=opt), net, opt


def _batch(b=4, s=8, seed=0):
    ids = np.random.RandomState(seed).randint(0, 64, (b, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64)


def test_hapi_fit_accumulate_routes_gpt_fused():
    hm, net, opt = _port_model()
    x, y = _batch(s=6)
    hm.fit([(x, y)] * 6, epochs=1, accumulate_grad_batches=2, verbose=0)
    assert hm._fused_step is not None and not hm._fused_step.dirty
    assert opt._global_step == 3           # 6 batches / k=2
    logs = hm.evaluate([(x, y)])
    assert np.isfinite(logs["loss"])


def _linear_model(seed=7):
    tp.seed(seed)
    net = tnn.Linear(8, 4)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    return net, TModel(net).prepare(optimizer=opt, loss=tnn.CrossEntropyLoss())


def test_hapi_generic_accumulation_matches_big_batch():
    rng = np.random.RandomState(0)
    X = rng.randn(8, 8).astype(np.float32)
    Y = rng.randint(0, 4, 8).astype(np.int64)
    net_a, hm_a = _linear_model()
    hm_a.fit([(X[:4], Y[:4]), (X[4:], Y[4:])], epochs=1,
             accumulate_grad_batches=2, verbose=0)
    net_b, hm_b = _linear_model()
    hm_b.fit([(X, Y)], epochs=1, verbose=0)
    np.testing.assert_allclose(_np(net_a.weight), _np(net_b.weight),
                               rtol=1e-6, atol=1e-7)


def test_hapi_generic_partial_flush_rescales():
    rng = np.random.RandomState(0)
    X = [rng.randn(4, 8).astype(np.float32) for _ in range(3)]
    Y = [rng.randint(0, 4, 4).astype(np.int64) for _ in range(3)]
    net_a, hm_a = _linear_model()
    hm_a.fit(list(zip(X, Y)), epochs=1, accumulate_grad_batches=2, verbose=0)
    net_b, hm_b = _linear_model()
    hm_b.fit(list(zip(X[:2], Y[:2])), epochs=1, accumulate_grad_batches=2,
             verbose=0)
    hm_b.fit([(X[2], Y[2])], epochs=1, verbose=0)
    np.testing.assert_allclose(_np(net_a.weight), _np(net_b.weight),
                               rtol=1e-6, atol=1e-7)


def test_hapi_fused_ragged_final_group_no_crash():
    hm, net, opt = _port_model()
    x, y = _batch()
    hm.fit([(x, y), (x[:3], y[:3])], epochs=1, accumulate_grad_batches=2,
           verbose=0)
    assert opt._global_step == 1


def test_hapi_load_not_clobbered_by_dirty_fused_step(tmp_path):
    hm, net, opt = _port_model()
    hm.save(str(tmp_path / "init"))
    w0 = _np(net.state_dict()["gpt.h.0.mlp.fc_in.weight"]).copy()
    x, y = _batch()
    hm.fit([(x, y)] * 4, epochs=1, accumulate_grad_batches=2, verbose=0)
    assert not np.array_equal(
        w0, _np(net.state_dict()["gpt.h.0.mlp.fc_in.weight"]))
    hm.load(str(tmp_path / "init"))
    hm.evaluate([(x, y)])
    np.testing.assert_array_equal(
        w0, _np(net.state_dict()["gpt.h.0.mlp.fc_in.weight"]))
    assert opt._global_step == 0


def test_fit_resume_parity(tmp_path):
    """Preempt after epoch 0, resume a fresh model, optimizer and manager
    into epoch 1: the final weights equal the uninterrupted 2-epoch fit
    bit for bit (one full and one leftover group an epoch)."""
    def make(seed=5):
        return _port_model(seed)[0]

    ref = make()
    ref.fit(_toy(tio, n=6), batch_size=2, epochs=2, shuffle=False,
            verbose=0, accumulate_grad_batches=2)
    part1 = make()
    part1.fit(_toy(tio, n=6), batch_size=2, epochs=1, shuffle=False,
              verbose=0, accumulate_grad_batches=2,
              checkpoint_manager=CheckpointManager(str(tmp_path), every=2))
    part2 = make(seed=77)
    mgr = CheckpointManager(str(tmp_path), every=2)
    part2.fit(_toy(tio, n=6), batch_size=2, epochs=2, shuffle=False,
              verbose=0, accumulate_grad_batches=2, checkpoint_manager=mgr)
    want, got = _state(ref.network), _state(part2.network)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert mgr.latest()[0] == 4
    # an int cursor (CheckpointManager.run's) is refused with the JAX text
    with pytest.raises(ValueError, match=r"data_cursor=\[1, 2\]"):
        mgr.run(lambda c: _batch(2, 8), until_step=5)


def test_fit_request_stop_leaves_complete_checkpoint(tmp_path):
    hm, net, opt = _port_model()
    mgr = CheckpointManager(str(tmp_path), every=100)

    class Preempt(tcb.Callback):
        def on_batch_end(self, mode, step, logs=None):
            if step == 2:
                mgr.request_stop()

    hm.fit(_toy(tio, n=12), batch_size=2, epochs=3, shuffle=False,
           verbose=0, checkpoint_manager=mgr, callbacks=[Preempt()])
    lat = mgr.latest()
    assert lat is not None and lat[0] == 4
    loaded = load_sharded(lat[1], return_numpy=True)
    assert loaded["meta/global_step"] == 4
    assert loaded["meta/data_cursor"] == [0, 3]
    with pytest.raises(ValueError, match="shuffle=False"):
        _port_model()[0].fit(_toy(tio), shuffle=True, verbose=0,
                             checkpoint_manager=CheckpointManager(
                                 str(tmp_path / "x")))


def test_scan_unsupported_routes_fit_to_eager():
    """Where the JAX step raises ScanUnsupported the port's does, with the
    same text, and fit takes the eager route on both packages."""
    cases = [
        ("attention_dropout", {"attention_dropout": 0.1}, "AdamW", {}),
        ("lamb", {}, "Lamb", {}),
        ("l1", {}, "AdamW",
         {"weight_decay": jp.regularizer.L1Decay(1e-4)}),
    ]
    for name, over, opt_name, kw in cases:
        texts = []
        for pkg, make in ((jp, _jax_gpt), (tp, _port_gpt)):
            net = make(**over)
            opt = getattr(pkg.optimizer, opt_name)(
                learning_rate=1e-3, parameters=net.parameters(), **kw)
            M = JModel if pkg is jp else TModel
            model = M(net).prepare(optimizer=opt)
            assert model._maybe_fused_step(2) is None, name
            with pytest.raises(JUnsupported if pkg is jp
                               else ScanUnsupported) as e:
                if pkg is jp:
                    JStep(net, opt)
                else:
                    TStep(net, opt, device="cpu")
            assert isinstance(e.value, ValueError)
            texts.append(str(e.value))
        assert texts[1].startswith(texts[0]), (name, texts)
    # a network that is no GPT never takes the step
    with pytest.raises(ScanUnsupported, match="needs GPTForCausalLM"):
        TStep(tnn.Linear(2, 2), tp.optimizer.AdamW(), device="cpu")
    # learning rates that differ across the layers of one stacked leaf
    net = _port_gpt()
    net.gpt.h[0].mlp.fc_in.weight.optimize_attr = {"learning_rate": 0.5}
    opt = tp.optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters())
    assert TModel(net).prepare(optimizer=opt)._maybe_fused_step(1) is None


# ------------------------------------------------------------ eager route


def _conv_pair():
    jp.seed(3)
    jnet = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.BatchNorm2D(4),
                          jnn.ReLU(), jnn.Flatten(), jnn.Linear(64, 5))
    tnet = tnn.Sequential(tnn.Conv2D(3, 4, 3, padding=1), tnn.BatchNorm2D(4),
                          tnn.ReLU(), tnn.Flatten(), tnn.Linear(64, 5))
    tnet.set_state_dict(_state(jnet))
    return jnet, tnet


class _Images:
    def __init__(self, n=12):
        rng = np.random.RandomState(9)
        self.x = rng.randn(n, 3, 4, 4).astype(np.float32)
        self.y = rng.randint(0, 5, (n, 1)).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _images(m, n=8):
    data = _Images(n)

    class Images(m.Dataset):
        def __len__(self):
            return len(data)

        def __getitem__(self, i):
            return data[i]
    return Images()


def test_eager_fit_equals_jax():
    jnet, tnet = _conv_pair()
    out = {}
    for name, net, pkg, m, M, met in (
            ("jax", jnet, jp, jio, JModel, jmetric),
            ("port", tnet, tp, tio, TModel, tmetric)):
        opt = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=net.parameters())
        model = M(net).prepare(optimizer=opt,
                               loss=(jnn if pkg is jp else tnn)
                               .CrossEntropyLoss(),
                               metrics=met.Accuracy(topk=(1, 2)))
        rec = Record()
        model.fit(_images(m, 12), eval_data=_images(m, 8), batch_size=4,
                  epochs=1, accumulate_grad_batches=2, shuffle=False,
                  verbose=0, callbacks=[rec])
        assert model._fused_step is None
        preds = model.predict(_images(m, 4), batch_size=4,
                              stack_outputs=True)
        out[name] = (rec.logs, model.evaluate(_images(m, 8), batch_size=4),
                     preds, opt._global_step)
    (jl, jev, jpred, jsteps), (tl, tev, tpred, tsteps) = \
        out["jax"], out["port"]
    assert jsteps == tsteps == 2          # 1 group + 1 flushed partial
    assert len(jl) == len(tl) == 3
    for a, b in zip(jl + [jev], tl + [tev]):
        assert list(a) == list(b)
        for k in a:
            assert np.abs(np.subtract(a[k], b[k])).max() <= 1e-5, (k, a, b)
    assert np.abs(jpred[0] - tpred[0]).max() <= 1e-5
    _close(_state(jnet), _state(tnet), 1e-5)


# -------------------------------------------------------------- callbacks


class _Stub:
    stop_training = False


def test_early_stopping_stop_epoch_equal():
    seqs = {"loss": [1.0, 0.9, 0.95, 0.97, 0.5], "acc": [0.1, 0.3, 0.2,
                                                         0.25, 0.2]}
    for monitor, patience, delta in (("loss", 1, 0.0), ("loss", 2, 0.02),
                                     ("acc", 2, 0.0)):
        got = []
        for cb in (jcb, tcb):
            es = cb.EarlyStopping(monitor=monitor, patience=patience,
                                  min_delta=delta)
            es.set_model(_Stub())
            es.model.stop_training = False
            stop = None
            for e, v in enumerate(seqs[monitor]):
                logs = {monitor: v} if e % 2 else {f"eval_{monitor}": v}
                es.on_epoch_end(e, logs)
                if es.model.stop_training and stop is None:
                    stop = e
            got.append((stop, es.best, es.wait))
        assert got[0] == got[1], monitor
    # through fit: an eval loss that never improves stops training
    net, hm = _linear_model()
    X = np.ones((4, 8), np.float32)
    Y = np.zeros(4, np.int64)
    es = tcb.EarlyStopping(monitor="eval_loss", patience=0, mode="max")
    hm.fit([(X, Y)], eval_data=[(X, Y)], epochs=5, verbose=0, callbacks=[es])
    assert hm.stop_training and es.wait == 1


def test_lr_scheduler_rates_equal():
    rates = {}
    for name, pkg, M, cb in (("jax", jp, JModel, jcb),
                             ("port", tp, TModel, tcb)):
        pkg.seed(7)
        net = (jnn if pkg is jp else tnn).Linear(8, 4)
        sched = pkg.optimizer.lr.StepDecay(learning_rate=0.5, step_size=2,
                                           gamma=0.5)
        opt = pkg.optimizer.SGD(learning_rate=sched,
                                parameters=net.parameters())
        model = M(net).prepare(optimizer=opt, loss=(
            jnn if pkg is jp else tnn).CrossEntropyLoss())
        seen = []

        class Rate(cb.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append(opt.get_lr())

        X = np.ones((2, 8), np.float32)
        Y = np.zeros(2, np.int64)
        model.fit([(X, Y)] * 3, epochs=2, verbose=0,
                  callbacks=[Rate(), cb.LRScheduler(by_step=True,
                                                    by_epoch=True)])
        rates[name] = seen
    assert rates["jax"] == rates["port"]
    assert rates["port"][0] == 0.5 and rates["port"][-1] < 0.5


def _fit_lines(pkg, M, cb, capsys, **kw):
    pkg.seed(7)
    net = (jnn if pkg is jp else tnn).Linear(8, 4)
    opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    model = M(net).prepare(optimizer=opt, loss=(
        jnn if pkg is jp else tnn).CrossEntropyLoss())
    rng = np.random.RandomState(1)
    data = [(rng.randn(2, 8).astype(np.float32),
             rng.randint(0, 4, 2).astype(np.int64)) for _ in range(3)]
    capsys.readouterr()
    model.fit(data, eval_data=data[:1], epochs=2, **kw)
    return re.sub(r"done in [0-9.]+s", "done in Ts", capsys.readouterr().out)


def test_progbar_lines_and_visualdl_scalars_equal(capsys, tmp_path):
    j = _fit_lines(jp, JModel, jcb, capsys, verbose=2, log_freq=1)
    t = _fit_lines(tp, TModel, tcb, capsys, verbose=2, log_freq=1)
    assert j == t and t.count("Epoch 1 step") == 3 and "eval_loss" in t
    scalars = []
    for pkg, M, cb, d in ((jp, JModel, jcb, "j"), (tp, TModel, tcb, "t")):
        _fit_lines(pkg, M, cb, capsys, verbose=0,
                   callbacks=[cb.VisualDL(str(tmp_path / d))],
                   save_dir=str(tmp_path / f"ck{d}"))
        lines = [json.loads(x) for x in
                 (tmp_path / d / "scalars.jsonl").read_text().splitlines()]
        scalars.append([x for x in lines
                        if not x["tag"].startswith("metrics/")])
        assert any(x["tag"].startswith("metrics/") for x in lines)
        assert sorted(p.name for p in (tmp_path / f"ck{d}").iterdir()) == [
            "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
            "final.pdopt", "final.pdparams"]
    assert len(scalars[0]) == len(scalars[1]) == 6
    for a, b in zip(*scalars):
        assert (a["tag"], a["step"]) == (b["tag"], b["step"])
        assert abs(a["value"] - b["value"]) <= 1e-6


# ---------------------------------------------------- save, load, summary


def test_save_files_load_in_the_other_package(tmp_path):
    jnet, tnet = _conv_pair()
    jm = JModel(jnet).prepare(optimizer=jp.optimizer.Momentum(
        learning_rate=0.1, parameters=jnet.parameters()),
        loss=jnn.CrossEntropyLoss())
    tm = TModel(tnet).prepare(optimizer=tp.optimizer.Momentum(
        learning_rate=0.1, parameters=tnet.parameters()),
        loss=tnn.CrossEntropyLoss())
    x, y = _Images(4)[0]
    jm.fit([(x[None], y[None])] * 2, verbose=0)
    tm.fit([(x[None] + 1, y[None])] * 3, verbose=0)
    jm.save(str(tmp_path / "j"))
    tm.save(str(tmp_path / "t"))
    jnet2, tnet2 = _conv_pair()
    tm2 = TModel(tnet2).prepare(optimizer=tp.optimizer.Momentum(
        learning_rate=0.1, parameters=tnet2.parameters()))
    tm2.load(str(tmp_path / "j"))
    jm2 = JModel(jnet2).prepare(optimizer=jp.optimizer.Momentum(
        learning_rate=0.1, parameters=jnet2.parameters()))
    jm2.load(str(tmp_path / "t"))
    _close(_state(tnet2), _state(jnet), 0.0)
    _close(_state(jnet2), _state(tnet), 0.0)
    assert tm2._optimizer._global_step == 2
    assert jm2._optimizer._global_step == 3


def test_summary_counts_equal(capsys):
    jnet, tnet = _conv_pair()
    for n in (jnet, tnet):
        n[1].weight.stop_gradient = True
    capsys.readouterr()
    j = jp.summary(jnet)
    jtext = capsys.readouterr().out
    t = tp.summary(tnet)
    assert t == j == TModel(tnet).summary()
    assert capsys.readouterr().out.startswith(jtext)
    assert t["trainable_params"] == t["total_params"] - 4
    assert [p.shape for p in TModel(tnet).parameters()] == \
        [p.shape for p in tnet.parameters()]
