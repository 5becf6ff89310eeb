"""The port's fault-tolerant training (`paddle_tpu_torch/train/
fault_tolerance.py::CheckpointManager` over its `ScanTrainStep`) held
against the JAX package's manager, scenario by scenario.

Each scenario of the JAX `tests/test_train_chaos.py` that needs neither
hapi nor a mesh and no real signal runs once with a JAX tiny GPT step and
once with the port's step on the same weights (`models/convert.py`), on
the CPU in float32, each side arming its own `testing/faults.py`. The
records must agree: losses within 1e-5, and exactly the checkpoint
directories and their files, LATEST, index layouts, error types and
texts, restored data cursors, the ``train.*`` counter deltas and the
manager's flight events. `tests/test_torch_fault_tolerance_fleet.py`
holds the resume, SIGTERM and emulated multi-host scenarios and the
resumes across the packages.

The JAX step's ``disable_x64`` import (ROADMAP C1) is answered for these
tests by ``jax.enable_x64(False)``, what that import did.
"""
import json
import os

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability.flight_recorder import flight as jflight
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.train import CheckpointManager as JManager
from paddle_tpu.train import ScanTrainStep as JStep
from paddle_tpu.train import TooManyBadSteps as JTooMany
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import train_state_from_numpy
from paddle_tpu_torch.observability.flight_recorder import flight as tflight
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.train import CheckpointManager as TManager
from paddle_tpu_torch.train import ScanTrainStep as TStep
from paddle_tpu_torch.train import TooManyBadSteps as TTooMany
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


pytestmark = pytest.mark.chaos

TINY = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            intermediate_size=32, max_position_embeddings=8,
            hidden_dropout=0.0, attention_dropout=0.0)
COUNTERS = ("train.checkpoints", "train.resumes", "train.bad_steps",
            "train.rollbacks", "train.resume_corrupt_skipped",
            "train.steps", "train.peer_lost")
EVENTS = ("train.checkpoint", "train.checkpoint_complete", "train.resume",
          "train.resume_skipped_corrupt", "train.rollback",
          "train.bad_step", "train.sigterm", "train.run_batch_budget")


@pytest.fixture(autouse=True)
def _x64_and_faults(monkeypatch):
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)
    yield
    jfaults.disarm()
    tfaults.disarm()


def _batch(i, b=2, s=8, vocab=64):
    rng = np.random.RandomState(1000 + i)
    ids = rng.randint(0, vocab, (b, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def _sched(mod, base):
    return mod.NoamDecay(d_model=16, warmup_steps=4, learning_rate=base)


def _jax_step(seed, sched=False):
    paddle.seed(seed)
    m = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    lr = _sched(jlr, sched) if sched else 1e-3
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=m.parameters())
    return JStep(m, opt, microbatches=1)


def _torch_step(seed, sched=False):
    """The port's step on the weights and state the JAX step starts
    from."""
    js = _jax_step(seed)
    tree = lambda t: jax.tree_util.tree_map(np.array, t)   # noqa: E731
    params, opt_state = train_state_from_numpy(tree(js._params),
                                               tree(js._opt_state), "cpu")
    m = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY))
    m.set_state_dict(params)
    opt = AdamW(learning_rate=_sched(tlr, sched) if sched else 1e-3)
    opt.state = opt_state
    return TStep(m, opt, microbatches=1, device="cpu")


class Side:
    """One package's pieces, named alike."""

    def __init__(self, pkg):
        self.pkg = pkg
        jax_side = pkg == "jax"
        self.make = _jax_step if jax_side else _torch_step
        self.Manager = JManager if jax_side else TManager
        self.TooMany = JTooMany if jax_side else TTooMany
        self.faults = jfaults if jax_side else tfaults
        self.obs = jobs if jax_side else tobs
        self.flight = jflight if jax_side else tflight
        self.ckpt = jckpt if jax_side else tckpt
        self.lr = jlr if jax_side else tlr

    def gs(self, step):
        return int(step.opt._global_step if self.pkg == "jax"
                   else step.opt.global_step)

    @staticmethod
    def leaf(tree, *path):
        v = tree
        for k in path:
            v = v[k]
        return np.array(v.detach().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v))

    def wte(self, step):
        return self.leaf(step._params, "top", "gpt.wte.weight")

    def m1(self, step):
        return self.leaf(step._opt_state, "top", "gpt.wte.weight", "moment1")

    def sched(self, step):
        return step.opt._learning_rate if self.pkg == "jax" \
            else step.opt.learning_rate


SIDES = {p: Side(p) for p in ("jax", "torch")}


def _outcome(fn, root):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the record
        return (type(e).__name__, str(e).replace(root, "ROOT"))


def _tree(root):
    """Every checkpoint dir's sorted file names, and LATEST's content."""
    out = {}
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if os.path.isdir(p):
            out[name] = sorted(os.listdir(p))
        elif name == "LATEST":
            out[name] = open(p).read()
    return out


def _index_layout(path):
    """Each index file's (key, shape, dtype, file names) in order — the
    layout without the checksums."""
    out = {}
    for f in sorted(os.listdir(path)):
        if f.startswith("index") and f.endswith(".json"):
            idx = json.load(open(os.path.join(path, f)))
            out[f] = [(k, v.get("literal", (v.get("shape"), v.get("dtype"),
                                            [e["file"] for e in
                                             v.get("shards", [])])))
                      for k, v in idx.items() if k != "__ckpt_meta__"]
    return out


def _run(side, scenario, tmp_path):
    root = str(tmp_path / side.pkg)
    snap0 = side.obs.snapshot()["counters"]
    side.flight.clear()
    rec = scenario(side, root)
    snap = side.obs.snapshot()["counters"]
    rec["counters"] = {c: snap.get(c, 0) - snap0.get(c, 0) for c in COUNTERS}
    # sorted: an async save's writer thread records its completion while
    # the step loop records the save, in either order
    rec["events"] = sorted(e["kind"] for e in side.flight.events()
                           if e["kind"] in EVENTS)
    return rec


def both(scenario, tmp_path):
    got = {p: _run(SIDES[p], scenario, tmp_path) for p in SIDES}
    jl, tl = got["jax"].pop("losses", []), got["torch"].pop("losses", [])
    assert len(jl) == len(tl)
    assert np.allclose(np.asarray(tl, np.float64), np.asarray(jl, np.float64),
                       rtol=0, atol=1e-5, equal_nan=True), (tl, jl)
    assert got["torch"] == got["jax"]
    return got["torch"]


# -------------------------------------------------------------- scenarios


def sc_crash_between_shards(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, keep=3)
    losses = [step.step(*_batch(0))]
    mgr.save(data_cursor=1, sync=True)
    ref = side.wte(step)
    losses.append(step.step(*_batch(1)))
    with side.faults.scoped("ckpt.crash_between_shards", times=1):
        err = _outcome(lambda: mgr.save(data_cursor=2, sync=True), root)
    rec = {"err": err[0], "tree": _tree(root), "latest": mgr.latest()[0],
           "complete": [n for n, _ in mgr.complete_checkpoints()]}
    info = mgr.restore(require=True)
    rec.update(info=(info["step"], info["data_cursor"]),
               restored=bool(np.array_equal(side.wte(step), ref)),
               losses=losses)
    return rec


def sc_retention(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, every=1, keep=2)
    losses = mgr.run(lambda i: _batch(i), until_step=5)
    kept = [n for n, _ in mgr.complete_checkpoints()]
    mgr2 = side.Manager(root, side.make(99), every=1, keep=2)
    losses += mgr2.run(lambda i: _batch(i), until_step=8)
    return {"kept": kept, "kept2": [n for n, _ in mgr2.complete_checkpoints()],
            "tree": _tree(root),
            "layout": _index_layout(mgr2.latest()[1]), "losses": losses}


def sc_async_failure(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, use_async=True)
    losses = [step.step(*_batch(0))]
    with side.faults.scoped("ckpt.crash_between_shards", times=1):
        mgr.save(data_cursor=1)
        err = _outcome(mgr.wait, root)
    latest = mgr.latest()
    mgr.save(data_cursor=1, sync=True)
    return {"err": err, "latest_before": latest, "latest": mgr.latest()[0],
            "losses": losses}


def sc_async_snapshot(side, root):
    step = side.make(5)
    losses = [step.step(*_batch(0))]
    ref = (side.wte(step), side.m1(step))
    h = side.ckpt.async_save({"params": step._params,
                              "opt": step._opt_state}, root)
    losses += [step.step(*_batch(1)), step.step(*_batch(2))]
    h.wait()
    out = side.ckpt.load_sharded(root, return_numpy=True)
    return {"wte": bool(np.array_equal(
                np.asarray(out["params/top/gpt.wte.weight"]), ref[0])),
            "m1": bool(np.array_equal(
                np.asarray(out["opt/top/gpt.wte.weight/moment1"]), ref[1])),
            "moved": not np.array_equal(side.wte(step), ref[0]),
            # the caller's own trees: each package keeps their order
            "layout": {f: sorted(v) for f, v in _index_layout(root).items()},
            "losses": losses}


def sc_bad_step(side, root):
    step = side.make(5)
    losses = [step.step(*_batch(0))]
    gs, wte, m1 = side.gs(step), side.wte(step), side.m1(step)
    with side.faults.scoped("train.step_nan", times=1):
        losses.append(step.step(*_batch(1)))
    rec = {"ok": step.last_step_ok, "consec": step.consecutive_bad_steps,
           "clock": side.gs(step) == gs,
           "same": bool(np.array_equal(side.wte(step), wte)
                        and np.array_equal(side.m1(step), m1))}
    losses.append(step.step(*_batch(2)))
    rec.update(consec_after=step.consecutive_bad_steps,
               compiles=step.compile_count, losses=losses)
    return rec


def sc_rollback(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, every=2, keep=2, max_consecutive_bad=2)
    losses = mgr.run(lambda i: _batch(i), until_step=2)
    ckpt_wte = side.wte(step)
    side.faults.arm("train.step_nan", times=-1)
    try:
        err = _outcome(lambda: mgr.run(lambda i: _batch(i), until_step=9,
                                       resume=False, data_cursor=2), root)
    finally:
        side.faults.disarm()
    rec = {"err": err, "gs": side.gs(step),
           "restored": bool(np.array_equal(side.wte(step), ckpt_wte))}
    losses += mgr.run(lambda i: _batch(i), until_step=4, resume=False,
                      data_cursor=4)
    rec.update(tree=_tree(root), losses=losses)
    return rec


def _edit_index(d, fn):
    for name in os.listdir(d):
        if name.startswith("index.") and name.endswith(".json"):
            p = os.path.join(d, name)
            idx = json.load(open(p))
            fn(idx)
            json.dump(idx, open(p, "w"))


def sc_missing_leaves(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step)
    losses = [step.step(*_batch(0))]
    d = mgr.save(data_cursor=1, sync=True)
    _edit_index(d, lambda idx: idx.pop(
        next(k for k in idx if k.startswith("params/"))))
    err = _outcome(lambda: side.Manager(root, side.make(99)).restore(
        require=True), root)
    return {"err": err, "losses": losses}


def sc_extra_leaves(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step)
    losses = [step.step(*_batch(0))]
    d = mgr.save(data_cursor=1, sync=True)

    def ghost(idx):
        src = next(k for k in idx if k.startswith("params/top/"))
        idx["params/top/ghost.weight"] = idx[src]
    _edit_index(d, ghost)
    err = _outcome(lambda: side.Manager(root, side.make(99)).restore(
        require=True), root)
    return {"err": err, "losses": losses}


def sc_finalize_cursor(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, every=1, keep=3, max_consecutive_bad=5)
    side.faults.arm("train.step_nan", times=1)
    try:
        losses = [step.step(*_batch(0))]
        mgr.after_step(data_cursor=1)
        losses.append(step.step(*_batch(1)))
        mgr.after_step(data_cursor=2)
    finally:
        side.faults.disarm()
    mgr.finalize(data_cursor=2)
    info = side.Manager(root, side.make(99)).restore(require=True)
    return {"info": (info["step"], info["data_cursor"]), "tree": _tree(root),
            "losses": losses}


def sc_rollback_without_checkpoint(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, max_consecutive_bad=1)
    with side.faults.scoped("train.step_nan", times=1):
        losses = [step.step(*_batch(0))]
    return {"err": _outcome(mgr.after_step, root), "losses": losses}


def sc_fit_style_cursor(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step)
    losses = [step.step(*_batch(0))]
    mgr.save(data_cursor=[0, 1], sync=True)
    mgr2 = side.Manager(root, side.make(99))
    err = _outcome(lambda: mgr2.run(lambda i: _batch(i), until_step=4), root)
    return {"err": err, "losses": losses}


def sc_rewrite_crash(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, keep=3)
    losses = [step.step(*_batch(0))]
    mgr.save(data_cursor=1, sync=True)
    ref = side.wte(step)
    with side.faults.scoped("ckpt.crash_between_shards", times=1):
        err = _outcome(lambda: mgr.save(data_cursor=2, sync=True), root)
    step2 = side.make(99)
    info = side.Manager(root, step2).restore(require=True)
    rec = {"err": err[0], "info": (info["step"], info["data_cursor"]),
           "restored": bool(np.array_equal(side.wte(step2), ref))}
    mgr2 = side.Manager(root, step2)
    mgr2.finalize(data_cursor=5)
    rec.update(cursor=mgr2._saved_cursor(mgr2.latest()[1]),
               tree=_tree(root), losses=losses)
    return rec


def sc_broken_complete_dir(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, every=1, keep=3)
    losses = mgr.run(lambda i: _batch(i), until_step=3)
    newest = mgr.latest()[1]
    victim = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))[0]
    os.remove(os.path.join(newest, victim))
    info = side.Manager(root, side.make(99)).restore(require=True)
    return {"step": info["step"], "losses": losses}


def sc_lr_scheduler(side, root):
    step = side.make(5, sched=1.0)
    sched = side.sched(step)
    mgr = side.Manager(root, step)
    losses = []
    for i in range(3):
        losses.append(step.step(*_batch(i)))
        sched.step()
    mgr.save(data_cursor=3, sync=True)
    cont = step.step(*_batch(3))
    step2 = side.make(99, sched=1.0)
    sched2 = side.sched(step2)
    fresh = sched2.last_epoch
    side.Manager(root, step2).restore(require=True)
    rec = {"fresh": fresh, "epoch": (sched2.last_epoch, sched.last_epoch),
           "lr": sched2.last_lr == sched.last_lr,
           "lr_sched": json.loads(tckpt.read_literal(
               mgr.latest()[1], "meta/lr_sched"))}
    again = step2.step(*_batch(3))
    rec.update(bit_identical=again == cont, losses=losses + [cont, again])
    return rec


def sc_corrupt_latest(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, every=1, keep=3)
    losses = mgr.run(lambda i: _batch(i), until_step=3)
    newest = mgr.latest()
    shard = next(f for f in sorted(os.listdir(newest[1]))
                 if f.startswith("params") and f.endswith(".npy"))
    p = os.path.join(newest[1], shard)
    blob = bytearray(open(p, "rb").read())
    blob[-1] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    info = side.Manager(root, side.make(99)).restore(require=True)
    return {"newest": newest[0], "step": info["step"], "losses": losses}


def sc_nan_storm(side, root):
    step = side.make(5)
    mgr = side.Manager(root, step, max_consecutive_bad=0)
    side.faults.arm("train.step_nan", times=-1)
    try:
        losses = mgr.run(lambda i: _batch(i), until_step=100, resume=False,
                         max_batches=5)
    finally:
        side.faults.disarm()
    return {"n": len(losses), "finite": any(np.isfinite(losses)),
            "gs": side.gs(step), "tree": _tree(root), "losses": losses}


def sc_missing_latest(side, root):
    mgr = side.Manager(os.path.join(root, "empty"))
    return {"none": mgr.restore() is None,
            "err": _outcome(lambda: mgr.restore(require=True), root)}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_crash_between_shards, sc_retention, sc_async_failure,
    sc_async_snapshot, sc_bad_step, sc_rollback, sc_missing_leaves,
    sc_extra_leaves, sc_finalize_cursor, sc_rollback_without_checkpoint,
    sc_fit_style_cursor, sc_rewrite_crash, sc_broken_complete_dir,
    sc_lr_scheduler, sc_corrupt_latest, sc_nan_storm, sc_missing_latest)}

# what each scenario must show, beyond the two packages agreeing
EXPECT = {
    "crash_between_shards": lambda r: r["err"] == "FaultInjected"
    and r["latest"] == 1 and r["complete"] == [1] and r["info"] == (1, 1)
    and r["restored"],
    "retention": lambda r: r["kept"] == [4, 5] and 5 in r["kept2"]
    and r["kept2"][-2:] == [7, 8],
    "async_failure": lambda r: r["err"][0] == "FaultInjected"
    and r["latest_before"] is None and r["latest"] == 1,
    "async_snapshot": lambda r: r["wte"] and r["m1"] and r["moved"],
    "bad_step": lambda r: not r["ok"] and r["consec"] == 1 and r["clock"]
    and r["same"] and r["consec_after"] == 0 and r["compiles"] == 1
    and r["counters"]["train.bad_steps"] == 1,
    "rollback": lambda r: r["err"][0] == "TooManyBadSteps"
    and "rolled back to step 2" in r["err"][1] and r["gs"] == 2
    and r["restored"] and r["counters"]["train.rollbacks"] == 1,
    "missing_leaves": lambda r: r["err"][0] == "CheckpointIncomplete"
    and "leaves" in r["err"][1],
    "extra_leaves": lambda r: r["err"][0] == "CheckpointCorrupt"
    and "no slot" in r["err"][1],
    "finalize_cursor": lambda r: r["info"] == (1, 2),
    "rollback_without_checkpoint": lambda r: r["err"][0] == "TooManyBadSteps"
    and "no checkpoint" in r["err"][1],
    "fit_style_cursor": lambda r: r["err"][0] == "ValueError"
    and "data_cursor" in r["err"][1],
    "rewrite_crash": lambda r: r["info"] == (1, 1) and r["restored"]
    and r["cursor"] == 5,
    "broken_complete_dir": lambda r: r["step"] == 2,
    "lr_scheduler": lambda r: r["fresh"] == 0 and r["epoch"][0]
    == r["epoch"][1] and r["lr"] and r["bit_identical"],
    "corrupt_latest": lambda r: r["newest"] == 3 and r["step"] == 2
    and r["counters"]["train.resume_corrupt_skipped"] == 1,
    "nan_storm": lambda r: r["n"] == 5 and not r["finite"] and r["gs"] == 0,
    "missing_latest": lambda r: r["none"] and r["err"][0]
    == "CheckpointIncomplete" and "LATEST" in r["err"][1],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(tmp_path, name):
    rec = both(SCENARIOS[name], tmp_path)
    assert EXPECT[name](rec), rec
