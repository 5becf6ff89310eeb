"""The port's `CheckpointManager` against the JAX package's, continued
from `tests/test_torch_fault_tolerance.py` (its sides, records and
comparison): a resume bit-identical to the uninterrupted run, a SIGTERM
drain, the emulated multi-host publication scenarios of the JAX
`tests/test_train_elastic.py` (key-partitioned saves, the barrier
timeout, a crash between shards, forced synchronous saves), and
checkpoints resumed across the packages: a JAX-written one by the port
and a port-written one by JAX, each continuing with the other's losses
(within 1e-5), the restored leaves and key chain exact.
"""
import json
import os
import signal

import jax
import jax.experimental
import numpy as np
import pytest

from paddle_tpu.testing import faults as jfaults
from paddle_tpu.train import CheckpointManager as JManager
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.train import CheckpointManager as TManager
from tests.test_torch_fault_tolerance import (SIDES, _batch, _index_layout,
                                              _jax_step, _outcome,
                                              _torch_step, _tree, both)
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.tensor import torch_state


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _x64_and_faults(monkeypatch):
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)
    yield
    jfaults.disarm()
    tfaults.disarm()


def sc_resume_bit_identical(side, root):
    """Six uninterrupted steps against four, a fresh step and manager
    resuming from LATEST, and two more: the same losses bit for bit
    within the package, and the same parameters."""
    whole = side.make(5)
    ref = [whole.step(*_batch(i)) for i in range(6)]
    step = side.make(5)
    mgr = side.Manager(root, step, every=2, keep=2)
    first = mgr.run(lambda i: _batch(i), until_step=4)
    step2 = side.make(99)
    rest = side.Manager(root, step2, every=2, keep=2).run(
        lambda i: _batch(i), until_step=6)
    return {"bit_identical": [repr(x) for x in first + rest]
            == [repr(x) for x in ref],
            "params": bool(np.array_equal(side.wte(step2), side.wte(whole))),
            "tree": _tree(root), "layout": _index_layout(os.path.join(
                root, "step-00000006")), "losses": first + rest}


def sc_sigterm(side, root):
    """``run(install_sigterm=True)``: a SIGTERM at step 2 finishes that
    step, writes a synchronous checkpoint and returns; a fresh step
    resumes from it and matches the uninterrupted run."""
    whole = side.make(5)
    ref = [whole.step(*_batch(i)) for i in range(4)]
    prev = signal.getsignal(signal.SIGTERM)
    step = side.make(5)
    mgr = side.Manager(root, step, every=10, use_async=True)

    def on_step(n, loss, ok):
        if n == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    try:
        first = mgr.run(lambda i: _batch(i), until_step=4, on_step=on_step,
                        install_sigterm=True)
    finally:
        signal.signal(signal.SIGTERM, prev)
    rec = {"stopped_at": side.gs(step), "latest": mgr.latest()[0],
           "tree": _tree(root)}
    rest = side.Manager(root, side.make(99)).run(lambda i: _batch(i),
                                                 until_step=4)
    rec.update(equal=[repr(x) for x in first + rest]
               == [repr(x) for x in ref], losses=first + rest)
    return rec


def sc_multihost_partitioned(side, root):
    step = side.make(5)
    losses = [step.step(*_batch(0))]
    tags = []
    mgr1 = side.Manager(root, step, world=(1, 2), barrier=tags.append)
    mgr0 = side.Manager(root, step, world=(0, 2), barrier=tags.append)
    mgr1.save(data_cursor=1)
    before = mgr1.latest()
    mgr0.save(data_cursor=1)
    lat = mgr0.latest()
    owners = {}
    for pid in (0, 1):
        idx = json.load(open(os.path.join(lat[1], f"index.p{pid}.json")))
        owners[pid] = [k for k in idx if k != "__ckpt_meta__"
                       and "literal" not in idx[k]]
    step2 = side.make(99)
    info = side.Manager(root, step2, world=(0, 1)).restore(require=True)
    rec = {"before": before, "tags": tags, "owners": owners,
           "info": info["data_cursor"],
           "same": bool(np.array_equal(side.wte(step2), side.wte(step))),
           "layout": _index_layout(lat[1])}
    os.remove(os.path.join(lat[1], "index.p1.json"))
    rec["err"] = _outcome(lambda: side.Manager(
        root, side.make(7), world=(0, 1)).restore(require=True), root)
    rec["losses"] = losses
    return rec


def sc_multihost_barrier_timeout(side, root):
    step = side.make(5)
    losses = [step.step(*_batch(0))]
    mgr = side.Manager(root, step, world=(0, 2), barrier=lambda t: None)
    with side.faults.scoped("ckpt.barrier_timeout", times=1):
        err = _outcome(lambda: mgr.save(data_cursor=1), root)
    rec = {"err": err, "latest": mgr.latest(), "tree": _tree(root)}
    mgr.save(data_cursor=1)
    rec.update(after=mgr.latest()[0], losses=losses)
    return rec


def sc_multihost_crash_and_sync(side, root):
    step = side.make(5)
    losses = [step.step(*_batch(0))]
    mgr = side.Manager(root, step, world=(0, 2), barrier=lambda t: None)
    with side.faults.scoped("ckpt.crash_between_shards", times=1):
        err = _outcome(lambda: mgr.save(data_cursor=1), root)
    rec = {"err": err[0], "latest": mgr.latest()}
    single = side.Manager(root, step, world=(0, 1), use_async=True)
    mgr2 = side.Manager(root, step, world=(0, 2), use_async=True,
                        barrier=lambda t: None)
    mgr2.save(data_cursor=1)
    rec.update(multihost=(single.multihost, mgr2.multihost),
               pending=mgr2._pending is None, losses=losses)
    return rec


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_resume_bit_identical, sc_sigterm, sc_multihost_partitioned,
    sc_multihost_barrier_timeout, sc_multihost_crash_and_sync)}

EXPECT = {
    "resume_bit_identical": lambda r: r["bit_identical"] and r["params"],
    "sigterm": lambda r: r["stopped_at"] == 2 and r["latest"] == 2
    and r["equal"] and "train.sigterm" in r["events"],
    "multihost_partitioned": lambda r: r["before"] is None
    and any(t.endswith("/shards") for t in r["tags"]) and all(r["owners"].values())
    and r["info"] == 1 and r["same"]
    and r["err"][0] == "CheckpointIncomplete",
    "multihost_barrier_timeout": lambda r: r["err"][0] == "PeerLost"
    and "barrier" in r["err"][1] and r["latest"] is None
    and "LATEST" not in r["tree"] and r["after"] == 1
    and r["counters"]["train.peer_lost"] == 1,
    "multihost_crash_and_sync": lambda r: r["err"] == "FaultInjected"
    and r["latest"] is None and r["multihost"] == (False, True)
    and r["pending"],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(tmp_path, name):
    rec = both(SCENARIOS[name], tmp_path)
    assert EXPECT[name](rec), rec


def test_multihost_owners_follow_shard_owner(tmp_path):
    step = _torch_step(5)
    step.step(*_batch(0))
    root = str(tmp_path)
    for r in (1, 0):
        TManager(root, step, world=(r, 2), barrier=lambda t: None).save(
            data_cursor=1)
    lat = TManager(root, step).latest()[1]
    for pid in (0, 1):
        idx = json.load(open(os.path.join(lat, f"index.p{pid}.json")))
        keys = [k for k in idx if k != "__ckpt_meta__"
                and "literal" not in idx[k]]
        assert keys and all(tckpt.shard_owner(k, 2) == pid for k in keys)


# -------------------------------------------------- across the packages


def _continue(side, root, n0, n1, sched=None):
    step = side.make(99, sched=sched)
    info = side.Manager(root, step).restore(require=True)
    out = []
    for i in range(n0, n1):
        out.append(step.step(*_batch(i)))
        if sched:
            side.sched(step).step()
    return info, out, step


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """Three steps (with a NoamDecay schedule of peak rate 0.0125: a
    larger one makes the two packages' uninterrupted runs part by more
    than 1e-5 within six steps) and a synchronous save by
    one package; the other restores it (the same parameters, optimizer
    state, key chain, clock and schedule) and continues with the
    writer's own continuation's losses."""
    w, r = SIDES[writer], SIDES["torch" if writer == "jax" else "jax"]
    root = str(tmp_path / "ck")
    step = w.make(5, sched=0.01)
    mgr = w.Manager(root, step)
    for i in range(3):
        step.step(*_batch(i))
        w.sched(step).step()
    mgr.save(data_cursor=3, sync=True)
    want = []
    for i in range(3, 6):
        want.append(step.step(*_batch(i)))
        w.sched(step).step()
    info, got, other = _continue(r, root, 3, 6, sched=0.01)
    assert info["step"] == 3 and info["data_cursor"] == 3
    assert np.allclose(got, want, rtol=0, atol=1e-5), (got, want)
    assert r.sched(other).last_epoch == w.sched(step).last_epoch


def test_port_restore_is_exact_from_a_jax_checkpoint(tmp_path):
    """The restored leaves equal the JAX step's saved ones bit for bit,
    and the key chain's words are the JAX key's."""
    js = _jax_step(5)
    root = str(tmp_path / "ck")
    js.step(*_batch(0))
    JManager(root, js).save(data_cursor=1, sync=True)
    ts = _torch_step(99)
    TManager(root, ts).restore(require=True)
    for grp in ("blocks", "top"):
        for k in js._params[grp]:
            assert np.array_equal(ts._params[grp][k].detach().numpy(),
                                  np.asarray(js._params[grp][k])), k
            for n in js._opt_state[grp][k]:
                assert np.array_equal(ts._opt_state[grp][k][n].numpy(),
                                      np.asarray(js._opt_state[grp][k][n]))
    assert np.array_equal(ts.key_data(),
                          np.asarray(jax.random.key_data(js._key)))
    assert ts.opt.global_step == 1
    assert torch_state(ts.model)["gpt.wte.weight"].equal(
        ts._params["top"]["gpt.wte.weight"].detach())


def test_checkpoint_index_bytes_equal_before_and_after_steps(tmp_path):
    """The manager's index lists the leaves in the JAX step's order: the
    stacking order before any step, sorted after one (its jitted step's
    pytrees); the literal meta entries are byte-equal."""
    for n_steps in (0, 1):
        idx = {}
        for pkg, side in SIDES.items():
            step = side.make(5)
            for i in range(n_steps):
                step.step(*_batch(i))
            d = side.Manager(str(tmp_path / f"{pkg}{n_steps}"), step).save(
                data_cursor=n_steps, sync=True)
            raw = json.load(open(os.path.join(d, "index.json")))
            idx[pkg] = [(k, v.get("literal", (v.get("shape"), v.get("dtype"))))
                        for k, v in raw.items()]
        assert idx["torch"] == idx["jax"], n_steps
