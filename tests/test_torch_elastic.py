"""The port's elastic training (`paddle_tpu_torch/train/elastic.py`) held
against the JAX package's (`paddle_tpu/train/elastic.py`).

- `FleetReducer`: the packed vector, the f32 rank mean and the stop vote
  bit-equal to the JAX reducer's, at world 1 and over a crafted two-rank
  stack (the JAX tests' patched allgather), with torch leaves on the
  port's side.
- The split step (grads, the reducer on the host, then the finite check,
  clip and update) equal bit for bit to the fused step, and to the JAX
  split step within 1e-5.
- `ElasticController`'s decisions, relaunches, give-ups and straggler
  kills on fake processes equal to the JAX controller's.
- One real two-process CPU fleet of the port (`spawn_local_fleet(...,
  device="cpu")`): both ranks train, checkpoint and exit 0, and their
  losses equal a one-process step with two microbatches on the same
  global batches.
- The real kill -9 and SIGTERM drills (marked slow, as the JAX package
  marks its own in `tests/test_wall_budget.py`): a dead peer turns into
  typed PeerLost (rc 23) on the survivor, the controller reforms the
  fleet at world 1 and it resumes equal to a one-process run from the
  same checkpoint; a SIGTERM on rank 1 drains both ranks at one step
  boundary into a complete checkpoint.
"""
import os
import shutil
import signal
import time

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import paddle_tpu.observability as jobs
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.train import elastic as jel
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.train import ScanTrainStep
from paddle_tpu_torch.train import elastic as tel
from tests.test_torch_fault_tolerance import SIDES, _batch
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)


def _grads(seed=0):
    rng = np.random.RandomState(seed)
    return {"top": {"b": rng.randn(3).astype(np.float32),
                    "a": rng.randn(2, 2).astype(np.float32),
                    "e": np.zeros((0,), np.float32)},
            "blocks": {"w": rng.randn(2, 3, 4).astype(np.float32),
                       "s": np.float32(rng.randn())}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _flat(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _flat(v) if isinstance(v, dict) else [np.asarray(v)]
    return out


def test_reducer_world1_identity_and_stop_vote():
    jr, tr = jel.FleetReducer(), tel.FleetReducer()
    g = _grads()
    for stop in (False, True):
        jr.request_stop = tr.request_stop = stop
        jl, jg = jr(np.float32(2.5), g)
        tl, tg = tr(torch.tensor(2.5), _torch_tree(g))
        assert tr.fleet_stop == jr.fleet_stop == stop
        assert np.asarray(tl).tobytes() == np.asarray(jl).tobytes()
        for a, b in zip(_flat(tg), _flat(jg)):
            assert a.dtype == np.float32 and a.shape == b.shape
            assert a.tobytes() == np.asarray(b).tobytes()
    assert tr.reduces == jr.reduces == 2


@pytest.mark.parametrize("peer_stop", [0.0, 1.0])
def test_reducer_means_ranks_and_ors_stop(monkeypatch, peer_stop):
    """A crafted two-rank stack (the peer's values the local ones plus a
    random offset, its vote ``peer_stop``): the packed vectors, the f32
    mean and the vote bit-equal across the packages."""
    captured = {}

    def fake(pkg):
        def allgather(flat):
            captured[pkg] = np.asarray(flat).copy()
            other = np.asarray(flat).copy()
            other[:-1] += np.random.RandomState(7).randn(
                other.size - 1).astype(np.float32)
            other[-1] = peer_stop
            return np.stack([np.asarray(flat), other])
        return allgather

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jcoll, "_proc_allgather", fake("jax"))
    monkeypatch.setattr(tcoll, "_multiprocess", lambda: True)
    monkeypatch.setattr(tcoll, "_proc_allgather", fake("torch"))
    g = _grads(3)
    jl, jg = jel.FleetReducer()(np.float32(3.0), g)
    tr = tel.FleetReducer()
    tl, tg = tr(torch.tensor(3.0), _torch_tree(g))
    assert captured["torch"].tobytes() == captured["jax"].tobytes()
    assert captured["torch"][-1] == 0.0
    assert tr.fleet_stop == bool(peer_stop)
    assert np.asarray(tl).tobytes() == np.asarray(jl).tobytes()
    for a, b in zip(_flat(tg), _flat(jg)):
        assert a.tobytes() == np.asarray(b).tobytes()
    assert set(tr.timings) == {"pack", "publish", "read", "barrier",
                               "unpack", "bytes"}


def test_split_step_equal_to_fused_and_to_jax():
    """The identity reducer (a world-1 FleetReducer) in split mode: the
    port's losses and parameters bit-equal its fused step's, and within
    1e-5 of the JAX split step's."""
    t = SIDES["torch"]
    fused = t.make(5)
    ref = [fused.step(*_batch(i)) for i in range(3)]
    split = t.make(5)
    split._grad_reducer = tel.FleetReducer()
    got = [split.step(*_batch(i)) for i in range(3)]
    assert [repr(a) for a in got] == [repr(b) for b in ref]
    assert np.array_equal(t.wte(split), t.wte(fused))
    assert split._grad_reducer.reduces == 3
    js = SIDES["jax"].make(5)
    from paddle_tpu.train import ScanTrainStep as JStep
    jsplit = JStep(js.model, js.opt, grad_reducer=jel.FleetReducer())
    want = [jsplit.step(*_batch(i)) for i in range(3)]
    assert np.allclose(got, want, rtol=0, atol=1e-5)


def test_split_step_poison_skips_on_every_rank():
    """``train.step_nan`` in split mode: the NaN rides the loss through
    the reduce, so the reduced loss is NaN and the step is skipped."""
    from paddle_tpu_torch.testing import faults
    step = SIDES["torch"].make(5)
    red = tel.FleetReducer()
    step._grad_reducer = red
    with faults.scoped("train.step_nan", times=1):
        loss = step.step(*_batch(0))
    assert np.isnan(loss) and not step.last_step_ok
    assert step.opt.global_step == 0 and red.reduces == 1


# --------------------------------------------------------- the controller


class _FakeProc:
    def __init__(self, rc):
        self._rc = rc
        self.killed = False

    def poll(self):
        return self._rc

    def wait(self, timeout=None):
        return self._rc

    def kill(self):
        self.killed = True
        self._rc = -9


def _ctl_record(mod, obs):
    """Every controller scenario of the JAX tests, one package."""
    c0 = obs.snapshot()["counters"].get("train.elastic_restarts", 0)
    ctl = mod.ElasticController(lambda w, a: [], world_size=4,
                                allowed_sizes=(1, 2, 4), min_world=1)
    rec = [ctl.decide_next_world(rcs) for rcs in (
        [23, 23, 23, -9], [23, -9, -9, -9], [-9, -9, -9, -9], [0, 23])]
    ctl2 = mod.ElasticController(lambda w, a: [], world_size=4,
                                 allowed_sizes=(2, 4), min_world=2)
    rec.append(ctl2.decide_next_world([23, -9, -9, -9]))
    script = {0: [mod.EXIT_PEER_LOST] * 3 + [-9], 1: [0, 0]}
    seen = []

    def spawn(world, attempt):
        seen.append((world, attempt))
        return [_FakeProc(rc) for rc in script[attempt]]

    ctl3 = mod.ElasticController(spawn, world_size=4,
                                 allowed_sizes=(1, 2, 4), max_restarts=2,
                                 settle_s=1.0, poll_s=0.01)
    rec += [ctl3.run(), seen, ctl3.attempts]
    ctl4 = mod.ElasticController(
        lambda w, a: [_FakeProc(mod.EXIT_PEER_LOST), _FakeProc(-9)],
        world_size=2, allowed_sizes=(1, 2), max_restarts=1, settle_s=1.0,
        poll_s=0.01)
    rec += [ctl4.run(), len(ctl4.attempts)]
    hung = _FakeProc(None)
    ctl5 = mod.ElasticController(lambda w, a: [_FakeProc(-9), hung],
                                 world_size=2, allowed_sizes=(1, 2),
                                 max_restarts=0, settle_s=0.1, poll_s=0.01)
    rec += [ctl5.run(), hung.killed, ctl5.attempts]
    rec.append(obs.snapshot()["counters"].get("train.elastic_restarts", 0)
               - c0)
    return rec


def test_controller_decisions_equal():
    assert tel.EXIT_PEER_LOST == jel.EXIT_PEER_LOST == 23
    got, want = _ctl_record(tel, tobs), _ctl_record(jel, jobs)
    assert got == want
    assert got[:5] == [2, 1, 0, 1, 0] and got[5] == 0 and got[-1] == 2


# ------------------------------------------------------ real CPU fleets


def _losses_of(path):
    return [float(line.split()[2]) for line in open(path)
            if line.startswith("STEP ")]


def _one_process_losses(steps, start=0, root=None, microbatches=2,
                        batch=4, seq=8, vocab=64, hidden=16, layers=2,
                        seed=5):
    """The drill's model and global batches, trained in one process with
    the global batch as ``microbatches`` (optionally from a
    checkpoint)."""
    cfg = tgpt.GPTConfig(vocab_size=vocab, hidden_size=hidden,
                         num_layers=layers, num_heads=2,
                         intermediate_size=2 * hidden,
                         max_position_embeddings=seq, hidden_dropout=0.0,
                         attention_dropout=0.0)
    model = tgpt.GPTForCausalLM(cfg,
                                generator=torch.Generator().manual_seed(seed))
    step = ScanTrainStep(model, AdamW(learning_rate=1e-3),
                         microbatches=microbatches, device="cpu")
    if root is not None:
        from paddle_tpu_torch.train import CheckpointManager
        CheckpointManager(root, step).restore(require=True)
    fn = tel._drill_batch_fn(batch, seq, vocab)
    return [step.step(*fn(c, 0, 1)) for c in range(start, steps)]


def test_two_process_cpu_fleet_trains_checkpoints_and_exits_0(tmp_path):
    root, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    procs = tel.spawn_local_fleet(2, root=root, until_step=4, log_dir=logs,
                                  every=2, deadline_s=20, device="cpu")
    rcs = [p.wait(timeout=240) for p in procs]
    assert rcs == [0, 0], [open(f"{logs}/rank{r}.a0.log").read()[-800:]
                           for r in (0, 1)]
    l0, l1 = (_losses_of(f"{logs}/rank{r}.a0.log") for r in (0, 1))
    assert len(l0) == 4 and l0 == l1
    # the f32 mean of two ranks' grads is the two-microbatch step's
    assert l0 == _one_process_losses(4)
    latest = open(os.path.join(root, "LATEST")).read().strip()
    assert latest == "step-00000004"
    assert os.path.exists(os.path.join(root, latest, "COMPLETE"))
    loaded = tckpt.load_sharded(os.path.join(root, latest))
    assert loaded["meta/global_step"] == 4 and loaded["meta/data_cursor"] == 4
    # each rank wrote its key partition
    assert {f for f in os.listdir(os.path.join(root, latest))
            if f.startswith("index.p")} == {"index.p0.json", "index.p1.json"}
    for r in (0, 1):
        assert "DONE 4 compiles=1 stopped=False" in open(
            f"{logs}/rank{r}.a0.log").read()


@pytest.mark.slow
def test_kill9_peer_reforms_at_world1_and_resumes_equal(tmp_path):
    """Rank 1 SIGKILLs itself at its 4th step boundary: rank 0 raises
    typed PeerLost and exits 23; the controller relaunches at world 1,
    which resumes from the last fleet-complete checkpoint (step 2) and
    finishes with the losses of a one-process run from it."""
    root, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    ref_root = str(tmp_path / "ref")

    def spawn(world, attempt):
        if attempt == 1:
            shutil.copytree(root, ref_root,
                            ignore=shutil.ignore_patterns("hb*"))
        env = (lambda r: {"PADDLE_FAULTS": "train.peer_dead:times=4"}
               if (attempt == 0 and r == 1) else {})
        return tel.spawn_local_fleet(world, root=root, until_step=6,
                                     log_dir=logs, every=2, deadline_s=4,
                                     env_for_rank=env, attempt=attempt,
                                     device="cpu")

    ctl = tel.ElasticController(spawn, world_size=2, settle_s=30)
    assert ctl.run() == 0, ctl.attempts
    assert ctl.attempts[0] == (2, [23, -9]) and ctl.attempts[1] == (1, [0])
    assert "PeerLost" in open(f"{logs}/rank0.a0.log").read()
    got = _losses_of(f"{logs}/rank0.a1.log")
    # a world-1 drill rank is one process with one microbatch
    want = _one_process_losses(6, start=2, root=ref_root, microbatches=1)
    assert got == want


@pytest.mark.slow
def test_sigterm_rank1_drains_fleet_to_complete_checkpoint(tmp_path):
    root, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    procs = tel.spawn_local_fleet(2, root=root, until_step=10_000,
                                  log_dir=logs, every=2, deadline_s=20,
                                  device="cpu")
    log1 = f"{logs}/rank1.a0.log"
    deadline = time.time() + 180
    while time.time() < deadline:
        txt = open(log1).read() if os.path.exists(log1) else ""
        if sum(1 for ln in txt.splitlines() if ln.startswith("STEP ")) >= 3:
            procs[1].send_signal(signal.SIGTERM)
            break
        time.sleep(0.1)
    else:
        pytest.fail("rank 1 never reached step 3")
    assert [p.wait(timeout=180) for p in procs] == [0, 0]
    latest = open(os.path.join(root, "LATEST")).read().strip()
    assert os.path.exists(os.path.join(root, latest, "COMPLETE"))
    loaded = tckpt.load_sharded(os.path.join(root, latest))
    assert int(loaded["meta/global_step"]) >= 3
    steps = [_losses_of(f"{logs}/rank{r}.a0.log") for r in (0, 1)]
    assert steps[0] == steps[1]
    for r in (0, 1):
        assert "stopped=True" in open(f"{logs}/rank{r}.a0.log").read()
