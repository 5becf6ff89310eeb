"""The port's ``nn.Layer`` (`paddle_tpu_torch/nn/layer.py`), containers and
optimizers (`paddle_tpu_torch/optimizer/`) held against the JAX package's,
on the CPU.

The Layer API: parameters and their names, ``named_*``, ``state_dict``
round trips with the JAX package (`models/convert.py`), train / eval,
forward hooks and the containers. The optimizers: each of the ten takes 3
steps on the same parameters and gradients in both packages (values
within 1e-6), and its ``state_dict`` carries into a fresh optimizer of the
other package and on for a fourth step."""
import numpy as np
import pytest

import paddle_tpu as jp

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models.convert import (layer_state_from_numpy,
                                             optimizer_state_from_numpy)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


def _net(m):
    nn = m.nn

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(6, 8)
            self.norm = nn.LayerNorm(8)
            self.act = nn.GELU()
            self.register_buffer("scale", m.ones([8]))

        def forward(self, x):
            return self.act(self.norm(self.fc(x))) * self.scale

    return nn.Sequential(Block(), nn.Dropout(0.0), nn.Linear(8, 3))


def _seeded(m, seed=0):
    m.seed(seed)
    return _net(m)


def test_parameters_names_and_state_dict_match_jax():
    t, j = _seeded(tp), _seeded(jp)
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    assert list(t.state_dict()) == list(j.state_dict())
    assert [n for n, _ in t.named_buffers()] == ["0.scale"]
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]
    assert len(t.parameters()) == 6
    assert all(isinstance(p, tp.Parameter) and not p.stop_gradient
               for p in t.parameters())
    for k, v in j.state_dict().items():
        np.testing.assert_allclose(t.state_dict()[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-7)


def test_state_dict_round_trip_with_jax():
    t, j = _seeded(tp, 1), _seeded(jp, 2)
    layer_state_from_numpy(t, {k: np.asarray(v.numpy())
                               for k, v in j.state_dict().items()})
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    np.testing.assert_allclose(t(tp.to_tensor(x)).numpy(),
                               j(jp.to_tensor(x)).numpy(), atol=1e-6)
    back = _seeded(jp, 3)
    missing, unexpected = back.set_state_dict(
        {k: jp.to_tensor(v.numpy()) for k, v in t.state_dict().items()})
    assert missing == [] and unexpected == []
    np.testing.assert_allclose(back(jp.to_tensor(x)).numpy(),
                               j(jp.to_tensor(x)).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="shape mismatch"):
        t.set_state_dict({"2.weight": np.zeros((3, 3), np.float32)})


def test_train_eval_and_forward_hooks():
    t = _seeded(tp)
    assert all(s.training for s in t.sublayers())
    t.eval()
    assert not any(s.training for s in t.sublayers()) and not t.training
    t.train()
    seen = []
    h1 = t[2].register_forward_pre_hook(lambda layer, inp: seen.append(
        "pre") or (inp[0] * 2,))
    h2 = t[2].register_forward_post_hook(lambda layer, inp, out: out + 1)
    x = tp.to_tensor(np.ones((2, 6), np.float32))
    hooked = t(x).numpy()
    h1.remove()
    h2.remove()
    plain = t[2](t[1](t[0](x)) * 2).numpy() + 1
    assert seen == ["pre"]
    np.testing.assert_allclose(hooked, plain)


def test_containers():
    nn = tp.nn
    ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
    ll.append(nn.Linear(2, 2))
    assert len(ll) == 4 and len(ll.parameters()) == 8
    assert isinstance(ll[-1], nn.Linear) and len(ll[1:3]) == 2
    ld = nn.LayerDict({"a": nn.Linear(2, 3)})
    ld["b"] = nn.ReLU()
    assert list(ld.keys()) == ["a", "b"] and "a" in ld
    pl = nn.ParameterList([tp.Parameter(np.ones(2, np.float32))])
    assert len(pl) == 1 and len(list(pl.parameters())) == 1
    seq = nn.Sequential(("fc", nn.Linear(2, 2)), ("act", nn.Tanh()))
    assert list(seq.state_dict()) == ["fc.weight", "fc.bias"]
    lay = nn.Linear(2, 2).to(dtype="bfloat16")
    assert lay.weight.dtype == tp.bfloat16 and not lay.weight.stop_gradient


OPTIMIZERS = {
    "SGD": lambda m, ps: m.optimizer.SGD(0.1, parameters=ps,
                                         weight_decay=0.01),
    "Momentum": lambda m, ps: m.optimizer.Momentum(
        0.05, 0.9, parameters=ps, use_nesterov=True, weight_decay=0.01),
    "Adam": lambda m, ps: m.optimizer.Adam(0.01, parameters=ps,
                                           weight_decay=0.01),
    "AdamW": lambda m, ps: m.optimizer.AdamW(0.01, parameters=ps),
    "Adagrad": lambda m, ps: m.optimizer.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1),
    "Adamax": lambda m, ps: m.optimizer.Adamax(0.02, parameters=ps),
    "Adadelta": lambda m, ps: m.optimizer.Adadelta(1.0, parameters=ps,
                                                   weight_decay=0.01),
    "RMSProp": lambda m, ps: m.optimizer.RMSProp(
        0.01, momentum=0.5, centered=True, parameters=ps),
    "Lamb": lambda m, ps: m.optimizer.Lamb(0.01, parameters=ps),
    "LarsMomentum": lambda m, ps: m.optimizer.LarsMomentum(
        0.1, parameters=ps),
}


def _step(m, model, opt, x, y):
    loss = m.nn.functional.mse_loss(model(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_and_state_dict_match_jax(name):
    make = OPTIMIZERS[name]
    rng = np.random.RandomState(4)
    x, y = (rng.randn(5, 6).astype(np.float32),
            rng.randn(5, 3).astype(np.float32))
    models = {m: _seeded(m, 5) for m in (tp, jp)}
    opts = {m: make(m, models[m].parameters()) for m in (tp, jp)}
    for _ in range(3):
        losses = [_step(m, models[m], opts[m], m.to_tensor(x),
                        m.to_tensor(y)) for m in (tp, jp)]
        assert abs(losses[0] - losses[1]) <= 1e-6, losses
    for (n, a), b in zip(models[tp].named_parameters(),
                         models[jp].parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
    # the JAX optimizer's state carries into a fresh port optimizer of the
    # same class (and the port's into a fresh JAX one): a fourth step
    # taken from either equals the JAX optimizer's own fourth step
    jsd = opts[jp].state_dict()
    fresh = make(tp, models[tp].parameters())
    optimizer_state_from_numpy(fresh, {
        k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
        for k, v in jsd.items()})
    assert fresh.global_step == opts[jp]._global_step == 3
    tsd = opts[tp].state_dict()

    def entries(sd):     # "<param name>_<state>_0" without the param name,
        # whose counter differs between the packages' processes
        return sorted(k.split(".", 1)[1] for k in sd if k.endswith("_0"))
    assert entries(tsd) == entries(jsd)
    jfresh = make(jp, models[jp].parameters())
    jfresh.set_state_dict({k: (jp.to_tensor(v.numpy()) if hasattr(
        v, "numpy") else v) for k, v in tsd.items()})
    t4 = _step(tp, models[tp], fresh, tp.to_tensor(x), tp.to_tensor(y))
    j4 = _step(jp, models[jp], jfresh, jp.to_tensor(x), jp.to_tensor(y))
    assert abs(t4 - j4) <= 1e-6
    for a, b in zip(models[tp].parameters(), models[jp].parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_lr_scheduler_param_groups_and_clip():
    sched = tp.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    net = _seeded(tp, 6)
    groups = [{"params": net[0].parameters()},
              {"params": net[2].parameters(), "learning_rate": 0.5}]
    opt = tp.optimizer.SGD(sched, parameters=groups,
                           grad_clip=jp.nn.ClipGradByGlobalNorm(0.1))
    assert opt.get_lr() == pytest.approx(0.1)
    before = [p.numpy().copy() for p in net.parameters()]
    x = tp.to_tensor(np.ones((2, 6), np.float32))
    net(x).sum().backward()
    grads = [p.grad.numpy().copy() for p in net.parameters()]
    opt.step()
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads))
    scale = 0.1 / max(norm, 0.1)
    for i, (p, b, g) in enumerate(zip(net.parameters(), before, grads)):
        lr = 0.1 * (0.5 if i >= 4 else 1.0)
        np.testing.assert_allclose(p.numpy(), b - lr * g * scale, atol=1e-6)
    sched.step()
    assert opt.get_lr() == pytest.approx(0.05)
    with pytest.raises(RuntimeError, match="parameters="):
        tp.optimizer.AdamW(1e-3).step()
