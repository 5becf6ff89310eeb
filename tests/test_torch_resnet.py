"""`vision.models.resnet` of the port held against the JAX package's on the
CPU: ``resnet50(num_classes=10)`` built from one seed in both (module
fixture: the JAX build takes ~12 s here), its 267 state keys (161
parameters, ``_mean`` and ``_variance`` of each of the 53 batch norms)
equal to the JAX draws bit for bit, `models/convert.py` both ways in
float32 and bfloat16, the forward and backward of one training call, and
the nine constructors' sizes.

The forward and backward run in float64 (the float32 draws cast, the
running statistics kept float32 as `amp.decorate` keeps them). At [2, 3,
32, 32] the last stage's batch norms normalize 2 values a channel, where
a change in the last bit of an input flips an output between about -1 and
1: each package's float32 logits differ from its own float64 ones by
about 2 (2.05 the port, 2.21 the JAX package), so float32 cannot be held
at this shape. In float64 the logits and the loss are held within 1e-4,
every gradient within 1e-4 of its largest magnitude, and the running
statistics within 1e-6 (measured: about 3e-7, 4e-6 and 2e-9). The
float32 path is held op by op in `tests/test_torch_conv.py`,
`test_torch_pooling.py` and `test_torch_batch_norm.py`, and as the bench
program in `tests/test_torch_resnet_program.py`.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jp
from paddle_tpu.vision.models import resnet as jresnet

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.models import resnet as tresnet


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    with tdevice.device_scope("cpu"):
        yield


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread for the block. A seeded draw is
    thousands of small int64 ops: under the tier-1 run's six workers
    their eight OpenMP threads a process stall each other, and the port's
    seeded resnet50 takes 93-164 s there against 8.7 s on one thread. The
    values do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(_port_on_cpu):
    """{package: resnet50(num_classes=10) from seed 0} and the JAX
    model's state on entry, as numpy arrays."""
    models = {}
    tp.seed(0)
    with one_thread():
        models[tp] = tresnet.resnet50(num_classes=10)
    jp.seed(0)
    models[jp] = jresnet.resnet50(num_classes=10)
    state = {k: np.asarray(v._data) for k, v in
             models[jp].state_dict().items()}
    return models, state


def _np(t):
    return np.asarray(t.numpy(), np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_seeded_weights_and_buffers_equal_the_jax_draws(pair):
    models, _ = pair
    ts, js = models[tp].state_dict(), models[jp].state_dict()
    assert list(ts) == list(js) and len(ts) == 267
    assert len(models[tp].parameters()) == 161
    assert sum(k.endswith(("._mean", "._variance")) for k in ts) == 2 * 53
    for k, v in js.items():
        assert ts[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(v._data),
                                      err_msg=k)


@pytest.fixture(scope="module")
def other_draws(_port_on_cpu):
    """The port's resnet50(num_classes=10) drawn from another seed (1),
    once for the module: its state, which `_other_model` loads into a
    model built without draws."""
    tp.seed(1)
    with one_thread():
        model = tresnet.resnet50(num_classes=10)
    return {k: v._data.clone() for k, v in model.state_dict().items()}


def _other_model(draws):
    with I.skip_draws():
        model = tresnet.resnet50(num_classes=10)
    for k, t in model.state_dict().items():
        t._write(draws[k].clone())
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_the_state_both_ways(pair, other_draws, dtype):
    """The JAX state (every parameter and buffer; in bfloat16 the
    parameters cast) into a port model drawn from another seed, bit for
    bit; out of it again as numpy, which the JAX model loads."""
    models, state = pair
    if dtype == "bfloat16":
        state = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
                 if not k.endswith(("_mean", "_variance")) else v
                 for k, v in state.items()}
    tm = _other_model(other_draws)
    assert not np.array_equal(tm.state_dict()["conv1.weight"].numpy(),
                              state["conv1.weight"].astype(np.float32))
    convert.layer_state_from_numpy(tm, state)
    ts = tm.state_dict()
    for k, v in state.items():
        want = "bfloat16" if v.dtype.name == "bfloat16" else "float32"
        assert str(ts[k].dtype) == f"torch.{want}", k
        np.testing.assert_array_equal(ts[k].numpy(),
                                      np.asarray(v, np.float32), err_msg=k)
    back = convert.layer_state_to_numpy(tm)
    assert list(back) == list(state)
    jm = models[jp]
    jm.set_state_dict({k: jp.to_tensor(v) for k, v in back.items()})
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v._data, np.float32),
                                      np.asarray(state[k], np.float32))
    with pytest.raises(KeyError, match="missing"):
        convert.layer_state_from_numpy(tm, {})


def _load_f64(models, state):
    """The fixture's draws into both models, the parameters as float64
    and the buffers as float32."""
    for m, model in models.items():
        for k, t in model.state_dict().items():
            v = state[k]
            if not k.endswith(("_mean", "_variance")):
                v = v.astype(np.float64)
            t._write(jnp.asarray(v) if m is jp else torch.from_numpy(
                np.array(v)))


def test_forward_backward_matches_jax_in_float64(pair):
    models, state = pair
    _load_f64(models, state)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 32, 32)
    y = rng.randint(0, 10, 2).astype(np.int64)
    res = {}
    for m, model in models.items():
        model.train()
        logits = model(m.to_tensor(x))
        loss = m.nn.CrossEntropyLoss()(logits, m.to_tensor(y))
        loss.backward()
        res[m] = (logits, loss,
                  {k: p.grad for k, p in model.named_parameters()},
                  model.state_dict())
        for p in model.parameters():
            p.clear_grad(set_to_zero=False)
    (tl, tloss, tg, ts), (jl, jloss, jg, js) = res[tp], res[jp]
    assert tl.dtype == torch.float64 and tl.shape == [2, 10]
    assert float(np.abs(_np(tl) - _np(jl)).max()) <= 1e-4
    assert abs(float(tloss) - float(jloss)) <= 1e-4
    assert set(tg) == set(jg)
    for k, g in jg.items():
        assert _rel(tg[k], g) <= 1e-4, k
    for k in js:
        if k.endswith(("_mean", "_variance")):
            assert _rel(ts[k], js[k]) <= 1e-6, k


SIZES = {"resnet18": (11689512, 102), "resnet34": (21797672, 182),
         "resnet50": (25557032, 267), "resnet101": (44549160, 522),
         "resnet152": (60192808, 777), "resnext50_32x4d": (25028904, 267),
         "resnext101_32x4d": (44177704, 522),
         "wide_resnet50_2": (68883240, 267),
         "wide_resnet101_2": (126886696, 522)}


@pytest.mark.parametrize("name", list(SIZES))
def test_constructors_build_the_reference_sizes(name):
    """Each of the nine constructors (``pretrained`` taken and ignored,
    nothing downloaded) at 1000 classes: the reference framework's
    parameter counts, and the JAX package's state keys."""
    with I.skip_draws():
        model = getattr(tmodels, name)(pretrained=True)
    n_params, n_keys = SIZES[name]
    assert sum(int(np.prod(p.shape)) for p in model.parameters()) == n_params
    assert len(model.state_dict()) == n_keys
    assert isinstance(model, tresnet.ResNet)
