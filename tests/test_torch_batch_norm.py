"""Batch norm of the port (`batch_norm` in
`paddle_tpu_torch/nn/functional/norm.py`, the BatchNorm Layers and
`SyncBatchNorm`) held against the JAX package's on the CPU, with the
helpers of `tests/test_torch_conv.py`: in float32 outputs within 1e-5,
gradients within 1e-4 of the largest magnitude, and the running statistics
after a training call within 1e-5. Under amp O2 the norm runs in bfloat16
with bfloat16 weights beside float32 running statistics; there its output
is held within 2e-2 (a few bfloat16 roundings of the normalized value) and
the running statistics within 1e-3."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from tests.test_torch_conv import _rand, _rel, _run, _hold, hold_layer


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    with tdevice.device_scope("cpu"):
        yield


# --------------------------------------------------------------- batch norm

BN = {
    "nchw": ((4, 3, 5, 6), "NCHW", True, True),
    "nhwc": ((4, 5, 6, 3), "NHWC", True, True),
    "nc": ((8, 3), "NCHW", True, True),
    "ncl": ((4, 3, 7), "NCL", True, True),
    "ncdhw": ((2, 3, 4, 3, 5), "NCDHW", True, True),
    "no_affine": ((4, 3, 5, 6), "NCHW", False, False),
    "weight_only": ((4, 3, 5, 6), "NCHW", True, False),
}


def _bn_arrays(shape, data_format, seed=0):
    c = shape[-1] if data_format.endswith("C") and len(data_format) > 2 \
        else shape[1]
    x = _rand(*shape, seed=seed) * 2.0 + 0.5
    return x, _rand(c, seed=seed + 1) + 1.0, _rand(c, seed=seed + 2), \
        np.abs(_rand(c, seed=seed + 3)) + 0.5, _rand(c, seed=seed + 4)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", list(BN))
def test_batch_norm_matches_jax(case, training):
    shape, fmt, has_w, has_b = BN[case]
    x, w, b, var, mean = _bn_arrays(shape, fmt)
    stats = {}

    def fn(m, a, *wb):
        it = iter(wb)
        rm = m.to_tensor(mean)
        rv = m.to_tensor(var)
        out = m.nn.functional.batch_norm(
            a, rm, rv, next(it) if has_w else None,
            next(it) if has_b else None, training=training, momentum=0.8,
            epsilon=1e-4, data_format=fmt)
        stats[m] = (rm, rv)
        return out

    _hold(fn, [x] + ([w] if has_w else []) + ([b] if has_b else []))
    for ta, ja in zip(stats[tp], stats[jp]):
        assert ta.dtype == torch.float32
        assert _rel(ta, ja) <= 1e-5
    if not training:
        assert _rel(stats[tp][0], tp.to_tensor(mean)) == 0.0


def test_batch_norm_use_global_stats_in_training():
    x, w, b, var, mean = _bn_arrays((4, 3, 5, 6), "NCHW", seed=5)
    _hold(lambda m, a, wt, bs: m.nn.functional.batch_norm(
        a, m.to_tensor(mean), m.to_tensor(var), wt, bs, training=True,
        use_global_stats=True), [x, w, b])


def test_batch_norm_bfloat16_under_o2_weights():
    """O2's batch norm: bfloat16 input, weight and bias, float32 running
    statistics that stay float32; the output bfloat16 in both."""
    x, w, b, var, mean = _bn_arrays((4, 3, 5, 6), "NCHW", seed=7)
    res = {}
    for m in (tp, jp):
        rm, rv = m.to_tensor(mean), m.to_tensor(var)
        xs = m.to_tensor(x).astype("bfloat16")
        xs.stop_gradient = False
        ws = m.to_tensor(w).astype("bfloat16")
        bs = m.to_tensor(b).astype("bfloat16")
        out = m.nn.functional.batch_norm(xs, rm, rv, ws, bs, training=True)
        out.astype("float32").sum().backward()
        res[m] = (out, rm, rv, xs.grad)
    assert res[tp][0].dtype == torch.bfloat16
    assert "bfloat16" in str(res[jp][0].dtype)
    assert res[tp][1].dtype == res[tp][2].dtype == torch.float32
    assert _rel(res[tp][0], res[jp][0]) <= 2e-2
    for a, c in zip(res[tp][1:3], res[jp][1:3]):
        assert _rel(a, c) <= 1e-3
    assert res[tp][3].dtype == torch.bfloat16


def test_batch_norm_keeps_only_its_input():
    """The training arm's autograd keeps its input (x's dtype, the same
    storage) and per-channel statistics, not op-for-op temporaries."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    x = tp.to_tensor(_rand(4, 3, 5, 6), stop_gradient=False)
    bn = tp.nn.BatchNorm2D(3)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        bn(x)
    big = [t for t in saved if t.numel() == x.size]
    assert len(big) == 1 and big[0].dtype == torch.float32
    assert big[0].data_ptr() == x._data.data_ptr()


BN_LAYERS = {
    "BatchNorm2D": (lambda m: m.nn.BatchNorm2D(4), (3, 4, 5, 5)),
    "BatchNorm1D": (lambda m: m.nn.BatchNorm1D(4), (6, 4)),
    "BatchNorm3D": (lambda m: m.nn.BatchNorm3D(2), (2, 2, 3, 3, 3)),
    "BatchNorm_relu": (lambda m: m.nn.BatchNorm(4, act="relu"), (3, 4, 5, 5)),
    "SyncBatchNorm": (lambda m: m.nn.SyncBatchNorm(4), (3, 4, 5, 5)),
}


@pytest.mark.parametrize("name", list(BN_LAYERS))
def test_layer_matches_jax(name):
    hold_layer(*BN_LAYERS[name])


def test_sync_batch_norm_converts_and_refuses_ranks(monkeypatch):
    tp.seed(0)
    net = tp.nn.Sequential(tp.nn.Conv2D(3, 4, 3), tp.nn.BatchNorm2D(4))
    bn = net[1]
    conv = tp.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tp.nn.SyncBatchNorm)
    assert conv[1].weight is bn.weight and conv[1]._mean is bn._mean
    x = tp.to_tensor(_rand(2, 3, 6, 6))
    conv(x)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(NotImplementedError, match="A12"):
        conv(x)
    conv.eval()
    conv(x)


@pytest.mark.parametrize("case,match", [
    ("cpu_tensors", "CUDA tensors"), ("float16", "not supported"),
    ("float64", "not supported"), ("x_dims", r"\[outer, C, inner\]"),
    ("weight_dtype", "w must be float32"), ("weight_shape", "w must be"),
    ("noncontig_x", "x must be contiguous"), ("dy_shape", "dy must be"),
    ("mixed_devices", "one device"), ("f32_x_bf16_y", "y must be float32")])
def test_batch_norm_wrappers_refuse_bad_input(case, match):
    """The batch norm kernels' wrappers (`kernels/cuda/batch_norm.py`): x
    [outer, C, inner] contiguous in f32 or bf16 on the card, per-channel
    tensors f32 [C], dy of x's shape; anything else raises before a
    launch."""
    from paddle_tpu_torch.kernels.cuda import batch_norm as cbn
    x, dy = torch.zeros(2, 4, 6), torch.zeros(2, 4, 6)
    w, b = torch.ones(4), torch.zeros(4)
    m, r = torch.zeros(4), torch.ones(4)
    y_dtype = torch.float32
    if case in ("float16", "float64"):
        dt = torch.float16 if case == "float16" else torch.float64
        x, dy = x.to(dt), dy.to(dt)
        y_dtype = torch.float32
    elif case == "x_dims":
        x = dy = torch.zeros(2, 4)
    elif case == "weight_dtype":
        w = w.bfloat16()
    elif case == "weight_shape":
        w = torch.ones(5)
    elif case == "noncontig_x":
        x = torch.zeros(2, 6, 4).transpose(1, 2)
    elif case == "dy_shape":
        dy = dy[:1]
    elif case == "mixed_devices":
        w = torch.ones(4, device="meta")
    elif case == "f32_x_bf16_y":
        y_dtype = torch.bfloat16
    before = cbn.FWD.launches, cbn.BWD.launches
    calls = []
    if case != "dy_shape":
        calls.append(lambda: cbn.batch_norm_fwd(x, w, b, 1e-5, y_dtype))
    if case != "f32_x_bf16_y":
        calls.append(lambda: cbn.batch_norm_bwd(x, dy, m, r, w))
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()
    assert (cbn.FWD.launches, cbn.BWD.launches) == before
