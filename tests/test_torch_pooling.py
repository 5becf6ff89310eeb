"""Pooling of the port (`paddle_tpu_torch/nn/functional/pooling.py`, the 12
pooling Layers) held against the JAX package's on the CPU, with the
helpers and tolerances of `tests/test_torch_conv.py`: outputs within 1e-5
and gradients within 1e-4 of the largest magnitude, max pools on inputs
without ties, their masks on values at least 1 apart (ROADMAP C22), and a
max window wholly in the padding -inf in both."""
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


# --------------------------------------------------------------- pooling

POOL2D = {
    "max_k3s2p1": ("max", dict(kernel_size=3, stride=2, padding=1)),
    "max_asym": ("max", dict(kernel_size=3, stride=2, padding=[0, 1, 1, 2])),
    "max_ceil": ("max", dict(kernel_size=3, stride=2, ceil_mode=True)),
    "max_ceil_pad": ("max", dict(kernel_size=2, stride=2, padding=1,
                                 ceil_mode=True)),
    "max_same": ("max", dict(kernel_size=3, stride=2, padding="SAME")),
    "max_nhwc": ("max", dict(kernel_size=2, padding=1, data_format="NHWC")),
    "avg_k2": ("avg", dict(kernel_size=2)),
    "avg_pad_exclusive": ("avg", dict(kernel_size=3, stride=2, padding=1)),
    "avg_pad_inclusive": ("avg", dict(kernel_size=3, stride=2, padding=1,
                                      exclusive=False)),
    "avg_asym": ("avg", dict(kernel_size=3, stride=1, padding=[1, 0, 2, 1])),
    "avg_ceil": ("avg", dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True)),
    "avg_ceil_inclusive": ("avg", dict(kernel_size=2, stride=2,
                                       ceil_mode=True, exclusive=False)),
    "avg_nhwc": ("avg", dict(kernel_size=3, stride=2, padding=1,
                             data_format="NHWC")),
}


@pytest.mark.parametrize("case", list(POOL2D))
def test_pool2d_matches_jax(case):
    kind, kw = POOL2D[case]
    x = _rand(2, 3, 9, 8)
    if kw.get("data_format") == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    fn = kind + "_pool2d"
    _hold(lambda m, a: getattr(m.nn.functional, fn)(a, **kw), [x])


@pytest.mark.parametrize("n,kind", [(1, "max"), (1, "avg"), (3, "max"),
                                    (3, "avg")])
def test_pool1d_3d_match_jax(n, kind):
    x = _rand(*((2, 3) + (7,) * n))
    fn = f"{kind}_pool{n}d"
    _hold(lambda m, a: getattr(m.nn.functional, fn)(
        a, 3, stride=2, padding=1, ceil_mode=True), [x])


@pytest.mark.parametrize("n,kw", [
    (2, dict(kernel_size=3, stride=2, padding=1)),
    (2, dict(kernel_size=2, stride=2)),
    (1, dict(kernel_size=3, stride=2, padding=1)),
    (3, dict(kernel_size=2, stride=2, padding=1))])
def test_max_pool_mask_matches_jax(n, kw):
    shape = (2, 3) + (6,) * n
    x = np.random.RandomState(3).permutation(int(np.prod(shape))).reshape(
        shape).astype(np.float32)
    fn = f"max_pool{n}d"
    outs = {m: getattr(m.nn.functional, fn)(m.to_tensor(x), return_mask=True,
                                            **kw) for m in (tp, jp)}
    assert _rel(outs[tp][0], outs[jp][0]) == 0.0
    assert outs[tp][1].dtype == torch.int64
    np.testing.assert_array_equal(outs[tp][1].numpy(), outs[jp][1].numpy())


ADAPTIVE = [("avg", 2, (1, 1)), ("avg", 2, (3, 2)), ("avg", 2, 4),
            ("max", 2, (3, 5)), ("avg", 1, 3), ("max", 1, 4),
            ("avg", 3, (2, 3, 1)), ("max", 3, 2)]


@pytest.mark.parametrize("kind,n,size", ADAPTIVE)
def test_adaptive_pool_matches_jax(kind, n, size):
    x = _rand(*((2, 3) + (8, 7, 6)[:n]))
    fn = f"adaptive_{kind}_pool{n}d"
    _hold(lambda m, a: getattr(m.nn.functional, fn)(a, size), [x])


def test_adaptive_avg_pool_nhwc_and_max_mask_none():
    x = _rand(2, 8, 7, 3)
    _hold(lambda m, a: m.nn.functional.adaptive_avg_pool2d(
        a, (3, 2), data_format="NHWC"), [x])
    out = tp.nn.functional.adaptive_max_pool2d(tp.to_tensor(x), 2,
                                               return_mask=True)
    assert out[1] is None and out[0].shape == [2, 8, 2, 2]



POOL_LAYERS = {
    "MaxPool2D": (lambda m: m.nn.MaxPool2D(3, 2, 1), (2, 3, 8, 8)),
    "MaxPool1D": (lambda m: m.nn.MaxPool1D(2), (2, 3, 8)),
    "MaxPool3D": (lambda m: m.nn.MaxPool3D(2, ceil_mode=True),
                  (2, 2, 5, 5, 5)),
    "AvgPool2D": (lambda m: m.nn.AvgPool2D(3, 2, 1), (2, 3, 8, 8)),
    "AvgPool1D": (lambda m: m.nn.AvgPool1D(3, 2, 1, exclusive=False),
                  (2, 3, 8)),
    "AvgPool3D": (lambda m: m.nn.AvgPool3D(2), (2, 2, 4, 4, 4)),
    "AdaptiveAvgPool2D": (lambda m: m.nn.AdaptiveAvgPool2D((1, 1)),
                          (2, 3, 7, 7)),
    "AdaptiveAvgPool1D": (lambda m: m.nn.AdaptiveAvgPool1D(3), (2, 3, 8)),
    "AdaptiveAvgPool3D": (lambda m: m.nn.AdaptiveAvgPool3D(2),
                          (2, 2, 4, 5, 4)),
    "AdaptiveMaxPool2D": (lambda m: m.nn.AdaptiveMaxPool2D(3), (2, 3, 7, 7)),
    "AdaptiveMaxPool1D": (lambda m: m.nn.AdaptiveMaxPool1D(3), (2, 3, 8)),
    "AdaptiveMaxPool3D": (lambda m: m.nn.AdaptiveMaxPool3D(2),
                          (2, 2, 4, 4, 4)),

}


@pytest.mark.parametrize("name", list(POOL_LAYERS))
def test_layer_matches_jax(name):
    hold_layer(*POOL_LAYERS[name])
