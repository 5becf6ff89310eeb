"""Convolution of the port (`paddle_tpu_torch/nn/functional/conv.py`, the
Conv Layers) held against the JAX package's on the CPU, with the same
numpy inputs from a seed; its helpers hold pooling
(`tests/test_torch_pooling.py`) and batch norm
(`tests/test_torch_batch_norm.py`) too.

Tolerances (float32): every output within 1e-5 and every gradient within
1e-4, each relative to the largest finite magnitude of the JAX tensor it
is held against (equal infinities count as equal); the running statistics
after a training call within 1e-5. The gradient is that of ``sum(out *
r)`` for a fixed random ``r``. Under O1 bfloat16 a convolution is held
within 1e-2 (bfloat16 inputs, float32 accumulation in both).

The JAX package's string-padded conv transposes raise on jax 0.9 (ROADMAP
C23), so the port's are held against the JAX transpose with the integer
pads `lax.conv_transpose` derives from the string.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    with tdevice.device_scope("cpu"):
        yield


def _f64(t):
    return np.asarray(t.numpy(), np.float64)


def _rel(a, b):
    """Largest difference over the largest finite magnitude of ``b``;
    equal infinities (a max window wholly in the padding) differ by 0."""
    a, b = _f64(a), _f64(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore"):
        diff = np.where(same, 0.0, np.abs(a - b))
    scale = np.abs(np.where(np.isfinite(b), b, 0.0)).max()
    return float(diff.max() / max(scale, 1e-30))


def _run(m, fn, arrays, grad=True, seed=9):
    """``fn(m, *tensors)`` in package ``m``: the output and the gradients
    of ``sum(out * r)`` with respect to each float input."""
    ts = [m.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
          for a in arrays]
    out = fn(m, *ts)
    outs = out if isinstance(out, tuple) else (out,)
    grads = []
    if grad:
        r = np.random.RandomState(seed).randn(*outs[0].shape).astype(
            np.float32)
        (outs[0] * m.to_tensor(r)).sum().backward()
        grads = [t.grad for t in ts if not t.stop_gradient]
    return outs, grads


def _hold(fn, arrays, grad=True, out_tol=1e-5, grad_tol=1e-4):
    (t_out, t_g), (j_out, j_g) = (_run(m, fn, arrays, grad)
                                  for m in (tp, jp))
    for a, b in zip(t_out, j_out):
        assert a.dtype == b.dtype or str(b.dtype) in str(a.dtype)
        assert _rel(a, b) <= out_tol
    assert len(t_g) == len(j_g)
    for a, b in zip(t_g, j_g):
        assert _rel(a, b) <= grad_tol


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --------------------------------------------------------------- conv

CONV2D = {
    "pad0": dict(padding=0),
    "pad1_stride2": dict(padding=1, stride=2),
    "per_dim": dict(padding=[1, 2]),
    "flat_pairs": dict(padding=[1, 0, 2, 1]),
    "same": dict(padding="SAME"),
    "same_stride2": dict(padding="SAME", stride=2),
    "same_dilated": dict(padding="same", dilation=2, stride=2),
    "valid": dict(padding="VALID", stride=(2, 1)),
    "groups": dict(padding=1, groups=2),
    "dilation": dict(padding=2, dilation=2),
    "nhwc": dict(padding=[1, 0, 0, 1], stride=2, data_format="NHWC"),
    "nhwc_same_groups": dict(padding="SAME", stride=2, groups=2,
                             data_format="NHWC"),
}


@pytest.mark.parametrize("case", list(CONV2D))
def test_conv2d_matches_jax(case):
    kw = CONV2D[case]
    g = kw.get("groups", 1)
    x = _rand(2, 4, 9, 8)
    if kw.get("data_format") == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    w, b = _rand(6, 4 // g, 3, 3, seed=1), _rand(6, seed=2)
    _hold(lambda m, a, wt, bs: m.nn.functional.conv2d(a, wt, bs, **kw),
          [x, w, b])


@pytest.mark.parametrize("nested,flat,fmt", [
    ([[0, 2], [1, 0]], [0, 2, 1, 0], "NCHW"),
    ([[0, 0], [0, 0], [2, 1], [1, 1]], [2, 1, 1, 1], "NCHW"),
    ([[0, 0], [1, 2], [0, 1], [0, 0]], [1, 2, 0, 1], "NHWC")])
def test_nested_padding_matches_the_flat_form(nested, flat, fmt):
    """The nested forms (a pair a spatial dim, or a pair a dim of the
    input) against the JAX package's flat pairs, whose own reading of the
    nested form fails (C23); conv and pooling alike."""
    x = _rand(2, 4, 7, 8)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    w = _rand(3, 4, 3, 3, seed=1)
    for fn, extra in (("conv2d", (w,)), ("max_pool2d", (3,)),
                      ("avg_pool2d", (3,))):
        t, _ = _run(tp, lambda m, a: getattr(m.nn.functional, fn)(
            a, *[m.to_tensor(e) if isinstance(e, np.ndarray) else e
                 for e in extra], padding=nested, stride=2,
            data_format=fmt), [x], grad=False)
        j, _ = _run(jp, lambda m, a: getattr(m.nn.functional, fn)(
            a, *[m.to_tensor(e) if isinstance(e, np.ndarray) else e
                 for e in extra], padding=flat, stride=2,
            data_format=fmt), [x], grad=False)
        assert _rel(t[0], j[0]) <= 1e-5, fn


@pytest.mark.parametrize("case", ["pad1", "same_stride2", "nwc"])
def test_conv1d_matches_jax(case):
    kw = {"pad1": dict(padding=1), "same_stride2": dict(padding="SAME",
                                                         stride=2),
          "nwc": dict(padding=[2, 1], data_format="NLC")}[case]
    x = _rand(2, 3, 11)
    if case == "nwc":
        x = x.transpose(0, 2, 1).copy()
    _hold(lambda m, a, wt: m.nn.functional.conv1d(a, wt, **kw),
          [x, _rand(5, 3, 3, seed=1)])


@pytest.mark.parametrize("case", ["pad1_stride2", "same_groups", "ndhwc"])
def test_conv3d_matches_jax(case):
    kw = {"pad1_stride2": dict(padding=1, stride=2),
          "same_groups": dict(padding="SAME", stride=2, groups=2),
          "ndhwc": dict(padding=[1, 0, 0, 1, 1, 1],
                        data_format="NDHWC")}[case]
    g = kw.get("groups", 1)
    x = _rand(2, 4, 5, 6, 5)
    if case == "ndhwc":
        x = x.transpose(0, 2, 3, 4, 1).copy()
    _hold(lambda m, a, wt: m.nn.functional.conv3d(a, wt, **kw),
          [x, _rand(4, 4 // g, 3, 3, 3, seed=1)])


CONV2D_T = {
    "pad0": dict(),
    "pad1_stride2": dict(padding=1, stride=2),
    "output_padding": dict(padding=1, stride=2, output_padding=1),
    "output_padding_past_stride": dict(stride=2, output_padding=3),
    "flat_pairs": dict(padding=[1, 0, 2, 1], stride=2),
    "groups": dict(padding=1, stride=2, groups=2),
    "dilation": dict(padding=1, dilation=2),
    "output_size": dict(padding=1, stride=2, output_size=[16, 15]),
    "nhwc": dict(padding=1, stride=2, output_padding=1, data_format="NHWC"),
}


@pytest.mark.parametrize("case", list(CONV2D_T))
def test_conv2d_transpose_matches_jax(case):
    kw = CONV2D_T[case]
    g = kw.get("groups", 1)
    x = _rand(2, 4, 7, 7)
    if kw.get("data_format") == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    w, b = _rand(4, 6 // g, 3, 3, seed=1), _rand(6, seed=2)
    _hold(lambda m, a, wt, bs: m.nn.functional.conv2d_transpose(
        a, wt, bs, **kw), [x, w, b])


@pytest.mark.parametrize("n", [1, 3])
def test_conv1d_3d_transpose_match_jax(n):
    x = _rand(*((2, 4) + (5,) * n))
    w = _rand(*((4, 3) + (3,) * n), seed=1)
    fn = {1: "conv1d_transpose", 3: "conv3d_transpose"}[n]
    _hold(lambda m, a, wt: getattr(m.nn.functional, fn)(
        a, wt, stride=2, padding=1, output_padding=1), [x, w])


@pytest.mark.parametrize("padding,stride,k", [
    ("SAME", 2, 3), ("SAME", 3, 2), ("VALID", 2, 3), ("SAME", 1, 4)])
def test_string_padded_transpose_takes_lax_pads(padding, stride, k):
    """The port's string-padded transpose against the JAX transpose with
    the integer pads `lax.conv_transpose` derives (k - 1 - pad_a, k - 1 -
    pad_b); the JAX string form itself raises (C23)."""
    total = {"SAME": k + stride - 2,
             "VALID": k + stride - 2 + max(k - stride, 0)}[padding]
    a = (k - 1 if stride > k - 1 else -(-total // 2)) \
        if padding == "SAME" else k - 1
    lo, hi = k - 1 - a, k - 1 - (total - a)
    x, w = _rand(2, 3, 6, 6), _rand(3, 4, k, k, seed=1)
    t, _ = _run(tp, lambda m, xa, wa: m.nn.functional.conv2d_transpose(
        xa, wa, stride=stride, padding=padding), [x, w])
    pads = [lo, hi, lo, hi]
    j, _ = _run(jp, lambda m, xa, wa: m.nn.functional.conv2d_transpose(
        xa, wa, stride=stride, padding=pads), [x, w])
    assert _rel(t[0], j[0]) <= 1e-5
    with pytest.raises(TypeError):
        jp.nn.functional.conv2d_transpose(jp.to_tensor(x), jp.to_tensor(w),
                                          stride=stride, padding=padding)


def test_conv_amp_cast_sites_match_jax():
    """conv2d is on the white list: under O1 bfloat16 both packages cast
    x and the weight and return bfloat16."""
    x, w = _rand(2, 4, 6, 6), _rand(5, 4, 3, 3, seed=1)
    outs = {}
    for m in (tp, jp):
        with m.amp.auto_cast(level="O1", dtype="bfloat16"):
            outs[m] = m.nn.functional.conv2d(m.to_tensor(x), m.to_tensor(w),
                                             padding=1)
    assert outs[tp].dtype == torch.bfloat16
    assert "bfloat16" in str(outs[jp].dtype)
    assert _rel(outs[tp], outs[jp]) <= 1e-2


# --------------------------------------------------------------- layers



def hold_layer(make, shape):
    """Seeded parameters and buffers equal to the JAX draws, key for key;
    the forward (training mode), the parameters' gradients and the buffers
    after it."""
    layers = {}
    for m in (tp, jp):
        m.seed(4)
        layers[m] = make(m)
    ts, js = layers[tp].state_dict(), layers[jp].state_dict()
    assert list(ts) == list(js)
    for k in js:
        assert _rel(ts[k], js[k]) == 0.0, k
    x = _rand(*shape, seed=5)
    outs = {}
    for m in (tp, jp):
        out = layers[m](m.to_tensor(x))
        (out * m.to_tensor(_rand(*out.shape, seed=6))).sum().backward()
        outs[m] = (out, {k: p.grad for k, p in layers[m].named_parameters()},
                   layers[m].state_dict())
    assert _rel(outs[tp][0], outs[jp][0]) <= 1e-5
    for k, g in outs[jp][1].items():
        assert _rel(outs[tp][1][k], g) <= 1e-4, k
    for k, v in outs[jp][2].items():
        assert _rel(outs[tp][2][k], v) <= 1e-5, k



LAYERS = {
    "Conv2D": (lambda m: m.nn.Conv2D(4, 6, 3, stride=2, padding=1),
               (2, 4, 8, 8)),
    "Conv2D_groups_nobias": (lambda m: m.nn.Conv2D(4, 6, 3, groups=2,
                                                   bias_attr=False),
                             (2, 4, 7, 7)),
    "Conv1D": (lambda m: m.nn.Conv1D(3, 5, 3, padding="SAME"), (2, 3, 9)),
    "Conv3D": (lambda m: m.nn.Conv3D(2, 3, 2), (2, 2, 4, 4, 4)),
    "Conv2DTranspose": (lambda m: m.nn.Conv2DTranspose(4, 3, 3, stride=2,
                                                       padding=1),
                        (2, 4, 5, 5)),
    "Conv1DTranspose": (lambda m: m.nn.Conv1DTranspose(3, 2, 3, stride=2),
                        (2, 3, 6)),
    "Conv3DTranspose": (lambda m: m.nn.Conv3DTranspose(2, 3, 2, stride=2),
                        (2, 2, 3, 3, 3)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name):
    hold_layer(*LAYERS[name])
