"""The port's Paddle `Tensor` (`paddle_tpu_torch/core/tensor.py`) held
against the JAX package's on the scenarios of `tests/test_tensor.py`:
creation and dtype rules, arithmetic, indexing, in-place ops, casts,
clone and detach, on the CPU. Values are compared exactly (the same ops on
the same float32 inputs), dtypes by name."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import dtype as tdtype


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


def _name(d):
    return d.name if isinstance(d, np.dtype) else tdtype.dtype_name(d)


def _same(t, j):
    assert _name(t.dtype) == _name(j.dtype)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


@pytest.mark.parametrize("data,kw", [
    ([1.0, 2.0], {}), ([1, 2], {}), (np.zeros((2, 3), np.float64), {}),
    (True, {}), ([1, 2], {"dtype": "float32"}), (3.5, {}), (7, {}),
    (np.arange(6, dtype=np.int32).reshape(2, 3), {}),
    ([[1.5, 2.5]], {"dtype": "float64"})])
def test_to_tensor_dtypes_match_jax(data, kw):
    _same(tp.to_tensor(data, **kw), jp.to_tensor(data, **kw))


def test_shape_props():
    t, j = tp.zeros([2, 3, 4]), jp.zeros([2, 3, 4])
    assert (t.shape, t.ndim, t.size) == (j.shape, j.ndim, j.size) == (
        [2, 3, 4], 3, 24)
    assert t.numpy().shape == (2, 3, 4)
    assert t.place.is_cpu_place() and t.stop_gradient


def _both(fn, *arrays):
    return (fn(tp, *(tp.to_tensor(a) for a in arrays)),
            fn(jp, *(jp.to_tensor(a) for a in arrays)))


A = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
B = np.array([10.0, 20.0], np.float32)


@pytest.mark.parametrize("expr", [
    lambda m, a, b: a + b, lambda m, a, b: a * 2, lambda m, a, b: 2 * a,
    lambda m, a, b: a - b, lambda m, a, b: 1.0 / a, lambda m, a, b: a ** 2,
    lambda m, a, b: -a, lambda m, a, b: a @ a, lambda m, a, b: a % 3,
    lambda m, a, b: a // 2, lambda m, a, b: abs(a - 3),
    lambda m, a, b: a < b, lambda m, a, b: a == b, lambda m, a, b: a >= 2,
    lambda m, a, b: (a > 1) & (a < 4), lambda m, a, b: ~(a > 2),
    lambda m, a, b: a.T, lambda m, a, b: a.sum(axis=1),
    lambda m, a, b: a.max(axis=0), lambda m, a, b: a.mean()],
    ids=["add", "mul", "rmul", "sub", "rdiv", "pow", "neg", "matmul", "mod",
         "floordiv", "abs", "lt", "eq", "ge", "and", "invert", "T", "sum",
         "max", "mean"])
def test_arithmetic_and_methods_match_jax(expr):
    t, j = _both(expr, A, B)
    _same(t, j)


def test_scalar_and_int_float_promotion():
    for fn in (lambda m: m.ones([2], dtype="float32") + 0.5,
               lambda m: m.ones([2], dtype="float32") * 3,
               lambda m: m.ones([2], dtype="int32") + 1,
               lambda m: m.ones([2], dtype="float32") +
               m.ones([2], dtype="int64")):
        assert _name(fn(tp).dtype) == _name(fn(jp).dtype)


IDX = np.arange(24).reshape(2, 3, 4).astype(np.float32)


@pytest.mark.parametrize("key", [
    0, (slice(None), 1), (0, slice(1, 3), slice(None, None, 2)), Ellipsis,
    (None, 1), (-1, slice(None, None, -1)), "tensor", "mask", "list"])
def test_indexing_matches_jax(key):
    def idx(m):
        if key == "tensor":
            return m.to_tensor([0, 1])
        if key == "mask":
            return m.to_tensor(IDX) > 10
        if key == "list":
            return [1, 0]
        return key
    _same(tp.to_tensor(IDX)[idx(tp)], jp.to_tensor(IDX)[idx(jp)])


def test_setitem_matches_jax():
    outs = []
    for m in (tp, jp):
        a = m.zeros([3, 3])
        a[1] = 5.0
        a[0, 0] = 1.0
        a[2] = m.to_tensor([7.0, 8.0, 9.0])
        a[a > 7] = -1.0
        outs.append(a)
    _same(*outs)


def test_inplace_ops_match_jax():
    outs = []
    for m in (tp, jp):
        a = m.ones([3])
        a.add_(m.ones([3]))
        a.scale_(2.0)
        a.subtract_(m.to_tensor([1.0, 2.0, 3.0]))
        a.clip_(0.5, 2.5)
        outs.append(a)
    _same(*outs)


def test_item_casts_and_conversions():
    for m in (tp, jp):
        a = m.to_tensor(3.5)
        assert a.item() == pytest.approx(3.5) and float(a) == 3.5
        assert int(m.to_tensor(np.asarray(2, np.int64))) == 2
        assert [10, 20, 30][m.to_tensor(np.asarray(2, np.int64))] == 30
    _same(tp.to_tensor(A).astype("int32"), jp.to_tensor(A).astype("int32"))
    _same(tp.to_tensor(A).cast("float64"), jp.to_tensor(A).cast("float64"))
    assert tp.to_tensor(A).tolist() == jp.to_tensor(A).tolist()


def test_clone_detach_and_stop_gradient():
    a = tp.rand([2, 2])
    a.stop_gradient = False
    assert a._data.requires_grad and a.is_leaf
    c = a.clone()
    assert not c.stop_gradient and not c.is_leaf
    d = a.detach()
    assert d.stop_gradient and not d._data.requires_grad
    np.testing.assert_array_equal(d.numpy(), a.numpy())
    a.stop_gradient = True
    assert not a._data.requires_grad
    # an int tensor records no gradient whatever its flag says
    i = tp.to_tensor([1, 2], stop_gradient=False)
    assert not i._data.requires_grad


def test_tensor_wraps_a_torch_tensor_and_methods_are_paddles():
    t = tp.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    assert isinstance(t._data, torch.Tensor)
    assert not isinstance(t, torch.Tensor)
    j = jp.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    # Paddle's signatures, not torch's
    _same(t.transpose([1, 0]), j.transpose([1, 0]))
    _same(t.flatten(0, 1), j.flatten(0, 1))
    for a, b in zip(t.split(2, axis=1), j.split(2, axis=1)):
        _same(a, b)
    for a, b in zip(t.unbind(axis=1), j.unbind(axis=1)):
        _same(a, b)
    _same(t.max(axis=1), j.max(axis=1))


def test_creation_needs_a_device_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    monkeypatch.setattr(tdevice, "_current", None)
    with pytest.raises(RuntimeError, match=r'set_device\("cpu"\)'):
        tp.zeros([2])
    with pytest.raises(RuntimeError, match=r'set_device\("cpu"\)'):
        tp.to_tensor([1.0])
    assert tp.set_device("cpu") == "cpu" and tp.get_device() == "cpu"
    assert tp.zeros([2]).place == tp.CPUPlace()
