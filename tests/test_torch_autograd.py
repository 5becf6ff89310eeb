"""The port's autograd (`paddle_tpu_torch/core/autograd.py`, torch's
engine under Paddle's API) held against the JAX package's tape on the
scenarios of `tests/test_autograd.py`, and on the in-place cases the
value semantics exist for, on the CPU. Gradients within 1e-6."""
import numpy as np
import pytest

import paddle_tpu as jp

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


def _close(t, j, tol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), atol=tol,
                               rtol=0)


def _leaf(m, v):
    return m.to_tensor(v, stop_gradient=False)


SCENARIOS = {
    "simple": lambda m, x: (x * x).sum(),
    "chain": lambda m, x: (x * x * x).sum(),
    "branching": lambda m, x: (x * 2 + x * 5).sum(),
    "indexing": lambda m, x: x[1:].sum() + (x[0] * 3),
    "topk": lambda m, x: x.reshape([2, 2]).topk(1, axis=1)[0].sum(),
    "softmax": lambda m, x: m.nn.functional.softmax(x).max(),
    "reshape_concat": lambda m, x: m.concat(
        [x.reshape([2, 2]), x.reshape([2, 2]) * 2], axis=0).mean(),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_backward_matches_jax(name):
    v = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    grads = []
    for m in (tp, jp):
        x = _leaf(m, v)
        SCENARIOS[name](m, x).backward()
        grads.append(x.grad)
    _close(*grads)


def test_accumulation_and_clear_grad():
    outs = []
    for m in (tp, jp):
        x = _leaf(m, [1.0])
        (x * 2).sum().backward()
        (x * 3).sum().backward()
        outs.append(x.grad)
    _close(*outs)
    assert outs[0].item() == pytest.approx(5.0)
    x = _leaf(tp, [1.0])
    (x * 2).sum().backward()
    x.clear_grad()                       # Paddle's default: zero it
    assert x.grad is not None and x.grad.item() == 0.0
    x.clear_grad(set_to_zero=False)
    assert x.grad is None


def test_stop_gradient_and_no_grad():
    x = _leaf(tp, [1.0])
    w = tp.to_tensor([2.0])
    (x * w).sum().backward()
    assert x.grad is not None and w.grad is None
    with tp.no_grad():
        y = x * 2
    assert y._grad_node is None and y.stop_gradient
    z = x * 2
    assert z._grad_node is not None and not z.stop_gradient
    with tp.set_grad_enabled(False):
        assert not tp.is_grad_enabled()
    assert tp.is_grad_enabled()


def test_retain_graph_and_freed_graph():
    x = _leaf(tp, [1.0])
    y = (x * 2).sum()
    y.backward(retain_graph=True)
    y.backward()
    assert x.grad.item() == pytest.approx(4.0)
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()


def test_hooks_match_jax():
    seen, grads = [], []
    for m in (tp, jp):
        x = _leaf(m, [1.0, 2.0])
        h = x * 3

        def leaf_hook(g, seen=seen):
            seen.append(g.numpy().copy())
            return g * 2

        x.register_hook(leaf_hook)
        h.register_hook(lambda g: g + 1)
        (h * h).sum().backward()
        grads.append(x.grad)
    _close(*grads)
    np.testing.assert_allclose(seen[0], seen[1])
    x = _leaf(tp, [1.0])
    handle = x.register_hook(lambda g: g * 10)
    handle.remove()
    (x * 3).sum().backward()
    assert x.grad.item() == pytest.approx(3.0)


def test_functional_grad_and_create_graph_match_jax():
    outs = []
    for m in (tp, jp):
        x = _leaf(m, [1.0, 2.0])
        (g1,) = m.grad([(x ** 3).sum()], [x], create_graph=True)
        (g2,) = m.grad([g1.sum()], [x])
        outs.append((g1, g2, x.grad))
    _close(outs[0][0], outs[1][0])
    _close(outs[0][1], outs[1][1])
    assert outs[0][2] is None and outs[1][2] is None
    x = _leaf(tp, 2.0)
    (g,) = tp.grad([x * x * x], [x], create_graph=True)
    assert not g.stop_gradient and g.item() == pytest.approx(12.0)


def test_grad_unused_input():
    x, z = _leaf(tp, 1.0), _leaf(tp, 1.0)
    with pytest.raises(RuntimeError):
        tp.grad([x * 2], [x, z])
    gx, gz = tp.grad([x * 2], [x, z], allow_unused=True)
    assert gz is None and gx.item() == pytest.approx(2.0)


def test_non_scalar_backward_fills_ones():
    outs = []
    for m in (tp, jp):
        x = _leaf(m, [1.0, 2.0])
        (x * 2).backward()
        a = x.grad.numpy().copy()
        x.clear_grad(set_to_zero=False)
        (x * 2).backward(m.to_tensor([1.0, 3.0]))
        outs.append((a, x.grad.numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_pylayer_matches_jax():
    grads = []
    for m in (tp, jp):
        class Cube(m.PyLayer):
            @staticmethod
            def forward(ctx, a, k):
                ctx.save_for_backward(a)
                ctx.k = k
                return a * a * a * k

            @staticmethod
            def backward(ctx, g):
                (a,) = ctx.saved_tensor()
                return g * 3 * a * a * ctx.k

        x = _leaf(m, [1.0, 2.0])
        y = Cube.apply(x, 2.0)
        assert not y.stop_gradient
        (y * x).sum().backward()
        grads.append(x.grad)
    _close(*grads)


def test_inplace_after_use_keeps_the_old_value():
    """An in-place op on a tensor another op has already read: the port
    rebinds the tensor, so the earlier reader keeps the old value and
    autograd never sees a write. y = (2x)^2 and then h = 3 (2x + 1): the
    gradient of sum(y) + sum(h) is 8x + 6. (The JAX package's tape drops
    this gradient altogether, x.grad None: ROADMAP C17.)"""
    x = _leaf(tp, [1.0, 2.0, 3.0])
    h = x * 2
    y = h * h
    h.add_(tp.ones([3]))
    h.scale_(3.0)
    np.testing.assert_array_equal(y.numpy(), [4.0, 16.0, 36.0])
    np.testing.assert_array_equal(h.numpy(), [9.0, 15.0, 21.0])
    (y.sum() + h.sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), [14.0, 22.0, 30.0])


def test_setitem_with_grads():
    """``__setitem__`` writes into a clone and rebinds: h = [1.5 x0, 2 v,
    0, 0], so sum(h^2) has gradient [4.5 x0, 0, 0, 0] in x and 8 v in v.
    (The JAX package's tape drops both gradients: ROADMAP C17.)"""
    x = _leaf(tp, [1.0, 2.0, 3.0, 4.0])
    v = _leaf(tp, [10.0])
    h = x * 1.5
    h[1:2] = v * 2
    h[2:] = 0.0
    (h * h).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.5, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(v.grad.numpy(), [80.0])
    # the forward values equal the JAX package's
    j = jp.to_tensor([1.0, 2.0, 3.0, 4.0]) * 1.5
    j[1:2] = jp.to_tensor([20.0])
    j[2:] = 0.0
    np.testing.assert_array_equal(h.numpy(), j.numpy())


def test_inplace_on_a_leaf_that_requires_grad_raises():
    x = _leaf(tp, [1.0])
    with pytest.raises(RuntimeError, match="leaf"):
        x.add_(tp.ones([1]))
    with tp.no_grad():
        x.add_(tp.ones([1]))
    assert x.item() == 2.0 and x.is_leaf and not x.stop_gradient
