"""`paddle.amp` on the port (`paddle_tpu_torch/amp/`) held against the JAX
package's on the CPU: the output dtype of each op under ``auto_cast`` at
O1 and O2 and with custom lists, ``decorate``'s parameter dtypes and
master copies, and the ``GradScaler``'s state machine, error texts,
dynamic scale sequence and ``state_dict`` over the same float16
gradients, overflowing ones included.

Only ``linear`` and ``matmul`` cast (the JAX package's cast sites; its
``conv`` sites come with the convolutions, ROADMAP A7.2), so every other
op keeps its inputs' dtype in both packages.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.dtype import dtype_name


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    with tdevice.device_scope("cpu"):
        yield


def _name(m, t):
    return dtype_name(t.dtype) if m is tp else str(t.dtype)


def _ops(m, dtype):
    """Each op once on float inputs of ``dtype`` (a matmul also on mixed
    inputs): {op: output dtype name}."""
    rng = np.random.RandomState(0)
    x = m.to_tensor(rng.randn(2, 4).astype(np.float32)).astype(dtype)
    w = m.to_tensor(rng.randn(4, 3).astype(np.float32)).astype(dtype)
    b = m.to_tensor(rng.randn(3).astype(np.float32))
    other = m.to_tensor(rng.randn(4, 3).astype(np.float32))
    F = m.nn.functional
    outs = {
        "linear": F.linear(x, w, b),
        "linear_nobias": F.linear(x, w),
        "matmul": m.matmul(x, w),
        "matmul_mixed": m.matmul(x, other),
        "matmul_t": m.matmul(w, x, transpose_x=True, transpose_y=True),
        "add": x + x,
        "exp": m.exp(x),
        "softmax": F.softmax(x),
        "mean": m.mean(x),
        "gelu": F.gelu(x),
        "layer_norm": F.layer_norm(x, [4]),
    }
    return {k: _name(m, v) for k, v in outs.items()}


CASES = {
    "off": dict(enable=False),
    "o1_bf16": dict(level="O1", dtype="bfloat16"),
    "o2_bf16": dict(level="O2", dtype="bfloat16"),
    "o1_fp16": dict(level="O1", dtype="float16"),
    "o2_fp16": dict(level="O2", dtype="float16"),
    "o1_black_linear": dict(level="O1", custom_black_list=["linear"]),
    "o2_black_matmul": dict(level="O2", custom_black_list=["matmul"]),
    "o1_white_exp": dict(level="O1", custom_white_list=["exp"]),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_output_dtypes_match_jax(case, dtype):
    got = {}
    for m in (tp, jp):
        with m.amp.auto_cast(**CASES[case]):
            got[m] = _ops(m, dtype)
    assert got[tp] == got[jp]
    if case == "o1_bf16":
        assert got[tp]["linear"] == "bfloat16"
        assert got[tp]["exp"] == dtype


def test_auto_cast_restores_the_state_and_amp_guard_is_it():
    st = tp.amp.state.amp_state()
    with tp.amp.auto_cast(level="O2", dtype="float16",
                          custom_white_list=["exp"]):
        assert st.enabled and st.level == "O2" and st.dtype == torch.float16
        with tp.amp.amp_guard(enable=False):
            assert not tp.amp.state.in_amp_context()
        assert tp.amp.state.amp_dtype() == torch.float16
    assert not st.enabled and st.custom_white == set()
    assert tp.amp.WHITE_LIST == jp.amp.WHITE_LIST
    assert tp.amp.BLACK_LIST == jp.amp.BLACK_LIST


def _model(m):
    m.seed(4)
    return m.nn.Sequential(m.nn.Linear(4, 8), m.nn.LayerNorm(8),
                           m.nn.Linear(8, 2))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_dtypes_and_master_copies(level):
    x = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    res = {}
    for m in (tp, jp):
        model = _model(m)
        before = {k: np.asarray(v.numpy()) for k, v in
                  model.state_dict().items()}
        opt = m.optimizer.AdamW(learning_rate=1e-3,
                                parameters=model.parameters())
        model, opt = m.amp.decorate(model, opt, level=level,
                                    dtype="bfloat16")
        dtypes = {k: _name(m, v) for k, v in model.state_dict().items()}
        if level == "O2":
            for k, p in model.named_parameters():
                assert _name(m, p._master) == "float32"
                assert np.array_equal(np.asarray(p._master.numpy()),
                                      before[k])
        assert opt._use_master_weights == (level == "O2")
        with m.amp.auto_cast(level=level, dtype="bfloat16"):
            loss = model(m.to_tensor(x)).astype("float32").mean()
        loss.backward()
        opt.step()
        masters = {k: np.asarray(opt._master_weights[id(p)]._data
                                 if m is jp else
                                 opt._master_weights[id(p)], np.float64)
                   for k, p in model.named_parameters()} \
            if level == "O2" else {}
        res[m] = (dtypes, float(loss), masters,
                  {k: np.asarray(v.numpy(), np.float64)
                   for k, v in model.state_dict().items()})
    assert res[tp][0] == res[jp][0]
    assert abs(res[tp][1] - res[jp][1]) <= 1e-2
    for k, v in res[tp][2].items():
        assert np.abs(v - res[jp][2][k]).max() <= 2e-3
        # the parameter is its master copy rounded to bfloat16
        own = torch.from_numpy(v.astype(np.float32)).bfloat16().float()
        assert np.array_equal(res[tp][3][k], own.numpy().astype(np.float64))


def _scaler_run(m, xs, **kw):
    """A float16 Linear trained through a GradScaler over the inputs
    ``xs`` (one holding inf overflows): the scale after every update, whether
    each step moved the weights, and the state_dict."""
    m.seed(6)
    model = m.nn.Linear(4, 2)
    model.to(dtype="float16")
    opt = m.optimizer.SGD(learning_rate=1e-2, parameters=model.parameters())
    scaler = m.amp.GradScaler(**kw)
    scales, moved = [], []
    for x in xs:
        w0 = np.asarray(model.weight.numpy(), np.float64).copy()
        loss = model(m.to_tensor(x)).astype("float32").sum()
        scaler.scale(loss).backward()
        scaler.minimize(opt, loss)
        opt.clear_grad()
        scales.append(scaler.get_init_loss_scaling())
        moved.append(not np.array_equal(
            w0, np.asarray(model.weight.numpy(), np.float64)))
    return scales, moved, scaler.state_dict(), \
        np.asarray(model.weight.numpy(), np.float64)


def test_grad_scaler_scale_sequence_matches_jax():
    rng = np.random.RandomState(2)
    xs = [rng.randn(3, 4).astype(np.float16) for _ in range(9)]
    for i in (2, 3, 6):
        xs[i][0, 0] = np.inf                # its gradients overflow
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    t, j = _scaler_run(tp, xs, **kw), _scaler_run(jp, xs, **kw)
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert False in t[1] and True in t[1]
    assert t[2] == j[2]
    assert np.abs(t[3] - j[3]).max() <= 1e-3


def test_grad_scaler_state_machine_errors_match_jax():
    texts = {}
    for m in (tp, jp):
        model = m.nn.Linear(2, 2)
        opt = m.optimizer.SGD(learning_rate=0.1,
                              parameters=model.parameters())
        scaler = m.amp.GradScaler(init_loss_scaling=8.0)
        got = []
        for calls in (("unscale_", "unscale_"), ("step", "unscale_"),
                      ("step", "step")):
            scaler.scale(model(m.to_tensor(np.ones((1, 2), np.float32)))
                         .sum()).backward()
            with pytest.raises(RuntimeError) as e:
                for c in calls:
                    getattr(scaler, c)(opt)
            got.append(str(e.value))
            scaler.update()
            opt.clear_grad()
        texts[m] = got
        sd = scaler.state_dict()
        scaler.load_state_dict(dict(sd, scale=3.0, good_steps=1))
        assert scaler.get_init_loss_scaling() == 3.0
        assert scaler.state_dict()["good_steps"] == 1
    assert texts[tp] == texts[jp]
    assert len(set(texts[tp])) == 3
