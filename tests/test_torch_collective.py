"""The port's eager collectives (`paddle_tpu_torch/distributed/
collective.py`) and its blockwise int8 codec (`quantization/comms.py`)
held against the JAX package's, on the CPU.

- The codec: `quantize_blockwise`'s values and scales,
  `dequantize_blockwise`, `roundtrip_bound` and `quantized_payload_nbytes`
  bit-equal to JAX's over sizes, block sizes and float32 / bfloat16
  inputs (the bf16 inputs are the same bits on both sides).
- One process (the ``local`` mode): every op's result and the
  ``collective.*`` counter deltas equal to JAX's for the same calls, and
  the assertions of JAX `tests/test_quantization.py::
  TestQuantizedAllreduce` (but its in-graph test: a port tensor is never
  a tracer).
- Two CPU processes joined by `init_parallel_env` over a TCPStore
  (`testing/collective_drill.py`, spawned as the elastic tests spawn
  their fleet): every op against numpy's closed form, the quantized
  SUM/AVG bit for bit against the sum of JAX's per-rank round trips
  (one add at P=2), the byte counters against JAX's formula, groups and
  p2p sequence keys that stay in step.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu.distributed as jdist
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.quantization import comms as jcomms

import paddle_tpu_torch as tp
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.quantization import comms as tcomms
from paddle_tpu_torch.testing import collective_drill as drill

SIZES = (1, 255, 256, 257, 4096)
BLOCKS = (1, 256, 1000)
WORLD = 2
NUMEL = 1000


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors go to the CPU here (its default is the
    card)."""
    with tdevice.device_scope("cpu"):
        yield


def _payload(n, dtype, seed=0):
    """The same input on both sides: a JAX array and a torch tensor with
    its bits."""
    x = jnp.asarray(np.random.RandomState(seed).randn(n).astype(np.float32)
                    * 3.0).astype(dtype)
    a = np.asarray(x)
    t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16) \
        if dtype == jnp.bfloat16 else torch.from_numpy(a.copy())
    return x, t


def _bits(v):
    """Comparable bits of a JAX array or a torch tensor."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy()
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", SIZES)
def test_codec_bit_equal_to_jax(n, block, dtype):
    x, t = _payload(n, dtype, seed=n)
    jq, js, jmeta = jcomms.quantize_blockwise(x, block)
    q, s, meta = tcomms.quantize_blockwise(t, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s), _bits(js))
    assert meta[:2] == (tuple(jmeta[0]), jmeta[1])
    np.testing.assert_array_equal(
        _bits(tcomms.dequantize_blockwise(q, s, meta)),
        _bits(jcomms.dequantize_blockwise(jq, js, jmeta)))
    np.testing.assert_array_equal(_bits(tcomms.roundtrip_bound(t, block)),
                                  _bits(jcomms.roundtrip_bound(x, block)))
    assert tcomms.quantized_payload_nbytes(q, s) == \
        jcomms.quantized_payload_nbytes(jq, js)


def test_dequantize_takes_leading_batch_axes():
    (x0, t0), (x1, t1) = _payload(300, jnp.float32, 1), \
        _payload(300, jnp.float32, 2)
    jparts = [jcomms.quantize_blockwise(x, 64) for x in (x0, x1)]
    parts = [tcomms.quantize_blockwise(t, 64) for t in (t0, t1)]
    meta = ((300,), 300, torch.float32)
    got = tcomms.dequantize_blockwise(torch.stack([p[0] for p in parts]),
                                      torch.stack([p[1] for p in parts]),
                                      meta)
    want = jcomms.dequantize_blockwise(
        jnp.stack([p[0] for p in jparts]), jnp.stack([p[1] for p in jparts]),
        ((300,), 300, jnp.float32))
    assert got.shape == (2, 300)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ local mode


def _counts(reg):
    snap = reg.snapshot()["counters"]
    return {k: v for k, v in snap.items() if k.startswith("collective.")}


def _delta(reg, before):
    return {k: v - before.get(k, 0) for k, v in _counts(reg).items()
            if v != before.get(k, 0)}


def _both(fn):
    """``fn(dist, to_tensor)`` on each package -> (jax result, port
    result, jax counter deltas, port counter deltas)."""
    out = []
    for dist, to_tensor, reg in ((jdist, jp.to_tensor, jmetrics),
                                 (tdist, tp.to_tensor, tmetrics)):
        before = _counts(reg)
        res = fn(dist, to_tensor)
        out.append((res, _delta(reg, before)))
    (jres, jd), (tres, td) = out
    return jres, tres, jd, td


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(e) for e in v]
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return v


X = np.random.RandomState(5).randn(4, 6).astype(np.float32)
LOCAL_OPS = {
    "all_reduce_sum": lambda d, T: d.all_reduce(T(X)),
    "all_reduce_max": lambda d, T: d.all_reduce(T(X), op=d.ReduceOp.MAX),
    "all_reduce_min": lambda d, T: d.all_reduce(T(X), op=d.ReduceOp.MIN),
    "all_reduce_prod": lambda d, T: d.all_reduce(T(X), op=d.ReduceOp.PROD),
    "all_reduce_avg": lambda d, T: d.all_reduce(T(X), op=d.ReduceOp.AVG),
    "quantized_sum": lambda d, T: d.all_reduce(T(X), quantized=True),
    "quantized_avg_block_5": lambda d, T: d.all_reduce(
        T(X), op=d.ReduceOp.AVG, quantized=True, quant_block=5),
    "all_gather": lambda d, T: d.all_gather([], T(X)),
    "all_gather_object": lambda d, T: d.all_gather_object([], {"a": [1]}),
    "reduce": lambda d, T: d.reduce(T(X), 0),
    "broadcast": lambda d, T: d.broadcast(T(X), 0),
    "scatter": lambda d, T: d.scatter(T(np.zeros(6, np.float32)),
                                      [T(X[0]), T(X[1])]),
    "reduce_scatter": lambda d, T: d.reduce_scatter(
        T(np.zeros(6, np.float32)), [T(X[0]), T(X[1])]),
    "alltoall": lambda d, T: d.alltoall([T(X[0]), T(X[1])]),
    "alltoall_single": lambda d, T: d.alltoall_single(T(X)),
    "alltoall_single_out": lambda d, T: d.alltoall_single(
        T(X), T(np.zeros_like(X))),
}


@pytest.mark.parametrize("name", sorted(LOCAL_OPS))
def test_local_op_equals_jax(name):
    jres, tres, jd, td = _both(LOCAL_OPS[name])
    assert td == jd
    got, want = _np(tres), _np(jres)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["send", "recv"])
def test_local_p2p_has_no_peer(op):
    msgs = []
    for dist, to_tensor in ((jdist, jp.to_tensor), (tdist, tp.to_tensor)):
        with pytest.raises(RuntimeError) as e:
            getattr(dist, op)(to_tensor(X), 0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_groups_bookkeeping_equals_jax():
    recs = []
    for dist in (jdist, tdist):
        dist.destroy_process_group()
        g0 = dist.get_group()
        g = dist.new_group([0, 3, 5], axis_name="dp")
        a, b = dist.split_group(g, [1, 2])
        rec = [repr(g0), g.ranks, g.nranks, g.world_size, g.rank,
               g.get_group_rank(5), g.is_member(), g.process_group() is g,
               a.ranks, b.ranks, b.rank, dist.get_group(g.id) is g,
               dist.get_rank(b), dist.get_world_size(b)]
        dist.destroy_process_group(a)
        rec.append(dist.get_group(a.id).id)
        dist.destroy_process_group()
        rec.append(repr(dist.get_group(g.id)))
        dist.wait(jp.to_tensor(X) if dist is jdist else tp.to_tensor(X))
        recs.append([g.id - g0.id, a.id - g0.id] + rec)
    assert recs[0] == recs[1]


# The assertions of JAX tests/test_quantization.py::TestQuantizedAllreduce
# (its in-graph test aside), on the port.

def _bytes_now():
    snap = tmetrics.snapshot()["counters"]
    return sum(v for k, v in snap.items() if k.startswith("collective.bytes"))


def test_codec_roundtrip_bound():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(777).astype(np.float32) * 5)
    q, s, meta = tcomms.quantize_blockwise(x, 64)
    assert q.dtype == torch.int8 and tuple(q.shape) == (13, 64)
    back = tcomms.dequantize_blockwise(q, s, meta)
    assert back.shape == x.shape
    err = (back - x).abs().numpy()
    bound = tcomms.roundtrip_bound(x, 64).numpy()
    assert (err <= bound + 1e-7).all()
    assert bound.max() <= float(x.abs().max()) / 127.0 + 1e-7


def test_local_allreduce_bound_and_payload():
    x = np.random.RandomState(1).randn(4096).astype(np.float32)
    t = tp.to_tensor(x.copy())
    b0 = _bytes_now()
    tdist.all_reduce(t)
    plain = _bytes_now() - b0
    qc0 = tmetrics.snapshot()["counters"].get("collective.quantized_calls",
                                              0)
    tq = tp.to_tensor(x.copy())
    b1 = _bytes_now()
    tdist.all_reduce(tq, quantized=True)
    quant = _bytes_now() - b1
    assert plain / quant >= 3.0, (plain, quant)
    assert tmetrics.snapshot()["counters"][
        "collective.quantized_calls"] == qc0 + 1
    err = np.abs(tq.numpy() - x)
    bound = tcomms.roundtrip_bound(torch.from_numpy(x)).numpy()
    assert (err <= bound + 1e-7).all()


def test_avg_and_unsupported_ops():
    x = np.random.RandomState(2).randn(100).astype(np.float32)
    t = tp.to_tensor(x.copy())
    tdist.all_reduce(t, op=tdist.ReduceOp.AVG, quantized=True)
    err = np.abs(t.numpy() - x)
    bound = tcomms.roundtrip_bound(torch.from_numpy(x)).numpy()
    assert (err <= bound + 1e-7).all()
    for op in (tdist.ReduceOp.MAX, tdist.ReduceOp.MIN, tdist.ReduceOp.PROD):
        msgs = []
        for dist, to_tensor in ((jdist, jp.to_tensor),
                                (tdist, tp.to_tensor)):
            with pytest.raises(ValueError, match="SUM/AVG") as e:
                dist.all_reduce(to_tensor(x.copy()), op=op, quantized=True)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------------- two CPU processes


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The drill on two CPU rank processes: their results and records."""
    out = str(tmp_path_factory.mktemp("collective_drill"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")}
    rcs = drill.spawn(WORLD, out, "cpu", NUMEL, env=env, timeout=240)
    logs = [open(os.path.join(out, f"rank{r}.log")).read()[-3000:]
            for r in range(WORLD)]
    assert rcs == [0] * WORLD, logs
    return ([dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(WORLD)],
            [json.load(open(os.path.join(out, f"rank{r}.json")))
             for r in range(WORLD)])


XS = [drill.inputs(r, NUMEL) for r in range(WORLD)]
CLOSED = {
    "all_reduce/sum": lambda r: XS[0] + XS[1],
    "all_reduce/avg": lambda r: (XS[0] + XS[1]) / np.float32(2),
    "all_reduce/max": lambda r: np.maximum(XS[0], XS[1]),
    "all_reduce/min": lambda r: np.minimum(XS[0], XS[1]),
    "all_reduce/prod": lambda r: XS[0] * XS[1],
    "broadcast": lambda r: XS[WORLD - 1],
    "scatter": lambda r: np.split(XS[0], WORLD)[r],
    "reduce_scatter": lambda r: np.split(XS[0], WORLD)[r]
    + np.split(XS[1], WORLD)[r],
    "alltoall_single": lambda r: np.concatenate(
        [np.split(XS[p], WORLD)[r] for p in range(WORLD)]),
}


def _bf16(a):
    """float32 values rounded to bfloat16 (to nearest even) and back."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


@pytest.mark.parametrize("name", sorted(CLOSED))
def test_fleet_op_equals_closed_form(fleet, name):
    arrays, _ = fleet
    for r in range(WORLD):
        np.testing.assert_array_equal(arrays[r][f"{name}/0"], CLOSED[name](r))


def test_fleet_gathers_alltoall_and_p2p(fleet):
    arrays, recs = fleet
    for r in range(WORLD):
        a = arrays[r]
        for p in range(WORLD):
            np.testing.assert_array_equal(a[f"all_gather/{p}"], XS[p])
            np.testing.assert_array_equal(a[f"alltoall/{p}"],
                                          np.split(XS[p], WORLD)[r])
        peer = (r - 1) % WORLD
        for i in range(drill.P2P_ROUNDS):
            np.testing.assert_array_equal(a[f"p2p/{i}"],
                                          XS[peer] * np.float32(i + 1))
        np.testing.assert_array_equal(a["isend_irecv/0"],
                                      XS[peer] + np.float32(1.0))
        ins, outs = drill.alltoall_single_splits(r, WORLD, NUMEL)
        want = np.concatenate([
            np.split(XS[p], np.cumsum(drill.alltoall_single_splits(
                p, WORLD, NUMEL)[0])[:-1])[r] for p in range(WORLD)])
        np.testing.assert_array_equal(a["alltoall_single_uneven/0"], want)
        assert len(want) == sum(outs)
        np.testing.assert_array_equal(a["all_reduce/sum_bf16/0"],
                                      _bf16(_bf16(XS[0]) + _bf16(XS[1])))
        assert recs[r]["objects"] == [{"rank": p, "tag": "r" * (p + 1)}
                                      for p in range(WORLD)]
        assert recs[r]["tasks_done"] == [True, True]


@pytest.mark.parametrize("block", drill.QUANT_BLOCKS)
@pytest.mark.parametrize("op", ["sum", "avg"])
def test_fleet_quantized_equals_jax_round_trips(fleet, op, block):
    """The quantized SUM/AVG bit for bit against the sum of JAX's per-rank
    `dequantize_blockwise(quantize_blockwise(x_r))`, within the sum of
    the ranks' bounds of the exact result."""
    arrays, recs = fleet
    b = block or jcomms.DEFAULT_BLOCK
    trips = [np.asarray(jcomms.dequantize_blockwise(
        *jcomms.quantize_blockwise(jnp.asarray(x), b))) for x in XS]
    want = trips[0] + trips[1]
    exact = XS[0] + XS[1]
    bound = sum(np.asarray(jcomms.roundtrip_bound(jnp.asarray(x), b))
                for x in XS)
    if op == "avg":
        want, exact, bound = (v / np.float32(WORLD)
                              for v in (want, exact, bound))
    q, s, _ = jcomms.quantize_blockwise(jnp.asarray(XS[0]), b)
    name = f"all_reduce_quantized/{op}/{block or 'default'}"
    for r in range(WORLD):
        got = arrays[r][f"{name}/0"]
        np.testing.assert_array_equal(got, want)
        assert (np.abs(got - exact) <= bound + 1e-6).all()
        assert recs[r]["ops"][name]["counts"] == {
            "collective.calls{mode=eager,op=all_reduce}": 1,
            "collective.bytes{mode=eager,op=all_reduce}":
                jcomms.quantized_payload_nbytes(q, s),
            "collective.quantized_calls": 1}


def test_fleet_counters_refusals_groups_and_p2p_keys(fleet):
    _, recs = fleet
    nb = NUMEL * 4
    want = {"all_reduce/sum": ("all_reduce", nb),
            "all_reduce/sum_bf16": ("all_reduce", NUMEL * 2),
            "all_gather": ("all_gather", nb),
            "broadcast": ("broadcast", nb),
            "reduce_scatter": ("reduce_scatter", nb),
            "alltoall": ("alltoall", nb),
            "alltoall_single": ("alltoall_single", nb),
            "alltoall_single_uneven": ("alltoall_single", nb),
            "send/0": ("send", nb), "recv/2": ("recv", nb)}
    for r, rec in enumerate(recs):
        for name, (op, n) in want.items():
            assert rec["ops"][name]["counts"] == {
                f"collective.calls{{mode=eager,op={op}}}": 1,
                f"collective.bytes{{mode=eager,op={op}}}": n}, name
        scatter = {"collective.calls{mode=eager,op=scatter}": 1,
                   "collective.bytes{mode=eager,op=scatter}": nb // WORLD}
        if r:        # a receiving rank's scatter is a recv too
            scatter.update({"collective.calls{mode=eager,op=recv}": 1,
                            "collective.bytes{mode=eager,op=recv}":
                                nb // WORLD})
        assert rec["ops"]["scatter"]["counts"] == scatter
        assert rec["ops"]["all_gather_object"]["counts"] == {}
        for op in ("max", "min", "prod"):
            assert rec["ops"][f"quantized_refused/{op}"] == \
                f"quantized all_reduce supports SUM/AVG, got {op!r}"
        g = rec["groups"]
        assert g["new_group"] == [0, 1] and g["split"] == [[0], [1]]
        assert g["get_group"] == [0, 1]
        assert g["rank_in_halves"] == [0 if r == 0 else -1,
                                       -1 if r == 0 else 0]
        assert g["world_in_g"] == WORLD and g["rank_in_g"] == r
        assert g["after_destroy"] == 0 and g["after_destroy_all"] == 0
        # scatter (from 0), alltoall, the uneven alltoall_single, the p2p
        # rounds and the isend: every pair's keys in step on both ends
        sends = 1 + drill.P2P_ROUNDS + 1 + 1
        assert rec["p2p_seq"] == {"0to1": sends + 1, "1to0": sends}


def test_margin_gated_parity_takes_the_default_bound():
    """`bench_quant`'s parity harness calls `margin_gated_parity` with two
    arguments (`bench.py:995`): the bound defaults to QUANT_LOGIT_BOUND in
    both packages, with the same verdicts."""
    from paddle_tpu.quantization import serving as jserving
    from paddle_tpu_torch.quantization import serving as tserving
    assert tserving.QUANT_LOGIT_BOUND == jserving.QUANT_LOGIT_BOUND
    rng = np.random.RandomState(6)
    ref = rng.randn(3, 50).astype(np.float32) * 4
    for noise in (0.1, 0.4, 0.7):
        got = ref + noise * np.sign(rng.randn(3, 50)).astype(np.float32)
        want = jserving.margin_gated_parity(jnp.asarray(ref),
                                            jnp.asarray(got))
        diff, ok = tserving.margin_gated_parity(torch.from_numpy(ref),
                                                torch.from_numpy(got))
        assert ok == want[1] and diff == pytest.approx(want[0], abs=1e-6)
