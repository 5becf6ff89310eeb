"""The port's node registries (`paddle_tpu_torch/distributed/fleet/
elastic.py`), weight file (`framework/io.py`) and fleet collector
(`observability/fleet.py`) held against the JAX package's.

- Registries: one `NodeRegistry` directory and one `TcpRegistryServer`
  shared by both packages: each sees the other's leases, the lease files
  and lines are the same, the TCP registry refuses to run without
  ``PADDLE_ELASTIC_TOKEN`` in both; the role scheme of
  `tests/test_disagg.py::TestRoleScheme` in both.
- ``PDTPU001``: files written by either package load in the other
  (float32, bfloat16, int32), byte-equal when written from the same
  arrays; a JAX GPT's saved state dict loads into the port's model.
- Collector: `FleetMetrics` rollups, relabelled Prometheus text and the
  HTTP exporter over two registries equal to the JAX collector's on the
  same snapshots (`tests/test_fleet_observability.py:555-634`);
  `TraceCollector` stitching, trace pulls, STATS scrapes and DEBUG_DUMP
  over the wire against a port replica and a JAX replica.
- The new modules import no JAX, JAX package or ``ml_dtypes`` (a
  subprocess probe).
"""
import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.fleet.elastic as jel
import paddle_tpu.inference.engine as jeng
import paddle_tpu.inference.serve as jserve
import paddle_tpu.observability.fleet as jfleet
import paddle_tpu_torch.distributed.fleet.elastic as tel
import paddle_tpu_torch.inference.engine as teng
import paddle_tpu_torch.inference.serve as tserve
import paddle_tpu_torch.observability.fleet as tfleet
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import MetricsRegistry as JRegistry
from paddle_tpu.observability.tracing import mint_trace
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import MetricsRegistry as TRegistry
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.tensor import torch_state


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64)
FLEET = "fleet-obs"
PKGS = {"jax": jel, "torch": tel}


# ------------------------------------------------------------- registries


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_node_registry_directory_shared(tmp_path, writer, reader):
    w = PKGS[writer].NodeRegistry(str(tmp_path), "prefill:p0",
                                  "127.0.0.1:7001", heartbeat_interval=0.2)
    w.register()
    try:
        obs = PKGS[reader].NodeRegistry(str(tmp_path))
        assert obs.alive_nodes() == {"prefill:p0": "127.0.0.1:7001"}
        info = json.loads((tmp_path / "node_prefill:p0.json").read_text())
        assert sorted(info) == ["endpoint", "ts", "ttl"]
        with pytest.raises(RuntimeError, match="observer"):
            obs.register()
    finally:
        w.leave()
    assert PKGS[reader].NodeRegistry(str(tmp_path)).alive_nodes() == {}


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_tcp_registry_shared(monkeypatch, server_pkg):
    monkeypatch.setenv("PADDLE_ELASTIC_TOKEN", "fleet-test-secret")
    srv = PKGS[server_pkg].TcpRegistryServer().start()
    try:
        addr = f"127.0.0.1:{srv.port}"
        regs = [PKGS[p].TcpNodeRegistry(addr, f"r-{p}", f"10.0.0.{i}:1",
                                        heartbeat_interval=0.2).register()
                for i, p in enumerate(("jax", "torch"))]
        want = {"r-jax": "10.0.0.0:1", "r-torch": "10.0.0.1:1"}
        for p in PKGS:
            assert PKGS[p].TcpNodeRegistry(addr).alive_nodes() == want
        regs[0].leave()
        assert PKGS["torch"].TcpNodeRegistry(addr).alive_nodes() \
            == {"r-torch": "10.0.0.1:1"}
        # a late renewal of the departed session is tombstoned
        resp = regs[0]._call({"op": "put", "node_id": "r-jax",
                              "endpoint": "10.0.0.0:1", "ttl": 30,
                              "nonce": regs[0]._nonce})
        assert resp.get("stale")
        regs[1].leave()
    finally:
        srv.stop()


def test_tcp_registry_refuses_without_token(monkeypatch):
    monkeypatch.delenv("PADDLE_ELASTIC_TOKEN", raising=False)
    msgs = []
    for mod in PKGS.values():
        with pytest.raises(RuntimeError, match="PADDLE_ELASTIC_TOKEN") as ei:
            mod.TcpRegistryServer()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_role_scheme(pkg):
    mod = PKGS[pkg]
    assert mod.role_node_id("prefill", "p0") == "prefill:p0"
    assert mod.node_role(mod.role_node_id("decode", "d1")) == "decode"
    assert mod.router_node_id("x") == mod.role_node_id("router", "x")
    assert mod.node_role(mod.router_node_id("x")) == "router"
    for legacy in ("replica-123", "legacy-id", "r0", "node_7",
                   "NotARole:x", "1bad:x", ":empty", "with space:x"):
        assert mod.node_role(legacy) == "replica", legacy
    for bad in ("Bad", "has space", "", "1digit", "way" + "x" * 40):
        with pytest.raises(ValueError):
            mod.role_node_id(bad, "id")


def test_unknown_role_prefix_stays_a_migration_peer():
    class _FakeReg:
        node_id = "self"
        endpoint = "h:1"

        def alive_nodes(self):
            return {"east-1:replica-3": "h:2", "router:r": "h:3",
                    "prefill:p": "h:4", "legacy": "h:5", "decode:d": "h:6",
                    "self": "h:1"}

    peers = []
    for serve in (jserve, tserve):
        srv = serve.InferenceServer.__new__(serve.InferenceServer)
        srv._registry = _FakeReg()
        peers.append(srv._discover_peers())
    assert peers[0] == peers[1] == ["h:6", "h:2", "h:5"]


# ------------------------------------------------------------ weight file

ARRAYS = {"float32": np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4),
          "bfloat16": np.linspace(-2, 2, 12, dtype=np.float32)
          .reshape(4, 3).astype(ml_dtypes.bfloat16),
          "int32": np.arange(-5, 5, dtype=np.int32)}


def _jax_tree(arr):
    t = Tensor(jnp.asarray(arr), _internal=True)
    return {"w": t, "nested": [t, {"n": 3}], "s": "text"}


def _port_tree(arr):
    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
        if arr.dtype.name == "bfloat16" else torch.from_numpy(arr)
    return {"w": t, "nested": [t, {"n": 3}], "s": "text"}


def _words(x):
    """An array's or a tensor's values, bfloat16 as its 16-bit words."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("dtype", sorted(ARRAYS))
def test_pdtpu001_round_trips_both_ways(tmp_path, dtype):
    arr = ARRAYS[dtype]
    jpath, tpath = tmp_path / "jax.pd", tmp_path / "port.pd"
    paddle.save(_jax_tree(arr), str(jpath))
    tio.save(_port_tree(arr), str(tpath))
    assert jpath.read_bytes() == tpath.read_bytes()
    # the port reads the JAX file: tensors of the same bits and dtype
    back = tio.load(str(jpath))
    assert back["s"] == "text" and back["nested"][1] == {"n": 3}
    want_dtype = torch.bfloat16 if dtype == "bfloat16" \
        else getattr(torch, dtype)
    for t in (back["w"], back["nested"][0]):
        assert t.dtype == want_dtype
        assert np.array_equal(_words(t), _words(arr))
    # return_numpy gives what the JAX load gives (bf16: its raw V2 array)
    jnp_ = paddle.load(str(tpath), return_numpy=True)
    tnp = tio.load(str(jpath), return_numpy=True)
    assert jnp_["w"].dtype == tnp["w"].dtype
    assert jnp_["w"].tobytes() == tnp["w"].tobytes() == arr.tobytes()
    if dtype != "bfloat16":       # the JAX load of a bf16 file raises (C12)
        jt = paddle.load(str(tpath))["w"]
        assert np.array_equal(np.asarray(jt._data), arr)


def test_pdtpu001_refuses_other_jax_globals(tmp_path):
    import pickle
    path = tmp_path / "evil.pd"
    path.write_bytes(pickle.dumps({"x": jel.NodeRegistry}))
    with pytest.raises(pickle.UnpicklingError, match="paddle_tpu"):
        tio.load(str(path))
    path.write_bytes(pickle.dumps({"x": np.arange(3)}))
    assert np.array_equal(tio.load(str(path))["x"], np.arange(3))


def test_jax_saved_gpt_state_loads_into_the_port_model(tmp_path):
    paddle.seed(3)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    path = tmp_path / "gpt.pdparams"
    paddle.save(jm.state_dict(), str(path))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY))
    missing, unexpected = tm.set_state_dict(tio.load(str(path)))
    assert missing == [] and unexpected == []
    for k, v in jm.state_dict().items():
        assert np.array_equal(torch_state(tm)[k].numpy(),
                              np.asarray(v._data)), k
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.set_state_dict({"gpt.wte.weight": torch.zeros(3, 3)})
    # a bf16 file casts into the float32 model as the JAX load would
    tio.save({k: v.to(torch.bfloat16) for k, v in torch_state(tm).items()},
             str(path))
    tm.set_state_dict(tio.load(str(path)))
    assert tm.gpt.wte.weight.dtype == torch.float32


# ---------------------------------------------------------- metrics plane


def _two_registries(cls):
    a, b = cls(), cls()
    a.counter("serve.requests").inc(3)
    b.counter("serve.requests").inc(5)
    a.counter("engine.tokens").inc(40)
    b.counter("engine.tokens").inc(60)
    a.gauge("engine.pages_in_use").set(4)
    b.gauge("engine.pages_in_use").set(6)
    a.gauge("engine.tokens_per_s").set(10.0)
    b.gauge("engine.tokens_per_s").set(7.5)
    for v in (0.1, 0.3):
        a.histogram("serve.ttft_seconds").observe(v)
    for v in (0.2, 0.6):
        b.histogram("serve.ttft_seconds").observe(v)
    a.counter("router.replica_requests", replica="r9").inc()
    return a, b


def _fed(fleet_mod, snaps):
    fm = fleet_mod.FleetMetrics()
    fm.ingest("d0", "decode", "127.0.0.1:1", snaps[0])
    fm.ingest("p0", "prefill", "127.0.0.1:2", snaps[1])
    return fm


def _no_age(roll):
    return dict(roll, members={k: dict(v, age_s=0)
                               for k, v in roll["members"].items()})


@pytest.mark.parametrize("source", ["jax", "torch"])
def test_fleet_rollup_and_exposition_equal_the_jax_collector(source):
    snaps = [r.snapshot() for r in _two_registries(
        JRegistry if source == "jax" else TRegistry)]
    jfm, tfm = _fed(jfleet, snaps), _fed(tfleet, snaps)
    roll = tfm.rollup()
    assert _no_age(roll) == _no_age(jfm.rollup())
    assert tfm.to_prometheus() == jfm.to_prometheus()
    assert roll["counters"]["serve.requests"] == 8
    h = roll["histograms"]["serve.ttft_seconds"]
    assert h["count"] == 4 and h["min"] == 0.1 and h["max"] == 0.6
    assert roll["fleet"]["pages_in_use"] == {"d0": 4, "p0": 6}
    text = tfm.to_prometheus()
    assert 'serve_requests{role="decode",replica="d0"} 3' in text
    assert 'router_replica_requests{replica="r9",role="decode"} 1' in text
    assert "fleet_tokens_per_s 17.5" in text
    assert tfm.snapshot_for("127.0.0.1:2") is snaps[1]
    assert tfleet.merge_histograms([s["histograms"]["serve.ttft_seconds"]
                                    for s in snaps]) \
        == jfleet.merge_histograms([s["histograms"]["serve.ttft_seconds"]
                                    for s in snaps])


def test_fleet_http_exporter_serves_what_the_jax_one_does():
    snaps = [r.snapshot() for r in _two_registries(TRegistry)]
    bodies = []
    for mod in (jfleet, tfleet):
        srv = mod.start_fleet_exporter(_fed(mod, snaps))
        try:
            port = srv.server_address[1]
            metrics = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10).read()
            roll = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/fleet", timeout=10).read())
            bodies.append((metrics, _no_age(roll)))
        finally:
            srv.shutdown()
    assert bodies[0] == bodies[1]
    assert b'serve_requests{role="decode",replica="d0"} 3' in bodies[1][0]


def test_trace_stitch_equal_and_lane_separated():
    exports = [
        {"node": {"role": "router", "node_id": "router:a", "pid": 11},
         "spans": [{"name": "router.forward", "cat": "router", "ph": "X",
                    "pid": 11, "tid": 1, "ts": 2000.0, "dur": 50.0,
                    "args": {}}]},
        {"node": {"role": "decode", "node_id": "d0", "pid": 22},
         "spans": [{"name": "request.e2e", "cat": "request", "ph": "X",
                    "pid": 22, "tid": 2, "ts": 2010.0, "dur": 30.0,
                    "args": {}}]}]
    trace = tfleet.TraceCollector.stitch(exports)
    assert trace == jfleet.TraceCollector.stitch(exports)
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert len({e["pid"] for e in xs}) == 2 and min(e["ts"] for e in xs) == 0


# ------------------------------------------- over the wire, both replicas


def _pair_models():
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY))
    tm.set_state_dict({k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def replicas():
    """A JAX replica and a port replica, one fleet secret."""
    jm, tm = _pair_models()
    cfg = dict(page_size=4, max_slots=2, min_bucket=8)
    srvs = {"jax": jserve.InferenceServer(
        None, engine=jeng.DecodeEngine(jm, jeng.EngineConfig(**cfg)),
        auth_name=FLEET),
        "torch": tserve.InferenceServer(
            None, engine=teng.DecodeEngine(tm, teng.EngineConfig(**cfg),
                                           device="cpu"),
            auth_name=FLEET)}
    for srv in srvs.values():
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srvs
    for srv in srvs.values():
        srv._stop.set()
        srv._engine_thread.join(timeout=30)
        srv._sock.close()


def test_collector_pulls_and_stitches_both_replicas(replicas):
    members = {f"{p}-r": f"127.0.0.1:{s.port}" for p, s in replicas.items()}
    tid, span = mint_trace()
    for p, srv in replicas.items():
        cli = tserve.RemotePredictor(port=srv.port, secret=FLEET)
        cli.generate(np.arange(2, 8, dtype=np.int32), max_new_tokens=3,
                     trace_id=tid, parent_span=span)
        cli.close()
    for mod in (tfleet, jfleet):
        exports = mod.TraceCollector(members, secret=FLEET).pull(tid)
        # both processes are this one: two exports of one span buffer
        # each (the JAX registry's and the port's)
        assert len(exports) == 2
        trace = mod.TraceCollector.stitch(exports)
        xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        assert xs and all(e["args"]["trace_id"] == tid for e in xs)
        assert min(e["ts"] for e in xs) == 0.0
    names = {e["name"] for ex in tfleet.TraceCollector(
        members, secret=FLEET).pull(tid) for e in ex["spans"]}
    assert {"request.e2e", "client.generate"} <= names


def test_scrape_once_and_debug_dump_over_the_wire(replicas):
    members = {f"decode:{p}": f"127.0.0.1:{s.port}"
               for p, s in replicas.items()}
    members["gone"] = "127.0.0.1:9"
    fms = [jfleet.FleetMetrics(), tfleet.FleetMetrics()]
    assert jfleet.scrape_once(fms[0], members, secret=FLEET) == 2
    assert tfleet.scrape_once(fms[1], members, secret=FLEET) == 2
    for fm in fms:
        mem = fm.members()
        assert sorted(mem) == ["decode:jax", "decode:torch"]
        assert {m["role"] for m in mem.values()} == {"both"}
    for p, srv in replicas.items():
        for serve in (jserve, tserve):
            cli = serve.RemotePredictor(port=srv.port, secret=FLEET)
            dump = cli.debug_dump()
            cli.close()
            assert set(dump) == {"node", "events", "metrics"}
            assert dump["node"]["pid"] == os.getpid()
            assert isinstance(dump["events"], list)


def test_fleet_cli_once_and_trace(replicas, capsys):
    port = replicas["torch"].port
    tfleet.main(["--member", f"r0=127.0.0.1:{port}", "--secret", FLEET,
                 "--once"])
    roll = json.loads(capsys.readouterr().out)
    assert list(roll["members"]) == ["r0"]
    with pytest.raises(SystemExit, match="no members"):
        tfleet.main([])
    with pytest.raises(SystemExit, match="ID=HOST:PORT"):
        tfleet.main(["--member", "nohost"])


# ------------------------------------------------------------ import probe

_PROBE = r"""
import sys
import paddle_tpu_torch.inference.serve, paddle_tpu_torch.framework.io
import paddle_tpu_torch.distributed.fleet.elastic
import paddle_tpu_torch.observability.fleet
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu", "ml_dtypes"))
print("BAD", bad)
"""


def test_serve_tier_modules_import_no_jax_or_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
