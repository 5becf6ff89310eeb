"""The port's serve tier (`paddle_tpu_torch/inference/serve.py`) held against
the JAX package's (`paddle_tpu/inference/serve.py`) in one process, on the
tiny model of `tests/test_migration.py` (vocab 97, 32 wide, 2 layers,
``page_size=4``, 2 slots) in float32, with both packages' weights drawn
by numpy from one seed.

Each scenario of the JAX wire tests (`tests/test_engine.py::
TestServeGenerate`, `tests/test_migration.py::TestWireMigration` but the
routed drill, `tests/test_control_plane.py::TestExactlyOnce` without a
router and `TestWireIntegrity`'s corrupt-blob drill,
`tests/test_tracing.py::...test_trace_threads_through_serve_wire`,
`tests/test_spec_prefix.py::TestServeKnobs`,
`tests/test_disagg.py::...test_prefill_role_refuses_decode_work`, and the
`InferenceServer` cancel-recording of `TestEngineMigration`) runs once
with JAX replicas and clients and once with the port's, through `both`:
the records (tokens, typed error classes and texts, ``serve.*`` /
``engine.*`` counter deltas of each package's own registry, free pages)
must be equal, and the tokens equal an uninterrupted engine's. Timing is
pinned as the JAX tests pin it: ``engine.step_delay`` armed on the side
under test, every wait bounded, every server's engine thread stopped at
the end.

Across the packages: a JAX client against a port server and the reverse,
drains from either package into the other, a prefill worker's ``PTKS1``
records of either package fed to the other's KV_STREAM, equal auth
digests, and equal wire frames for every dtype (bfloat16 as raw words).
The CLI: the port's ``--device cpu`` server on a weight file the JAX
``paddle.save`` wrote answers the JAX CLI's tokens and drains to exit 0
on SIGTERM.
"""
import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference.engine as jeng
import paddle_tpu.inference.errors as jerr
import paddle_tpu.inference.serve as jserve
import paddle_tpu_torch.inference.engine as teng
import paddle_tpu_torch.inference.errors as terr
import paddle_tpu_torch.inference.serve as tserve
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64)
FLEET = "serve-fleet"
COUNTERS = ("serve.requests", "serve.generate_requests", "serve.errors",
            "serve.cancels", "serve.disconnect_cancels",
            "serve.migrations_out", "serve.migrations_in",
            "serve.migrate_drops", "serve.migrate_failed",
            "serve.blob_corrupt_refused", "serve.kv_stream_in",
            "serve.prefill_streams", "serve.drains", "serve.request_errors",
            "engine.requests", "engine.dedup_replays", "engine.cancelled",
            "engine.migrations_out", "engine.migrations_in",
            "engine.prefix_hit", "engine.spec_drafted", "router.failovers")
BYTES = ("serve.request_bytes", "serve.response_bytes")


def _pair(seed):
    """A JAX and a port GPT on the same numpy-drawn weights, and the
    weights."""
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    rng = np.random.RandomState(seed)
    w = {}
    for k, v in jm.state_dict().items():
        base = 1.0 if k.endswith(("ln_1.weight", "ln_2.weight",
                                  "ln_f.weight")) else 0.0
        w[k] = (base + rng.randn(*v._data.shape) * 0.1).astype(np.float32)
    jm.set_state_dict(w)
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY))
    tm.set_state_dict(params_from_numpy(w, "cpu"))
    return jm, tm, w


@pytest.fixture(scope="module")
def models():
    return _pair(7)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    jfaults.disarm()
    tfaults.disarm()


def _wait_for(pred, timeout=30.0, msg="condition"):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.02)


def _stop_server(srv):
    """Stop a server's engine thread (a leaked loop eats faults armed by
    later scenarios) and close its socket."""
    srv._stop.set()
    if srv._engine_thread is not None:
        srv._engine_thread.join(timeout=30)
        assert not srv._engine_thread.is_alive()
    srv._sock.close()


def _ref(models, prompt, n, **ekw):
    """The port engine's uninterrupted tokens for ``prompt``."""
    eng = teng.DecodeEngine(models[1], teng.EngineConfig(
        page_size=4, max_slots=2, min_bucket=8, **ekw), device="cpu")
    req = eng.submit(np.asarray(prompt, np.int32), n)
    eng.run_until_idle()
    return req.result(timeout=0).tolist()


def _norm(text):
    """An error text without the socket ports and request ids that differ
    between two runs."""
    text = re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:P", text)
    return re.sub(r"port \d+", "port P", text)


class Side:
    """One package's half of a scenario: its serve module, engines,
    faults, errors and registry deltas; every replica it starts is
    stopped by `close`."""

    def __init__(self, name, models):
        self.jax = name == "jax"
        self.name = name
        self.serve = jserve if self.jax else tserve
        self.faults = jfaults if self.jax else tfaults
        self.errors = jerr if self.jax else terr
        self.metrics = jmetrics if self.jax else tmetrics
        self.model = models[0 if self.jax else 1]
        self.servers = []
        self.c0 = self._counters()

    def engine(self, **kw):
        cfg = {"page_size": 4, "max_slots": 2, "min_bucket": 8, **kw}
        if self.jax:
            return jeng.DecodeEngine(self.model, jeng.EngineConfig(**cfg))
        return teng.DecodeEngine(self.model, teng.EngineConfig(**cfg),
                                 device="cpu")

    def replica(self, role="both", auth_name=FLEET, **ekw):
        srv = self.serve.InferenceServer(None, engine=self.engine(**ekw),
                                         auth_name=auth_name, role=role)
        srv.accept_thread = threading.Thread(target=srv.serve_forever,
                                             daemon=True)
        srv.accept_thread.start()
        self.servers.append(srv)
        return srv

    def client(self, port, **kw):
        kw.setdefault("secret", FLEET)
        return self.serve.RemotePredictor(port=port, **kw)

    def _counters(self):
        snap = self.metrics.snapshot()
        return {k: snap["counters"].get(k, 0) for k in COUNTERS + BYTES}

    def delta(self, names=COUNTERS):
        now = self._counters()
        return {k: now[k] - self.c0[k] for k in names}

    def close(self):
        for srv in self.servers:
            _stop_server(srv)


def both(models, scenario, **kw):
    """Run ``scenario(side, **kw)`` with the JAX package, then the port;
    the two records must be equal. Returns them."""
    recs = {}
    for name in ("jax", "torch"):
        side = Side(name, models)
        try:
            recs[name] = scenario(side, **kw)
        finally:
            side.close()
    assert recs["jax"] == recs["torch"], recs
    return recs


def _mid_decode(srv):
    return any(r is not None and len(r.generated) >= 2
               for r in srv._engine._slot_req)


def _baseline(eng):
    return eng.allocator.free_pages == eng.allocator.num_pages - 1


def _outcome(fn):
    """``("ok", tokens)`` or ``("err", class name, normalized text)``."""
    try:
        return ("ok", np.asarray(fn()).tolist())
    except Exception as e:  # noqa: BLE001 — recorded for comparison
        return ("err", type(e).__name__, _norm(str(e)))


# ------------------------------------------------------- TestServeGenerate


def sc_concurrent_clients(s, prompts):
    srv = s.replica()
    outs = [None] * len(prompts)

    def client(i):
        cli = s.client(srv.port)
        outs[i] = cli.generate(prompts[i], max_new_tokens=6).tolist()
        cli.close()

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(len(prompts))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
        assert not t.is_alive()
    return {"tokens": outs, "counters": s.delta(COUNTERS + BYTES),
            "baseline": _baseline(srv._engine)}


def test_concurrent_clients_match_in_process_engine(models):
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 97, 4 + i).astype(np.int32) for i in range(3)]
    recs = both(models, sc_concurrent_clients, prompts=prompts)
    assert recs["torch"]["tokens"] == [_ref(models, p, 6) for p in prompts]
    assert recs["torch"]["counters"]["serve.generate_requests"] == 3


def sc_random_secret(s):
    srv = s.serve.InferenceServer(None, engine=s.engine(max_slots=1))
    srv2 = s.serve.InferenceServer(None, engine=s.engine(max_slots=1))
    s.servers += [srv, srv2]
    rec = {"minted": bool(srv.generated_secret)
           and len(srv.generated_secret) >= 32
           and srv2.generated_secret != srv.generated_secret}
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    raw = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
    raw.sendall(struct.pack("<I", s.serve.MAGIC)
                + s.serve.auth_token("None"))
    raw.settimeout(5)
    try:
        rec["guess_dropped"] = raw.recv(12) == b""
    except ConnectionResetError:
        rec["guess_dropped"] = True
    raw.close()
    cli = s.client(srv.port, secret=srv.generated_secret)
    rec["ping"] = cli.ping()
    cli.close()
    return rec


def test_engine_only_server_generates_random_secret(models, monkeypatch):
    monkeypatch.delenv("PADDLE_SERVE_TOKEN", raising=False)
    recs = both(models, sc_random_secret)
    assert recs["torch"] == {"minted": True, "guess_dropped": True,
                             "ping": True}


def sc_legacy_env_token(s):
    srv = s.serve.InferenceServer(None, engine=s.engine(max_slots=1))
    s.servers.append(srv)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    cli = s.serve.RemotePredictor(port=srv.port,
                                  model_prefix="/some/model/path")
    rec = {"generated": srv.generated_secret, "ping": cli.ping()}
    cli.close()
    return rec


def test_legacy_model_prefix_client_with_env_token(models, monkeypatch):
    monkeypatch.setenv("PADDLE_SERVE_TOKEN", "legacy-shared-secret")
    recs = both(models, sc_legacy_env_token)
    assert recs["torch"] == {"generated": None, "ping": True}


def sc_run_op(s):
    srv = s.replica()
    cli = s.client(srv.port)
    rec = _outcome(lambda: cli.run([np.zeros((1, 4), np.float32)]))
    cli.close()
    cli2 = s.client(srv.port)
    rec = (rec, cli2.ping())
    cli2.close()
    return rec


def test_run_op_rejected_on_engine_only_server(models):
    recs = both(models, sc_run_op)
    (kind, cls, text), ping = recs["torch"]
    assert (kind, cls, ping) == ("err", "RuntimeError", True)
    assert "engine-only" in text


def test_model_prefix_refused_naming_a7(models):
    with pytest.raises(NotImplementedError, match="A7"):
        tserve.InferenceServer("/some/saved/model")


# ------------------------------------------------------- TestWireMigration


def _drain_client(s, srv, prompt, n, res, **kw):
    def client():
        cli = s.client(srv.port)
        res["x"] = _outcome(lambda: cli.generate(prompt, max_new_tokens=n,
                                                 **kw))
        cli.close()
    t = threading.Thread(target=client)
    t.start()
    return t


def sc_drain_splices(s, prompt, drop=0, corrupt=0):
    a, b = s.replica(), s.replica()
    peers = [f"127.0.0.1:{b.port}"]
    if drop:
        c = s.replica()
        peers.append(f"127.0.0.1:{c.port}")
    res = {}
    t = _drain_client(s, a, prompt, 16, res)
    with s.faults.scoped("engine.step_delay", times=-1, delay_s=0.01):
        _wait_for(lambda: _mid_decode(a), msg="mid-decode on A")
        for site, n in (("serve.migrate_drop", drop),
                        ("serve.blob_corrupt", corrupt)):
            if n:
                s.faults.arm(site, times=n)
        clean = a.drain(migrate_peers=peers)
    t.join(timeout=60)
    assert not t.is_alive()
    return {"clean": clean, "out": res["x"], "counters": s.delta(),
            "baseline": [_baseline(srv._engine) for srv in s.servers]}


@pytest.mark.parametrize("drop,corrupt", [(0, 0), (1, 0), (0, 1)],
                         ids=["splice", "peer_death_falls_back",
                              "blob_corrupt_reshipped"])
def test_drain_splices_peer_tokens_into_original_future(models, drop,
                                                        corrupt):
    prompt = np.arange(3, 9, dtype=np.int32)
    recs = both(models, sc_drain_splices, prompt=prompt, drop=drop,
                corrupt=corrupt)
    r = recs["torch"]
    assert r["clean"] is True
    assert r["out"] == ("ok", _ref(models, prompt, 16))
    assert r["counters"]["serve.migrations_out"] == 1
    assert r["counters"]["serve.migrate_drops"] == drop
    assert r["counters"]["serve.blob_corrupt_refused"] == corrupt
    assert all(r["baseline"])


def sc_all_peers_dead(s, prompt):
    a = s.replica()
    dead = s.replica()
    dead_port = dead.port
    _stop_server(dead)
    s.servers.remove(dead)
    # refused from here on: the accept loop has left its socket
    dead.accept_thread.join(timeout=5)
    assert not dead.accept_thread.is_alive()
    res = {}
    t = _drain_client(s, a, prompt, 16, res)
    with s.faults.scoped("engine.step_delay", times=-1, delay_s=0.01):
        _wait_for(lambda: _mid_decode(a), msg="mid-decode on A")
        clean = a.drain(deadline_s=10.0,
                        migrate_peers=[f"127.0.0.1:{dead_port}"])
    t.join(timeout=60)
    assert not t.is_alive()
    return {"clean": clean, "out": res["x"], "counters": s.delta(),
            "baseline": _baseline(a._engine)}


def test_all_peers_dead_is_bounded_typed_error(models):
    recs = both(models, sc_all_peers_dead,
                prompt=np.arange(2, 8, dtype=np.int32))
    r = recs["torch"]
    assert r["clean"] is False and r["baseline"]
    assert r["out"][0] == "err" and "migration failed" in r["out"][2]
    assert r["counters"]["serve.migrate_failed"] == 1


def sc_cancel_after_migration(s, prompt, on_victim):
    a, b = s.replica(), s.replica()
    res, drained = {}, {}
    tag = "mig-cancel"
    t = _drain_client(s, a, prompt, 40, res, tag=tag)
    with s.faults.scoped("engine.step_delay", times=-1, delay_s=0.03):
        _wait_for(lambda: _mid_decode(a), msg="mid-decode on A")
        dt = threading.Thread(target=lambda: drained.update(
            ok=a.drain(deadline_s=60.0,
                       migrate_peers=[f"127.0.0.1:{b.port}"])))
        dt.start()
        if not on_victim:
            _wait_for(lambda: b._tags, msg="tag registered on B")
        _wait_for(lambda: b._engine._occupied(),
                  msg="migrated decode running on B")
        ctl = s.client((a if on_victim else b).port)
        hit = ctl.cancel(tag)
        ctl.close()
        dt.join(timeout=60)
        t.join(timeout=60)
    assert not dt.is_alive() and not t.is_alive(), "hung after cancel"
    _wait_for(lambda: not b._engine._has_work(), msg="B quiesce")
    if on_victim:
        _wait_for(lambda: s.delta()["serve.disconnect_cancels"] >= 1,
                  msg="peer disconnect cancel")
    return {"hit": hit, "drained": drained.get("ok"), "out": res["x"][:2],
            "counters": s.delta(),
            "baseline": [_baseline(a._engine), _baseline(b._engine)]}


@pytest.mark.parametrize("on_victim", [False, True],
                         ids=["tag_follows_to_peer", "victim_drops_peer"])
def test_cancel_reaches_a_migrated_request(models, on_victim):
    recs = both(models, sc_cancel_after_migration,
                prompt=np.arange(3, 9, dtype=np.int32), on_victim=on_victim)
    r = recs["torch"]
    assert r["hit"] is True and r["drained"] is True
    assert r["out"] == ("err", "Cancelled")
    assert all(r["baseline"])


def sc_export_window_cancel(s):
    src = s.engine()
    req = src.submit(np.arange(1, 7, dtype=np.int32), 8)
    for _ in range(2):
        src.step()
    src.drain(migrate=True)
    src.step()
    rec = {"engine_miss": not src.cancel(req.request_id)}
    srv = s.serve.InferenceServer(None, engine=src, auth_name=FLEET)
    s.servers.append(srv)
    srv._draining = True
    rec["plain_drain_miss"] = not srv._cancel_request(req.request_id, "x")
    rec["nothing_recorded"] = not srv._mig_cancelled
    srv._migrating = True
    rec["recorded"] = srv._cancel_request(req.request_id,
                                          "client disconnected")
    items = src.take_migrated(timeout=10)
    rec["items"] = len(items)
    rec["clean"] = srv._migrate_items(items, ["127.0.0.1:9"],
                                      time.monotonic() + 5.0)
    rec["out"] = _outcome(lambda: req.result(timeout=5.0))
    return rec


def test_cancel_in_export_window_is_recorded_and_honored(models):
    recs = both(models, sc_export_window_cancel)
    assert recs["torch"]["out"] == ("err", "Cancelled",
                                    "client disconnected")
    assert recs["torch"]["clean"] and recs["torch"]["items"] == 1


def sc_migrating_cancel_records(s):
    src = s.engine()
    srv = s.serve.InferenceServer(None, engine=src, auth_name=FLEET)
    s.servers.append(srv)
    req = src.submit(np.arange(1, 7, dtype=np.int32), 8)
    _wait_for(lambda: len(req.generated) >= 1, msg="first decoded token")
    srv._draining = srv._migrating = True
    return {"hit": srv._cancel_request(req.request_id, "gone"),
            "recorded": srv._mig_cancelled.get(req.request_id)}


def test_migrating_cancel_records_even_when_engine_claims_it(models):
    recs = both(models, sc_migrating_cancel_records)
    assert recs["torch"] == {"hit": True, "recorded": "gone"}


# --------------------------------------------------------- TestExactlyOnce


def sc_ack_drop(s, keyed):
    srv = s.replica(max_slots=4)
    p = np.arange(6 if keyed else 4, dtype=np.int32)
    cli = s.serve.RemotePredictor(
        endpoints=[f"127.0.0.1:{srv.port}"], secret=FLEET) if keyed \
        else s.client(srv.port)
    with s.faults.scoped("serve.ack_drop", times=1):
        out = _outcome(lambda: cli.generate(
            p, max_new_tokens=6 if keyed else 2))
    cli.close()
    if not keyed:     # the server side of a dropped ack: the answer ran
        out = out[:2]
    else:
        # both packages' servers count a request after sending its
        # answer: wait for the replayed one's count before reading
        _wait_for(lambda: s.delta(("serve.requests",))["serve.requests"]
                  >= 1, timeout=10, msg="the replayed request's count")
    return {"out": out, "counters": s.delta()}


@pytest.mark.parametrize("keyed", [True, False],
                         ids=["keyed_resubmit_replays", "legacy_keyless"])
def test_ack_drop(models, keyed):
    recs = both(models, sc_ack_drop, keyed=keyed)
    r = recs["torch"]
    if keyed:
        assert r["out"] == ("ok", _ref(models, np.arange(6), 6))
        assert r["counters"]["engine.requests"] == 1
        assert r["counters"]["engine.dedup_replays"] == 1
        assert r["counters"]["router.failovers"] == 1
    else:
        assert r["out"][0] == "err"
        assert r["out"][1] in ("ConnectionError", "ConnectionResetError",
                               "BrokenPipeError", "OSError")


# -------------------------------------------- tracing, knobs, tier roles


def sc_trace_wire(s):
    snap0 = s.metrics.snapshot()
    base = snap0["histograms"].get("serve.e2e_seconds", {}).get("count", 0)
    srv = s.replica(auth_name="trace-test")
    rng = np.random.RandomState(1)
    cli = s.client(srv.port, secret="trace-test")
    out = cli.generate(rng.randint(0, 97, 5).astype(np.int32),
                       max_new_tokens=4)
    stats = cli.stats()
    prom = cli.prometheus()
    err = _outcome(lambda: cli.generate(
        rng.randint(0, 97, 5).astype(np.int32), max_new_tokens=10 ** 6))
    cli.close()
    cli2 = s.client(srv.port, secret="trace-test")
    stats2 = cli2.stats()
    cli2.close()
    return {"shape": list(out.shape),
            "e2e": stats["histograms"]["serve.e2e_seconds"]["count"] - base,
            "prom": [n in prom for n in ("serve_ttft_seconds_count",
                                         "serve_e2e_seconds_count")],
            "err": err, "role": stats["role"],
            "page_size": stats["prefix"]["page_size"],
            "node_keys": sorted(stats["node"]),
            "request_errors": stats2["counters"]["serve.request_errors"]
            - snap0["counters"].get("serve.request_errors", 0)}


def test_trace_threads_through_serve_wire(models):
    recs = both(models, sc_trace_wire)
    r = recs["torch"]
    assert r["shape"] == [9] and r["e2e"] == 1 and all(r["prom"])
    assert r["err"][:2] == ("err", "RuntimeError")
    assert "max_seq_len" in r["err"][2]
    assert r["request_errors"] == 1 and r["role"] == "both"


def sc_knobs(s, prompt):
    srv = s.replica(auth_name="knobs", speculate_k=2)
    cli = s.client(srv.port, secret="knobs")
    outs = [cli.generate(prompt, max_new_tokens=6).tolist()]
    mid = s.delta()
    outs.append(cli.generate(prompt, max_new_tokens=6, cache=False,
                             speculate=False).tolist())
    opted_out = s.delta()
    outs.append(cli.generate(prompt, max_new_tokens=6, cache=True).tolist())
    cli.close()
    return {"outs": outs,
            "hits": [mid["engine.prefix_hit"],
                     opted_out["engine.prefix_hit"],
                     s.delta()["engine.prefix_hit"]],
            "drafted_while_out": opted_out["engine.spec_drafted"]
            - mid["engine.spec_drafted"]}


def test_wire_options_reach_the_engine(models):
    prompt = np.random.RandomState(12).randint(0, 97, 16).astype(np.int32)
    recs = both(models, sc_knobs, prompt=prompt)
    r = recs["torch"]
    assert r["outs"] == [_ref(models, prompt, 6)] * 3
    assert r["hits"][1] == r["hits"][0] and r["hits"][2] == r["hits"][0] + 1
    assert r["drafted_while_out"] == 0


def sc_prefill_role(s):
    pf = s.replica(role="prefill")
    cli = s.client(pf.port)
    out = _outcome(lambda: cli.generate(np.arange(6, dtype=np.int32),
                                        max_new_tokens=2))
    cli.close()
    return out


def test_prefill_role_refuses_decode_work(models):
    recs = both(models, sc_prefill_role)
    assert recs["torch"][:2] == ("err", "RuntimeError")
    assert "prefill-role" in recs["torch"][2]


# ------------------------------------------------------ across the packages

PAIRS = [("jax", "torch"), ("torch", "jax")]


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS,
                         ids=["jax_client_port_server",
                              "port_client_jax_server"])
def test_client_of_one_package_against_server_of_the_other(
        models, client_pkg, server_pkg):
    cs, ss = Side(client_pkg, models), Side(server_pkg, models)
    try:
        srv = ss.replica()
        prompt = np.arange(3, 9, dtype=np.int32)
        cli = cs.client(srv.port)
        assert cli.ping()
        assert cli.generate(prompt, max_new_tokens=6).tolist() \
            == _ref(models, prompt, 6)
        stats = cli.stats()
        assert stats["counters"]["serve.generate_requests"] >= 1
        assert stats["role"] == "both"
        assert "serve_e2e_seconds_count" in cli.prometheus()
        assert cli.cancel("never-seen") is False
        assert set(cli.debug_dump()) == {"node", "events", "metrics"}
        # a typed error crosses as the client package's own class
        res = {}
        t = _drain_client(cs, srv, prompt, 40, res, tag="x-cancel")
        with ss.faults.scoped("engine.step_delay", times=-1, delay_s=0.03):
            _wait_for(lambda: _mid_decode(srv), msg="mid-decode")
            ctl = cs.client(srv.port)
            assert ctl.cancel("x-cancel") is True
            ctl.close()
            t.join(timeout=60)
        assert res["x"][:2] == ("err", "Cancelled")
        assert "CANCEL wire op" in res["x"][2]
        with pytest.raises(cs.errors.Cancelled):
            raise cs.errors.from_wire("Cancelled: CANCEL wire op")
        _wait_for(lambda: not srv._engine._has_work(), msg="quiesce")
        assert _baseline(srv._engine)
        cli.close()
    finally:
        ss.close()


@pytest.mark.parametrize("src_pkg,dst_pkg", PAIRS,
                         ids=["jax_drains_into_port", "port_drains_into_jax"])
def test_drain_into_a_peer_of_the_other_package(models, src_pkg, dst_pkg):
    src, dst = Side(src_pkg, models), Side(dst_pkg, models)
    try:
        a, b = src.replica(), dst.replica()
        prompt = np.arange(3, 9, dtype=np.int32)
        res = {}
        t = _drain_client(src, a, prompt, 16, res)
        with src.faults.scoped("engine.step_delay", times=-1, delay_s=0.01):
            _wait_for(lambda: _mid_decode(a), msg="mid-decode on A")
            assert a.drain(migrate_peers=[f"127.0.0.1:{b.port}"]) is True
        t.join(timeout=60)
        assert res["x"] == ("ok", _ref(models, prompt, 16))
        assert src.delta()["serve.migrations_out"] == 1
        assert dst.delta()["serve.migrations_in"] == 1
        assert _baseline(a._engine) and _baseline(b._engine)
    finally:
        src.close()
        dst.close()


def _prefill_records(serve, port, prompt):
    """OP_PREFILL against a prefill worker: its PTKS1 records."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        sock.sendall(struct.pack("<I", serve.MAGIC) + serve.auth_token(FLEET))
        sock.sendall(struct.pack("<III", serve.MAGIC, serve.OP_PREFILL, 2))
        # cache=0: each run prefills, so two runs give the same records
        serve.send_arrays(sock, [prompt, np.asarray([0], np.int32)])
        magic, status, n = struct.unpack("<III", serve._recv_exact(sock, 12))
        if status != 0:
            raise serve.from_wire(serve._recv_exact(sock, n).decode())
        return [bytes(a) for a in serve.recv_arrays(sock, n)]
    finally:
        sock.close()


def _kv_stream(serve, port, records, n):
    """OP_KV_STREAM of ``records`` to a decode replica: its answer."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        sock.sendall(struct.pack("<I", serve.MAGIC) + serve.auth_token(FLEET))
        sock.sendall(struct.pack("<III", serve.MAGIC, serve.OP_KV_STREAM,
                                 2 + len(records)))
        serve.send_arrays(sock, [np.asarray([n, 1, 1, 0], np.int32),
                                 np.zeros(0, np.uint8)]
                          + [np.frombuffer(r, np.uint8) for r in records])
        magic, status, m = struct.unpack("<III", serve._recv_exact(sock, 12))
        if status != 0:
            raise serve.from_wire(serve._recv_exact(sock, m).decode())
        (out,) = serve.recv_arrays(sock, m)
        return out.tolist()
    finally:
        sock.close()


@pytest.mark.parametrize("pre_pkg,dec_pkg", PAIRS + [("torch", "torch")],
                         ids=["jax_worker_port_decode",
                              "port_worker_jax_decode", "port_to_port"])
def test_prefill_stream_relayed_to_a_decode_replica(models, pre_pkg,
                                                    dec_pkg):
    pre, dec = Side(pre_pkg, models), Side(dec_pkg, models)
    try:
        pf = pre.replica(role="prefill", prefill_chunk_tokens=8)
        dc = dec.replica(role="decode")
        prompt = (np.arange(20) * 5 % 97).astype(np.int32)
        records = _prefill_records(pre.serve, pf.port, prompt)
        other = tserve if pre.jax else jserve
        assert records == _prefill_records(other, pf.port, prompt)
        assert len(records) >= 3
        out = _kv_stream(dec.serve, dc.port, records, 8)
        assert out == _ref(models, prompt, 8, prefill_chunk_tokens=8)
        assert dec.delta()["serve.kv_stream_in"] == 1
        assert pre.delta()["serve.prefill_streams"] == 2
        assert not any(k[0] in ("prefill", "prefill_chunk")
                       for k in dc._engine._programs)
        with pytest.raises(RuntimeError, match="decode-role"):
            _prefill_records(dec.serve, dc.port, prompt)
    finally:
        pre.close()
        dec.close()


def test_auth_digests_equal_and_wrong_secret_dropped(models, monkeypatch):
    monkeypatch.setenv("PADDLE_SERVE_TOKEN", "env-secret")
    for name in ("fleet", "", "ünïcode"):
        assert jserve.auth_token(name) == tserve.auth_token(name)
    assert jserve.auth_token(None) == tserve.auth_token(None)
    for pkg in ("jax", "torch"):
        side = Side(pkg, models)
        try:
            srv = side.replica()
            for serve in (jserve, tserve):
                raw = socket.create_connection(("127.0.0.1", srv.port),
                                               timeout=5)
                raw.sendall(struct.pack("<I", serve.MAGIC)
                            + serve.auth_token("wrong"))
                raw.sendall(struct.pack("<III", serve.MAGIC,
                                        serve.OP_PING, 0))
                raw.settimeout(5)
                try:
                    assert raw.recv(12) == b""
                except ConnectionResetError:
                    pass
                raw.close()
        finally:
            side.close()


WIRE_ARRAYS = {
    "float32": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
    "float64": np.linspace(-1, 1, 5),
    "int32": np.arange(-3, 3, dtype=np.int32),
    "int64": np.arange(4, dtype=np.int64) << 40,
    "uint8": np.arange(250, 256, dtype=np.uint8),
    "bool": np.array([True, False, True]),
    "float16": np.arange(4, dtype=np.float16) / 3,
    "bfloat16": (np.arange(6, dtype=np.float32).reshape(3, 2) / 3)
    .astype(ml_dtypes.bfloat16),
    "int8": np.arange(-4, 4, dtype=np.int8),
    "int16": np.arange(-2, 2, dtype=np.int16),
    "uint16": np.arange(65530, 65536, dtype=np.uint16),
    "uint32": np.arange(3, dtype=np.uint32) + 2 ** 31,
    "uint64": np.arange(3, dtype=np.uint64) + 2 ** 63,
}


def _frame(serve, arrays):
    a, b = socket.socketpair()
    try:
        serve.send_arrays(a, arrays)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        a.close()
        b.close()


def _unframe(serve, raw, n):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        return serve.recv_arrays(b, n)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("dtype", sorted(WIRE_ARRAYS))
def test_wire_frames_byte_equal(dtype):
    arr = WIRE_ARRAYS[dtype]
    raw = _frame(jserve, [arr, arr[None]])
    assert _frame(tserve, [arr, arr[None]]) == raw
    back = _unframe(tserve, raw, 2)
    assert _frame(tserve, back) == raw      # re-framed byte-equal
    if dtype == "bfloat16":
        assert back[0].dtype == torch.bfloat16
        assert np.array_equal(back[0].view(torch.int16).numpy(),
                              arr.view(np.int16))
        # a bf16 tensor of the port frames as the JAX array does
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        assert _frame(tserve, [t, t[None]]) == raw
        assert np.array_equal(_unframe(jserve, raw, 1)[0].view(np.int16),
                              arr.view(np.int16))
    else:
        assert back[0].dtype == arr.dtype and np.array_equal(back[0], arr)


# ---------------------------------------------------------------- the CLI


def _spawn(args, log, env=None):
    """``python -m args`` from the repository root, stdout piped, stderr
    into the file ``log`` (a full pipe would block the server)."""
    env = dict(env or os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    with open(log, "w") as err:
        return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO,
                                env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True)


def _read_line(proc, prefix, timeout=120.0):
    """The first stdout line of ``proc`` starting with ``prefix``; fails
    after ``timeout`` or when the process ends first."""
    box = {}

    def reader():
        for line in proc.stdout:
            if line.startswith(prefix):
                box["line"] = line.strip()
                return
    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout)
    assert "line" in box, (prefix, proc.poll())
    return box["line"]


def test_cli_serves_a_jax_weight_file_and_drains_on_sigterm(models,
                                                            tmp_path):
    jm, _, _ = models
    weights = tmp_path / "gpt.pdparams"
    paddle.save(jm.state_dict(), str(weights))
    spec = dict(TINY, hidden_dropout=0.0, attention_dropout=0.0,
                seq_parallel=False, sp_attention="ring",
                weights=str(weights),
                engine={"page_size": 4, "max_slots": 2, "min_bucket": 8})
    cfg = tmp_path / "g.json"
    cfg.write_text(json.dumps(spec))
    common = ["--gpt-config", str(cfg), "--port", "0", "--auth-name", FLEET,
              "--drain-deadline", "20"]
    procs = {"jax": _spawn(["paddle_tpu.inference.serve", *common],
                           tmp_path / "jax.err"),
             "torch": _spawn(["paddle_tpu_torch.inference.serve", *common,
                              "--device", "cpu"], tmp_path / "torch.err")}
    try:
        ports = {k: int(_read_line(p, "LISTENING").split()[1])
                 for k, p in procs.items()}
        prompts = [np.arange(3, 9, dtype=np.int32),
                   (np.arange(11) * 7 % 97).astype(np.int32)]
        outs = {}
        for k, port in ports.items():
            cli = tserve.RemotePredictor(port=port, secret=FLEET)
            outs[k] = [cli.generate(p, max_new_tokens=8).tolist()
                       for p in prompts]
            cli.close()
        assert outs["torch"] == outs["jax"] \
            == [_ref(models, p, 8) for p in prompts]
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        for k, p in procs.items():
            assert p.wait(timeout=60) == 0, \
                (k, (tmp_path / f"{k}.err").read_text()[-2000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def test_cli_prints_a_token_when_no_secret_is_given(models, tmp_path):
    """No secret: the CLI prints a random ``TOKEN``. It also registers in a
    shared registry directory, where the JAX package's registry sees its
    ``decode:`` lease."""
    spec = dict(TINY, engine={"page_size": 4, "max_slots": 1})
    cfg = tmp_path / "g.json"
    cfg.write_text(json.dumps(spec))
    reg = tmp_path / "registry"
    env = {k: v for k, v in os.environ.items() if k != "PADDLE_SERVE_TOKEN"}
    proc = _spawn(["paddle_tpu_torch.inference.serve", "--gpt-config",
                   str(cfg), "--port", "0", "--device", "cpu",
                   "--registry-dir", str(reg), "--replica-id", "r-port",
                   "--role", "decode"], tmp_path / "torch.err", env)
    try:
        port = int(_read_line(proc, "LISTENING").split()[1])
        secret = _read_line(proc, "TOKEN").split()[1]
        assert len(secret) == 32
        from paddle_tpu.distributed.fleet.elastic import NodeRegistry
        assert NodeRegistry(str(reg)).alive_nodes() \
            == {"decode:r-port": f"127.0.0.1:{port}"}
        cli = tserve.RemotePredictor(port=port, secret=secret)
        assert cli.ping()
        cli.shutdown_server()
        cli.close()
        assert proc.wait(timeout=60) == 0, \
            (tmp_path / "torch.err").read_text()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.parametrize("argv", [
    ["--model", "/m", "--kv-dtype", "int8"],
    ["--model", "/m", "--weight-dtype", "int8"], ["--kv-dtype", "int8"],
    []], ids=["kv_dtype", "weight_dtype", "kv_dtype_alone", "no_config"])
def test_cli_refusals_match(argv, capsys):
    msgs = []
    for serve in (jserve, tserve):
        with pytest.raises(SystemExit) as ei:
            serve.main(argv)
        assert ei.value.code == 2
        msgs.append(capsys.readouterr().err.splitlines()[-1]
                    .split("error: ")[1])
    assert msgs[0] == msgs[1]


def test_cli_refuses_sequence_parallel_config_and_model(tmp_path):
    spec = dict(TINY, seq_parallel=True)
    cfg = tmp_path / "g.json"
    cfg.write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match="A6"):
        tserve.main(["--gpt-config", str(cfg), "--device", "cpu"])
    with pytest.raises(SystemExit):
        tserve.main(["--model", "/some/prefix"])
