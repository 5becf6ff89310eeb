"""The port's liveness board and guarded key-value waits
(`paddle_tpu_torch/distributed/liveness.py`) and its key-value client
over a TCPStore (`distributed/collective.py::StoreKV`), held against the
JAX package's `paddle_tpu/distributed/liveness.py`.

- The scenarios of the JAX `tests/test_train_elastic.py` (silent peer,
  tombstone cascade, startup grace, previous-incarnation files, rebeat,
  the marker protocol of guarded reads, plain reads without a monitor,
  the polling barrier and its cleanup) run in both packages, over the
  JAX tests' dict-backed fake client and over a real TCPStore: the same
  outcomes, error types and texts (ages and dump paths normalized), the
  same counters and heartbeat files.
- `StoreKV` satisfies the fake's method contract, run in-process over a
  real `TCPStore`: write-once keys, recursive directory listings and
  deletes, blocking reads with their own timeout, values past the
  store's message limit, ``wait_at_barrier``.
"""
import datetime
import json
import os
import re
import threading
import time

import pytest
from torch.distributed import TCPStore

from paddle_tpu.distributed import liveness as jlive
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch.distributed import liveness as tlive
from paddle_tpu_torch.distributed.collective import StoreKV
from paddle_tpu_torch.observability import metrics as tmetrics

pytestmark = pytest.mark.chaos

PKG = {"jax": (jlive, jmetrics), "torch": (tlive, tmetrics)}


@pytest.fixture(autouse=True)
def _dump_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_WATCHDOG_DIR", str(tmp_path / "dumps"))
    yield
    jlive.uninstall()
    tlive.uninstall()


class FakeKV:
    """The JAX tests' dict-backed coordination client
    (`tests/test_train_elastic.py::_FakeKV`)."""

    def __init__(self):
        self.kv = {}

    def key_value_set_bytes(self, k, v):
        if k in self.kv:
            raise RuntimeError(f"ALREADY_EXISTS: {k}")
        self.kv[k] = bytes(v)

    def blocking_key_value_get_bytes(self, k, timeout_ms):
        if k in self.kv:
            return self.kv[k]
        raise RuntimeError(f"DEADLINE_EXCEEDED: GetKeyValue({k})")

    def key_value_dir_get(self, prefix):
        return [(k, v.decode()) for k, v in sorted(self.kv.items())
                if k.startswith(prefix.rstrip("/") + "/")]

    def key_value_delete(self, k):
        if k.endswith("/"):
            for kk in [x for x in self.kv if x.startswith(k)]:
                del self.kv[kk]
        else:
            self.kv.pop(k, None)


def _store(world=1):
    return TCPStore("127.0.0.1", 0, world, True,
                    timeout=datetime.timedelta(seconds=30),
                    wait_for_workers=False)


CLIENTS = {"fake": lambda: FakeKV(), "store": lambda: StoreKV(_store(), 2)}


def _norm(text):
    text = re.sub(r"dumped to [^)]*", "dumped to PATH", text)
    return re.sub(r"\d+\.\d+", "N", text)


def _beat(d, rank, step, t=None):
    with open(os.path.join(d, f"hb-{rank}.json"), "w") as f:
        json.dump({"rank": rank, "step": step,
                   "t": time.time() if t is None else t}, f)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the record
        return (type(e).__name__, _norm(str(e)))


def _lost(metrics):
    return metrics.snapshot()["counters"].get("train.peer_lost", 0)


# ------------------------------------------------------------- scenarios


def sc_silent_peer(live, d, client):
    mon = live.LivenessMonitor(d, rank=0, world=3, deadline_s=0.05)
    _beat(d, 1, step=7)
    _beat(d, 2, step=7)
    mon.beat(8)
    out = [_outcome(mon.check)]
    time.sleep(0.12)
    _beat(d, 2, step=8)
    out.append(_outcome(lambda: mon.check(context="unit")))
    out.append(os.path.exists(os.path.join(d, "lost-0.json")))
    return out


def sc_cascade(live, d, client):
    mon = live.LivenessMonitor(d, rank=1, world=3, deadline_s=30.0)
    _beat(d, 0, step=4)
    _beat(d, 2, step=4)
    mon.beat(4)
    out = [_outcome(mon.check)]
    with open(os.path.join(d, "lost-0.json"), "w") as f:
        json.dump({"rank": 0, "silent": [2], "t": time.time()}, f)
    out.append(_outcome(mon.check))
    return out


def sc_grace(live, d, client):
    mon = live.LivenessMonitor(d, rank=0, world=2, deadline_s=0.05,
                               grace_s=30.0)
    mon.beat(0)
    time.sleep(0.12)
    out = [_outcome(mon.check)]
    mon2 = live.LivenessMonitor(d, rank=0, world=2, deadline_s=0.05,
                                grace_s=0.01)
    time.sleep(0.05)
    out.append(_outcome(mon2.check))
    return out


def sc_previous_incarnation(live, d, client):
    with open(os.path.join(d, "hb-1.json"), "w") as f:
        json.dump({"rank": 1, "step": 5, "t": time.time() - 0.05}, f)
    with open(os.path.join(d, "lost-1.json"), "w") as f:
        json.dump({"rank": 1, "silent": [0], "t": time.time() - 0.05}, f)
    time.sleep(0.02)
    mon = live.LivenessMonitor(d, rank=0, world=2, deadline_s=0.01,
                               grace_s=60)
    mon.beat(0)
    out = [_outcome(mon.check)]
    _beat(d, 1, step=0)
    time.sleep(0.05)
    out.append(_outcome(mon.check))
    return out


def sc_rebeat(live, d, client):
    mon = live.LivenessMonitor(d, rank=0, world=2, deadline_s=10.0)
    mon.beat(3)
    t1 = json.load(open(os.path.join(d, "hb-0.json")))["t"]
    time.sleep(0.02)
    mon.rebeat()
    info = json.load(open(os.path.join(d, "hb-0.json")))
    return [info["t"] > t1, info["step"], sorted(info)]


def sc_guarded_get(live, d, client):
    mon = live.LivenessMonitor(d, rank=0, world=2, deadline_s=5.0)
    _beat(d, 1, step=0)
    mon.beat(0)
    live.set_with_marker(client, "data/k1", b"payload")
    out = [_outcome(lambda: live.guarded_get_bytes(client, "data/k1", 1000,
                                                   monitor=mon))]
    t0 = time.time()
    out.append(_outcome(lambda: live.guarded_get_bytes(
        client, "data/k2", 600, monitor=mon)))
    out.append(time.time() - t0 < 10)
    mon_fast = live.LivenessMonitor(d, rank=0, world=2, deadline_s=0.05,
                                    grace_s=0.01)
    mon_fast.last_step = 0
    time.sleep(0.12)
    out.append(_outcome(lambda: live.guarded_get_bytes(
        client, "data/k2", 60_000, monitor=mon_fast))[0])
    out.append(sorted(k for k, _ in client.key_value_dir_get("ptpu_mk/")))
    live.clear_with_marker(client, "data/k1")
    out.append(client.key_value_dir_get("ptpu_mk/data/"))
    return out


def sc_plain_get(live, d, client):
    client.key_value_set_bytes("raw/k", b"v")      # payload WITHOUT marker
    return [_outcome(lambda: bytes(live.guarded_get_bytes(client, "raw/k",
                                                          100)))]


def sc_barrier(live, d, client):
    client.key_value_set_bytes("ptpu_bar/t1/1", b"1")
    out = [_outcome(lambda: live.kv_barrier(client, "t1", rank=0, world=2,
                                            timeout_ms=2000))]
    out.append(sorted(k for k, _ in client.key_value_dir_get("ptpu_bar/t1/")))
    live.kv_barrier_cleanup(client, "t1")
    out.append(client.key_value_dir_get("ptpu_bar/t1/"))
    mon = live.LivenessMonitor(d, rank=0, world=2, deadline_s=0.05)
    mon.beat(0)
    _beat(d, 1, step=0)
    out.append(_outcome(lambda: live.kv_barrier(
        client, "t2", rank=0, world=2, timeout_ms=60_000, monitor=mon))[0])
    out.append(_outcome(lambda: live.kv_barrier(
        client, "t3", rank=0, world=2, timeout_ms=300)))
    out.append(live.is_timeout(TimeoutError("KV read timed out")))
    return out


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_silent_peer, sc_cascade, sc_grace, sc_previous_incarnation,
    sc_rebeat, sc_guarded_get, sc_plain_get, sc_barrier)}


@pytest.mark.parametrize("client", sorted(CLIENTS))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_same_outcomes(tmp_path, name, client):
    """Each scenario in each package over a fresh client: the same
    records (outcomes, texts, files, listings) and the same number of
    ``train.peer_lost`` counts."""
    got = {}
    for pkg, (live, metrics) in PKG.items():
        d = str(tmp_path / pkg / "hb")
        os.makedirs(d)
        lost0 = _lost(metrics)
        got[pkg] = (SCENARIOS[name](live, d, CLIENTS[client]()),
                    _lost(metrics) - lost0)
    assert got["torch"] == got["jax"]
    if name == "silent_peer":
        assert got["torch"][0][1][0] == "PeerLost" and got["torch"][1] == 1


def test_peer_lost_dumps_the_ring(tmp_path):
    d = str(tmp_path / "hb")
    mon = tlive.LivenessMonitor(d, rank=0, world=2, deadline_s=0.01,
                                grace_s=0.01)
    time.sleep(0.05)
    with pytest.raises(tlive.PeerLost, match=r"flight ring dumped to") as e:
        mon.check(context="unit")
    path = str(e.value).split("dumped to ")[1].rstrip(")")
    payload = json.load(open(path))
    assert payload["label"] == "peer_lost_rank0"
    assert payload["silent_peers"] == {"1": "no heartbeat"}


# ------------------------------------------------ StoreKV's contract


def _contract(client):
    """The fake client's observable behaviour, op by op."""
    out = []
    client.key_value_set_bytes("a/b/1", b"x")
    client.key_value_set_bytes("a/b/2", b"yy")
    client.key_value_set_bytes("a/c/d/3", b"z")
    client.key_value_set_bytes("ab/4", b"w")
    out.append(_outcome(lambda: client.key_value_set_bytes("a/b/1", b"q"))[0])
    out.append(bytes(client.blocking_key_value_get_bytes("a/b/2", 1000)))
    out.append(client.key_value_dir_get("a/"))
    out.append(client.key_value_dir_get("a/b"))
    client.key_value_delete("a/b/1")
    out.append(client.key_value_dir_get("a/b/"))
    client.key_value_delete("a/")
    out.append(client.key_value_dir_get("a/"))
    out.append(client.key_value_dir_get("ab/"))
    t0 = time.time()
    err = _outcome(lambda: client.blocking_key_value_get_bytes("a/b/1", 200))
    out.append((err[0] in ("RuntimeError", "TimeoutError"),
                "DEADLINE_EXCEEDED" in err[1]))
    out.append(time.time() - t0 < 5)
    client.key_value_set_bytes("a/b/1", b"again")   # deleted keys reset
    out.append(bytes(client.blocking_key_value_get_bytes("a/b/1", 1000)))
    return out


def test_store_client_matches_the_fake():
    assert _contract(StoreKV(_store(), 2)) == _contract(FakeKV())


def test_store_client_carries_values_past_the_message_limit(tmp_path):
    """The libuv store refuses a message over 8 MiB; the client stores a
    larger value in pieces, renewing an installed monitor's heartbeat
    between them, reads it whole, and a directory delete takes the pieces
    with it."""
    store = _store()
    kv = StoreKV(store, 1)
    blob = os.urandom(3 * StoreKV.CHUNK + 12345)
    mon = tlive.install(tlive.LivenessMonitor(str(tmp_path), 0, 2))
    beats0 = tmetrics.counter("train.heartbeats").value
    kv.key_value_set_bytes("ptpu_ag/0/1", blob)
    assert kv.blocking_key_value_get_bytes("ptpu_ag/0/1", 1000) == blob
    assert tmetrics.counter("train.heartbeats").value - beats0 == 8
    assert json.load(open(tmp_path / "hb-0.json"))["step"] == mon.last_step
    tlive.uninstall()
    assert store.check([f"ptpu_chunk:ptpu_ag/0/1/{i}" for i in range(4)])
    kv.key_value_set_bytes("ptpu_ag/0/d/2", b"x")
    kv.key_value_delete("ptpu_ag/0/")
    assert not store.check(["ptpu_ag/0/1"])
    assert not store.check(["ptpu_chunk:ptpu_ag/0/1/0"])
    # the directory's listings, its own and its subdirectory's, go too
    assert not store.check(["ptpu_dir:ptpu_ag/0/"])
    assert not store.check(["ptpu_dir:ptpu_ag/0/d/"])


def test_store_client_wait_at_barrier():
    store = _store(world=2)
    kvs = [StoreKV(store, 2), StoreKV(TCPStore("127.0.0.1", store.port, 2,
                                               False), 2)]
    done = []
    th = threading.Thread(target=lambda: done.append(
        kvs[1].wait_at_barrier("b1", 5000)))
    th.start()
    kvs[0].wait_at_barrier("b1", 5000)
    th.join(10)
    assert done == [None]
    with pytest.raises(TimeoutError, match="DEADLINE_EXCEEDED"):
        kvs[0].wait_at_barrier("b2", 200)
    assert tlive.is_timeout(TimeoutError("DEADLINE_EXCEEDED: x"))
