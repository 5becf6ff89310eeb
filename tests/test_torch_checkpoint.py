"""The port's sharded checkpoints (`paddle_tpu_torch/distributed/
checkpoint.py`) held against the JAX package's
(`paddle_tpu/distributed/checkpoint.py`).

- The same state (float32, bfloat16 and int32 leaves, a uint32 array and
  JSON literals) saved by each package gives byte-equal index files and
  ``.npy`` shards on the synchronous path; on the async path every shard
  file the JAX save writes is byte-equal to the port's (a bfloat16 leaf's
  ``<V2`` words included: the JAX async save then raises at its digest,
  ROADMAP C15).
- Each package loads the other's checkpoints: both paths into the port;
  the synchronous path into JAX; the port's async bfloat16 file is the one
  the JAX loader cannot read (C15).
- A flipped byte, a truncated shard (``ckpt.write_truncate``), a version
  mismatch, a missing index, a missing shard and ``ckpt.crash_between_
  shards`` are refused by both loaders with the same type and text; a
  legacy unstamped index loads in both.
- `shard_owner` and the partitioned save agree across keys and worlds.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jc
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.distributed import checkpoint as tc
from paddle_tpu_torch.testing import faults as tfaults

pytestmark = pytest.mark.chaos

PKG = {"jax": (jc, jfaults), "torch": (tc, tfaults)}


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    jfaults.disarm()
    tfaults.disarm()


def _arrays(seed=3):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 4).astype(np.float32),
            "h": rng.randn(3, 5).astype(np.float32),
            "i": rng.randint(-9, 9, (2, 3)).astype(np.int32),
            "rng": np.array([0, 7], np.uint32)}


def _state(pkg, bf16=True, seed=3):
    """The same nested state in either package's leaves: float32, a
    bfloat16 matrix (of bf16-exact values), int32, a uint32 numpy array
    and literals."""
    a = _arrays(seed)
    h = torch.from_numpy(a["h"]).bfloat16()
    if pkg == "jax":
        leaves = {"w": jnp.asarray(a["w"]), "i": jnp.asarray(a["i"])}
        if bf16:
            leaves["h"] = jnp.asarray(h.float().numpy(), jnp.bfloat16)
    else:
        leaves = {"w": torch.from_numpy(a["w"]),
                  "i": torch.from_numpy(a["i"])}
        if bf16:
            leaves["h"] = h
    return {"params": leaves,
            "meta": {"step": 7, "rng": a["rng"], "name": "run",
                     "cursor": [0, 3]}}


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _save(pkg, state, d, mode):
    mod = PKG[pkg][0]
    if mode == "sync":
        mod.save_sharded(state, d)
    else:
        mod.async_save(state, d).join()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_bytes_equal_without_bf16(tmp_path, mode):
    """float32, int32, uint32 and literals: every file byte-equal."""
    for pkg in PKG:
        _save(pkg, _state(pkg, bf16=False), str(tmp_path / pkg), mode)
    j, t = _files(str(tmp_path / "jax")), _files(str(tmp_path / "torch"))
    assert sorted(j) == sorted(t) and j == t
    idx = json.loads(t["index.p0.json"])
    assert idx["__ckpt_meta__"] == {"version": 2}
    assert idx["meta/cursor"] == {"literal": [0, 3]}


def test_sync_bytes_equal_with_bf16(tmp_path):
    """bfloat16 widened to a float32 ``.npy`` with ``"bfloat16"`` in the
    index, as the JAX synchronous path writes it."""
    for pkg in PKG:
        PKG[pkg][0].save_sharded(_state(pkg), str(tmp_path / pkg))
    j, t = _files(str(tmp_path / "jax")), _files(str(tmp_path / "torch"))
    assert j == t
    entry = json.loads(t["index.json"])["params/h"]
    assert entry["dtype"] == "bfloat16"
    assert np.load(os.path.join(tmp_path / "torch",
                                entry["shards"][0]["file"])).dtype \
        == np.float32


def test_async_bf16_shard_bytes_equal_and_jax_save_fails(tmp_path):
    """The async path writes the host snapshot as it is: the JAX
    ``ml_dtypes`` array as a ``<V2`` ``.npy``, which the port writes
    byte for byte from its raw words. The JAX save then raises at its
    digest (no buffer export for ``ml_dtypes``), before any index: C15."""
    with pytest.raises(ValueError, match="buffer"):
        jc.async_save(_state("jax"), str(tmp_path / "jax")).join()
    tc.async_save(_state("torch"), str(tmp_path / "torch")).join()
    j, t = _files(str(tmp_path / "jax")), _files(str(tmp_path / "torch"))
    assert j and "index.json" not in j
    for f in j:
        assert j[f] == t[f], f
    entry = json.loads(t["index.json"])["params/h"]
    assert entry["dtype"] == "bfloat16"
    assert b"'descr': '<V2'" in t[entry["shards"][0]["file"]]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_port_loads_jax_checkpoints(tmp_path, mode):
    bf16 = mode == "sync"
    d = str(tmp_path / "c")
    _save("jax", _state("jax", bf16=bf16), d, mode)
    want = _state("torch", bf16=bf16)
    got = tc.load_sharded(d)
    for k, v in want["params"].items():
        assert got[f"params/{k}"].dtype == v.dtype
        assert torch.equal(got[f"params/{k}"], v), k
    assert np.array_equal(got["meta/rng"].numpy(), want["meta"]["rng"])
    assert got["meta/step"] == 7 and got["meta/cursor"] == [0, 3]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_jax_loads_port_checkpoints(tmp_path, mode):
    """The JAX loader reads the port's synchronous bfloat16 checkpoint
    and both paths without bfloat16; the port's async bfloat16 file it
    cannot cast (C15), while the port's own loader reads it."""
    for bf16 in (False, True):
        d = str(tmp_path / f"c{int(bf16)}")
        _save("torch", _state("torch", bf16=bf16), d, mode)
        want = _state("jax", bf16=bf16)
        if bf16 and mode == "async":
            with pytest.raises(ValueError, match="sequence"):
                jc.load_sharded(d)
            got = tc.load_sharded(d)
            assert torch.equal(got["params/h"], _state("torch")["params"]["h"])
            continue
        got = jc.load_sharded(d)
        for k, v in want["params"].items():
            g = got[f"params/{k}"]._data
            assert g.dtype == v.dtype
            assert np.array_equal(np.asarray(g, np.float32),
                                  np.asarray(v, np.float32)), k
        assert got["meta/step"] == 7


# ---------------------------------------------------------- the refusals


def _bitflip(d):
    shard = next(f for f in sorted(os.listdir(d))
                 if f.startswith("params_w") and f.endswith(".npy"))
    p = os.path.join(d, shard)
    blob = bytearray(open(p, "rb").read())
    blob[-1] ^= 0xFF
    open(p, "wb").write(bytes(blob))


def _version(d):
    for name in os.listdir(d):
        if name.startswith("index.") and name.endswith(".json"):
            p = os.path.join(d, name)
            idx = json.load(open(p))
            idx["__ckpt_meta__"]["version"] = 99
            json.dump(idx, open(p, "w"))


def _missing_shard(d):
    victim = next(f for f in sorted(os.listdir(d)) if f.endswith(".npy"))
    os.remove(os.path.join(d, victim))


def _no_index(d):
    for name in os.listdir(d):
        if name.startswith("index"):
            os.remove(os.path.join(d, name))


REFUSALS = {"bitflip": (_bitflip, None), "version": (_version, None),
            "missing_shard": (_missing_shard, None),
            "missing_index": (_no_index, None),
            "truncate": (None, "ckpt.write_truncate")}


def _refusal(pkg, d):
    mod = PKG[pkg][0]
    try:
        mod.load_sharded(d)
    except (jc.CheckpointCorrupt, jc.CheckpointIncomplete,
            tc.CheckpointCorrupt, tc.CheckpointIncomplete) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(REFUSALS))
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_same_refusals_and_texts(tmp_path, case, writer):
    """Each broken checkpoint, written by either package, is refused by
    both loaders with the same type and text (the texts name the same
    path); the write-truncate site fires once in the writer."""
    edit, site = REFUSALS[case]
    d = str(tmp_path / "c")
    mod, faults = PKG[writer]
    if site:
        with faults.scoped(site, times=1):
            mod.save_sharded(_state(writer), d)
        assert faults.fired(site) >= 1
    else:
        mod.save_sharded(_state(writer), d)
        edit(d)
    got = {pkg: _refusal(pkg, d) for pkg in PKG}
    assert got["jax"] is not None and got["jax"] == got["torch"], got
    kind = {"bitflip": "CheckpointCorrupt", "version": "CheckpointCorrupt",
            "truncate": "CheckpointCorrupt",
            "missing_shard": "CheckpointIncomplete",
            "missing_index": "CheckpointIncomplete"}[case]
    assert got["torch"][0] == kind


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_crash_between_shards_leaves_no_index(tmp_path, pkg):
    mod, faults = PKG[pkg]
    d = str(tmp_path / "c")
    with faults.scoped("ckpt.crash_between_shards", times=1):
        with pytest.raises(faults.FaultInjected,
                           match="ckpt.crash_between_shards"):
            mod.save_sharded(_state(pkg), d)
    assert not [f for f in os.listdir(d) if f.startswith("index")]
    assert _refusal("jax", d) == _refusal("torch", d) != None  # noqa: E711


def test_legacy_unstamped_checkpoint_loads_in_both(tmp_path):
    d = str(tmp_path / "l")
    tc.save_sharded(_state("torch", bf16=False), d)
    for name in os.listdir(d):
        if name.startswith("index.") and name.endswith(".json"):
            p = os.path.join(d, name)
            idx = json.load(open(p))
            idx.pop("__ckpt_meta__", None)
            for meta in idx.values():
                for e in meta.get("shards", []):
                    e.pop("sum", None)
            json.dump(idx, open(p, "w"))
    a = _arrays()
    for pkg in PKG:
        out = PKG[pkg][0].load_sharded(d, return_numpy=True)
        assert np.array_equal(np.asarray(out["params/w"]), a["w"])
        assert out["meta/step"] == 7


def test_read_literal_equal(tmp_path):
    d = str(tmp_path / "r")
    tc.save_sharded(_state("torch"), d)
    for key in ("meta/step", "meta/cursor", "meta/name", "params/w", "x"):
        assert tc.read_literal(d, key, "dflt") \
            == jc.read_literal(d, key, "dflt")


# ------------------------------------------------------------ partitions


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_shard_owner_equal(world):
    keys = [f"params/blocks/k{i}" for i in range(40)] + [
        "opt/top/gpt.wte.weight/moment1", "meta/rng", "a/b", "a_b"]
    assert [tc.shard_owner(k, world) for k in keys] \
        == [jc.shard_owner(k, world) for k in keys]


def test_partitioned_saves_equal_and_merge(tmp_path):
    """``partition=(rank, world)``: each rank's files equal the JAX
    rank's, and the merged ranks load whole in both packages."""
    for pkg in PKG:
        for r in range(3):
            PKG[pkg][0].save_sharded(_state(pkg), str(tmp_path / pkg),
                                     partition=(r, 3))
    assert _files(str(tmp_path / "jax")) == _files(str(tmp_path / "torch"))
    got = tc.load_sharded(str(tmp_path / "jax"))
    assert torch.equal(got["params/h"], _state("torch")["params"]["h"])
    assert jc.load_sharded(str(tmp_path / "torch"))["meta/step"] == 7
    with pytest.raises(ValueError, match="outside world"):
        tc.save_sharded(_state("torch"), str(tmp_path / "x"),
                        partition=(3, 3))
