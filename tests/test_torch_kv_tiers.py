"""The port's KV tiers (`paddle_tpu_torch/inference/kv_tiers.py` and the
engine's spill and re-upload) held against the JAX package's: the store's
``PTKT1`` blobs byte for byte, its LRU bounds, demotion and typed refusals,
and engines with a host or a disk tier against the JAX `DecodeEngine` with
the same tiers on the same trace: tokens EQUAL, only the tail prefilled,
the tier counters equal to the JAX metrics, re-uploaded pages bit-identical
to the pages that were spilled, and every failure a clean cold prefill.
"""
import hashlib

import numpy as np
import pytest
import torch

from paddle_tpu.inference.kv_tiers import KVTierStore as JStore
from paddle_tpu_torch.inference import engine as engine_mod
from paddle_tpu_torch.inference.errors import HandoffCorrupt
from paddle_tpu_torch.inference.kv_tiers import KVTierStore
from paddle_tpu_torch.kernels.paged_attention import export_pages
from tests.test_torch_prefix import (PREFIX_KEYS, TIER_KEYS, _ids,  # noqa: F401
                                     _wave, both, models)

SHAPE = (2, 4, 2, 8)                     # (nl, ps, nh, dh)
KEYS = PREFIX_KEYS + TIER_KEYS


def _store(host=0, disk=0, disk_dir=None, dtype="float32", scales=False):
    return KVTierStore(host_bytes=host, disk_bytes=disk, disk_dir=disk_dir,
                       page_shape=SHAPE, dtype=dtype, scales=scales)


def _page(i, dtype="float32"):
    """A chain hash and one page's (k, v, ks, vs), CPU tensors; int8 pages
    carry f32 scale planes."""
    rng = np.random.RandomState(100 + i)
    h = hashlib.blake2b(b"page-%d" % i, digest_size=16).digest()
    if dtype == "int8":
        k, v = (torch.from_numpy(rng.randint(-127, 128, SHAPE).astype(
            np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.rand(*SHAPE[:3]).astype(np.float32))
                  for _ in range(2))
        return h, k, v, ks, vs
    k, v = (torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
            .to(getattr(torch, dtype)) for _ in range(2))
    return h, k, v, None, None


def _blob_size():
    """One framed f32 page blob's size (fixed-width salt and epoch: every
    blob of one geometry is this long)."""
    h, k, v, _, _ = _page(0)
    return len(_store(host=1 << 20)._pack(h, k, v, None, None))


def _same(a, b):
    return a is None and b is None or torch.equal(a, b)


# ------------------------------------------------------------ the store

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_host_round_trip_bit_for_bit(dtype):
    s = _store(host=1 << 20, dtype=dtype, scales=dtype == "int8")
    h, *page = _page(1, dtype)
    s.put(h, *page)
    for _ in range(2):                   # read-through: a hit keeps the entry
        e = s.get(h)
        assert e is not None and e.tier == "host"
        assert all(_same(a, b) for a, b in zip((e.k, e.v, e.ks, e.vs), page))
        assert e.k.dtype == page[0].dtype
    assert s.hashes() == [h.hex()] and s.host_pages() == 1
    assert s.get(b"\0" * 16) is None and s.counters["kvtier_refusals"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_blob_bytes_equal_the_jax_store(dtype):
    """The same page framed by both stores (salt and epoch made equal) is
    the same bytes, and each store decodes the other's blob."""
    scales = dtype == "int8"
    s = _store(host=1 << 20, dtype=dtype, scales=scales)
    j = JStore(host_bytes=1 << 20, page_shape=SHAPE, dtype=dtype,
               scales=scales)
    j._salt = s._salt
    h, k, v, ks, vs = _page(2, dtype)

    def np_(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            from ml_dtypes import bfloat16
            return t.view(torch.int16).numpy().view(bfloat16)
        return t.numpy()

    blob = s._pack(h, k, v, ks, vs)
    assert blob == j._pack(h, *map(np_, (k, v, ks, vs)))
    back = s._unpack(h, blob)
    assert all(_same(a, b) for a, b in zip(back, (k, v, ks, vs)))
    jk, jv, jks, jvs = j._unpack(h, blob)
    np.testing.assert_array_equal(jk, np_(k))
    np.testing.assert_array_equal(jv, np_(v))


def test_host_overflow_demotes_lru_to_disk(tmp_path):
    sz = _blob_size()
    s = _store(host=2 * sz, disk=1 << 20, disk_dir=str(tmp_path))
    pages = [_page(i) for i in range(1, 4)]
    for h, *p in pages:
        s.put(h, *p)
    assert s.host_pages() == 2 and s.disk_pages() == 1
    e = s.get(pages[0][0])
    assert e is not None and e.tier == "disk"
    assert torch.equal(e.k, pages[0][1])
    assert s.get(pages[1][0]).tier == "host"   # recency: page 3 goes next
    h4, *p4 = _page(4)
    s.put(h4, *p4)
    assert s.get(pages[1][0]).tier == "host"
    assert s.get(pages[2][0]).tier == "disk"
    assert s.counters["kvtier_spills_host"] == 4
    assert s.counters["kvtier_spills_disk"] == 2


def test_disk_overflow_discards_lru_and_unlinks(tmp_path):
    sz = _blob_size()
    s = _store(disk=2 * sz, disk_dir=str(tmp_path))
    pages = [_page(i) for i in range(1, 4)]
    for h, *p in pages:
        s.put(h, *p)
    assert s.host_pages() == 0 and s.disk_pages() == 2
    assert len(list(tmp_path.glob("*.ptkt"))) == 2
    assert s.get(pages[0][0]) is None           # discarded: a plain miss
    assert s.counters["kvtier_refusals"] == 0
    assert s.get(pages[2][0]).tier == "disk"


@pytest.mark.parametrize("fault", ["disk_bit_flip", "host_bit_flip",
                                   "foreign_magic", "truncated"])
def test_corrupt_blob_refuses_typed_and_reads_as_a_miss(tmp_path, fault):
    disk = fault == "disk_bit_flip"
    s = _store(host=0 if disk else 1 << 20, disk=1 << 20 if disk else 0,
               disk_dir=str(tmp_path))
    h, *p = _page(1)
    s.put(h, *p)
    if disk:
        (path,) = tmp_path.glob("*.ptkt")
        raw = bytearray(path.read_bytes())
        raw[-1] ^= 0xFF
        path.write_bytes(bytes(raw))
    else:
        blob = bytearray(s._host[h])
        if fault == "host_bit_flip":
            blob[-1] ^= 0x01
        elif fault == "foreign_magic":
            blob[:6] = b"NOTKV1"
        else:
            blob = blob[:-8]
        with pytest.raises(HandoffCorrupt):
            s._unpack(h, bytes(blob))
        s._host[h] = bytes(blob)
    assert s.get(h) is None
    assert s.counters["kvtier_refusals"] == 1
    assert s.host_pages() == s.disk_pages() == 0
    assert not list(tmp_path.glob("*.ptkt"))


def test_foreign_key_and_store_refuse_typed():
    s1, s2 = _store(host=1 << 20), _store(host=1 << 20)
    h, *p = _page(1)
    blob = s1._pack(h, *p)
    with pytest.raises(HandoffCorrupt, match="key or geometry"):
        s1._unpack(_page(2)[0], blob)
    with pytest.raises(HandoffCorrupt, match="STALE"):
        s2._unpack(h, blob)


def test_flush_empties_tiers_and_stales_earlier_blobs(tmp_path):
    sz = _blob_size()
    s = _store(host=sz, disk=1 << 20, disk_dir=str(tmp_path))
    (h1, *p1), (h2, *p2) = _page(1), _page(2)
    s.put(h1, *p1)
    s.put(h2, *p2)                   # overflows the host tier: h1 on disk
    assert s.host_pages() == 1 and s.disk_pages() == 1
    pre = s._pack(h1, *p1)
    s.flush()
    assert s.host_pages() == s.disk_pages() == 0 and s.hashes() == []
    assert not list(tmp_path.glob("*.ptkt"))
    with pytest.raises(HandoffCorrupt, match="STALE"):
        s._unpack(h1, pre)


def test_store_owns_its_directory(tmp_path):
    (tmp_path / "old.ptkt").write_bytes(b"left over")
    (tmp_path / "keep.txt").write_bytes(b"not ours")
    _store(disk=1 << 20, disk_dir=str(tmp_path))
    assert sorted(f.name for f in tmp_path.iterdir()) == ["keep.txt"]


# ------------------------------------------------------------ the engine

def demote_all(eng):
    """Evict every idle cached page through the store's evict hook (the
    JAX engine's `_shrink_prefix`), so their contents demote to the tiers,
    and return them to the free list."""
    if hasattr(eng, "_shrink_prefix"):
        eng._shrink_prefix()
        return
    idle = eng._evict_prefix_pages(len(eng._prefix_idle))
    if idle:
        eng.allocator.reclaim(idle)


def _tier_dirs(tmp_path):
    return ({"kv_disk_tier_dir": str(tmp_path / "port")},
            {"kv_disk_tier_dir": str(tmp_path / "jax")})


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_tier_hit_equals_jax_and_prefills_only_the_tail(models, tmp_path,
                                                        tier):
    prompt = _ids(0 if tier == "host" else 4, 17)
    if tier == "host":
        kw, jkw = {"kv_host_tier_bytes": 1 << 20}, {}
    else:   # a host bound under one blob: spills land straight on disk
        port_dir, jkw = _tier_dirs(tmp_path)
        kw = dict(port_dir, kv_host_tier_bytes=64,
                  kv_disk_tier_bytes=1 << 20)
    pages_seen = {}

    def scenario(eng):
        out = _wave(eng, [(prompt, 8, {})])
        demote_all(eng)
        assert not eng._prefix_pages
        if isinstance(eng, engine_mod.DecodeEngine):
            pages_seen["spilled"] = (eng._tiers.host_pages(),
                                     eng._tiers.disk_pages())
        return out + _wave(eng, [(prompt, 8, {})])

    eng, d = both(models, scenario, keys=KEYS, jax_cfg=jkw, **kw)
    assert pages_seen["spilled"] == ((4, 0) if tier == "host" else (0, 4))
    assert d["prefix_evictions_demoted"] == d["prefix_evictions"] == 4
    assert d["kvtier_hits_" + tier] == d["kvtier_reuploads_" + tier] == 4
    assert d["prefill_tokens"] == 17 + 1          # the second: its tail
    if tier == "disk":
        assert len(list((tmp_path / "port").glob("*.ptkt"))) == 4


def test_int8_chain_split_across_tiers_comes_back_bit_identical(models,
                                                                tmp_path):
    """int8 pools spill values and scale planes; a host bound of one blob
    splits the 4-page chain (newest in host, three demoted to disk). The
    re-uploaded pages equal the exported ones byte for byte."""
    prompt = _ids(5, 17)
    port_dir, jkw = _tier_dirs(tmp_path)
    kw = dict(port_dir, kv_dtype="int8", kv_host_tier_bytes=1000,
              kv_disk_tier_bytes=1 << 20)
    seen = {}

    def scenario(eng):
        out = _wave(eng, [(prompt, 8, {})])
        port = isinstance(eng, engine_mod.DecodeEngine)
        if port:
            pages = list(eng._prefix_pages.values())     # chain order
            seen["before"] = export_pages(eng._kc, eng._vc, pages,
                                          eng._ks, eng._vs)
        demote_all(eng)
        if port:
            seen["tiers"] = (eng._tiers.host_pages(), eng._tiers.disk_pages())
        out += _wave(eng, [(prompt, 8, {})])
        if port:
            pages = list(eng._prefix_pages.values())
            seen["after"] = export_pages(eng._kc, eng._vc, pages,
                                         eng._ks, eng._vs)
        return out

    _, d = both(models, scenario, keys=KEYS, jax_cfg=jkw, **kw)
    assert seen["tiers"] == (1, 3)
    assert d["kvtier_reuploads_host"] == 1 and d["kvtier_reuploads_disk"] == 3
    assert d["prefill_tokens"] == 17 + 1
    assert all(torch.equal(a, b) for a, b in zip(seen["before"],
                                                  seen["after"]))


def test_refresh_params_flushes_every_tier(models, tmp_path):
    prompt = _ids(13, 17)
    port_dir, jkw = _tier_dirs(tmp_path)
    kw = dict(port_dir, kv_host_tier_bytes=2600, kv_disk_tier_bytes=1 << 20)
    jm2, tm2 = models[12]

    def scenario(eng):
        out = _wave(eng, [(prompt, 6, {})])
        demote_all(eng)
        assert eng.tier_hashes()
        eng.refresh_params(jm2 if not isinstance(
            eng, engine_mod.DecodeEngine) else tm2)
        assert eng.tier_hashes() == []
        return out + _wave(eng, [(prompt, 6, {})])

    eng, d = both(models, scenario, keys=KEYS, jax_cfg=jkw, **kw)
    assert eng._tiers.host_pages() == eng._tiers.disk_pages() == 0
    assert not list((tmp_path / "port").glob("*.ptkt"))
    assert d["kvtier_hits_host"] + d["kvtier_hits_disk"] == 0
    assert d["prefill_tokens"] == 2 * 17


@pytest.mark.parametrize("fault", ["spill", "reupload"])
def test_tier_failure_is_a_discard_or_a_cold_prefill(models, monkeypatch,
                                                     caplog, fault):
    """A failed spill (the page gather raising) makes the eviction a plain
    discard; a failed re-upload (the page scatter raising) makes the
    request prefill cold. Both engines give the tokens of a cold run."""
    prompt = _ids(9, 17)

    def broken(*a, **k):
        raise RuntimeError(f"injected {fault} failure")

    def scenario(eng):
        out = _wave(eng, [(prompt, 6, {})])
        if isinstance(eng, engine_mod.DecodeEngine):
            monkeypatch.setattr(engine_mod, fault == "spill" and
                                "export_pages" or "import_pages", broken)
            demote_all(eng)
            out += _wave(eng, [(prompt, 6, {})])
            monkeypatch.undo()
        else:
            from paddle_tpu.testing import faults
            with faults.scoped("kvtier." + fault + "_fail"):
                demote_all(eng)
                out += _wave(eng, [(prompt, 6, {})])
        return out

    eng, d = both(models, scenario, keys=KEYS, kv_host_tier_bytes=1 << 20)
    assert d["kvtier_" + fault + "_fail"] == 1
    assert f"injected {fault} failure" in caplog.text   # with its traceback
    assert d["prefill_tokens"] == 2 * 17          # the second ran cold
    if fault == "spill":
        assert d["prefix_evictions_discarded"] == 4
        assert eng._tiers.host_pages() == 0
    else:
        assert d["kvtier_hits_host"] == 4 and d["kvtier_reuploads_host"] == 0
