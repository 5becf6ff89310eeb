"""The port's KV handoff, streamed prefill and live migration
(`paddle_tpu_torch/inference/handoff.py`, `serving/disagg.py`'s page
stream, `DecodeEngine.prefill_export` / `import_request` /
`submit_prefill_stream` / `submit_import` / `drain(migrate=True)` /
`take_migrated`) held against the JAX package's on the same numpy-drawn
weights, at the tiny model of `tests/test_migration.py` (vocab 97, 32
wide, 2 layers, 2 heads, ``page_size=4``, ``max_slots=2``) in float32.

Each scenario of the JAX package's engine-level tests
(`tests/test_migration.py::TestEngineMigration`,
`tests/test_disagg.py::TestStreamFormat` and `TestTokenParity`,
`tests/test_engine.py::TestKVHandoff`) runs once on JAX engines and once
on the port's (``device="cpu"``) and records what it sees: tokens, typed
errors (class and text), the ``engine.*`` counter deltas of each
package's registry, the usage records' fields and free pages. The two
records must be equal, and every migrated or imported request's tokens
equal the uninterrupted engine's. The wire blobs are byte-equal across
the packages when packed from the same arrays (float32, bfloat16 as raw
words, int8 with scales; greedy and sampled), and a blob made by either
engine decodes token for token alike in the other. The serve tier's and
the router's scenarios (`TestWireMigration`, `TestDisaggFleet`, the
cancel-recording of `InferenceServer`) wait for their port.
"""
import ml_dtypes
import numpy as np
import pytest

import paddle_tpu.inference.engine as jeng
import paddle_tpu.inference.errors as jerr
import paddle_tpu.serving.disagg as jdisagg
import paddle_tpu_torch.inference.engine as teng
import paddle_tpu_torch.inference.errors as terr
import paddle_tpu_torch.serving.disagg as tdisagg
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import usage as jusage
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import usage as tusage
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64)
V = TINY["vocab_size"]
COUNTERS = ("requests", "tokens", "steps", "prefill_tokens", "dedup_hits",
            "h2d_transfers", "d2h_transfers", "cancelled",
            "deadline_exceeded", "prefix_hit", "prefix_miss",
            "prefix_pages_reused", "spec_steps", "kv_exports", "kv_imports",
            "kv_stream_exports", "migrations_out", "migrations_in")
USAGE = ("prompt_tokens", "prefill_computed", "prefill_saved", "generated",
         "spec_accepted", "kv_page_steps", "migrations", "imported",
         "error")


def _pair(seed, **cfg):
    """A JAX and a port GPT on the same numpy-drawn weights."""
    cfg = dict(TINY, **cfg)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    rng = np.random.RandomState(seed)
    w = {}
    for k, v in jm.state_dict().items():
        base = 1.0 if k.endswith(("ln_1.weight", "ln_2.weight",
                                  "ln_f.weight")) else 0.0
        w[k] = (base + rng.randn(*v._data.shape) * 0.1).astype(np.float32)
    jm.set_state_dict(w)
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
    tm.set_state_dict(params_from_numpy(w, "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(7)


class Side:
    """One package's half of a scenario: its engines, wire functions,
    errors and reads of its registry and usage log (deltas since the
    scenario began)."""

    def __init__(self, name, models, model=None):
        self.jax = name == "jax"
        self.name = name
        self.eng = jeng if self.jax else teng
        self.disagg = jdisagg if self.jax else tdisagg
        self.errors = jerr if self.jax else terr
        self.metrics = jmetrics if self.jax else tmetrics
        self.usage = (jusage if self.jax else tusage).usage_log
        self.flight = (jfr if self.jax else tfr).flight
        self.model = model or models[0 if self.jax else 1]
        self.c0 = self._counters()
        self.u0 = self.usage.emitted
        evs = self.flight.events()
        self.seq0 = evs[-1]["seq"] if evs else 0

    def engine(self, model=None, **kw):
        cfg = {"page_size": 4, "max_slots": 2, "min_bucket": 8, **kw}
        model = model or self.model
        if self.jax:
            return jeng.DecodeEngine(model, jeng.EngineConfig(**cfg))
        return teng.DecodeEngine(model, teng.EngineConfig(**cfg),
                                 device="cpu")

    def _counters(self):
        snap = self.metrics.snapshot()
        out = {k: snap["counters"].get("engine." + k, 0) for k in COUNTERS}
        out["quant_dequant_ms"] = snap["histograms"].get(
            "engine.quant_dequant_ms", {}).get("count", 0)
        return out

    def delta(self):
        now = self._counters()
        return {k: now[k] - self.c0[k] for k in now}

    def events(self, *fields):
        """The flight recorder's events since the scenario began: each
        one's kind and ``fields``."""
        return [(e["kind"], *(e.get(f) for f in fields))
                for e in self.flight.events() if e["seq"] > self.seq0]

    def usage_records(self):
        n = self.usage.emitted - self.u0
        return [{k: r[k] for k in USAGE} for r in self.usage.last(n)] \
            if n else []


def both(models, scenario):
    """``scenario(side)`` on the JAX package and on the port; their
    records must be equal. Returns the port's record."""
    recs = {name: scenario(Side(name, models)) for name in ("jax", "port")}
    same(recs["port"], recs["jax"])
    return recs["port"]


def same(got, want, path="record"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), \
            (path, got, want)
        for k in want:
            same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


def outcome(req, timeout=30):
    """A finished request's tokens, or its typed error's class and text."""
    try:
        return ("tokens", req.result(timeout=timeout))
    except RuntimeError as e:
        return ("error", type(e).__name__, str(e))


def raised(fn):
    """The class name and text of what ``fn()`` raised, or None."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def free(eng):
    a = eng.allocator
    return a.free_pages, a.num_pages - 1


def run(eng, prompt, n, **kw):
    """``prompt`` served to the end on ``eng`` (the uninterrupted run)."""
    r = eng.submit(prompt, max_new_tokens=n, **kw)
    eng.run_until_idle(max_steps=300)
    return r.result(timeout=30)


def migrate_once(src, n_steps):
    """`tests/test_migration.py::_migrate_once`: ``n_steps`` steps, a
    migrating drain and the step that exports."""
    for _ in range(n_steps):
        src.step()
    src.drain(migrate=True)
    src.step()
    return src.take_migrated(timeout=10)


def resume(dst, item, **kw):
    r = dst.submit_import(item.handoff, max_new_tokens=item.max_new_tokens,
                          **kw)
    dst.run_until_idle(max_steps=300)
    return r.result(timeout=30)


def item_record(item):
    rec = {"warm": item.handoff is not None,
           "max_new_tokens": item.max_new_tokens,
           "cache": item.cache, "speculate": item.speculate,
           "sample": item.sample, "key": item.request_key,
           "deadline": item.deadline_ms is not None}
    if item.handoff is not None:
        h = item.handoff
        rec.update(context=h.prompt, first_token=h.first_token,
                   pages=list(h.k_pages.shape), dtype=h.cache_dtype,
                   scales=h.k_scales is not None, handoff_sample=h.sample)
    else:
        rec["prompt"] = item.prompt
    return rec


def _ids(seed, n):
    return np.random.RandomState(seed).randint(0, V, n).astype(np.int32)


# ------------------------------------------------------- engine migration

def test_mid_decode_export_resumes_token_identical(models):
    """Mid-decode export after 4 steps: the source future stays open, the
    context is prompt + generated[:-1] with the last token as the seed,
    the peer's budget counts the seed, the deadline's remainder and the
    idempotency key ride the item (a resubmit of the key on the peer
    attaches to the imported request), the PTMG1 blob round-trips (cold
    items with their cancel tag), and the peer's tokens are the
    uninterrupted run's."""
    prompt = np.arange(3, 9, dtype=np.int32)
    key = bytes(range(16))

    def scenario(side):
        src, dst = side.engine(), side.engine()
        req = src.submit(prompt, max_new_tokens=12, deadline_s=60.0,
                         request_key=key)
        items = migrate_once(src, 4)
        (item,) = items
        wire = side.eng.unpack_migration(side.eng.pack_migration(item))
        cold = side.eng.MigrationItem(
            max_new_tokens=5, prompt=np.arange(4, dtype=np.int32),
            deadline_ms=1234, tag=b"cancel-me")
        c2 = side.eng.unpack_migration(side.eng.pack_migration(cold))
        r = dst.submit_import(wire.handoff,
                              max_new_tokens=wire.max_new_tokens,
                              request_key=wire.request_key)
        attached = dst.submit(prompt, 12, request_key=key) is r
        dst.run_until_idle(max_steps=300)
        out = r.result(timeout=30)
        rec = {"item": item_record(item), "done": req.done,
               "attached": attached,
               "delivered": list(req.generated),
               "deadline_ok": 0 < item.deadline_ms <= 60_000,
               "wire": item_record(wire), "wire_request": wire.request,
               "wire_tag": wire.tag, "wire_pages_equal": bool(
                   np.array_equal(wire.handoff.k_pages,
                                  item.handoff.k_pages)),
               "cold": (c2.handoff, c2.deadline_ms, c2.tag, c2.prompt),
               "bad_magic": raised(lambda: side.eng.unpack_migration(
                   b"NOPE" + b"\x00" * 16)),
               "src_free": free(src), "out": out}
        rec["dst_free"] = free(dst)
        rec["ref"] = run(dst, prompt, 12)
        rec["counters"] = side.delta()
        rec["usage"] = side.usage_records()
        rec["events"] = side.events("warm", "delivered", "count",
                                    "context_len", "prompt_len")
        return rec

    rec = both(models, scenario)
    np.testing.assert_array_equal(rec["out"], rec["ref"])
    kinds = [e[0] for e in rec["events"]]
    for kind in ("engine.migrate_out", "engine.migrated",
                 "engine.migrate_in", "engine.kv_import"):
        assert kind in kinds, kind
    assert rec["attached"] and rec["item"]["key"] == key
    assert rec["item"]["max_new_tokens"] == 12 - len(rec["delivered"]) + 1
    assert rec["counters"]["migrations_out"] == 1
    assert rec["counters"]["migrations_in"] == 1
    assert rec["usage"][0]["imported"] and rec["usage"][0]["prefill_saved"]


def test_every_migration_step_boundary_is_token_identical(models):
    """Migrating after any number of steps, at readback windows 1, 2 and
    3, resumes on the uninterrupted tokens: the seed/context split holds
    with steps still in flight at the drain. The JAX engine runs the
    boundaries of its own (slow) sweep at its default window, the port
    every boundary at every window."""
    prompt = np.arange(5, 12, dtype=np.int32)

    def sweep(side, steps, windows):
        ref, outs = None, {}
        for w in windows:
            dst = side.engine(inflight=w)
            ref = run(dst, prompt, 10) if ref is None else ref
            for n in steps:
                src = side.engine(inflight=w)
                src.submit(prompt, max_new_tokens=10)
                (item,) = migrate_once(src, n)
                outs[(w, n)] = resume(dst, item)
                assert free(src)[0] == free(src)[1]
        return ref, outs

    jref, jouts = sweep(Side("jax", models), (1, 5), (2,))
    tref, touts = sweep(Side("port", models), (1, 2, 3, 5, 8), (1, 2, 3))
    np.testing.assert_array_equal(tref, jref)
    for k, out in {**jouts, **touts}.items():
        np.testing.assert_array_equal(out, jref, err_msg=str(k))


def test_queued_and_chunk_prefilling_requests_migrate_cold(models):
    """A queued request leaves cold (its prompt, its full budget) and
    re-enters a peer through plain submit; a slot still chunk-prefilling
    leaves cold too; the drained source then refuses `submit_import`
    ("draining"), and a plain drain on the peer still waits its requests
    out."""
    p0 = np.arange(1, 7, dtype=np.int32)
    p1 = np.arange(11, 16, dtype=np.int32)
    long = np.arange(2, 22, dtype=np.int32)          # 5 chunks of 4

    def scenario(side):
        src = side.engine(max_slots=1)
        dst = side.engine(max_slots=2)
        src.submit(p0, max_new_tokens=8)
        q = src.submit(p1, max_new_tokens=8)
        items = migrate_once(src, 2)
        warm = [i for i in items if i.handoff is not None]
        cold = [i for i in items if i.handoff is None]
        rec = {"items": [item_record(i) for i in items],
               "cold_is_queued": cold[0].request is q,
               "src_free": free(src),
               "refused": raised(lambda: src.submit_import(
                   warm[0].handoff, max_new_tokens=warm[0].max_new_tokens))}
        r_cold = dst.submit(cold[0].prompt, cold[0].max_new_tokens)
        r_warm = dst.submit_import(warm[0].handoff,
                                   max_new_tokens=warm[0].max_new_tokens)
        dst.step()
        dst.drain()                      # wait the two out
        dst.run_until_idle(max_steps=300)
        rec.update(cold_out=outcome(r_cold), warm_out=outcome(r_warm),
                   dst_free=free(dst))
        chunked = side.engine(prefill_chunk_tokens=4, max_slots=1)
        chunked.submit(long, max_new_tokens=4)
        chunked.step()
        rec["prefilling"] = bool(chunked._prefilling)
        chunked.drain(migrate=True)
        chunked.step()
        (item,) = chunked.take_migrated(timeout=10)
        rec.update(chunk_item=item_record(item), chunk_free=free(chunked),
                   counters=side.delta(), usage=side.usage_records())
        return rec

    rec = both(models, scenario)
    assert [i["warm"] for i in rec["items"]] == [True, False]
    assert rec["chunk_item"]["warm"] is False
    assert "draining" in rec["refused"][1]


def test_speculating_source_and_sampled_requests_migrate(models):
    """A speculating source (its verify steps harvested at once) and a
    sampling source with greedy and sampled requests mixed: the sampled
    slot's advanced key chain rides the handoff (two words in [0, 2^32),
    equal across the packages), and each peer continues the uninterrupted
    tokens. A sampled handoff into a greedy engine is refused."""
    tiled = np.tile(np.arange(1, 5, dtype=np.int32), 3)
    p_s = _ids(3, 7)

    def scenario(side):
        spec = side.engine(speculate_k=2)
        spec.submit(tiled, max_new_tokens=12)
        (s_item,) = migrate_once(spec, 3)
        dst = side.engine()
        s_out = resume(dst, s_item)
        s_ref = run(dst, tiled, 12)
        src = side.engine(sampling=True)
        src.submit(p_s, max_new_tokens=10, temperature=0.8, top_k=5, seed=3)
        src.submit(tiled, max_new_tokens=10)
        items = migrate_once(src, 3)
        sdst = side.engine(sampling=True)
        outs = [resume(sdst, i) for i in items]
        refs = [run(sdst, p_s, 10, temperature=0.8, top_k=5, seed=3),
                run(sdst, tiled, 10)]
        return {"spec_item": item_record(s_item), "spec_out": s_out,
                "spec_ref": s_ref,
                "items": [item_record(i) for i in items], "outs": outs,
                "refs": refs, "greedy_refuses": raised(
                    lambda: dst.submit_import(
                        items[0].handoff, max_new_tokens=4)),
                "free": [free(e) for e in (spec, dst, src, sdst)],
                "counters": side.delta(), "usage": side.usage_records()}

    rec = both(models, scenario)
    np.testing.assert_array_equal(rec["spec_out"], rec["spec_ref"])
    for out, ref in zip(rec["outs"], rec["refs"]):
        np.testing.assert_array_equal(out, ref)
    key = rec["items"][0]["handoff_sample"]["key"]
    assert len(key) == 2 and all(0 <= w < 2 ** 32 for w in key)
    assert rec["items"][1]["handoff_sample"] is None


def test_int8_kv_migration_and_dtype_mismatch(models):
    """int8 pages travel with their scales and resume on the
    uninterrupted int8 tokens; a float engine refuses the int8 handoff on
    the posting thread ("dtype mismatch")."""
    prompt = np.arange(4, 10, dtype=np.int32)

    def scenario(side):
        src = side.engine(kv_dtype="int8")
        dst = side.engine(kv_dtype="int8")
        f32 = side.engine()
        src.submit(prompt, max_new_tokens=10)
        (item,) = migrate_once(src, 3)
        return {"item": item_record(item),
                "refused": raised(lambda: f32.submit_import(
                    item.handoff, max_new_tokens=item.max_new_tokens)),
                "out": resume(dst, item), "ref": run(dst, prompt, 10),
                "free": [free(src), free(dst)], "counters": side.delta()}

    rec = both(models, scenario)
    np.testing.assert_array_equal(rec["out"], rec["ref"])
    assert rec["item"]["scales"] and "dtype mismatch" in rec["refused"][1]


def test_cache_opt_out_survives_migration(models):
    """``cache=False`` / ``speculate=False`` ride the item and the PTMG1
    header; the peer neither hashes nor registers the context."""
    prompt = np.arange(3, 9, dtype=np.int32)

    def scenario(side):
        src, dst = side.engine(), side.engine()
        src.submit(prompt, max_new_tokens=10, cache=False, speculate=False)
        (item,) = migrate_once(src, 3)
        w2 = side.eng.unpack_migration(side.eng.pack_migration(item))
        r = dst.submit_import(w2.handoff, max_new_tokens=w2.max_new_tokens,
                              cache=w2.cache, speculate=w2.speculate)
        hashed = bool(r.page_hashes)
        dst.run_until_idle(max_steps=300)
        return {"item": item_record(w2), "hashed": hashed,
                "out": outcome(r), "registered": len(dst._prefix_pages),
                "ref": run(side.engine(), prompt, 10),
                "counters": side.delta()}

    rec = both(models, scenario)
    assert not rec["hashed"] and rec["registered"] == 0
    np.testing.assert_array_equal(rec["out"][1], rec["ref"])


def test_abort_finishes_untaken_futures_and_cancel_misses(models):
    """Exported but never taken: an engine cancel misses the request (the
    engine no longer holds it), and abort answers its future with the
    reason; `take_migrated` then returns at once."""
    def scenario(side):
        src = side.engine()
        req = src.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=8)
        src.step()
        src.step()
        src.drain(migrate=True)
        src.step()
        rec = {"done": req.done, "cancel": src.cancel(req.request_id)}
        src.abort("engine stopped: teardown mid-migrate")
        rec.update(out=outcome(req, timeout=1), free=free(src),
                   taken=src.take_migrated(timeout=1),
                   counters=side.delta(), usage=side.usage_records())
        return rec

    rec = both(models, scenario)
    assert rec["out"][0] == "error" and "teardown" in rec["out"][2]


def test_cancel_one_of_two_deferred_imports(models):
    """Two same-shape imports deferred behind a full peer; cancelling one
    in the mailbox ends it typed-Cancelled and the other completes on the
    uninterrupted tokens once the slot frees."""
    pa = np.arange(1, 7, dtype=np.int32)
    pb = np.arange(11, 17, dtype=np.int32)

    def scenario(side):
        src = side.engine()
        src.submit(pa, max_new_tokens=8)
        src.submit(pb, max_new_tokens=8)
        items = migrate_once(src, 2)
        dst = side.engine(max_slots=1)
        occupier = dst.submit(np.arange(30, 34, dtype=np.int32),
                              max_new_tokens=6)
        dst.step()
        r1 = dst.submit_import(items[0].handoff,
                               max_new_tokens=items[0].max_new_tokens)
        r2 = dst.submit_import(items[1].handoff,
                               max_new_tokens=items[1].max_new_tokens)
        rec = {"cancel": dst.cancel(r2.request_id)}
        dst.step()
        rec["r2"] = outcome(r2, timeout=10)
        dst.run_until_idle(max_steps=300)
        rec["reaped"] = [e for e in side.events("where", "error")
                         if e[0] == "engine.reap"]
        rec.update(occupier=outcome(occupier), r1=outcome(r1),
                   ref=run(dst, pa, 8), free=free(dst),
                   counters=side.delta(), usage=side.usage_records())
        return rec

    rec = both(models, scenario)
    assert rec["cancel"] and rec["r2"][1] == "Cancelled"
    np.testing.assert_array_equal(rec["r1"][1], rec["ref"])


# ------------------------------------------------------ PTKS1 page stream

def run_stream(eng, prompt, cache=True):
    """One engine-level prefill-stream job; its records."""
    sink = eng.submit_prefill_stream(prompt, cache=cache)
    eng.step()
    items = []
    while True:
        kind, val = sink.get(timeout=30)
        items.append((kind, val))
        if kind in ("done", "err"):
            break
    assert items[0][0] == "count" and items[-1][0] == "done", items
    recs = [v for k, v in items if k == "rec"]
    assert len(recs) == items[0][1]
    return recs


def assemble(side, records):
    asm = side.disagg.KVStreamAssembler()
    out = None
    for r in records:
        out = asm.feed(r)
    assert out is not None
    return out


def test_stream_format_round_trips_and_refusals(models):
    """A one-shot PTKV1 blob is a complete stream; `stream_records` at
    1, 2 and 7 pages a batch reassembles bit for bit; a bit-flipped or
    truncated record, a record out of order and a stream missing a batch
    are typed HandoffCorrupt refusals (their texts equal); a partial
    stream allocates nothing."""
    prompt = (np.arange(10) % 50).astype(np.int32)

    def scenario(side):
        src, dst = side.engine(), side.engine()
        h = src.prefill_export(prompt)
        got = assemble(side, [h.pack()])
        r = dst.submit_import(got, max_new_tokens=6)
        dst.run_until_idle(max_steps=64)
        rec = {"legacy": outcome(r), "splits": []}
        for ppb in (1, 2, 7):
            g = assemble(side, side.disagg.stream_records(
                h, pages_per_batch=ppb))
            rec["splits"].append(
                (np.array_equal(g.k_pages, h.k_pages),
                 np.array_equal(g.v_pages, h.v_pages),
                 g.first_token == h.first_token,
                 np.array_equal(g.prompt, h.prompt)))
        recs = run_stream(src, prompt)
        baseline = free(dst)
        errs = []

        def refuse(feed):
            try:
                asm = side.disagg.KVStreamAssembler()
                for r in feed:
                    asm.feed(r)
            except side.errors.HandoffCorrupt as e:
                errs.append(str(e))
                return
            errs.append(None)
        bad = bytearray(recs[1])
        bad[-3] ^= 0x40
        refuse([recs[0], bytes(bad)])
        refuse([recs[0], recs[1][:len(recs[1]) // 2]])
        refuse([recs[1]])
        refuse([recs[0]] + recs[2:])
        h2 = assemble(side, recs)
        rec.update(n_records=len(recs), errors=errs,
                   events=[e for e in side.events(
                       "prompt_len", "records", "cached_pages")
                       if e[0] == "engine.prefill_stream"],
                   partial_free=(baseline, free(dst)),
                   stream_equal=(np.array_equal(h2.prompt, h.prompt),
                                 h2.first_token == h.first_token),
                   counters=side.delta())
        return rec

    rec = both(models, scenario)
    assert all(e is not None for e in rec["errors"])
    assert all(all(s) for s in rec["splits"]) and all(rec["stream_equal"])


def test_stream_token_parity_f32_chunked_and_speculative(models):
    """The streamed prefill, from a one-shot and from a chunked worker,
    into a plain and a speculating decode engine: tokens equal the
    uninterrupted engine's, and the decode side never builds a prefill
    program."""
    prompt = (np.arange(13) % 60).astype(np.int32)
    tiled = np.tile((np.arange(6) % 40).astype(np.int32), 2)

    def scenario(side):
        src = side.engine()
        chunked = side.engine(prefill_chunk_tokens=4)
        dst = side.engine()
        spec = side.engine(speculate_k=2)
        rec = {"records": []}
        outs = []
        for s, d, p, n in ((src, dst, prompt, 6), (chunked, dst, prompt, 6),
                           (src, spec, tiled, 8)):
            recs = run_stream(s, p)
            rec["records"].append(len(recs))
            r = d.submit_import(assemble(side, recs), max_new_tokens=n)
            d.run_until_idle(max_steps=300)
            outs.append(r.result(timeout=30))
        rec["prefill_programs"] = [
            [k for k in e._programs if k[0] in ("prefill", "prefill_chunk")]
            for e in (dst, spec)]
        rec.update(outs=outs, refs=[run(src, prompt, 6),
                                    run(src, tiled, 8)],
                   free=[free(e) for e in (src, chunked, dst, spec)],
                   counters=side.delta(), usage=side.usage_records())
        return rec

    rec = both(models, scenario)
    assert rec["prefill_programs"] == [[], []]
    for out, ref in zip(rec["outs"], rec["refs"][:1] * 2 + rec["refs"][1:]):
        np.testing.assert_array_equal(out, ref)
    assert rec["counters"]["kv_stream_exports"] == 3
    assert rec["counters"]["spec_steps"] >= 1


def test_stream_int8_parity_and_prefix_hit(models):
    """int8 pages and scales travel the stream and decode on the
    symmetric int8 tokens (`engine.quant_dequant_ms` observed only by
    `prefill_export`'s int8 gather); a second stream of a prompt sharing
    the first's pages attaches them from the prefix store and exports
    them in one batch without a prefill."""
    prompt = (np.arange(12) % 60).astype(np.int32)
    longer = np.concatenate([prompt, _ids(9, 7)])

    def scenario(side):
        src = side.engine(kv_dtype="int8")
        dst = side.engine(kv_dtype="int8")
        recs = run_stream(src, prompt)
        r = dst.submit_import(assemble(side, recs), max_new_tokens=6)
        dst.run_until_idle(max_steps=300)
        recs2 = run_stream(src, longer)
        r2 = dst.submit_import(assemble(side, recs2), max_new_tokens=6)
        dst.run_until_idle(max_steps=300)
        h = src.prefill_export(prompt)
        return {"n": [len(recs), len(recs2)], "out": outcome(r),
                "out2": outcome(r2), "ref": run(dst, prompt, 6),
                "ref2": run(dst, longer, 6),
                "scales": h.k_scales is not None,
                "free": [free(src), free(dst)], "counters": side.delta()}

    rec = both(models, scenario)
    np.testing.assert_array_equal(rec["out"][1], rec["ref"])
    np.testing.assert_array_equal(rec["out2"][1], rec["ref2"])
    assert rec["counters"]["prefix_hit"] >= 1


# -------------------------------------------------- one-shot KV handoff

def test_handoff_round_trip_and_shared_batch(models):
    """`tests/test_engine.py::TestKVHandoff`: a chunked exporter and a
    plain importer through `pack` / `unpack`; an imported request
    decoding beside a local one in the same step."""
    prompt = _ids(8, 21)
    p_remote, p_local = _ids(9, 9), _ids(10, 6)

    def scenario(side):
        a = side.engine(prefill_chunk_tokens=8)
        b = side.engine()
        h = a.prefill_export(prompt)
        rec = {"a_free": free(a)}
        h2 = side.eng.KVHandoff.unpack(h.pack())
        req = b.import_request(h2, max_new_tokens=12)
        b.run_until_idle(max_steps=100)
        rec["out"] = outcome(req)
        rec["ref"] = run(side.engine(), prompt, 12)
        c = side.engine(max_slots=1)
        h3 = c.prefill_export(p_remote)
        r_local = b.submit(p_local, max_new_tokens=8)
        r_remote = b.import_request(h3, max_new_tokens=8)
        b.run_until_idle(max_steps=100)
        rec.update(remote=outcome(r_remote), local=outcome(r_local),
                   refs=[run(c, p_remote, 8), run(c, p_local, 8)],
                   b_free=free(b), counters=side.delta(),
                   usage=side.usage_records())
        return rec

    rec = both(models, scenario)
    np.testing.assert_array_equal(rec["out"][1], rec["ref"])
    np.testing.assert_array_equal(rec["remote"][1], rec["refs"][0])
    np.testing.assert_array_equal(rec["local"][1], rec["refs"][1])
    assert rec["counters"]["kv_exports"] == 2


def test_handoff_geometry_mismatch_refused(models):
    """Another page size and another head geometry refuse the handoff
    with the JAX engine's texts."""
    other = _pair(8, hidden_size=64, num_heads=4)

    def scenario(side):
        h = side.engine().prefill_export(_ids(10, 9))
        psize = side.engine(page_size=8)
        heads = side.engine(model=other[0 if side.jax else 1])
        return [raised(lambda: psize.import_request(h, max_new_tokens=4)),
                raised(lambda: heads.import_request(h, max_new_tokens=4))]

    rec = both(models, scenario)
    assert "page_size mismatch" in rec[0][1]
    assert "geometry mismatch" in rec[1][1]


# ----------------------------------------------------- across the packages

def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)


def _handoffs(rng):
    """JAX handoffs of each pool dtype, greedy and sampled, and the port
    handoffs of the same arrays (bfloat16 as its raw int16 words)."""
    shape = (2, 3, 4, 2, 16)
    out = []
    for dtype in ("float32", "bfloat16", "int8"):
        if dtype == "bfloat16":
            k, v = _bf16(rng, shape), _bf16(rng, shape)
        elif dtype == "int8":
            k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                    for _ in range(2))
        else:
            k, v = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(2))
        ks = vs = None
        if dtype == "int8":
            ks, vs = (rng.random(shape[:-1]).astype(np.float32)
                      for _ in range(2))
        for sample in (None, {"temperature": 0.8, "top_k": 5,
                              "key": [4294967295, 17]}):
            kw = dict(prompt=rng.integers(0, V, 10).astype(np.int32),
                      first_token=5, page_size=4, cache_dtype=dtype,
                      k_scales=ks, v_scales=vs, sample=sample)
            j = jeng.KVHandoff(k_pages=k, v_pages=v, **kw)
            t = teng.KVHandoff(
                k_pages=k.view(np.int16) if dtype == "bfloat16" else k,
                v_pages=v.view(np.int16) if dtype == "bfloat16" else v,
                **kw)
            out.append((dtype, j, t))
    return out


def test_wire_blobs_byte_equal_across_packages():
    """PTKV1, PTMG1 (warm and cold, every header field) and every PTKS1
    record packed by the port from a JAX handoff's arrays are the JAX
    package's bytes; each package unpacks the other's blobs to the same
    arrays (the port's bfloat16 as int16 words of the same bits)."""
    rng = np.random.default_rng(0)
    for dtype, j, t in _handoffs(rng):
        jb, tb = j.pack(), t.pack()
        assert jb == tb, dtype
        back = teng.KVHandoff.unpack(jb)
        assert back.sample == j.sample and back.cache_dtype == dtype
        np.testing.assert_array_equal(back.k_pages, t.k_pages)
        jback = jeng.KVHandoff.unpack(tb)
        assert jback.k_pages.tobytes() == j.k_pages.tobytes()
        if dtype == "int8":
            np.testing.assert_array_equal(back.v_scales, j.v_scales)
        for ppb in (1, 2):
            jr = jdisagg.stream_records(j, pages_per_batch=ppb)
            tr = tdisagg.stream_records(t, pages_per_batch=ppb)
            assert jr == tr, (dtype, ppb)
            asm = tdisagg.KVStreamAssembler()
            for r in jr:
                got = asm.feed(r)
            assert got.v_pages.tobytes() == j.v_pages.tobytes()
        trace = ("ab" * 16, "cd" * 8)
        assert jdisagg.pack_stream_header(
            0, j.prompt, 4, dtype, [2, 4, 2, 16], 3, 4, dtype == "int8",
            trace_ctx=trace) == tdisagg.pack_stream_header(
            0, t.prompt, 4, dtype, [2, 4, 2, 16], 3, 4, dtype == "int8",
            trace_ctx=trace)
        fields = dict(max_new_tokens=7, deadline_ms=1500, tag=b"t1",
                      cache=False, speculate=False,
                      request_key=bytes(range(16)), trace_id="ab" * 16,
                      parent_span="cd" * 8)
        jm = jeng.pack_migration(jeng.MigrationItem(handoff=j, **fields))
        tm = teng.pack_migration(teng.MigrationItem(handoff=t, **fields))
        assert jm == tm, dtype
        item = teng.unpack_migration(jm)
        same(item_record(item), item_record(jeng.unpack_migration(tm)))
        assert (item.tag, item.trace_id, item.parent_span) == (
            b"t1", "ab" * 16, "cd" * 8)
    cold = dict(max_new_tokens=3, prompt=np.arange(5, dtype=np.int32),
                sample={"temperature": 0.7, "top_k": 0, "seed": 9})
    assert jeng.pack_migration(jeng.MigrationItem(**cold)) == \
        teng.pack_migration(teng.MigrationItem(**cold))


def test_blob_checksum_refusals_match_across_packages():
    """A flipped body byte or a cut blob: the same typed HandoffCorrupt
    refusal text from both packages, for PTKV1 and PTMG1."""
    rng = np.random.default_rng(1)
    _, j, t = _handoffs(rng)[4]
    blobs = [t.pack(), teng.pack_migration(
        teng.MigrationItem(max_new_tokens=3, handoff=t))]
    for blob, junpack, tunpack in zip(
            blobs, (jeng.KVHandoff.unpack, jeng.unpack_migration),
            (teng.KVHandoff.unpack, teng.unpack_migration)):
        bad = bytearray(blob)
        bad[-5] ^= 0x01
        for damaged in (bytes(bad), blob[:len(blob) - 7], blob[:9]):
            texts = []
            for fn, err in ((junpack, jerr.HandoffCorrupt),
                            (tunpack, terr.HandoffCorrupt)):
                with pytest.raises(err) as e:
                    fn(damaged)
                texts.append(str(e.value))
            assert texts[0] == texts[1]


def test_blobs_decode_token_identically_in_the_other_package(models):
    """A PTMG1 blob of a sampled mid-decode request and a PTKV1 blob of a
    one-shot export, made by each package's engine, imported by the
    other's: the tokens are the uninterrupted run's on both sides."""
    p_s, p_g = _ids(3, 7), _ids(4, 9)
    made, refs = {}, {}
    for side in (Side("jax", models), Side("port", models)):
        src = side.engine(sampling=True)
        src.submit(p_s, max_new_tokens=10, temperature=0.8, top_k=5, seed=3)
        (item,) = migrate_once(src, 3)
        made[side.name] = (side.eng.pack_migration(item),
                           side.engine().prefill_export(p_g).pack())
        ref_eng = side.engine(sampling=True)
        refs[side.name] = (run(ref_eng, p_s, 10, temperature=0.8, top_k=5,
                               seed=3), run(ref_eng, p_g, 6))
    same(refs["port"], refs["jax"])
    for side, other in ((Side("jax", models), "port"),
                        (Side("port", models), "jax")):
        mig, one = made[other]
        dst = side.engine(sampling=True)
        item = side.eng.unpack_migration(mig)
        out = resume(dst, item)
        r = dst.import_request(side.eng.KVHandoff.unpack(one),
                               max_new_tokens=6)
        dst.run_until_idle(max_steps=300)
        np.testing.assert_array_equal(out, refs["jax"][0])
        np.testing.assert_array_equal(r.result(timeout=30), refs["jax"][1])


def test_bf16_pages_travel_as_raw_words(models):
    """A bfloat16 port engine (no ml_dtypes in the port): its export's
    pages are int16 words under the dtype name "bfloat16", bit for bit the
    pool's; the JAX package reads the blob as the same bfloat16 values;
    a mid-decode migration and a stream resume on the uninterrupted
    bfloat16 tokens."""
    import copy

    import torch
    tm = copy.deepcopy(models[1]).to(torch.bfloat16)
    side = Side("port", models, model=tm)
    prompt = _ids(11, 10)
    src, dst = side.engine(), side.engine()
    h = src.prefill_export(prompt)
    assert h.cache_dtype == "bfloat16" and h.k_pages.dtype == np.int16
    jh = jeng.KVHandoff.unpack(h.pack())
    assert jh.k_pages.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        jh.k_pages.astype(np.float32),
        torch.from_numpy(h.k_pages).view(torch.bfloat16).float().numpy())
    src.submit(prompt, max_new_tokens=10)
    (item,) = migrate_once(src, 3)
    item = teng.unpack_migration(teng.pack_migration(item))
    out = resume(dst, item)
    r = dst.submit_import(assemble(side, run_stream(side.engine(), prompt)),
                          max_new_tokens=10)
    dst.run_until_idle(max_steps=300)
    ref = run(side.engine(), prompt, 10)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(r.result(timeout=30), ref)
    assert free(src)[0] == free(src)[1] and free(dst)[0] == free(dst)[1]
