"""The KV handoff's wire blobs (counterpart of the blob half of
`paddle_tpu/inference/engine.py`): `KVHandoff` (``PTKV1``), `MigrationItem`
with `pack_migration` / `unpack_migration` (``PTMG1``), and the checksummed
header both share. `inference/engine.py` re-exports all of them, where the
JAX package keeps them; they live in a module of their own because
`serving/disagg.py`'s page stream (``PTKS1``) frames its records with the
same header and the engine imports that module.

The bytes are the JAX package's, byte for byte: the same JSON header keys
in the same order, the same blake2b body digest, the same array layouts.
A bfloat16 pool's pages travel as their raw 16-bit words: in this package
a bfloat16 page array is an ``int16`` array of the same bits under the
header dtype name ``"bfloat16"`` (no ``ml_dtypes``), as the KV tiers'
``PTKT1`` blobs carry them (`inference/kv_tiers.py`).
"""
from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass

import numpy as np

from paddle_tpu_torch.inference.errors import HandoffCorrupt

__all__ = ["KVHandoff", "MigrationItem", "MIG_MAGIC", "pack_migration",
           "unpack_migration"]


def _np_cache_dtype(name: str) -> np.dtype:
    """The numpy dtype a pool of header dtype ``name`` travels in: its own,
    and for ``"bfloat16"`` ``int16``, the carrier of its raw words."""
    if name == "bfloat16":
        return np.dtype(np.int16)
    return np.dtype(name)


def _blob_digest(body: bytes) -> str:
    """blake2b content checksum of a wire blob's body: the one digest both
    `KVHandoff` and the ``PTMG1`` migration blob stamp into their headers
    and verify on unpack."""
    return hashlib.blake2b(body, digest_size=16).hexdigest()


def _read_blob_head(buf: bytes, magic_len: int, what: str):
    """Parse a checksummed wire blob's ``u32 header_len | JSON header`` and
    verify the header's ``sum`` digest over the body (everything past the
    header) before any payload byte is interpreted. Returns ``(head,
    body_offset)``. An unparseable header or a digest mismatch (truncation,
    bit flip, torn transfer) raises the typed `HandoffCorrupt` refusal; a
    header without ``sum`` (a blob of a build before the checksum) loads
    unverified."""
    try:
        (hlen,) = struct.unpack("<I", buf[magic_len:magic_len + 4])
        head = json.loads(buf[magic_len + 4:magic_len + 4 + hlen].decode())
        if not isinstance(head, dict):
            raise ValueError(f"header is {type(head).__name__}, not object")
    except (struct.error, ValueError) as e:
        raise HandoffCorrupt(
            f"{what} blob header unparseable ({type(e).__name__}: {e}) — "
            f"truncated or corrupted transfer") from e
    off = magic_len + 4 + hlen
    want = head.get("sum")
    if want is not None:
        got = _blob_digest(buf[off:])
        if got != want:
            raise HandoffCorrupt(
                f"{what} blob failed its content checksum over "
                f"{len(buf) - off} body bytes — truncated or bit-flipped "
                f"transfer, refusing to decode garbage context")
    return head, off


@dataclass
class KVHandoff:
    """A request's paged KV state, detached from any engine.

    `DecodeEngine.prefill_export` makes one (the prompt's KV pages and the
    first token); `DecodeEngine.import_request` or `submit_import` on any
    engine of the same geometry and pool dtype resumes decode from it,
    token for token what a local prefill gives. Only page ids change
    across the transfer; the contents move bit for bit.

    ``pack()`` / ``unpack()`` make and read the wire blob ``b"PTKV1\\n" |
    u32 header_len | JSON header | prompt int32 | k | v [| k_scales |
    v_scales]``. The header carries page_size, dtype, first_token,
    prompt_len and the ``[nl, n_pages, page_size, nh, dh]`` pages shape;
    an int8 pool's blob also the ``[nl, n_pages, page_size, nh]`` scales
    shape, its pages' f32 scales travelling with their values; ``sample``
    for a sampled request; and ``sum``, the body's blake2b digest, which
    `unpack` verifies first (`HandoffCorrupt`)."""
    prompt: np.ndarray          # [S0] int32
    first_token: int            # drawn from the prefill's last logits
    k_pages: np.ndarray         # [nl, n_pages, page_size, nh, dh]
    v_pages: np.ndarray         # (bfloat16: int16 of the same bits)
    page_size: int
    cache_dtype: str            # numpy name of the pool dtype
    k_scales: np.ndarray | None = None   # [nl, n_pages, page_size, nh] f32
    v_scales: np.ndarray | None = None   # (int8 pools only)
    # a sampled request's sampler state: {"temperature": f, "top_k": i,
    # "key": [k0, k1]}, the slot's key chain as advanced so far (two words
    # in [0, 2^32)), so decode on the importing engine continues the same
    # sampled sequence. None: greedy
    sample: dict | None = None

    MAGIC = b"PTKV1\n"

    def pack(self) -> bytes:
        head = {
            "page_size": int(self.page_size), "dtype": self.cache_dtype,
            "first_token": int(self.first_token),
            "prompt_len": int(self.prompt.size),
            "pages_shape": [int(d) for d in self.k_pages.shape]}
        if self.sample is not None:
            head["sample"] = self.sample
        parts = [
            np.ascontiguousarray(self.prompt, np.int32).tobytes(),
            np.ascontiguousarray(self.k_pages).tobytes(),
            np.ascontiguousarray(self.v_pages).tobytes()]
        if self.k_scales is not None:
            head["scales_shape"] = [int(d) for d in self.k_scales.shape]
            parts += [
                np.ascontiguousarray(self.k_scales, np.float32).tobytes(),
                np.ascontiguousarray(self.v_scales, np.float32).tobytes()]
        body = b"".join(parts)
        head["sum"] = _blob_digest(body)
        hb = json.dumps(head).encode()
        return b"".join([self.MAGIC, struct.pack("<I", len(hb)), hb, body])

    @classmethod
    def unpack(cls, buf: bytes) -> "KVHandoff":
        m = len(cls.MAGIC)
        if buf[:m] != cls.MAGIC:
            raise ValueError("not a KV handoff blob (bad magic)")
        head, off = _read_blob_head(buf, m, "KV handoff")
        s0 = int(head["prompt_len"])
        prompt = np.frombuffer(buf, np.int32, count=s0, offset=off).copy()
        off += 4 * s0
        dt = _np_cache_dtype(head["dtype"])
        shape = tuple(head["pages_shape"])
        n = int(np.prod(shape))
        k = np.frombuffer(buf, dt, count=n, offset=off).reshape(shape).copy()
        off += n * dt.itemsize
        v = np.frombuffer(buf, dt, count=n, offset=off).reshape(shape).copy()
        off += n * dt.itemsize
        ks = vs = None
        int8 = head["dtype"] == "int8"
        if int8 != ("scales_shape" in head):
            raise ValueError(
                f"KV handoff blob dtype {head['dtype']!r} "
                f"{'missing its' if int8 else 'carries unexpected'}"
                f" scales section — refusing a silently mis-scaled import")
        if "scales_shape" in head:
            sshape = tuple(head["scales_shape"])
            if sshape != shape[:-1]:
                raise ValueError(
                    f"KV handoff scales shape {sshape} does not match "
                    f"pages shape {shape} — expected {shape[:-1]}")
            ns = int(np.prod(sshape))
            ks = np.frombuffer(buf, np.float32, count=ns,
                               offset=off).reshape(sshape).copy()
            off += ns * 4
            vs = np.frombuffer(buf, np.float32, count=ns,
                               offset=off).reshape(sshape).copy()
        return cls(prompt=prompt, first_token=int(head["first_token"]),
                   k_pages=k, v_pages=v, page_size=int(head["page_size"]),
                   cache_dtype=head["dtype"], k_scales=ks, v_scales=vs,
                   sample=head.get("sample"))


@dataclass
class MigrationItem:
    """One request leaving a draining engine. WARM items (``handoff`` set)
    left mid-decode: the handoff's prompt is the whole resident context
    (the prompt and every delivered token whose KV is in the pool) and its
    first_token the last drawn token, the seed, as `prefill_export`'s.
    COLD items (``prompt`` set) never reached a seeded slot (queued, or
    mid chunked prefill) and re-enter a peer through plain `submit`.

    ``max_new_tokens`` is the peer's budget: for a warm item the seed
    counts as the peer's first token, so it is the original budget less
    the delivered tokens plus one, and the peer's answer (context and its
    tokens) is the uninterrupted run's. ``deadline_ms`` is the deadline's
    remainder at export. ``request`` is the source's own future, which
    never crosses the wire (`pack_migration` drops it). ``tag`` is the
    request's cancel tag on the wire, ``cache`` / ``speculate`` its
    per-request opt-outs, ``request_key`` its idempotency key (the peer
    registers it in its dedup table), ``sample`` a cold sampled item's
    ``{"temperature", "top_k", "seed"}`` (a warm one carries its advanced
    chain in ``handoff.sample``), and ``trace_id`` / ``parent_span`` the
    fleet trace context, hex."""
    max_new_tokens: int
    handoff: KVHandoff | None = None
    prompt: np.ndarray | None = None     # cold items only
    deadline_ms: int | None = None
    request: object | None = None        # the source's GenerateRequest
    tag: bytes | None = None
    cache: bool = True
    speculate: bool = True
    request_key: bytes | None = None
    sample: dict | None = None
    trace_id: str | None = None
    parent_span: str | None = None


MIG_MAGIC = b"PTMG1\n"


def pack_migration(item: MigrationItem) -> bytes:
    """A `MigrationItem` as ``b"PTMG1\\n" | u32 header_len | JSON header |
    body``, the body the ``PTKV1`` blob (warm) or the bare int32 prompt
    (cold). The header's ``sum`` covers the body; a warm item's inner blob
    carries its own checksum too."""
    head = {"max_new_tokens": int(item.max_new_tokens),
            "deadline_ms": 0 if item.deadline_ms is None
            else int(item.deadline_ms),
            "warm": item.handoff is not None}
    if item.tag is not None:
        head["tag"] = bytes(item.tag).hex()
    if item.request_key is not None:
        head["key"] = bytes(item.request_key).hex()
    if not item.cache:
        head["cache"] = False
    if not item.speculate:
        head["speculate"] = False
    if item.sample is not None:
        head["sample"] = item.sample
    if item.trace_id is not None:
        head["trace"] = item.trace_id
    if item.parent_span is not None:
        head["parent"] = item.parent_span
    if item.handoff is None:
        if item.prompt is None:
            raise ValueError("cold migration item has no prompt")
        head["prompt_len"] = int(item.prompt.size)
        body = np.ascontiguousarray(item.prompt, np.int32).tobytes()
    else:
        body = item.handoff.pack()
    head["sum"] = _blob_digest(body)
    hb = json.dumps(head).encode()
    return b"".join([MIG_MAGIC, struct.pack("<I", len(hb)), hb, body])


def unpack_migration(buf: bytes) -> MigrationItem:
    """Wire blob -> `MigrationItem` (``request`` None: the receiving engine
    makes its own future). The header's body checksum is verified first:
    a damaged blob raises `HandoffCorrupt` before any payload is read."""
    m = len(MIG_MAGIC)
    if buf[:m] != MIG_MAGIC:
        raise ValueError("not a migration blob (bad magic)")
    head, off = _read_blob_head(buf, m, "PTMG1 migration")
    common = dict(
        max_new_tokens=int(head["max_new_tokens"]),
        deadline_ms=int(head.get("deadline_ms", 0)) or None,
        tag=bytes.fromhex(head["tag"]) if "tag" in head else None,
        cache=bool(head.get("cache", True)),
        speculate=bool(head.get("speculate", True)),
        request_key=bytes.fromhex(head["key"]) if "key" in head else None,
        sample=head.get("sample"), trace_id=head.get("trace"),
        parent_span=head.get("parent"))
    if head.get("warm"):
        return MigrationItem(handoff=KVHandoff.unpack(buf[off:]), **common)
    s0 = int(head["prompt_len"])
    prompt = np.frombuffer(buf, np.int32, count=s0, offset=off).copy()
    return MigrationItem(prompt=prompt, **common)
