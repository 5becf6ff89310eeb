"""Disaggregated serving, reduced to what the port's engine needs so far:
the rolling page-chain hash of a prompt (counterpart of
`paddle_tpu/serving/disagg.py::prompt_page_hashes`).

The hashes are byte-identical to the JAX package's: an engine's prefix
store, its KV tiers and a fleet's prefix directory all key on them, so one
implementation and one seed serve both packages.
"""
from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["prompt_page_hashes"]

_PREFIX_SEED = b"pt-prefix-v1"


def prompt_page_hashes(ids, page_size: int) -> list[bytes]:
    """Rolling hash over a prompt's FULL token pages: ``h_i = H(h_{i-1} |
    page_i tokens)``, blake2b with a 16-byte digest over the int32 token
    bytes. Chained keys mean a page is only reusable when every page before
    it matches too; a trailing partial page gets no hash."""
    ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int32)
    ps = int(page_size)
    out, h = [], _PREFIX_SEED
    for i in range(ids.size // ps):
        h = hashlib.blake2b(h + ids[i * ps:(i + 1) * ps].tobytes(),
                            digest_size=16).digest()
        out.append(h)
    return out
