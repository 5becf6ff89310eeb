"""Paged KV-cache attention: the serving cache layout and its attention ops
(counterpart of `paddle_tpu/kernels/paged_attention.py`).

Tokens live in fixed-size PAGES,

    k_pages, v_pages : [num_layers, num_pages, page_size, num_heads, head_dim]

and each sequence owns an ordered list of page indices, its row of the page
table padded to ``pages_per_slot``. Token ``t`` of a sequence lives at
``(page_table[t // page_size], t % page_size)``.

`paged_attention` (decode) and `prefill_attention` (one prefill chunk) are
dispatched by `kernels/registry.py` on the tensor's device: the ``plain``
PyTorch versions here for CPU tensors (the math of the JAX reference's XLA
arms), the hand-written CUDA kernels (`kernels/cuda/`) for CUDA tensors.

An int8 pool (``EngineConfig.kv_dtype="int8"``) pairs the int8 pages with
f32 scale pools ``[num_layers, num_pages, page_size, num_heads]``: one scale
per token slot and head, written by the same scatters that write the
values. Decode writes one token per step into a partly filled page, so a
per-page scale would change the dequantization of the page's earlier
tokens; one scale per written cell keeps every write self-contained. Both
ops take the scales as ``k_scale``/``v_scale`` and dequantize right after
the load, before the f32 scores.

Page 0 is RESERVED as the trash page: writes for inactive slots, prompt
padding and positions past a slot's capacity are routed there instead of
being predicated out, so every write is unconditional. Allocators never hand
out page 0.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.quantization.comms import absmax_int8

# the reserved spill target for masked writes, never allocated to a sequence
TRASH_PAGE = 0

# EngineConfig.kv_dtype values -> page storage dtypes; "int8" comes with the
# f32 scale pools
KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

__all__ = ["TRASH_PAGE", "KV_DTYPES", "gather_kv", "quantize_kv",
           "dequantize_window", "gather_scales", "paged_attention",
           "prefill_attention", "token_page_coords", "prompt_page_coords",
           "chunk_page_coords", "verify_page_coords", "export_pages",
           "import_pages"]


def quantize_kv(x):
    """Per-head abs-max int8 of a K or V write ``[..., nh, dh]`` -> (int8
    values ``[..., nh, dh]``, f32 scales ``[..., nh]``), one scale per token
    slot and head."""
    return absmax_int8(x, axis=-1)


def dequantize_window(win, scales):
    """int8 window ``[..., nh, dh]`` and its scales ``[..., nh]`` -> f32."""
    return win.float() * scales[..., None]


def gather_kv(pages, page_table):
    """Materialize one layer's paged K (or V) into per-sequence windows.

    pages      : [num_pages, page_size, nh, dh]
    page_table : [B, pages_per_slot] int32 page indices
    returns    : [B, pages_per_slot * page_size, nh, dh]
    """
    _, ps, nh, dh = pages.shape
    b, maxp = page_table.shape
    return pages[page_table.long()].reshape(b, maxp * ps, nh, dh)


def gather_scales(scales, page_table):
    """[num_pages, page_size, nh] scales -> [B, pages_per_slot * page_size,
    nh] windows, the scale-side twin of :func:`gather_kv`."""
    _, ps, nh = scales.shape
    b, maxp = page_table.shape
    return scales[page_table.long()].reshape(b, maxp * ps, nh)


def _gather_f32(pages, scales, page_table):
    """One layer's K or V windows in f32, dequantized right after the gather
    when the pool is int8 (``scales`` given)."""
    win = gather_kv(pages, page_table).float()
    if scales is not None:
        win = win * gather_scales(scales, page_table)[..., None]
    return win


def _plain_paged_attention(q, k_pages, v_pages, page_table, pos,
                           k_scale=None, v_scale=None):
    """Gather + masked f32 softmax over the slot's whole window: the math of
    the JAX `_xla_paged_attention`. Arguments as :func:`paged_attention`."""
    dh = q.shape[-1]
    scale = 1.0 / (dh ** 0.5)
    k = _gather_f32(k_pages, k_scale, page_table)       # [B, Lmax, nh, dh]
    v = _gather_f32(v_pages, v_scale, page_table)
    lmax = k.shape[1]
    sc = torch.einsum("bhd,blhd->bhl", q.float() * scale, k)
    mask = torch.arange(lmax, device=q.device)[None, :] <= pos[:, None]
    sc = sc.masked_fill(~mask[:, None, :], -1e30)
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("bhl,blhd->bhd", pr, v).to(q.dtype)


def _plain_prefill_attention(q, k_pages, v_pages, page_table, start, valid,
                             k_scale=None, v_scale=None):
    """Gather + absolute-position-masked f32 softmax for one chunk: the math
    of the JAX `_xla_prefill_attention`, with rows ``>= valid`` (chunk
    padding) written as 0 like the kernels write them. Arguments as
    :func:`prefill_attention`."""
    dh = q.shape[-1]
    c = q.shape[1]
    scale = 1.0 / (dh ** 0.5)
    kk = _gather_f32(k_pages, k_scale, page_table[None])
    vv = _gather_f32(v_pages, v_scale, page_table[None])
    lmax = kk.shape[1]
    rows = torch.arange(c, device=q.device)
    pos = start + rows
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk)
    mask = torch.arange(lmax, device=q.device)[None, :] <= pos[:, None]
    sc = sc.masked_fill(~mask[None, None], -1e30)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", pr, vv)
    out = out.masked_fill((rows >= valid)[None, :, None, None], 0.0)
    return out.to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, pos, k_scale=None,
                    v_scale=None):
    """One decode step of attention over paged K/V for B sequences.

    q          : [B, nh, dh] query of the CURRENT token of each sequence
    k_pages    : [num_pages, page_size, nh, dh] (one layer)
    v_pages    : [num_pages, page_size, nh, dh]
    page_table : [B, pages_per_slot] int32
    pos        : [B] int32, position of the current token (already written
                 to the cache); attends over positions 0..pos inclusive
    k_scale/v_scale : [num_pages, page_size, nh] f32 for int8 pools, else
                 None
    returns    : [B, nh, dh] in q.dtype (f32 scores, -1e30 mask, f32 softmax)
    """
    if registry.dispatch("paged_attention", q) == "cuda":
        from paddle_tpu_torch.kernels.cuda import paged_attention as cdec
        if k_scale is not None:
            return cdec.paged_decode_int8(q, k_pages, v_pages, k_scale,
                                          v_scale, page_table, pos)
        return cdec.paged_decode(q, k_pages, v_pages, page_table, pos)
    return _plain_paged_attention(q, k_pages, v_pages, page_table, pos,
                                  k_scale, v_scale)


def prefill_attention(q, k_pages, v_pages, page_table, start, valid,
                      k_scale=None, v_scale=None):
    """One CHUNK of ragged prefill attention for ONE sequence, over the pages
    the chunk's K/V were just written to.

    q          : [1, C, nh, dh] chunk queries
    k_pages    : [num_pages, page_size, nh, dh] (one layer)
    page_table : [pages_per_slot] int32, this sequence's page row
    start      : int, absolute position of the chunk's first token
    valid      : int, true token count in this chunk
    k_scale/v_scale : [num_pages, page_size, nh] f32 for int8 pools, else
                 None
    returns    : [1, C, nh, dh] in q.dtype; rows >= valid are 0
    """
    if registry.dispatch("prefill_attention", q) == "cuda":
        from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre
        if k_scale is not None:
            return cpre.paged_prefill_int8(q[0], k_pages, v_pages, k_scale,
                                           v_scale, page_table, start,
                                           valid)[None]
        return cpre.paged_prefill(q[0], k_pages, v_pages, page_table, start,
                                  valid)[None]
    return _plain_prefill_attention(q, k_pages, v_pages, page_table, start,
                                    valid, k_scale, v_scale)


def token_page_coords(page_table, pos, active, page_size):
    """(page, offset) for writing token ``pos`` of each of B sequences.

    page_table : [B, pages_per_slot] int32; pos : [B] int32; active : [B]
    bool. Inactive slots go to TRASH_PAGE, and so does any position past the
    slot's capacity (``pos >= pages_per_slot * page_size``): a clamped
    overflow would corrupt the LAST page's KV. Returns ([B], [B]) int64.
    """
    maxp = page_table.shape[1]
    idx = torch.div(pos, page_size, rounding_mode="floor")
    page = page_table.gather(1, idx.clamp(0, maxp - 1).long()[:, None])[:, 0]
    page = torch.where(active & (idx < maxp), page, TRASH_PAGE)
    return page.long(), (pos % page_size).long()


def prompt_page_coords(page_table, length, seq_len, page_size):
    """(page, offset) for writing positions 0..seq_len-1 of ONE sequence.

    page_table : [pages_per_slot] int32; length : true prompt length.
    Positions >= length (bucket padding) and positions past the slot's
    capacity go to TRASH_PAGE. Returns ([seq_len], [seq_len]) int64.
    """
    return chunk_page_coords(page_table, 0, length, seq_len, page_size)


def chunk_page_coords(page_table, start, valid, seq_len, page_size):
    """(page, offset) for writing a prefill CHUNK: positions
    ``start .. start+seq_len-1`` of ONE sequence.

    page_table : [pages_per_slot] int32; start : absolute position of the
    chunk's first token; valid : true token count in the chunk. Chunk
    padding (``i >= valid``) and positions past the slot's capacity go to
    TRASH_PAGE. Returns ([seq_len], [seq_len]) int64.
    """
    maxp = page_table.shape[0]
    i = torch.arange(seq_len, device=page_table.device)
    t = start + i
    idx = torch.div(t, page_size, rounding_mode="floor")
    page = torch.where((i < valid) & (idx < maxp),
                       page_table[idx.clamp(0, maxp - 1)], TRASH_PAGE)
    return page.long(), (t % page_size).long()


def verify_page_coords(page_table, pos, valid, page_size):
    """(page, offset) for writing a ``[B, W]`` WINDOW of tokens per sequence,
    the speculative verify step's writes (`models/gpt.py::verify_step`):
    each slot writes its current token and up to W-1 drafted ones.

    page_table : [B, pages_per_slot] int32; pos : [B, W] absolute
    positions; valid : [B, W] bool. Padding drafts, inactive slots and
    positions past the slot's capacity go to TRASH_PAGE (rejected drafts
    leave data only past the rolled-back length, which later steps write
    before any query attends it). Returns ([B, W], [B, W]) int64.
    """
    maxp = page_table.shape[1]
    idx = torch.div(pos, page_size, rounding_mode="floor")
    page = page_table.gather(1, idx.clamp(0, maxp - 1).long())
    page = torch.where(valid & (idx < maxp), page, TRASH_PAGE)
    return page.long(), (pos % page_size).long()


def export_pages(k_pages, v_pages, page_list, k_scales=None, v_scales=None):
    """Gather the listed pages' contents out of the pools in one indexing
    op per pool: the spill side of the KV tiers (`inference/kv_tiers.py`).

    k_pages/v_pages : [num_layers, num_pages, page_size, nh, dh]
    page_list       : [n] page indices, in token order
    k_scales/v_scales : optional [num_layers, num_pages, page_size, nh] f32
                      (int8 pools); the pages' scales travel with their
                      values, so a round trip is bit-exact
    returns         : (k_blob, v_blob) each [num_layers, n, page_size, nh,
                      dh], new tensors on the pools' device, plus
                      (k_s_blob, v_s_blob) when scales were given
    """
    idx = torch.as_tensor(page_list, dtype=torch.long, device=k_pages.device)
    out = (k_pages[:, idx], v_pages[:, idx])
    if k_scales is None:
        return out
    return out + (k_scales[:, idx], v_scales[:, idx])


def import_pages(k_pages, v_pages, k_blob, v_blob, page_list, k_scales=None,
                 v_scales=None, k_s_blob=None, v_s_blob=None):
    """Scatter exported page contents into the pools at ``page_list``, IN
    PLACE (``index_copy_`` on the page dimension), so the pool tensors keep
    their identity as the step functions' writes do. Contents, and the
    scales of int8 pools, land bit-identical.

    k_blob/v_blob : [num_layers, n, page_size, nh, dh] from `export_pages`
                    (any device; moved to the pools')
    page_list     : [n] destination page indices
    returns       : (k_pages, v_pages), plus (k_scales, v_scales) when the
                    scale pools and blobs were given
    """
    dev = k_pages.device
    idx = torch.as_tensor(page_list, dtype=torch.long, device=dev)
    k_pages.index_copy_(1, idx, k_blob.to(dev, k_pages.dtype))
    v_pages.index_copy_(1, idx, v_blob.to(dev, v_pages.dtype))
    if k_scales is None:
        return k_pages, v_pages
    k_scales.index_copy_(1, idx, k_s_blob.to(dev, k_scales.dtype))
    v_scales.index_copy_(1, idx, v_s_blob.to(dev, v_scales.dtype))
    return k_pages, v_pages, k_scales, v_scales
