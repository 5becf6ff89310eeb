"""Wrappers of the ragged paged-attention PREFILL kernels, the Hopper
counterparts of `paddle_tpu/kernels/pallas/prefill_attention.py::
_prefill_kernel`: `kernels/csrc/paged_prefill.cu` for float pools and
`kernels/csrc/paged_prefill_int8.cu` for int8 pools with f32 scales (the
Pallas kernel's ``quant=True`` arm). Each kernel holds two loops and picks
one by a fixed rule before the launch (:func:`arm`): q in bfloat16 with a
head dim that is a multiple of 16 up to 128 takes the tensor-core loop of
`csrc/paged_prefill_mma.cuh` (``"mma_bf16"``), everything else the
CUDA-core loop of `csrc/paged_prefill.cuh` (``"cuda_core"``: exact f32
products, register-tiled, with each query tile's keys split across
:func:`core_splits` blocks and merged in the same launch). Both take
64-row query tiles (:func:`default_block_q`).

The kernels read ``start`` and ``valid`` from device memory and clamp
them there (``load_chunk_bounds``, `csrc/attention_common.cuh`), so a
captured CUDA graph serves every chunk its upload describes: the engine
passes 0-d int32 views of its packed upload. Host ints are checked on the
host and copied to the card first, for eager callers (tests, kernel
timings); a host 0 is a persistent device zero, which the one-shot
prefill's ``start`` uses. For the same reason the split count comes from
shapes only.

Bound on the H100: the visible pages' K/V bytes over 3.35 TB/s, or at long
chunks the causal products over the peak rate of the dtype (see the
sources' headers). The wrappers take CUDA tensors only and always launch
their kernel; `kernels/paged_attention.py` sends CPU tensors to the plain
version, `_plain_prefill_attention`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.kernels._build import CudaKernel
from paddle_tpu_torch.kernels.cuda import (DTYPE_CODES, check_attention_args,
                                           require_cuda)
from paddle_tpu_torch.kernels.cuda.paged_attention import _sm_count, _tickets

__all__ = ["KERNEL", "KERNEL_INT8", "MMA_BLOCK_Q", "MMA_MAX_PAGES",
           "CORE_BLOCK_Q", "CORE_BLOCKS_PER_SM", "CORE_MAX_SPLITS", "arm",
           "block_visits", "core_keys", "core_splits", "default_block_q",
           "grid", "paged_prefill", "paged_prefill_int8", "split_pages",
           "unit_pages"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# pointers (q, pools[, scales], page_table, out, visits, partials,
# tickets), ints (c, nh, dh, ps, maxp), the device pointers of start and
# valid, ints (block_q, splits, dtype), the stream
_TAIL = [_P, _P] + [_I] * 5 + [_P, _P] + [_I] * 3 + [_P]
KERNEL = CudaKernel("paged_prefill", "paged_prefill", [_P] * 6 + _TAIL)
KERNEL_INT8 = CudaKernel("paged_prefill_int8", "paged_prefill_int8",
                         [_P] * 8 + _TAIL)

MMA_BLOCK_Q = 64     # 4 row groups of 16 (paged_prefill_mma.cuh)
MMA_MAX_PAGES = 16384   # the page-table row the tensor-core loop holds
CORE_BLOCK_Q = 64    # a 16 x 16 thread grid, 4 rows a thread
                     # (paged_prefill.cuh, prefill_core::kBlockQ)
CORE_BLOCKS_PER_SM = 2   # blocks an SM the split count asks for: two fit
                         # at dh 64 (shared memory and registers)
CORE_MAX_SPLITS = 32     # prefill_core::kMaxSplits


def arm(dtype, dh: int) -> str:
    """The loop a call takes, the rule of the C entry points
    (`mma_takes`): ``"mma_bf16"`` (tensor cores) for q in bfloat16 with
    ``dh`` a multiple of 16 up to 128, else ``"cuda_core"``. float32 stays
    on the CUDA cores because the tensor cores would take it only as
    TF32."""
    dh = int(dh)
    if dtype == torch.bfloat16 and 0 < dh <= 128 and dh % 16 == 0:
        return "mma_bf16"
    return "cuda_core"


def block_visits(start, valid, row0, block_q, page_size):
    """Trip count of one query block's page loop, the length-aware stop: a
    block with no row < ``valid`` visits 0 pages; otherwise
    ``ceil((start + last_live_row + 1) / page_size)``."""
    nrows = max(0, min(valid - row0, block_q))
    if nrows == 0:
        return 0
    return (start + row0 + nrows - 1 + page_size) // page_size


def default_block_q(c: int, dtype, dh: int) -> int:
    """Query rows per block. The TPU kernel takes up to 256 rows per grid
    cell because its grid runs in order on one core; on the H100 the tile
    is what one block holds and the grid has to fill 132 SMs. Both loops
    take 64-row tiles: the tensor-core loop gives each of 4 row groups the
    16 rows of one mma tile, each taken by two warps that split every key
    tile in halves; the CUDA-core loop gives each of its 16 x 16 threads 4
    rows against 4 keys of a 64-key tile (2 of a 32-key tile above dh
    128), and splits the keys across blocks where the query tiles alone
    would leave SMs idle (:func:`core_splits`). ``dtype`` and ``dh`` pick
    the arm; the tile is the same."""
    tile = MMA_BLOCK_Q if arm(dtype, dh) == "mma_bf16" else CORE_BLOCK_Q
    return min(int(c), tile)


def core_keys(dh: int) -> int:
    """Keys of one tile of the CUDA-core loop: 64, or 32 above dh 128 so
    that the widest rows still fit two stages of the ring."""
    return 64 if int(dh) <= 128 else 32


def unit_pages(dh: int, page_size: int) -> int:
    """Pages of one split unit of the CUDA-core loop: a key tile's worth
    (``core_keys(dh) // page_size``), or one page when a page holds a tile
    or more, so that no page is split between two blocks."""
    return max(1, core_keys(dh) // int(page_size))


def core_splits(c: int, nh: int, dh: int, pages_per_slot: int,
                page_size: int, sm_count: int) -> int:
    """Blocks each (query tile, head) of the CUDA-core loop splits its keys
    across, from shapes only: enough that the grid asks for about
    CORE_BLOCKS_PER_SM blocks on each of ``sm_count`` SMs, at most
    CORE_MAX_SPLITS, and no more than the slot has units
    (:func:`unit_pages`), so that a tile as deep as the slot gives every
    split work. Never from ``start`` / ``valid``, which lie on the card:
    reading them would synchronise every prefill and break its graph.
    Split s walks units s, s + splits, ... (:func:`split_pages`)."""
    nq = -(-int(c) // CORE_BLOCK_Q)
    units = -(-int(pages_per_slot) // unit_pages(dh, page_size))
    by_card = -(-CORE_BLOCKS_PER_SM * int(sm_count) // (nq * int(nh)))
    return max(1, min(units, by_card, CORE_MAX_SPLITS))


def split_pages(start, valid, row0, block_q, page_size, pages_per_slot,
                dh, splits):
    """The pages each of ``splits`` blocks of one query tile visits on the
    CUDA-core loop, as lists of page indices: the tile's
    :func:`block_visits` pages (clamped to the slot) cut into units of
    :func:`unit_pages`, unit u to split u % splits. The kernel's
    ``visits`` holds each list's length."""
    npages = min(block_visits(start, valid, row0, block_q, page_size),
                 int(pages_per_slot))
    ppt = unit_pages(dh, page_size)
    out = [[] for _ in range(splits)]
    for u in range(-(-npages // ppt)):
        out[u % splits].extend(range(u * ppt, min((u + 1) * ppt, npages)))
    return out


def grid(c: int, nh: int, dtype, dh: int, pages_per_slot: int,
         page_size: int, sm_count: int) -> tuple[int, ...]:
    """The launch grid: (heads, query tiles) on the tensor-core loop, whose
    blockIdx.y 0 takes the last (heaviest) tile; (query tiles, heads,
    splits) on the CUDA-core loop, whose blocks take, in launch order, the
    splits of a (tile, head), then the heads, then the tiles from the last
    back."""
    nq = -(-int(c) // default_block_q(c, dtype, dh))
    if arm(dtype, dh) == "mma_bf16":
        return nh, nq
    return nq, nh, core_splits(c, nh, dh, pages_per_slot, page_size,
                               sm_count)


@functools.lru_cache(maxsize=None)
def _device_zero(device) -> torch.Tensor:
    """One int32 zero on ``device`` for the life of the process: the
    ``start`` of every one-shot prefill. Made eagerly (a captured graph's
    warm-up runs come first); made inside a capture, its zeroing would run
    only at replay."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("prefill_attention: the device zero must exist "
                           "before a graph is captured; run the body "
                           "eagerly first")
    return torch.zeros((), dtype=torch.int32, device=device)


def _check_bounds(op, start, valid, c, cap, device):
    """Refuse what the host can see of ``start`` and ``valid``. A tensor
    must be a 0-d or one-element int32 tensor on ``device``; its value is
    the kernel's to clamp. A host int must lie in range (the two together,
    when both are ints)."""
    for name, x, hi in (("start", start, cap), ("valid", valid, c)):
        if torch.is_tensor(x):
            if x.numel() != 1 or x.dtype != torch.int32 \
                    or x.device != device:
                raise ValueError(
                    f"{op}: {name} must be an int or a one-element int32 "
                    f"tensor on {device}, got {x.dtype} "
                    f"{tuple(x.shape)} on {x.device}")
        elif not 0 <= int(x) <= hi:
            raise ValueError(f"{op}: {name}={x} out of range [0, {hi}] for "
                             f"a chunk of {c} rows and a slot of {cap} "
                             "positions")
    if not (torch.is_tensor(start) or torch.is_tensor(valid)) \
            and int(start) + int(valid) > cap:
        raise ValueError(f"{op}: start={start}, valid={valid} out of range "
                         f"for a slot of {cap} positions")


def _on_device(x, device):
    """A checked ``start`` or ``valid`` as an int32 device scalar: a tensor
    as it is, a host int copied to the card (0 is `_device_zero`). The
    copy serves eager callers and cannot be captured."""
    if torch.is_tensor(x):
        return x
    if int(x) == 0:
        return _device_zero(device)
    return torch.tensor(int(x), dtype=torch.int32, device=device)


def _launch(op, kernel, q, k_pages, v_pages, scales, page_table, start,
            valid, return_visits):
    check_attention_args(op, q, k_pages, v_pages,
                         {"page_table": page_table}, scales)
    c, nh, dh = q.shape
    _, ps, _, _ = k_pages.shape
    maxp = page_table.shape[0]
    if page_table.dim() != 1:
        raise ValueError(f"{op}: page_table must be one row "
                         f"[pages_per_slot], got {tuple(page_table.shape)}")
    _check_bounds(op, start, valid, c, maxp * ps, q.device)
    if arm(q.dtype, dh) == "mma_bf16":
        if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
            raise ValueError(f"{op}: the tensor-core loop copies 16 bytes at "
                             "a time; q and the pools must start on 16-byte "
                             "boundaries")
        if maxp > MMA_MAX_PAGES:
            raise ValueError(f"{op}: the tensor-core loop keeps the slot's "
                             f"page-table row in shared memory, at most "
                             f"{MMA_MAX_PAGES} pages; got {maxp}")
    require_cuda(op, q)
    start, valid = (_on_device(x, q.device) for x in (start, valid))
    bq = default_block_q(c, q.dtype, dh)
    nq = -(-c // bq)
    n, part, tickets = 1, None, None
    if arm(q.dtype, dh) == "cuda_core":
        n = core_splits(c, nh, dh, maxp, ps, _sm_count(q.device.index))
        if n > 1:
            part = torch.empty(nq * nh * n * CORE_BLOCK_Q
                               * (-(-dh // 4) * 4 + 2),
                               dtype=torch.float32, device=q.device)
            stream = torch.cuda.current_stream(q.device).cuda_stream
            tickets = _tickets(q.device, nq * nh, stream,
                               registry.capture_id())
    out = torch.empty_like(q)
    visits = torch.empty((nq, nh, n), dtype=torch.int32, device=q.device) \
        if return_visits else None
    kernel.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  *(s.data_ptr() for s in scales or ()),
                  page_table.data_ptr(), out.data_ptr(),
                  *(None if t is None else t.data_ptr()
                    for t in (visits, part, tickets)),
                  c, nh, dh, ps, maxp, start.data_ptr(), valid.data_ptr(),
                  bq, n,
                  DTYPE_CODES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    if not return_visits:
        return out
    if return_visits == "splits":
        return out, visits
    return out, visits.sum(-1, dtype=torch.int32)


def paged_prefill(q, k_pages, v_pages, page_table, start, valid, *,
                  return_visits=False):
    """One chunk of ragged prefill attention for ONE sequence.

    q [C, nh, dh]; pools [num_pages, page_size, nh, dh] of q's dtype
    (float32 or bfloat16); page_table [pages_per_slot] int32; start, valid
    (absolute position of q[0], true token count) each a host int or a
    one-element int32 tensor on the card, whose value the kernel clamps
    (``valid`` to [0, C], ``start`` to [0, pages_per_slot * page_size]);
    tensors on one CUDA device. Returns [C, nh, dh] in q.dtype with rows >=
    valid set to 0 and, with ``return_visits``, the per-(query block, head)
    trip counts [ceil(C / default_block_q(C, q.dtype, dh)), nh] int32, the
    pages its splits visited summed; with ``return_visits="splits"`` each
    split's count, [..., nh, splits] (one split on the tensor-core loop).
    """
    return _launch("paged_prefill", KERNEL, q, k_pages, v_pages, None,
                   page_table, start, valid, return_visits)


def paged_prefill_int8(q, k_pages, v_pages, k_scale, v_scale, page_table,
                       start, valid, *, return_visits=False):
    """:func:`paged_prefill` over int8 pools: ``k_scale``/``v_scale`` are
    the f32 scale pools [num_pages, page_size, nh], one scale per token
    slot and head; q and the result are float32 or bfloat16."""
    return _launch("paged_prefill_int8", KERNEL_INT8, q, k_pages, v_pages,
                   (k_scale, v_scale), page_table, start, valid,
                   return_visits)
