"""Wrappers of the ragged paged-attention DECODE kernels, the Hopper
counterparts of `paddle_tpu/kernels/pallas/paged_attention.py::
_decode_kernel`: `kernels/csrc/paged_decode.cu` for float pools and
`kernels/csrc/paged_decode_int8.cu` for int8 pools with f32 scales (the
Pallas kernel's ``quant=True`` arm). Both kernels pick their loop by one
fixed rule before the launch (:func:`arm`): a head dim that is a multiple
of 16 up to 256 takes `csrc/paged_decode_split.cuh` (``"split"``: each
row's pages split across :func:`splits` blocks, merged in the same launch
by the last block to finish), other head dims the per-(b, h) loop of
`csrc/paged_decode.cuh` (``"per_head"``).

Bound on the H100: the live pages' K/V bytes over 3.35 TB/s (see the
sources' headers for the design against it). The wrappers take CUDA
tensors only and always launch their kernel; `kernels/paged_attention.py`
sends CPU tensors to the plain version, `_plain_paged_attention`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.kernels._build import CudaKernel
from paddle_tpu_torch.kernels.cuda import (DTYPE_CODES, check_attention_args,
                                           require_cuda)

__all__ = ["KERNEL", "KERNEL_INT8", "MAX_SPLITS", "SPLIT_BLOCKS_PER_SM",
           "SPLIT_KEYS", "arm", "grid", "pages_needed", "paged_decode",
           "paged_decode_int8", "splits"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("paged_decode", "paged_decode",
                    [_P] * 9 + [_I] * 7 + [_P])
KERNEL_INT8 = CudaKernel("paged_decode_int8", "paged_decode_int8",
                         [_P] * 11 + [_I] * 7 + [_P])

MAX_SPLITS = 64            # decode_split::kMaxSplits
SPLIT_KEYS = 128           # keys of a split: one 32-key group for each of
                           # its 4 warps (decode_split::kWarps)
SPLIT_BLOCKS_PER_SM = 8    # with many rows, fewer splits: about this many
                           # blocks an SM


def arm(dh: int) -> str:
    """The loop a decode call takes, float or int8 pools alike, the rule of
    the C entry points (`split_takes`): ``"split"`` for a head dim that is
    a multiple of 16 up to 256 (16-byte key loads), else ``"per_head"``."""
    dh = int(dh)
    return "split" if 0 < dh <= 256 and dh % 16 == 0 else "per_head"


def splits(b: int, nh: int, pages_per_slot: int, page_size: int,
           sm_count: int) -> int:
    """Blocks each (b, h) row's pages are split across, from shapes only:
    splits of SPLIT_KEYS keys (each warp of a block walks one group of 32),
    no more than SPLIT_BLOCKS_PER_SM blocks on each of ``sm_count`` SMs ask
    for, at most MAX_SPLITS, and no more than ranges of ceil(pages_per_slot
    / splits) pages need (so no split is empty for every position; split s
    walks pages [s * per, (s + 1) * per), cut at the row's pages_needed).
    Never from the positions, which lie on the card: reading them would
    synchronise every decode step."""
    maxp = int(pages_per_slot)
    by_keys = -(-maxp // -(-SPLIT_KEYS // int(page_size)))
    by_card = -(-SPLIT_BLOCKS_PER_SM * int(sm_count) // (int(b) * int(nh)))
    n = max(1, min(by_keys, by_card, MAX_SPLITS))
    per = -(-maxp // n)
    return -(-maxp // per)


def grid(b: int, nh: int, pages_per_slot: int, page_size: int,
         sm_count: int, dh: int) -> tuple[int, int]:
    """Either kernel's launch grid: (b*nh, splits) on the split loop,
    (b, nh) on the per-(b, h) loop."""
    if arm(dh) == "split":
        return int(b) * int(nh), splits(b, nh, pages_per_slot, page_size,
                                        sm_count)
    return int(b), int(nh)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(device, rows, stream, owner=None):
    """The split loop's tickets for ``rows`` (b, h) pairs on ``device``,
    for the launches on ``stream`` (a CUDA stream handle): zeroed once and
    kept, since every launch leaves them zero again (so a decode call is
    one launch, with no memset). A launch's blocks count on its tickets
    until its last block merges, so launches that share them must run one
    after another: each stream has its own. The float and int8 kernels
    share them, and so do the CUDA-core prefill loop's launches
    (`kernels/cuda/prefill_attention.py`, one ticket a query tile and
    head), since a launch of any of them leaves them zero.

    ``owner``: the `registry.capture_id` of a CUDA graph's warm-up and
    capture runs (`inference/graphs.py`), which take tickets of their own,
    kept for the graph's replays. A graph replays on another stream than
    the one it was captured on, and another engine of the process may be
    warming up its own graphs on that capture stream meanwhile."""
    return _ticket_buffer(device, rows, stream, owner)


@functools.lru_cache(maxsize=None)
def _ticket_buffer(device, rows, stream, owner):
    return torch.zeros(rows, dtype=torch.int32, device=device)


def pages_needed(pos, page_size, pages_per_slot):
    """Trip count of the kernel's page loop for position ``pos``: the
    length-aware stop ``ceil((pos + 1) / page_size)``, clamped to
    ``pages_per_slot`` so a slot at or past its capacity never reads past
    its page-table row (the Pallas kernel has no such clamp)."""
    n = (pos + page_size) // page_size
    if isinstance(n, torch.Tensor):
        return n.clamp(max=pages_per_slot)
    return min(n, pages_per_slot)


def _split_args(op, q, k_pages, v_pages, maxp):
    """(partials, tickets, splits) of a decode call: one split and no
    buffers on the per-(b, h) loop; on the split loop the partials
    (torch.empty, never read before they are written) and the cached
    tickets when there is more than one split."""
    b, nh, dh = q.shape
    if arm(dh) != "split":
        return None, None, 1
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{op}: the split loop reads 16 bytes at a time; the "
                         "pools must start on 16-byte boundaries")
    n = splits(b, nh, maxp, k_pages.shape[1], _sm_count(q.device.index))
    if n == 1:
        return None, None, 1
    part = torch.empty(b * nh * n * (dh + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return part, _tickets(q.device, b * nh, stream,
                          registry.capture_id()), n


def _launch(op, kernel, q, k_pages, v_pages, scales, page_table, pos,
            return_visits):
    check_attention_args(op, q, k_pages, v_pages,
                         {"page_table": page_table, "pos": pos}, scales)
    b, nh, dh = q.shape
    _, ps, _, _ = k_pages.shape
    maxp = page_table.shape[1]
    if tuple(page_table.shape) != (b, maxp) or tuple(pos.shape) != (b,):
        raise ValueError(f"{op}: page_table {tuple(page_table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    require_cuda(op, q)
    out = torch.empty_like(q)
    visits = torch.empty((b, nh), dtype=torch.int32, device=q.device) \
        if return_visits else None
    part, tickets, n = _split_args(op, q, k_pages, v_pages, maxp)
    kernel.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  *(s.data_ptr() for s in scales or ()),
                  page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                  *(None if t is None else t.data_ptr()
                    for t in (visits, part, tickets)),
                  b, nh, dh, ps, maxp, n,
                  DTYPE_CODES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return (out, visits) if return_visits else out


def paged_decode(q, k_pages, v_pages, page_table, pos, *,
                 return_visits=False):
    """One decode token per sequence over paged K/V.

    q [B, nh, dh]; pools [num_pages, page_size, nh, dh] of q's dtype
    (float32 or bfloat16); page_table [B, pages_per_slot] int32; pos [B]
    int32, all on one CUDA device. Returns [B, nh, dh] in q.dtype and, with
    ``return_visits``, the per-(b, h) page-loop trip counts [B, nh] int32.
    """
    return _launch("paged_decode", KERNEL, q, k_pages, v_pages, None,
                   page_table, pos, return_visits)


def paged_decode_int8(q, k_pages, v_pages, k_scale, v_scale, page_table,
                      pos, *, return_visits=False):
    """:func:`paged_decode` over int8 pools: ``k_scale``/``v_scale`` are
    the f32 scale pools [num_pages, page_size, nh], one scale per token
    slot and head; q and the result are float32 or bfloat16."""
    return _launch("paged_decode_int8", KERNEL_INT8, q, k_pages, v_pages,
                   (k_scale, v_scale), page_table, pos, return_visits)
