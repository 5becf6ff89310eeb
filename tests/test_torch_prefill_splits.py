"""The CUDA-core prefill loop's key splits, held on the CPU.

The split schedule is plain Python in the wrapper
(`paddle_tpu_torch/kernels/cuda/prefill_attention.py`: `core_splits`,
`unit_pages`, `split_pages`), and the kernel
(`kernels/csrc/paged_prefill.cuh`) walks the same units. Here: for a sweep
of chunk shapes, positions, page sizes, slot sizes and SM counts, the
splits of each query tile visit exactly the tile's `block_visits` pages,
each once, and the kernel's own count of a split's pages (mirrored below)
agrees; the split count is a function of shapes only; the grid fills the
card at the prefix-tail shape. `_emulate` repeats the kernel's arithmetic
in numpy (64-row tiles, key tiles of `core_keys`, interleaved units, a row
max a tile, partials merged in split order) and is held against the plain
version within the kernel's f32 tolerance, 2e-5; the kernel itself is held
against the plain version on the card (`tests/test_torch_cuda.py`).
"""
import inspect
import itertools

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre

TOL = 2e-5
BQ = cpre.CORE_BLOCK_Q


def _kernel_split_pages(npages, ppt, splits, s):
    """The kernel's count of split ``s``'s pages (`paged_prefill.cuh`):
    its units times ``ppt``, less the cut of the last unit if it is
    ``s``'s."""
    nunits = -(-npages // ppt)
    mine = (nunits - 1 - s) // splits + 1 if nunits > s else 0
    pages = mine * ppt
    if mine and (nunits - 1) % splits == s:
        pages -= nunits * ppt - npages
    return pages


# (C, start, valid): valid 0 and 1, start mid-page, a full chunk, a short
# tail deep in the slot, and start at the slot's capacity (clamped)
CHUNKS = [(64, 0, 0), (64, 0, 1), (16, 0, 7), (64, 5, 60), (200, 37, 150),
          (256, 496, 100), (64, 768, 50), (128, 0, 128), (64, "cap", 64),
          (96, "cap-40", 40)]


@pytest.mark.parametrize("ps,maxp", [(8, 24), (16, 64), (64, 17), (24, 9),
                                     (128, 5)])
@pytest.mark.parametrize("dh", [64, 256])
def test_split_pages_cover_block_visits_each_once(ps, maxp, dh):
    cap = maxp * ps
    for (c, start, valid), sm in itertools.product(CHUNKS, (8, 132, 1024)):
        if isinstance(start, str):
            start = cap - (int(start[4:]) if "-" in start else 0)
        valid = min(valid, c)
        n = cpre.core_splits(c, 12, dh, maxp, ps, sm)
        assert 1 <= n <= cpre.CORE_MAX_SPLITS
        ppt = cpre.unit_pages(dh, ps)
        for qt in range(-(-c // BQ)):
            row0 = qt * BQ
            want = min(cpre.block_visits(start, valid, row0, BQ, ps), maxp)
            got = cpre.split_pages(start, valid, row0, BQ, ps, maxp, dh, n)
            assert len(got) == n
            flat = [p for pages in got for p in pages]
            assert sorted(flat) == list(range(want)), (c, start, valid, qt)
            assert [len(p) for p in got] == [
                _kernel_split_pages(want, ppt, n, s) for s in range(n)]


def test_split_count_never_reads_start_or_valid():
    params = inspect.signature(cpre.core_splits).parameters
    assert not {"start", "valid"} & set(params)
    # the grid is one for every chunk of a shape, wherever it lies
    grids = {cpre.grid(64, 12, torch.float32, 64, 64, 16, 132)
             for _ in CHUNKS}
    assert len(grids) == 1


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 72),
                                      (torch.bfloat16, 256)])
def test_grid_fills_the_card_at_the_tail_shape(dtype, dh):
    # a prefix hit's tail: C=64 after 768 cached tokens, GPT-2's 12 heads,
    # a slot of 64 pages of 16, 132 SMs: one query tile per head, so only
    # the splits can fill the card
    nq, nh, n = cpre.grid(64, 12, dtype, dh, 64, 16, 132)
    assert (nq, nh) == (1, 12)
    assert nq * nh * n >= 132
    # the tail's 52 pages fill min(splits, units) splits
    used = cpre.split_pages(768, 50, 0, 64, 16, 64, dh, n)
    units = -(-52 // cpre.unit_pages(dh, 16))
    assert sum(1 for pages in used if pages) == min(n, units)


def test_split_count_follows_the_card_and_the_slot():
    # C=1024 at dh 64: 192 (tile, head) blocks already, so 2 splits
    assert cpre.core_splits(1024, 12, 64, 64, 16, 132) == 2
    # never more splits than units in the slot, nor than CORE_MAX_SPLITS
    assert cpre.core_splits(64, 12, 64, 3, 16, 132) == 1
    assert cpre.core_splits(16, 1, 64, 4096, 16, 1024) == \
        cpre.CORE_MAX_SPLITS
    assert cpre.unit_pages(64, 16) == 4 and cpre.unit_pages(256, 16) == 2
    assert cpre.unit_pages(64, 128) == 1


# prefill_core::kMaxSmem: the H100's 227 KB a block, less the kernel's
# static arrays
MAX_SMEM = 232448 - 1024


def _core_smem_bytes(dh, pool_itemsize, quant):
    """Dynamic shared memory of one CUDA-core block, prefill_core::
    core_layout: the Q tile, the P tile, for narrow pools one widened f32
    K/V tile, and the ring of 2 stages (f32 pools) or 3 (int8 and bf16
    pools, 2 where 3 do not fit)."""
    bk = cpre.core_keys(dh)
    ld = -(-dh // 8) * 8 + 4
    f32_pool = pool_itemsize == 4
    rs = 4 * ld if f32_pool else -(-dh * pool_itemsize // 16) * 16
    stage = 2 * bk * rs + (2 * bk * 4 if quant else 0)
    fixed = BQ * ld * 4 + BQ * (bk + 16) * 4
    if not f32_pool:
        fixed += 2 * bk * ld * 4
        if fixed + 3 * stage <= MAX_SMEM:
            return fixed + 3 * stage
    return fixed + 2 * stage


def test_shared_memory_fits_every_head_dim():
    # so the wrapper refuses no head dim that check_attention_args takes
    for dh in range(1, 257):
        for item, quant in ((4, False), (2, False), (1, True)):
            assert _core_smem_bytes(dh, item, quant) <= MAX_SMEM, (dh, item)
    # two blocks an SM at GPT-2's dh 64 in f32 (228 KB an SM, 1 KB each
    # reserved), over float and int8 pools
    for item, quant in ((4, False), (1, True)):
        assert 2 * (_core_smem_bytes(64, item, quant) + 2048) <= 228 * 1024


def _emulate(q, kp, vp, row, start, valid, ks=None, vs=None, sm=132):
    """The CUDA-core loop's arithmetic in numpy f32: returns (out [C, nh,
    dh], visits [tiles, nh, splits])."""
    c, nh, dh = q.shape
    ps, maxp = kp.shape[1], row.shape[0]
    cap = maxp * ps
    start, valid = min(max(start, 0), cap), min(max(valid, 0), c)
    kf = kp.astype(np.float32)
    vf = vp.astype(np.float32)
    if ks is not None:
        kf = kf * ks[..., None]
        vf = vf * vs[..., None]
    bk, ppt = cpre.core_keys(dh), cpre.unit_pages(dh, ps)
    ukeys, n = ppt * ps, cpre.core_splits(c, nh, dh, maxp, ps, sm)
    scale = np.float32(1.0 / np.sqrt(dh))
    nq = -(-c // BQ)
    out = np.zeros_like(q, dtype=np.float32)
    visits = np.zeros((nq, nh, n), np.int32)
    for qt, h in itertools.product(range(nq), range(nh)):
        row0 = qt * BQ
        nrows = max(0, min(valid - row0, BQ))
        if nrows == 0:
            continue
        kv_end = min(start + row0 + nrows, cap)
        npages = -(-kv_end // ps)
        nunits = -(-npages // ppt)
        qs = np.zeros((BQ, dh), np.float32)
        qs[:nrows] = q[row0:row0 + nrows, h] * scale
        pos = start + row0 + np.arange(BQ)
        parts = []
        for s in range(n):
            units = list(range(s, nunits, n))
            visits[qt, h, s] = sum(min(ppt, npages - u * ppt) for u in units)
            if not units:
                parts.append(None)
                continue
            m = np.full(BQ, -np.inf, np.float32)
            l = np.zeros(BQ, np.float32)
            acc = np.zeros((BQ, dh), np.float32)
            for u in units:
                for k0 in range(u * ukeys, (u + 1) * ukeys, bk):
                    kend = min(k0 + bk, (u + 1) * ukeys, kv_end)
                    keys = np.arange(k0, k0 + bk)
                    live = keys < kend
                    kk = np.where(live, keys, 0)
                    slots = row[kk // ps], kk % ps
                    kt = np.where(live[:, None], kf[slots][:, h], 0)
                    vt = np.where(live[:, None], vf[slots][:, h], 0)
                    sc = qs @ kt.T
                    lim = np.minimum(pos + 1, kend)
                    sc = np.where(keys[None, :] < lim[:, None], sc, -np.inf)
                    mn = np.maximum(m, sc.max(1))
                    mu = np.where(mn == -np.inf, 0, mn).astype(np.float32)
                    p = np.exp(sc - mu[:, None])
                    alpha = np.exp(m - mu)
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ vt
                    m = mn
            parts.append((acc, m, l))
        ms = np.stack([p[1] if p else np.full(BQ, -np.inf) for p in parts])
        mx = ms.max(0)
        w = np.where(ms == -np.inf, 0, np.exp(ms - mx)).astype(np.float32)
        lsum = np.zeros(BQ, np.float32)
        o = np.zeros((BQ, dh), np.float32)
        for s, p in enumerate(parts):      # split order
            if p is not None:
                lsum += w[s] * p[2]
                o += w[s][:, None] * p[0]
        res = o / np.maximum(lsum, 1e-30)[:, None]
        out[row0:row0 + nrows, h] = res[:nrows]
    return out, visits


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("ps,dh", [(8, 64), (16, 72), (64, 32), (16, 256)])
@pytest.mark.parametrize("c,start,valid", [(64, 0, 1), (100, 5, 100),
                                           (64, 200, 50), (128, "cap", 128),
                                           (64, 0, 0)])
def test_emulated_loop_matches_plain(quant, ps, dh, c, start, valid):
    rng = np.random.default_rng(ps * 1000 + dh + c)
    nh, maxp = 2, -(-300 // ps)
    cap = maxp * ps
    start = cap if start == "cap" else start
    shape = (1 + maxp, ps, nh, dh)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    sc = ()
    if quant:
        (k, ks), (v, vs) = (pa.quantize_kv(torch.from_numpy(x)) for x in (k, v))
        sc = (ks, vs)
        k, v = k.numpy(), v.numpy()
    row = (1 + rng.permutation(maxp)).astype(np.int32)
    q = rng.standard_normal((c, nh, dh), dtype=np.float32)
    got, visits = _emulate(q, k, v, row, start, valid,
                           *(s.numpy() for s in sc), sm=16)
    want = pa._plain_prefill_attention(
        torch.from_numpy(q)[None], torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(row), start, valid, *sc)[0].numpy()
    assert np.abs(got - want).max() <= TOL
    assert (got[valid:] == 0).all()
    n = visits.shape[2]
    for qt in range(visits.shape[0]):
        pages = cpre.split_pages(start, valid, qt * BQ, BQ, ps, maxp, dh, n)
        assert visits[qt, 0].tolist() == [len(p) for p in pages]
