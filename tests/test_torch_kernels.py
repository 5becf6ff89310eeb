"""Paged attention of the PyTorch port (`paddle_tpu_torch/kernels/`) held
against the JAX package: the plain PyTorch versions against the XLA arms
and the Pallas kernels in interpret mode, the CUDA kernels' trip-count
functions against the Pallas kernels' exported visits, the page-coordinate
functions including trash routing, and the device dispatch. The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.

Every input is drawn with numpy from a seed and handed to both packages.
Tolerance: max-abs 1e-5 in float32 (both sides softmax in f32; only the
summation order differs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels.pallas import paged_attention as jdec
from paddle_tpu.kernels.pallas import prefill_attention as jpre
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.kernels.cuda import paged_attention as cdec
from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre

TOL = 1e-5


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _decode_case(seed, b, nh, dh, ps, maxp, pos):
    """Distinct non-trash pages per (slot, page), so a wrong page read shows
    up as a numeric mismatch."""
    rng = np.random.RandomState(seed)
    num_pages = 1 + b * maxp
    q = rng.randn(b, nh, dh).astype(np.float32)
    kp = rng.randn(num_pages, ps, nh, dh).astype(np.float32)
    vp = rng.randn(num_pages, ps, nh, dh).astype(np.float32)
    pt = (1 + rng.permutation(num_pages - 1)[:b * maxp]).reshape(b, maxp)
    return q, kp, vp, pt.astype(np.int32), np.asarray(pos, np.int32)


DECODE_CASES = {
    "ragged": dict(b=4, nh=2, dh=16, ps=4, maxp=5, pos=[0, 6, 13, 19]),
    "page_boundaries": dict(b=4, nh=2, dh=16, ps=4, maxp=4, pos=[3, 4, 7, 8]),
    "single_token": dict(b=2, nh=3, dh=8, ps=4, maxp=3, pos=[0, 0]),
    "wide_head": dict(b=2, nh=1, dh=96, ps=8, maxp=3, pos=[5, 23]),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_plain_decode_matches_xla_and_pallas(name):
    kw = DECODE_CASES[name]
    q, kp, vp, pt, pos = _decode_case(1, **kw)
    got = pa._plain_paged_attention(*map(torch.from_numpy,
                                         (q, kp, vp, pt, pos)))
    want_xla = jpa._xla_paged_attention(*map(jnp.asarray,
                                             (q, kp, vp, pt, pos)))
    want_pl, visits = jdec.paged_attention(*map(jnp.asarray,
                                                (q, kp, vp, pt, pos)),
                                           interpret=True,
                                           return_visits=True)
    assert _maxabs(got, want_xla) <= TOL
    assert _maxabs(got, want_pl) <= TOL
    # the CUDA kernel's trip count is the Pallas kernel's where pos lies
    # inside the slot
    want_visits = np.asarray(visits)
    for bi, p in enumerate(pos):
        assert (want_visits[bi] == cdec.pages_needed(int(p), kw["ps"],
                                                     kw["maxp"])).all()
    tv = cdec.pages_needed(torch.from_numpy(pos), kw["ps"], kw["maxp"])
    assert (tv.numpy()[:, None] == want_visits).all()


def test_pages_needed_clamps_at_capacity():
    # a trash-only row at pos = pages_per_slot * page_size: the Pallas loop
    # bound would walk one page past the row; the CUDA kernel's stops at it
    assert jdec.pages_needed(16, 4) == 5
    assert cdec.pages_needed(16, 4, 4) == 4
    assert cdec.pages_needed(15, 4, 4) == 4
    assert cdec.pages_needed(0, 16, 64) == 1


def test_float_decode_takes_the_split_loop_at_gpt2_small_shapes():
    # GPT-2 small serving: 12 heads of 64, pages of 16, 64 pages a slot, an
    # H100's 132 SMs. The float kernel takes the int8 kernel's rule and
    # grid: 8 splits of 128 keys at B=1 and B=8, fewer as the rows fill the
    # card; dh=40 keeps the per-(b, h) loop.
    assert cdec.arm(64) == "split"
    assert cdec.grid(8, 12, 64, 16, 132, 64) == (96, 8)
    assert cdec.grid(1, 12, 64, 16, 132, 64) == (12, 8)
    assert cdec.grid(32, 12, 64, 16, 132, 64) == (384, 3)
    assert cdec.grid(8, 12, 64, 16, 132, 40) == (8, 12)
    # the C entry points take the split loop's buffers in one order: the
    # float kernel's arguments are the int8 kernel's less the two scales
    assert cdec.KERNEL.argtypes == (cdec.KERNEL_INT8.argtypes[:3]
                                    + cdec.KERNEL_INT8.argtypes[5:])


def test_plain_decode_trash_row_at_capacity_matches_xla():
    q, kp, vp, pt, _ = _decode_case(2, b=2, nh=2, dh=8, ps=4, maxp=3,
                                    pos=[0, 0])
    pt[1] = 0                             # inactive slot: all trash
    pos = np.asarray([5, 3 * 4], np.int32)
    got = pa._plain_paged_attention(*map(torch.from_numpy,
                                         (q, kp, vp, pt, pos)))
    want = jpa._xla_paged_attention(*map(jnp.asarray, (q, kp, vp, pt, pos)))
    assert _maxabs(got, want) <= TOL


def _prefill_case(seed, c, nh=2, dh=8, ps=4, maxp=6):
    rng = np.random.RandomState(seed)
    npages = 1 + maxp
    kp = rng.randn(npages, ps, nh, dh).astype(np.float32)
    vp = rng.randn(npages, ps, nh, dh).astype(np.float32)
    row = np.arange(1, maxp + 1, dtype=np.int32)[::-1].copy()
    q = rng.randn(1, c, nh, dh).astype(np.float32)
    return q, kp, vp, row


PREFILL_CASES = [
    # (start, valid, c, block_q, maxp)
    (0, 7, 8, 8, 6),        # fresh prompt, padded tail
    (8, 5, 8, 8, 6),        # chunk after 2 pages of context
    (4, 8, 8, 8, 6),        # mid-page start
    (0, 1, 4, 4, 6),        # single real token
    (12, 3, 4, 4, 6),       # deep context, short tail
    (8, 10, 16, 4, 16),     # several query blocks
    (0, 5, 16, 4, 16),      # padded query blocks visit 0 pages
    (0, 24, 24, 8, 6),      # the whole slot, every row live
    # the tensor-core loop's 64-row tiles (default_block_q for bf16, dh 64)
    (0, 128, 128, 64, 32),  # two tiles, every row live
    (8, 150, 200, 64, 40),  # four tiles: one partly live, one all padding
]


@pytest.mark.parametrize("start,valid,c,block_q,maxp", PREFILL_CASES)
def test_plain_prefill_matches_xla_and_pallas(start, valid, c, block_q,
                                              maxp):
    q, kp, vp, row = _prefill_case(start * 17 + valid, c, maxp=maxp)
    got = pa._plain_prefill_attention(
        *map(torch.from_numpy, (q, kp, vp, row)), start, valid).numpy()
    want_xla = np.asarray(jpa._xla_prefill_attention(
        *map(jnp.asarray, (q, kp, vp, row)), jnp.int32(start),
        jnp.int32(valid)))
    want_pl, visits = jpre.prefill_attention(
        jnp.asarray(q[0]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(row), jnp.int32(start), jnp.int32(valid),
        interpret=True, return_visits=True, block_q=block_q)
    assert _maxabs(got[0, :valid], want_xla[0, :valid]) <= TOL
    # the Pallas kernel zeroes padded rows, as the port's versions do
    assert _maxabs(got[0], want_pl) <= TOL
    assert (got[0, valid:] == 0).all()
    want_visits = np.asarray(visits)
    for i in range(want_visits.shape[0]):
        assert (want_visits[i] == cpre.block_visits(
            start, valid, i * block_q, block_q, 4)).all()


# the CUDA-core grid is (query tiles, heads, splits): at a slot of 64
# pages of 16 on 132 SMs, C=1024 asks for 2 splits (192 tiles x heads),
# and dh 256 (32-key tiles, units of 2 pages) at C=100 for 11
@pytest.mark.parametrize("dtype,dh,c,want_arm,want_bq,want_grid", [
    (torch.bfloat16, 64, 1024, "mma_bf16", 64, (12, 16)),  # the serve path
    (torch.bfloat16, 128, 16, "mma_bf16", 16, (12, 1)),
    (torch.bfloat16, 16, 200, "mma_bf16", 64, (12, 4)),
    (torch.float32, 64, 1024, "cuda_core", 64, (16, 12, 2)),  # f32: no TF32
    (torch.bfloat16, 72, 1024, "cuda_core", 64, (16, 12, 2)),  # not 16 | dh
    (torch.bfloat16, 256, 100, "cuda_core", 64, (2, 12, 11)),  # above 128
])
def test_prefill_arm_rule_and_query_tiles(dtype, dh, c, want_arm, want_bq,
                                          want_grid):
    assert cpre.arm(dtype, dh) == want_arm
    assert cpre.default_block_q(c, dtype, dh) == want_bq
    assert cpre.grid(c, 12, dtype, dh, 64, 16, 132) == want_grid


def test_tensor_core_prefill_refuses_what_it_cannot_take():
    # checked before the device: the loop's 16-byte copies and the slot's
    # page-table row it keeps in shared memory
    nh, dh, ps = 2, 64, 16
    q = torch.zeros(4, nh, dh, dtype=torch.bfloat16)
    kp = torch.zeros(3, ps, nh, dh, dtype=torch.bfloat16)
    kq = kp.to(torch.int8)
    sc = torch.ones(3, ps, nh)
    row = torch.zeros(cpre.MMA_MAX_PAGES + 1, dtype=torch.int32)
    calls = (lambda q, row: cpre.paged_prefill(q, kp, kp.clone(), row, 0, 4),
             lambda q, row: cpre.paged_prefill_int8(q, kq, kq.clone(), sc,
                                                    sc.clone(), row, 0, 4))
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    for call in calls:
        with pytest.raises(ValueError, match="page-table row"):
            call(q, row)
        with pytest.raises(ValueError, match="16-byte boundaries"):
            call(flat[1:].view(4, nh, dh), row[:2])


def test_gather_kv_matches_jax():
    rng = np.random.RandomState(3)
    pages = rng.randn(6, 4, 2, 8).astype(np.float32)
    table = np.array([[3, 1, 4], [0, 5, 2]], np.int32)
    got = pa.gather_kv(torch.from_numpy(pages), torch.from_numpy(table))
    want = jpa.gather_kv(jnp.asarray(pages), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_token_page_coords_match_jax_with_trash_routing():
    table = np.array([[3, 1, 4], [5, 2, 6], [7, 8, 9]], np.int32)
    pos = np.array([5, 12, 2], np.int32)    # slot 1 sits past capacity
    active = np.array([True, True, False])  # slot 2 inactive
    page, off = pa.token_page_coords(torch.from_numpy(table),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(active), 4)
    jpage, joff = jpa.token_page_coords(jnp.asarray(table), jnp.asarray(pos),
                                        jnp.asarray(active), 4)
    np.testing.assert_array_equal(page.numpy(), np.asarray(jpage))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    assert page.tolist() == [1, pa.TRASH_PAGE, pa.TRASH_PAGE]


@pytest.mark.parametrize("start,valid,seq_len", [
    (0, 5, 8),      # prompt with bucket padding
    (6, 4, 4),      # mid-page chunk
    (8, 8, 8),      # chunk running past the slot's capacity (12)
])
def test_chunk_and_prompt_page_coords_match_jax(start, valid, seq_len):
    row = np.array([3, 1, 4], np.int32)
    page, off = pa.chunk_page_coords(torch.from_numpy(row), start, valid,
                                     seq_len, 4)
    jpage, joff = jpa.chunk_page_coords(jnp.asarray(row), jnp.int32(start),
                                        jnp.int32(valid), seq_len, 4)
    np.testing.assert_array_equal(page.numpy(), np.asarray(jpage))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    if start == 0:
        page, off = pa.prompt_page_coords(torch.from_numpy(row), valid,
                                          seq_len, 4)
        jpage, joff = jpa.prompt_page_coords(jnp.asarray(row),
                                             jnp.int32(valid), seq_len, 4)
        np.testing.assert_array_equal(page.numpy(), np.asarray(jpage))
        np.testing.assert_array_equal(off.numpy(), np.asarray(joff))


def test_cpu_tensors_dispatch_to_plain_and_count():
    q, kp, vp, pt, pos = map(torch.from_numpy, _decode_case(
        4, b=2, nh=2, dh=8, ps=4, maxp=3, pos=[2, 9]))
    registry.reset_counts()
    out = pa.paged_attention(q, kp, vp, pt, pos)
    assert torch.equal(out, pa._plain_paged_attention(q, kp, vp, pt, pos))
    assert registry.counts() == {"kernel.dispatch.paged_attention.plain": 1}
    # the device decision is the registry's alone: the CUDA wrappers refuse
    # CPU tensors instead of running the plain version uncounted
    with pytest.raises(ValueError, match="CUDA tensors"):
        cdec.paged_decode(q, kp, vp, pt, pos)

    qc, kp, vp, row = map(torch.from_numpy, _prefill_case(5, 8))
    outp = pa.prefill_attention(qc, kp, vp, row, 4, 6)
    assert torch.equal(outp, pa._plain_prefill_attention(qc, kp, vp, row,
                                                          4, 6))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cpre.paged_prefill(qc[0], kp, vp, row, 4, 6)
    assert registry.counts() == {"kernel.dispatch.paged_attention.plain": 1,
                                 "kernel.dispatch.prefill_attention.plain": 1}
    with pytest.raises(KeyError):
        registry.dispatch("ring_attention", q)      # not ported yet
    # the sampler's one impl is plain torch ops on either device
    assert registry.dispatch("fused_sampling", q) == "torch"
