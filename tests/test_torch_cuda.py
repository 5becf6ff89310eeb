"""The PyTorch port's hand-written CUDA kernels held against their plain
PyTorch versions ON THE CARD, and the card engine against the CPU engine.
Every test here needs an NVIDIA card with CUDA and nvcc, is marked
``cuda``, and skips elsewhere. This file imports no JAX (the card's
machine has none), so run it there without the JAX-loading conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 2e-5 in float32 (online softmax against a full softmax, f32
throughout); 2e-2 in bfloat16, where both outputs are rounded to bfloat16.
The int8 paged kernels take the same tolerances for q in f32 and bf16. The
prefill kernels run q in bfloat16 on the tensor cores (head dims that are
multiples of 16 up to 128), and 2e-2 still holds there: the scores and the
softmax stay f32, and the one rounding the plain version does not make is
P's, to bf16 before the P V product (2^-8 of each weight, so at most 2^-8
of the largest |v| in an output). Over int8 pools there is no other: the
int8 values widen to bf16 exactly, and the K and V scales multiply the f32
scores and P after the products instead of the values before them.
`tests/test_torch_quant.py` emulates that rounding on the CPU against the
same tolerance. Float32 stays on the CUDA cores (the register-tiled
loop, its keys split across blocks and merged in one launch: held at
its split edges, under a captured graph, bit for bit run to run, and
on tickets it shares with the decode loop). The card engine equals
the CPU engine token for token, native and int8.
The flash kernels: in float32 2e-5 (forward) and 1e-4 (gradients) times
the largest reference value when that exceeds 1; in bfloat16 one bfloat16
step of the largest reference value, never less than the float32 bound
(the bf16 forward runs on the tensor cores and rounds P to bf16 for P V,
at most 2^-9 of each weight; its lse, from the f32 p, keeps 2e-5; the
bf16 dK/dV and dQ loops run there too and round P and dS to bf16 only as
the operands of their dV, dK and dQ products, a bound
`tests/test_torch_flash.py` emulates on the CPU). The split decode loop, over float and int8 pools,
holds the same bounds as the per-(b, h) loop.
The sampler on the card against the CPU (the same torch code): bits,
uniforms and key chains exact, Gumbel values within 4 ulp of max(|g|, 1),
tokens equal where the CPU's perturbed top-2 margin clears that; the
sampled engine, plain and speculative, float and int8 pools, equals the
CPU engine token for token.
The fused cross-entropy on the card against the CPU: losses within 1e-4,
gradients within one bf16 step (2^-8) of their largest value.
The fused layernorm kernels: y within 2e-5 and dx within 1e-4 in
float32 (one bfloat16 step in bfloat16), statistics and dgamma/dbeta
partials within 2e-5 / 1e-4 relative; the rotary kernel within 1e-6 of
the largest value in float32 (one bfloat16 step in bfloat16). The
`incubate.nn` layers on the card against the CPU: the stack within 1e-4,
FusedLayerNorm within 2e-5 (y) and 1e-4 (gradients), rope 1e-6, each
relative to the largest value when above 1.
"""
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.tensor import torch_state
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels.cuda import paged_attention as cdec
from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre

pytestmark = pytest.mark.cuda

DTYPES = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA: the kernels have no "
                    "CPU mode (their plain versions are tested against the "
                    "JAX package in tests/test_torch_kernels.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pools(rng, num_pages, ps, nh, dh, dev, dtype):
    return tuple(torch.from_numpy(rng.standard_normal(
        (num_pages, ps, nh, dh), dtype=np.float32)).to(dev, dtype)
        for _ in range(2))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("dh", [64, 32, 128])
def test_decode_kernel_matches_plain(card, dtype, tol, dh):
    rng = np.random.default_rng(dh)
    b, nh, ps, maxp = 8, 4, 16, 8
    kp, vp = _pools(rng, 1 + b * maxp, ps, nh, dh, card, dtype)
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp)
    table[4] = 0                            # trash row at capacity
    pos = np.array([0, 15, 16, 127, maxp * ps, 64, 3, 99], np.int32)
    q = torch.from_numpy(rng.standard_normal((b, nh, dh), dtype=np.float32)
                         ).to(card, dtype)
    pt = torch.from_numpy(table.astype(np.int32)).to(card)
    pos_t = torch.from_numpy(pos).to(card)
    out, visits = cdec.paged_decode(q, kp, vp, pt, pos_t, return_visits=True)
    torch.cuda.synchronize()
    ref = pa._plain_paged_attention(q, kp, vp, pt, pos_t)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    want = cdec.pages_needed(pos_t, ps, maxp).to(torch.int32)
    assert torch.equal(visits, want[:, None].expand_as(visits))
    # the dispatcher takes the kernel for CUDA tensors
    launches = cdec.KERNEL.launches
    assert torch.equal(pa.paged_attention(q, kp, vp, pt, pos_t), out)
    assert cdec.KERNEL.launches == launches + 1


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b", [1, 8, 32, 64])
@pytest.mark.parametrize("dh", [64, 128, 256, 40])
def test_float_decode_split_loop_matches_plain(card, dtype, tol, b, dh):
    """The float kernel at GPT-2 small's heads and pages (12 heads, pages
    of 16, 64 pages a slot; 8 splits a row at B=1 and 8, fewer at B=32 and
    64), head dims of the split loop and dh=40 on the per-(b, h) loop:
    positions 0, mid-page, a slot's last key and capacity (a trash-only
    row), each call one launch, the visits equal to pages_needed, and a
    second call equal to the first (the tickets are left at zero)."""
    rng = np.random.default_rng(500 + b + dh)
    nh, ps, maxp = 12, 16, 64
    kp, vp = _pools(rng, 1 + b * maxp, ps, nh, dh, card, dtype)
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp)
    pos = rng.integers(0, maxp * ps, b).astype(np.int32)
    pos[0] = maxp * ps - 1 if b == 1 else 0
    if b > 1:
        pos[1], table[-1], pos[-1] = 40, 0, maxp * ps   # mid-page; trash
    q = torch.from_numpy(rng.standard_normal((b, nh, dh), dtype=np.float32)
                         ).to(card, dtype)
    pt = torch.from_numpy(table.astype(np.int32)).to(card)
    pos_t = torch.from_numpy(pos).to(card)
    assert cdec.arm(dh) == ("per_head" if dh == 40 else "split")
    before = cdec.KERNEL.launches
    out, visits = cdec.paged_decode(q, kp, vp, pt, pos_t, return_visits=True)
    assert cdec.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    ref = pa._plain_paged_attention(q, kp, vp, pt, pos_t)
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol
    want = cdec.pages_needed(pos_t, ps, maxp).to(torch.int32)
    assert torch.equal(visits, want[:, None].expand_as(visits))
    assert torch.equal(cdec.paged_decode(q, kp, vp, pt, pos_t), out)


def test_float_decode_split_loop_refuses_misaligned_pools(card):
    kp = torch.zeros(5 * 4 * 2 * 16 + 2, device=card)[2:].view(5, 4, 2, 16)
    q = torch.zeros(2, 2, 16, device=card)
    pt = torch.zeros(2, 2, dtype=torch.int32, device=card)
    pos = torch.zeros(2, dtype=torch.int32, device=card)
    assert kp.data_ptr() % 16 == 8 and cdec.arm(16) == "split"
    before = cdec.KERNEL.launches
    with pytest.raises(ValueError, match="16-byte boundaries"):
        cdec.paged_decode(q, kp, kp, pt, pos)
    assert cdec.KERNEL.launches == before


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("start,valid,c", [
    (0, 7, 16), (0, 128, 128), (40, 20, 32), (0, 100, 128), (0, 150, 512),
    (17, 1, 4)])
def test_prefill_kernel_matches_plain(card, dtype, tol, start, valid, c):
    rng = np.random.default_rng(start + valid + c)
    nh, dh, ps, maxp = 4, 64, 16, 12
    kp, vp = _pools(rng, 1 + maxp, ps, nh, dh, card, dtype)
    row = torch.from_numpy((1 + rng.permutation(maxp)).astype(np.int32)
                           ).to(card)
    q = torch.from_numpy(rng.standard_normal((c, nh, dh), dtype=np.float32)
                         ).to(card, dtype)
    out, visits = cpre.paged_prefill(q, kp, vp, row, start, valid,
                                     return_visits=True)
    torch.cuda.synchronize()
    ref = pa._plain_prefill_attention(q[None], kp, vp, row, start, valid)[0]
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (out[valid:] == 0).all()
    bq = cpre.default_block_q(c, dtype, dh)
    want = [cpre.block_visits(start, valid, i * bq, bq, ps)
            for i in range(visits.shape[0])]
    assert visits[:, 0].tolist() == want


def _int8_pools(rng, num_pages, ps, nh, dh, dev):
    """int8 pools and their f32 scales, quantized from normal K/V."""
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((num_pages, ps, nh, dh),
                                                 dtype=np.float32)).to(dev)
        out += list(pa.quantize_kv(x))
    return out[0], out[2], out[1], out[3]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("dh", [64, 32, 128])
def test_int8_decode_kernel_matches_plain(card, dtype, tol, dh):
    rng = np.random.default_rng(100 + dh)
    b, nh, ps, maxp = 8, 4, 16, 8
    kp, vp, ks, vs = _int8_pools(rng, 1 + b * maxp, ps, nh, dh, card)
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp)
    table[4] = 0                            # trash row at capacity
    pos = np.array([0, 15, 16, 127, maxp * ps, 64, 3, 99], np.int32)
    q = torch.from_numpy(rng.standard_normal((b, nh, dh), dtype=np.float32)
                         ).to(card, dtype)
    pt = torch.from_numpy(table.astype(np.int32)).to(card)
    pos_t = torch.from_numpy(pos).to(card)
    out, visits = cdec.paged_decode_int8(q, kp, vp, ks, vs, pt, pos_t,
                                         return_visits=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    ref = pa._plain_paged_attention(q, kp, vp, pt, pos_t, ks, vs)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    want = cdec.pages_needed(pos_t, ps, maxp).to(torch.int32)
    assert torch.equal(visits, want[:, None].expand_as(visits))
    # the dispatcher takes the int8 kernel for int8 CUDA pools
    launches = cdec.KERNEL_INT8.launches
    assert torch.equal(pa.paged_attention(q, kp, vp, pt, pos_t, ks, vs), out)
    assert cdec.KERNEL_INT8.launches == launches + 1


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("dh", [64, 32, 128])
@pytest.mark.parametrize("start,valid,c", [
    (0, 7, 16), (0, 100, 128), (40, 20, 32), (0, 150, 512)])
def test_int8_prefill_kernel_matches_plain(card, dtype, tol, dh, start,
                                           valid, c):
    rng = np.random.default_rng(start + valid + c + dh)
    nh, ps, maxp = 4, 16, 12
    kp, vp, ks, vs = _int8_pools(rng, 1 + maxp, ps, nh, dh, card)
    row = torch.from_numpy((1 + rng.permutation(maxp)).astype(np.int32)
                           ).to(card)
    q = torch.from_numpy(rng.standard_normal((c, nh, dh), dtype=np.float32)
                         ).to(card, dtype)
    out, visits = cpre.paged_prefill_int8(q, kp, vp, ks, vs, row, start,
                                          valid, return_visits=True)
    torch.cuda.synchronize()
    ref = pa._plain_prefill_attention(q[None], kp, vp, row, start, valid,
                                      ks, vs)[0]
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (out[valid:] == 0).all()
    bq = cpre.default_block_q(c, dtype, dh)
    want = [cpre.block_visits(start, valid, i * bq, bq, ps)
            for i in range(visits.shape[0])]
    assert visits[:, 0].tolist() == want
    launches = cpre.KERNEL_INT8.launches
    assert torch.equal(pa.prefill_attention(q[None], kp, vp, row, start,
                                            valid, ks, vs)[0], out)
    assert cpre.KERNEL_INT8.launches == launches + 1


def _prefill_pools(rng, quant, num_pages, ps, nh, dh, dev, dtype):
    """(k_pages, v_pages, scales): float pools of q's dtype and no scales,
    or int8 pools and their (k_scale, v_scale)."""
    if quant:
        kp, vp, ks, vs = _int8_pools(rng, num_pages, ps, nh, dh, dev)
        return kp, vp, (ks, vs)
    return (*_pools(rng, num_pages, ps, nh, dh, dev, dtype), ())


def _prefill(quant):
    return cpre.paged_prefill_int8 if quant else cpre.paged_prefill


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_prefill_kernels_cover_page_sizes_and_head_dims(card, quant, dtype,
                                                        tol, dh, ps):
    # pages of 8 and 16 keys (several to a 64-key tile) and of 64 (one):
    # the gather takes each key row from its own page
    rng = np.random.default_rng(1000 * ps + dh + quant)
    nh = 2
    maxp = -(-1100 // ps)                 # a slot of at least 1100 positions
    cap = maxp * ps
    kp, vp, sc = _prefill_pools(rng, quant, 1 + maxp, ps, nh, dh, card,
                                dtype)
    row = torch.from_numpy((1 + rng.permutation(maxp)).astype(np.int32)
                           ).to(card)
    for start, valid, c in (
            (0, 1024, 1024),              # every row live
            (5, 100, 128),                # starts mid-page
            (0, 60, 256),                 # query tiles of padding rows
            (cap - 100, 100, 128)):       # last live row at the slot's end
        q = torch.from_numpy(rng.standard_normal(
            (c, nh, dh), dtype=np.float32)).to(card, dtype)
        out, visits = _prefill(quant)(q, kp, vp, *sc, row, start, valid,
                                      return_visits=True)
        torch.cuda.synchronize()
        ref = pa._plain_prefill_attention(q[None], kp, vp, row, start,
                                          valid, *sc)[0]
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol, (start, valid, c, err)
        assert (out[valid:] == 0).all(), (start, valid, c)
        bq = cpre.default_block_q(c, dtype, dh)
        want = [min(cpre.block_visits(start, valid, i * bq, bq, ps), maxp)
                for i in range(visits.shape[0])]
        assert visits.shape[0] == -(-c // bq)
        assert visits[:, 0].tolist() == want, (start, valid, c)
        assert (visits == visits[:, :1]).all()
        if valid == 60:
            assert want[-1] == 0          # a tile of padding visits nothing
        if start + valid == cap:
            assert max(want) == maxp      # the clamp: never past the slot


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("start", ["zero", "mid_slot", "capacity"])
@pytest.mark.parametrize("valid", ["zero", "one", "chunk"])
def test_prefill_kernels_read_start_and_valid_from_the_card(
        card, quant, dtype, tol, start, valid):
    """``start`` and ``valid`` as one-element int32 tensors on the card (a
    captured graph's packed upload): valid 0, 1 and the whole chunk; start
    0, in the middle of a page of the slot, and at the slot's capacity,
    where every key is visible and the kernel's clamp of the visible range
    is what keeps it in the slot. Each equals the plain version on the
    same values, and a host int call where the host allows one."""
    rng = np.random.default_rng(11)
    nh, dh, ps, maxp, c = 4, 64, 16, 12, 96
    cap = maxp * ps
    s = {"zero": 0, "mid_slot": 70, "capacity": cap}[start]
    v = {"zero": 0, "one": 1, "chunk": c}[valid]
    kp, vp, sc = _prefill_pools(rng, quant, 1 + maxp, ps, nh, dh, card,
                                dtype)
    row = torch.from_numpy((1 + rng.permutation(maxp)).astype(np.int32)
                           ).to(card)
    q = torch.from_numpy(rng.standard_normal((c, nh, dh), dtype=np.float32)
                         ).to(card, dtype)
    dev_s, dev_v = (torch.tensor(x, dtype=torch.int32, device=card)
                    for x in (s, v))
    out = _prefill(quant)(q, kp, vp, *sc, row, dev_s, dev_v)
    torch.cuda.synchronize()
    ref = pa._plain_prefill_attention(q[None], kp, vp, row, dev_s, dev_v,
                                      *sc)[0]
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (out[v:] == 0).all()
    if s + v <= cap:
        assert torch.equal(out, _prefill(quant)(q, kp, vp, *sc, row, s, v))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_bf16_prefill_op_launches_the_tensor_core_kernel_once(
        card, quant, monkeypatch):
    rng = np.random.default_rng(7)
    nh, dh, ps, maxp, c = 12, 64, 16, 64, 1024
    kp, vp, sc = _prefill_pools(rng, quant, 1 + maxp, ps, nh, dh, card,
                                torch.bfloat16)
    row = torch.from_numpy((1 + rng.permutation(maxp)).astype(np.int32)
                           ).to(card)
    q = torch.from_numpy(rng.standard_normal((c, nh, dh), dtype=np.float32)
                         ).to(card, torch.bfloat16)
    assert cpre.arm(q.dtype, dh) == "mma_bf16"
    kern, other = ((cpre.KERNEL_INT8, cpre.KERNEL) if quant
                   else (cpre.KERNEL, cpre.KERNEL_INT8))
    plain = pa._plain_prefill_attention

    def no_fallback(*a, **k):
        raise AssertionError("a bf16 CUDA call reached the plain version")

    monkeypatch.setattr(pa, "_plain_prefill_attention", no_fallback)
    before, before_other = kern.launches, other.launches
    got = pa.prefill_attention(q[None], kp, vp, row, 0, c, *sc)[0]
    assert kern.launches == before + 1
    assert other.launches == before_other
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.equal(got, _prefill(quant)(q, kp, vp, *sc, row, 0, c))
    ref = plain(q[None], kp, vp, row, 0, c, *sc)[0]
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


# the CUDA-core loop's key splits at GPT-2 small's heads and a serve slot
# (64 pages of 16): a prefix tail deep in the slot, a chunk at the slot's
# capacity, and valid 0 / 1 / C mid-slot
CORE_NH, CORE_DH, CORE_PS, CORE_MAXP = 12, 64, 16, 64
CORE_EDGES = [(64, 768, 50), (64, CORE_MAXP * CORE_PS, 64), (256, 501, 0),
              (256, 501, 1), (256, 501, 256), (1024, 0, 1024)]


def _core_case(rng, quant, dtype, c, nh=CORE_NH, dh=CORE_DH, ps=CORE_PS,
               maxp=CORE_MAXP, dev="cuda"):
    kp, vp, sc = _prefill_pools(rng, quant, 1 + maxp, ps, nh, dh, dev, dtype)
    row = torch.from_numpy((1 + rng.permutation(maxp)).astype(np.int32)
                           ).to(dev)
    q = torch.from_numpy(rng.standard_normal((c, nh, dh), dtype=np.float32)
                         ).to(dev, dtype)
    return q, kp, vp, sc, row


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("c,start,valid", CORE_EDGES)
def test_core_prefill_splits_match_plain_at_their_edges(card, quant, c,
                                                        start, valid):
    """f32 q over float and int8 pools through the CUDA-core loop: within
    2e-5 of the plain version, padded rows zero, each split's page count
    equal to `split_pages` (together `block_visits`, each page once), the
    op dispatching to the kernel, and a second run bit-identical (the
    merge takes the splits in index order)."""
    rng = np.random.default_rng(c + start + valid + quant)
    q, kp, vp, sc, row = _core_case(rng, quant, torch.float32, c)
    assert cpre.arm(q.dtype, CORE_DH) == "cuda_core"
    sm = torch.cuda.get_device_properties(card).multi_processor_count
    nq, nh, n = cpre.grid(c, CORE_NH, q.dtype, CORE_DH, CORE_MAXP, CORE_PS,
                          sm)
    # on the card, as a captured graph passes them (a host start at the
    # slot's capacity would be refused)
    dev_s, dev_v = torch.tensor([start, valid], dtype=torch.int32,
                                device=card)
    out, visits = _prefill(quant)(q, kp, vp, *sc, row, dev_s, dev_v,
                                  return_visits="splits")
    torch.cuda.synchronize()
    ref = pa._plain_prefill_attention(q[None], kp, vp, row, dev_s, dev_v,
                                      *sc)[0]
    assert (out - ref).abs().max().item() <= 2e-5
    assert (out[valid:] == 0).all()
    assert tuple(visits.shape) == (nq, nh, n)
    for qt in range(nq):
        want = cpre.split_pages(start, valid, qt * 64, 64, CORE_PS,
                                CORE_MAXP, CORE_DH, n)
        assert (visits[qt] == torch.tensor(
            [len(p) for p in want], dtype=torch.int32, device=card)).all()
    kern = cpre.KERNEL_INT8 if quant else cpre.KERNEL
    before = kern.launches
    again = pa.prefill_attention(q[None], kp, vp, row, dev_s, dev_v,
                                 *sc)[0]
    assert kern.launches == before + 1
    assert torch.equal(again, out)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 72),
                                      (torch.bfloat16, 256),
                                      (torch.bfloat16, 33),
                                      (torch.float32, 33)])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_core_prefill_covers_other_head_dims(card, quant, dtype, dh, ps):
    """The head dims the tensor cores do not take (not a multiple of 16,
    or above 128), and an odd one whose rows the gather copies 4, 2 or 1
    bytes at a time, at page sizes of 8, 16 and 64: within the dtype's
    tolerance of the plain version, padded rows zero, visits equal to
    `block_visits`."""
    rng = np.random.default_rng(ps * 300 + dh + quant)
    nh, maxp = 2, -(-600 // ps)
    cap = maxp * ps
    q, kp, vp, sc, row = _core_case(rng, quant, dtype, 256, nh, dh, ps, maxp,
                                    card)
    assert cpre.arm(dtype, dh) == "cuda_core"
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for start, valid in ((0, 256), (37, 100), (cap - 64, 64), (300, 1)):
        out, visits = _prefill(quant)(q, kp, vp, *sc, row, start, valid,
                                      return_visits=True)
        torch.cuda.synchronize()
        ref = pa._plain_prefill_attention(q[None], kp, vp, row, start,
                                          valid, *sc)[0]
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol, (start, valid, err)
        assert (out[valid:] == 0).all()
        want = [min(cpre.block_visits(start, valid, i * 64, 64, ps), maxp)
                for i in range(visits.shape[0])]
        assert visits[:, 0].tolist() == want, (start, valid)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_core_prefill_graph_replays_other_uploads(card, quant):
    """A CUDA graph of one f32 call captured over device `start` / `valid`
    and replayed with two other uploads equals eager calls on the same
    values bit for bit (the split count is the shape's, the merge order
    fixed)."""
    rng = np.random.default_rng(60 + quant)
    c = 256
    q, kp, vp, sc, row = _core_case(rng, quant, torch.float32, c)
    fn = _prefill(quant)
    dev_s, dev_v = (torch.zeros((), dtype=torch.int32, device=card)
                    for _ in range(2))
    dev_s.fill_(96)
    dev_v.fill_(c)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        for _ in range(2):      # caches the side stream's tickets
            fn(q, kp, vp, *sc, row, dev_s, dev_v)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn(q, kp, vp, *sc, row, dev_s, dev_v)
    for start, valid in ((768, 50), (501, c)):
        dev_s.fill_(start)
        dev_v.fill_(valid)
        graph.replay()
        torch.cuda.synchronize()
        eager = fn(q, kp, vp, *sc, row, start, valid)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), (start, valid)
        ref = pa._plain_prefill_attention(q[None], kp, vp, row, start, valid,
                                          *sc)[0]
        assert (out - ref).abs().max().item() <= 2e-5


def test_core_prefill_float_and_int8_share_tickets_on_a_stream(card):
    """f32 calls over float and int8 pools at one (query tile, head) count
    (and the split decode loop at the same row count), alternating back to
    back on one stream with no synchronisation, share its tickets: each
    equals its plain version and its repeat, and the tickets are zero
    after them."""
    rng = np.random.default_rng(70)
    c, start, valid = 64, 768, 50
    calls = []
    for quant in (False, True):
        q, kp, vp, sc, row = _core_case(rng, quant, torch.float32, c)
        calls.append((_prefill(quant), (q, kp, vp, *sc, row, start, valid)))
    sm = torch.cuda.get_device_properties(card).multi_processor_count
    assert cpre.core_splits(c, CORE_NH, CORE_DH, CORE_MAXP, CORE_PS, sm) > 1
    # a decode call whose (b, h) count is the prefill's (query tiles x
    # heads): one tickets tensor for both loops
    kd, vd = _pools(rng, 1 + CORE_MAXP, CORE_PS, CORE_NH, CORE_DH, card,
                    torch.float32)
    qd = torch.randn(1, CORE_NH, CORE_DH, device=card)
    ptd = row[None].clone()
    posd = torch.tensor([900], dtype=torch.int32, device=card)
    calls.append((cdec.paged_decode, (qd, kd, vd, ptd, posd)))
    refs = [pa._plain_prefill_attention(a[0][None], a[1], a[2], a[-3],
                                        start, valid, *a[3:-3])[0]
            for _, a in calls[:2]]
    refs.append(pa._plain_paged_attention(qd, kd, vd, ptd, posd))
    outs = [fn(*args) for _ in range(3) for fn, args in calls]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        j = i % len(calls)
        assert (out - refs[j]).abs().max().item() <= 2e-5, i
        assert torch.equal(out, outs[j])
    stream = torch.cuda.current_stream(card).cuda_stream
    assert int(cdec._tickets(card, CORE_NH, stream).abs().sum()) == 0


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b", [1, 8, 32, 64])
def test_int8_decode_split_loop_matches_plain(card, dtype, tol, b):
    """The split loop at GPT-2 small's heads (12 of 64, pages of 16, 64
    pages a slot; 8 splits a row at B=1 and 8, fewer at B=32 and 64):
    positions 0,
    mid-page, a slot's last key and capacity (a trash-only row), each call
    one launch, the visits equal to
    pages_needed, and a second call equal to the first (the tickets are
    left at zero)."""
    rng = np.random.default_rng(200 + b)
    nh, dh, ps, maxp = 12, 64, 16, 64
    kp, vp, ks, vs = _int8_pools(rng, 1 + b * maxp, ps, nh, dh, card)
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp)
    pos = rng.integers(0, maxp * ps, b).astype(np.int32)
    pos[0] = maxp * ps - 1 if b == 1 else 0
    if b > 1:
        pos[1], table[-1], pos[-1] = 40, 0, maxp * ps   # mid-page; trash
    q = torch.from_numpy(rng.standard_normal((b, nh, dh), dtype=np.float32)
                         ).to(card, dtype)
    pt = torch.from_numpy(table.astype(np.int32)).to(card)
    pos_t = torch.from_numpy(pos).to(card)
    assert cdec.arm(dh) == "split"
    n = cdec.splits(b, nh, maxp, ps, torch.cuda.get_device_properties(
        card).multi_processor_count)
    assert cdec.grid(b, nh, maxp, ps, 132, dh)[0] == b * nh
    before = cdec.KERNEL_INT8.launches
    out, visits = cdec.paged_decode_int8(q, kp, vp, ks, vs, pt, pos_t,
                                         return_visits=True)
    assert cdec.KERNEL_INT8.launches == before + 1
    torch.cuda.synchronize()
    ref = pa._plain_paged_attention(q, kp, vp, pt, pos_t, ks, vs)
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol, n
    want = cdec.pages_needed(pos_t, ps, maxp).to(torch.int32)
    assert torch.equal(visits, want[:, None].expand_as(visits))
    again = cdec.paged_decode_int8(q, kp, vp, ks, vs, pt, pos_t)
    assert torch.equal(again, out)


@pytest.mark.parametrize("dh", [16, 48, 128, 160, 256, 40])
def test_int8_decode_arms_cover_head_dims(card, dh):
    """Head dims of every lane layout of the split loop (4, 16 and 32
    lanes a V row, two char4 a lane above 128), and dh=40, which keeps the
    per-(b, h) loop; two splits of 32 pages of 4, the second empty for the
    rows at 0 and 13."""
    rng = np.random.default_rng(300 + dh)
    b, nh, ps, maxp = 3, 2, 4, 40
    kp, vp, ks, vs = _int8_pools(rng, 1 + b * maxp, ps, nh, dh, card)
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp)
    pos = np.array([0, 13, maxp * ps - 1], np.int32)
    q = torch.from_numpy(rng.standard_normal((b, nh, dh), dtype=np.float32)
                         ).to(card)
    pt = torch.from_numpy(table.astype(np.int32)).to(card)
    pos_t = torch.from_numpy(pos).to(card)
    assert cdec.arm(dh) == ("per_head" if dh == 40 else "split")
    out, visits = cdec.paged_decode_int8(q, kp, vp, ks, vs, pt, pos_t,
                                         return_visits=True)
    torch.cuda.synchronize()
    ref = pa._plain_paged_attention(q, kp, vp, pt, pos_t, ks, vs)
    assert (out - ref).abs().max().item() <= 2e-5
    want = cdec.pages_needed(pos_t, ps, maxp).to(torch.int32)
    assert torch.equal(visits, want[:, None].expand_as(visits))


def test_int8_decode_split_counts_share_tickets_on_a_stream(card):
    """Calls with other split counts on one (b, h) count (8 splits of a
    64-page slot, 4 of a 32-page one) share the tickets of their stream:
    back to back with no synchronisation, each equals the plain version and
    its repeat; on a second stream, running beside the first, the calls
    take tickets of their own and are right too."""
    rng = np.random.default_rng(400)
    b, nh, dh, ps = 8, 12, 64, 16
    kp, vp, ks, vs = _int8_pools(rng, 1 + b * 64, ps, nh, dh, card)
    sm = torch.cuda.get_device_properties(card).multi_processor_count
    calls = []
    for maxp in (64, 32):
        table = (1 + rng.permutation(b * 64)[:b * maxp]).reshape(b, maxp)
        pos = rng.integers(0, maxp * ps, b).astype(np.int32)
        calls.append((torch.from_numpy(rng.standard_normal(
            (b, nh, dh), dtype=np.float32)).to(card, torch.bfloat16),
            torch.from_numpy(table.astype(np.int32)).to(card),
            torch.from_numpy(pos).to(card)))
    assert [cdec.splits(b, nh, pt.shape[1], ps, sm)
            for _, pt, _ in calls] == [8, 4]
    refs = [pa._plain_paged_attention(q, kp, vp, pt, pos, ks, vs)
            for q, pt, pos in calls]

    def run_all():
        return [cdec.paged_decode_int8(q, kp, vp, ks, vs, pt, pos)
                for q, pt, pos in calls * 2]

    outs = run_all()
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        side_outs = run_all()
    main_outs = run_all()
    torch.cuda.synchronize()
    tickets = {s: cdec._tickets(card, b * nh, s.cuda_stream)
               for s in (torch.cuda.current_stream(card), side)}
    assert len({t.data_ptr() for t in tickets.values()}) == 2
    for got in (outs, side_outs, main_outs):
        for i, out in enumerate(got):
            assert (out.float() - refs[i % 2].float()).abs().max().item() \
                <= 2e-2
            assert torch.equal(out, outs[i % 2])
    assert all(int(t.abs().sum()) == 0 for t in tickets.values())


def test_float_and_int8_decode_share_tickets_on_a_stream(card):
    """Float (bf16 and f32) and int8 calls at one (b, h) count, alternating
    back to back on one stream with no synchronisation, share its tickets:
    each equals its plain version and its repeat, and the tickets are zero
    after them."""
    rng = np.random.default_rng(450)
    b, nh, dh, ps, maxp = 8, 12, 64, 16, 64
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp)
    pos = rng.integers(0, maxp * ps, b).astype(np.int32)
    pt = torch.from_numpy(table.astype(np.int32)).to(card)
    pos_t = torch.from_numpy(pos).to(card)
    kq, vq, ks, vs = _int8_pools(rng, 1 + b * maxp, ps, nh, dh, card)
    calls = []
    for dtype in (torch.bfloat16, torch.float32):
        kp, vp = _pools(rng, 1 + b * maxp, ps, nh, dh, card, dtype)
        q = torch.from_numpy(rng.standard_normal(
            (b, nh, dh), dtype=np.float32)).to(card, dtype)
        calls += [((q, kp, vp, pt, pos_t), cdec.paged_decode),
                  ((q, kq, vq, ks, vs, pt, pos_t), cdec.paged_decode_int8)]
    sm = torch.cuda.get_device_properties(card).multi_processor_count
    assert cdec.splits(b, nh, maxp, ps, sm) > 1
    refs = [pa._plain_paged_attention(*args[:3], pt, pos_t, *args[3:-2])
            for args, _ in calls]
    outs = [fn(*args) for _ in range(3) for args, fn in calls]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        j = i % len(calls)
        tol = 2e-5 if out.dtype == torch.float32 else 2e-2
        assert (out.float() - refs[j].float()).abs().max().item() <= tol, i
        assert torch.equal(out, outs[j])
    stream = torch.cuda.current_stream(card).cuda_stream
    assert int(cdec._tickets(card, b * nh, stream).abs().sum()) == 0


def test_int8_wrappers_refuse_float_pools_on_the_card(card):
    q = torch.zeros(2, 2, 8, device=card)
    kp = torch.zeros(5, 4, 2, 8, device=card)
    ks = torch.ones(5, 4, 2, device=card)
    pt = torch.zeros(2, 2, dtype=torch.int32, device=card)
    pos = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="takes int8 pools"):
        cdec.paged_decode_int8(q, kp, kp.clone(), ks, ks.clone(), pt, pos)
    with pytest.raises(ValueError, match="need their k_scale"):
        cdec.paged_decode(q, kp.to(torch.int8), kp.to(torch.int8), pt, pos)
    with pytest.raises(ValueError, match="k_scale must be"):
        cpre.paged_prefill_int8(q, kp.to(torch.int8), kp.to(torch.int8),
                                ks[:, :2], ks.clone(), pt[0], 0, 2)


def _small_model():
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2,
                    num_heads=2, intermediate_size=128,
                    max_position_embeddings=128)
    return GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("quant", [{}, {"kv_dtype": "int8"},
                                   {"kv_dtype": "int8",
                                    "weight_dtype": "int8"}])
def test_card_engine_matches_cpu_engine(card, quant):
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    model = _small_model()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (3, 19, 40)]
    ecfg = EngineConfig(page_size=16, max_slots=2, prefill_chunk_tokens=16,
                        **quant)
    outs = []
    for dev in ("cpu", "cuda"):
        eng = DecodeEngine(model, ecfg, device=dev)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle(max_steps=200)
        outs.append([r.result(timeout=0) for r in reqs])
        assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", [{}, {"kv_dtype": "int8"}])
def test_card_prefix_hit_matches_cpu_engine(card, quant, tmp_path):
    """Prefix hits on the card: a shared system prompt's pages attached by
    reference and the tails prefilled at start > 0, then the same pages
    demoted to a host tier and re-uploaded: tokens and prefix counters
    equal to the CPU engine's on the same trace."""
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    model = _small_model()
    rng = np.random.default_rng(5)
    system = rng.integers(0, 97, 48).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 97, n).astype(
        np.int32)]) for n in (5, 17, 40)]
    ecfg = EngineConfig(page_size=16, max_slots=4,
                        kv_host_tier_bytes=1 << 24, **quant)
    keys = ("prefix_hit", "prefix_miss", "prefix_pages_reused",
            "prefill_tokens", "kvtier_reuploads_host")
    outs, counts = [], []
    for dev in ("cpu", "cuda"):
        eng = DecodeEngine(model, ecfg, device=dev)
        got = []
        for wave in ([system], prompts):
            reqs = [eng.submit(p, max_new_tokens=8) for p in wave]
            eng.run_until_idle(max_steps=200)
            got += [r.result(timeout=0) for r in reqs]
            idle = eng._evict_prefix_pages(len(eng._prefix_idle))
            eng.allocator.reclaim(idle)        # demote to the host tier
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle(max_steps=200)
        got += [r.result(timeout=0) for r in reqs]
        outs.append(got)
        counts.append({k: eng.counters[k] for k in keys})
        assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert counts[0] == counts[1]
    assert counts[1]["prefix_hit"] >= 4
    assert counts[1]["kvtier_reuploads_host"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_export_import_pages_round_trip_on_the_card(card, dtype):
    """`export_pages` then `import_pages` into other pages of the same
    pools, on the card: byte for byte, values and int8 scales, and the
    pools keep their identity (written in place)."""
    from paddle_tpu_torch.kernels.paged_attention import (export_pages,
                                                          import_pages)
    g = torch.Generator(device=card).manual_seed(0)
    shape = (3, 12, 16, 4, 64)                   # [nl, P, ps, nh, dh]
    if dtype == torch.int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device=card,
                                dtype=torch.int8) for _ in range(2))
        scales = tuple(torch.rand(shape[:4], generator=g, device=card)
                       for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=g, device=card).to(dtype)
                  for _ in range(2))
        scales = ()
    src, dst = [2, 5, 7], [9, 1, 11]
    blobs = [b.cpu() for b in export_pages(kp, vp, src, *scales)]
    ptrs = [t.data_ptr() for t in (kp, vp, *scales)]
    out = import_pages(kp, vp, *blobs[:2], dst, *scales, *blobs[2:])
    assert [t.data_ptr() for t in out] == ptrs
    for pool, blob in zip((kp, vp, *scales), blobs):
        assert torch.equal(pool[:, dst].cpu(), blob)
        assert torch.equal(pool[:, src], pool[:, dst])


# ------------------------------------------------------------ flash attention
# (bh, sq, sk, d, causal): ragged S, Sq < Sk bottom-right, head dims of
# every template width, a tail shorter than a tile
FLASH_CASES = [(3, 200, 200, 64, True), (2, 64, 300, 64, True),
               (2, 130, 70, 32, False), (1, 77, 77, 128, True),
               (2, 33, 90, 16, True), (1, 65, 65, 256, False),
               (4, 1, 1, 64, True)]


def _flash_inputs(case, dev, dtype, seed=0):
    bh, sq, sk, d, _ = case
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, dtype)
    return t(bh, sq, d), t(bh, sk, d), t(bh, sk, d), t(bh, sq, d)


def _flash_tol(dtype, ref, f32_tol):
    """f32: the stated bound, scaled by the largest value when that exceeds
    1; bf16: one bf16 step of the largest value (both sides round an f32
    result to bf16), and never less than the f32 bound."""
    big = ref.float().abs().max().item()
    f32 = f32_tol * max(1.0, big)
    return f32 if dtype == torch.float32 else max(f32, 2.0 ** -7 * big)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(card, dtype, case):
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    causal = case[4]
    scale = 1.0 / np.sqrt(case[3])
    q, k, v, do = _flash_inputs(case, card, dtype)
    out, lse = cfa.flash_fwd(q, k, v, scale, causal)
    torch.cuda.synchronize()
    rout, rlse = tfa._plain_flash_fwd(q, k, v, scale, causal)
    err = (out.float() - rout.float()).abs().max().item()
    assert err <= _flash_tol(dtype, rout, 2e-5)
    assert (lse - rlse).abs().max().item() <= 2e-5 * max(
        1.0, rlse.abs().max().item())
    delta = (do.float() * rout.float()).sum(-1)
    dq = cfa.flash_dq(q, k, v, do, rlse, delta, scale, causal)
    dk, dv = cfa.flash_dkv(q, k, v, do, rlse, delta, scale, causal)
    torch.cuda.synchronize()
    rdq = tfa._plain_flash_dq(q, k, v, do, rlse, delta, scale, causal)
    rdk, rdv = tfa._plain_flash_dkv(q, k, v, do, rlse, delta, scale, causal)
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= _flash_tol(dtype, ref, 1e-4), err
    # each output element is written by one block: runs repeat bit for bit
    assert torch.equal(cfa.flash_dkv(q, k, v, do, rlse, delta, scale,
                                     causal)[0], dk)


# (bh, sq, sk, causal): square causal, ragged (a tail shorter than a query
# tile and a key tile), cross-length bottom-right, non-causal Sq > Sk
MMA_FLASH_SHAPES = [(4, 256, 256, True), (3, 200, 200, True),
                    (2, 64, 300, True), (2, 130, 70, False),
                    (2, 100, 333, False)]


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 72])
def test_flash_fwd_tensor_core_arm_matches_plain(card, d):
    """bf16 with d a multiple of 16 up to 128 takes the tensor-core loop
    (one launch a call), d=72 the CUDA-core loop; out within one bf16 step
    of the largest reference value, lse within 2e-5 relative (f32 on both
    sides, p kept in f32 for the row sum)."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    assert cfa.arm(torch.bfloat16, d) == ("cuda_core" if d == 72
                                          else "mma_bf16")
    assert cfa.arm(torch.float32, d) == "cuda_core"
    for i, (bh, sq, sk, causal) in enumerate(MMA_FLASH_SHAPES):
        q, k, v, _ = _flash_inputs((bh, sq, sk, d, causal), card,
                                   torch.bfloat16, seed=d + i)
        scale = 1.0 / np.sqrt(d)
        before = cfa.FWD.launches
        out, lse = cfa.flash_fwd(q, k, v, scale, causal)
        assert cfa.FWD.launches == before + 1
        torch.cuda.synchronize()
        rout, rlse = tfa._plain_flash_fwd(q, k, v, scale, causal)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        err = (out.float() - rout.float()).abs().max().item()
        assert err <= _flash_tol(torch.bfloat16, rout, 2e-5), (i, err)
        assert (lse - rlse).abs().max().item() <= 2e-5 * max(
            1.0, rlse.abs().max().item()), i


def test_flash_fwd_tensor_core_arm_refuses_misaligned_q(card):
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    buf = torch.zeros(2 * 64 * 64 + 4, dtype=torch.bfloat16, device=card)
    q = buf[4:].view(2, 64, 64)            # 8 bytes past the allocation
    k = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device=card)
    assert q.data_ptr() % 16 == 8
    before = cfa.FWD.launches
    with pytest.raises(ValueError, match="16-byte boundaries"):
        cfa.flash_fwd(q, k, k, 0.125, True)
    assert cfa.FWD.launches == before
    assert cfa.grid(96, 1024, torch.bfloat16, 64) == (96, 8)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 72])
def test_flash_dkv_tensor_core_arm_matches_plain(card, d):
    """bf16 with d a multiple of 16 up to 128 takes the tensor-core dK/dV
    loop (one launch a call), d=72 the CUDA-core loop; dk and dv within one
    bf16 step of the largest reference value over the causal, ragged,
    cross-length and non-causal shapes, and a second call equal bit for
    bit (no atomics)."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    assert cfa.dkv_arm(torch.bfloat16, d) == ("cuda_core" if d == 72
                                              else "mma_bf16")
    assert cfa.dkv_arm(torch.float32, d) == "cuda_core"
    for i, (bh, sq, sk, causal) in enumerate(MMA_FLASH_SHAPES):
        q, k, v, do = _flash_inputs((bh, sq, sk, d, causal), card,
                                    torch.bfloat16, seed=100 + d + i)
        scale = 1.0 / np.sqrt(d)
        rout, rlse = tfa._plain_flash_fwd(q, k, v, scale, causal)
        delta = (do.float() * rout.float()).sum(-1)
        before = cfa.DKV.launches
        dk, dv = cfa.flash_dkv(q, k, v, do, rlse, delta, scale, causal)
        assert cfa.DKV.launches == before + 1
        torch.cuda.synchronize()
        rdk, rdv = tfa._plain_flash_dkv(q, k, v, do, rlse, delta, scale,
                                        causal)
        for got, ref in ((dk, rdk), (dv, rdv)):
            assert got.dtype == torch.bfloat16
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= _flash_tol(torch.bfloat16, ref, 1e-4), (i, err)
        again = cfa.flash_dkv(q, k, v, do, rlse, delta, scale, causal)
        assert torch.equal(again[0], dk) and torch.equal(again[1], dv)


def test_flash_dkv_tensor_core_arm_refuses_misaligned_do(card):
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    buf = torch.zeros(2 * 64 * 64 + 4, dtype=torch.bfloat16, device=card)
    do = buf[4:].view(2, 64, 64)           # 8 bytes past the allocation
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device=card)
    lse = torch.zeros(2, 64, device=card)
    assert do.data_ptr() % 16 == 8
    before = cfa.DKV.launches
    with pytest.raises(ValueError, match="do must start on 16-byte"):
        cfa.flash_dkv(q, q, q, do, lse, lse, 0.125, True)
    assert cfa.DKV.launches == before
    assert cfa.dkv_grid(96, 1024, torch.bfloat16, 64) == (96, 16)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 72])
def test_flash_dq_tensor_core_arm_matches_plain(card, d):
    """bf16 with d a multiple of 16 up to 128 takes the tensor-core dQ loop
    (one launch a call), d=72 and float32 the CUDA-core loop; dq within
    one bf16 step of the largest reference value over the causal, ragged,
    cross-length and non-causal shapes, and a second call equal bit for
    bit (no atomics)."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    assert cfa.dq_arm(torch.bfloat16, d) == ("cuda_core" if d == 72
                                             else "mma_bf16")
    assert cfa.dq_arm(torch.float32, d) == "cuda_core"
    for i, (bh, sq, sk, causal) in enumerate(MMA_FLASH_SHAPES):
        q, k, v, do = _flash_inputs((bh, sq, sk, d, causal), card,
                                    torch.bfloat16, seed=200 + d + i)
        scale = 1.0 / np.sqrt(d)
        rout, rlse = tfa._plain_flash_fwd(q, k, v, scale, causal)
        delta = (do.float() * rout.float()).sum(-1)
        before = cfa.DQ.launches
        dq = cfa.flash_dq(q, k, v, do, rlse, delta, scale, causal)
        assert cfa.DQ.launches == before + 1
        torch.cuda.synchronize()
        ref = tfa._plain_flash_dq(q, k, v, do, rlse, delta, scale, causal)
        assert dq.dtype == torch.bfloat16
        err = (dq.float() - ref.float()).abs().max().item()
        assert err <= _flash_tol(torch.bfloat16, ref, 1e-4), (i, err)
        assert torch.equal(cfa.flash_dq(q, k, v, do, rlse, delta, scale,
                                        causal), dq)


def test_flash_dq_tensor_core_arm_refuses_misaligned_do(card):
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    buf = torch.zeros(2 * 64 * 64 + 4, dtype=torch.bfloat16, device=card)
    do = buf[4:].view(2, 64, 64)           # 8 bytes past the allocation
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device=card)
    lse = torch.zeros(2, 64, device=card)
    assert do.data_ptr() % 16 == 8
    before = cfa.DQ.launches
    with pytest.raises(ValueError, match="do must start on 16-byte"):
        cfa.flash_dq(q, q, q, do, lse, lse, 0.125, True)
    assert cfa.DQ.launches == before
    assert cfa.dq_grid(96, 1024, torch.bfloat16, 64) == (96, 8)


# The register-tiled CUDA-core loops of flash_fwd.cu and flash_dkv.cu: f32
# at every head-dim class (not a multiple of 4, of 8, of 16; above 128 with
# 32-key tiles; the one-stage dK/dV ring above D=112), bf16 where it does
# not take the tensor cores, at a ragged causal, a cross-length causal and
# a non-causal Sq > Sk shape. (dtype, d) pairs:
CORE_FLASH_DIMS = [(torch.float32, d) for d in
                   (16, 33, 40, 64, 72, 80, 128, 200, 256)] + \
                  [(torch.bfloat16, d) for d in (33, 40, 72, 200, 256)]
CORE_FLASH_SHAPES = [(2, 200, 200, True), (2, 64, 300, True),
                     (2, 130, 70, False)]


def _core_flash_check(cfa, tfa, q, k, v, do, causal):
    """Forward (out, lse), dK/dV and dQ of the CUDA-core loops against the
    plain versions; dQ on the kernel forward's lse. Returns the kernels'
    outputs."""
    dtype, d = q.dtype, q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    assert cfa.arm(dtype, d) == cfa.dkv_arm(dtype, d) == "cuda_core"
    out, lse = cfa.flash_fwd(q, k, v, scale, causal)
    torch.cuda.synchronize()
    rout, rlse = tfa._plain_flash_fwd(q, k, v, scale, causal)
    assert out.dtype == dtype
    err = (out.float() - rout.float()).abs().max().item()
    assert err <= _flash_tol(dtype, rout, 2e-5), ("out", err)
    err = (lse - rlse).abs().max().item()
    assert err <= 2e-5 * max(1.0, rlse.abs().max().item()), ("lse", err)
    delta = (do.float() * rout.float()).sum(-1)
    dk, dv = cfa.flash_dkv(q, k, v, do, rlse, delta, scale, causal)
    dq = cfa.flash_dq(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    rdk, rdv = tfa._plain_flash_dkv(q, k, v, do, rlse, delta, scale, causal)
    rdq = tfa._plain_flash_dq(q, k, v, do, rlse, delta, scale, causal)
    for name, got, ref in (("dk", dk, rdk), ("dv", dv, rdv), ("dq", dq, rdq)):
        assert got.dtype == dtype
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= _flash_tol(dtype, ref, 1e-4), (name, err)
    return out, lse, dk, dv, delta


@pytest.mark.parametrize("shape", CORE_FLASH_SHAPES)
@pytest.mark.parametrize("dtype,d", CORE_FLASH_DIMS)
def test_flash_core_loops_match_plain(card, dtype, d, shape):
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    bh, sq, sk, causal = shape
    q, k, v, do = _flash_inputs((bh, sq, sk, d, causal), card, dtype,
                                seed=d + sq)
    before = (cfa.FWD.launches, cfa.DKV.launches)
    out, lse, dk, dv, delta = _core_flash_check(cfa, tfa, q, k, v, do,
                                                causal)
    assert (cfa.FWD.launches, cfa.DKV.launches) == (before[0] + 1,
                                                    before[1] + 1)
    # no atomics, one writer a value: runs repeat bit for bit
    scale = 1.0 / np.sqrt(d)
    out2, lse2 = cfa.flash_fwd(q, k, v, scale, causal)
    rlse = tfa._plain_flash_fwd(q, k, v, scale, causal)[1]
    dk2, dv2 = cfa.flash_dkv(q, k, v, do, rlse, delta, scale, causal)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


@pytest.mark.parametrize("dtype,d,shift", [(torch.float32, 64, 1),
                                           (torch.float32, 33, 3),
                                           (torch.float32, 72, 2),
                                           (torch.bfloat16, 72, 1)])
def test_flash_core_loops_take_misaligned_tensors(card, dtype, d, shift):
    """Every input `shift` elements past a 16-byte boundary (4, 12 or 8
    bytes for f32, 2 for bf16): the copies narrow to what the alignment
    allows, and nothing is refused."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    bh, sq, sk, causal = 3, 150, 150, True
    q, k, v, do = _flash_inputs((bh, sq, sk, d, causal), card, dtype, seed=9)

    def shifted(t):
        buf = torch.empty(t.numel() + shift, dtype=dtype, device=card)
        out = buf[shift:].view(t.shape)
        out.copy_(t)
        return out
    q, k, v, do = (shifted(t) for t in (q, k, v, do))
    assert q.data_ptr() % 16 == shift * q.element_size()
    _core_flash_check(cfa, tfa, q, k, v, do, causal)


def test_flash_core_layouts_match_the_kernels(card):
    """The card takes the largest CUDA-core block the wrapper's layout
    mirrors describe (`tests/test_torch_flash_core.py` holds them against
    the kernels' formulas on the CPU)."""
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    props = torch.cuda.get_device_properties(card)
    limit = getattr(props, "shared_memory_per_block_optin", cfa.MAX_SMEM)
    assert max(max(cfa.core_fwd_smem(d), cfa.core_dkv_layout(d)[1],
                   cfa.core_dq_layout(d)[2])
               for d in range(1, 257)) <= cfa.MAX_SMEM <= limit


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.float32, 33),
                                     (torch.bfloat16, 40),
                                     (torch.bfloat16, 200)])
def test_flash_dq_core_loop_repeats_bit_for_bit(card, dtype, d):
    """The CUDA-core dQ loop (f32, and bf16 at head dims the tensor cores
    refuse): one DQ launch a call, each dq row written by one block, so
    two calls give the same bits."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    bh, sq, sk, causal = 3, 200, 200, True
    assert cfa.dq_arm(dtype, d) == "cuda_core"
    q, k, v, do = _flash_inputs((bh, sq, sk, d, causal), card, dtype,
                                seed=d + 5)
    scale = 1.0 / np.sqrt(d)
    rout, rlse = tfa._plain_flash_fwd(q, k, v, scale, causal)
    delta = (do.float() * rout.float()).sum(-1)
    before = cfa.DQ.launches
    dq = cfa.flash_dq(q, k, v, do, rlse, delta, scale, causal)
    assert cfa.DQ.launches == before + 1
    dq2 = cfa.flash_dq(q, k, v, do, rlse, delta, scale, causal)
    assert cfa.DQ.launches == before + 2
    torch.cuda.synchronize()
    assert dq.dtype == dtype and torch.equal(dq, dq2)
    ref = tfa._plain_flash_dq(q, k, v, do, rlse, delta, scale, causal)
    err = (dq.float() - ref.float()).abs().max().item()
    assert err <= _flash_tol(dtype, ref, 1e-4), err


@pytest.mark.parametrize("dtype,d", [(torch.float32, 240),
                                     (torch.float32, 241),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 256)])
def test_flash_dq_core_loop_cross_length_causal_wide(card, dtype, d):
    """Cross-length causal (the bottom-right diagonal, Sk - Sq = 203) with
    ragged query and key tails at the widest head dims: 32-key tiles, the
    K ring at two stages (D=240) and one (D=241, 256)."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    bh, sq, sk, causal = 2, 130, 333, True
    assert cfa.core_dq_layout(d)[0] == (2 if d <= 240 else 1)
    q, k, v, do = _flash_inputs((bh, sq, sk, d, causal), card, dtype,
                                seed=d)
    scale = 1.0 / np.sqrt(d)
    rout, rlse = tfa._plain_flash_fwd(q, k, v, scale, causal)
    delta = (do.float() * rout.float()).sum(-1)
    dq = cfa.flash_dq(q, k, v, do, rlse, delta, scale, causal)
    torch.cuda.synchronize()
    ref = tfa._plain_flash_dq(q, k, v, do, rlse, delta, scale, causal)
    err = (dq.float() - ref.float()).abs().max().item()
    assert err <= _flash_tol(dtype, ref, 1e-4), err


def test_flash_op_takes_the_kernels_forward_and_backward(card):
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    q, k, v, do = _flash_inputs((6, 96, 96, 64, True), card, torch.float32)
    ins = [t.reshape(2, 3, 96, 64).requires_grad_(True) for t in (q, k, v)]
    before = [kern.launches for kern in (cfa.FWD, cfa.DQ, cfa.DKV)]
    registry.reset_counts()
    out = tfa.flash_attention(*ins, causal=True)
    out.backward(do.reshape(2, 3, 96, 64))
    assert [kern.launches for kern in (cfa.FWD, cfa.DQ, cfa.DKV)] == \
        [b + 1 for b in before]
    assert registry.counts() == {"kernel.dispatch.flash_attention.cuda": 1}
    cpu = [t.detach().cpu().requires_grad_(True) for t in ins]
    ref = tfa.flash_attention(*cpu, causal=True)
    ref.backward(do.cpu().reshape(2, 3, 96, 64))
    assert (out.detach().cpu() - ref.detach()).abs().max().item() <= 2e-5
    for a, b in zip(ins, cpu):
        assert (a.grad.cpu() - b.grad).abs().max().item() <= 1e-4


def test_fused_ce_on_the_card_matches_the_cpu(card):
    from paddle_tpu_torch.kernels.fused_ce import fused_linear_cross_entropy
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal((64, 96), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((12288, 96), dtype=np.float32)
                         * 0.1)
    labels = torch.from_numpy(rng.integers(0, 12288, 64))
    labels[3] = -100
    got, ref = [], []
    for dev, out in (("cuda", got), ("cpu", ref)):
        hh = h.to(dev).requires_grad_(True)
        ww = w.to(dev).requires_grad_(True)
        loss = fused_linear_cross_entropy(hh, ww, labels.to(dev))
        loss.mean().backward()
        out.extend(t.detach().cpu() for t in (loss, hh.grad, ww.grad))
    # f32 results of bf16 products on both devices, summed in other orders
    assert (got[0] - ref[0]).abs().max().item() <= 1e-4
    for a, b in zip(got[1:], ref[1:]):
        assert (a - b).abs().max().item() <= 2.0 ** -8 * b.abs().max().item()


# fused layernorm: d of every width the kernels choose (64: a warp a row,
# one chunk a lane; 1000: not a multiple of the bf16 16-byte chunk; 1001:
# odd, the scalar path; 1024: the widest row a warp holds; 1025: the
# narrowest a team of warps holds, on the scalar path; 4096: a team of 8
# warps; 8192: of 16), n of one row, fewer rows than a block has warps
# (5), a ragged last backward block (300 = 9 x 32 + 12) and the train
# shape's 8192 rows
LN_DS = [64, 768, 1000, 1001, 1024, 1025, 4096, 8192]
LN_NS = [1, 5, 300, 8192]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", LN_DS)
@pytest.mark.parametrize("n", LN_NS)
def test_fused_layernorm_kernels_match_plain(card, dtype, d, n):
    """Forward: y within 2e-5 (f32) or one bf16 step of the largest value,
    mean and rstd within 2e-5 relative (f32 sums in another order; rstd by
    the card's rsqrtf). Backward, from the same statistics: dx within 1e-4
    (f32) or one bf16 step, the dgamma/dbeta partials of the same blocks
    of cln.ROWS_PER_BLOCK rows within 1e-4 relative."""
    from paddle_tpu_torch.kernels import fused_layernorm as fln
    from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln
    rng = np.random.default_rng(d + n)

    def t(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(card, dt)
    x, dy = t(n, d) * 2 + 0.5, t(n, d)
    gamma, beta = t(d, dt=torch.float32), t(d, dt=torch.float32)
    y, mu, rstd = cln.fused_layernorm_fwd(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    ry, rmu, rrs = fln._plain_ln_fwd(x, gamma, beta, 1e-5)
    assert y.dtype == dtype and mu.shape == rstd.shape == (n, 1)
    assert (y.float() - ry.float()).abs().max().item() <= _flash_tol(
        dtype, ry, 2e-5)
    for got, ref in ((mu, rmu), (rstd, rrs)):
        assert (got - ref).abs().max().item() <= 2e-5 * max(
            1.0, ref.abs().max().item())
    dx, dg, db = cln.fused_layernorm_bwd(x, gamma, rmu, rrs, dy)
    torch.cuda.synchronize()
    rdx, rdg, rdb = fln._plain_ln_bwd(x, gamma, rmu, rrs, dy,
                                      block_rows=cln.ROWS_PER_BLOCK)
    assert dx.dtype == dtype and dg.shape == rdg.shape == (
        -(-n // cln.ROWS_PER_BLOCK), d)
    assert (dx.float() - rdx.float()).abs().max().item() <= _flash_tol(
        dtype, rdx, 1e-4)
    for got, ref in ((dg, rdg), (db, rdb)):
        assert (got - ref).abs().max().item() <= 1e-4 * max(
            1.0, ref.abs().max().item())


def test_fused_layernorm_kernels_take_bf16_gamma(card):
    from paddle_tpu_torch.kernels import fused_layernorm as fln
    from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(37, 768, generator=g).to(card, torch.bfloat16)
    gamma, beta = (torch.randn(768, generator=g).to(card, torch.bfloat16)
                   for _ in "gb")
    y, mu, rstd = cln.fused_layernorm_fwd(x, gamma, beta, 1e-5)
    ry, _, _ = fln._plain_ln_fwd(x, gamma, beta, 1e-5)
    assert (y.float() - ry.float()).abs().max().item() <= _flash_tol(
        torch.bfloat16, ry, 2e-5)
    dx, dg, _ = cln.fused_layernorm_bwd(x, gamma, mu, rstd, x)
    rdx, rdg, _ = fln._plain_ln_bwd(x, gamma, mu, rstd, x,
                                    block_rows=cln.ROWS_PER_BLOCK)
    assert (dx.float() - rdx.float()).abs().max().item() <= _flash_tol(
        torch.bfloat16, rdx, 1e-4)
    assert (dg - rdg).abs().max().item() <= 1e-4 * rdg.abs().max().item()


def _ln_case(card, dtype, n, d, seed, offset_bytes=0):
    """x, dy [n, d] and f32 gamma, beta [d], each a contiguous view
    ``offset_bytes`` into a larger buffer of its dtype, whose elements
    before and after the view (16 bytes' worth after) are NaN: a kernel
    that used a byte outside its tensor would show it."""
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        size, off = int(np.prod(shape)), offset_bytes // dt.itemsize
        buf = torch.full((off + size + 16 // dt.itemsize,), float("nan"),
                         dtype=dt, device=card)
        buf[off:off + size] = torch.from_numpy(rng.standard_normal(
            size, dtype=np.float32)).to(card, dt)
        return buf[off:off + size].view(*shape)
    return t(n, d), t(n, d), t(d, dt=torch.float32), t(d, dt=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [768, 1001, 1024, 4096])
def test_fused_layernorm_kernels_take_tensors_off_16_bytes(card, dtype, d):
    """x, dy, gamma and beta 4 bytes off a 16-byte boundary take the scalar
    path, within the bounds of test_fused_layernorm_kernels_match_plain;
    the NaNs around each tensor stay out of every output."""
    from paddle_tpu_torch.kernels import fused_layernorm as fln
    from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln
    x, dy, gamma, beta = _ln_case(card, dtype, 300, d, d, offset_bytes=4)
    assert all(t.data_ptr() % 16 == 4 for t in (x, dy, gamma, beta))
    y, mu, rstd = cln.fused_layernorm_fwd(x, gamma, beta, 1e-5)
    dx, dg, db = cln.fused_layernorm_bwd(x, gamma, mu, rstd, dy)
    torch.cuda.synchronize()
    assert all(o.isfinite().all() for o in (y, mu, rstd, dx, dg, db))
    ry, rmu, rrs = fln._plain_ln_fwd(x, gamma, beta, 1e-5)
    rdx, rdg, rdb = fln._plain_ln_bwd(x, gamma, mu, rstd, dy,
                                      block_rows=cln.ROWS_PER_BLOCK)
    assert (y.float() - ry.float()).abs().max().item() <= _flash_tol(
        dtype, ry, 2e-5)
    assert (dx.float() - rdx.float()).abs().max().item() <= _flash_tol(
        dtype, rdx, 1e-4)
    for got, ref, tol in ((mu, rmu, 2e-5), (rstd, rrs, 2e-5), (dg, rdg, 1e-4),
                          (db, rdb, 1e-4)):
        assert (got - ref).abs().max().item() <= tol * max(
            1.0, ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 768, 1001, 1025, 4096, 8192])
def test_fused_layernorm_kernels_repeat_bit_for_bit(card, dtype, d):
    """No atomics and a fixed order of every sum: two calls on the same
    inputs give the same bits of y, mean, rstd, dx and both partials."""
    from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln
    x, dy, gamma, beta = _ln_case(card, dtype, 1000, d, d + 1)
    def run():
        y, mu, rstd = cln.fused_layernorm_fwd(x, gamma, beta, 1e-5)
        return (y, mu, rstd, *cln.fused_layernorm_bwd(x, gamma, mu, rstd, dy))
    first, again = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _rope_tables(s, d, dev, base=10000.0):
    """NeoX cos/sin tables [S, D/2] in f32."""
    inv = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv[None, :]
    return ang.cos().to(dev), ang.sin().to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 6])
@pytest.mark.parametrize("s", [7, 300, 1024])
def test_rotary_kernel_matches_plain(card, dtype, d, s):
    """Both sides round each product and the sum in f32 and store in q's
    dtype: within one f32 ulp of the largest value (1e-6 relative), or one
    bf16 step. D=6 takes the scalar path (D/2 not a multiple of 4)."""
    from paddle_tpu_torch.kernels import rotary as rot
    from paddle_tpu_torch.kernels.cuda import rotary as crot
    rng = np.random.default_rng(s + d)
    q, k = (torch.from_numpy(rng.standard_normal((2, 3, s, d),
                                                 dtype=np.float32)
                             ).to(card, dtype) for _ in "qk")
    cos, sin = _rope_tables(s, d, card)
    qo, ko = crot.rotary(q, k, cos, sin)
    torch.cuda.synchronize()
    rq, rk = rot._plain_rope(q, k, cos, sin)
    for got, ref in ((qo, rq), (ko, rk)):
        assert got.dtype == dtype
        err = (got.float() - ref.float()).abs().max().item()
        big = ref.float().abs().max().item()
        assert err <= (1e-6 * big if dtype == torch.float32
                       else 2.0 ** -7 * big), err
    # bf16 tables take the same path
    qb, _ = crot.rotary(q, k, cos.to(dtype), sin.to(dtype))
    rb, _ = rot._plain_rope(q, k, cos.to(dtype), sin.to(dtype))
    assert (qb.float() - rb.float()).abs().max().item() <= 2.0 ** -7 * \
        rb.float().abs().max().item()


@pytest.mark.parametrize("masked", [True, False])
def test_card_fused_multi_transformer_matches_cpu(card, masked):
    """f32 stack on the card against the same weights on the CPU: with a
    mask both take the plain softmax arm; without, the card runs flash_fwd
    once per layer and the CPU the plain flash. Within 1e-4 of the largest
    value (matrix products and layernorms summed in other orders)."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        cpu = FusedMultiTransformer(64, 4, 128, num_layers=2).eval()
    with tdevice.device_scope(card):
        dev = FusedMultiTransformer(64, 4, 128, num_layers=2).eval()
    dev.set_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 40, 64, generator=g)
    mask = torch.randn(2, 1, 40, 40, generator=g) if masked else None
    before = cfa.FWD.launches
    with torch.no_grad():
        got = dev(x.to(card), attn_mask=None if mask is None
                  else mask.to(card))._data.cpu()
        ref = cpu(x, attn_mask=mask)._data
    assert cfa.FWD.launches - before == (0 if masked else 2)
    assert (got - ref).abs().max().item() <= 1e-4 * max(
        1.0, ref.abs().max().item())


def test_card_fused_layer_norm_and_rope_match_cpu(card):
    """FusedLayerNorm forward (2e-5) and its x / weight / bias gradients
    (1e-4) through the two kernels, and the rope (1e-6), each relative to
    the largest value when above 1; each call dispatches once."""
    from paddle_tpu_torch.incubate.nn import (FusedLayerNorm,
                                              fused_rotary_position_embedding)
    from paddle_tpu_torch.kernels import registry
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn(3, 50, 96, generator=g), torch.randn(3, 50, 96,
                                                            generator=g)
    state = {"weight": torch.randn(96, generator=g),
             "bias": torch.randn(96, generator=g)}
    outs = {}
    registry.reset_counts()
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.core.tensor import Tensor
    for where in ("cpu", card):
        with tdevice.device_scope(where):
            ln = FusedLayerNorm(96)
        ln.set_state_dict(state)
        xx = Tensor(x.to(where), stop_gradient=False)
        y = ln(xx)
        (y * Tensor(w.to(where))).sum().backward()
        outs[str(where)] = [t._data.detach().cpu() for t in
                            (y, xx.grad, ln.weight.grad, ln.bias.grad)]
    for i, (got, ref) in enumerate(zip(outs[str(card)], outs["cpu"])):
        tol = 2e-5 if i == 0 else 1e-4
        assert (got - ref).abs().max().item() <= tol * max(
            1.0, ref.abs().max().item())
    q, k = torch.randn(2, 4, 33, 64, generator=g), torch.randn(
        2, 4, 33, 64, generator=g)
    cos, sin = _rope_tables(33, 64, "cpu")
    ref = [t._data for t in fused_rotary_position_embedding(q, k, cos, sin)]
    got = [t._data for t in fused_rotary_position_embedding(
        q.to(card), k.to(card), cos.to(card), sin.to(card))]
    for a, b in zip(got, ref):
        assert (a.cpu() - b).abs().max().item() <= 1e-6 * max(
            1.0, b.abs().max().item())
    assert registry.counts() == {
        "kernel.dispatch.fused_layernorm.plain": 1,
        "kernel.dispatch.fused_layernorm.cuda": 1,
        "kernel.dispatch.fused_rope.plain": 1,
        "kernel.dispatch.fused_rope.cuda": 1}


# ------------------------------------------------------ sampled serving
# The sampler is the same torch code on both devices (no kernel behind it),
# so these hold the card's arithmetic against the CPU's: bits, uniforms and
# keys exactly; Gumbel values within GUMBEL_CARD_ULPS units in the last
# place at max(|g|, 1), since CUDA's logf and the CPU's log may each round
# one place off in each of the two logs; tokens equal wherever the CPU's
# top-2 margin of the perturbed logits exceeds twice what that allows them
# to move. The JAX algorithm itself is held on the CPU
# (tests/test_torch_sampling.py).
GUMBEL_CARD_ULPS = 4
SAMPLER_PARAMS = [(1.0, 0), (0.8, 40), (1.0, 50), (0.7, 0), (1.3, 5),
                  (1.0, 0), (0.9, 1), (2.0, 1000)]


def _ulp_at(x):
    """One unit in the last place of float32 at max(|x|, 1), per row."""
    big = x.abs().amax(dim=-1).clamp_min(1.0)
    return 2.0 ** (torch.floor(torch.log2(big)) - 23)


def test_card_sampler_matches_cpu(card):
    from paddle_tpu_torch.kernels import prng
    from paddle_tpu_torch.kernels import sampling as smp
    rng = np.random.default_rng(7)
    b, v = len(SAMPLER_PARAMS), 50257
    temps = torch.tensor([t for t, _ in SAMPLER_PARAMS])
    topks = torch.tensor([k for _, k in SAMPLER_PARAMS])
    keys = {"cpu": torch.stack([prng.prng_key(s) for s in range(b)])}
    keys["card"] = keys["cpu"].to(card)
    for _ in range(5):
        lg = torch.from_numpy(rng.standard_normal((b, v), dtype=np.float32)
                              * 2)
        out = {}
        for where, dev in (("cpu", "cpu"), ("card", card)):
            sub = prng.split(keys[where])[:, 1]
            out[where] = [t.cpu() for t in (
                prng.random_bits(sub, (v,)),
                prng.uniform(sub, (v,), np.finfo(np.float32).tiny, 1.0),
                prng.gumbel(sub, (v,)),
                smp.perturbed_logits(lg.to(dev), sub, temps.to(dev),
                                     topks.to(dev)))]
            tok, keys[where] = smp.fused_sample(lg.to(dev), keys[where],
                                                temps.to(dev), topks.to(dev))
            out[where].append(tok.cpu())
        (bits_c, u_c, g_c, p_c, t_c), (bits_g, u_g, g_g, p_g, t_g) = \
            out["cpu"], out["card"]
        assert torch.equal(bits_g, bits_c)
        assert torch.equal(u_g.view(torch.int32), u_c.view(torch.int32))
        assert torch.equal(keys["card"].cpu(), keys["cpu"])
        ulp = _ulp_at(g_c)
        assert ((g_g - g_c).abs().amax(-1) <= GUMBEL_CARD_ULPS * ulp).all()
        top2 = p_c.topk(2, dim=-1).values
        # the perturbed value moves with g, plus one rounding of the sum
        # at the top values (not at the masked -1e30 entries)
        gate = 2 * (GUMBEL_CARD_ULPS * ulp + _ulp_at(top2))
        sure = (top2[:, 0] - top2[:, 1]) > gate
        greedy = (temps == 1.0) & (topks == 0)
        assert torch.equal(t_g[greedy], t_c[greedy])
        assert torch.equal(t_g[sure & ~greedy], t_c[sure & ~greedy])


@pytest.mark.parametrize("spec", [None, 3], ids=["plain", "speculative"])
@pytest.mark.parametrize("quant", [{}, {"kv_dtype": "int8"}],
                         ids=["float", "int8"])
def test_card_sampled_engine_matches_cpu_engine(card, quant, spec):
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    model = _small_model()
    rng = np.random.default_rng(5)
    pattern = rng.integers(0, 97, 6)
    prompts = [np.tile(pattern, r).astype(np.int32) for r in (1, 4, 7)]
    params = [dict(temperature=0.8, top_k=5, seed=1), {},
              dict(temperature=1.2, seed=4)]
    ecfg = EngineConfig(page_size=16, max_slots=2, prefill_chunk_tokens=16,
                        sampling=True, speculate_k=spec, **quant)
    outs = []
    for dev in ("cpu", "cuda"):
        eng = DecodeEngine(model, ecfg, device=dev)
        reqs = [eng.submit(p, max_new_tokens=10, **kw)
                for p, kw in zip(prompts, params)]
        eng.run_until_idle(max_steps=200)
        outs.append([r.result(timeout=0) for r in reqs])
        assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- captured step programs

GRAPH_CASES = {"greedy": {}, "sampled": {"sampling": True},
               "speculative": {"sampling": True, "speculate_k": 3},
               "int8": {"kv_dtype": "int8", "weight_dtype": "int8"}}


def _graph_prompts():
    rng = np.random.default_rng(6)
    pattern = rng.integers(0, 97, 6)
    prompts = [np.tile(pattern, r).astype(np.int32) for r in (1, 4, 7)]
    params = [dict(temperature=0.8, top_k=5, seed=1), {},
              dict(temperature=1.2, seed=4)]
    return prompts, params


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_card_step_is_a_replayed_graph(card, case):
    """`warmup` captures the decode (verify) step as a CUDA graph; serving
    replays it once a step, each replay adding the capture's launches, and
    the tokens equal the CPU engine's."""
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from paddle_tpu_torch.inference.graphs import StepGraph
    from paddle_tpu_torch.kernels import _build
    model = _small_model()
    prompts, params = _graph_prompts()
    ecfg = EngineConfig(page_size=16, max_slots=2, prefill_chunk_tokens=16,
                        prefix_cache=False, **GRAPH_CASES[case])
    if not ecfg.sampling:
        params = [{}] * len(prompts)
    outs = []
    for dev in ("cpu", "cuda"):
        eng = DecodeEngine(model, ecfg, device=dev)
        eng.warmup((8,), ())
        if dev == "cuda":
            key = ("verify", 3) if eng._spec else ("decode", "cuda")
            graph = eng._programs[key]
            assert isinstance(graph, StepGraph)
            for k in _build.kernels():
                k.launches = 0
        reqs = [eng.submit(p, max_new_tokens=10, **kw)
                for p, kw in zip(prompts, params)]
        eng.run_until_idle(max_steps=200)
        outs.append([r.result(timeout=0) for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    steps = eng.counters["steps"]
    assert graph.replays == steps > 0
    assert eng.counters["compile_count"] == len(eng._programs)
    launches = {k.source: k.launches for k in _build.kernels()}
    suffix = "_int8" if eng._quant_kv else ""
    decode = 0 if eng._spec else model.cfg.num_layers * steps
    assert launches["paged_decode" + suffix] == decode
    assert launches["paged_prefill" + suffix] == model.cfg.num_layers * (
        eng.counters["prefills"] + eng.counters["prefill_chunks"])


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_card_graph_replay_equals_the_eager_step(card, case):
    """One step replayed from the graph and the same step run eagerly
    from the same state: tokens, key chains, logits and every pool page
    but the trash page equal."""
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    model = _small_model()
    prompts, params = _graph_prompts()
    ecfg = EngineConfig(page_size=16, max_slots=4, prefix_cache=False,
                        **GRAPH_CASES[case])
    if not ecfg.sampling:
        params = [{}] * len(prompts)
    eng = DecodeEngine(model, ecfg, device="cuda")
    reqs = [eng.submit(p, max_new_tokens=10, **kw)
            for p, kw in zip(prompts, params)]
    eng.step()
    eng.step()
    graph, eager = eng.check_step_graph()
    for k in ("tokens", "keys", "logits"):
        if graph[k] is not None:
            assert torch.equal(graph[k], eager[k]), k
    for a, b in zip(graph["pools"], eager["pools"]):
        # page 0, the trash page, takes colliding masked writes in an
        # unspecified order
        assert torch.equal(a[:, 1:], b[:, 1:])
    eng.run_until_idle(max_steps=200)
    assert all(r.done for r in reqs)


@pytest.mark.parametrize("weight_dtype", ["native", "int8"])
def test_card_refresh_params_reaches_the_captured_graph(card, weight_dtype):
    """`refresh_params` copies into the tensors the graph was captured
    over: the weights keep their addresses, nothing is recaptured, and
    the tokens after it equal a fresh engine's on the new weights."""
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    model = _small_model()
    other = GPTForCausalLM(model.cfg,
                           generator=torch.Generator().manual_seed(9))
    prompts, _ = _graph_prompts()
    ecfg = EngineConfig(page_size=16, max_slots=2, prefix_cache=False,
                        weight_dtype=weight_dtype)

    def serve(eng):
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        eng.run_until_idle(max_steps=200)
        return [r.result(timeout=0) for r in reqs]

    eng = DecodeEngine(model, ecfg, device="cuda")
    first = serve(eng)
    ptrs = {k: getattr(v, "q", v).data_ptr() for k, v in eng._params.items()}
    compiles = eng.counters["compile_count"]
    eng.refresh_params(other)
    assert {k: getattr(v, "q", v).data_ptr()
            for k, v in eng._params.items()} == ptrs
    after = serve(eng)
    assert eng.counters["compile_count"] == compiles
    fresh = serve(DecodeEngine(other, ecfg, device="cuda"))
    for a, b in zip(after, fresh):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(first, after))


@pytest.mark.parametrize("case", ["greedy", "sampled", "int8"])
def test_card_prefill_graph_replays_two_lengths_of_one_bucket(card, case):
    """One captured one-shot prefill graph (bucket 32) replayed for prompts
    of 20 and 29 tokens, and one chunk graph for two tails: each replay
    equals the eager body from the same state (first token, key chains,
    logits, every pool page but the trash page), and no replay recaptures.
    """
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from paddle_tpu_torch.inference.graphs import StepGraph
    model = _small_model()
    ecfg = EngineConfig(page_size=16, max_slots=2, prefix_cache=False,
                        **GRAPH_CASES[case])
    eng = DecodeEngine(model, ecfg, device="cuda")
    eng.warmup(prompt_lens=(20,), tail_lens=(10,))
    compiles = eng.counters["compile_count"]
    entry = eng._programs[("prefill", 32, "cuda")]
    assert isinstance(entry.graph, StepGraph)
    rng = np.random.default_rng(8)
    kw = dict(temperature=0.8, top_k=5, seed=2) if ecfg.sampling else {}
    for n, start in ((20, 0), (29, 0), (40, 30), (45, 32)):
        graph, eager = eng.check_prefill_graph(
            rng.integers(0, 97, n).astype(np.int32), start, **kw)
        for k in ("tokens", "keys", "logits"):
            if graph[k] is not None:
                assert torch.equal(graph[k], eager[k]), (n, start, k)
        for a, b in zip(graph["pools"], eager["pools"]):
            assert torch.equal(a[:, 1:], b[:, 1:]), (n, start)
    assert entry.graph.replays == 2
    assert eng._programs[("prefill_chunk", 16, "cuda")].graph.replays == 2
    assert eng.counters["compile_count"] == compiles


def test_card_prefill_graph_built_mid_serving_leaves_live_slots_alone(card):
    """A prefill graph captured lazily while slot 0 is live and sampling:
    its warm-up and capture runs write the trash page and the key buffer's
    scratch row only, so slot 0's key chain and every other page stay as
    they were, and the engine then serves the CPU engine's tokens."""
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    model = _small_model()
    prompts, params = _graph_prompts()
    ecfg = EngineConfig(page_size=16, max_slots=2, prefix_cache=False,
                        prefill_chunk_tokens=16, sampling=True)
    outs = []
    for dev in ("cpu", "cuda"):
        eng = DecodeEngine(model, ecfg, device=dev)
        reqs = [eng.submit(p, max_new_tokens=10, **kw)
                for p, kw in zip(prompts, params)]
        eng.step()
        eng.step()
        if dev == "cuda":
            assert eng._slot_req[0] is not None and eng._active[0]
            keys = eng._keys_dev.clone()
            pools = [eng._kc.clone(), eng._vc.clone()]
            for build in (lambda: eng._prefill_exe(64),
                          lambda: eng._prefill_chunk_exe(32)):
                assert build().graph is not None
            B = ecfg.max_slots
            assert torch.equal(eng._keys_dev[:B], keys[:B])
            for a, b in zip((eng._kc, eng._vc), pools):
                assert torch.equal(a[:, 1:], b[:, 1:])
        eng.run_until_idle(max_steps=200)
        outs.append([r.result(timeout=0) for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- dropout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [
    ((8, 1024, 768), 0), ((3, 7), 0), ((5, 33), 1), ((4096,), 3),
    ((2, 129, 64), 0)])
def test_dropout_kernel_matches_plain(card, dtype, shape, offset):
    """Bit for bit: the mask (zeros where the plain version drops), the
    output and the gradient, in the vector arm (16 aligned bytes) and the
    one-element arm (a ragged size, or x at an element offset)."""
    from paddle_tpu_torch.kernels import dropout as tdrop
    from paddle_tpu_torch.kernels import prng
    from paddle_tpu_torch.kernels.cuda import dropout as cdrop
    rng = np.random.default_rng(sum(shape) + offset)
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.standard_normal(
        n + offset, dtype=np.float32)).to(card, dtype)
    x = flat[offset:].reshape(shape)
    key = prng.split(prng.prng_key(sum(shape), card), 3)[2]
    before = cdrop.KERNEL.launches
    for p in (0.1, 0.5):
        got = cdrop.dropout(x, key, p)
        want = tdrop._plain_dropout(x, key, p)
        torch.cuda.synchronize()
        assert torch.equal(got == 0, want == 0)
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32))
        cpu = tdrop._plain_dropout(x.cpu(), key.cpu(), p)
        assert torch.equal(got.cpu(), cpu)
    assert cdrop.KERNEL.launches == before + 2


def test_dropout_op_takes_the_kernel_forward_and_backward(card):
    from paddle_tpu_torch.kernels import prng, registry
    from paddle_tpu_torch.kernels.cuda import dropout as cdrop
    from paddle_tpu_torch.kernels.dropout import hidden_dropout
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 96, 768), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 96, 768), dtype=np.float32))
    key = prng.prng_key(9)
    ins = [x.to(card).requires_grad_(True), x.clone().requires_grad_(True)]
    before = cdrop.KERNEL.launches
    registry.reset_counts()
    out = hidden_dropout(ins[0], key.to(card), 0.1)
    out.backward(g.to(card))
    assert cdrop.KERNEL.launches == before + 2
    assert registry.counts() == {"kernel.dispatch.fused_dropout.cuda": 2}
    ref = hidden_dropout(ins[1], key, 0.1)
    ref.backward(g)
    assert torch.equal(out.detach().cpu(), ref.detach())
    assert torch.equal(ins[0].grad.cpu(), ins[1].grad)


@pytest.mark.parametrize("over", [{}, {"recompute": True},
                                  {"recompute_granularity": "mlp"},
                                  {"recompute_granularity": "mlp_up"}],
                         ids=["none", "full_block", "mlp", "mlp_up"])
def test_card_train_forward_with_dropout_matches_cpu(card, over):
    """scan_loss with hidden dropout on the card against the CPU, f32 (the
    flash kernels' bounds), and each recompute setting equal on the card
    to the card's run without it."""
    from paddle_tpu_torch.kernels import prng
    from paddle_tpu_torch.models import gpt as tgpt
    cfg = tgpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=2, intermediate_size=128,
                         max_position_embeddings=64, hidden_dropout=0.1,
                         attention_dropout=0.0, **over)
    base = tgpt.GPTConfig(**dict(cfg.__dict__, recompute=False,
                                 recompute_granularity="full"))
    model = tgpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 256, (2, 65)))
    x, y = ids[:, :-1], ids[:, 1:]

    def run(dev, c):
        stacked = tgpt.stack_gpt_params({
            k: v.to(dev).clone() for k, v in torch_state(model).items()})
        leaves = [stacked[g][k] for g in ("blocks", "top") for k in stacked[g]]
        for t in leaves:
            t.requires_grad_(True)
        loss = tgpt.scan_loss(stacked, x.to(dev), y.to(dev), c,
                              training=True,
                              dropout_key=prng.prng_key(5, dev))
        return loss, torch.autograd.grad(loss, leaves)

    loss, grads = run(card, cfg)
    ref_loss, ref_grads = run("cpu", cfg)
    assert abs(loss.item() - ref_loss.item()) <= 2e-5
    for a, b in zip(grads, ref_grads):
        assert (a.cpu() - b).abs().max().item() <= \
            1e-4 * max(1.0, b.abs().max().item())
    plain_loss, plain_grads = run(card, base)
    assert torch.equal(loss, plain_loss)
    for a, b in zip(grads, plain_grads):
        assert torch.equal(a, b)


# ----------------------------------------------- the in-flight window

def _window_run(eng, lag_cycles=0):
    """Five greedy requests on two slots, two of them submitted mid-run, so
    that admissions and retirements fall inside the window. With
    ``lag_cycles`` every state upload is queued behind a spin of that many
    cycles, so the card runs far behind the host. Returns the outputs, the
    deepest window seen after a step, and whether every state buffer's
    last upload had landed when the host packed into it again."""
    rng = np.random.default_rng(8)
    upload, pack = eng._upload_state, eng._packed_state
    landed = []

    def lagged_upload():
        torch.cuda._sleep(lag_cycles)
        upload()

    def checked_pack(*a):
        pack(*a)
        event = eng._state_uploaded[eng._state_i]
        landed.append(event is None or event.query())

    if lag_cycles:
        eng._upload_state = lagged_upload
    eng._packed_state = checked_pack
    reqs = [eng.submit(rng.integers(0, 97, n).astype(np.int32), new)
            for n, new in ((5, 9), (40, 4), (17, 12))]
    deepest = 0
    for i in range(1000):
        more = eng.step()
        deepest = max(deepest, len(eng._inflight))
        if i == 2:
            reqs += [eng.submit(rng.integers(0, 97, n).astype(np.int32), new)
                     for n, new in ((9, 7), (3, 5))]
        elif not more:
            break
    return [r.result(timeout=0) for r in reqs], deepest, all(landed)


def test_card_window_gives_the_synchronous_tokens_under_a_lagging_stream(
        card):
    """``inflight=3`` against ``inflight=1`` and the CPU engine, with the
    card held ~1 ms behind the host at every step: the tokens are equal,
    the window reaches two steps in flight, and no state buffer is written
    before its last copy to the card has landed (the ring's events)."""
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    model = _small_model()
    outs = {}
    for dev, inflight, lag in (("cpu", 1, 0), ("cuda", 1, 0),
                               ("cuda", 3, 0), ("cuda", 3, 2_000_000)):
        eng = DecodeEngine(model, EngineConfig(
            page_size=16, max_slots=2, prefix_cache=False,
            inflight=inflight), device=dev)
        outs[dev, inflight, lag], deepest, landed = _window_run(eng, lag)
        assert landed
        assert deepest == (2 if inflight == 3 else 0)
        assert len(eng._state_ring) == len(eng._tok_ring) == inflight
        assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    want = outs["cpu", 1, 0]
    for key, got in outs.items():
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b, err_msg=str(key))


def test_card_cancel_and_deadline_keep_the_captured_graphs(card):
    """A cancel mid-decode and a deadline cut under an injected step delay
    on a warm card engine: typed errors, the survivors' tokens equal to
    the CPU engine's, the pool back at its baseline, and no new capture
    (``compile_count`` unchanged)."""
    from paddle_tpu_torch.inference.engine import (Cancelled,
                                                   DeadlineExceeded,
                                                   DecodeEngine, EngineConfig)
    from paddle_tpu_torch.testing import faults
    model = _small_model()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (6, 20, 33)]
    ecfg = EngineConfig(page_size=16, max_slots=4, prefix_cache=True)
    cpu = DecodeEngine(model, ecfg, device="cpu")
    ref = [cpu.submit(p, 12) for p in prompts]
    cpu.run_until_idle(max_steps=200)
    eng = DecodeEngine(model, ecfg, device=card)
    eng.warmup((6, 20, 33), (4,))           # the victim's 4-token tail
    compiles = eng.counters["compile_count"]
    reqs = [eng.submit(p, 12) for p in prompts]
    victim = eng.submit(prompts[1], 40)            # shares prompt 1's pages
    for _ in range(3):
        eng.step()
    assert eng.cancel(victim.request_id, reason="client left")
    with faults.scoped("engine.step_delay", times=-1, delay_s=0.2):
        late = eng.submit(prompts[0], 30, deadline_s=0.5)
        eng.run_until_idle(max_steps=400)
    with pytest.raises(Cancelled, match="client left"):
        victim.result(timeout=0)
    with pytest.raises(DeadlineExceeded, match="deadline"):
        late.result(timeout=0)
    for r, want in zip(reqs, ref):
        np.testing.assert_array_equal(r.result(timeout=0),
                                      want.result(timeout=0))
    assert eng.counters["cancelled"] == eng.counters["deadline_exceeded"] == 1
    assert eng.counters["compile_count"] == compiles
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1


def test_card_serve_loop_captures_an_unwarmed_length_on_its_thread(
        card, tmp_path, monkeypatch):
    """`serve_loop` on a thread that did not build the engine, under its
    watchdog, with requests submitted from this thread while the loop
    captures the prefill graph of a prompt length left unwarmed (the
    submit makes no CUDA call and the capture is thread-local): the
    tokens equal the CPU engine's and `run_until_idle`'s on a second card
    engine, one capture lands inside the loop, the ``engine.*`` counter
    deltas are equal between the two loops, and the healthy loop leaves
    no watchdog dump."""
    import threading

    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.observability.tracing import RequestTrace
    model = _small_model()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 97, n).astype(np.int32)
               for n in (6, 20, 33, 70)]
    ecfg = EngineConfig(page_size=16, max_slots=4, prefix_cache=False)
    cpu = DecodeEngine(model, ecfg, device="cpu")
    ref = [cpu.submit(p, 10) for p in prompts]
    cpu.run_until_idle(max_steps=200)

    def counters(eng):
        return dict(eng.counters)

    direct = DecodeEngine(model, ecfg, device=card)
    direct.warmup((6, 20, 33))
    c0 = counters(direct)
    reqs = [direct.submit(p, 10, RequestTrace()) for p in prompts]
    direct.run_until_idle(max_steps=200)
    want = {k: v - c0[k] for k, v in counters(direct).items()}

    monkeypatch.setenv("PADDLE_WATCHDOG_S", "30")
    monkeypatch.setenv("PADDLE_WATCHDOG_DIR", str(tmp_path))
    eng = DecodeEngine(model, ecfg, device=card)
    eng.warmup((6, 20, 33))                 # 70 (bucket 128) left unwarmed
    torch.cuda.synchronize()
    c0 = counters(eng)
    errors0 = metrics.counter("engine.loop_errors").value
    stop = threading.Event()
    loop = threading.Thread(target=eng.serve_loop, args=(stop,))
    loop.start()
    try:
        looped = [eng.submit(p, 10, RequestTrace()) for p in prompts]
        outs = [r.result(timeout=120) for r in looped]
    finally:
        stop.set()
        loop.join(timeout=120)
    got = {k: v - c0[k] for k, v in counters(eng).items()}
    for a, b, c in zip(outs, reqs, ref, strict=True):
        np.testing.assert_array_equal(a, c.result(timeout=0))
        np.testing.assert_array_equal(a, b.result(timeout=0))
    assert got["compile_count"] == want["compile_count"] == 1
    for k in ("requests", "prefill_tokens", "tokens", "prefills"):
        assert got[k] == want[k], k
    assert metrics.counter("engine.loop_errors").value == errors0
    assert list(tmp_path.iterdir()) == []
    assert not loop.is_alive()


def test_card_train_step_reports_its_mfu(card):
    """The train step on the card: ``train.mfu`` is the step's own MFU
    record (divided by the H100 bf16 peak) and ``train.steps`` counts the
    steps taken."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import ScanTrainStep
    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2, num_heads=2,
                    intermediate_size=128, max_position_embeddings=128,
                    hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(5))
    ts = ScanTrainStep(model, AdamW(learning_rate=1e-3), device=card)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 97, (4, 65))
    x, y = ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)
    s0 = metrics.counter("train.steps").value
    for _ in range(3):
        ts.step(x, y)
    assert metrics.counter("train.steps").value - s0 == 3
    assert metrics.gauge("train.mfu").value == ts.records[-1]["mfu"]
    assert 0 < ts.records[-1]["mfu"] <= 1


# ----------------------------------------------- KV handoff and migration

HANDOFF_CASES = {"float": {}, "int8": {"kv_dtype": "int8"}}


@pytest.mark.parametrize("case", list(HANDOFF_CASES))
def test_card_handoff_round_trip_reaches_the_captured_graph(card, case):
    """`prefill_export` on one card engine, the PTKV1 blob's bytes, then
    `import_request` into a warm decode-only engine: right after the
    import the captured decode graph and the eager step, run from one
    state, give the same tokens, logits and pages (the graph reads the
    pages `import_pages` wrote in place), the tokens equal an
    uninterrupted card engine's and the CPU engine's, the importer built
    no prefill program and both pools end at their baseline."""
    from paddle_tpu_torch.inference.engine import (DecodeEngine, EngineConfig,
                                                   KVHandoff)
    model = _small_model()
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 16, 41)]
    ecfg = EngineConfig(page_size=16, max_slots=4, prefix_cache=False,
                        **HANDOFF_CASES[case])
    refs = []
    for dev in ("cpu", card):
        eng = DecodeEngine(model, ecfg, device=dev)
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        eng.run_until_idle(max_steps=200)
        refs.append([r.result(timeout=0) for r in reqs])
    src = DecodeEngine(model, ecfg, device=card)
    dst = DecodeEngine(model, ecfg, device=card)
    dst.warmup(prompt_lens=())
    pools = [t.data_ptr() for t in (dst._kc, dst._vc)]
    reqs = [dst.import_request(KVHandoff.unpack(src.prefill_export(p).pack()),
                               max_new_tokens=10) for p in prompts]
    graph, eager = dst.check_step_graph()
    for k in ("tokens", "logits"):
        assert torch.equal(graph[k], eager[k]), k
    for a, b in zip(graph["pools"], eager["pools"]):
        assert torch.equal(a[:, 1:], b[:, 1:])
    dst.run_until_idle(max_steps=200)
    for r, card_ref, cpu_ref in zip(reqs, *refs):
        np.testing.assert_array_equal(r.result(timeout=0), card_ref)
        np.testing.assert_array_equal(r.result(timeout=0), cpu_ref)
    assert [t.data_ptr() for t in (dst._kc, dst._vc)] == pools
    assert not any(k[0] in ("prefill", "prefill_chunk")
                   for k in dst._programs)
    for eng in (src, dst):
        assert eng.allocator.free_pages == eng.allocator.num_pages - 1


@pytest.mark.parametrize("case", list(HANDOFF_CASES))
def test_card_sampled_migration_continues_the_chain(card, case):
    """A sampling card engine migrates mid-decode (two steps in flight at
    the drain) through PTMG1 into another: the imported slot's key row is
    the exported chain's two words, and every request's tokens, sampled
    and greedy, warm and cold, equal an uninterrupted card engine's."""
    from paddle_tpu_torch.inference.engine import (DecodeEngine, EngineConfig,
                                                   pack_migration,
                                                   unpack_migration)
    model = _small_model()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 97, n).astype(np.int32)
               for n in (7, 19, 30, 12)]
    params = [dict(temperature=0.8, top_k=5, seed=1), {},
              dict(temperature=1.2, seed=4), dict(temperature=0.9, seed=6)]
    ecfg = EngineConfig(page_size=16, max_slots=3, prefix_cache=False,
                        sampling=True, inflight=3, **HANDOFF_CASES[case])
    ref = DecodeEngine(model, ecfg, device=card)
    want = [ref.submit(p, 12, **kw) for p, kw in zip(prompts, params)]
    ref.run_until_idle(max_steps=200)
    src = DecodeEngine(model, ecfg, device=card)
    dst = DecodeEngine(model, ecfg, device=card)
    reqs = [src.submit(p, 12, **kw) for p, kw in zip(prompts, params)]
    for _ in range(4):
        src.step()
    src.drain(migrate=True)
    src.step()
    taken = src.take_migrated(timeout=30)
    order = [next(j for j, r in enumerate(reqs) if r is i.request)
             for i in taken]
    items = [unpack_migration(pack_migration(i)) for i in taken]
    assert sum(i.handoff is None for i in items) == 1     # the queued one
    answers = {}
    for j, item in zip(order, items):
        if item.handoff is None:
            answers[j] = dst.submit(item.prompt, item.max_new_tokens,
                                    **(item.sample or {}))
        else:
            answers[j] = dst.submit_import(
                item.handoff, max_new_tokens=item.max_new_tokens)
    dst._apply_imports()                     # placed, no step run yet
    for j, item in zip(order, items):
        if item.handoff is not None and item.handoff.sample is not None:
            slot = dst._slot_req.index(answers[j])
            assert dst._keys_dev[slot].tolist() == \
                item.handoff.sample["key"]
    dst.run_until_idle(max_steps=200)
    for j, w in enumerate(want):
        np.testing.assert_array_equal(answers[j].result(timeout=0),
                                      w.result(timeout=0))
    assert not any(r.done for r in reqs)
    for eng in (src, dst):
        assert eng.allocator.free_pages == eng.allocator.num_pages - 1


# ----------------------------------------------------------- the serve tier

def _card_replica(model, card, **ekw):
    """An `InferenceServer` over a card engine, accepting on a thread."""
    import threading

    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from paddle_tpu_torch.inference.serve import InferenceServer
    eng = DecodeEngine(model, EngineConfig(
        page_size=16, max_slots=4, prefix_cache=False, **ekw), device=card)
    srv = InferenceServer(None, engine=eng, auth_name="card-fleet")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv._stop.set()
    srv._engine_thread.join(timeout=60)
    assert not srv._engine_thread.is_alive()
    srv._sock.close()


def _card_refs(model, card, prompts, n):
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    eng = DecodeEngine(model, EngineConfig(page_size=16, max_slots=4,
                                           prefix_cache=False), device=card)
    reqs = [eng.submit(p, max_new_tokens=n) for p in prompts]
    eng.run_until_idle(max_steps=500)
    return [r.result(timeout=0).tolist() for r in reqs]


def test_card_server_answers_concurrent_clients(card):
    """A server over a card engine (its `serve_loop` on the server's
    engine thread, graphs captured there on first use) answers two
    concurrent clients with the in-process card engine's tokens."""
    import threading

    from paddle_tpu_torch.inference.serve import RemotePredictor
    model = _small_model()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (9, 40)]
    want = _card_refs(model, card, prompts, 12)
    srv = _card_replica(model, card)
    outs = [None, None]

    def client(i):
        cli = RemotePredictor(port=srv.port, secret="card-fleet")
        outs[i] = cli.generate(prompts[i], max_new_tokens=12).tolist()
        cli.close()
    try:
        ths = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
            assert not t.is_alive()
        assert outs == want
    finally:
        _stop(srv)


def test_card_wire_migration_resumes_token_identically(card):
    """A request mid-decode on one card replica is migrated over
    OP_MIGRATE to another by `drain(migrate_peers=...)`; the client's
    answer equals the uninterrupted card engine's and both pools end at
    their baseline."""
    import threading

    from paddle_tpu_torch.inference.serve import RemotePredictor
    from paddle_tpu_torch.testing import faults
    model = _small_model()
    prompt = np.arange(3, 30, dtype=np.int32)
    want = _card_refs(model, card, [prompt], 24)[0]
    a, b = _card_replica(model, card), _card_replica(model, card)
    out = {}

    def client():
        cli = RemotePredictor(port=a.port, secret="card-fleet")
        out["x"] = cli.generate(prompt, max_new_tokens=24).tolist()
        cli.close()
    try:
        t = threading.Thread(target=client)
        with faults.scoped("engine.step_delay", times=-1, delay_s=0.02):
            t.start()
            t_end = time.monotonic() + 60
            while not any(r is not None and len(r.generated) >= 3
                          for r in a._engine._slot_req):
                assert time.monotonic() < t_end, "never mid-decode on A"
                time.sleep(0.01)
            assert a.drain(migrate_peers=[f"127.0.0.1:{b.port}"]) is True
        t.join(timeout=120)
        assert not t.is_alive()
        assert out["x"] == want
        assert b._engine.counters["migrations_in"] == 1
        for srv in (a, b):
            assert srv._engine.allocator.free_pages \
                == srv._engine.allocator.num_pages - 1
    finally:
        faults.disarm()
        _stop(b)


def test_card_router_fronts_two_card_replicas(card):
    """A port `Router` in front of two card replicas answers four
    concurrent clients with the in-process card engine's tokens; each
    replica serves a share, and the paged kernels dispatch their cuda arm
    (never the plain one)."""
    import threading

    from paddle_tpu_torch.inference.serve import RemotePredictor
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.serving import Router
    model = _small_model()
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (9, 40, 17,
                                                                  64)]
    want = _card_refs(model, card, prompts, 12)
    reps = [_card_replica(model, card) for _ in range(2)]
    router = Router(replicas={f"r{i}": f"127.0.0.1:{s.port}"
                              for i, s in enumerate(reps)},
                    replica_secret="card-fleet", auth_name="card-front")
    accept = threading.Thread(target=router.serve_forever, daemon=True)
    accept.start()
    before = registry.counts()
    outs = [None] * len(prompts)

    def client(i):
        cli = RemotePredictor(port=router.port, secret="card-front")
        outs[i] = cli.generate(prompts[i], max_new_tokens=12).tolist()
        cli.close()
    try:
        ths = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
            assert not t.is_alive()
        assert outs == want
        served = [s._engine.counters["requests"] for s in reps]
        assert min(served) >= 1 and sum(served) == len(prompts)
        after = registry.counts()
        for op in ("paged_attention", "prefill_attention"):
            key = f"kernel.dispatch.{op}."
            assert after.get(key + "cuda", 0) > before.get(key + "cuda", 0)
            assert after.get(key + "plain", 0) == before.get(key + "plain",
                                                             0)
    finally:
        router.stop()
        accept.join(timeout=10)
        for s in reps:
            _stop(s)


def test_card_engine_warmed_while_another_serves(card):
    """Engines warmed up (their graphs captured on the capture stream) on
    this thread while another engine serves on a thread of its own (its
    graphs replayed on the default stream), at GPT-2 small's width: every
    graph has its own split-loop tickets, and warm-ups, captures and
    replays take turns on the capture stream's cuBLAS workspace, so both
    engines' tokens stay the in-process engine's, and the launch counts
    stay exact."""
    import threading

    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(
        vocab_size=97, hidden_size=768, num_layers=2, num_heads=12,
        intermediate_size=3072, max_position_embeddings=128),
        generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, 97, n).astype(np.int32)
               for n in (9, 40, 17, 64)]
    want = _card_refs(model, card, prompts, 24)
    cfg = EngineConfig(page_size=16, max_slots=4, prefix_cache=False)
    serving = DecodeEngine(model, cfg, device=card)
    serving.warmup(prompt_lens=[len(p) for p in prompts])
    torch.cuda.synchronize()
    rounds, stop = [], threading.Event()

    def serve_rounds():
        while not stop.is_set():
            reqs = [serving.submit(p, max_new_tokens=24) for p in prompts]
            serving.run_until_idle(max_steps=500)
            rounds.append([r.result(timeout=0).tolist() for r in reqs])

    t = threading.Thread(target=serve_rounds)
    for k in _build.kernels():
        k.launches = 0
    c0 = dict(serving.counters)
    t.start()
    built = []
    try:
        for _ in range(3):
            eng = DecodeEngine(model, cfg, device=card)
            eng.warmup(prompt_lens=[len(p) for p in prompts])
            built.append(eng)
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive() and len(rounds) >= 1
    assert all(r == want for r in rounds), [r == want for r in rounds]
    torch.cuda.synchronize()
    nl = model.cfg.num_layers
    ran = {k: serving.counters[k] - c0[k] for k in c0}
    launches = {k.source: k.launches for k in _build.kernels()}
    assert launches["paged_decode"] == nl * ran["steps"]
    assert launches["paged_prefill"] == nl * (ran["prefills"]
                                              + ran["prefill_chunks"])
    last = built[-1]
    reqs = [last.submit(p, max_new_tokens=24) for p in prompts]
    last.run_until_idle(max_steps=500)
    assert [r.result(timeout=0).tolist() for r in reqs] == want


def test_card_connection_threads_launch_no_kernel(card):
    """STATS, PROMETHEUS, PING and DEBUG_DUMP are served on connection
    threads from host state: a burst of them against an idle card replica
    launches no kernel and dispatches no kernel op."""
    from paddle_tpu_torch.inference.serve import RemotePredictor
    from paddle_tpu_torch.kernels import _build, registry
    model = _small_model()
    srv = _card_replica(model, card)
    try:
        cli = RemotePredictor(port=srv.port, secret="card-fleet")
        cli.generate(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)
        t_end = time.monotonic() + 30
        while srv._engine._has_work():
            assert time.monotonic() < t_end
            time.sleep(0.01)
        torch.cuda.synchronize()
        launches = {k.source: k.launches for k in _build.kernels()}
        dispatched = registry.counts()
        for _ in range(20):
            assert "kernel_dispatch_" in cli.prometheus()
            assert cli.stats()["role"] == "both"
            assert cli.ping()
            assert set(cli.debug_dump()) == {"node", "events", "metrics"}
        torch.cuda.synchronize()
        assert {k.source: k.launches for k in _build.kernels()} == launches
        assert registry.counts() == dispatched
        cli.close()
    finally:
        _stop(srv)


# ------------------------------------- fault-tolerant and elastic training


def _card_train_step(card, dtype=torch.bfloat16, reducer=None, seed=5):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    from paddle_tpu_torch.train import ScanTrainStep
    cfg = GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256,
                    max_position_embeddings=128, hidden_dropout=0.1,
                    attention_dropout=0.0)
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(seed))
    sched = LinearWarmup(CosineAnnealingDecay(1e-3, 20), 2, 0.0, 1e-3)
    return ScanTrainStep(model.to(dtype), AdamW(learning_rate=sched,
                                                clip_norm=1.0),
                         microbatches=2, device=card, grad_reducer=reducer)


def _card_batch(i):
    ids = np.random.default_rng(100 + i).integers(0, 97, (4, 129))
    return ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)


def _train(step, steps):
    out = []
    for i in steps:
        out.append(step.step(*_card_batch(i)))
        step.opt.learning_rate.step()
    return out


def test_card_checkpoint_round_trip_is_bit_exact(card, tmp_path):
    """bf16 parameters on f32 masters, hidden dropout and an lr schedule
    on the card: an async checkpoint after 2 steps, restored into a fresh
    step, gives every leaf, the key chain and the schedule back bit for
    bit, and the next steps' losses equal the uninterrupted run's (the
    run repeats itself bit for bit first: two steps from one state)."""
    from paddle_tpu_torch.train import CheckpointManager
    a, b = _card_train_step(card), _card_train_step(card)
    assert _train(a, range(3)) == _train(b, range(3))
    step = _card_train_step(card)
    _train(step, range(2))
    mgr = CheckpointManager(str(tmp_path), step, use_async=True)
    mgr.save(data_cursor=2)
    mgr.wait()
    want = _train(step, range(2, 4))
    fresh = _card_train_step(card, seed=9)
    info = CheckpointManager(str(tmp_path), fresh).restore(require=True)
    assert info["step"] == 2 and info["data_cursor"] == 2
    assert fresh.opt.learning_rate.last_epoch == 2
    got = _train(fresh, range(2, 4))
    assert got == want
    for grp in ("blocks", "top"):
        for k, p in step._params[grp].items():
            assert torch.equal(fresh._params[grp][k], p), k
            assert fresh._params[grp][k].dtype == torch.bfloat16
            for n, v in step._opt_state[grp][k].items():
                assert torch.equal(fresh._opt_state[grp][k][n], v), (k, n)
    assert torch.equal(fresh._key, step._key)


def test_card_split_step_equals_fused(card):
    """The split grads/reduce/apply step with a world-1 reducer on the
    card: losses and parameters bit-equal the fused step's."""
    from paddle_tpu_torch.train import FleetReducer
    fused = _card_train_step(card)
    red = FleetReducer()
    split = _card_train_step(card, reducer=red)
    assert _train(split, range(3)) == _train(fused, range(3))
    assert red.reduces == 3 and red.timings["bytes"] == 0
    for grp in ("blocks", "top"):
        for k, p in fused._params[grp].items():
            assert torch.equal(split._params[grp][k], p), k


# --- the Paddle front end on the card ---------------------------------------

def _eager_pair(card, **over):
    """Two copies of a small GPT Layer, one on the card, one on the CPU,
    with the same weights."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**dict(dict(vocab_size=256, hidden_size=128,
                                num_layers=2, num_heads=2,
                                intermediate_size=256,
                                max_position_embeddings=128,
                                hidden_dropout=0.0, attention_dropout=0.0),
                           **over))
    paddle.seed(0)
    with tdevice.device_scope(card):
        dev = GPTForCausalLM(cfg)
    with tdevice.device_scope("cpu"):
        cpu = GPTForCausalLM(cfg)
    cpu.set_state_dict(dev.state_dict())
    return dev, cpu


def test_card_eager_train_step_matches_cpu(card):
    """Two eager AdamW steps of the Paddle GPT Layer on the card (flash
    forward, dQ and dK/dV kernels) against the CPU: losses within 1e-4;
    all but 0.1% of the parameters' elements within 1e-5, and none beyond
    AdamW's two steps of the rate (an element whose gradient is at
    rounding level may take the other sign's step)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    dev, cpu = _eager_pair(card)
    ids = np.random.default_rng(1).integers(0, 256, (2, 65))
    losses = {}
    before = (cfa.FWD.launches, cfa.DQ.launches, cfa.DKV.launches)
    for where, m in ((card, dev), ("cpu", cpu)):
        opt = paddle.optimizer.AdamW(parameters=m.parameters())
        x = paddle.to_tensor(ids[:, :-1], place=where)
        y = paddle.to_tensor(ids[:, 1:], place=where)
        out = []
        for _ in range(2):
            _, loss = m(x, labels=y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss))
        losses[str(where)] = out
    assert (cfa.FWD.launches - before[0], cfa.DQ.launches - before[1],
            cfa.DKV.launches - before[2]) == (4, 4, 4)
    assert np.allclose(losses[str(card)], losses["cpu"], atol=1e-4)
    diff = torch.cat([(a._data.cpu() - b._data).abs().reshape(-1)
                      for a, b in zip(dev.parameters(), cpu.parameters())])
    assert diff.max().item() <= 2e-3
    assert diff.topk(max(1, diff.numel() // 1000)).values[-1].item() <= 1e-5


def test_card_eager_generate_matches_cpu(card):
    """The Layer's eager generate on the card (flash at Sq = 1 against the
    growing cache) gives the CPU's greedy tokens."""
    import paddle_tpu_torch as paddle
    dev, cpu = _eager_pair(card)
    prompt = np.random.default_rng(2).integers(0, 256, (2, 9))
    got = dev.generate(paddle.to_tensor(prompt, place=card),
                       max_new_tokens=8).numpy()
    want = cpu.generate(paddle.to_tensor(prompt, place="cpu"),
                        max_new_tokens=8).numpy()
    assert np.array_equal(got, want)


# ------------------------------------------------------------ jit.to_static
# A to_static step on the card runs its first EAGER_RUNS calls eagerly on
# the capture stream, then captures one CUDA graph and replays it. Graph
# and eager run the same kernels on the same values (the optimizer's rate
# and step count are device tensors on both paths, the key chain splits on
# the card on both), so they must agree bit for bit.

def _static_gpt(card, amp, **over):
    """A small GPT Layer on the card (head dim 64: the flash kernels'
    tensor-core arms in bfloat16), AdamW, amp O2 bfloat16 when ``amp``,
    and the bench's train step (undecorated)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**dict(dict(vocab_size=512, hidden_size=256,
                                num_layers=2, num_heads=4,
                                intermediate_size=512,
                                max_position_embeddings=128,
                                hidden_dropout=0.0, attention_dropout=0.0),
                           **over))
    paddle.seed(0)
    with tdevice.device_scope(card):
        model = GPTForCausalLM(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
    if amp:
        model, opt = paddle.amp.decorate(model, opt, level="O2",
                                         dtype="bfloat16")

    def step(x, y):
        with paddle.amp.auto_cast(enable=amp, level="O2", dtype="bfloat16"):
            _, loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, step


def _static_batch(card, k=None, b=4, s=128):
    import paddle_tpu_torch as paddle
    ids = np.random.default_rng(3).integers(0, 512, (b, s + 1))
    x, y = ids[:, :-1], ids[:, 1:]
    if k is not None:
        x = np.broadcast_to(x, (k,) + x.shape).copy()
        y = np.broadcast_to(y, (k,) + y.shape).copy()
    return paddle.to_tensor(x, place=card), paddle.to_tensor(y, place=card)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "o2_bf16"])
def test_card_static_graph_equals_eager_steps(card, amp):
    """6 to_static calls (2 eager, the capture, 3 replays) then
    multi_steps(3) against 9 eager steps from the same seed: losses and
    parameters bit for bit; the flash kernels' launches counted through
    the replays (one of each a layer a step)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit.static_function import EAGER_RUNS
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    x, y = _static_batch(card)
    xk, yk = _static_batch(card, k=3)
    model, _, step = _static_gpt(card, amp)
    eager = [step(x, y).numpy() for _ in range(9)]
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    model, _, step = _static_gpt(card, amp)
    static = paddle.jit.to_static(step)
    before = cfa.FWD.launches, cfa.DQ.launches, cfa.DKV.launches
    got = [static(x, y).numpy() for _ in range(6)]
    got += list(static.multi_steps(3)(xk, yk).numpy())
    prog = static.concrete_program(x, y)
    assert prog.graph is not None and prog.graph.replays == 9 - EAGER_RUNS
    assert (cfa.FWD.launches - before[0], cfa.DQ.launches - before[1],
            cfa.DKV.launches - before[2]) == (2 * 9,) * 3
    assert [a.tobytes() for a in got] == [a.tobytes() for a in eager]
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), want[k]), k


def test_card_static_key_chain_and_lr_across_replays(card):
    """Hidden dropout 0.1: 5 static steps equal 5 eager steps bit for bit
    and leave the key chain where the eager run does; a static dropout's
    replays draw a new mask each; a rate set to 0 between replays stops
    the next replay's update."""
    import paddle_tpu_torch as paddle
    x, y = _static_batch(card)
    runs = {}
    for static in (False, True):
        model, opt, step = _static_gpt(card, True, hidden_dropout=0.1)
        fn = paddle.jit.to_static(step) if static else step
        losses = [fn(x, y).numpy().tobytes() for _ in range(5)]
        runs[static] = (losses, paddle.get_rng_state()[0].numpy())
        if static:
            opt.set_lr(0.0)
            w0 = {k: v.numpy() for k, v in model.state_dict().items()}
            fn(x, y)
            assert fn.concrete_program(x, y).graph.replays == 4
            assert all(np.array_equal(v.numpy(), w0[k])
                       for k, v in model.state_dict().items())
    assert runs[True][0] == runs[False][0]
    assert np.array_equal(runs[True][1], runs[False][1])

    @paddle.jit.to_static
    def drop(a):
        return paddle.nn.functional.dropout(a, p=0.5)

    ones = paddle.to_tensor(np.ones((8, 256), np.float32), place=card)
    paddle.seed(1)
    masks = [drop(ones).numpy() for _ in range(5)]
    assert drop.concrete_program(ones).graph.replays == 3
    paddle.seed(1)
    eager = [paddle.nn.functional.dropout(ones, p=0.5).numpy()
             for _ in range(5)]
    assert all(np.array_equal(a, b) for a, b in zip(masks, eager))
    assert all(not np.array_equal(a, b) for a, b in zip(masks, masks[1:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_flash_bert_shape_matches_plain(card, dtype):
    """The flash kernels at BERT-base's training shape (B=128, H=12,
    S=128, D=64, non-causal) against their plain versions."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    case = (128 * 12, 128, 128, 64, False)
    scale = 1.0 / np.sqrt(64)
    q, k, v, do = _flash_inputs(case, card, dtype, seed=5)
    out, lse = cfa.flash_fwd(q, k, v, scale, False)
    rout, rlse = tfa._plain_flash_fwd(q, k, v, scale, False)
    assert (out.float() - rout.float()).abs().max().item() <= \
        _flash_tol(dtype, rout, 2e-5)
    delta = (do.float() * rout.float()).sum(-1)
    dq = cfa.flash_dq(q, k, v, do, rlse, delta, scale, False)
    dk, dv = cfa.flash_dkv(q, k, v, do, rlse, delta, scale, False)
    rdq = tfa._plain_flash_dq(q, k, v, do, rlse, delta, scale, False)
    rdk, rdv = tfa._plain_flash_dkv(q, k, v, do, rlse, delta, scale, False)
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert (got.float() - ref.float()).abs().max().item() <= \
            _flash_tol(dtype, ref, 1e-4)


def test_card_grad_scaler_float16_matches_cpu(card):
    """GradScaler's float16 path on the card, on a model of Linear layers
    (no attention: the flash kernels take no float16, ROADMAP A10),
    against the same run on the CPU: the scale after every update and
    which steps were skipped equal, the weights within 1e-3."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((4, 16)).astype(np.float16) for _ in range(8)]
    for i in (2, 3, 6):
        xs[i][0, 0] = np.inf
    runs = {}
    for where in (card, "cpu"):
        paddle.seed(3)
        with tdevice.device_scope(where):
            model = paddle.nn.Sequential(paddle.nn.Linear(16, 32),
                                         paddle.nn.Linear(32, 4))
        model.to(dtype="float16")
        opt = paddle.optimizer.SGD(learning_rate=1e-2,
                                   parameters=model.parameters())
        scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                       incr_every_n_steps=2,
                                       decr_every_n_nan_or_inf=1)
        scales, moved = [], []
        for x in xs:
            w0 = model[0].weight.numpy().copy()
            with paddle.amp.auto_cast(dtype="float16"):
                loss = model(paddle.to_tensor(x, place=where)).astype(
                    "float32").sum()
            scaler.scale(loss).backward()
            scaler.minimize(opt, loss)
            opt.clear_grad()
            scales.append(scaler.get_init_loss_scaling())
            moved.append(not np.array_equal(w0, model[0].weight.numpy()))
        runs[str(where)] = (scales, moved, model[0].weight.numpy())
    (cs, cm, cw), (ps, pm, pw) = runs[str(card)], runs["cpu"]
    assert cs == ps and cm == pm and False in cm
    assert np.abs(cw.astype(np.float64) - pw).max() <= 1e-3


def test_card_static_failed_capture_raises(card):
    """A step that reads a value back to the host (here through the torch
    tensor, past the Tensor's own check) runs eagerly on its first calls
    and then fails to capture: the call raises, nothing runs it eagerly
    instead, and the card stays usable."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit.static_function import EAGER_RUNS
    lin = paddle.nn.Linear(8, 8)
    lin.to(card)

    @paddle.jit.to_static
    def step(a):
        out = lin(a).sum()
        out._data.item()
        return out

    a = paddle.to_tensor(np.ones((2, 8), np.float32), place=card)
    for _ in range(EAGER_RUNS):
        step(a)
    with pytest.raises(RuntimeError, match="capturing the step step"):
        step(a)
    assert step.concrete_program(a).graph is None
    assert float((a * 2).sum()) == 32.0


# ------------------------------------------- convolution, pooling, batch norm

def _vision_pair(card, fn, arrays, seed=9):
    """``fn(*tensors)`` of the port on the card and on the CPU, f32 with
    TF32 off: outputs and the gradients of ``sum(out * r)``."""
    import paddle_tpu_torch as paddle
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    try:
        for dev in (torch.device("cpu"), card):
            ts = [paddle.to_tensor(a, place=dev,
                                   stop_gradient=a.dtype.kind != "f")
                  for a in arrays]
            out = fn(*ts)
            r = np.random.RandomState(seed).randn(*out.shape).astype(
                np.float32)
            (out * paddle.to_tensor(r, place=dev)).sum().backward()
            res[dev.type] = (out.numpy(), [t.grad.numpy() for t in ts
                                           if not t.stop_gradient])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return res["cuda"], res["cpu"]


def _vision_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a == b)
    return float(np.where(same, 0.0, np.abs(a - b)).max()
                 / max(np.abs(np.where(np.isfinite(b), b, 0.0)).max(), 1e-30))


VISION_CASES = {
    "conv2d_same_stride2": ("conv2d", dict(padding="SAME", stride=2)),
    "conv2d_groups_nhwc": ("conv2d", dict(padding=[1, 0, 0, 1], groups=2,
                                          data_format="NHWC")),
    "conv2d_transpose": ("conv2d_transpose", dict(padding=1, stride=2,
                                                  output_padding=1)),
    "max_pool2d": ("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    "max_pool2d_ceil": ("max_pool2d", dict(kernel_size=3, stride=2,
                                           ceil_mode=True)),
    "avg_pool2d_exclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                                padding=[0, 1, 1, 2])),
    "adaptive_avg_pool2d": ("adaptive_avg_pool2d", dict(output_size=(3, 2))),
    "adaptive_max_pool2d": ("adaptive_max_pool2d", dict(output_size=3)),
}


@pytest.mark.parametrize("case", list(VISION_CASES))
def test_card_conv_and_pooling_match_cpu(card, case):
    """Convolution and pooling on the card against the port on the CPU,
    float32 with TF32 off: outputs within 1e-5 and gradients within 1e-4
    of the largest magnitude."""
    import paddle_tpu_torch as paddle
    name, kw = VISION_CASES[case]
    rng = np.random.RandomState(3)
    x = rng.randn(4, 8, 17, 15).astype(np.float32)
    arrays = [x]
    if name.startswith("conv"):
        if kw.get("data_format") == "NHWC":
            arrays[0] = x.transpose(0, 2, 3, 1).copy()
        g = kw.get("groups", 1)
        shape = (8, 6 // g, 3, 3) if "transpose" in name else (12, 8 // g,
                                                              3, 3)
        arrays.append(rng.randn(*shape).astype(np.float32))
    fn = getattr(paddle.nn.functional, name)
    (out, grads), (ref, rgrads) = _vision_pair(
        card, lambda *ts: fn(*ts, **kw), arrays)
    assert _vision_rel(out, ref) <= 1e-5
    for g, r in zip(grads, rgrads):
        assert _vision_rel(g, r) <= 1e-4


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_card_batch_norm_matches_cpu(card, fmt):
    """The training arm (the autograd Function) and eval on the card
    against the CPU in float32: outputs within 1e-5, gradients within 1e-4,
    running statistics within 1e-5."""
    import paddle_tpu_torch as paddle
    rng = np.random.RandomState(4)
    x = (rng.randn(8, 16, 9, 7) * 3 + 1).astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    w, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    for training in (True, False):
        stats = {}

        def fn(a, wt, bs):
            dev = a._data.device
            rm = paddle.to_tensor(np.zeros(16, np.float32), place=dev)
            rv = paddle.to_tensor(np.ones(16, np.float32), place=dev)
            stats[dev.type] = (rm, rv)
            return paddle.nn.functional.batch_norm(
                a, rm, rv, wt, bs, training=training, data_format=fmt)

        (out, grads), (ref, rgrads) = _vision_pair(card, fn, [x, w, b])
        assert _vision_rel(out, ref) <= 1e-5
        for g, r in zip(grads, rgrads):
            assert _vision_rel(g, r) <= 1e-4
        for a, r in zip(stats["cuda"], stats["cpu"]):
            assert _vision_rel(a.numpy(), r.numpy()) <= 1e-5


def test_card_batch_norm_bfloat16_under_o2(card):
    """O2's batch norm on the card: bfloat16 input, weight and bias,
    float32 running statistics that stay float32; the output and the
    input's gradient bfloat16, within 2e-2 of the CPU's (both round the
    normalized value to bfloat16) and the statistics within 1e-3."""
    import paddle_tpu_torch as paddle
    rng = np.random.RandomState(5)
    x = (rng.randn(16, 32, 14, 14) * 2 + 0.5).astype(np.float32)
    res = {}
    for dev in (torch.device("cpu"), card):
        bn = None
        with paddle.device.device_scope(dev):
            paddle.seed(0)
            bn = paddle.nn.BatchNorm2D(32)
        for p in bn.parameters():
            p._write(p._data.detach().to(torch.bfloat16))
        xs = paddle.to_tensor(x, place=dev).astype("bfloat16")
        xs.stop_gradient = False
        out = bn(xs)
        r = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
        (out.astype("float32") * paddle.to_tensor(r, place=dev)).sum(
        ).backward()
        res[dev.type] = (out, xs.grad, bn._mean, bn._variance)
    out, g, m, v = res["cuda"]
    assert out.dtype == g.dtype == torch.bfloat16
    assert m.dtype == v.dtype == torch.float32
    assert _vision_rel(out.numpy(), res["cpu"][0].numpy()) <= 2e-2
    assert _vision_rel(g.numpy(), res["cpu"][1].numpy()) <= 2e-2
    for a, r in zip((m, v), res["cpu"][2:]):
        assert _vision_rel(a.numpy(), r.numpy()) <= 1e-3


def test_card_static_resnet_replays_keep_running_stats(card):
    """`bench_resnet50`'s program at resnet18, B=8 at 64 x 64, under
    ``cudnn.deterministic``: 5 to_static calls (2 eager, the capture, 2
    replays) then multi_steps(2) against 7 eager steps from one seed:
    losses, parameters and every batch norm's running statistics bit for
    bit; the batch norm kernels launch once a norm (20) a step on both
    paths, counted through the replays, and no other kernel launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit.static_function import EAGER_RUNS
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.vision.models import resnet18
    rng = np.random.RandomState(0)
    xa = rng.randn(8, 3, 64, 64).astype(np.float32)
    ya = rng.randint(0, 10, 8).astype(np.int64)
    x, y = (paddle.to_tensor(a, place=card) for a in (xa, ya))
    xk, yk = (paddle.to_tensor(np.broadcast_to(a, (2,) + a.shape).copy(),
                               place=card) for a in (xa, ya))
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    before = {k.source: k.launches for k in _build.kernels()}
    runs = {}
    try:
        for static in (False, True):
            paddle.seed(0)
            with paddle.device.device_scope(card):
                model = resnet18(num_classes=10)
            opt = paddle.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9,
                parameters=model.parameters(), weight_decay=1e-4)
            model, opt = paddle.amp.decorate(model, opt, level="O2",
                                             dtype="bfloat16")
            loss_fn = paddle.nn.CrossEntropyLoss()

            def step(a, b):
                with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
                    loss = loss_fn(model(a), b)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss

            if static:
                fn = paddle.jit.to_static(step)
                losses = [fn(x, y).numpy() for _ in range(5)]
                losses += list(fn.multi_steps(2)(xk, yk).numpy())
                prog = fn.concrete_program(x, y)
                assert prog.graph.replays == 7 - EAGER_RUNS
            else:
                losses = [step(x, y).numpy() for _ in range(7)]
            runs[static] = ([np.asarray(a).tobytes() for a in losses],
                            {k: v.numpy() for k, v in
                             model.state_dict().items()})
    finally:
        torch.backends.cudnn.deterministic = prev
    assert runs[True][0] == runs[False][0]
    for k, v in runs[False][1].items():
        assert np.array_equal(runs[True][1][k], v), k
    norms = 20 * 7 * 2                 # a norm a step, eager and static
    assert {k.source: k.launches - before[k.source]
            for k in _build.kernels()} == {
        k.source: norms if k.source.startswith("batch_norm") else 0
        for k in _build.kernels()}


BN_KERNEL_CASES = {
    "nchw_vec8": ((4, 32, 16, 16), 1, torch.bfloat16, torch.bfloat16),
    "nchw_odd_inner": ((8, 16, 9, 7), 1, torch.float32, torch.float32),
    "channels_last": ((4, 6, 5, 24), 3, torch.bfloat16, torch.bfloat16),
    "nc": ((64, 24), 1, torch.float32, torch.float32),
    "bf16_x_f32_weight": ((4, 8, 12, 12), 1, torch.bfloat16, torch.float32),
    "no_affine": ((4, 8, 10, 10), 1, torch.bfloat16, None),
}


@pytest.mark.parametrize("case", list(BN_KERNEL_CASES))
def test_card_batch_norm_kernels_match_plain(card, case):
    """The batch norm kernels against their plain versions on the card
    (chip_smoke.py's BN_TOL): output and statistics within 2e-5 (f32) or
    two bfloat16 steps (2^-6) of the largest value when above 1, dx the
    same, dw and db within 1e-4 (f32) or one bfloat16 step (2^-7); two
    runs bit for bit (no atomics)."""
    from paddle_tpu_torch.kernels import batch_norm as tbn
    shape, ch, dtype, wdtype = BN_KERNEL_CASES[case]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        card, dtype)
    c = shape[ch]
    w = b = None
    if wdtype is not None:
        w = torch.from_numpy(rng.standard_normal(c, dtype=np.float32)).to(
            card, wdtype)
        b = torch.from_numpy(rng.standard_normal(c, dtype=np.float32)).to(
            card, wdtype)
    x3 = tbn.view3(x, ch)
    got = tbn.train_fwd("cuda", x3, w, b, 1e-5)
    ref = tbn._plain_fwd(x3, w, b, 1e-5)
    assert got[0].dtype == ref[0].dtype
    dy = torch.from_numpy(rng.standard_normal(tuple(x3.shape),
                                              dtype=np.float32)).to(
        card, got[0].dtype)
    gotb = tbn.train_bwd("cuda", x3, dy, got[1], got[3], w)
    refb = tbn._plain_bwd(x3, dy, ref[1], ref[3], w)
    out_tol, sum_tol = (2e-5, 1e-4) if dtype == torch.float32 else \
        (2.0 ** -6, 2.0 ** -7)

    def err(a, r):
        return (a.float() - r.float()).abs().max().item()

    def tol(r, t):
        return t * max(1.0, r.float().abs().max().item())

    for a, r in zip(got, ref):
        assert err(a, r) <= tol(r, out_tol)
    assert gotb[0].dtype == dtype
    assert err(gotb[0], refb[0]) <= tol(refb[0], out_tol)
    for a, r in zip(gotb[1:], refb[1:]):
        assert err(a, r) <= tol(r, sum_tol)
    again = tbn.train_bwd("cuda", x3, dy, got[1], got[3], w)
    assert all(torch.equal(a, r) for a, r in zip(again, gotb))
    assert torch.equal(tbn.train_fwd("cuda", x3, w, b, 1e-5)[0], got[0])


# ------------------------------------------------- fast_generate, comms

FAST_CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64)


def _fast_pair(card):
    """A tiny GPT on the CPU and the same weights on the card."""
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.models import gpt as tgpt
    with tdevice.device_scope("cpu"):
        cpu = tgpt.GPTForCausalLM(tgpt.GPTConfig(**FAST_CFG), generator=
                                  torch.Generator().manual_seed(3))
    with tdevice.device_scope(card):
        dev = tgpt.GPTForCausalLM(tgpt.GPTConfig(**FAST_CFG))
    dev.set_state_dict({k: v._data for k, v in cpu.state_dict().items()})
    return cpu, dev


def _fast(model, ids, n, **kw):
    from paddle_tpu_torch.core.tensor import Tensor
    x = Tensor(torch.from_numpy(ids).to(
        model.gpt.wte.weight._data.device))
    return model.fast_generate(x, max_new_tokens=n, **kw).numpy()


@pytest.mark.parametrize("kw", [{}, dict(temperature=0.8, top_k=5, seed=3)],
                         ids=["greedy", "sampled"])
def test_card_fast_generate_graph_matches_cpu(card, kw):
    """One captured graph a signature, replayed once a call; its tokens
    equal the CPU's eager program; a weight written in place is read by
    the next replay; a rebound weight is captured again."""
    cpu, dev = _fast_pair(card)
    ids = np.random.RandomState(0).randint(0, 97, (2, 8)).astype(np.int32)
    want = _fast(cpu, ids, 12, **kw)
    got = _fast(dev, ids, 12, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_fast(dev, ids, 12, **kw), want)
    (prog,) = dev._fast_decode_cache.values()
    assert prog.captures == 1 and prog.graph.replays == 2
    delta = torch.from_numpy(np.random.RandomState(1).randn(97, 32)
                             .astype(np.float32))
    for model in (cpu, dev):
        w = model.gpt.wte.weight
        w._write(w._data + delta.to(w._data.device))
    want = _fast(cpu, ids, 12, **kw)
    np.testing.assert_array_equal(_fast(dev, ids, 12, **kw), want)
    assert prog.captures == 1
    w = dev.gpt.wte.weight
    w.stop_gradient = True
    new = (w._data * 1.5).clone()
    dev.set_state_dict({"gpt.wte.weight": new})
    cpu.set_state_dict({"gpt.wte.weight": new.cpu()})
    np.testing.assert_array_equal(_fast(dev, ids, 12, **kw),
                                  _fast(cpu, ids, 12, **kw))
    assert prog.captures == 2


def test_card_fast_generate_failed_capture_raises(card, monkeypatch):
    """A program that reads a value back cannot be captured: the call
    raises, and nothing falls back to the eager loop."""
    from paddle_tpu_torch.models import gpt as tgpt
    _, dev = _fast_pair(card)
    real = tgpt._fast_decode

    def reads_back(p, ids, key, cfg, n, sample):
        int(ids.sum().item())
        return real(p, ids, key, cfg, n, sample)
    monkeypatch.setattr(tgpt, "_fast_decode", reads_back)
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="capturing the decode program"):
        _fast(dev, ids, 3)
    (prog,) = dev._fast_decode_cache.values()
    assert prog.graph is None
    x = torch.ones(4, device=card)
    assert float((x * 2).sum()) == 8.0


@pytest.mark.parametrize("n,block", [(257, 256), (4096, 64), (1000, 1)])
def test_card_codec_within_an_ulp_of_cpu(card, n, block):
    """The blockwise codec on the card: each scale within one f32 ulp of
    the CPU's (ROADMAP C25: CUDA divides by the host scalar 127 as a
    product with its reciprocal), each round trip within its bound, and
    the card's own round trip repeatable bit for bit."""
    from paddle_tpu_torch.quantization import comms
    x = torch.from_numpy(np.random.RandomState(n).randn(n).astype(
        np.float32) * 3)
    want = comms.quantize_blockwise(x, block)
    got = comms.quantize_blockwise(x.to(card), block)
    s, ws = got[1].cpu(), want[1]
    assert ((s - ws).abs() <= ws * 2.0 ** -23).all()
    back = comms.dequantize_blockwise(*got).cpu()
    assert ((back - x).abs() <= comms.roundtrip_bound(x, block)
            + 1e-5).all()
    again = comms.quantize_blockwise(x.to(card), block)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_card_local_collectives_stay_on_the_card(card):
    """World 1: a plain all-reduce is the identity, a quantized one the
    codec's round trip (the card's own, within its bound), on the card."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.quantization import comms
    x = np.random.RandomState(4).randn(3000).astype(np.float32)
    t = Tensor(torch.from_numpy(x).to(card))
    dist.all_reduce(t)
    assert t._data.is_cuda and np.array_equal(t.numpy(), x)
    q = Tensor(torch.from_numpy(x).to(card))
    dist.all_reduce(q, op=dist.ReduceOp.AVG, quantized=True)
    assert q._data.is_cuda
    want = comms.dequantize_blockwise(*comms.quantize_blockwise(
        torch.from_numpy(x).to(card)))
    assert torch.equal(q._data, want)
    bound = comms.roundtrip_bound(torch.from_numpy(x)).numpy()
    assert (np.abs(q.numpy() - x) <= bound + 1e-5).all()


# ------------------------------------------- the data pipeline and Model.fit


class _ProbedRows:
    """Rows of numpy ids whose spawn workers write, as they unpickle the
    dataset and at each sample, whether they hold a CUDA context
    (module-level: it pickles into spawn workers)."""

    def __init__(self, probe_dir, n=24):
        self.probe_dir, self.parent, self.n = probe_dir, os.getpid(), n

    def _note(self):
        if os.getpid() != self.parent:
            with open(os.path.join(self.probe_dir, str(os.getpid())),
                      "w") as f:
                f.write(str(torch.cuda.is_initialized()))

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._note()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self._note()
        return np.full((5,), i, np.float32), np.array(i, np.int64)


def test_card_shm_loader_tensors_on_card_workers_without_cuda(card,
                                                             tmp_path):
    """A shm DataLoader with spawn workers (the default) after the parent
    holds a CUDA context: every batch is a Tensor on the card, in order,
    and no worker initialised CUDA."""
    import paddle_tpu_torch.io as tio
    from paddle_tpu_torch.framework.flags import set_flags
    torch.zeros(1, device=card)             # the parent holds a context
    set_flags({"FLAGS_dataloader_auto_fallback": False})
    try:
        batches = list(tio.DataLoader(_ProbedRows(str(tmp_path)),
                                      batch_size=4, num_workers=2))
    finally:
        set_flags({"FLAGS_dataloader_auto_fallback": True})
    assert all(x._data.is_cuda and y._data.is_cuda for x, y in batches)
    assert np.concatenate([y.numpy() for _, y in batches]).tolist() == \
        list(range(24))
    probes = [open(p).read() for p in tmp_path.iterdir()]
    assert len(probes) == 2 and set(probes) == {"False"}


def _card_fit_gpt(card, seed=5):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256,
                    max_position_embeddings=128, hidden_dropout=0.0,
                    attention_dropout=0.0)
    with paddle.device.device_scope("cpu"):
        return GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
            seed)).to(torch.bfloat16)


def test_card_fused_fit_equals_direct_scan_step(card):
    """`Model.fit` on the fused route (bf16 on f32 masters, k = 2 over
    loader batches of 4) equals `ScanTrainStep(microbatches=2)` stepped
    directly on the same concatenated groups, bit for bit, and launches
    each flash kernel once a layer a microbatch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import ScanTrainStep
    ids = np.random.default_rng(7).integers(0, 97, (16, 129))
    rows = [(r[:-1].astype(np.int32), r[1:].astype(np.int64)) for r in ids]
    net = _card_fit_gpt(card).to(card)
    hm = paddle.Model(net).prepare(optimizer=paddle.optimizer.AdamW(
        learning_rate=1e-3, clip_norm=1.0, parameters=net.parameters()))

    class Rows(paddle.io.Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i]

    before = (cfa.FWD.launches, cfa.DQ.launches, cfa.DKV.launches)
    hm.fit(Rows(), batch_size=4, accumulate_grad_batches=2, shuffle=False,
           verbose=0)
    after = (cfa.FWD.launches, cfa.DQ.launches, cfa.DKV.launches)
    assert [a - b for a, b in zip(after, before)] == [2 * 2 * 2] * 3
    assert hm._fused_step.device.type == "cuda"
    ref = _card_fit_gpt(card)
    step = ScanTrainStep(ref, AdamW(learning_rate=1e-3, clip_norm=1.0),
                         microbatches=2, device=card)
    for g in range(2):
        step.step(ids[g * 8:(g + 1) * 8, :-1].astype(np.int32),
                  ids[g * 8:(g + 1) * 8, 1:].astype(np.int64))
    step.sync_to_model()
    want = torch_state(ref)
    for k, v in torch_state(net).items():
        assert torch.equal(v.cpu(), want[k].cpu()), k


def test_card_eager_fit_batch_norm_matches_cpu(card):
    """Eager `Model.fit` of a conv + BatchNorm2D + linear net: on the card
    each step launches batch_norm_fwd and batch_norm_bwd once a norm, and
    two Momentum steps from the same weights match the CPU's within
    chip_smoke's RESNET_CPU_TOL: losses absolute, running statistics
    relative to their largest, each parameter's update as an L2 error
    over its norm (``grad_l2``)."""
    import paddle_tpu_torch as paddle
    from chip_smoke import RESNET_CPU_TOL
    from paddle_tpu_torch.kernels.cuda import batch_norm as cbn
    rng = np.random.RandomState(8)
    x = rng.randn(16, 3, 12, 12).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.int64)
    res = {}
    for dev in (torch.device("cpu"), card):
        with paddle.device.device_scope(dev):
            paddle.seed(0)
            nn = paddle.nn
            net = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1),
                                nn.BatchNorm2D(8), nn.ReLU(),
                                nn.Conv2D(8, 8, 3, stride=2),
                                nn.BatchNorm2D(8), nn.ReLU(),
                                nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                                nn.Linear(8, 10))
            if dev.type == "cuda":
                net.set_state_dict(res["cpu"][0])
            init = {k: v.numpy().copy() for k, v in net.state_dict().items()}
            hm = paddle.Model(net).prepare(
                optimizer=paddle.optimizer.Momentum(
                    learning_rate=0.1, parameters=net.parameters()),
                loss=nn.CrossEntropyLoss())
            clock = []

            class Losses(paddle.callbacks.Callback):
                def on_train_batch_end(self, step, logs=None):
                    clock.append(logs["loss"])

            before = (cbn.FWD.launches, cbn.BWD.launches)
            hm.fit([(x[:8], y[:8]), (x[8:], y[8:])], epochs=1, verbose=0,
                   callbacks=[Losses()])
            launched = (cbn.FWD.launches - before[0],
                        cbn.BWD.launches - before[1])
            res[dev.type] = (init, clock, {k: v.numpy() for k, v in
                                           net.state_dict().items()},
                             launched)
    (init, closs, cstate, claunch), (_, gloss, gstate, glaunch) = \
        res["cpu"], res["cuda"]
    assert claunch == (0, 0) and glaunch == (2 * 2, 2 * 2)
    assert max(abs(a - b) for a, b in zip(closs, gloss)) <= \
        RESNET_CPU_TOL["loss"]
    for k, v in cstate.items():
        if k.endswith(("_mean", "_variance")):
            assert np.abs(gstate[k] - v).max() <= \
                RESNET_CPU_TOL["stats"] * np.abs(v).max(), k
        else:
            step = v - init[k]
            assert np.linalg.norm(gstate[k] - init[k] - step) <= \
                RESNET_CPU_TOL["grad_l2"] * np.linalg.norm(step), k
