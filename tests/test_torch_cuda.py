"""The PyTorch port's hand-written CUDA kernels held against their plain
PyTorch versions ON THE CARD, and the card engine against the CPU engine.
Every test here needs an NVIDIA card with CUDA and nvcc, is marked
``cuda``, and skips elsewhere. This file imports no JAX (the card's
machine has none), so run it there without the JAX-loading conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 2e-5 in float32 (online softmax against a full softmax, f32
throughout); 2e-2 in bfloat16, where both outputs are rounded to bfloat16.
The int8 paged kernels take the same tolerances for q in f32 and bf16:
both sides dequantize the same int8 values and scales in f32. The card
engine equals the CPU engine token for token, native and int8.
The flash kernels: in float32 2e-5 (forward) and 1e-4 (gradients) times
the largest reference value when that exceeds 1; in bfloat16 one bfloat16
step of the largest reference value, never less than the float32 bound.
The fused cross-entropy on the card against the CPU: losses within 1e-4,
gradients within one bf16 step (2^-8) of their largest value.
"""
import numpy as np
import pytest
import torch

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
    bq = cpre.default_block_q(c)
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
    bq = cpre.default_block_q(c)
    want = [cpre.block_visits(start, valid, i * bq, bq, ps)
            for i in range(visits.shape[0])]
    assert visits[:, 0].tolist() == want
    launches = cpre.KERNEL_INT8.launches
    assert torch.equal(pa.prefill_attention(q[None], kp, vp, row, start,
                                            valid, ks, vs)[0], out)
    assert cpre.KERNEL_INT8.launches == launches + 1


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
