"""Flash attention of the PyTorch port (`paddle_tpu_torch/kernels/
flash_attention.py`) held against the JAX package's authored Pallas kernels
(`paddle_tpu/kernels/pallas/flash_attention.py`, run in interpret mode on
the CPU, as the JAX package's own tests run them) on the same inputs.

The port runs its plain PyTorch versions here, which is what a CPU tensor
takes. Tolerances: in float32, out and lse within 2e-5 and dq/dk/dv within
1e-4, the JAX package's own (`tests/test_pallas_kernels.py`); in bfloat16,
where both sides compute in float32 and round the result to bfloat16, one
bfloat16 step of the largest value, 2^-7 * max|ref|, for out and the
gradients, and 1e-4 for lse (float32 on both sides from the same bfloat16
inputs).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels.pallas.flash_attention import _bwd, _fwd
from paddle_tpu.kernels.pallas.flash_attention import flash_attention as jflash
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import registry

# (bh, sq, sk, d, causal, block): causal and not, a ragged S=48 with block
# 32, and Sq < Sk with the diagonal aligned bottom-right (ragged too)
CASES = [
    (4, 64, 64, 32, False, 32),
    (4, 64, 64, 32, True, 32),
    (2, 48, 48, 16, True, 32),
    (2, 48, 48, 16, False, 32),
    (2, 16, 64, 16, True, 16),
    (2, 20, 50, 16, True, 16),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(case, dtype, seed=0):
    bh, sq, sk, d = case[:4]
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, sq, d).astype(np.float32)
    k = rng.randn(bh, sk, d).astype(np.float32)
    v = rng.randn(bh, sk, d).astype(np.float32)
    do = rng.randn(bh, sq, d).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a).astype(jdt) for a in (q, k, v, do)]
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, do)]
    return j, t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref, dtype, f32_tol):
    got, ref = _np(got), _np(ref)
    tol = f32_tol if dtype == "float32" else 2.0 ** -7 * np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_plain_forward_matches_pallas(case, dtype):
    (jq, jk, jv, _), (q, k, v, _) = _arrays(case, dtype)
    scale = float(1.0 / np.sqrt(case[3]))
    jout, jlse = _fwd(jq, jk, jv, scale, case[4], case[5], case[5], True)
    out, lse = tfa._plain_flash_fwd(q, k, v, scale, case[4])
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    _close(out, jout, dtype, 2e-5)
    err = np.abs(lse.numpy() - np.asarray(jlse)).max()
    assert err <= (2e-5 if dtype == "float32" else 1e-4), err


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_pallas(case, dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = _arrays(case, dtype, seed=1)
    scale, causal, blk = float(1.0 / np.sqrt(case[3])), case[4], case[5]
    jout, jlse = _fwd(jq, jk, jv, scale, causal, blk, blk, True)
    jdq, jdk, jdv = _bwd(jq, jk, jv, jout, jlse, jdo, scale, causal, blk,
                         blk, True)
    # the same saved out and lse on both sides
    out = torch.from_numpy(_np(jout)).to(q.dtype)
    lse = torch.from_numpy(np.array(jlse))
    delta = (do.float() * out.float()).sum(-1)
    dq = tfa._plain_flash_dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = tfa._plain_flash_dkv(q, k, v, do, lse, delta, scale, causal)
    for got, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == q.dtype
        _close(got, ref, dtype, 1e-4)


@pytest.mark.parametrize("case", CASES)
def test_autograd_matches_jax_grad(case):
    bh, sq, sk, d, causal, blk = case
    (jq, jk, jv, jdo), (q, k, v, do) = _arrays(case, "float32", seed=2)
    b, h = 2, bh // 2
    shape = lambda a, s: a.reshape(b, h, s, d)   # noqa: E731

    def jloss(q_, k_, v_):
        out = jflash(shape(q_, sq), shape(k_, sk), shape(v_, sk),
                     causal=causal, block_q=blk, block_k=blk, interpret=True)
        return jnp.sum(out * shape(jdo, sq))

    jout = jflash(shape(jq, sq), shape(jk, sk), shape(jv, sk), causal=causal,
                  block_q=blk, block_k=blk, interpret=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    registry.reset_counts()
    out = tfa.flash_attention(shape(ins[0], sq), shape(ins[1], sk),
                              shape(ins[2], sk), causal=causal)
    out.backward(shape(do, sq))
    assert registry.counts() == {"kernel.dispatch.flash_attention.plain": 1}
    _close(out, jout, "float32", 2e-5)
    for t, jg in zip(ins, jgrads):
        _close(t.grad, jg, "float32", 1e-4)


def test_model_layout_entry_matches_bhsd():
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 24, 3, 8).astype(np.float32))
               for _ in range(3))        # [B, S, H, D]
    got = tfa.flash_attention_fn(causal=True)(q, k, v)
    want = tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True)
    assert got.shape == q.shape
    assert torch.equal(got, want.transpose(1, 2))


def test_causal_longer_queries_raise():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(NotImplementedError, match="seq_q <= seq_k"):
        tfa.flash_attention(q, q[:, :, :4], q[:, :, :4], causal=True)
    # not causal: every row sees every key, so Sq > Sk is fine
    assert tfa.flash_attention(q, q[:, :, :4], q[:, :, :4]).shape == q.shape


@pytest.mark.parametrize("causal,sq,sk", [(True, 5, 7), (False, 6, 3)])
def test_plain_gradcheck_float64(causal, sq, sk):
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(1, 2, sq, 4)).requires_grad_(True)
    k = torch.from_numpy(rng.randn(1, 2, sk, 4)).requires_grad_(True)
    v = torch.from_numpy(rng.randn(1, 2, sk, 4)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.flash_attention(a, b, c, causal=causal),
        (q, k, v), eps=1e-6, atol=1e-6)


def _mma_flash_emulation(q, k, v, scale, causal, tile=64):
    """The arithmetic of the tensor-core forward loop
    (`kernels/csrc/flash_fwd_mma.cuh`) in plain torch: bf16 q, k, v; S = q
    k^T in f32 over 64-key tiles, the scale applied after the product; an
    online softmax in f32 on the raw scores; the row sum l from the f32 p;
    p rounded to bf16 before P V (f32 sums); out rounded to bf16 and
    lse = m * scale + log(l)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    bh, sq, d = q.shape
    sk = k.shape[1]
    rows = torch.arange(sq)[:, None]
    m = torch.full((bh, sq), -np.inf)
    l = torch.zeros(bh, sq)
    o = torch.zeros(bh, sq, d)
    for k0 in range(0, sk, tile):
        keys = torch.arange(k0, min(k0 + tile, sk))
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, keys])
        if causal:
            s = s.masked_fill(keys[None, :] > rows + (sk - sq), -np.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp((s - m_new[..., None]) * scale)
        alpha = torch.exp((m - m_new) * scale)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bqk,bkd->bqd", p.to(torch.bfloat16).float(), vf[:, keys])
        m = m_new
    lc = l.clamp_min(1e-30)
    return (o / lc[..., None]).to(torch.bfloat16), m * scale + torch.log(lc)


# (bh, sq, sk, d, causal, pallas block): causal S=256, cross Sq=64 / Sk=300
# (ragged, bottom-right), non-causal S=192 with GPT-2's head dim
MMA_CASES = [(2, 256, 256, 64, True, 64), (2, 64, 300, 32, True, 64),
             (2, 192, 192, 64, False, 64)]


@pytest.mark.parametrize("case", MMA_CASES)
def test_tensor_core_forward_rounding_matches_pallas(case):
    # within one bf16 step of the largest value (2^-7 of it), the bound the
    # card's kernel lines hold; lse within 1e-4 (f32 from bf16 inputs)
    (jq, jk, jv, _), (q, k, v, _) = _arrays(case, "bfloat16", seed=5)
    scale = float(1.0 / np.sqrt(case[3]))
    jout, jlse = _fwd(jq, jk, jv, scale, case[4], case[5], case[5], True)
    out, lse = _mma_flash_emulation(q, k, v, scale, case[4])
    ref = _np(jout)
    big = np.abs(ref).max()
    err = np.abs(_np(out) - ref).max()
    assert err <= max(2e-5 * max(1.0, big), 2.0 ** -7 * big), (err, big)
    assert np.abs(lse.numpy() - np.asarray(jlse)).max() <= 1e-4


def _mma_dkv_emulation(q, k, v, do, lse, delta, scale, causal):
    """The arithmetic of the tensor-core dK/dV loop
    (`kernels/csrc/flash_dkv_mma.cuh`) in plain torch: bf16 q, k, v, dO;
    S^T = K Q^T and dP^T = V dO^T in f32, the scale applied after the
    product inside the exponent, P = exp(s * scale - lse), 0 past the
    causal diagonal; dS = P (dP - delta) from the f32 P; P and dS rounded
    to bf16 only as the operands of dV = P^T dO and dK = dS^T Q (f32 sums);
    dK scaled once at the end; dk and dv rounded to bf16."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bkd,bqd->bkq", kf, qf)
    p = torch.exp(s * scale - lse[:, None, :])
    if causal:
        keys, rows = torch.arange(sk)[:, None], torch.arange(sq)[None, :]
        p = p.masked_fill(keys > rows + (sk - sq), 0.0)
    dp = torch.einsum("bkd,bqd->bkq", vf, dof)
    ds = p * (dp - delta[:, None, :])
    bf = lambda t: t.to(torch.bfloat16).float()   # noqa: E731
    dv = torch.einsum("bkq,bqd->bkd", bf(p), dof)
    dk = torch.einsum("bkq,bqd->bkd", bf(ds), qf) * scale
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


@pytest.mark.parametrize("case", MMA_CASES)
def test_tensor_core_dkv_rounding_matches_pallas(case):
    # dk and dv within one bf16 step of the largest value (2^-7 of it), the
    # bound the card's kernel lines hold, against the interpret-mode Pallas
    # backward on the same saved out and lse
    (jq, jk, jv, jdo), (q, k, v, do) = _arrays(case, "bfloat16", seed=6)
    scale, causal, blk = float(1.0 / np.sqrt(case[3])), case[4], case[5]
    jout, jlse = _fwd(jq, jk, jv, scale, causal, blk, blk, True)
    _, jdk, jdv = _bwd(jq, jk, jv, jout, jlse, jdo, scale, causal, blk, blk,
                       True)
    out = torch.from_numpy(_np(jout)).to(torch.bfloat16)
    lse = torch.from_numpy(np.array(jlse))
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = _mma_dkv_emulation(q, k, v, do, lse, delta, scale, causal)
    for got, want in ((dk, jdk), (dv, jdv)):
        ref = _np(want)
        big = np.abs(ref).max()
        err = np.abs(_np(got) - ref).max()
        assert err <= max(1e-4 * max(1.0, big), 2.0 ** -7 * big), (err, big)


def _mma_dq_emulation(q, k, v, do, lse, delta, scale, causal):
    """The arithmetic of the tensor-core dQ loop
    (`kernels/csrc/flash_dq_mma.cuh`) in plain torch: bf16 q, k, v, dO;
    S = Q K^T and dP = dO V^T in f32, the scale applied after the product
    inside the exponent, P = exp(s * scale - lse), 0 past the causal
    diagonal; dS = P (dP - delta) from the f32 P, rounded to bf16 only as
    the operand of dQ = dS K (f32 sums); dQ scaled once at the end and
    rounded to bf16."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", qf, kf)
    p = torch.exp(s * scale - lse[:, :, None])
    if causal:
        rows, keys = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
        p = p.masked_fill(keys > rows + (sk - sq), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = (p * (dp - delta[:, :, None])).to(torch.bfloat16).float()
    return (torch.einsum("bqk,bkd->bqd", ds, kf) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("case", MMA_CASES)
def test_tensor_core_dq_rounding_matches_pallas(case):
    # dq within one bf16 step of the largest value (2^-7 of it), the bound
    # the card's kernel lines hold, against the interpret-mode Pallas
    # backward on the same saved out and lse
    (jq, jk, jv, jdo), (q, k, v, do) = _arrays(case, "bfloat16", seed=7)
    scale, causal, blk = float(1.0 / np.sqrt(case[3])), case[4], case[5]
    jout, jlse = _fwd(jq, jk, jv, scale, causal, blk, blk, True)
    jdq, _, _ = _bwd(jq, jk, jv, jout, jlse, jdo, scale, causal, blk, blk,
                     True)
    out = torch.from_numpy(_np(jout)).to(torch.bfloat16)
    lse = torch.from_numpy(np.array(jlse))
    delta = (do.float() * out.float()).sum(-1)
    dq = _mma_dq_emulation(q, k, v, do, lse, delta, scale, causal)
    ref = _np(jdq)
    big = np.abs(ref).max()
    err = np.abs(_np(dq) - ref).max()
    assert err <= max(1e-4 * max(1.0, big), 2.0 ** -7 * big), (err, big)


def test_dq_arm_rule_and_grid():
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    assert [cfa.dq_arm(torch.bfloat16, d) for d in (16, 64, 128, 72, 256)] \
        == ["mma_bf16", "mma_bf16", "mma_bf16", "cuda_core", "cuda_core"]
    assert cfa.dq_arm(torch.float32, 64) == "cuda_core"
    # the train shape: 96 (b, h) x 8 query tiles of 128 on the tensor cores
    # (64 rows above D=64), the last tile first; the CUDA-core loop's
    # 64-row blocks come first
    assert cfa.dq_grid(96, 1024, torch.bfloat16, 64) == (96, 8)
    assert cfa.dq_grid(12, 200, torch.bfloat16, 64) == (12, 2)
    assert cfa.dq_grid(12, 200, torch.bfloat16, 128) == (12, 4)
    assert cfa.dq_grid(96, 1024, torch.float32, 64) == (16, 96)
    assert cfa.dq_grid(2, 65, torch.bfloat16, 256) == (2, 2)


def test_dkv_arm_rule_and_grid():
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    assert [cfa.dkv_arm(torch.bfloat16, d) for d in (16, 64, 128, 72, 256)] \
        == ["mma_bf16", "mma_bf16", "mma_bf16", "cuda_core", "cuda_core"]
    assert cfa.dkv_arm(torch.float32, 64) == "cuda_core"
    # the train shape: 96 (b, h) x 16 key tiles of 64 on the tensor cores;
    # the CUDA-core loop's 64-key blocks (32 above D=128) come first
    assert cfa.dkv_grid(96, 1024, torch.bfloat16, 64) == (96, 16)
    assert cfa.dkv_grid(12, 300, torch.bfloat16, 64) == (12, 5)
    assert cfa.dkv_grid(96, 1024, torch.float32, 64) == (16, 96)
    assert cfa.dkv_grid(2, 65, torch.bfloat16, 256) == (3, 2)


def test_forward_arm_rule():
    from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
    assert [cfa.arm(torch.bfloat16, d) for d in (16, 64, 128, 72, 256)] == [
        "mma_bf16", "mma_bf16", "mma_bf16", "cuda_core", "cuda_core"]
    assert cfa.arm(torch.float32, 64) == "cuda_core"
    # the train shape: 96 (b, h) x 8 query tiles of 128 on the tensor cores
    assert cfa.grid(96, 1024, torch.bfloat16, 64) == (96, 8)
    assert cfa.grid(96, 1024, torch.float32, 64) == (16, 96)
