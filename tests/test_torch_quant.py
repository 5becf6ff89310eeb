"""Quantized serving of the PyTorch port held against the JAX package on the
same numpy-drawn inputs and weights (2 layers, hidden 32, 2 heads, page
size 4):

- the abs-max quantizer (`quantization/comms.py::absmax_int8`) and
  `quantize_kv`: int8 values and scales EQUAL to JAX's, for float32 and
  bfloat16 inputs;
- the plain int8 decode and prefill attention: within 1e-5 of the JAX XLA
  arms and of the interpret-mode Pallas kernels with ``k_scale`` /
  ``v_scale`` (f32 softmax on both sides; only the summation order
  differs), and the CUDA prefill kernels' trip counts (`block_visits`,
  up to the tensor-core loop's 64-row tiles) equal to the Pallas kernel's
  exported visits;
- the tensor-core prefill loop's rounding, emulated in plain torch (int8
  widened to bf16, scales after the products, ``p * vs`` rounded to bf16,
  64-key tiles; GPT-2 small's head dim 64, 4 heads, page size 16, a chunk
  of 256): within the card tests' bfloat16 tolerance, 2e-2, of the plain
  prefill attention;
- `quantize_gpt_params` in both layouts: int8 values and scales equal,
  other leaves passed through, fp8 refused; `scan_logits` over the
  quantized stacked params within 1e-4 of JAX's and margin-gated close to
  the float forward;
- the step functions over int8 pools with float32 weights: logits within
  1e-4 of the JAX steps', scales within 1e-6 relative, int8 values equal or
  one step apart in a few elements (a K/V value that lies within float32
  noise of a rounding boundary may round the other way);
- `DecodeEngine`: greedy tokens EQUAL to the JAX `DecodeEngine`'s under
  ``kv_dtype="int8"``, ``weight_dtype="int8"`` and both, and one-shot equal
  to chunked on the port; the pool's bytes per token; the refusals;
- `models/convert.py`: a JAX-quantized params dict carried across equals
  the port's own quantization bit for bit and serves the same tokens.

The JAX side runs its CPU arms; the port runs the plain PyTorch versions
of its kernels (``device="cpu"``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.engine import DecodeEngine as JEngine
from paddle_tpu.inference.engine import EngineConfig as JConfig
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels.pallas import paged_attention as jdec
from paddle_tpu.kernels.pallas import prefill_attention as jpre
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.quantization import comms as jcomms
from paddle_tpu.quantization import serving as jserving
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.kernels.cuda import paged_attention as cpre_dec
from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.quantization import comms
from paddle_tpu_torch.quantization.serving import (QUANT_LOGIT_BOUND,
                                                   QuantizedLeaf,
                                                   margin_gated_parity,
                                                   quantize_gpt_params)
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.tensor import torch_state


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=64)
NL, NH, DH, PS = 2, 2, 16, 4
ATT_TOL = 1e-5       # plain attention vs the JAX arms
STEP_TOL = 1e-4      # step logits vs the JAX steps


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _np(t):
    """A JAX or torch array as numpy (bf16 through float32)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ----------------------------------------------------------------- quantizer

def _quant_input(seed, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(6, 5, NH, DH).astype(np.float32)
    x *= rng.uniform(0.01, 30.0, (6, 5, NH, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0             # an all-zero row: the 1e-8 clamp
    x[1, 2, 1, :3] = [2.5, -2.5, 0.5]     # ties under some scales
    jx = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" \
        else jnp.asarray(x)
    tx = params_from_numpy({"x": np.asarray(jx)}, "cpu")["x"]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absmax_int8_and_quantize_kv_equal_jax(dtype):
    jx, tx = _quant_input(0, dtype)
    assert str(tx.dtype) == f"torch.{dtype}"
    for axis, keep in ((-1, False), (-2, True), (1, False)):
        jq, js = jcomms.absmax_int8(jx, axis=axis, keepdims=keep)
        tq, ts = comms.absmax_int8(tx, axis=axis, keepdims=keep)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, js = jpa.quantize_kv(jx)
    tq, ts = pa.quantize_kv(tx)
    assert tuple(ts.shape) == tuple(tx.shape[:-1])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        pa.dequantize_window(tq, ts).numpy(),
        np.asarray(jpa.dequantize_window(jq, js)))


# ------------------------------------------------------------ plain attention

def _int8_pools(rng, num_pages, nh=NH, dh=DH, ps=PS):
    """int8 pools and their scales, quantized from normal K/V by the JAX
    quantizer (numpy out, shared by both sides)."""
    out = []
    for _ in range(2):
        x = rng.randn(num_pages, ps, nh, dh).astype(np.float32)
        q, s = jpa.quantize_kv(jnp.asarray(x))
        out += [np.array(q), np.array(s)]
    kq, ks, vq, vs = out
    return kq, vq, ks, vs


DECODE_CASES = {
    "ragged": dict(b=4, maxp=5, pos=[0, 6, 13, 19]),
    "page_boundaries": dict(b=4, maxp=4, pos=[3, 4, 7, 8]),
    "single_token": dict(b=2, maxp=3, pos=[0, 0]),
}


def _decode_case(seed, b, maxp, pos):
    rng = np.random.RandomState(seed)
    num_pages = 1 + b * maxp
    q = rng.randn(b, NH, DH).astype(np.float32)
    kq, vq, ks, vs = _int8_pools(rng, num_pages)
    pt = (1 + rng.permutation(num_pages - 1)[:b * maxp]).reshape(b, maxp)
    return q, kq, vq, pt.astype(np.int32), np.asarray(pos, np.int32), ks, vs


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_plain_int8_decode_matches_xla_and_pallas(name):
    args = _decode_case(1, **DECODE_CASES[name])
    q, kq, vq, pt, pos, ks, vs = args
    got = pa._plain_paged_attention(*map(torch.from_numpy, args))
    ja = list(map(jnp.asarray, args))
    want_xla = jpa._xla_paged_attention(*ja[:5], k_scale=ja[5],
                                        v_scale=ja[6])
    want_pl = jdec.paged_attention(*ja[:5], k_scale=ja[5], v_scale=ja[6],
                                   interpret=True)
    assert _maxabs(got, want_xla) <= ATT_TOL
    assert _maxabs(got, want_pl) <= ATT_TOL
    registry.reset_counts()
    out = pa.paged_attention(*map(torch.from_numpy, args[:5]),
                             k_scale=torch.from_numpy(ks),
                             v_scale=torch.from_numpy(vs))
    assert torch.equal(out, got)
    assert registry.counts() == {"kernel.dispatch.paged_attention.plain": 1}


def test_plain_int8_decode_trash_row_at_capacity_matches_xla():
    args = list(_decode_case(2, b=2, maxp=3, pos=[0, 0]))
    args[3][1] = 0                        # inactive slot: all trash
    args[4] = np.asarray([5, 3 * PS], np.int32)   # slot 1 at capacity
    got = pa._plain_paged_attention(*map(torch.from_numpy, args))
    ja = list(map(jnp.asarray, args))
    want = jpa._xla_paged_attention(*ja[:5], k_scale=ja[5], v_scale=ja[6])
    assert _maxabs(got, want) <= ATT_TOL


PREFILL_CASES = [
    # (start, valid, c, block_q, maxp)
    (0, 7, 8, 8, 6),        # fresh prompt, padded tail
    (8, 5, 8, 8, 6),        # chunk after 2 pages of context
    (4, 8, 8, 8, 6),        # mid-page start
    (8, 10, 16, 4, 16),     # several query blocks
    (0, 5, 16, 4, 16),      # padded query blocks
    # the tensor-core loop's 64-row tiles (default_block_q for bf16, dh 64)
    (0, 128, 128, 64, 32),  # two tiles, every row live
    (8, 150, 200, 64, 40),  # four tiles: one partly live, one all padding
]


@pytest.mark.parametrize("start,valid,c,block_q,maxp", PREFILL_CASES)
def test_plain_int8_prefill_matches_xla_and_pallas(start, valid, c, block_q,
                                                   maxp):
    rng = np.random.RandomState(start * 17 + valid)
    kq, vq, ks, vs = _int8_pools(rng, 1 + maxp)
    row = np.arange(1, maxp + 1, dtype=np.int32)[::-1].copy()
    q = rng.randn(1, c, NH, DH).astype(np.float32)
    got = pa._plain_prefill_attention(
        *map(torch.from_numpy, (q, kq, vq, row)), start, valid,
        torch.from_numpy(ks), torch.from_numpy(vs)).numpy()
    jq, jkq, jvq, jrow, jks, jvs = map(jnp.asarray, (q, kq, vq, row, ks, vs))
    want_xla = np.asarray(jpa._xla_prefill_attention(
        jq, jkq, jvq, jrow, jnp.int32(start), jnp.int32(valid),
        k_scale=jks, v_scale=jvs))
    want_pl, visits = jpre.prefill_attention(
        jq[0], jkq, jvq, jrow, jnp.int32(start), jnp.int32(valid),
        interpret=True, block_q=block_q, k_scale=jks, v_scale=jvs,
        return_visits=True)
    assert _maxabs(got[0, :valid], want_xla[0, :valid]) <= ATT_TOL
    assert _maxabs(got[0], want_pl) <= ATT_TOL
    assert (got[0, valid:] == 0).all()
    want_visits = np.asarray(visits)
    assert want_visits.shape[0] == -(-c // block_q)
    for i in range(want_visits.shape[0]):
        assert (want_visits[i] == cpre.block_visits(
            start, valid, i * block_q, block_q, PS)).all()


def _mma_prefill_emulation(q, kp, vp, row, start, valid, k_scale=None,
                           v_scale=None, tile=64):
    """The rounding of the tensor-core prefill loop
    (`kernels/csrc/paged_prefill_mma.cuh`) in plain torch: q [C, nh, dh]
    in bf16, the pools' values as bf16 (int8 widens exactly), S = q . k in
    f32 times ``k_scale / sqrt(dh)`` after the product, an online softmax
    over 64-key tiles in f32, ``p * v_scale`` rounded to bf16 before the
    P V product (f32 sums), the output rounded to bf16 and rows >= valid
    zero."""
    c, nh, dh = q.shape
    kk = pa.gather_kv(kp, row[None])[0].to(torch.bfloat16).float()
    vv = pa.gather_kv(vp, row[None])[0].to(torch.bfloat16).float()
    lmax = kk.shape[0]
    ones = torch.ones(lmax, nh)
    kss = ones if k_scale is None else pa.gather_scales(k_scale, row[None])[0]
    vss = ones if v_scale is None else pa.gather_scales(v_scale, row[None])[0]
    scale = torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32)
    qf = q.float()
    pos = start + torch.arange(c)
    m = torch.full((nh, c), -1e30)
    l = torch.zeros(nh, c)
    o = torch.zeros(nh, c, dh)
    for k0 in range(0, start + valid, tile):
        keys = torch.arange(k0, min(k0 + tile, lmax))
        s = torch.einsum("qhd,khd->hqk", qf, kk[keys])
        s = s * (kss[keys].T * scale)[:, None, :]
        s = s.masked_fill(keys[None, None, :] > pos[None, :, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = (p * vss[keys].T[:, None, :]).to(torch.bfloat16).float()
        o = o * alpha[..., None] + torch.einsum("hqk,khd->hqd", pv,
                                                vv[keys])
        m = m_new
    out = (o / l.clamp_min(1e-30)[..., None]).permute(1, 0, 2)
    out[valid:] = 0
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("pool,start", [("int8", 0), ("int8", 200),
                                        ("bf16", 0)])
def test_tensor_core_prefill_rounding_within_bf16_tolerance(pool, start):
    # one GPT-2 small head width, a 256-row chunk (four 64-row tiles),
    # starting at 0 or mid-page after 200 tokens of context
    rng = np.random.RandomState(11 + start)
    nh, dh, ps, maxp, c = 4, 64, 16, 32, 256
    row = torch.from_numpy((1 + rng.permutation(maxp)).astype(np.int32))
    q = torch.from_numpy(rng.randn(c, nh, dh).astype(np.float32)
                         ).to(torch.bfloat16)
    if pool == "int8":
        kq, vq, ks, vs = map(torch.from_numpy,
                             _int8_pools(rng, 1 + maxp, nh, dh, ps))
        sc = (ks, vs)
    else:
        kq, vq = (torch.from_numpy(rng.randn(1 + maxp, ps, nh, dh).astype(
            np.float32)).to(torch.bfloat16) for _ in "kv")
        sc = ()
    got = _mma_prefill_emulation(q, kq, vq, row, start, c, *sc)
    ref = pa._plain_prefill_attention(q[None], kq, vq, row, start, c,
                                      *sc)[0]
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err


def _split_ranges(n_splits, pages_per_slot, npages):
    """Page range [first, end) each split of a row walks in the split
    decode loop: ceil(pages_per_slot / n_splits) pages each, cut at the
    row's ``npages``; empty for a split wholly past it."""
    per = -(-pages_per_slot // n_splits)
    return [(min(s * per, npages), min((s + 1) * per, npages))
            for s in range(n_splits)]


def _split_decode_emulation(q, kp, vp, pt, pos, n_splits, ks=None,
                            vs=None):
    """The arithmetic of the split decode loop
    (`kernels/csrc/paged_decode_split.cuh`) in plain torch: each split of a
    row takes its page range (`_split_ranges`), cut at the row's
    length-aware stop, forms s = (q . k) / sqrt(dh), times the key's
    k_scale for int8 pools (the scale after the product), and keeps
    (m, l, acc) with p (times v_scale for int8 pools) against the pool's
    values; a split past the row's last page is empty (m = -inf, l = 0) and
    weighs 0 in the merge. All f32; the output in q's dtype. Float pools
    (``ks`` None) carry no scales."""
    b, nh, dh = q.shape
    ps, maxp = kp.shape[1], pt.shape[1]
    scale = torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32)
    kflat, vflat = kp.reshape(-1, nh, dh), vp.reshape(-1, nh, dh)
    if ks is None:
        ksf = vsf = torch.ones(kflat.shape[0], nh)
    else:
        ksf, vsf = ks.reshape(-1, nh), vs.reshape(-1, nh)
    out = torch.zeros(b, nh, dh)
    for bi in range(b):
        p_ = int(pos[bi])
        npages = cpre_dec.pages_needed(p_, ps, maxp)
        nkeys = min(p_ + 1, maxp * ps)
        parts = []
        for first, end in _split_ranges(n_splits, maxp, npages):
            kb, ke = first * ps, min(end * ps, nkeys)
            if ke <= kb:
                parts.append((torch.full((nh,), -np.inf), torch.zeros(nh),
                              None))
                continue
            keys = torch.arange(kb, ke)
            slots = pt[bi, keys // ps].long() * ps + keys % ps
            s = torch.einsum("hd,lhd->hl", q[bi].float(),
                             kflat[slots].float())
            s = s * (ksf[slots].T * scale)
            m = s.amax(-1)
            pr = torch.exp(s - m[:, None])
            acc = torch.einsum("hl,lhd->hd", pr * vsf[slots].T,
                               vflat[slots].float())
            parts.append((m, pr.sum(-1), acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        tot_l, tot = torch.zeros(nh), torch.zeros(nh, dh)
        for m, l_, acc in parts:
            if acc is None:
                continue
            w = torch.exp(m - mx)
            tot_l += w * l_
            tot += w[:, None] * acc
        out[bi] = tot / tot_l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


# (b, maxp, pos, n_splits, against Pallas): pos 0 (every split but the
# first empty); 3 splits over 5 pages (not dividing: 2 + 2 + 1); more
# splits than pages (5 over 3: two empty for every row); a row at
# capacity on the trash page (the Pallas kernel lacks the clamp, C2: held
# against the XLA arm and the plain version only)
SPLIT_CASES = {
    "pos_zero": (2, 4, [0, 0], 4, True),
    "uneven": (3, 5, [0, 9, 19], 3, True),
    "more_splits_than_pages": (2, 3, [5, 11], 5, True),
    "capacity_trash_row": (2, 3, [5, 12], 2, False),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_int8_decode_emulation_matches_pallas_and_plain(name):
    b, maxp, pos, n_splits, pallas = SPLIT_CASES[name]
    args = list(_decode_case(5, b=b, maxp=maxp, pos=pos))
    if name == "capacity_trash_row":
        args[3][1] = 0                   # inactive slot: all trash
    q, kq, vq, pt, pos_, ks, vs = map(torch.from_numpy, args)
    got = _split_decode_emulation(q, kq, vq, pt, pos_, n_splits, ks, vs)
    plain = pa._plain_paged_attention(q, kq, vq, pt, pos_, ks, vs)
    assert _maxabs(got, plain) <= 2e-5
    ja = list(map(jnp.asarray, args))
    want = jpa._xla_paged_attention(*ja[:5], k_scale=ja[5], v_scale=ja[6])
    assert _maxabs(got, want) <= 2e-5
    if pallas:
        want_pl = jdec.paged_attention(*ja[:5], k_scale=ja[5],
                                       v_scale=ja[6], interpret=True)
        assert _maxabs(got, want_pl) <= 2e-5


def _float_split_case(seed, b, maxp, pos, dtype):
    """q and float pools of ``dtype`` (drawn in f32 and rounded), the page
    table and positions, as numpy f32 / int32: the same values for both
    packages."""
    rng = np.random.RandomState(seed)
    num_pages = 1 + b * maxp
    arrays = [rng.randn(*shape).astype(np.float32) for shape in
              ((b, NH, DH), (num_pages, PS, NH, DH), (num_pages, PS, NH, DH))]
    if dtype == torch.bfloat16:
        arrays = [torch.from_numpy(a).to(dtype).float().numpy()
                  for a in arrays]
    pt = (1 + rng.permutation(num_pages - 1)[:b * maxp]).reshape(b, maxp)
    return [*arrays, pt.astype(np.int32), np.asarray(pos, np.int32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_float_decode_emulation_matches_pallas_and_plain(name, dtype):
    """The split loop over float pools (no scales): the emulation in q's
    dtype against the plain version on the same tensors and against the
    JAX arms on the same values in f32; 2e-5 in f32, and in bf16 the card
    tests' 2e-2 (the outputs rounded to bf16 on one side)."""
    b, maxp, pos, n_splits, pallas = SPLIT_CASES[name]
    args = _float_split_case(6, b, maxp, pos, dtype)
    if name == "capacity_trash_row":
        args[3][1] = 0                   # inactive slot: all trash
    q, kp, vp = (torch.from_numpy(a).to(dtype) for a in args[:3])
    pt, pos_ = map(torch.from_numpy, args[3:])
    got = _split_decode_emulation(q, kp, vp, pt, pos_, n_splits)
    assert got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    plain = pa._plain_paged_attention(q, kp, vp, pt, pos_)
    assert _maxabs(_np(got), _np(plain)) <= tol
    ja = list(map(jnp.asarray, args))
    assert _maxabs(_np(got), jpa._xla_paged_attention(*ja)) <= tol
    if pallas:
        want_pl = jdec.paged_attention(*ja, interpret=True)
        assert _maxabs(_np(got), want_pl) <= tol


def test_split_rule_depends_on_shapes_only():
    # GPT-2 small's 12 heads, 64 pages of 16 a slot, 132 SMs: splits of 8
    # pages (128 keys) up to B=12, then fewer as the rows fill the card;
    # ranges cover the slot once and stop at the row's pages
    assert cpre_dec.splits(8, 12, 64, 16, 132) == 8
    assert cpre_dec.splits(1, 12, 64, 16, 132) == 8
    assert cpre_dec.splits(32, 12, 64, 16, 132) == 3
    assert cpre_dec.splits(88, 12, 64, 16, 132) == 1
    assert cpre_dec.splits(1, 12, 64, 64, 132) == 32     # 2 pages of 64
    assert cpre_dec.splits(1, 1, 3, 8, 132) == 1       # 24 keys: one group
    assert cpre_dec.splits(1, 1, 40, 4, 132) == 2
    assert cpre_dec.grid(8, 12, 64, 16, 132, 64) == (96, 8)
    assert cpre_dec.grid(8, 12, 64, 16, 132, 40) == (8, 12)
    assert [cpre_dec.arm(d) for d in (16, 64, 256, 40, 272)] == [
        "split", "split", "split", "per_head", "per_head"]
    for b, nh, maxp, ps in ((8, 12, 64, 16), (1, 12, 64, 16), (3, 2, 5, 4),
                            (1, 1, 1, 16), (2, 3, 1000, 1)):
        n = cpre_dec.splits(b, nh, maxp, ps, 132)
        ranges = _split_ranges(n, maxp, maxp)
        assert 1 <= n <= min(maxp, cpre_dec.MAX_SPLITS)
        assert ranges[0][0] == 0 and ranges[-1][1] == maxp
        assert all(a < e for a, e in ranges)        # none empty by shape
        assert all(ranges[i][1] == ranges[i + 1][0] for i in range(n - 1))
    assert _split_ranges(3, 64, 1) == [(0, 1), (1, 1), (1, 1)]


# ------------------------------------------------------------ weight int8

def _weights(seed):
    """GPT state_dict arrays drawn with numpy; non-trivial layernorm scales
    and biases, so every parameter reaches the logits."""
    rng = np.random.RandomState(seed)
    h, f = SMALL["hidden_size"], SMALL["intermediate_size"]

    def n(*shape, std=0.1):
        return (rng.randn(*shape) * std).astype(np.float32)

    w = {"gpt.wte.weight": n(SMALL["vocab_size"], h),
         "gpt.wpe.weight": n(SMALL["max_position_embeddings"], h),
         "gpt.ln_f.weight": 1 + n(h), "gpt.ln_f.bias": n(h)}
    for i in range(SMALL["num_layers"]):
        p = f"gpt.h.{i}."
        w.update({p + "ln_1.weight": 1 + n(h), p + "ln_1.bias": n(h),
                  p + "attn.qkv_proj.weight": n(h, 3 * h),
                  p + "attn.qkv_proj.bias": n(3 * h),
                  p + "attn.out_proj.weight": n(h, h),
                  p + "attn.out_proj.bias": n(h),
                  p + "ln_2.weight": 1 + n(h), p + "ln_2.bias": n(h),
                  p + "mlp.fc_in.weight": n(h, f),
                  p + "mlp.fc_in.bias": n(f),
                  p + "mlp.fc_out.weight": n(f, h),
                  p + "mlp.fc_out.bias": n(h)})
    return w


def _check_quantized(tq, jq):
    """Port and JAX quantized dicts: same keys, matmul leaves with equal
    int8 values and scales, everything else equal."""
    assert set(tq) == set(jq)
    for k, leaf in tq.items():
        if isinstance(leaf, QuantizedLeaf):
            assert isinstance(jq[k], jserving.QuantizedLeaf), k
            assert leaf.q.dtype == torch.int8 and leaf.dtype_name == \
                jq[k].dtype_name
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(jq[k].q))
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(jq[k].scale))
        else:
            np.testing.assert_array_equal(_np(leaf), _np(jq[k]))


def test_quantize_gpt_params_state_dict_matches_jax():
    w = _weights(0)
    tp = params_from_numpy(w, "cpu")
    tq = quantize_gpt_params(tp)
    jq = jserving.quantize_gpt_params({k: jnp.asarray(v) for k, v in w.items()})
    _check_quantized(tq, jq)
    n_q = sum(isinstance(v, QuantizedLeaf) for v in tq.values())
    assert n_q == 4 * SMALL["num_layers"]
    # non-matmul leaves pass through by reference; scales broadcast [1, out]
    assert tq["gpt.h.0.ln_1.bias"] is tp["gpt.h.0.ln_1.bias"]
    assert tq["gpt.wte.weight"] is tp["gpt.wte.weight"]
    leaf = tq["gpt.h.1.mlp.fc_in.weight"]
    assert tuple(leaf.scale.shape) == (1, SMALL["intermediate_size"])
    err = (leaf.dequant() - tp["gpt.h.1.mlp.fc_in.weight"]).abs()
    assert bool((err <= leaf.scale / 2 + 1e-7).all())
    with pytest.raises(ValueError, match="weight_dtype"):
        quantize_gpt_params(tp, dtype="fp8")
    # bf16 weights: int8 and scales still equal, dequant back in bf16
    w16 = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in w.items()}
    tq16 = quantize_gpt_params(params_from_numpy(w16, "cpu"))
    _check_quantized(tq16, jserving.quantize_gpt_params(
        {k: jnp.asarray(v) for k, v in w16.items()}))
    assert tq16["gpt.h.0.attn.qkv_proj.weight"].dequant().dtype == \
        torch.bfloat16


def test_quantize_stacked_layout_usable_in_scan():
    w = _weights(1)
    tstacked = tgpt.stack_gpt_params(params_from_numpy(w, "cpu"))
    jstacked = jgpt.stack_gpt_params({k: jnp.asarray(v) for k, v in w.items()})
    tq = quantize_gpt_params(tstacked)
    jq = jserving.quantize_gpt_params(jstacked)
    for suffix, leaf in tq["blocks"].items():
        if isinstance(leaf, QuantizedLeaf):
            assert tuple(leaf.scale.shape) == (NL, 1, leaf.shape[-1])
            np.testing.assert_array_equal(leaf.q.numpy(),
                                          np.asarray(jq["blocks"][suffix].q))
            np.testing.assert_array_equal(
                leaf.scale.numpy(), np.asarray(jq["blocks"][suffix].scale))
        else:
            assert leaf is tstacked["blocks"][suffix]
    assert sum(isinstance(v, QuantizedLeaf)
               for v in tq["blocks"].values()) == 4
    ids = np.random.RandomState(4).randint(0, SMALL["vocab_size"], (2, 8))
    ids = ids.astype(np.int32)
    tcfg = tgpt.GPTConfig(**SMALL)
    jcfg = jgpt.GPTConfig(**SMALL, hidden_dropout=0.0, attention_dropout=0.0)
    lg_q = tgpt.scan_logits(tq, torch.from_numpy(ids), tcfg)
    lg_f = tgpt.scan_logits(tstacked, torch.from_numpy(ids), tcfg)
    jlg_q = jgpt.scan_logits(jq, jnp.asarray(ids), jcfg, training=False)
    assert _maxabs(lg_q, jlg_q) <= STEP_TOL
    diff, ok = margin_gated_parity(lg_f, lg_q, QUANT_LOGIT_BOUND)
    assert ok and 0 < diff


# ------------------------------------------------------------- step functions

def _pool_state(seed, num_pages=12):
    """int8 pools holding earlier tokens, and their scales, as numpy."""
    rng = np.random.RandomState(seed)
    shape = (NL, num_pages, PS, NH, DH)
    kq = rng.randint(-127, 128, shape).astype(np.int8)
    vq = rng.randint(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, shape[:4]).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, shape[:4]).astype(np.float32)
    return kq, vq, ks, vs


def _check_int8_pools(tpools, jpools, report):
    """Scales within 1e-6 relative, int8 values equal or one step apart in
    a few elements, all but the trash page (padding rows land there in an
    unspecified order on both sides)."""
    tk, tv, tks, tvs = (t.numpy()[:, 1:] for t in tpools)
    jk, jv, jks, jvs = (np.asarray(a)[:, 1:] for a in jpools)
    for t, j in ((tks, jks), (tvs, jvs)):
        assert np.all(np.abs(t - j) <= 1e-6 * np.abs(j)), "scales differ"
    steps = [np.abs(t.astype(np.int32) - j.astype(np.int32))
             for t, j in ((tk, jk), (tv, jv))]
    off = sum(int((s > 0).sum()) for s in steps)
    report.append((off, sum(s.size for s in steps)))
    assert max(int(s.max()) for s in steps) <= 1
    assert off <= 4, f"{off} int8 values one step apart"


def _both_params(seed):
    w = _weights(seed)
    return ({k: jnp.asarray(v) for k, v in w.items()},
            params_from_numpy(w, "cpu"),
            jgpt.GPTConfig(**SMALL), tgpt.GPTConfig(**SMALL))


def test_decode_step_int8_matches_jax():
    jp, tp, jcfg, tcfg = _both_params(0)
    kq, vq, ks, vs = _pool_state(1)
    rng = np.random.RandomState(2)
    table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [0, 0, 0]], np.int32)
    lengths = np.array([3, 4, 9, 11], np.int32)
    mask = np.array([True, True, True, False])
    ids = rng.randint(0, SMALL["vocab_size"], 4).astype(np.int32)
    jl, jc = jgpt.decode_step(
        jp, jnp.asarray(ids),
        dict(k_pages=jnp.asarray(kq), v_pages=jnp.asarray(vq),
             k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
             page_table=jnp.asarray(table), lengths=jnp.asarray(lengths)),
        jnp.asarray(mask), cfg=jcfg)
    pools = [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs)]
    tl, tc = tgpt.decode_step(
        tp, torch.from_numpy(ids),
        dict(k_pages=pools[0], v_pages=pools[1], k_scale=pools[2],
             v_scale=pools[3], page_table=torch.from_numpy(table),
             lengths=torch.from_numpy(lengths)),
        torch.from_numpy(mask), cfg=tcfg)
    assert _maxabs(tl, jl) <= STEP_TOL
    assert tc["k_scale"] is pools[2]          # written in place
    report = []
    _check_int8_pools(pools, [jc[k] for k in ("k_pages", "v_pages",
                                              "k_scale", "v_scale")], report)
    print("decode_step int8 values one step apart:", report)


@pytest.mark.parametrize("length,bucket", [(11, 16), (8, 8), (1, 8)])
def test_prefill_step_int8_matches_jax(length, bucket):
    jp, tp, jcfg, tcfg = _both_params(2)
    kq, vq, ks, vs = _pool_state(3)
    rng = np.random.RandomState(4)
    row = np.array([5, 2, 9, 0], np.int32)
    ids = np.zeros(bucket, np.int32)
    ids[:length] = rng.randint(0, SMALL["vocab_size"], length)
    jout = jgpt.prefill_step(jp, jnp.asarray(ids), jnp.int32(length),
                             jnp.asarray(row), jnp.asarray(kq),
                             jnp.asarray(vq), cfg=jcfg,
                             k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    pools = [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs)]
    tout = tgpt.prefill_step(tp, torch.from_numpy(ids), length,
                             torch.from_numpy(row), pools[0], pools[1],
                             cfg=tcfg, k_scale=pools[2], v_scale=pools[3])
    assert len(tout) == len(jout) == 5
    assert _maxabs(tout[0], jout[0]) <= STEP_TOL
    report = []
    _check_int8_pools(pools, jout[1:], report)
    print("prefill_step int8 values one step apart:", report)


@pytest.mark.parametrize("start,valid,c", [(8, 5, 8), (6, 8, 8), (0, 3, 4)])
def test_prefill_chunk_step_int8_matches_jax(start, valid, c):
    jp, tp, jcfg, tcfg = _both_params(4)
    kq, vq, ks, vs = _pool_state(5)   # positions < start: earlier chunks
    rng = np.random.RandomState(6)
    row = np.array([3, 7, 1, 10], np.int32)
    ids = np.zeros(c, np.int32)
    ids[:valid] = rng.randint(0, SMALL["vocab_size"], valid)
    jout = jgpt.prefill_chunk_step(
        jp, jnp.asarray(ids), jnp.int32(start), jnp.int32(valid),
        jnp.asarray(row), jnp.asarray(kq), jnp.asarray(vq), cfg=jcfg,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    pools = [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs)]
    tout = tgpt.prefill_chunk_step(tp, torch.from_numpy(ids), start, valid,
                                   torch.from_numpy(row), pools[0], pools[1],
                                   cfg=tcfg, k_scale=pools[2],
                                   v_scale=pools[3])
    assert len(tout) == len(jout) == 5
    assert _maxabs(tout[0], jout[0]) <= STEP_TOL
    report = []
    _check_int8_pools(pools, jout[1:], report)
    print("prefill_chunk_step int8 values one step apart:", report)


def test_step_needs_both_scale_pools():
    _, tp, _, tcfg = _both_params(0)
    kq, vq, ks, _ = map(torch.from_numpy, _pool_state(1))
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tgpt.prefill_step(tp, torch.zeros(8, dtype=torch.int32), 3,
                          torch.tensor([1, 2], dtype=torch.int32), kq, vq,
                          cfg=tcfg, k_scale=ks)


# ------------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def models():
    w = _weights(11)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    jm.set_state_dict(w)
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL))
    tm.set_state_dict(params_from_numpy(w, "cpu"))
    return jm, tm, w


PROMPT_LENS = (3, 13, 21, 5, 9)   # chunked (> 8) and one-shot, 5 > 2 slots
ECFG = dict(page_size=PS, max_slots=2, min_bucket=8)


def _prompts():
    rng = np.random.RandomState(12)
    return [rng.randint(0, SMALL["vocab_size"], n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, prompts, n=7):
    reqs = [engine.submit(p, max_new_tokens=n) for p in prompts]
    engine.run_until_idle(max_steps=400)
    return [r.result(timeout=30) for r in reqs]


@pytest.mark.parametrize("quant,chunk", [
    (dict(kv_dtype="int8"), 8),
    (dict(weight_dtype="int8"), None),
    (dict(kv_dtype="int8", weight_dtype="int8"), 8)])
def test_engine_int8_tokens_equal_jax_engine(models, quant, chunk):
    jm, tm, _ = models
    prompts = _prompts()
    kw = dict(ECFG, prefill_chunk_tokens=chunk, **quant)
    want = _serve(JEngine(jm, JConfig(**kw)), prompts)
    eng = DecodeEngine(tm, EngineConfig(**kw), device="cpu")
    got = _serve(eng, prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    if "kv_dtype" in quant:
        assert eng._kc.dtype == torch.int8
        assert tuple(eng._ks.shape) == tuple(eng._kc.shape[:4])
    if "weight_dtype" in quant:
        assert isinstance(eng._params["gpt.h.0.mlp.fc_in.weight"],
                          QuantizedLeaf)


def test_engine_int8_one_shot_equals_chunked(models):
    _, tm, _ = models
    prompts = _prompts()
    outs = [_serve(DecodeEngine(tm, EngineConfig(**ECFG, kv_dtype="int8",
                                                 prefill_chunk_tokens=chunk),
                                device="cpu"), prompts)
            for chunk in (None, 4)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_engine_kv_bytes_and_refusals(models):
    jm, tm, _ = models
    nl, nh = SMALL["num_layers"], SMALL["num_heads"]
    dh = SMALL["hidden_size"] // nh
    f32 = DecodeEngine(tm, EngineConfig(**ECFG), device="cpu")
    i8 = DecodeEngine(tm, EngineConfig(**ECFG, kv_dtype="int8"),
                      device="cpu")
    assert f32.kv_bytes_per_token == 2 * nl * nh * dh * 4
    assert i8.kv_bytes_per_token == nl * 2 * (nh * dh + 4 * nh)
    assert i8.kv_bytes_per_token == JEngine(
        jm, JConfig(**ECFG, kv_dtype="int8")).kv_bytes_per_token
    # a float kv_dtype equal to the weights' is the native pool
    same = DecodeEngine(tm, EngineConfig(**ECFG, kv_dtype="f32"),
                        device="cpu")
    assert same._kc.dtype == torch.float32 and same._ks is None
    with pytest.raises(ValueError, match="kv_dtype"):
        DecodeEngine(tm, EngineConfig(**ECFG, kv_dtype="fp4"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        DecodeEngine(tm, EngineConfig(**ECFG, kv_dtype="bf16"), device="cpu")
    with pytest.raises(ValueError, match="weight_dtype"):
        DecodeEngine(tm, EngineConfig(**ECFG, weight_dtype="fp8"),
                     device="cpu")


def test_jax_quantized_params_carry_across(models):
    """`params_from_numpy` turns a JAX `quantize_gpt_params` dict into the
    port's leaves bit for bit, and an engine serving them emits the tokens
    of the port's own weight quantization."""
    _, tm, w = models
    jq = jserving.quantize_gpt_params({k: jnp.asarray(v)
                                       for k, v in w.items()})
    carried = params_from_numpy(jq, "cpu")
    own = quantize_gpt_params({k: v.detach()
                               for k, v in torch_state(tm).items()})
    _check_quantized(carried, jq)
    for k, leaf in own.items():
        if isinstance(leaf, QuantizedLeaf):
            assert torch.equal(leaf.q, carried[k].q)
            assert torch.equal(leaf.scale, carried[k].scale)
    prompts = _prompts()[:3]
    cfg = EngineConfig(**ECFG, kv_dtype="int8", weight_dtype="int8")
    want = _serve(DecodeEngine(tm, cfg, device="cpu"), prompts)
    eng = DecodeEngine(tm, EngineConfig(**ECFG, kv_dtype="int8"),
                       device="cpu")
    eng._params = carried          # serve the carried-over weights
    for g, x in zip(_serve(eng, prompts), want):
        np.testing.assert_array_equal(g, x)
