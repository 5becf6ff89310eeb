"""The register-tiled f32 CUDA-core loops of the flash forward, dQ and
dK/dV kernels (`paddle_tpu_torch/kernels/csrc/flash_fwd.cu`, `flash_dq.cu`,
`flash_dkv.cu`), held on the CPU.

The kernels cannot run here, so their arithmetic is emulated in numpy
float32, tile by tile as the loops walk it: 64-row query tiles against key
tiles of `core_keys(D)` (64 keys up to D=128, 32 above), scores scaled
into base-2 units after the product (the loops take exp2f), the causal
mask and the ragged tails applied only on a tile that crosses the diagonal
or an end (the emulation checks that every other tile is wholly visible),
one row max a tile, each row's sum kept as 16 per-thread shares (keys tx +
16 j) added by the half-warp butterfly at the end; dQ per 64-row query
block over its key tiles up to the last visible one, P = 2^(S * scale *
log2 e - lse * log2 e), masked only on edge tiles, dQ += dS K, dQ scaled
once; dK/dV per key block
from its first query tile, `max(0, k0 - (Sk - Sq)) // 64` (the tiles
before it see none of its keys), P^T = 2^(S^T * scale * log2 e - lse *
log2 e), masked only on edge tiles, dV += P^T dO and dK += dS^T Q, dK
scaled once. Bfloat16 inputs (the CUDA-core bf16 arm, head dims the tensor
cores do not take) are widened exactly and the outputs rounded to bf16.

The emulation is held against the plain versions
(`kernels/flash_attention.py::_plain_flash_fwd` / `_plain_flash_dq` /
`_plain_flash_dkv`) within the kernels' tolerances, 2e-5 (out, lse) and
1e-4 (dQ, dK, dV) relative to the
largest value when above 1, and one bf16 step of the largest value in
bf16; and at two small shapes against the JAX package's Pallas kernels in
interpret mode. The wrapper's layout mirrors (`core_fwd_smem`,
`core_dq_layout`, `core_dkv_layout`) are held against the kernels' formulas and the H100's
227 KB a block at every head dim up to 256, and the grids' launch order
against the heaviest-first rule. The kernels themselves are held against
the plain versions on the card (`tests/test_torch_cuda.py`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.pallas.flash_attention import _bwd, _fwd
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels.cuda import flash_attention as cfa

BQ = cfa.CORE_BLOCK_Q
NEG = np.float32(-1e30)
F32 = np.float32
LOG2E = F32(1.4426950408889634)
LN2 = F32(0.6931471805599453)


def _half_warp_sum(x):
    """The shuffle butterfly over offsets 8, 4, 2, 1 of 16 per-thread values
    (last axis); every lane ends with lane 0's value."""
    lanes = np.arange(16)
    for o in (8, 4, 2, 1):
        x = (x + x[..., lanes ^ o]).astype(F32)
    return x[..., 0]


def _tile(a, r0, n):
    """Rows [r0, r0 + n) of a [S, D] array, zeros past its end."""
    t = np.zeros((n, a.shape[1]), F32)
    m = max(0, min(n, a.shape[0] - r0))
    t[:m] = a[r0:r0 + m]
    return t


def _visible(rows, keys, sq, sk, causal):
    """[rows, keys] bool: the pairs the attention sees."""
    vis = (rows[:, None] < sq) & (keys[None, :] < sk)
    if causal:
        vis &= keys[None, :] <= rows[:, None] + (sk - sq)
    return vis


def _emulate_fwd(q, k, v, scale, causal):
    """The forward loop's arithmetic: (out [BH, Sq, D], lse [BH, Sq])."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bk, off = cfa.core_keys(d), sk - sq
    kpt = bk // 16
    out = np.zeros((bh, sq, d), F32)
    lse = np.zeros((bh, sq), F32)
    for b in range(bh):
        for q0 in range(0, sq, BQ):
            rows = q0 + np.arange(BQ)
            qt = _tile(q[b], q0, BQ)
            nkb = -(-sk // bk)
            if causal:
                nkb = min(nkb, (q0 + BQ - 1 + off) // bk + 1)
            m = np.full(BQ, NEG, F32)
            share = np.zeros((BQ, 16), F32)      # keys tx + 16 j of a row
            acc = np.zeros((BQ, d), F32)
            for j in range(nkb):
                k0 = j * bk
                keys = k0 + np.arange(bk)
                kt, vt = _tile(k[b], k0, bk), _tile(v[b], k0, bk)
                s = (qt @ kt.T).astype(F32) * (F32(scale) * LOG2E)
                vis = _visible(rows, keys, sq, sk, causal)
                if k0 + bk > sk or (causal and k0 + bk - 1 > q0 + off):
                    lim = np.minimum(rows + off + 1, sk) if causal else sk
                    s = np.where(keys[None, :] < np.reshape(lim, (-1, 1)),
                                 s, NEG)
                else:   # no mask: every live row sees the whole tile
                    assert vis[rows < sq].all()
                mn = np.maximum(m, s.max(1))        # one row max a tile
                alpha = np.exp2(m - mn)
                p = np.exp2(s - mn[:, None]).astype(F32)
                rs = p.reshape(BQ, kpt, 16)
                part = np.zeros((BQ, 16), F32)
                for jj in range(kpt):               # the thread's keys in order
                    part = (part + rs[:, jj]).astype(F32)
                share = (share * alpha[:, None] + part).astype(F32)
                acc = (acc * alpha[:, None] + p @ vt).astype(F32)
                m = mn
            lc = np.maximum(_half_warp_sum(share), F32(1e-30))
            n = min(BQ, sq - q0)
            out[b, q0:q0 + n] = (acc / lc[:, None])[:n]
            lse[b, q0:q0 + n] = (m * LN2 + np.log(lc))[:n]
    return out, lse


def _emulate_dkv(q, k, v, do, lse, delta, scale, causal):
    """The dK/dV loop's arithmetic: (dk, dv) [BH, Sk, D]."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bk, off = cfa.core_keys(d), sk - sq
    nqb = -(-sq // BQ)
    dk = np.zeros((bh, sk, d), F32)
    dv = np.zeros((bh, sk, d), F32)
    for b in range(bh):
        for k0 in range(0, sk, bk):
            keys = k0 + np.arange(bk)
            kt, vt = _tile(k[b], k0, bk), _tile(v[b], k0, bk)
            first = max(0, k0 - off) // BQ if causal else 0
            # the query tiles before `first` see none of the block's keys
            rows_before = np.arange(first * BQ)
            assert not _visible(rows_before, keys, sq, sk, causal).any()
            gk = np.zeros((bk, d), F32)
            gv = np.zeros((bk, d), F32)
            for t in range(first, nqb):
                q0 = t * BQ
                rows = q0 + np.arange(BQ)
                qt, dot = _tile(q[b], q0, BQ), _tile(do[b], q0, BQ)
                ls = _tile(lse[b][:, None], q0, BQ)[:, 0] * LOG2E
                dl = _tile(delta[b][:, None], q0, BQ)[:, 0]
                st = (kt @ qt.T).astype(F32)
                dpt = (vt @ dot.T).astype(F32)
                pt = np.exp2(st * (F32(scale) * LOG2E)
                             - ls[None, :]).astype(F32)
                vis = _visible(rows, keys, sq, sk, causal).T   # [keys, rows]
                if q0 + BQ > sq or (causal and k0 + bk - 1 > q0 + off):
                    seen = rows[None, :] < sq
                    if causal:
                        seen = seen & (keys[:, None] <= rows[None, :] + off)
                    pt = np.where(seen, pt, F32(0))
                else:   # no mask: every key of the block sees every row
                    assert vis[keys < sk].all()
                dst = (pt * (dpt - dl[None, :])).astype(F32)
                gv = (gv + pt @ dot).astype(F32)
                gk = (gk + dst @ qt).astype(F32)
            n = min(bk, sk - k0)
            dk[b, k0:k0 + n] = (gk * F32(scale))[:n]
            dv[b, k0:k0 + n] = gv[:n]
    return dk, dv


def _emulate_dq(q, k, v, do, lse, delta, scale, causal):
    """The dQ loop's arithmetic: dq [BH, Sq, D]."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bk, off = cfa.core_keys(d), sk - sq
    dq = np.zeros((bh, sq, d), F32)
    for b in range(bh):
        for q0 in range(0, sq, BQ):
            rows = q0 + np.arange(BQ)
            qt, dot = _tile(q[b], q0, BQ), _tile(do[b], q0, BQ)
            # lse in base-2 units and delta, 0 past sq (zero Q, dO rows)
            lr = _tile(lse[b][:, None], q0, BQ)[:, 0] * LOG2E
            dr = _tile(delta[b][:, None], q0, BQ)[:, 0]
            nkb = -(-sk // bk)
            if causal:
                nkb = min(nkb, (q0 + BQ - 1 + off) // bk + 1)
            # the key tiles past the last visible one see none of the rows
            keys_after = np.arange(nkb * bk, sk)
            assert not _visible(rows, keys_after, sq, sk, causal).any()
            acc = np.zeros((BQ, d), F32)
            for j in range(nkb):
                k0 = j * bk
                keys = k0 + np.arange(bk)
                kt, vt = _tile(k[b], k0, bk), _tile(v[b], k0, bk)
                s = (qt @ kt.T).astype(F32)
                dp = (dot @ vt.T).astype(F32)
                p = np.exp2(s * (F32(scale) * LOG2E)
                            - lr[:, None]).astype(F32)
                vis = _visible(rows, keys, sq, sk, causal)
                if k0 + bk > sk or (causal and k0 + bk - 1 > q0 + off):
                    lim = np.minimum(rows + off + 1, sk) if causal else sk
                    p = np.where(keys[None, :] < np.reshape(lim, (-1, 1)),
                                 p, F32(0))
                else:   # no mask: every live row sees the whole tile
                    assert vis[rows < sq].all()
                ds = (p * (dp - dr[:, None])).astype(F32)
                acc = (acc + ds @ kt).astype(F32)
            n = min(BQ, sq - q0)
            dq[b, q0:q0 + n] = (acc * F32(scale))[:n]
    return dq


def _inputs(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))]


def _tol(ref, f32_tol, bf16):
    big = float(np.abs(ref).max())
    tol = f32_tol * max(1.0, big)
    return max(tol, 2.0 ** -7 * big) if bf16 else tol


def _check(dtype, bh, sq, sk, d, causal, seed):
    """The emulated forward and dK/dV against the plain versions."""
    bf16 = dtype == torch.bfloat16
    arrs = _inputs(bh, sq, sk, d, seed)
    if bf16:   # the bf16 inputs, widened exactly by the loops
        arrs = [torch.from_numpy(a).to(dtype).float().numpy() for a in arrs]
    q, k, v, do = arrs
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in arrs)
    scale = 1.0 / np.sqrt(d)
    out, lse = _emulate_fwd(q, k, v, scale, causal)
    rout, rlse = tfa._plain_flash_fwd(tq, tk, tv, scale, causal)
    if bf16:
        out = torch.from_numpy(out).to(dtype).float().numpy()
    rout = rout.float().numpy()
    assert np.abs(out - rout).max() <= _tol(rout, 2e-5, bf16)
    rlse = rlse.numpy()
    assert np.abs(lse - rlse).max() <= 2e-5 * max(1.0, np.abs(rlse).max())
    delta = (tdo.float() * torch.from_numpy(rout)).sum(-1)
    rdk, rdv = tfa._plain_flash_dkv(tq, tk, tv, tdo, torch.from_numpy(rlse),
                                    delta, scale, causal)
    dk, dv = _emulate_dkv(q, k, v, do, rlse, delta.numpy(), scale, causal)
    for got, ref in ((dk, rdk), (dv, rdv)):
        ref = ref.float().numpy()
        if bf16:
            got = torch.from_numpy(got).to(dtype).float().numpy()
        assert np.abs(got - ref).max() <= _tol(ref, 1e-4, bf16)


# (bh, sq, sk, causal): a ragged causal square, a cross-length causal
# (bottom-right diagonal), a non-causal Sq > Sk, a single row
SHAPES = [(2, 130, 130, True), (2, 64, 150, True), (1, 100, 70, False),
          (2, 1, 1, True)]
# f32 at every head-dim class (not a multiple of 4 or 8, 64, above 128
# with 32-key tiles); bf16 at head dims the tensor cores do not take
DIMS = [(torch.float32, d) for d in (16, 33, 64, 72, 200, 256)] + \
       [(torch.bfloat16, d) for d in (40, 200)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype,d", DIMS, ids=str)
def test_emulated_core_loops_match_plain(dtype, d, shape):
    bh, sq, sk, causal = shape
    assert cfa.arm(dtype, d) == cfa.dkv_arm(dtype, d) == "cuda_core"
    _check(dtype, bh, sq, sk, d, causal, seed=d + sq)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype,d", DIMS, ids=str)
def test_emulated_dq_loop_matches_plain(dtype, d, shape):
    """The dQ loop, on the plain forward's lse and delta as the backward
    takes them, against the plain dQ."""
    bh, sq, sk, causal = shape
    assert cfa.dq_arm(dtype, d) == "cuda_core"
    bf16 = dtype == torch.bfloat16
    arrs = _inputs(bh, sq, sk, d, seed=d + sq + 1)
    if bf16:   # the bf16 inputs, widened exactly by the loop
        arrs = [torch.from_numpy(a).to(dtype).float().numpy() for a in arrs]
    q, k, v, do = arrs
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in arrs)
    scale = 1.0 / np.sqrt(d)
    rout, rlse = tfa._plain_flash_fwd(tq, tk, tv, scale, causal)
    delta = (tdo.float() * rout.float()).sum(-1)
    ref = tfa._plain_flash_dq(tq, tk, tv, tdo, rlse, delta, scale,
                              causal).float().numpy()
    got = _emulate_dq(q, k, v, do, rlse.numpy(), delta.numpy(), scale,
                      causal)
    if bf16:
        got = torch.from_numpy(got).to(dtype).float().numpy()
    assert np.abs(got - ref).max() <= _tol(ref, 1e-4, bf16)


# (bh, sq, sk, d, causal, pallas block): causal square, cross-length
MATCH_JAX = [(2, 128, 128, 64, True, 64), (2, 64, 96, 32, True, 32)]


@pytest.mark.parametrize("case", MATCH_JAX, ids=str)
def test_emulated_core_loops_match_pallas(case):
    bh, sq, sk, d, causal, blk = case
    q, k, v, do = _inputs(bh, sq, sk, d, seed=sq + d)
    scale = float(1.0 / np.sqrt(d))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = _fwd(jq, jk, jv, scale, causal, blk, blk, True)
    _, jdk, jdv = _bwd(jq, jk, jv, jout, jlse, jdo, scale, causal, blk, blk,
                       True)
    out, lse = _emulate_fwd(q, k, v, scale, causal)
    ref = np.asarray(jout)
    assert np.abs(out - ref).max() <= 2e-5 * max(1.0, np.abs(ref).max())
    assert np.abs(lse - np.asarray(jlse)).max() <= 2e-5 * max(
        1.0, np.abs(np.asarray(jlse)).max())
    # the same saved out and lse on both sides, as the backward takes them
    delta = (do * ref).sum(-1)
    dk, dv = _emulate_dkv(q, k, v, do, np.asarray(jlse), delta, scale,
                          causal)
    for got, want in ((dk, jdk), (dv, jdv)):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * max(1.0,
                                                      np.abs(want).max())


@pytest.mark.parametrize("case", MATCH_JAX, ids=str)
def test_emulated_dq_loop_matches_pallas(case):
    """The dQ loop against the interpret-mode Pallas `_bwd`'s dq, both on
    the Pallas forward's out and lse."""
    bh, sq, sk, d, causal, blk = case
    q, k, v, do = _inputs(bh, sq, sk, d, seed=sq + d + 1)
    scale = float(1.0 / np.sqrt(d))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = _fwd(jq, jk, jv, scale, causal, blk, blk, True)
    jdq, _, _ = _bwd(jq, jk, jv, jout, jlse, jdo, scale, causal, blk, blk,
                     True)
    delta = (do * np.asarray(jout)).sum(-1)
    got = _emulate_dq(q, k, v, do, np.asarray(jlse), delta, scale, causal)
    want = np.asarray(jdq)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


# flash::kMaxSmem: the H100's 227 KB a block, less the kernels' static
# arrays; an SM has 228 KB, 1 KB of it reserved a block
MAX_SMEM = 232448 - 1024


def _fwd_smem(d):
    """flash_fwd.cu's layout: Q [64][ld], K and V rings of 2 stages
    [BK][ld] each, P [64][BK + 16]; ld = D rounded up to 8, plus 4."""
    bk = 64 if d <= 128 else 32
    ld = -(-d // 8) * 8 + 4
    return 4 * ((64 + 2 * 2 * bk) * ld + 64 * (bk + 16))


def _dkv_smem(d, stages):
    """flash_dkv.cu's layout: K, V [BK][ld], the Q/dO ring [stages][2 * 64]
    [ld], P^T and dS^T [BK][64 + 16], lse and delta [stages][2][64]."""
    bk = 64 if d <= 128 else 32
    ld = -(-d // 8) * 8 + 4
    return 4 * ((2 * bk + stages * 2 * 64) * ld + 2 * bk * 80
                + stages * 2 * 64)


def _dq_smem(d, kst, vst):
    """flash_dq.cu's layout: Q, dO [64][ld], the K ring [kst][BK][ld], the
    V ring [vst][BK][ld], dS [64][BK + 16]."""
    bk = 64 if d <= 128 else 32
    ld = -(-d // 8) * 8 + 4
    return 4 * ((2 * 64 + (kst + vst) * bk) * ld + 64 * (bk + 16))


def test_dq_layout_fits_every_head_dim():
    assert cfa.CORE_DQ_STAGES == (2, 1)
    for d in range(1, 257):
        kst, vst, nbytes = cfa.core_dq_layout(d)
        assert nbytes == _dq_smem(d, kst, vst) <= MAX_SMEM, d
        # V one stage; K two wherever they fit
        want = 2 if _dq_smem(d, 2, 1) <= MAX_SMEM else 1
        assert (kst, vst) == (want, 1), d
    assert [d for d in range(1, 257) if cfa.core_dq_layout(d)[0] == 1] == \
        list(range(241, 257))
    # GPT-2's D=64: two dQ blocks an SM
    assert 2 * (cfa.core_dq_layout(64)[2] + 1024) <= 228 * 1024
    assert cfa.core_dq_layout(64)[2] == 107_520


def test_layouts_fit_every_head_dim():
    assert cfa.MAX_SMEM == MAX_SMEM
    for d in range(1, 257):
        assert cfa.core_ld(d) % 8 == 4 and cfa.core_ld(d) >= d + 4
        assert cfa.core_fwd_smem(d) == _fwd_smem(d) <= MAX_SMEM, d
        stages, nbytes = cfa.core_dkv_layout(d)
        assert nbytes == _dkv_smem(d, stages) <= MAX_SMEM, d
        # two stages wherever they fit above D=64, one at or below
        want = 1 if d <= 64 or _dkv_smem(d, 2) > MAX_SMEM else 2
        assert stages == want, d
    # GPT-2's D=64: two forward and two dK/dV blocks an SM
    for nbytes in (cfa.core_fwd_smem(64), cfa.core_dkv_layout(64)[1]):
        assert 2 * (nbytes + 1024) <= 228 * 1024


def _launch_order(grid, heavy_last):
    """(query or key block, bh) of each linear block index of a CUDA-core
    grid (blocks, bh), as the kernels map it: every bh of one block index,
    the last query block first (forward) or key block 0 first (dK/dV)."""
    nb, nbh = grid
    out = []
    for lin in range(nb * nbh):
        blk = lin // nbh
        out.append((nb - 1 - blk if heavy_last else blk, lin % nbh))
    return out


@pytest.mark.parametrize("bh,s,d", [(96, 1024, 64), (3, 200, 33),
                                    (2, 65, 256)])
def test_grids_launch_the_heaviest_blocks_first(bh, s, d):
    g = cfa.grid(bh, s, torch.float32, d)
    assert g == (-(-s // BQ), bh)
    order = _launch_order(g, heavy_last=True)
    assert sorted(order) == [(i, j) for i in range(g[0]) for j in range(bh)]
    # causal work of a query block grows with its index: never increasing
    work = [min(-(-s // cfa.core_keys(d)), (qb * BQ + BQ - 1) //
                cfa.core_keys(d) + 1) for qb, _ in order]
    assert work == sorted(work, reverse=True)
    g = cfa.dkv_grid(bh, s, torch.float32, d)
    assert g == (-(-s // cfa.core_keys(d)), bh)
    order = _launch_order(g, heavy_last=False)
    assert sorted(order) == [(i, j) for i in range(g[0]) for j in range(bh)]
    # a key block sees the query tiles from max(0, k0) // 64 on
    tiles = [-(-s // BQ) - kb * cfa.core_keys(d) // BQ for kb, _ in order]
    assert tiles == sorted(tiles, reverse=True)


@pytest.mark.parametrize("bh,s,d", [(96, 1024, 64), (3, 200, 33),
                                    (2, 65, 256), (4, 130, 72)])
def test_dq_grid_launches_the_heaviest_blocks_first(bh, s, d):
    """The dQ loop's grid is the forward's: every (b, h) of the last (the
    longest causal) query block first, then of the one before."""
    for dtype in (torch.float32, torch.bfloat16):
        if cfa.dq_arm(dtype, d) != "cuda_core":
            continue
        g = cfa.dq_grid(bh, s, dtype, d)
        assert g == cfa.grid(bh, s, dtype, d) == (-(-s // BQ), bh)
        order = _launch_order(g, heavy_last=True)
        assert sorted(order) == [(i, j) for i in range(g[0])
                                 for j in range(bh)]
        # the key tiles a block walks: never increasing in launch order
        bk = cfa.core_keys(d)
        work = [min(-(-s // bk), (qb * BQ + BQ - 1) // bk + 1)
                for qb, _ in order]
        assert work == sorted(work, reverse=True)
        assert work[0] == -(-s // bk) and work[-1] == (BQ - 1) // bk + 1
