"""The row teams of the fused layernorm kernels
(`paddle_tpu_torch/kernels/csrc/fused_layernorm_fwd.cu`,
`fused_layernorm_bwd.cu`, `rowwise_common.cuh`), held on the CPU.

The kernels cannot run here, so their arithmetic is emulated in numpy
float32, team by team as they walk the rows. A row lies on a team of `tw`
warps as `team_shape` (`kernels/cuda/fused_layernorm.py`, the mirror of the
sources' own) lays it out: chunk c of `vec` elements on team lane c % (32
tw), slot c // (32 tw). Each lane adds its slots in order (products as one
fused multiply-add), the lanes of a warp meet by the shuffle butterfly
(offsets 16, 8, 4, 2, 1) and the warps of a team in turn. The forward
takes the mean, then the mean of (x - mean)^2, and y = (x - mean) * rstd *
gamma + beta. In the backward a block takes ROWS_PER_BLOCK contiguous rows,
team t its rows t, t + teams, ... in that order; each lane keeps its
dgamma / dbeta sums over those rows, and the block adds its teams' sums in
team order into one partial row. Bfloat16 inputs are widened exactly and
the outputs rounded to bf16.

The emulation is held against the plain versions
(`kernels/fused_layernorm.py::_plain_ln_fwd`, `_plain_ln_bwd` at
ROWS_PER_BLOCK rows a block) within the card tests' tolerances: y 2e-5,
mean and rstd 2e-5, dx and the partials 1e-4, each relative to the largest
value when above 1, and one bf16 step of the largest value for y and dx in
bf16; and at two small shapes against the JAX package's Pallas kernels in
interpret mode, the partials summed. Cases: fewer rows than a block has
warps, a ragged last block, and widths on both sides of the warp-row /
team boundary on the vector and the scalar path. `team_shape` is held
against the sources' constants and the kernels' limits at every width, and
the scalar path's staging of a row by aligned 16-byte blocks
(`RowStages`) is mirrored byte by byte: each row whole in its slot, no
byte read outside its tensor. The
kernels themselves are held against the plain versions on the card
(`tests/test_torch_cuda.py`).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.pallas.fused_layernorm import _bwd, _fwd
from paddle_tpu_torch.kernels import fused_layernorm as tfl
from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln

F32 = np.float32
EPS = 1e-5
CSRC = Path(tfl.__file__).resolve().parent / "csrc"
DS = [1, 64, 768, 1000, 1001, 1024, 1025, 8192]
NS = [5, 75]        # fewer rows than a block's warps; a ragged last block
CASES = [(n, d, dt, vec) for d in DS for n in NS
         for dt in ("float32", "bfloat16")
         for vec in (1, 16 // (4 if dt == "float32" else 2)) if d % vec == 0]


def _fma(a, b, c):
    """a * b + c rounded once to f32."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _lanes(a, vec, nc, tw):
    """Rows [r, d] -> [r, tw, 32, nc * vec] as the team lanes hold them,
    zeros past d."""
    r, d = a.shape
    tt = 32 * tw
    a = np.pad(a, ((0, 0), (0, tt * nc * vec - d)))
    return a.reshape(r, nc, tt, vec).transpose(0, 2, 1, 3).reshape(
        r, tw, 32, nc * vec)


def _rows(a, d, vec):
    """The inverse of `_lanes`."""
    r, tw, _, slots = a.shape
    return a.reshape(r, tw * 32, slots // vec, vec).transpose(
        0, 2, 1, 3).reshape(r, -1)[:, :d]


def _team_sum(s):
    """[r, tw, 32] lane sums -> [r]: the butterfly in each warp, then the
    warps in turn."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = (s + s[..., lanes ^ o]).astype(F32)
    tot = np.zeros(s.shape[0], F32)
    for w in range(s.shape[1]):
        tot = (tot + s[:, w, 0]).astype(F32)
    return tot


def _emulate_fwd(x, g, b, vec):
    """(y, mean, rstd) as the forward computes them: x [n, d] f32 (widened
    from x's dtype), g and b [d] f32."""
    n, d = x.shape
    nc, tw, _ = cln.team_shape(d, vec)
    xl = _lanes(x, vec, nc, tw)
    live = _lanes(np.ones((1, d), bool), vec, nc, tw)
    s = np.zeros(xl.shape[:3], F32)
    for k in range(xl.shape[-1]):
        s = (s + xl[..., k]).astype(F32)        # zeros past d add nothing
    mean = (_team_sum(s) / F32(d)).astype(F32)
    xc = np.where(live, (xl - mean[:, None, None, None]).astype(F32), F32(0))
    s = np.zeros(xl.shape[:3], F32)
    for k in range(xl.shape[-1]):
        s = _fma(xc[..., k], xc[..., k], s)
    var = (_team_sum(s) / F32(d)).astype(F32)
    rstd = (1.0 / np.sqrt(var.astype(np.float64) + EPS)).astype(F32)
    gl, bl = _lanes(g[None], vec, nc, tw), _lanes(b[None], vec, nc, tw)
    y = _fma((xc * rstd[:, None, None, None]).astype(F32), gl, bl)
    return _rows(y, d, vec), mean[:, None], rstd[:, None]


def _emulate_bwd(x, g, mu, rstd, dy, vec):
    """(dx, dgamma partials, dbeta partials) as the backward computes them,
    one partial row per ROWS_PER_BLOCK rows."""
    n, d = x.shape
    rpb = cln.ROWS_PER_BLOCK
    nc, tw, teams = cln.team_shape(d, vec)
    xl, dyl = _lanes(x, vec, nc, tw), _lanes(dy, vec, nc, tw)
    gl = _lanes(g[None], vec, nc, tw)
    xh = ((xl - mu[:, :, None, None]).astype(F32)
          * rstd[:, :, None, None]).astype(F32)
    w = (dyl * gl).astype(F32)
    s0 = np.zeros(xl.shape[:3], F32)
    s1 = np.zeros(xl.shape[:3], F32)
    for k in range(xl.shape[-1]):
        s0 = (s0 + w[..., k]).astype(F32)
        s1 = _fma(w[..., k], xh[..., k], s1)
    c1 = (_team_sum(s0) / F32(d)).astype(F32)[:, None, None, None]
    c2 = (_team_sum(s1) / F32(d)).astype(F32)[:, None, None, None]
    dx = (_fma(-xh, c2, (w - c1).astype(F32))
          * rstd[:, :, None, None]).astype(F32)
    nb = -(-n // rpb)
    dgp = np.zeros((nb, *xl.shape[1:]), F32)
    dbp = np.zeros_like(dgp)
    for blk in range(nb):
        r0, r1 = blk * rpb, min(n, blk * rpb + rpb)
        adg = np.zeros((teams, *xl.shape[1:]), F32)
        adb = np.zeros_like(adg)
        for t in range(teams):                   # team t's rows in order
            for r in range(r0 + t, r1, teams):
                adg[t] = _fma(dyl[r], xh[r], adg[t])
                adb[t] = (adb[t] + dyl[r]).astype(F32)
        for t in range(teams):                   # team 0 first
            dgp[blk] = (dgp[blk] + adg[t]).astype(F32)
            dbp[blk] = (dbp[blk] + adb[t]).astype(F32)
    return _rows(dx, d, vec), _rows(dgp, d, vec), _rows(dbp, d, vec)


def _inputs(n, d, dtype, seed):
    """x, dy [n, d] in ``dtype`` (torch) and f32 gamma, beta [d]."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=F32) * 2 + 0.5)
    dy = torch.from_numpy(rng.standard_normal((n, d), dtype=F32))
    g, b = (torch.from_numpy(rng.standard_normal(d, dtype=F32))
            for _ in "gb")
    return x.to(tdt), dy.to(tdt), g, b


def _np(t):
    return t.float().numpy()


def _round(a, dtype):
    """An f32 result stored in ``dtype``, back as f32."""
    return _np(torch.from_numpy(a).to(getattr(torch, dtype)))


def _tol(dtype, ref, f32_tol):
    big = float(np.abs(ref).max())
    f32 = f32_tol * max(1.0, big)
    return f32 if dtype == "float32" else max(f32, 2.0 ** -7 * big)


def _err(a, b):
    return float(np.abs(np.asarray(a, F32) - np.asarray(b, F32)).max())


@pytest.mark.parametrize("n,d,dtype,vec", CASES)
def test_emulated_forward_matches_plain(n, d, dtype, vec):
    x, _, g, b = _inputs(n, d, dtype, d + n)
    y, mu, rstd = _emulate_fwd(_np(x), _np(g), _np(b), vec)
    ry, rmu, rrs = (_np(t) for t in tfl._plain_ln_fwd(x, g, b, EPS))
    assert _err(_round(y, dtype), ry) <= _tol(dtype, ry, 2e-5)
    assert _err(mu, rmu) <= 2e-5 * max(1.0, float(np.abs(rmu).max()))
    assert _err(rstd, rrs) <= 2e-5 * max(1.0, float(np.abs(rrs).max()))


@pytest.mark.parametrize("n,d,dtype,vec", CASES)
def test_emulated_backward_matches_plain(n, d, dtype, vec):
    x, dy, g, b = _inputs(n, d, dtype, d + n + 1)
    _, mu, rstd = tfl._plain_ln_fwd(x, g, b, EPS)
    dx, dgp, dbp = _emulate_bwd(_np(x), _np(g), _np(mu), _np(rstd), _np(dy),
                                vec)
    rdx, rdg, rdb = (_np(t) for t in tfl._plain_ln_bwd(
        x, g, mu, rstd, dy, block_rows=cln.ROWS_PER_BLOCK))
    assert dgp.shape == rdg.shape == (-(-n // cln.ROWS_PER_BLOCK), d)
    assert _err(_round(dx, dtype), rdx) <= _tol(dtype, rdx, 1e-4)
    for got, ref in ((dgp, rdg), (dbp, rdb)):
        assert _err(got, ref) <= 1e-4 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("n,d,dtype,vec", [(37, 768, "bfloat16", 8),
                                           (70, 1025, "float32", 1)])
def test_emulation_matches_interpret_kernels(n, d, dtype, vec):
    """The Pallas kernels in interpret mode on the same inputs: y, mean,
    rstd, dx, and dgamma / dbeta as the emulated partials summed."""
    x, dy, g, b = _inputs(n, d, dtype, 7)
    jdt = getattr(jnp, dtype)
    jx, jdy = (jnp.asarray(_np(t)).astype(jdt) for t in (x, dy))
    jg, jb = jnp.asarray(_np(g)), jnp.asarray(_np(b))
    jy, jmu, jrs = _fwd(jx, jg, jb, EPS, 256, True)
    jdx, jdg, jdb = _bwd(jx, jg, jmu, jrs, jdy, 256, True)
    y, mu, rstd = _emulate_fwd(_np(x), _np(g), _np(b), vec)
    jy = np.asarray(jy.astype(jnp.float32))
    assert _err(_round(y, dtype), jy) <= _tol(dtype, jy, 2e-5)
    assert _err(mu, jmu) <= 2e-5 and _err(rstd, jrs) <= 2e-5
    dx, dgp, dbp = _emulate_bwd(_np(x), _np(g), np.asarray(jmu),
                                np.asarray(jrs), _np(dy), vec)
    jdx = np.asarray(jdx.astype(jnp.float32))
    assert _err(_round(dx, dtype), jdx) <= _tol(dtype, jdx, 1e-4)
    for got, ref in ((dgp.sum(0), jdg), (dbp.sum(0), jdb)):
        ref = np.asarray(ref)
        assert _err(got, ref) <= 1e-4 * max(1.0, float(np.abs(ref).max()))


def _constant(source, name):
    vals = re.findall(rf"constexpr int {name} = (\d+);",
                      (CSRC / source).read_text())
    assert len(vals) == 1, (source, name, vals)
    return int(vals[0])


STAGES = 3


def test_constants_match_the_sources():
    assert _constant("fused_layernorm_bwd.cu", "kRowsPerBlock") == \
        cln.ROWS_PER_BLOCK
    assert _constant("fused_layernorm_fwd.cu", "kBlockWarps") == \
        cln.FWD_WARPS
    assert _constant("fused_layernorm_bwd.cu", "kBlockWarps") == \
        cln.BWD_WARPS
    assert _constant("rowwise_common.cuh", "kMaxD") == cln.MAX_D
    assert _constant("rowwise_common.cuh", "kWarpRowElems") == \
        cln._WARP_ROW_ELEMS
    assert _constant("rowwise_common.cuh", "kTeamElems") == cln._TEAM_ELEMS
    for src in ("fused_layernorm_fwd.cu", "fused_layernorm_bwd.cu"):
        assert _constant(src, "kStages") == STAGES


@pytest.mark.parametrize("vec", [1, 4, 8])
def test_team_shape_fits_the_kernels_at_every_width(vec):
    """Every row fits its team; one warp a row up to 1024 elements (512 on
    the scalar path) and at most 32 (16) a lane; wider rows 16 elements a
    lane on 2-16 warps; blocks of at most 512 threads; an `nc` the sources
    instantiate; each kernel's shared memory within the H100's 227 KB a
    block: STAGES rows a team of x (and dy, with the backward's f32 mean
    and rstd a lane a row), in f32 on the scalar path, whose slots
    (`RowStages::slot_bytes`) hold a row's 16-byte blocks from the one
    that holds its first element, up to 32 bytes more than the row."""
    size = 2 if vec == 8 else 4
    for d in range(vec, cln.MAX_D + 1, vec):
        chunks = d // vec
        for warps, arrays in ((cln.FWD_WARPS, 1), (cln.BWD_WARPS, 2)):
            nc, tw, teams = cln.team_shape(d, vec, warps)
            tt = 32 * tw
            assert tt * nc >= chunks
            assert nc in (1, 2, 3, 4, 5, 6, 7, 8, 16)
            if tw == 1:
                assert d <= (512 if vec == 1 else 1024)
                assert nc * vec <= (16 if vec == 1 else 32)
                assert teams == warps
                assert 32 * (nc - 1) < chunks or vec == 1   # powers of 2
            else:
                assert d > (512 if vec == 1 else 1024)
                assert nc * vec == 16 and 2 <= tw <= 16
                assert 32 * nc * (tw - 1) < chunks
                assert teams == max(1, 16 // tw)
            assert tt * teams <= 512
            slot = nc * tt * vec * size
            if vec == 1:
                slot = (slot + 32 + 15) // 16 * 16
            staged = STAGES * slot
            stats = 4 * STAGES * 2 * tt if arrays == 2 else 0
            assert teams * (arrays * staged + stats) <= 227 * 1024
        assert 4 * 2 * d <= 2 * staged     # the bwd's sums fit its stages


def _stage_scalar_row(mem, start, n, d, size, row, slot_bytes):
    """`RowStages::copy` and `row` on the scalar path, in bytes: the slot
    one row of a tensor [n, d] of ``size``-byte elements at byte ``start``
    of ``mem`` fills (the aligned 16-byte blocks that hold the row, whole
    where they lie in the tensor, else the row's own elements alone), the
    bytes of ``mem`` it read, and the row's offset into the slot."""
    lo, hi = start, start + n * d * size
    rb = start + row * d * size
    re = rb + d * size
    a0 = rb & ~15
    slot = np.full(slot_bytes, 0xA5, np.uint8)
    read = []
    for k in range((re - a0 + 15) // 16):
        c = a0 + 16 * k
        assert 16 * k + 16 <= slot_bytes
        if lo <= c and c + 16 <= hi:
            spans = [(c, 16)]
        else:
            spans = [(c + b, size) for b in range(0, 16, size)
                     if rb <= c + b < re]
        for p, m in spans:
            slot[p - a0:p - a0 + m] = mem[p:p + m]
            read.append((p, m))
    return slot, rb & 15, read


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("d", [1, 7, 513, 1001, 1025, 8191])
def test_scalar_stage_holds_each_row_and_reads_inside_the_tensor(size, d):
    """On the scalar path every row staged lies whole in its slot at its
    offset, within the slot's bytes at the kernels' team shape, for a
    tensor at every element-aligned offset from 16 bytes and 1-3 rows; no
    byte outside the tensor is read."""
    rng = np.random.default_rng(d + size)
    for warps in (cln.FWD_WARPS, cln.BWD_WARPS):
        nc, tw, _ = cln.team_shape(d, 1, warps)
        slot_bytes = (nc * 32 * tw * size + 32 + 15) // 16 * 16
        for start in range(0, 16, size):
            for n in (1, 2, 3):
                mem = rng.integers(0, 256, start + n * d * size + 32,
                                   dtype=np.uint8)
                for row in range(n):
                    slot, off, read = _stage_scalar_row(
                        mem, start, n, d, size, row, slot_bytes)
                    rb = start + row * d * size
                    assert np.array_equal(slot[off:off + d * size],
                                          mem[rb:rb + d * size])
                    assert all(start <= p and p + m <= start + n * d * size
                               for p, m in read)
