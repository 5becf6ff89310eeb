"""Wrappers of the three flash-attention kernels (`kernels/csrc/flash_fwd.cu`,
`flash_dq.cu`, `flash_dkv.cu`), the Hopper counterparts of
`paddle_tpu/kernels/pallas/flash_attention.py::_fwd_kernel`, `_dq_kernel`
and `_dkv_kernel`.

Bound on the H100: operations, the causal products over the peak rate of
the dtype (see each source's header for the design against it). The
wrappers take CUDA tensors only and always launch their kernel;
`kernels/flash_attention.py` sends CPU tensors to the plain versions.
Layout [B*H, S, D], contiguous, float32 or bfloat16.

Each of the three kernels holds two loops and picks one by the same fixed
rule before the launch (:func:`arm`, :func:`dq_arm`, :func:`dkv_arm`):
bfloat16 with a head dim that is a multiple of 16 up to 128 takes the
tensor-core loop (``"mma_bf16"``: `csrc/flash_fwd_mma.cuh`,
`csrc/flash_dq_mma.cuh`, `csrc/flash_dkv_mma.cuh`), everything else the
CUDA-core loop of `csrc/flash_fwd.cu` / `csrc/flash_dq.cu` /
`csrc/flash_dkv.cu` (``"cuda_core"``). The three CUDA-core loops are
register-tiled exact-f32 products over f32 tiles in shared memory
(`csrc/flash_common.cuh`); :func:`core_fwd_smem`, :func:`core_dq_layout`
and :func:`core_dkv_layout` mirror their shared-memory layouts, which fit
the H100's 227 KB a block at every head dim up to 256. They copy with
cp.async at whatever alignment the tensors have (16, 8 or 4 bytes a copy),
so only the tensor-core loops demand 16-byte boundaries.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels._build import CudaKernel
from paddle_tpu_torch.kernels.cuda import (DTYPE_CODES, MAX_HEAD_DIM,
                                           require_cuda)

__all__ = ["FWD", "DQ", "DKV", "MMA_BLOCK_Q", "CORE_BLOCK_Q", "MMA_DQ_BLOCK_Q",
           "MMA_BLOCK_K", "MAX_SMEM", "CORE_DKV_STAGES", "CORE_DQ_STAGES",
           "arm", "grid", "dq_arm", "dq_grid", "dkv_arm", "dkv_grid",
           "core_keys", "core_ld", "core_fwd_smem", "core_dq_layout",
           "core_dkv_layout", "flash_fwd", "flash_dq", "flash_dkv"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD = CudaKernel("flash_fwd", "flash_fwd", [_P] * 5 + [_I] * 5 + [_F, _I, _P])
DQ = CudaKernel("flash_dq", "flash_dq", [_P] * 7 + [_I] * 5 + [_F, _I, _P])
DKV = CudaKernel("flash_dkv", "flash_dkv",
                 [_P] * 8 + [_I] * 5 + [_F, _I, _P])

MMA_BLOCK_Q = 128     # query rows a block (flash_fwd_mma.cuh, Tile)
CORE_BLOCK_Q = 64     # the CUDA-core loop's query block (flash_common.cuh)
MMA_DQ_BLOCK_Q = 128  # a dQ block's rows up to D=64, half above (dq Tile)
MMA_BLOCK_K = 64      # key rows a dK/dV block (flash_dkv_mma.cuh, kBlockK)
# dynamic shared memory a block may take (flash_common.cuh, kMaxSmem): the
# H100's 227 KB opt-in limit less room for static arrays
MAX_SMEM = 232448 - 1024
# the dK/dV loop's Q/dO ring: one stage up to D=64 (two blocks an SM,
# kDkvSmallStages), two above where they fit (kDkvStages)
CORE_DKV_STAGES = 2
# the dQ loop's K ring (two stages where they fit, kDqKStages) and V ring
# (one, kDqVStages)
CORE_DQ_STAGES = (2, 1)


def core_keys(d: int) -> int:
    """Keys of a CUDA-core key tile (forward, dQ) or dK/dV block: 64 up to
    D=128, 32 above."""
    return 64 if int(d) <= 128 else 32


def core_ld(d: int) -> int:
    """Floats of a CUDA-core f32 tile row (flash_common.cuh, `tile_ld`): D
    rounded up to 8, plus 4, a stride of 4 mod 8 floats."""
    return -(-int(d) // 8) * 8 + 4


def core_fwd_smem(d: int) -> int:
    """Shared-memory bytes of a CUDA-core forward block (flash_fwd.cu,
    `core_fwd_smem`): 64 query rows, two ring stages of K and V tiles, and
    the P tile (rows of keys + 16 floats)."""
    bk = core_keys(d)
    return ((CORE_BLOCK_Q + 4 * bk) * core_ld(d)
            + CORE_BLOCK_Q * (bk + 16)) * 4


def core_dq_layout(d: int) -> tuple[int, int, int]:
    """(K stages, V stages, shared-memory bytes) of a CUDA-core dQ block
    (flash_dq.cu, `core_dq_layout`): the block's Q and dO rows, the K ring
    (CORE_DQ_STAGES[0] stages where they fit, else one), the V ring
    (CORE_DQ_STAGES[1]), and dS (rows of keys + 16 floats); the key tile
    is :func:`core_keys`."""
    bk, ld = core_keys(d), core_ld(d)

    def size(kst, vst):
        return ((2 * CORE_BLOCK_Q + (kst + vst) * bk) * ld
                + CORE_BLOCK_Q * (bk + 16)) * 4
    kst, vst = CORE_DQ_STAGES
    while (kst > 1 or vst > 1) and size(kst, vst) > MAX_SMEM:
        if vst > 1:
            vst -= 1
        else:
            kst -= 1
    return kst, vst, size(kst, vst)


def core_dkv_layout(d: int) -> tuple[int, int]:
    """(ring stages, shared-memory bytes) of a CUDA-core dK/dV block
    (flash_dkv.cu, `core_dkv_layout`): the block's K and V rows, the Q/dO
    ring (one stage up to D=64, where two blocks share an SM; above,
    CORE_DKV_STAGES where they fit, else one), P^T and dS^T (rows of 64 +
    16 floats), and each stage's lse and delta."""
    bk, ld = core_keys(d), core_ld(d)

    def size(st):
        return ((2 * bk + 2 * st * CORE_BLOCK_Q) * ld
                + 2 * bk * (CORE_BLOCK_Q + 16) + 2 * st * CORE_BLOCK_Q) * 4
    for st in range(1 if int(d) <= 64 else CORE_DKV_STAGES, 1, -1):
        if size(st) <= MAX_SMEM:
            return st, size(st)
    return 1, size(1)


def arm(dtype, d: int) -> str:
    """The loop a forward call takes, the rule of the C entry point
    (`mma_takes`): ``"mma_bf16"`` (tensor cores) for bfloat16 with ``d`` a
    multiple of 16 up to 128, else ``"cuda_core"``. float32 stays on the
    CUDA cores because the tensor cores would take it only as TF32."""
    d = int(d)
    if dtype == torch.bfloat16 and 0 < d <= 128 and d % 16 == 0:
        return "mma_bf16"
    return "cuda_core"


def grid(bh: int, sq: int, dtype, d: int) -> tuple[int, int]:
    """The forward's launch grid: (b*h, query tiles) on the tensor-core
    loop, whose blockIdx.y 0 takes the last (heaviest causal) tile of every
    (b, h); (query blocks of 64, b*h) on the CUDA-core loop, whose linear
    block index takes every (b, h) of the last query block first."""
    if arm(dtype, d) == "mma_bf16":
        return int(bh), -(-int(sq) // MMA_BLOCK_Q)
    return -(-int(sq) // CORE_BLOCK_Q), int(bh)


def dq_arm(dtype, d: int) -> str:
    """The loop a dQ call takes: the forward's rule (:func:`arm`, the C
    entry point's `mma_takes`), ``"mma_bf16"`` for bfloat16 with ``d`` a
    multiple of 16 up to 128, else ``"cuda_core"``."""
    return arm(dtype, d)


def dq_grid(bh: int, sq: int, dtype, d: int) -> tuple[int, int]:
    """The dQ launch grid: (b*h, query tiles of 128 rows up to D=64, 64
    above) on the tensor-core loop, whose blockIdx.y 0 takes the last
    (heaviest causal) tile of every (b, h); (query blocks of 64, b*h) on
    the CUDA-core loop, whose linear block index takes every (b, h) of the
    last query block first, as the forward's (:func:`grid`)."""
    if dq_arm(dtype, d) == "mma_bf16":
        rows = MMA_DQ_BLOCK_Q if int(d) <= 64 else MMA_DQ_BLOCK_Q // 2
        return int(bh), -(-int(sq) // rows)
    return -(-int(sq) // CORE_BLOCK_Q), int(bh)


def dkv_arm(dtype, d: int) -> str:
    """The loop a dK/dV call takes: the forward's rule (:func:`arm`, the C
    entry point's `mma_takes`), ``"mma_bf16"`` for bfloat16 with ``d`` a
    multiple of 16 up to 128, else ``"cuda_core"``."""
    return arm(dtype, d)


def dkv_grid(bh: int, sk: int, dtype, d: int) -> tuple[int, int]:
    """The dK/dV launch grid: (b*h, key tiles of 64) on the tensor-core
    loop, whose blockIdx.y 0 is key tile 0 (the one that sees the most
    causal query rows) of every (b, h); (key blocks, b*h) on the CUDA-core
    loop, :func:`core_keys` keys a block (64 up to D=128, 32 above), whose
    linear block index takes every (b, h) of key block 0 first."""
    if dkv_arm(dtype, d) == "mma_bf16":
        return int(bh), -(-int(sk) // MMA_BLOCK_K)
    return -(-int(sk) // core_keys(d)), int(bh)


def _require_aligned(op, tensors):
    """The tensor-core loops copy 16 bytes at a time: raise ValueError
    unless every tensor of ``tensors`` (name, tensor) starts on a 16-byte
    boundary."""
    names = [n for n, t in tensors if t.data_ptr() % 16]
    if names:
        raise ValueError(f"{op}: the tensor-core loop copies 16 bytes at a "
                         f"time; {', '.join(names)} must start on 16-byte "
                         "boundaries")


def _check(op, q, k, v, causal, extra=()):
    """Raise ValueError on anything the kernels do not take: mixed devices,
    a dtype other than f32/bf16, q/k/v (and dO) of different dtypes or
    mismatched shapes, non-contiguous tensors, D > 256, causal Sq > Sk,
    empty or too many (b*h) rows; then demand CUDA. Returns (bh, sq, sk, d).
    """
    named = [("q", q), ("k", k), ("v", v), *extra]
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"{op}: all tensors must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{op}: dtype {q.dtype} not supported; expected "
                         "float32 or bfloat16")
    for name, t in named:
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want:
            raise ValueError(f"{op}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{op}: expected q [BH, Sq, D] and k, v [BH, Sk, D],"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    for name, t in extra:
        want = (bh, sq) if name in ("lse", "delta") else (bh, sq, d)
        if tuple(t.shape) != want:
            raise ValueError(f"{op}: {name} must be {list(want)}, got "
                             f"{list(t.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{op}: head_dim {d} > {MAX_HEAD_DIM}")
    if causal and sq > sk:
        raise ValueError(f"{op}: causal attention needs seq_q <= seq_k, got "
                         f"{sq} > {sk}")
    if min(bh, sq, sk, d) == 0 or bh > 65535:
        raise ValueError(f"{op}: B*H must be in [1, 65535] and S, D > 0, got"
                         f" {tuple(q.shape)} / {tuple(k.shape)}")
    require_cuda(op, q)
    return bh, sq, sk, d


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, sm_scale, causal):
    """(out [BH, Sq, D] in q.dtype, lse [BH, Sq] f32)."""
    bh, sq, sk, d = _check("flash_fwd", q, k, v, causal)
    if arm(q.dtype, d) == "mma_bf16":
        _require_aligned("flash_fwd", (("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr(), bh, sq, sk, d, int(causal), float(sm_scale),
               DTYPE_CODES[q.dtype], _stream(q))
    return out, lse


def flash_dq(q, k, v, do, lse, delta, sm_scale, causal):
    """dQ [BH, Sq, D] in q.dtype from the saved lse and delta = rowsum(dO*O)
    (both [BH, Sq] f32)."""
    bh, sq, sk, d = _check("flash_dq", q, k, v, causal,
                           (("do", do), ("lse", lse), ("delta", delta)))
    if dq_arm(q.dtype, d) == "mma_bf16":
        _require_aligned("flash_dq", (("q", q), ("k", k), ("v", v),
                                      ("do", do)))
    dq = torch.empty_like(q)
    DQ.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq, sk, d,
              int(causal), float(sm_scale), DTYPE_CODES[q.dtype], _stream(q))
    return dq


def flash_dkv(q, k, v, do, lse, delta, sm_scale, causal):
    """(dK, dV) [BH, Sk, D] in k's dtype."""
    bh, sq, sk, d = _check("flash_dkv", q, k, v, causal,
                           (("do", do), ("lse", lse), ("delta", delta)))
    if dkv_arm(q.dtype, d) == "mma_bf16":
        _require_aligned("flash_dkv", (("q", q), ("k", k), ("v", v),
                                       ("do", do)))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    DKV.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               bh, sq, sk, d, int(causal), float(sm_scale),
               DTYPE_CODES[q.dtype], _stream(q))
    return dk, dv
