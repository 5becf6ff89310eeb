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
`csrc/flash_dkv.cu` (``"cuda_core"``).
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels._build import CudaKernel
from paddle_tpu_torch.kernels.cuda import (DTYPE_CODES, MAX_HEAD_DIM,
                                           require_cuda)

__all__ = ["FWD", "DQ", "DKV", "MMA_BLOCK_Q", "CORE_BLOCK_Q", "MMA_DQ_BLOCK_Q",
           "MMA_BLOCK_K", "arm", "grid", "dq_arm", "dq_grid", "dkv_arm",
           "dkv_grid", "flash_fwd", "flash_dq", "flash_dkv"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD = CudaKernel("flash_fwd", "flash_fwd", [_P] * 5 + [_I] * 5 + [_F, _I, _P])
DQ = CudaKernel("flash_dq", "flash_dq", [_P] * 7 + [_I] * 5 + [_F, _I, _P])
DKV = CudaKernel("flash_dkv", "flash_dkv",
                 [_P] * 8 + [_I] * 5 + [_F, _I, _P])

MMA_BLOCK_Q = 128     # query rows a block (flash_fwd_mma.cuh, Tile)
CORE_BLOCK_Q = 64     # the CUDA-core loop's query block (flash_common.cuh)
MMA_DQ_BLOCK_Q = 128  # a dQ block's rows up to D=64, half above (dq Tile)
MMA_BLOCK_K = 64      # key rows a dK/dV block (flash_dkv_mma.cuh, kBlockK)


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
    (b, h); (query blocks, b*h) on the CUDA-core loop."""
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
    the CUDA-core loop."""
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
    loop, 64 keys a block up to D=128 and 32 above (`KeyTile`)."""
    if dkv_arm(dtype, d) == "mma_bf16":
        return int(bh), -(-int(sk) // MMA_BLOCK_K)
    return -(-int(sk) // (64 if int(d) <= 128 else 32)), int(bh)


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
