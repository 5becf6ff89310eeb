"""Wrappers of the hand-written CUDA kernels: argument checks, output
allocation, the launch on PyTorch's current stream, and each kernel's
launch count. They take CUDA tensors only. The kernels' sources are in
`kernels/csrc/`."""
from __future__ import annotations

import torch

# dtype codes of the C entry points (attention_common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def check_attention_args(op, q, k_pages, v_pages, int_args, scales=None):
    """Raise ValueError on anything the attention kernels do not take:
    mixed devices, a q dtype other than f32/bf16, float pools of another
    dtype than q, non-contiguous tensors, head_dim > 256, non-int32
    indices. With ``scales`` (``(k_scale, v_scale)``, the int8 kernels) the
    pools must be int8 and the scales float32 of shape
    ``[num_pages, page_size, nh]``; without, int8 pools are refused."""
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages)]
    if scales is not None:
        named += [("k_scale", scales[0]), ("v_scale", scales[1])]
    named += list(int_args.items())
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"{op}: all tensors must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{op}: dtype {q.dtype} not supported; expected "
                         "float32 or bfloat16")
    if scales is None:
        if k_pages.dtype == torch.int8 or v_pages.dtype == torch.int8:
            raise ValueError(f"{op}: int8 pools need their k_scale/v_scale "
                             "(the int8 kernel)")
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise ValueError(f"{op}: q ({q.dtype}) and the pools "
                             f"({k_pages.dtype}, {v_pages.dtype}) must share "
                             "one dtype")
    elif k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError(f"{op}: the int8 kernel takes int8 pools, got "
                         f"{k_pages.dtype} and {v_pages.dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{op}: pools must both be [num_pages, page_size, "
                         f"nh, dh], got {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    if scales is not None:
        for name, s in zip(("k_scale", "v_scale"), scales):
            if s.dtype != torch.float32 or \
                    tuple(s.shape) != tuple(k_pages.shape[:3]):
                raise ValueError(
                    f"{op}: {name} must be float32 of shape "
                    f"{tuple(k_pages.shape[:3])} (the pools' [num_pages, "
                    f"page_size, nh]), got {s.dtype} {tuple(s.shape)}")
    if tuple(k_pages.shape[2:]) != tuple(q.shape[-2:]):
        raise ValueError(f"{op}: q heads/head_dim {tuple(q.shape[-2:])} do "
                         f"not match the pools' {tuple(k_pages.shape[2:])}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{op}: head_dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    for name, t in int_args.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{op}: {name} must be int32, got {t.dtype}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def require_cuda(op, q, via="kernels/paged_attention.py"):
    """Raise ValueError unless ``q`` lies on a CUDA device: the kernels have
    no CPU mode. The device decision is `kernels/registry.py`'s, which sends
    CPU tensors to the plain versions (through the op module ``via``)
    before they reach a wrapper."""
    if not q.is_cuda:
        raise ValueError(f"{op}: the kernel takes CUDA tensors, got "
                         f"{q.device}; CPU tensors take the plain version "
                         f"through {via}")
