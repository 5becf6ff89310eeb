#!/usr/bin/env python3
"""Where the device time of the port's train step goes, on one NVIDIA card.
Run from the repository root:

    python3 profile_train.py [--dropout | --f32]

It builds the same bf16 GPT-2 small train run as `chip_smoke.py`'s train
phase (12 layers, B=16 as 2 microbatches of 8, S=1024, AdamW with float32
masters, one fixed batch), takes 2 warm-up steps, then 3 steps under
`torch.profiler`. It prints one JSON line: the host wall time, the summed
device time of all kernels and its share of the wall, that time split into
the flash-attention kernels, the dropout kernel, the matrix products and
the rest, the kernel launches, and the kernels with the most device time.
``--dropout`` profiles `chip_smoke.py`'s train_dropout run instead
(``hidden_dropout=0.1``); ``--f32`` its train_f32 run (GPT-2 small in its
default float32, no cast to bf16: the f32 CUDA-core flash loops and f32
matrix products). The line carries the card's clocks (`chip_smoke.py::
card_clocks`), read after the profiled steps.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from paddle_tpu_torch.models import gpt as gpt_mod
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.train import ScanTrainStep

GROUPS = (("flash attention", ("flash_",)),
          ("dropout", ("dropout_kernel",)),
          ("matrix products", ("gemm", "nvjet", "cutlass", "xmma", "sm90")))


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0)


def main(steps=3, top=12):
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 1
    p_drop = cs.DROPOUT_P if "--dropout" in sys.argv[1:] else 0.0
    dtype = torch.float32 if "--f32" in sys.argv[1:] else torch.bfloat16
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    model = gpt_mod.gpt2_small(
        generator=torch.Generator().manual_seed(cs.SEED),
        hidden_dropout=p_drop, attention_dropout=0.0).to(dtype)
    step = ScanTrainStep(model, AdamW(learning_rate=1e-4, clip_norm=1.0),
                         microbatches=2, device=dev)
    x, y = cs.train_batch(np.random.default_rng(cs.SEED + 4), 16, 1024,
                          cs.VOCAB)
    for _ in range(2):
        step.step(x, y)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = [step.step(x, y) for _ in range(steps)]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kern)
    groups = {g: 0.0 for g, _ in GROUPS}
    groups["other"] = 0.0
    for e in kern:
        name = e.key.lower()
        g = next((g for g, keys in GROUPS if any(k in name for k in keys)),
                 "other")
        groups[g] += _device_us(e)
    kern.sort(key=_device_us, reverse=True)
    cs.emit({"window": "train_steps", "hidden_dropout": p_drop,
             "dtype": str(dtype).replace("torch.", ""),
             "clocks": cs.card_clocks(), "steps": steps, "losses": losses,
             "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
             "device_busy_share": busy / wall_us, "kernels": len(kern),
             "kernel_launches": sum(e.count for e in kern),
             "groups_ms": {g: t / 1e3 for g, t in groups.items()},
             "groups_share_of_busy": {g: t / busy for g, t in groups.items()},
             "top": [{"name": e.key[:80], "calls": e.count,
                      "device_ms": _device_us(e) / 1e3,
                      "share_of_busy": _device_us(e) / busy}
                     for e in kern[:top]]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
