#!/usr/bin/env python3
"""Where the time of the JAX bench's training programs goes on the port,
on one NVIDIA card. Run from the repository root:

    python3 profile_static.py [gpt2 | bert]

For each model (both without an argument) it builds `chip_smoke.py`'s
``train_static`` / ``train_bert_static`` program (amp O2 bfloat16 on
float32 masters, AdamW, the step under ``paddle.jit.to_static``), runs 4
warm-up calls (the step's 2 eager runs, the capture, a replay), then 3
replays of the captured graph under `torch.profiler`, and then 3 eager
steps of the same program (no ``to_static``) under it too. One JSON line
per model and path: the host wall a step, the device time of all kernels
a step and its share of the wall, that time split into the flash
kernels, the matrix products, the optimizer's elementwise update and
copies, and the rest, the kernels a step, and the kernels with the most
device time. The line carries the card's name and power limit and its
clocks after the profiled steps.
"""
from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

GROUPS = (("flash attention", ("flash_",)),
          ("matrix products", ("gemm", "nvjet", "cutlass", "xmma", "sm90")),
          ("copies", ("copy", "memcpy")))
MODELS = {
    "gpt2": (lambda dev: cs.static_gpt(dev), cs.STATIC_LR, None, 50304,
             dict(b=cs.STATIC_BATCH, s=cs.STATIC_SEQ)),
    "bert": (lambda dev: cs.static_bert(dev), cs.BERT_LR, cs.bert_loss,
             30522, dict(b=cs.BERT_BATCH, s=cs.BERT_SEQ, labels=2)),
}


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0)


def profiled(run, steps):
    """``steps`` calls of ``run`` under the profiler: the wall a step, the
    kernels' device time a step by group, kernels a step, top kernels."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
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
        groups[g] += _device_us(e) / 1e3 / steps
    kern.sort(key=_device_us, reverse=True)
    return {"wall_ms_per_step": wall_us / 1e3 / steps,
            "device_ms_per_step": busy / 1e3 / steps,
            "device_share_of_wall": busy / wall_us,
            "device_ms_by_group": groups,
            "kernels_per_step": sum(e.count for e in kern) / steps,
            "top_kernels_ms_per_step": {e.key[:80]: _device_us(e) / 1e3
                                        / steps for e in kern[:10]}}


def main(steps=3):
    if not torch.cuda.is_available():
        print("profile_static: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    for name in sys.argv[1:] or list(MODELS):
        make, lr, loss, vocab, shape = MODELS[name]
        (x, y), _ = cs.static_batches(dev, vocab, shape["b"], shape["s"], 1,
                                      labels=shape.get("labels"))
        model, opt, step = cs.static_program(make(dev), lr, loss)
        static = cs.paddle.jit.to_static(step)
        for _ in range(4):
            static(x, y)
        for path, run in (("graph", lambda: static(x, y)),
                          ("eager", lambda: step(x, y))):
            line = {"window": "static_program", "model": name,
                    "path": path, "card": smi, "steps": steps,
                    **profiled(run, steps)}
            line["clocks"] = cs.card_clocks()
            cs.emit(line)
        del model, opt, step, static
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
