#!/usr/bin/env python3
"""Where the time of the JAX bench's training programs goes on the port,
on one NVIDIA card. Run from the repository root:

    python3 profile_static.py [gpt2 | bert | resnet50]

For each model (all three without an argument) it builds `chip_smoke.py`'s
``train_static`` / ``train_bert_static`` / ``train_resnet_static``
program (amp O2 bfloat16 on float32 masters, AdamW or, for ResNet50,
Momentum, the step under ``paddle.jit.to_static``), runs 4 warm-up calls
(the step's 2 eager runs, the capture, a replay), then 3 replays of the
captured graph under `torch.profiler`, and then 3 eager steps of the same
program (no ``to_static``) under it too. One JSON line per model and
path: the host wall a step, the device time of all kernels a step and its
share of the wall, that time split into the flash kernels, the batch
norm kernels, cuDNN's NCHW <-> NHWC transposes, the convolutions (cuDNN's
implicit-GEMM forward, data- and weight-gradient kernels), the matrix
products, copies, and the rest, the kernels a step, and the kernels with
the most device time. The line carries the card's name and power limit
and its clocks after the profiled steps. For ResNet50 one more line,
``batch_norm``: each of the step's 53 batch norms (its input shape read
by a hook) run alone, forward and backward in bfloat16 as the step runs
them: the sum a step of each one's wall between CUDA events (host work
included, the median of 5) and of the device time of its kernels under
the profiler, beside the graph step's device time.
"""
from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

GROUPS = (("flash attention", ("flash_",)),
          ("batch norm", ("partial_sums", "apply_fwd", "apply_bwd",
                          "finalize_stats", "finalize_grads")),
          ("layout transposes", ("nchwtonhwc", "nhwctonchw")),
          ("convolutions", ("implicit_gemm", "fprop", "dgrad", "wgrad",
                            "conv")),
          ("matrix products", ("gemm", "nvjet", "cutlass", "xmma", "sm90")),
          ("copies", ("copy", "memcpy")))
MODELS = {
    "gpt2": (lambda dev: cs.static_gpt(dev), cs.STATIC_LR, None, 50304,
             dict(b=cs.STATIC_BATCH, s=cs.STATIC_SEQ)),
    "bert": (lambda dev: cs.static_bert(dev), cs.BERT_LR, cs.bert_loss,
             30522, dict(b=cs.BERT_BATCH, s=cs.BERT_SEQ, labels=2)),
    "resnet50": None,
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


def batch_norm_ms(model, dev, x, reps=5):
    """The step's batch norms one at a time: each input shape read by a
    hook over one forward, then forward and backward of `batch_norm` in
    training at that shape in bfloat16 (weight and bias bfloat16, running
    statistics float32), the median of ``reps`` timed with CUDA events
    after one warm-up; then each once more under the profiler. Returns
    (wall ms a step, device ms a step, norms a step)."""
    from paddle_tpu_torch.nn.layers.norm import _BatchNormBase
    shapes = []
    handles = [sub.register_forward_pre_hook(
        lambda layer, inputs: shapes.append(tuple(inputs[0].shape)))
        for sub in model.sublayers() if isinstance(sub, _BatchNormBase)]
    with cs.paddle.no_grad(), cs.paddle.amp.auto_cast(level="O2",
                                                      dtype="bfloat16"):
        model.eval()
        model(x)
        model.train()
    for h in handles:
        h.remove()
    F = cs.paddle.nn.functional
    total, runs = 0.0, []
    for shape in shapes:
        c = shape[1]
        a = cs.paddle.to_tensor(torch.randn(shape, device=dev,
                                            dtype=torch.bfloat16))
        a.stop_gradient = False
        w = cs.paddle.to_tensor(torch.ones(c, device=dev,
                                           dtype=torch.bfloat16))
        b = cs.paddle.to_tensor(torch.zeros(c, device=dev,
                                            dtype=torch.bfloat16))
        w.stop_gradient = b.stop_gradient = False
        rm = cs.paddle.to_tensor(torch.zeros(c, device=dev))
        rv = cs.paddle.to_tensor(torch.ones(c, device=dev))
        dy = torch.randn(shape, device=dev, dtype=torch.bfloat16)

        def run(a=a, rm=rm, rv=rv, w=w, b=b, dy=dy):
            out = F.batch_norm(a, rm, rv, w, b, training=True)
            out._data.backward(dy)

        run()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        total += sorted(times)[reps // 2]
        runs.append(run)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for run in runs:
            run()
        torch.cuda.synchronize()
    device = sum(_device_us(e) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return total, device, len(shapes)


def main(steps=3):
    if not torch.cuda.is_available():
        print("profile_static: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    for name in sys.argv[1:] or list(MODELS):
        if name == "resnet50":
            (x, y), _ = cs.resnet_batches(dev, cs.RESNET_BATCH, 1)
            model, opt, step = cs.resnet_program(cs.resnet_model(dev))
        else:
            make, lr, loss, vocab, shape = MODELS[name]
            (x, y), _ = cs.static_batches(dev, vocab, shape["b"],
                                          shape["s"], 1,
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
            if path == "graph":
                graph_device_ms = line["device_ms_per_step"]
        if name == "resnet50":
            ms, device_ms, norms = batch_norm_ms(model, dev, x)
            cs.emit({"window": "batch_norm", "model": name, "card": smi,
                     "batch": cs.RESNET_BATCH, "norms_per_step": norms,
                     "ms_per_step": ms, "device_ms_per_step": device_ms,
                     "share_of_graph_device_ms": device_ms / graph_device_ms,
                     "clocks": cs.card_clocks()})
        del model, opt, step, static
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
