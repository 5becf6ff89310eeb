#!/usr/bin/env python3
"""Where the device time of the port's serve run goes, on one NVIDIA card.
Run from the repository root:

    python3 profile_serve.py            # the native bf16 engine
    python3 profile_serve.py --int8     # int8 KV pages and int8 weights
    python3 profile_serve.py --sampled  # the fused sampler, mixed requests
    python3 profile_serve.py --spec     # speculative decode, tiled prompts
    python3 profile_serve.py --prefix   # prefix hits against cold prefills
    python3 profile_serve.py --inflight 1,2,3   # readback windows, in turns

It serves the same bf16 GPT-2 small run as `chip_smoke.py`'s serve phase
(8 requests of 7-900 prompt tokens, 32 new tokens each; with ``--int8``
its serve_int8 phase, with ``--sampled`` its serve_sampled phase, with
``--spec`` its serve_spec phase) under `torch.profiler`, in two windows:
the first step (admission: 8 one-shot prefills and the first decode step)
and the
decode steps after it. For each window it prints one JSON line: the host
wall time, the summed device time of all kernels, their share of the
wall, the number of device kernel launches (graph-launched kernels
included), the host's runtime calls that put work on the card
(`chip_smoke.py::HOST_RUNTIME_CALLS`: kernel and graph launches, async
copies), and the kernels with the most device time. Every step program
(the prefills of the admission, the decode steps) runs as a replay of
the engine's captured CUDA graphs, captured by `cs.serve_engine`'s
warm-up before the windows. These runs keep the prefix cache off.

With ``--prefix`` it serves `chip_smoke.py`'s serve_prefix requests (a
768-token system prompt shared by 8 prompts) in turns, hbm, cold, hbm,
cold: the ``hbm`` arm's engine holds the system prompt's pages (each
admission prefills only its tail), the ``cold`` arm's has the prefix
cache off. Each run has the same two windows, named
``hbm#1:admission_step`` and so on; the second round is clear of the
first profiled window's start-up.

With ``--inflight N[,N...]`` it serves `chip_smoke.py`'s serve_inflight
run (the serve phase's 8 prompts, `cs.INFLIGHT_NEW_TOKENS` new tokens
each) once for each readback window listed, in that order, on an engine
of that ``inflight`` each: the same two windows, named
``inflight=2#1:decode_steps`` and so on. No step synchronizes inside a
window (the engine's own readbacks aside), so the decode window's
device-busy share is the card's share of that run's wall.
"""
from __future__ import annotations

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from paddle_tpu_torch.models import gpt as gpt_mod


def window(name, run, top=8):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and cs.device_us(e) > 0]
    busy = sum(cs.device_us(e) for e in kern)
    kern.sort(key=cs.device_us, reverse=True)
    calls = cs.host_runtime_calls(prof)
    cs.emit({"window": name, "steps": steps, "wall_ms": wall_us / 1e3,
             "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
             "kernels": len(kern), "launches": sum(e.count for e in kern),
             "host_runtime_calls": sum(calls.values()),
             "host_runtime_calls_by_name": calls,
             "top": [{"name": e.key[:80], "calls": e.count,
                      "device_ms": cs.device_us(e) / 1e3,
                      "share_of_busy": cs.device_us(e) / busy}
                     for e in kern[:top]]})


def main():
    if not torch.cuda.is_available():
        print("profile_serve: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    model = gpt_mod.gpt2_small(
        generator=torch.Generator().manual_seed(cs.SEED)).to(torch.bfloat16)
    args = sys.argv[1:]
    if "--prefix" in args:
        for turn, arm in enumerate(("hbm", "cold") * 2):
            eng, _, prompts, _, _ = cs.prefix_engine(model, dev, arm)
            cs.emit({"engine": {"arm": arm,
                                "prefix_cache": eng.ecfg.prefix_cache}})
            profile_run(eng, prompts, [(1.0, 0, 0)] * len(prompts),
                        f"{arm}#{turn // 2 + 1}:")
            del eng
            torch.cuda.empty_cache()
        return 0
    if "--inflight" in args:
        windows = [int(k) for k in args[args.index("--inflight") + 1]
                   .split(",")]
        for turn, k in enumerate(windows):
            eng, prompts, _ = cs.serve_engine(model, dev, inflight=k)
            cs.emit({"engine": {"inflight": eng.ecfg.inflight, "turn": turn}})
            profile_run(eng, prompts, [(1.0, 0, 0)] * len(prompts),
                        f"inflight={k}#{windows[:turn + 1].count(k)}:",
                        cs.INFLIGHT_NEW_TOKENS)
            del eng
            torch.cuda.empty_cache()
        return 0
    ecfg, params = {}, [(1.0, 0, 0)] * len(cs.SERVE_LENS)
    if "--int8" in args:
        ecfg = {"kv_dtype": "int8", "weight_dtype": "int8"}
    elif "--sampled" in args:
        ecfg, params = {"sampling": True}, cs.SAMPLED_PARAMS
    elif "--spec" in args:
        ecfg = {"speculate_k": cs.SPEC_K}
    eng, prompts, _ = cs.serve_engine(model, dev, tiled="--spec" in args,
                                      **ecfg)
    cs.emit({"engine": {"kv_dtype": eng.ecfg.kv_dtype,
                        "weight_dtype": eng.ecfg.weight_dtype,
                        "sampling": eng.ecfg.sampling,
                        "speculate_k": eng.ecfg.speculate_k}})
    profile_run(eng, prompts, params)
    return 0


def profile_run(eng, prompts, params, prefix="", new_tokens=32):
    """Submit ``prompts`` (``new_tokens`` each) and profile the admission
    step, then the decode steps to the end."""
    reqs = [eng.submit(p, max_new_tokens=new_tokens, temperature=t, top_k=k,
                       seed=s)
            for p, (t, k, s) in zip(prompts, params)]
    state = {"more": True}

    def one_step():
        state["more"] = eng.step()
        return 1

    def decode_steps():
        n = 0
        while state["more"]:
            state["more"] = eng.step()
            n += 1
        return n

    window(prefix + "admission_step", one_step)
    window(prefix + "decode_steps", decode_steps)
    if not all(r.done for r in reqs):
        raise SystemExit("profile_serve: requests left unfinished")


if __name__ == "__main__":
    sys.exit(main())
