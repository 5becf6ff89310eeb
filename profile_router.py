#!/usr/bin/env python3
"""`chip_smoke.py`'s ``serve_router`` phase alone on one H100, and what a
process that ran it does to the host-bound phases after it. Run from the
repository root:

    python3 profile_router.py            # the phase, then incubate / train twice
    python3 profile_router.py --turns parent_check . . parent_check

The default builds the kernels, runs `serve_wire`'s in-process reference
and its ``inproc`` arm (the figures ``serve_router`` prints beside its
own), then ``serve_router`` (one JSON line an arm, as in the smoke run),
prints the card memory and thread count left after it, and then runs
``incubate`` and ``train`` twice in the same process. ``--turns`` runs
``incubate`` and ``train`` alone for each checkout given, in order, each
in a process of its own (unpack the parent into the git-ignored
``parent_check/`` with `git archive`), printing each one's times.
"""
import json
import os
import subprocess
import sys
import threading
import time

_TURN = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev = torch.device("cuda", 0)
smi = cs.nvidia_smi()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs._build.build_all()
cs.incubate_run(dev, smi)
cs.train_run(dev, smi)
'''


def turns(roots):
    for root in roots:
        r = subprocess.run([sys.executable, "-c", _TURN], cwd=root,
                           capture_output=True, text=True)
        for line in r.stdout.splitlines():
            if not line.startswith("{"):
                continue
            d = json.loads(line)
            if d.get("phase") == "incubate":
                print(root, "incubate stack_forward_ms",
                      d["stack_forward_ms"], flush=True)
            elif d.get("phase") == "train":
                print(root, "train step_ms_p50", d.get("step_ms_p50"),
                      flush=True)
        if r.returncode:
            print(root, "exit code", r.returncode, r.stderr[-2000:],
                  flush=True)
            return r.returncode
    return 0


def router_alone():
    import gc

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("profile_router: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cs._build.build_all()
    print("build_s", time.perf_counter() - t0, flush=True)
    model = cs.gpt_mod.gpt2_small(
        generator=torch.Generator().manual_seed(cs.SEED)).to(torch.bfloat16)
    rng = np.random.default_rng(cs.SEED + 2)       # serve_wire's prompts
    prompts = [rng.integers(0, min(cs.VOCAB, model.cfg.vocab_size), n)
               .astype(np.int32) for n in cs.SERVE_LENS]
    ref_eng = cs.handoff_engine(model, dev)
    refs, inproc_tps, inproc_steps = cs.timed_reference(
        ref_eng, prompts, cs.HANDOFF_NEW_TOKENS)
    del ref_eng
    torch.cuda.empty_cache()
    inproc = cs.wire_inproc(model, dev, smi, prompts, refs, inproc_tps,
                            inproc_steps, 0.0)
    wire = {"prompts": prompts, "refs": refs, "inproc_tps": inproc_tps,
            "inproc": {k: inproc[k] for k in (
                "request_wall_ms_p50", "request_wall_ms_p90",
                "tokens_per_s", "ttft_ms_p50")}}
    t0 = time.perf_counter()
    cs.serve_router(model, dev, smi, wire)
    print("serve_router_s", time.perf_counter() - t0, flush=True)
    del wire, model
    gc.collect()
    torch.cuda.empty_cache()
    print("left_after: allocated_mib",
          torch.cuda.memory_allocated() / 2**20, "reserved_mib",
          torch.cuda.memory_reserved() / 2**20, "threads",
          threading.active_count(), flush=True)
    for _ in range(2):
        cs.incubate_run(dev, smi)
        cs.train_run(dev, smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turns"]:
        sys.exit(turns(sys.argv[2:]))
    sys.exit(router_alone())
