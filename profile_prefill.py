#!/usr/bin/env python3
"""Where the time of the tensor-core paged prefill kernels goes, on one
NVIDIA card. Run from the repository root:

    python3 profile_prefill.py

It compiles `paged_prefill.cu` and `paged_prefill_int8.cu` as
`kernels/_build.py` does, once as they are and once for each ablation: a
copy of `paged_prefill_mma.cuh` with one stage of the loop taken out (the
K/V copies, the int8 widening, the S = Q K^T product, the P V product).
It times each at `chip_smoke.py`'s C=1024 prefill shape (bf16 q, GPT-2
small's 12 heads of 64, page size 16, every row live; the same timer, the
median of 25 launches after an L2 eviction), three times in turns, and
prints one JSON line per kernel and variant. An ablated kernel computes
garbage: the time it saves is what that stage costs on the critical path,
not a time the kernel could reach without it.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.cuda import DTYPE_CODES

LOOP = "paged_prefill_mma.cuh"
# variant -> (source text, its replacement) in LOOP
ABLATIONS = {
    "full": None,
    "no_copies": ("    if (kt < ntiles) {\n", "    if (kt < 0) {\n"),
    "no_widen": ("      if (kt >= ntiles) return;\n",
                 "      if (kt >= 0) return;\n"),
    "no_qk": ("    for (int kc = 0; kc < KC; ++kc) {\n",
              "    for (int kc = 0; kc < 0; ++kc) {\n"),
    "no_pv": ("      for (int dp = 0; dp < DH / 16; ++dp) {\n",
              "      for (int dp = 0; dp < 0; ++dp) {\n"),
}
KERNELS = (("paged_prefill", False), ("paged_prefill_int8", True))


def build(root: Path) -> dict:
    """{(variant, stem): library path}, every variant's two kernels
    compiled in parallel; raises with nvcc's output on a failed build."""
    procs, libs = [], {}
    for variant, edit in ABLATIONS.items():
        src = root / variant
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        if edit is not None:
            text = (src / LOOP).read_text()
            if text.count(edit[0]) != 1:
                raise SystemExit(f"{variant}: {edit[0]!r} is not in {LOOP} "
                                 "exactly once; update ABLATIONS")
            (src / LOOP).write_text(text.replace(*edit))
        for stem, _ in KERNELS:
            lib = src / f"lib{stem}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
                   str(lib), str(src / f"{stem}.cu")]
            procs.append((variant, stem, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            libs[variant, stem] = lib
    for variant, stem, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {variant}/{stem}:\n{log}")
    return libs


def main():
    if not torch.cuda.is_available():
        print("profile_prefill: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    libs = build(_build.BUILD_DIR / "ablation")
    timer = cs.Timer(dev)
    c, start, valid = 1024, 0, 1024
    rng = np.random.default_rng(cs.SEED)
    for stem, quant in KERNELS:
        kp, vp, scales = cs.random_pools(rng, dev, torch.bfloat16, quant)
        row = torch.from_numpy((1 + rng.permutation(cs.NUM_PAGES - 1)
                                [:cs.MAXP]).astype(np.int32)).to(dev)
        q = torch.from_numpy(rng.standard_normal(
            (c, cs.NH, cs.DH), dtype=np.float32)).to(dev, torch.bfloat16)
        ptrs = [t.data_ptr() for t in (q, kp, vp, *(scales or ()), row)]
        # start and valid live in device memory (the kernels' ABI)
        bounds = torch.tensor([start, valid], dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        runs = {}
        for variant in ABLATIONS:
            fn = getattr(ctypes.CDLL(str(libs[variant, stem])), stem)
            fn.argtypes = ([ctypes.c_void_p] * (len(ptrs) + 2)
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])

            def run(fn=fn):
                rc = fn(*ptrs, out.data_ptr(), None, c, cs.NH, cs.DH, cs.PS,
                        cs.MAXP, bounds.data_ptr(), bounds[1:].data_ptr(),
                        64, DTYPE_CODES[q.dtype],
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise SystemExit(f"{stem}: cudaError {rc}")
            runs[variant] = run
        times = {v: [] for v in ABLATIONS}
        for _ in range(3):                  # in turns
            for variant, run in runs.items():
                times[variant].append(timer.ms(run))
        for variant, ms in times.items():
            cs.emit({"kernel": stem, "variant": variant, "card": smi,
                     "shape": {"C": c, "start": start, "valid": valid,
                               "nh": cs.NH, "dh": cs.DH,
                               "page_size": cs.PS},
                     "ms": ms, "median_ms": float(np.median(ms))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
