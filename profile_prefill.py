#!/usr/bin/env python3
"""Where the time of the paged prefill kernels goes, on one NVIDIA card.
Run from the repository root:

    python3 profile_prefill.py          # the tensor-core loop (bf16 q)
    python3 profile_prefill.py core     # the CUDA-core loop (f32 q)

It compiles `paged_prefill.cu` and `paged_prefill_int8.cu` as
`kernels/_build.py` does, once as they are and once for each ablation: a
copy of the loop's header (`paged_prefill_mma.cuh`, or `paged_prefill.cuh`
with ``core``) with one stage of the loop taken out (the K/V copies, the
int8 widening, the S = Q K^T product, the P V product; ``core``: the
merge of the splits' partials). It times each at
`chip_smoke.py`'s C=1024 prefill shape (GPT-2 small's 12 heads of 64,
page size 16, every row live; ``core`` also at the prefix tail, C=64 at
start 768 with 50 live rows, f32 q at the wrapper's split count; the same
timer, the median of 25 launches after an L2 eviction), three times in
turns, and prints one JSON line per kernel, shape and variant. An ablated
kernel computes garbage: the time it saves is what that stage costs on
the critical path, not a time the kernel could reach without it.
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
from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre

# loop -> (header, variant -> (source text, its replacement) in it)
LOOPS = {
    "mma": ("paged_prefill_mma.cuh", {
        "full": None,
        "no_copies": ("    if (kt < ntiles) {\n", "    if (kt < 0) {\n"),
        "no_widen": ("      if (kt >= ntiles) return;\n",
                     "      if (kt >= 0) return;\n"),
        "no_qk": ("    for (int kc = 0; kc < KC; ++kc) {\n",
                  "    for (int kc = 0; kc < 0; ++kc) {\n"),
        "no_pv": ("      for (int dp = 0; dp < DH / 16; ++dp) {\n",
                  "      for (int dp = 0; dp < 0; ++dp) {\n"),
    }),
    "core": ("paged_prefill.cuh", {
        "full": None,
        "no_copies": ("      if (i < ntiles) {\n", "      if (i < 0) {\n"),
        "no_qk": ("      for (int d = 0; d < dh4; d += 4) {\n",
                  "      for (int d = 0; d < 0; d += 4) {\n"),
        "no_pv": ("      for (int k = 0; k < BK; k += 4) {\n",
                  "      for (int k = 0; k < 0; k += 4) {\n"),
        "no_merge": ("  if (!sm_last) return;\n", "  return;\n"),
    }),
}
KERNELS = (("paged_prefill", False), ("paged_prefill_int8", True))
# loop -> (q dtype, the (case, C, start, valid) shapes it is timed at)
SHAPES = {"mma": (torch.bfloat16, (("c1024", 1024, 0, 1024),)),
          "core": (torch.float32, (("c1024", 1024, 0, 1024),
                                   ("tail", 64, 768, 50)))}


def build(root: Path, loop: str) -> dict:
    """{(variant, stem): library path}, every variant's two kernels
    compiled in parallel; raises with nvcc's output on a failed build."""
    header, ablations = LOOPS[loop]
    procs, libs = [], {}
    for variant, edit in ablations.items():
        src = root / loop / variant
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        if edit is not None:
            text = (src / header).read_text()
            if text.count(edit[0]) != 1:
                raise SystemExit(f"{variant}: {edit[0]!r} is not in "
                                 f"{header} exactly once; update LOOPS")
            (src / header).write_text(text.replace(*edit))
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
    loop = sys.argv[1] if sys.argv[1:] else "mma"
    if loop not in LOOPS:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    ablations = LOOPS[loop][1]
    libs = build(_build.BUILD_DIR / "ablation", loop)
    timer = cs.Timer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dtype, shapes = SHAPES[loop]
    rng = np.random.default_rng(cs.SEED)
    for case, c, start, valid in shapes:
        bq = cpre.default_block_q(c, dtype, cs.DH)
        nq = -(-c // bq)
        splits = 1
        part = tickets = None
        if cpre.arm(dtype, cs.DH) == "cuda_core":
            splits = cpre.core_splits(c, cs.NH, cs.DH, cs.MAXP, cs.PS, sms)
            part = torch.empty(nq * cs.NH * splits * cpre.CORE_BLOCK_Q
                               * (cs.DH + 2), dtype=torch.float32,
                               device=dev)
            tickets = torch.zeros(nq * cs.NH, dtype=torch.int32, device=dev)
        for stem, quant in KERNELS:
            kp, vp, scales = cs.random_pools(rng, dev, dtype, quant)
            row = torch.from_numpy((1 + rng.permutation(cs.NUM_PAGES - 1)
                                    [:cs.MAXP]).astype(np.int32)).to(dev)
            q = torch.from_numpy(rng.standard_normal(
                (c, cs.NH, cs.DH), dtype=np.float32)).to(dev, dtype)
            ptrs = [t.data_ptr() for t in (q, kp, vp, *(scales or ()), row)]
            # start and valid live in device memory (the kernels' ABI)
            bounds = torch.tensor([start, valid], dtype=torch.int32,
                                  device=dev)
            out = torch.empty_like(q)
            extra = [None if t is None else t.data_ptr()
                     for t in (part, tickets)]
            runs = {}
            for variant in ablations:
                fn = getattr(ctypes.CDLL(str(libs[variant, stem])), stem)
                fn.argtypes = ([ctypes.c_void_p] * (len(ptrs) + 4)
                               + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p])

                def run(fn=fn):
                    rc = fn(*ptrs, out.data_ptr(), None, *extra, c, cs.NH,
                            cs.DH, cs.PS, cs.MAXP, bounds.data_ptr(),
                            bounds[1:].data_ptr(), bq, splits,
                            DTYPE_CODES[q.dtype],
                            torch.cuda.current_stream(dev).cuda_stream)
                    if rc != 0:
                        raise SystemExit(f"{stem}: cudaError {rc}")
                runs[variant] = run
            times = {v: [] for v in ablations}
            for _ in range(3):                  # in turns
                for variant, run in runs.items():
                    times[variant].append(timer.ms(run))
            for variant, ms in times.items():
                cs.emit({"kernel": stem, "loop": loop, "case": case,
                         "variant": variant, "card": smi,
                         "clocks": cs.card_clocks(), "dtype": str(dtype),
                         "splits": splits,
                         "shape": {"C": c, "start": start, "valid": valid,
                                   "nh": cs.NH, "dh": cs.DH,
                                   "page_size": cs.PS},
                         "ms": ms, "median_ms": float(np.median(ms))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
