#!/usr/bin/env python3
"""The tensor-core dK/dV loop of `flash_dkv.cu` at other block shapes, on
one NVIDIA card. Run from the repository root:

    python3 profile_dkv.py

It compiles `flash_dkv.cu` as `kernels/_build.py` does, once as it is and
once for each variant of VARIANTS (a copy of `flash_dkv_mma.cuh` with its
warps a block, blocks an SM or load stages changed), holds each against
the plain version, and times each at `chip_smoke.py`'s bf16 train and
incubate shapes (B=8, H=12, S=1024, D=64, causal and not; the same timer,
the median of 25 launches after an L2 eviction), three times in turns,
beside SDPA's forward and backward on the same inputs. One JSON line per
shape and variant.
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
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels.cuda import DTYPE_CODES

LOOP = "flash_dkv_mma.cuh"
STEM = "flash_dkv"
# variant -> [(source text, its replacement)] in LOOP
VARIANTS = {
    "4 warps, 2 blocks an SM, 3 stages": [],
    "8 warps, 1 block an SM": [
        ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
    "2 warps, 4 blocks an SM": [
        ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;"),
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 4)")],
    "2 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "4 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
}
SHAPES = [case for case in cs.FLASH_CASES if case[0] in ("train", "incubate")]


def build(root: Path) -> dict:
    """{variant: library path}, compiled in parallel; raises with nvcc's
    output on a failed build."""
    procs, libs = [], {}
    for i, (variant, edits) in enumerate(VARIANTS.items()):
        src = root / f"v{i}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        text = (src / LOOP).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{variant}: {old!r} is not in {LOOP} "
                                 "exactly once; update VARIANTS")
            text = text.replace(old, new)
        (src / LOOP).write_text(text)
        lib = src / f"lib{STEM}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
               str(lib), str(src / f"{STEM}.cu")]
        procs.append((variant, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        libs[variant] = lib
    for variant, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {variant}:\n{log}")
    return libs


def main():
    if not torch.cuda.is_available():
        print("profile_dkv: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    libs = build(_build.BUILD_DIR / "dkv_variants")
    timer = cs.Timer(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, b, h, sq, sk, d, causal in SHAPES:
        rng = np.random.default_rng(cs.SEED + sq + sk)

        def rand(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(dev, torch.bfloat16)
        q, k, v, do = rand(b * h, sq, d), rand(b * h, sk, d), \
            rand(b * h, sk, d), rand(b * h, sq, d)
        scale = 1.0 / float(np.sqrt(d))
        rout, lse = tfa._plain_flash_fwd(q, k, v, scale, causal)
        delta = (do.float() * rout.float()).sum(-1)
        rdk, rdv = tfa._plain_flash_dkv(q, k, v, do, lse, delta, scale,
                                        causal)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)]
        runs, errs = {}, {}
        for variant, lib in libs.items():
            fn = getattr(ctypes.CDLL(str(lib)), STEM)
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

            def run(fn=fn):
                rc = fn(*ptrs, b * h, sq, sk, d, int(causal), scale,
                        DTYPE_CODES[q.dtype],
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise SystemExit(f"{STEM}: cudaError {rc}")
            run()
            torch.cuda.synchronize()
            errs[variant] = max((dk.float() - rdk.float()).abs().max().item(),
                                (dv.float() - rdv.float()).abs().max().item())
            runs[variant] = run
        gq, gk, gv = (t.view(b, h, -1, d).detach().requires_grad_(True)
                      for t in (q, k, v))
        runs["sdpa forward + backward"] = lambda: sdpa(
            gq, gk, gv, is_causal=causal).backward(do.view(b, h, sq, d))
        times = {v: [] for v in runs}
        for _ in range(3):                  # in turns
            for variant, run in runs.items():
                times[variant].append(timer.ms(run))
        for variant, ms in times.items():
            cs.emit({"kernel": STEM, "variant": variant, "card": smi,
                     "shape": {"case": name, "B": b, "H": h, "Sq": sq,
                               "Sk": sk, "D": d, "causal": causal},
                     "max_abs_err": errs.get(variant),
                     "tol": min(cs.flash_tol(torch.bfloat16, r, 1e-4)
                                for r in (rdk, rdv)),
                     "ms": ms, "median_ms": float(np.median(ms))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
