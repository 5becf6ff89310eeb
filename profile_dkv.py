#!/usr/bin/env python3
"""The tensor-core backward loops of `flash_dkv.cu` and `flash_dq.cu` at
other block shapes, on one NVIDIA card. Run from the repository root:

    python3 profile_dkv.py [flash_dkv | flash_dq ...]

For each kernel of LOOPS (all with no names) it compiles the kernel's
source as `kernels/_build.py` does, once as it is and once for each variant
of its VARIANTS (a copy of its tensor-core loop, LOOP, with its warps a
block, row tiles a warp, key tiles, blocks an SM or load stages changed),
holds each against the plain version, and times each at `chip_smoke.py`'s
bf16 train and incubate shapes (B=8, H=12, S=1024, D=64, causal and not;
the same timer, the median of 25 launches after an L2 eviction), three
times in turns, beside SDPA's forward and backward on the same inputs. One
JSON line per kernel, shape and variant.
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

# kernel (STEM) -> (its tensor-core loop LOOP, VARIANTS: variant ->
# [(source text, its replacement)] in LOOP)
LOOPS = {
    "flash_dkv": ("flash_dkv_mma.cuh", {
        "4 warps, 2 blocks an SM, 3 stages": [],
        "8 warps, 1 block an SM": [
            ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
            ("__launch_bounds__(kThreads, 2)",
             "__launch_bounds__(kThreads, 1)")],
        "2 warps, 4 blocks an SM": [
            ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;"),
            ("__launch_bounds__(kThreads, 2)",
             "__launch_bounds__(kThreads, 4)")],
        "2 stages": [("constexpr int kStages = 3;",
                      "constexpr int kStages = 2;")],
        "4 stages": [("constexpr int kStages = 3;",
                      "constexpr int kStages = 4;")],
    }),
    "flash_dq": ("flash_dq_mma.cuh", {
        "4 warps of 2 row tiles, 32 keys, 2 blocks an SM, 3 stages": [],
        "1 row tile a warp, 64 keys": [
            ("kRowTiles = DH <= 64 ? 2 : 1;", "kRowTiles = 1;"),
            ("kKeys = 32;", "kKeys = DH <= 64 ? 64 : 32;")],
        "1 row tile a warp, 64 keys, 3 blocks an SM": [
            ("kRowTiles = DH <= 64 ? 2 : 1;", "kRowTiles = 1;"),
            ("kKeys = 32;", "kKeys = DH <= 64 ? 64 : 32;"),
            ("kMinBlocks = 2;", "kMinBlocks = 3;")],
        "16 keys": [("kKeys = 32;", "kKeys = DH <= 64 ? 16 : 32;")],
        "2 warps, 4 blocks an SM": [("kWarps = 4;", "kWarps = 2;"),
                                    ("kMinBlocks = 2;", "kMinBlocks = 4;")],
        "8 warps, 1 block an SM": [("kWarps = 4;", "kWarps = 8;"),
                                   ("kMinBlocks = 2;", "kMinBlocks = 1;")],
        "2 stages": [("kStages = 3;", "kStages = 2;")],
        "4 stages": [("kStages = 3;", "kStages = 4;")],
    }),
}
SHAPES = [case for case in cs.FLASH_CASES if case[0] in ("train", "incubate")]


def build(root: Path, stems) -> dict:
    """{stem: {variant: library path}}, every variant of every kernel
    compiled in parallel; raises with nvcc's output on a failed build."""
    procs, libs = [], {}
    for stem in stems:
        loop, variants = LOOPS[stem]
        libs[stem] = {}
        for i, (variant, edits) in enumerate(variants.items()):
            src = root / f"{stem}_v{i}"
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(_build.CSRC, src)
            text = (src / loop).read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{variant}: {old!r} is not in {loop} "
                                     "exactly once; update VARIANTS")
                text = text.replace(old, new)
            (src / loop).write_text(text)
            lib = src / f"lib{stem}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
                   str(lib), str(src / f"{stem}.cu")]
            procs.append((stem, variant, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            libs[stem][variant] = lib
    for stem, variant, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {stem} {variant}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        cs.emit({"kernel": stem, "variant": variant, "ptxas": regs})
    return libs


def profile(stem: str, libs: dict, dev, timer, smi):
    """Times every variant of one kernel at SHAPES in turns; one line per
    shape and variant."""
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
        if stem == "flash_dq":
            refs = [tfa._plain_flash_dq(q, k, v, do, lse, delta, scale,
                                        causal)]
        else:
            refs = list(tfa._plain_flash_dkv(q, k, v, do, lse, delta, scale,
                                             causal))
        outs = [torch.empty_like(r) for r in refs]
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)]
        runs, errs = {}, {}
        for variant, lib in libs.items():
            fn = getattr(ctypes.CDLL(str(lib)), stem)
            fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                           + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

            def run(fn=fn):
                rc = fn(*ptrs, b * h, sq, sk, d, int(causal), scale,
                        DTYPE_CODES[q.dtype],
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise SystemExit(f"{stem}: cudaError {rc}")
            run()
            torch.cuda.synchronize()
            errs[variant] = max((o.float() - r.float()).abs().max().item()
                                for o, r in zip(outs, refs))
            runs[variant] = run
        gq, gk, gv = (t.view(b, h, -1, d).detach().requires_grad_(True)
                      for t in (q, k, v))
        runs["sdpa forward + backward"] = lambda: sdpa(
            gq, gk, gv, is_causal=causal).backward(do.view(b, h, sq, d))
        times = {v: [] for v in runs}
        for _ in range(3):                  # in turns
            for variant, run in runs.items():
                times[variant].append(timer.ms(run))
        tol = min(cs.flash_tol(torch.bfloat16, r, 1e-4) for r in refs)
        for variant, ms in times.items():
            err = errs.get(variant)
            cs.emit({"kernel": stem, "variant": variant, "card": smi,
                     "shape": {"case": name, "B": b, "H": h, "Sq": sq,
                               "Sk": sk, "D": d, "causal": causal},
                     "max_abs_err": err, "tol": tol,
                     "within_tol": None if err is None else err <= tol,
                     "ms": ms, "median_ms": float(np.median(ms))})


def main(argv):
    stems = argv or list(LOOPS)
    unknown = [s for s in stems if s not in LOOPS]
    if unknown:
        raise SystemExit(f"unknown kernels {unknown}; known: {list(LOOPS)}")
    if not torch.cuda.is_available():
        print("profile_dkv: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    libs = build(_build.BUILD_DIR / "variants", stems)
    timer = cs.Timer(dev)
    for stem in stems:
        profile(stem, libs[stem], dev, timer, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
