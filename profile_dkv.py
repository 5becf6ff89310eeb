#!/usr/bin/env python3
"""The tensor-core backward loops of `flash_dkv.cu` and `flash_dq.cu` at
other block shapes, and the stages of the f32 CUDA-core loops of
`flash_fwd.cu`, `flash_dq.cu` and `flash_dkv.cu`, on one NVIDIA card. Run
from the repository root:

    python3 profile_dkv.py [flash_dkv | flash_dq ...]
    python3 profile_dkv.py core [flash_fwd | flash_dq | flash_dkv ...]

For each kernel of LOOPS (all with no names) it compiles the kernel's
source as `kernels/_build.py` does, once as it is and once for each variant
of its VARIANTS (a copy of its tensor-core loop, LOOP, with its warps a
block, row tiles a warp, key tiles, blocks an SM or load stages changed),
holds each against the plain version, and times each at `chip_smoke.py`'s
bf16 train and incubate shapes (B=8, H=12, S=1024, D=64, causal and not;
the same timer, the median of 25 launches after an L2 eviction), three
times in turns, beside SDPA's forward and backward on the same inputs. One
JSON line per kernel, shape and variant.

``core``: for each kernel of CORE (all with no names) it compiles the
kernel's source once as it is and once for each of its CORE variants (a
copy of the source with one stage of its f32 CUDA-core loop taken out: the
K/V copies (forward, dQ) or the Q/dO copies (dK/dV), the S = Q K^T product
(forward), the S and dP products (dQ) or the S^T and dP^T products
(dK/dV), the P V product (forward), dS K (dQ) or the dV and dK products
(dK/dV); or changed: the forward's two products in two passes, dV and dK
in two passes, the dQ and dK/dV rings at other stages, key tiles and
blocks an SM), and times each at the f32 train and incubate shapes, three
times in turns, with the card's clocks beside each line. An ablated kernel computes garbage: the time it saves is what that
stage costs on the critical path, not a time the kernel could reach
without it.
"""
from __future__ import annotations

import ctypes
import re
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
# kernel (STEM) -> variant -> [(file, source text, its replacement)] for the
# f32 CUDA-core loops (``core``)
NN2 = "tile_nn2<RM, DC>(gv, pt, dot, gk, dst, qt, LDP, ld, kBlockQ, n4);"
DQ_NT2 = "tile_nt2<RM, KPT>(s, qs, kt, dp, dos, vt, ld, n4);"
DQ_NN = "tile_nn<RM, DC>(acc, dss, LDP, kt, ld, BK, n4);"
CORE = {
    "flash_fwd": {
        "full": [],
        "no_copies": [("flash_fwd.cu", "  auto load_k = [&](int j) {\n    if (j < nkb)",
                       "  auto load_k = [&](int j) {\n    if (j < 0)"),
                      ("flash_fwd.cu", "  auto load_v = [&](int j) {\n    if (j < nkb)",
                       "  auto load_v = [&](int j) {\n    if (j < 0)")],
        "no_qk": [("flash_fwd.cu", "tile_nt<RM, KPT>(s, qs, kring, ld, n4);",
                   "tile_nt<RM, KPT>(s, qs, kring, ld, 0);"),
                  ("flash_common.cuh",
                   "".join(f"        s[i][j] = fmaf(xa[i].{c}, yb[j].{c}, "
                           "s[i][j]);\n" for c in "xyzw"), "")],
        "no_pv": [("flash_fwd.cu",
                   "tile_nn<RM, DC>(acc, ps, LDP, vt, ld, BK, n4);",
                   "tile_nn<RM, DC>(acc, ps, LDP, vt, ld, 0, n4);"),
                  ("flash_common.cuh",
                   "    nn_step<RM, DC>(acc, p, x, ld, k, n / 4);\n", "")],
        "S and P V in two passes": [
            ("flash_fwd.cu", "const bool fused = DC == 1 && 4 * n4 == BK;",
             "const bool fused = false;")],
    },
    "flash_dkv": {
        "full": [],
        "no_copies": [("flash_dkv.cu", "    if (i < ntiles) {\n",
                       "    if (i < 0) {\n")],
        "no_st_dpt": [("flash_dkv.cu",
                       "tile_nt2<RM, CN>(s, ks, qt, dp, vs, dot, ld, n4);",
                       "tile_nt2<RM, CN>(s, ks, qt, dp, vs, dot, ld, 0);")],
        "no_dv_dk": [("flash_dkv.cu", NN2, NN2.replace("kBlockQ", "0"))],
        "dV and dK in two passes": [
            ("flash_dkv.cu", NN2,
             "tile_nn<RM, DC>(gv, pt, LDP, dot, ld, kBlockQ, n4); "
             "tile_nn<RM, DC>(gk, dst, LDP, qt, ld, kBlockQ, n4);")],
        "2 stages, 1 block an SM": [
            ("flash_dkv.cu", "constexpr int kDkvSmallStages = 1;",
             "constexpr int kDkvSmallStages = 2;"),
            ("flash_dkv.cu", "constexpr int kDkvMinBlocks = 2;",
             "constexpr int kDkvMinBlocks = 1;")],
        "1 stage, 1 block an SM": [
            ("flash_dkv.cu", "constexpr int kDkvMinBlocks = 2;",
             "constexpr int kDkvMinBlocks = 1;")],
    },
    "flash_dq": {
        "full": [],
        "no_copies": [("flash_dq.cu", "  auto load_k = [&](int j) {\n    if (j < nkb)",
                       "  auto load_k = [&](int j) {\n    if (j < 0)"),
                      ("flash_dq.cu", "  auto load_v = [&](int j) {\n    if (j < nkb)",
                       "  auto load_v = [&](int j) {\n    if (j < 0)")],
        "no_s_dp": [("flash_dq.cu", DQ_NT2, DQ_NT2.replace("ld, n4", "ld, 0"))],
        "no_ds_k": [("flash_dq.cu", DQ_NN, DQ_NN.replace("BK, n4", "0, n4"))],
        "K and V 2 stages, 1 block an SM": [
            ("flash_dq.cu", "constexpr int kDqVStages = 1;",
             "constexpr int kDqVStages = 2;"),
            ("flash_dq.cu", "constexpr int kDqMinBlocks = 2;",
             "constexpr int kDqMinBlocks = 1;")],
        "K and V 1 stage, 2 blocks an SM": [
            ("flash_dq.cu", "constexpr int kDqKStages = 2;",
             "constexpr int kDqKStages = 1;")],
        "K and V 2 stages of 32 keys, 2 blocks an SM": [
            ("flash_dq.cu", "constexpr int kDqVStages = 1;",
             "constexpr int kDqVStages = 2;"),
            ("flash_dq.cu", "constexpr int kDqSmallKpt = 4;",
             "constexpr int kDqSmallKpt = 2;")],
        "K 2 stages, V 1, 1 block an SM": [
            ("flash_dq.cu", "constexpr int kDqMinBlocks = 2;",
             "constexpr int kDqMinBlocks = 1;")],
    },
}
ARGTYPES = {   # the C entry points' (pointers, then ints, float, int, stream)
    "flash_fwd": 5, "flash_dkv": 8, "flash_dq": 7}
# words of the mangled kernel names whose registers and spills a build
# reports: the kernels a variant can change
PTXAS_KERNELS = ("mma", "core_kernel", "ln_fwd_kernel", "ln_bwd_kernel")


def ptxas_summary(log: str) -> dict:
    """{mangled kernel name: its registers and spills} from nvcc's -Xptxas -v
    output, for the kernels a variant can change (PTXAS_KERNELS)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        elif name and any(k in name for k in PTXAS_KERNELS) and (
                "Used" in ln or "spill" in ln):
            out[name] = (out.get(name, "") + " " + ln.split(":", 1)[-1]
                         .strip()).strip()
    return out


def build(root: Path, stems, table, csrc: Path = _build.CSRC) -> dict:
    """{stem: {variant: library path}}, every variant of every kernel of
    ``table`` ({stem: {variant: [(file, old, new)]}}, edits of the sources
    in ``csrc``) compiled in parallel; raises with nvcc's output on a
    failed build."""
    procs, libs = [], {}
    for stem in stems:
        libs[stem] = {}
        for i, (variant, edits) in enumerate(table[stem].items()):
            src = root / f"{stem}_v{i}"
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(csrc, src)
            for name, old, new in edits:
                text = (src / name).read_text()
                if text.count(old) != 1:
                    raise SystemExit(f"{variant}: {old!r} is not in {name} "
                                     "exactly once; update the variants")
                (src / name).write_text(text.replace(old, new))
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
        cs.emit({"kernel": stem, "variant": variant,
                 "ptxas": ptxas_summary(log)})
    return libs


def bind(lib, stem):
    """The C entry point ``stem`` of the library at ``lib``."""
    fn = getattr(ctypes.CDLL(str(lib)), stem)
    fn.argtypes = ([ctypes.c_void_p] * ARGTYPES[stem] + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


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
            def run(fn=bind(lib, stem)):
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


def profile_core(stem: str, libs: dict, dev, timer, smi):
    """Times every CORE variant of one f32 CUDA-core loop at SHAPES in
    turns; one line per shape and variant."""
    for name, b, h, sq, sk, d, causal in SHAPES:
        rng = np.random.default_rng(cs.SEED + sq + sk)

        def rand(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(dev)
        q, k, v, do = rand(b * h, sq, d), rand(b * h, sk, d), \
            rand(b * h, sk, d), rand(b * h, sq, d)
        scale = 1.0 / float(np.sqrt(d))
        rout, lse = tfa._plain_flash_fwd(q, k, v, scale, causal)
        if stem == "flash_fwd":
            refs = [rout, lse]
            outs = [torch.empty_like(rout), torch.empty_like(lse)]
            ptrs = [t.data_ptr() for t in (q, k, v, *outs)]
        else:
            delta = (do * rout).sum(-1)
            plain = (tfa._plain_flash_dq if stem == "flash_dq"
                     else tfa._plain_flash_dkv)
            refs = plain(q, k, v, do, lse, delta, scale, causal)
            refs = [refs] if stem == "flash_dq" else list(refs)
            outs = [torch.empty_like(r) for r in refs]
            ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)]
        tol = min(cs.flash_tol(torch.float32, r, 2e-5 if stem == "flash_fwd"
                               else 1e-4) for r in refs)
        runs, errs = {}, {}
        for variant, lib in libs.items():
            def run(fn=bind(lib, stem)):
                rc = fn(*ptrs, b * h, sq, sk, d, int(causal), scale,
                        DTYPE_CODES[torch.float32],
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise SystemExit(f"{stem} {variant}: cudaError {rc}")
            run()
            torch.cuda.synchronize()
            errs[variant] = max((o - r).abs().max().item()
                                for o, r in zip(outs, refs))
            runs[variant] = run
        times = {v: [] for v in runs}
        for _ in range(3):                  # in turns
            for variant, run in runs.items():
                times[variant].append(timer.ms(run))
        for variant, ms in times.items():
            cs.emit({"kernel": stem, "loop": "core", "variant": variant,
                     "card": smi, "clocks": cs.card_clocks(),
                     "shape": {"case": name, "B": b, "H": h, "Sq": sq,
                               "Sk": sk, "D": d, "causal": causal},
                     "dtype": "float32", "max_abs_err": errs[variant],
                     "tol": tol, "ms": ms, "median_ms": float(np.median(ms))})


def main(argv):
    core = argv[:1] == ["core"]
    table = CORE if core else {k: {v: [(loop, *e) for e in edits]
                                   for v, edits in variants.items()}
                               for k, (loop, variants) in LOOPS.items()}
    stems = argv[1:] if core else argv
    stems = stems or list(table)
    unknown = [s for s in stems if s not in table]
    if unknown:
        raise SystemExit(f"unknown kernels {unknown}; known: {list(table)}")
    if not torch.cuda.is_available():
        print("profile_dkv: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    libs = build(_build.BUILD_DIR / ("core" if core else "variants"), stems,
                 table)
    timer = cs.Timer(dev)
    for stem in stems:
        (profile_core if core else profile)(stem, libs[stem], dev, timer,
                                            smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
