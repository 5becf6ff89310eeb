#!/usr/bin/env python3
"""The fused layernorm kernels (`kernels/csrc/fused_layernorm_fwd.cu`,
`fused_layernorm_bwd.cu`) at other launch shapes, and the host side of one
`FusedLayerNorm` call, on one NVIDIA card. Run from the repository root:

    python3 profile_layernorm.py [fused_layernorm_fwd | fused_layernorm_bwd]
    python3 profile_layernorm.py host [CHECKOUT ...]

For each kernel of VARIANTS (both with no names) it compiles the kernel's
source as `kernels/_build.py` does, once for each variant (a copy of the
sources with the warps a block, the rows a block, the rows staged a team,
the warps of a wide row's block or the launch bounds changed;
`profile_dkv.build`), holds
each against the plain version (the backward's partials at the variant's
rows a block), and times each at CASES in float32 and bfloat16, three
times in turns, with `chip_smoke.py`'s timer (the median of 25 launches
after an L2 eviction); for the backward also the op's whole backward (the
kernel, then the sums of its partials, as `_LayerNorm.backward` runs
them). A variant whose launch the card refuses is recorded and skipped.
One JSON line per kernel, shape, dtype and variant, with the card's clocks.

``host``: the host side of one `FusedLayerNorm` call at `chip_smoke.py`'s
incubate shape, [8, 1024, 768] in bfloat16, forward and backward, each
part timed alone with `time.perf_counter` (the median of REPS calls, the
card synchronized before each call and outside the timed span; each
backward from a fresh forward with the gradients set to None): the module
call and `y.backward(dy)` whole, and the parts they run (the dispatch,
the `.contiguous()` calls, the wrapper's `_check`, the output
allocations, `_stream`, the ctypes launch, the backward's sums and casts);
what the whole leaves over is the autograd Function's and the module's own
cost. One JSON line per direction. Each CHECKOUT named (the root of a
checkout, such as ``parent_check . . parent_check``) has its two C entry
points compiled from its own sources and called straight, with this
checkout's arguments, REPS times each in the order given: one more line
that holds each one's host time a call.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
import profile_dkv
from compare_serve import LN_CASES
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_layernorm as tfl
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.kernels.cuda import DTYPE_CODES
from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln

FWD, BWD, COMMON = ("fused_layernorm_fwd.cu", "fused_layernorm_bwd.cu",
                    "rowwise_common.cuh")


def const(file, name, old, new):
    """The edit of one ``constexpr int`` of ``file`` from ``old`` to
    ``new``."""
    return (file, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


# kernel -> variant -> its edits of the shipped sources, [(file, text, its
# replacement)] as `profile_dkv.build` takes them; the first variant of
# each is the shipped source
WIDE_BLOCK_8 = (COMMON,
                "constexpr int kTeamBlockWarps = kMaxTeamThreads / 32;",
                "constexpr int kTeamBlockWarps = 8;")
VARIANTS = {
    "fused_layernorm_fwd": {
        "16 warps, 3 stages": [],
        "8 warps": [const(FWD, "kBlockWarps", 16, 8)],
        "2 stages": [const(FWD, "kStages", 3, 2)],
        "4 stages": [const(FWD, "kStages", 3, 4)],
        "wide rows in blocks of 8 warps": [WIDE_BLOCK_8],
        "2 blocks an SM": [(FWD, "__launch_bounds__(THREADS)",
                            "__launch_bounds__(THREADS, 2)")]},
    "fused_layernorm_bwd": {
        "8 warps, 32 rows, 3 stages": [],
        "4 warps, 16 rows": [const(BWD, "kBlockWarps", 8, 4),
                             const(BWD, "kRowsPerBlock", 32, 16)],
        "8 warps, 64 rows": [const(BWD, "kRowsPerBlock", 32, 64)],
        "2 stages": [const(BWD, "kStages", 3, 2)],
        "4 stages": [const(BWD, "kStages", 3, 4)],
        "wide rows in blocks of 8 warps": [WIDE_BLOCK_8]},
}
# compare_serve.py's cases, and two more rows of the scalar path: just
# wider than a warp holds (2 warps a row), and 5 warps a row
CASES = LN_CASES + [(8192, 513), (8192, 2049)]
BINDINGS = {"fused_layernorm_fwd": cln.FWD, "fused_layernorm_bwd": cln.BWD}
REPS = 200


def bind(lib, stem):
    """The C entry point ``stem`` of the library at ``lib``."""
    fn = getattr(ctypes.CDLL(str(lib)), stem)
    fn.argtypes = BINDINGS[stem].argtypes
    fn.restype = ctypes.c_int
    return fn


def rows_per_block(stem, lib):
    """The rows a block of the backward built at ``lib`` takes (its
    source's kRowsPerBlock); None for the forward."""
    if not stem.endswith("bwd"):
        return None
    text = (Path(lib).parent / BWD).read_text()
    return int(re.search(r"constexpr int kRowsPerBlock = (\d+);",
                         text).group(1))


def profile(stem, libs, dev, timer, smi):
    """Times every variant of one kernel at CASES in turns; one line per
    shape, dtype and variant."""
    eps = 1e-5
    for dtype in (torch.float32, torch.bfloat16):
        for n, d in CASES:
            rng = np.random.default_rng(cs.SEED + n + d)

            def rand(*shape, dt=dtype):
                return torch.from_numpy(rng.standard_normal(
                    shape, dtype=np.float32)).to(dev, dt)
            x, dy = rand(n, d), rand(n, d)
            gamma, beta = (rand(d, dt=torch.float32) for _ in "gb")
            ry, mu, rstd = tfl._plain_ln_fwd(x, gamma, beta, eps)
            codes = (DTYPE_CODES[dtype], DTYPE_CODES[torch.float32])
            stream = torch.cuda.current_stream(dev).cuda_stream
            runs, errs, refused = {}, {}, {}
            for variant, lib in libs.items():
                fn = bind(lib, stem)
                rows = rows_per_block(stem, lib)
                if rows is None:
                    outs = (torch.empty_like(x), torch.empty_like(mu),
                            torch.empty_like(rstd))
                    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                            *(t.data_ptr() for t in outs), n, d, eps, *codes,
                            stream)
                    refs = (ry, mu, rstd)
                else:
                    nb = -(-n // rows)
                    outs = (torch.empty_like(x),
                            torch.empty(nb, d, device=dev),
                            torch.empty(nb, d, device=dev))
                    args = (x.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
                            rstd.data_ptr(), dy.data_ptr(),
                            *(t.data_ptr() for t in outs), n, d, *codes,
                            stream)
                    refs = tfl._plain_ln_bwd(x, gamma, mu, rstd, dy, rows)

                def run(fn=fn, args=args):
                    rc = fn(*args)
                    if rc != 0:
                        raise RuntimeError(f"{stem}: cudaError {rc}")
                try:
                    run()
                except RuntimeError as err:   # e.g. more shared memory
                    refused[variant] = str(err)   # than an SM has
                    continue
                torch.cuda.synchronize()
                tol = cs.INCUBATE_TOL["ln_fwd" if rows is None else "ln_bwd"]
                got = [(cs.max_err(o, r), cs.flash_tol(dtype, r, tol) if i == 0
                        else cs.rel_tol(r, tol))
                       for i, (o, r) in enumerate(zip(outs, refs))]
                if any(e > t for e, t in got):
                    raise SystemExit(f"{stem} {variant} {dtype} {n}x{d}: "
                                     f"errors and bounds {got}")
                errs[variant] = max(e for e, _ in got)

                def op(run=run, outs=outs):
                    run()
                    return outs[1].sum(0), outs[2].sum(0)
                runs[variant] = (run, op if rows else None)
            ms = {v: {"kernel": [], "op": []} for v in runs}
            for _ in range(3):
                for variant, (run, op) in runs.items():
                    ms[variant]["kernel"].append(timer.ms(run))
                    if op:
                        ms[variant]["op"].append(timer.ms(op))
            for variant, lib in libs.items():
                if variant in refused:
                    cs.emit({"phase": "profile_layernorm", "kernel": stem,
                             "variant": variant, "dtype": cs.dtype_name(dtype),
                             "shape": {"n": n, "d": d},
                             "refused": refused[variant]})
                    continue
                line = {"phase": "profile_layernorm", "card": smi,
                        "clocks": cs.card_clocks(), "kernel": stem,
                        "variant": variant,
                        "rows_per_block": rows_per_block(stem, lib),
                        "dtype": cs.dtype_name(dtype),
                        "shape": {"n": n, "d": d},
                        "max_abs_err": errs[variant],
                        "kernel_ms": ms[variant]["kernel"]}
                if ms[variant]["op"]:
                    line["op_ms"] = ms[variant]["op"]
                cs.emit(line)


def host_split(dev, smi, roots=(), b=8, s=1024, d=cs.D_MODEL):
    """The host side of one FusedLayerNorm forward and backward, by part;
    then each of ``roots``' C entry points called straight, in turns."""
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.incubate.nn import FusedLayerNorm
    with tdevice.device_scope(dev):
        ln = FusedLayerNorm(d)
    g = torch.Generator().manual_seed(cs.SEED)
    x = torch.randn(b, s, d, generator=g).to(dev, torch.bfloat16)
    dy = torch.randn(b, s, d, generator=g).to(dev, torch.bfloat16)
    xg = Tensor(x, stop_gradient=False)
    gamma, beta = ln.weight._data.detach(), ln.bias._data.detach()
    x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
    n = x2.shape[0]
    nb = -(-n // cln.ROWS_PER_BLOCK)
    _, mu, rstd = cln.fused_layernorm_fwd(x2, gamma, beta, ln.epsilon)
    y2, dx, dg, db = (torch.empty_like(x2), torch.empty_like(x2),
                      torch.empty(nb, d, device=dev),
                      torch.empty(nb, d, device=dev))
    stream = cln._stream(x2)

    def clock(fn, prepare=None):
        times = []
        for _ in range(REPS):
            if prepare:
                prepare()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    fwd = {
        "reshapes": lambda: (x.reshape(-1, d), y2.reshape(b, s, d)),
        "registry.dispatch": lambda: registry.dispatch("fused_layernorm", x2),
        "contiguous x3": lambda: (x2.contiguous(), gamma.contiguous(),
                                  beta.contiguous()),
        "_check": lambda: cln._check("fused_layernorm_fwd", x2, gamma,
                                     [("beta", beta)]),
        "allocations": lambda: (torch.empty_like(x2), torch.empty(
            (n, 1), dtype=torch.float32, device=dev), torch.empty_like(mu)),
        "_stream": lambda: cln._stream(x2),
        "ctypes launch": lambda: cln.FWD.launch(
            x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y2.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), n, d, float(ln.epsilon),
            DTYPE_CODES[x2.dtype], DTYPE_CODES[gamma.dtype], stream)}
    bwd = {
        "contiguous": lambda: dy2.contiguous(),
        "_check": lambda: cln._check("fused_layernorm_bwd", x2, gamma,
                                     [("mu", mu), ("rstd", rstd),
                                      ("dy", dy2)]),
        "allocations": lambda: (torch.empty_like(x2), torch.empty(
            (nb, d), dtype=torch.float32, device=dev), torch.empty_like(dg)),
        "_stream": lambda: cln._stream(x2),
        "ctypes launch": lambda: cln.BWD.launch(
            x2.data_ptr(), gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            dy2.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(), n,
            d, DTYPE_CODES[x2.dtype], DTYPE_CODES[gamma.dtype], stream),
        "partial sums and casts": lambda: (dg.sum(0).to(gamma.dtype),
                                           db.sum(0).to(gamma.dtype))}
    state = {}

    def forward():
        state["y"] = ln(xg)

    def fresh():
        xg.grad = ln.weight.grad = ln.bias.grad = None
        forward()

    wholes = {"forward": (forward, None, fwd),
              "backward": (lambda: state["y"].backward(Tensor(dy)), fresh,
                           bwd)}
    for direction, (fn, prepare, parts) in wholes.items():
        for _ in range(3):                      # warm-up
            (prepare or (lambda: None))()
            fn()
        whole = clock(fn, prepare)

        def synced(fn=fn):
            fn()
            torch.cuda.synchronize()
        whole_sync = clock(synced, prepare)
        split = {k: clock(f) for k, f in parts.items()}
        cs.emit({"phase": "layernorm_host", "card": smi,
                 "clocks": cs.card_clocks(), "direction": direction,
                 "shape": [b, s, d], "dtype": "bfloat16", "reps": REPS,
                 "call_ms": whole, "call_synchronized_ms": whole_sync,
                 "parts_ms": split,
                 "autograd_and_module_ms": whole - sum(split.values())})
    if not roots:
        return
    entries = {}
    for i, root in enumerate(dict.fromkeys(roots)):
        libs = profile_dkv.build(
            _build.BUILD_DIR / f"ln_host_{i}", list(BINDINGS),
            {stem: {root: []} for stem in BINDINGS},
            Path(root) / "paddle_tpu_torch" / "kernels" / "csrc")
        entries[root] = [bind(libs[stem][root], stem) for stem in BINDINGS]
    # partials for a block of one row, so that any checkout's rows a
    # block fit
    dgn, dbn = (torch.empty(n, d, device=dev) for _ in "gb")
    fwd_args = (x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                y2.data_ptr(), mu.data_ptr(), rstd.data_ptr(), n, d,
                float(ln.epsilon), DTYPE_CODES[x2.dtype],
                DTYPE_CODES[gamma.dtype], stream)
    bwd_args = (x2.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
                rstd.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
                dgn.data_ptr(), dbn.data_ptr(), n, d, DTYPE_CODES[x2.dtype],
                DTYPE_CODES[gamma.dtype], stream)
    turns = []
    for root in roots:
        fwd_fn, bwd_fn = entries[root]
        turns.append({"checkout": root,
                      "fwd_entry_ms": clock(lambda: fwd_fn(*fwd_args)),
                      "bwd_entry_ms": clock(lambda: bwd_fn(*bwd_args))})
    cs.emit({"phase": "layernorm_host_entries", "card": smi,
             "clocks": cs.card_clocks(), "shape": [b, s, d],
             "dtype": "bfloat16", "reps": REPS, "turns": turns})


def main(argv):
    if not torch.cuda.is_available():
        print("profile_layernorm: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    if argv[:1] == ["host"]:
        _build.build_all()
        host_split(dev, smi, argv[1:])
        return 0
    stems = argv or list(VARIANTS)
    unknown = [s for s in stems if s not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown kernels {unknown}; known: "
                         f"{list(VARIANTS)}")
    libs = profile_dkv.build(_build.BUILD_DIR / "ln_variants", stems,
                             VARIANTS)
    timer = cs.Timer(dev)
    for stem in stems:
        profile(stem, libs[stem], dev, timer, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
