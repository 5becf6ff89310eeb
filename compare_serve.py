#!/usr/bin/env python3
"""The serve phases of `chip_smoke.py` for two or more checkouts of the
repository, in turns, on one NVIDIA card. Run from the repository root:

    python3 compare_serve.py parent_check . . parent_check
    python3 compare_serve.py --inflight parent_check . . parent_check
    python3 compare_serve.py --f32 parent_check . . parent_check
    python3 compare_serve.py --prefill parent_check . . parent_check
    python3 compare_serve.py --flash parent_check . . parent_check
    python3 compare_serve.py --train-f32 parent_check . . parent_check
    python3 compare_serve.py --layernorm parent_check . . parent_check

Each argument is the root of a checkout (this one is ``.``; another is
unpacked with ``git archive``); each runs in a process of its own, in the
order given, so that parent, change, change, parent puts both on the same
card under the same conditions. A process builds that checkout's kernels
and serves bf16 GPT-2 small through that checkout's `chip_smoke.py`
functions: ``serve``, ``serve_sampled``, ``serve_spec``, ``serve_int8``
and the three ``serve_prefix`` arms, each line with its exact launch
counts held; with ``--inflight``, ``serve`` and then ``serve_inflight``
(readback windows 1, 2, 3 in turns, 124 new tokens); with ``--f32``,
GPT-2 small in its default float32 (no cast to bf16), ``serve`` over
float32 pools and ``serve_int8`` over int8 K/V pools (weights native), so
that every prefill runs the CUDA-core prefill loop; with ``--prefill``,
no serving but `check_prefill`'s kernel lines at every PREFILL_CASES
shape, float32 and bfloat16 q over float and int8 pools; with ``--flash``,
`check_flash`'s kernel lines (forward, dQ, dK/dV) at every FLASH_CASES
shape in float32 and bfloat16; with ``--train-f32``, `chip_smoke.py`'s
``train_f32`` line (GPT-2 small trained in its default float32, B=16 as 2
microbatches, S=1024, 2 warm-up and 4 timed steps; the parent has no
``train_f32`` phase, so its process runs its own `train_run` with 2
warm-up and 4 timed steps and the cast to bfloat16 skipped); with
``--layernorm``, `check_layernorm`'s kernel lines at every LN_CASES shape
in float32 and bfloat16, and after each case one ``layernorm_op`` line
computed by the phase script through that checkout's own wrapper, so that
both checkouts get the same figures: the op's whole backward (the kernel,
then the sums of its partials and their casts, as `_LayerNorm.backward`
runs them) and streaming yardsticks of the kernels' bytes (``y.copy_(x)``,
``torch.add(x, dy, out=dx)``), timed by the same timer; then the kernel
lines of the other two kernels on `rowwise_common.cuh`, rotary and
dropout, in each dtype. Every JSON line a process prints is printed
again with ``checkout``, ``turn`` and the ``card_clocks`` read before the
process started added; a process that fails ends the run with its exit
code.
"""
from __future__ import annotations

import json
import subprocess
import sys

SERVE_PHASES = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import gpt as gpt_mod
dev = torch.device("cuda", 0)
smi = cs.nvidia_smi()
_build.build_all()
model = gpt_mod.gpt2_small(
    generator=torch.Generator().manual_seed(cs.SEED)).to(torch.bfloat16)
line, outs = cs.serve_run(model, dev, smi)
cs.serve_run(model, dev, smi, "serve_sampled", params=cs.SAMPLED_PARAMS,
             greedy_ref=outs, sampling=True)
cs.serve_run(model, dev, smi, "serve_spec", speculate_k=cs.SPEC_K)
cs.serve_run(model, dev, smi, "serve_int8", kv_dtype="int8",
             weight_dtype="int8")
cs.serve_prefix(model, dev, smi)
"""

INFLIGHT_PHASES = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import gpt as gpt_mod
dev = torch.device("cuda", 0)
smi = cs.nvidia_smi()
_build.build_all()
model = gpt_mod.gpt2_small(
    generator=torch.Generator().manual_seed(cs.SEED)).to(torch.bfloat16)
line, outs = cs.serve_run(model, dev, smi)
cs.serve_inflight(model, dev, smi, outs)
"""


F32_PHASES = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
dev = torch.device("cuda", 0)
smi = cs.nvidia_smi()
_build.build_all()
from paddle_tpu_torch.models import gpt as gpt_mod
model = gpt_mod.gpt2_small(generator=torch.Generator().manual_seed(cs.SEED))
cs.serve_run(model, dev, smi)
cs.serve_run(model, dev, smi, "serve_int8", kv_dtype="int8")
"""

PREFILL_PHASES = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
dev = torch.device("cuda", 0)
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
timer = cs.Timer(dev)
for dtype in (torch.float32, torch.bfloat16):
    for quant in (False, True):
        for c, start, valid in cs.PREFILL_CASES:
            cs.check_prefill(dev, timer, dtype, c, start, valid, quant)
"""

FLASH_PHASES = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
dev = torch.device("cuda", 0)
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
timer = cs.Timer(dev)
for dtype in (torch.float32, torch.bfloat16):
    for case in cs.FLASH_CASES:
        cs.check_flash(dev, timer, dtype, case)
"""

TRAIN_F32_PHASES = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
dev = torch.device("cuda", 0)
smi = cs.nvidia_smi()
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
if hasattr(cs, "train_f32"):
    cs.train_f32(dev, smi)
else:   # a checkout before train_f32: its train_run, the bf16 cast skipped
    make = cs.gpt_mod.gpt2_small

    def f32_model(*args, **kw):
        model = make(*args, **kw)
        to = model.to
        model.to = lambda *a, **k: model if a[:1] == (torch.bfloat16,) \
            else to(*a, **k)
        return model
    cs.gpt_mod.gpt2_small = f32_model
    cs.train_run(dev, smi, "train_f32", warmup=2, timed=4)
"""

# the incubate path's rows; a width a team of warps holds; the narrowest
# such width, odd, on the scalar path
LN_CASES = [(8192, 768), (2048, 4096), (8192, 1025)]

LAYERNORM_PHASES = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln
dev = torch.device("cuda", 0)
_build.build_all()
timer = cs.Timer(dev)
for dtype in (torch.float32, torch.bfloat16):
    for n, d in %r:
        cs.check_layernorm(dev, timer, dtype, n, d)
        g = torch.Generator().manual_seed(n + d)
        x, dy = (torch.randn(n, d, generator=g).to(dev, dtype) for _ in "xd")
        gamma, beta = (torch.randn(d, generator=g).to(dev) for _ in "gb")
        _, mu, rstd = cln.fused_layernorm_fwd(x, gamma, beta, 1e-5)

        def op_bwd():
            dx, dg, db = cln.fused_layernorm_bwd(x, gamma, mu, rstd, dy)
            return dx, dg.sum(0).to(gamma.dtype), db.sum(0).to(gamma.dtype)
        ys, dxs = torch.empty_like(x), torch.empty_like(x)
        cs.emit({"phase": "layernorm_op", "dtype": cs.dtype_name(dtype),
                 "shape": {"n": n, "d": d},
                 "rows_per_block": cln.ROWS_PER_BLOCK,
                 "bwd_op_ms": timer.ms(op_bwd),
                 "fwd_stream_ms": timer.ms(lambda: ys.copy_(x)),
                 "bwd_stream_ms": timer.ms(
                     lambda: torch.add(x, dy, out=dxs))})
    cs.check_rope(dev, timer, dtype)
    cs.check_dropout(dev, timer, cs.nvidia_smi(), dtype)
""" % (LN_CASES,)

PHASES = {"--inflight": INFLIGHT_PHASES, "--f32": F32_PHASES,
          "--prefill": PREFILL_PHASES, "--flash": FLASH_PHASES,
          "--train-f32": TRAIN_F32_PHASES, "--layernorm": LAYERNORM_PHASES}


def main():
    checkouts = sys.argv[1:]
    phases = SERVE_PHASES
    if checkouts[:1] and checkouts[0] in PHASES:
        checkouts, phases = checkouts[1:], PHASES[checkouts[0]]
    if not checkouts:
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    for turn, root in enumerate(checkouts):
        clocks = cs.card_clocks()
        proc = subprocess.run([sys.executable, "-c", phases],
                              cwd=root, capture_output=True, text=True)
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                print(json.dumps({"checkout": root, "turn": turn,
                                  "card_clocks": clocks,
                                  **json.loads(ln)}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
