#!/usr/bin/env python3
"""The serve phases of `chip_smoke.py` for two or more checkouts of the
repository, in turns, on one NVIDIA card. Run from the repository root:

    python3 compare_serve.py parent_check . . parent_check
    python3 compare_serve.py --inflight parent_check . . parent_check

Each argument is the root of a checkout (this one is ``.``; another is
unpacked with ``git archive``); each runs in a process of its own, in the
order given, so that parent, change, change, parent puts both on the same
card under the same conditions. A process builds that checkout's kernels
and serves bf16 GPT-2 small through that checkout's `chip_smoke.py`
functions: ``serve``, ``serve_sampled``, ``serve_spec``, ``serve_int8``
and the three ``serve_prefix`` arms, each line with its exact launch
counts held; with ``--inflight``, ``serve`` and then ``serve_inflight``
(readback windows 1, 2, 3 in turns, 124 new tokens). Every JSON line a process prints is printed again with
``checkout`` and ``turn`` added; a process that fails ends the run with its
exit code.
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


def main():
    checkouts = sys.argv[1:]
    phases = SERVE_PHASES
    if checkouts[:1] == ["--inflight"]:
        checkouts, phases = checkouts[1:], INFLIGHT_PHASES
    if not checkouts:
        print(__doc__, file=sys.stderr)
        return 2
    for turn, root in enumerate(checkouts):
        proc = subprocess.run([sys.executable, "-c", phases],
                              cwd=root, capture_output=True, text=True)
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                print(json.dumps({"checkout": root, "turn": turn,
                                  **json.loads(ln)}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
