#!/usr/bin/env python3
"""Controls for `chip_smoke.py`'s bfloat16 end-to-end checks,
``serve_bf16_parity`` and ``train_bf16_parity``: each planted fault of
FAULTS is a text change to the kernel sources of a temporary copy of the
port (made under the temporary directory, never in the checkout); the
copy builds its kernels from its own sources and runs both phases on the
card, the bf16 card engine and train step against the port's CPU ones. A
check that catches the fault comes out not ok. Run from the repository
root on a machine with one NVIDIA Hopper card:

    python3 bf16_parity_controls.py [fault ...]

With no names it runs the sources as they are (``none``, which must pass
both phases) and then every fault. One JSON line per fault and phase with
its gap, its bound and whether it passed, then one line with every
verdict. Exits 1 when ``none`` fails or a copy does not run to its end.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = "paddle_tpu_torch/kernels/csrc/"
PHASES = ("serve_bf16_parity", "train_bf16_parity")

# name -> (what it breaks, [(source, text, planted text)]); each text must
# occur exactly once in its source
FAULTS = {
    "none": ("the sources as they are", []),
    "mask_leak": (
        "each causal row also sees the next key, in both tensor-core loops",
        [(CSRC + "flash_fwd_mma.cuh",
          "return causal ? min(row0 + r + off, sk - 1) : sk - 1;",
          "return causal ? min(row0 + r + off + 1, sk - 1) : sk - 1;"),
         (CSRC + "paged_prefill_mma.cuh",
          "if (masked && key0 + col > (i < 2 ? lim0 : lim1)) x = -INFINITY;",
          "if (masked && key0 + col > (i < 2 ? lim0 : lim1) + 1) "
          "x = -INFINITY;")]),
    "pv_pair_swap": (
        "the P V fragment's first register takes its two keys' weights "
        "swapped, in both tensor-core loops",
        [(CSRC + "flash_fwd_mma.cuh",
          "a[rt][0] = pack_bf16(p0[0], p0[1]);",
          "a[rt][0] = pack_bf16(p0[1], p0[0]);"),
         (CSRC + "paged_prefill_mma.cuh",
          "{pack_bf16(p0[0] * vs[0][0], p0[1] * vs[0][1]),",
          "{pack_bf16(p0[1] * vs[0][1], p0[0] * vs[0][0]),")]),
    "pv_round_toward_zero": (
        "pack_bf16 rounds toward zero instead of to nearest: P for P V and "
        "the bf16 outputs of both tensor-core loops",
        [(CSRC + "mma_common.cuh",
          "__nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);",
          "__nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rz(lo), "
          "__float2bfloat16_rz(hi));")]),
    "dkv_mask_leak": (
        "the tensor-core dK/dV loop lets each causal row see one key past "
        "its limit",
        [(CSRC + "flash_dkv_mma.cuh",
          "if (masked && (qry >= sq || (causal && key > qry + off))) p = 0.f;",
          "if (masked && (qry >= sq || (causal && key > qry + off + 1))) "
          "p = 0.f;")]),
    "dq_mask_leak": (
        "the tensor-core dQ loop lets each causal row see one key past its "
        "limit",
        [(CSRC + "flash_dq_mma.cuh",
          "return causal ? min(row0 + r + off, sk - 1) : sk - 1;",
          "return causal ? min(row0 + r + off + 1, sk - 1) : sk - 1;")]),
    "decode_split_drop": (
        "the float split decode's merge drops the partial of the last "
        "split that holds keys, where that is not the first split",
        [(CSRC + "paged_decode_split.cuh",
          "const float w = sm_w[s] == -INFINITY ? 0.f : expf(sm_w[s] - gm);",
          "const float w = sm_w[s] == -INFINITY || (!kScaled && s > 0 && "
          "s == (npages - 1) / pps) ? 0.f : expf(sm_w[s] - gm);")]),
    "lse_log2": (
        "flash_fwd's tensor-core lse takes log2 of the row sum for its "
        "natural log (the backward pair reads it)",
        [(CSRC + "flash_fwd_mma.cuh",
          "lrow[r] = m[j] * scale + logf(lc);",
          "lrow[r] = m[j] * scale + log2f(lc);")]),
}


def plant(copy: Path, edits) -> None:
    for rel, text, planted in edits:
        path = copy / rel
        src = path.read_text()
        if src.count(text) != 1:
            raise SystemExit(f"{rel}: the text to change occurs "
                             f"{src.count(text)} times, not once: {text}")
        path.write_text(src.replace(text, planted))


def child() -> int:
    """Both phases on the sources next to this file; each phase prints its
    line, and a failed check does not stop the other phase."""
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = cs.gpt_mod.gpt2_small(
        generator=torch.Generator().manual_seed(cs.SEED)).to(torch.bfloat16)
    for run in (lambda: cs.serve_parity(model, dev),
                lambda: cs.train_parity(dev, torch.bfloat16)):
        try:
            run()
        except SystemExit as e:
            print(f"check failed: {e}", file=sys.stderr, flush=True)
    return 0


def run_fault(name: str) -> dict:
    """{phase: verdict line} of one fault, run in its own copy."""
    what, edits = FAULTS[name]
    with tempfile.TemporaryDirectory(prefix=f"bf16_control_{name}_") as tmp:
        copy = Path(tmp)
        shutil.copytree(ROOT / "paddle_tpu_torch", copy / "paddle_tpu_torch",
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        for f in ("chip_smoke.py", Path(__file__).name):
            shutil.copy2(ROOT / f, copy / f)
        plant(copy, edits)
        r = subprocess.run([sys.executable, str(copy / Path(__file__).name),
                            "--child"], cwd=copy, capture_output=True,
                           text=True, timeout=900)
    lines = {}
    for ln in r.stdout.splitlines():
        if ln.startswith("{"):
            obj = json.loads(ln)
            if obj.get("phase") in PHASES:
                lines[obj["phase"]] = obj
    out = {}
    for phase in PHASES:
        obj = lines.get(phase)
        if obj is None:
            out[phase] = {"fault": name, "phase": phase, "ran": False,
                          "rc": r.returncode, "stderr": r.stderr[-2000:]}
        elif phase == "serve_bf16_parity":
            out[phase] = {
                "fault": name, "phase": phase, "ran": True,
                "ok": obj["logits_ok"] and obj["tokens_ok"],
                "logits_ok": obj["logits_ok"], "tokens_ok": obj["tokens_ok"],
                "gap": obj["prefill_logit_max_abs_diff"],
                "bound": obj["logit_bound"],
                "margin_gate": obj["margin_gate"],
                "divergences": [q["first_divergence"]
                                for q in obj["requests"]
                                if "first_divergence" in q]}
        else:
            out[phase] = {"fault": name, "phase": phase, "ran": True,
                          "ok": obj["ok"], "gap": obj["loss_max_abs_diff"],
                          "gaps": obj["loss_abs_diff"], "bound": obj["tol"],
                          "grad_gap": obj["grad_rel_l2_max"],
                          "grad_leaf": obj["grad_rel_l2_leaf"],
                          "grad_bound": obj["grad_tol"]}
        out[phase]["what"] = what
    return out


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child()
    import torch
    if not torch.cuda.is_available():
        print("bf16_parity_controls: CUDA is not available", file=sys.stderr)
        return 1
    names = argv or list(FAULTS)
    unknown = [n for n in names if n not in FAULTS]
    if unknown:
        raise SystemExit(f"unknown faults {unknown}; known: {list(FAULTS)}")
    verdicts, failed = {}, False
    for name in names:
        res = run_fault(name)
        for line in res.values():
            print(json.dumps(line), flush=True)
        verdicts[name] = {p: res[p].get("ok") for p in PHASES}
        failed |= not all(v["ran"] for v in res.values())
        failed |= name == "none" and not all(verdicts[name].values())
    print(json.dumps({"controls": verdicts}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
