#!/usr/bin/env python3
"""Split counts of the split paged kernels, timed against each other on
one NVIDIA card. Run from the repository root:

    python3 profile_splits.py            # the int8 paged decode
    python3 profile_splits.py prefill    # the CUDA-core paged prefill

Decode: it calls the built `paged_decode_int8` entry point with each split
count at `chip_smoke.py`'s B=8 serve positions and at B=1, pos=1023, bf16
q. Prefill: it calls the built `paged_prefill` and `paged_prefill_int8`
entry points, q in float32 (the CUDA-core loop) over float32 and int8
pools, with each split count up to the slot's units at the prefix tail
(C=64, start=768, valid=50) and at C=1024 from position 0, GPT-2 small's
12 heads of 64 over a slot of 64 pages of 16. Each reports its largest
error against the plain version, and times each count with
`chip_smoke.py`'s timer, three times in turns. One JSON line per shape and
split count, with the card's name, power limit and clocks; the count the
wrapper's rule picks is marked ``"built": true``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels.cuda import DTYPE_CODES
from paddle_tpu_torch.kernels.cuda import paged_attention as cdec
from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre

SPLITS = (1, 2, 4, 6, 8, 11, 16, 32, 64)
PREFILL_SPLITS = (1, 2, 3, 4, 5, 6, 8, 11, 13, 16, 22, 32)
# (case, C, start, valid)
PREFILL_SHAPES = (("tail", 64, 768, 50), ("c1024", 1024, 0, 1024))


def decode(dev, timer, smi):
    fn = cdec.KERNEL_INT8._load()
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, pos in (("serve", [0, 15, 16, 1023, cs.MAXP * cs.PS, 100,
                                 511, 700]),
                      ("b1_long", [1023])):
        rng = np.random.default_rng(cs.SEED)
        b = len(pos)
        table = (1 + rng.permutation(cs.NUM_PAGES - 1)[:b * cs.MAXP]
                 ).reshape(b, cs.MAXP)
        kp, vp, (ks, vs) = cs.random_pools(rng, dev, torch.bfloat16, True)
        q = torch.from_numpy(rng.standard_normal(
            (b, cs.NH, cs.DH), dtype=np.float32)).to(dev, torch.bfloat16)
        pt = torch.from_numpy(table.astype(np.int32)).to(dev)
        pos_t = torch.from_numpy(np.array(pos, np.int32)).to(dev)
        ref = pa._plain_paged_attention(q, kp, vp, pt, pos_t, ks, vs)
        out = torch.empty_like(q)
        tickets = torch.zeros(b * cs.NH, dtype=torch.int32, device=dev)
        runs, errs = {}, {}
        for n in SPLITS:
            part = torch.empty(b * cs.NH * n * (cs.DH + 2),
                               dtype=torch.float32, device=dev)

            def run(n=n, part=part):
                rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        ks.data_ptr(), vs.data_ptr(), pt.data_ptr(),
                        pos_t.data_ptr(), out.data_ptr(), None,
                        part.data_ptr(), tickets.data_ptr(), b, cs.NH,
                        cs.DH, cs.PS, cs.MAXP, n, DTYPE_CODES[q.dtype],
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise SystemExit(f"paged_decode_int8 splits={n}: "
                                     f"cudaError {rc}")
            run()
            torch.cuda.synchronize()
            errs[n] = (out.float() - ref.float()).abs().max().item()
            runs[n] = run
        times = {n: [] for n in runs}
        for _ in range(3):
            for n, run in runs.items():
                times[n].append(timer.ms(run))
        built = cdec.splits(b, cs.NH, cs.MAXP, cs.PS, sm)
        for n, ms in times.items():
            cs.emit({"kernel": "paged_decode_int8", "case": case,
                     "card": smi, "B": b, "pos": pos, "splits": n,
                     "built": n == built, "max_abs_err": errs[n],
                     "ms": ms, "median_ms": float(np.median(ms))})


def prefill(dev, timer, smi):
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    dtype = torch.float32
    units = -(-cs.MAXP // cpre.unit_pages(cs.DH, cs.PS))
    for case, c, start, valid in PREFILL_SHAPES:
        for quant in (False, True):
            kern = cpre.KERNEL_INT8 if quant else cpre.KERNEL
            fn = kern._load()
            rng = np.random.default_rng(cs.SEED + c + start)
            kp, vp, scales = cs.random_pools(rng, dev, dtype, quant)
            sc = scales or ()
            row = torch.from_numpy((1 + rng.permutation(cs.NUM_PAGES - 1)
                                    [:cs.MAXP]).astype(np.int32)).to(dev)
            q = torch.from_numpy(rng.standard_normal(
                (c, cs.NH, cs.DH), dtype=np.float32)).to(dev, dtype)
            dev_s, dev_v = torch.tensor([start, valid], dtype=torch.int32,
                                        device=dev)
            ref = pa._plain_prefill_attention(q[None], kp, vp, row, start,
                                              valid, *sc)[0]
            out = torch.empty_like(q)
            bq = cpre.default_block_q(c, dtype, cs.DH)
            nq = -(-c // bq)
            tickets = torch.zeros(nq * cs.NH, dtype=torch.int32, device=dev)
            runs, errs = {}, {}
            for n in (n for n in PREFILL_SPLITS
                      if n <= min(units, cpre.CORE_MAX_SPLITS)):
                part = torch.empty(nq * cs.NH * n * cpre.CORE_BLOCK_Q
                                   * (cs.DH + 2), dtype=torch.float32,
                                   device=dev)

                def run(n=n, part=part):
                    rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                            *(t.data_ptr() for t in sc), row.data_ptr(),
                            out.data_ptr(), None, part.data_ptr(),
                            tickets.data_ptr(), c, cs.NH, cs.DH, cs.PS,
                            cs.MAXP, dev_s.data_ptr(), dev_v.data_ptr(), bq,
                            n, DTYPE_CODES[dtype],
                            torch.cuda.current_stream(dev).cuda_stream)
                    if rc != 0:
                        raise SystemExit(f"{kern.symbol} splits={n}: "
                                         f"cudaError {rc}")
                run()
                torch.cuda.synchronize()
                errs[n] = (out - ref).abs().max().item()
                runs[n] = run
            times = {n: [] for n in runs}
            for _ in range(3):
                for n, run in runs.items():
                    times[n].append(timer.ms(run))
            built = cpre.core_splits(c, cs.NH, cs.DH, cs.MAXP, cs.PS, sm)
            clocks = cs.card_clocks()
            for n, ms in times.items():
                cs.emit({"kernel": kern.symbol, "case": case, "card": smi,
                         "clocks": clocks, "dtype": "float32",
                         "pool": "int8" if quant else "float32",
                         "C": c, "start": start, "valid": valid,
                         "splits": n, "built": n == built,
                         "max_abs_err": errs[n], "ms": ms,
                         "median_ms": float(np.median(ms))})


def main():
    if not torch.cuda.is_available():
        print("profile_splits: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    timer = cs.Timer(dev)
    if sys.argv[1:] == ["prefill"]:
        prefill(dev, timer, smi)
    else:
        decode(dev, timer, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
