#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (`paddle_tpu_torch`) on one
NVIDIA H100. Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version, serves GPT-2 small at full width
(random weights from a fixed seed) through `DecodeEngine` on the card, in
its native dtype and quantized (int8 KV pages, weight-only int8), trains
it through `ScanTrainStep`, and prints one JSON object per line:

1. ``device``: the card's name and power limit as nvidia-smi gives them
   (that raw line is also printed alone), and its compute capability,
   which must be (9, 0).
2. ``build``: the nvcc build, all kernels compiled in parallel.
3. ``kernel``: one line per kernel, dtype and shape: the max-abs error
   against the plain version on the card with its tolerance (2e-5 in
   float32; 2e-2 in bfloat16, where the outputs are rounded to bfloat16),
   the page-loop trip counts against `pages_needed` / `block_visits`, and
   times: the kernel, the plain version and
   `torch.nn.functional.scaled_dot_product_attention` over the gathered
   window with the same mask (a yardstick the port never calls), each the
   median of 25 launches timed with CUDA events after a 128 MiB write that
   evicts the 50 MB L2 and a ~1 ms spin that keeps the host's launch out of
   the interval (`Timer`); and ``bound_ms``, the larger of the bytes the call
   must move over 3.35 TB/s and its operations over the dtype's peak (67
   TFLOP/s float32, 989 TFLOP/s bfloat16), and ``vs_library``, the
   kernel's time over the library call's. The prefill lines (PREFILL_CASES)
   and the three flash lines also name the loop the
   call took (``arm``: ``mma_bf16``, the tensor cores, for bfloat16;
   ``cuda_core`` for float32) and its launch ``grid`` (the prefill's
   ``block_q`` is in ``shape``); the ``paged_decode`` and
   ``paged_decode_int8`` lines name theirs (``split``) with its ``splits``
   and ``grid``, at the serve run's B=8 positions and at B=1, pos=1023
   (``case`` ``b1_long``, DECODE_CASES).
   The three flash-attention
   kernels (forward, dq, dk/dv) are held the same way at the training
   shape (B=8, H=12, S=1024, D=64, causal), a ragged causal S=200, a
   cross-length causal Sq=64 / Sk=300 and a non-causal S=256; their
   tolerances are 2e-5 (forward) and 1e-4 (gradients) times the largest
   reference value when that exceeds 1 in float32, and in bfloat16 one
   bfloat16 step of the largest reference value (2^-7 of it), never less
   than the float32 bound. Their library yardstick is SDPA forward, and
   SDPA forward plus backward for the backward pair. The int8 paged
   kernels (``paged_decode_int8``, ``paged_prefill_int8``) are held the
   same way at the float kernels' shapes, q in float32 and bfloat16, on
   int8 pools quantized from normal K/V (same tolerances); their library
   yardstick is SDPA over the window gathered and dequantized (in q's
   dtype) outside the timed region, and their bytes are the int8 values
   plus 4 scale bytes per key and head. The prefill kernels read
   ``start`` and ``valid`` from device memory, as the engine's captured
   graphs pass them (made once, outside the timed calls);
   ``prefill_scalars`` holds both kernels, float32 and bfloat16, against
   the plain version for valid 0, 1 and the whole chunk at start 0,
   mid-page and at the slot's capacity (PREFILL_SCALAR_STARTS).
   The hidden-dropout kernel (``dropout``) is held at a microbatch's
   hidden states [8, 1024, 768], float32 and bfloat16, p = 0.1: zero
   mask bits apart from `prng.bernoulli`, outputs and the op's gradient
   bit-equal to the plain version's; its bound counts the integer
   operations of the threefry hash (`kernels/cuda/dropout.py::
   INT_OPS_PER_ELEMENT`) over the H100's INT32 rate (PEAK_INT32_OPS); no
   PyTorch call draws the same masks, so it has no library time, and
   `F.dropout`'s time at the shape is printed beside it as another RNG.
4. ``serve_parity``: float32 engines on the card and on the CPU serve the
   same 4 requests (chunked prefill on); the greedy tokens must agree
   wherever the CPU logits' top-2 margin exceeds 1e-3, and the prefill
   logits must agree within 5e-4 (`quantization/serving.py`).
   ``serve_int8_parity`` does the same with ``kv_dtype="int8"``, counts
   the int8 K/V values the card and the CPU wrote one step apart, and
   holds the prefill logits within 2e-3 (see INT8_LOGIT_BOUND).
   ``serve_bf16_parity`` does the same for the bfloat16 model (the
   tensor-core prefill end to end): logits within `bf16_logit_bound` (4
   bfloat16 steps of the largest logit), tokens equal wherever the CPU's
   top-2 margin exceeds it.
5. ``serve``: the bfloat16 engine on the card serves 8 requests of 7-900
   prompt tokens, 32 new tokens each, through one-shot bucketed prefill.
   ``serve_int8`` serves the same requests with ``kv_dtype="int8"`` and
   ``weight_dtype="int8"``, reports the pool's bytes per token, and holds
   each prompt's first-token logits against the native bfloat16 ones
   within ``QUANT_LOGIT_BOUND`` (0.5), margin-gated. Every serve line
   (and each ``serve_prefix`` arm) carries, per decode or verify step of
   a short profiled window, the kernels the card ran and the host's
   runtime calls (``HOST_RUNTIME_CALLS``), and the same for the step that
   admits the 8 requests (``admission_*``, with its device ms): the
   engine replays each step, prefill and chunk as one captured CUDA
   graph. Each serve engine is warmed for its prompts first (`warm`: the
   seconds, programs and reserved memory of the captures are in the
   line), as a server is before its traffic. ``prefill_graph_memory``:
   the memory those captures reserve with the engine's prefill graphs
   sharing one pool and with a pool each. ``serve_graph`` (float32, then
   bfloat16, B=8, the engines of GRAPH_ARMS) runs one step from one state
   through the graph and through the eager body
   (`DecodeEngine.check_step_graph`), and likewise a one-shot prefill and
   a prefix tail's chunk (`check_prefill_graph`): tokens, key chains and
   pool pages equal, logits within the serve bounds; then
   `refresh_params` to other weights must give a fresh engine's tokens
   with no recapture.
6. ``train_parity``: float32 `ScanTrainStep`s on the card and on the CPU
   take 3 steps of GPT-2 small's width at 2 layers (S=256, B=4 as 2
   microbatches, AdamW lr 1e-3, clip 1.0); the first step's gradients
   must agree within 1.5e-4 in each leaf's L2 norm (see TRAIN_GRAD_TOL)
   and every step's loss within 1e-3 (see TRAIN_LOSS_TOL).
   ``train_bf16_parity`` does the same in bfloat16 with float32 masters
   (the tensor-core loops of the three flash kernels end to end),
   gradients within 2e-2 and each loss within 2e-3 of the CPU's (see
   TRAIN_BF16_GRAD_TOL, TRAIN_BF16_LOSS_TOL).
   ``bf16_parity_controls.py`` plants faults in the tensor-core loops and
   shows which of them these two checks catch.
   ``train_dropout_parity`` and ``train_dropout_bf16_parity``: the same
   two checks with ``hidden_dropout=0.1``, both devices drawing the masks
   from the steps' key chains (seed 0), with exact launch and dispatch
   counts (`train_launches`).
7. ``train``: GPT-2 small (12 layers) in bfloat16 with float32 masters,
   B=16 as 2 microbatches of 8, S=1024, AdamW lr 1e-4, clip 1.0: 2 warm-up
   steps, then 8 timed steps on one fixed batch; tokens/s, step ms p50,
   MFU against the H100's 989 TFLOP/s, peak memory and the losses, which
   must be finite and fall; under an armed watchdog (no dump), the
   ``train.mfu`` gauge must equal the last step's MFU record and
   ``train.steps`` count every step. ``train_dropout`` does the same with
   ``hidden_dropout=0.1`` (100 dropout launches a step), and
   ``train_recompute`` once more for each of ``recompute=True`` and
   ``recompute_granularity`` "mlp" and "mlp_up" (a
   ``train_recompute_<arm>`` line each): full-block recompute must lower
   the peak memory below ``train_dropout``'s, no arm may raise it, and
   the losses must stay ``train_dropout``'s; the line also times the
   fc_out product that "mlp" and "mlp_up" rerun beyond JAX's policy.
8. ``incubate_parity``: the `incubate.nn` fused layers in float32 on the
   card against the port's CPU layers on the same weights:
   `FusedMultiTransformer` at GPT-2 small's width (768, 12 heads, FFN
   3072) and 2 layers over [2, 256, 768], with an additive mask (the plain
   softmax arm on both) and without (``flash_fwd`` on the card, the plain
   flash on the CPU), outputs within 1e-4 of the largest value;
   `FusedLayerNorm` forward within 2e-5 and its x / weight / bias
   gradients within 1e-4 (relative to the largest value, when above 1);
   `fused_rotary_position_embedding` within 1e-6 of the largest value
   (see INCUBATE_TOL).
9. ``incubate``: the entry points as a user calls them, bfloat16 at full
   width: `FusedMultiTransformer(768, 12, 3072, num_layers=12).eval()`
   over [8, 1024, 768] with no mask, `FusedLayerNorm(768)` forward and
   ``.backward()`` on [8, 1024, 768], `fused_rotary_position_embedding`
   on q, k [8, 12, 1024, 64] with NeoX tables; times, peak memory and
   exact launch counts (``flash_fwd`` 12 per forward, each layernorm
   kernel and ``rotary`` once per call). The fused layernorm and rotary
   kernels get ``kernel`` lines at these shapes (rows [8192, 768]), in
   float32 and bfloat16, against their plain versions (tolerances as
   INCUBATE_TOL and the flash kernels'), beside
   `torch.nn.functional.layer_norm` and
   `torch.ops.aten.native_layer_norm_backward` (rope has no library call).
10. ``serve_prefix_parity`` (and ``serve_prefix_parity_int8`` over int8
   KV pages): float32 engines with the prefix cache on, card and CPU, a
   seeding request of a 100-token system prompt, then 4 requests of it
   plus 5-40-token suffixes: their tails prefill at start=96 over the
   shared pages. Tokens margin-gated as ``serve_parity``'s, the prefix
   counters equal on both devices, each tail's logits within
   ``serve_parity``'s bound (2e-3 over int8 pools). Its tier arm demotes
   a seeded engine's system pages to a host tier of 3 pages over a disk
   tier, reruns the requests and holds the re-uploaded pages byte-equal
   to the pages exported before the spill and the tokens equal to the
   first run's. ``serve_prefix``: bfloat16, 8 requests sharing a
   768-token system prompt (48 pages) with suffixes of 9-224 tokens, 32
   new tokens each, in three arms: ``cold`` (prefix cache off), ``hbm``
   (seeded store) and ``host_tier`` (the seeded pages demoted to a 64 MiB
   host tier first): TTFT, steps, tokens/s, prefill tokens, hits, pages
   reused, re-uploads, spill and re-upload ms a page, exact launches.
   ``hbm`` and ``host_tier`` tokens must be equal, against ``cold`` they
   are gated as ``serve_bf16_parity``'s. The earlier serve phases keep
   the prefix cache off, as before it was ported. Every serve phase
   above reads each step's tokens back before the next step is
   dispatched (``inflight=1``), as before the readback window was ported,
   so their lines stay comparable with earlier runs.
11. ``serve_inflight``: `serve`'s engine and 8 prompts with 124 new
   tokens each (decode dominates; 900 + 124 fills the position table), at
   readback windows (``inflight``) 1, 2 and 3, one warm engine each, in
   the turns 1, 2, 3, 3, 2, 1, with no synchronization between steps
   (one at the end): per turn decode tokens/s, step ms p50 (the host's
   step intervals), TTFT p50 and exact launches; the tokens identical in
   every turn and their first 32 equal to `serve`'s. ``serve_lifecycle`` (bf16, ``inflight=2``): engine
   A sheds the 17th of 17 submits (``Overloaded``), cancels two queued
   requests (no prefill for them), a running one that shares prefix
   pages (its slot goes to the next queued request), cuts a request with
   a 0.05 s deadline under an injected 0.1 s step delay
   (``DeadlineExceeded``), attaches and then replays a keyed resubmit,
   ends at its pool baseline, and its survivors' tokens equal an
   undisturbed engine's (margin-gated); engine B (``speculate_k=4``, a
   host tier) is pushed to ladder level 2 by its queue: the idle prefix
   pages go to the host tier, drafting stops from level 1 on, and the
   level falls to 0 as the queue drains. Every outcome is on the line.
   ``serve_observe`` (bf16, ``inflight=2``): `serve`'s 8 prompts and a
   9th whose prefill bucket is left unwarmed, 32 new tokens, a
   `RequestTrace` each, through `run_until_idle` on one engine and
   through `serve_loop` on a thread of its own (under its watchdog,
   requests submitted from the main thread, the 9th's graph captured in
   the loop) on another: the tokens equal `serve`'s and each other's, the
   metrics registry's counter and histogram deltas and the usage records
   (but their times) equal between the two loops, every request's four
   ``request.*`` spans, one ``engine.device_ms`` observation a step that
   did work, the Prometheus text within the exposition grammar, no
   watchdog dump from the healthy loop and exactly one from a loop whose
   step sleeps 2 s past a 0.5 s deadline (``engine.step_delay``).
12. ``kernels``: per kernel, its source, the TPU kernel it replaces, its
   launches in the run of the path that uses it (serve for the float paged
   kernels, serve_int8 for the int8 ones, train for the flash kernels,
   incubate for the layernorm and rotary kernels, train_dropout for the
   dropout kernel) and its numbers at that run's shapes.
13. The last line: ``{"ok": true, "device": {...}}``.

The card runs (4 to 11) are the paths of the main path: every
kernel's launch count is set to 0 just before each and read just after.
Each path states the kernels it must launch and how many times (the
engine's steps imply one paged-decode launch per layer per decode step and
one paged-prefill launch per layer per one-shot prefill or chunk, of the
int8 kernels where the pool is int8; a train step launches each flash
kernel once per layer per microbatch, and with hidden dropout the dropout
kernel 2 (1 + 2 layers) times per microbatch, `train_launches`), every
other kernel must show 0, and the run fails otherwise. Each line reports
its counts.

Any failure raises and exits non-zero. Without CUDA, or without the
`paddle_tpu_torch` package beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import gc
import glob
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from paddle_tpu_torch.incubate.nn import (FusedLayerNorm,
                                          FusedMultiTransformer,
                                          fused_rotary_position_embedding)
from paddle_tpu_torch.inference.engine import (DecodeEngine, EngineConfig,
                                               Overloaded)
from paddle_tpu_torch.kernels import _build, registry
from paddle_tpu_torch.kernels import dropout as tdrop
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_layernorm as tfl
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.kernels import rotary as trot
from paddle_tpu_torch.kernels import sampling as smp
from paddle_tpu_torch.kernels.cuda import dropout as cdrop
from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln
from paddle_tpu_torch.kernels.cuda import paged_attention as cdec
from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre
from paddle_tpu_torch.kernels.cuda import rotary as crot
from paddle_tpu_torch.models import gpt as gpt_mod
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.flight_recorder import flight
from paddle_tpu_torch.observability.tracing import RequestTrace
from paddle_tpu_torch.observability.usage import usage_log
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.quantization.serving import (QUANT_LOGIT_BOUND,
                                                   margin_gated_parity)
from paddle_tpu_torch.serving.disagg import prompt_page_hashes
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.train import H100_BF16_PEAK, ScanTrainStep
from paddle_tpu_torch.train.scan_step import _leaf_keys

SEED = 0
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
REPLACES = {
    "paged_decode": "paddle_tpu/kernels/pallas/paged_attention.py:48",
    "paged_prefill": "paddle_tpu/kernels/pallas/prefill_attention.py:69",
    # the quant=True arms of the same kernels
    "paged_decode_int8": "paddle_tpu/kernels/pallas/paged_attention.py:60",
    "paged_prefill_int8": "paddle_tpu/kernels/pallas/prefill_attention.py:79",
    "flash_fwd": "paddle_tpu/kernels/pallas/flash_attention.py:31",
    "flash_dq": "paddle_tpu/kernels/pallas/flash_attention.py:123",
    "flash_dkv": "paddle_tpu/kernels/pallas/flash_attention.py:161",
    "fused_layernorm_fwd": "paddle_tpu/kernels/pallas/fused_layernorm.py:21",
    "fused_layernorm_bwd": "paddle_tpu/kernels/pallas/fused_layernorm.py:33",
    "rotary": "paddle_tpu/kernels/pallas/rotary.py:20",
    # computed in XLA by the JAX package: no pl.pallas_call behind it
    "dropout": "paddle_tpu/models/gpt.py:655 (_fdropout, XLA, not Pallas)",
}
# integer operations a second of the H100 SXM: 64 INT32 lanes an SM
# (NVIDIA's Hopper white paper) x 132 SMs x 1.98 GHz, the boost clock of
# the data sheet's 67 TFLOP/s float32 (128 lanes x 2 x 132 x 1.98e9)
PEAK_INT32_OPS = 64 * 132 * 1.98e9
DROPOUT_P = 0.1                                # GPTConfig's hidden_dropout
DROPOUT_SHAPE = (8, 1024, 768)                 # a microbatch's hidden states
RECOMPUTE_ARMS = (("full_block", {"recompute": True}),
                  ("mlp", {"recompute_granularity": "mlp"}),
                  ("mlp_up", {"recompute_granularity": "mlp_up"}))
PS, MAXP, NUM_PAGES = 16, 64, 513              # page size, pages per slot, pool
NH, DH = 12, 64                                # GPT-2 small's heads
VOCAB = 50257                                  # GPT-2's tokenizer
LOGIT_BOUND, MARGIN = 5e-4, 1e-3
# decode kernel cases: the serve run's B=8 positions (a fresh slot, page
# edges, a slot at capacity on the trash row), and one long row alone,
# where one block per (b, h) would be 12 blocks on 132 SMs
DECODE_CASES = {"serve": (0, 15, 16, 1023, MAXP * PS, 100, 511, 700),
                "b1_long": (1023,)}
# card vs CPU prefill logits over int8 pools: the two devices' float32
# products differ in summation order (the float logits agree within
# 3.1e-06), and every K/V value within that difference of a rounding
# boundary is written one quantization step (max|x| / 127 of its head's
# row) apart, a jump the float path does not have. Measured on GPT-2 small
# at f32 (4 prompts of 5-600 tokens, H100): 0.42% of the int8 values one
# step apart, the logits 5.67e-04 apart; the bound leaves 3.5x room and
# is 250x under QUANT_LOGIT_BOUND.
INT8_LOGIT_BOUND = 2e-3


def bf16_step(x):
    """One bfloat16 step (unit in the last place) at |x|: 8 significant
    bits, so 2^(floor(log2 |x|) - 7)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


# card vs CPU logits of a bfloat16 GPT-2 small: both round every op to
# bf16 in other summation orders, and the logits come out rounded to bf16
# (2^-6 apart from 2 to 4, where the largest lies at random init).
# Measured on an H100 (4 prompts of 5-600 tokens): the first-token logits
# 2 such steps apart, and greedy tokens parting only where the CPU's top-2
# margin was 0 or 1 step. The bound is twice the gap; it also gates the
# tokens: two logits each the measured 2 steps off, in opposite
# directions, move their margin by at most 4 steps.
BF16_LOGIT_STEPS = 4


def bf16_logit_bound(lg_ref):
    """BF16_LOGIT_STEPS bf16 steps of the largest reference logit."""
    return BF16_LOGIT_STEPS * bf16_step(lg_ref.float().abs().max().item())


# (C, start, valid) of the prefill kernel checks: a short padded bucket,
# a half-live 512 bucket, the one-shot C=1024 the serve path's longest
# prompts take (the ``kernels`` line's shape), a short chunk deep in the
# slot, the last 256-token chunk of a 1024-token prompt (the chunked
# path at full context), and a prefix hit's tail: 50 tokens after a
# 768-token cached system prompt, at the tail's bucket of 64
PREFILL_CASES = ((16, 0, 7), (512, 0, 300), (1024, 0, 1024),
                 (256, 496, 100), (256, 768, 256), (64, 768, 50))
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
INT8_KERNELS = ("paged_decode_int8", "paged_prefill_int8")
# (name, B, H, Sq, Sk, D, causal) of the flash kernel checks; "train" and
# "incubate" are the shapes the train and incubate runs give the kernels
FLASH_CASES = (("train", 8, 12, 1024, 1024, 64, True),
               ("incubate", 8, 12, 1024, 1024, 64, False),
               ("ragged", 1, 12, 200, 200, 64, True),
               ("cross", 1, 12, 64, 300, 64, True),
               ("noncausal", 2, 12, 256, 256, 64, False))
# card vs CPU float32 train steps: both sum in other orders, and the fused
# cross-entropy rounds h, w and dlogits to bf16, where a value one f32 bit
# from a rounding boundary can round one bf16 step apart; Adam then moves
# the elements whose gradient is near zero by +-lr on either side. Losses
# of about 10.8 agree within 1e-3.
TRAIN_LOSS_TOL = 1e-3
# the same in bfloat16 with float32 masters: the loss is a float32 mean
# over 1024 tokens of cross-entropies over bf16 logits, each up to one
# bf16 step (2^-6 below 4) off in either direction, so about 2^-6 / sqrt(1024)
# = 4.9e-4 in the mean; measured on an H100 over 3 steps of a 2-layer
# model: 1.9e-4, 5.1e-4, 7.7e-4. The tolerance is 2.6x the largest.
TRAIN_BF16_LOSS_TOL = 2e-3
# card vs CPU gradients of the first step (the same weights and batch, no
# update yet), per leaf ||card - cpu|| / ||cpu|| in the L2 norm, the
# largest over the leaves: the losses above pass a fault that moves only
# the gradients, since AdamW's first steps follow the gradients' signs.
# Measured on an H100 (2 layers): float32 5.6e-5 (wte, through the fused
# cross-entropy's bf16 operands; 7e-6 to 9e-6 elsewhere), bfloat16 1.5e-3
# to 8.0e-3 (every product rounded to bf16 on both sides, in other
# orders). The tolerances are 2.7x and 2.5x the largest.
TRAIN_GRAD_TOL = 1.5e-4
TRAIN_BF16_GRAD_TOL = 2e-2
# card vs CPU (and kernel vs plain) for the incubate path, each relative to
# the largest reference value when that exceeds 1: f32 sums in other
# orders. Layernorm forward 2e-5 (and the card's rsqrtf); layernorm
# gradients 1e-4 (the dgamma/dbeta partials add 16- or 256-row blocks);
# the stack 1e-4 (matrix products and layernorms in a row); rope 1e-6 (one
# f32 rounding of each product and sum on both sides).
INCUBATE_TOL = {"ln_fwd": 2e-5, "ln_bwd": 1e-4, "stack": 1e-4,
                "rope": 1e-6}
LN_KERNELS = ("fused_layernorm_fwd", "fused_layernorm_bwd")
# the sampler on the card against the CPU: one torch code on both, so bits,
# uniforms and keys must be equal; each of the Gumbel noise's two logs
# (CUDA's logf, the CPU's log) lies within one place of the true value, so
# the two devices' g = -log(-log u) may part by 2 places of the inner log
# (at most 2 places at 1 after the outer log) plus 2 of the outer: 4 units
# in the last place at max(|g|, 1). A perturbed logit moves with g plus one
# rounding of the sum, so tokens must agree wherever the CPU's top-2
# margin of the perturbed logits exceeds twice that.
GUMBEL_CARD_ULPS = 4
# (temperature, top_k) of the sampler phase's 8 slots: greedy rows, top-k
# from 1 to 1000, temperatures from 0.7 to 2
SAMPLER_PARAMS = ((1.0, 0), (0.8, 40), (1.0, 50), (0.7, 0), (1.3, 5),
                  (1.0, 0), (0.9, 1), (2.0, 1000))
# the sampled serve runs' requests, (temperature, top_k, seed): chat-style
# sampling with 2 greedy requests among them (their tokens must equal the
# greedy serve run's)
SAMPLED_PARAMS = ((0.8, 40, 1), (1.0, 0, 0), (0.7, 0, 2), (1.2, 50, 3),
                  (1.0, 20, 4), (1.0, 0, 0), (0.9, 5, 5), (1.5, 100, 6))
SPEC_K = 4
SPEC_PATTERN = 32                 # the speculative runs' prompts repeat this
D_MODEL, FFN = 768, 3072                       # GPT-2 small's widths


def emit(obj):
    print(json.dumps(obj), flush=True)


def dtype_name(dt):
    return str(dt).replace("torch.", "")


class Timer:
    """Median device time of single launches, each after an L2 eviction.
    After the eviction the card spins for HOLD_CYCLES (about 1 ms) before
    the start event, so the host has queued the timed call by the time the
    card reaches it: the interval holds the call's device work and not the
    Python that prepares its launch, which for the row-wise kernels (tens
    of microseconds) would otherwise show as much as their own time."""

    HOLD_CYCLES = 2_000_000

    def __init__(self, dev):
        self.flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                                 device=dev)          # 128 MiB > 50 MB L2

    def ms(self, fn, reps=25, warmup=3):
        times = []
        for i in range(warmup + reps):
            self.flush.zero_()
            torch.cuda._sleep(self.HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i >= warmup:
                times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes, ops, dtype):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def random_pools(rng, dev, dtype, quant=False):
    """K/V pools of normal values in ``dtype``, or (``quant``) int8 pools
    quantized from them with their f32 scale pools. Returns (k, v, scales)
    with scales None or (k_scale, v_scale)."""
    k, v = (torch.from_numpy(rng.standard_normal(
        (NUM_PAGES, PS, NH, DH), dtype=np.float32)).to(dev) for _ in "kv")
    if not quant:
        return k.to(dtype), v.to(dtype), None
    (kq, ks), (vq, vs) = pa.quantize_kv(k), pa.quantize_kv(v)
    return kq, vq, (ks, vs)


def pool_bytes(keys, item, quant):
    """Bytes of K and V at ``keys`` token positions over all heads: the
    values, plus one f32 scale per position and head for int8 pools."""
    return 2 * keys * NH * (DH * item + (4 if quant else 0))


def library_window(pages, scales, table, dtype):
    """The paged window [B, nh, L, dh] gathered (and dequantized) in
    ``dtype`` for the SDPA yardstick, outside its timed region."""
    win = pa.gather_kv(pages, table)
    if scales is not None:
        win = pa.dequantize_window(win, pa.gather_scales(scales, table))
    return win.to(dtype).transpose(1, 2).contiguous()


def check_decode(dev, timer, dtype, quant=False, case="serve"):
    rng = np.random.default_rng(SEED)
    pos = np.array(DECODE_CASES[case], np.int32)
    b = len(pos)
    table = (1 + rng.permutation(NUM_PAGES - 1)[:b * MAXP]).reshape(b, MAXP)
    if case == "serve":
        table[4] = 0                 # inactive slot: all trash, at capacity
    kp, vp, scales = random_pools(rng, dev, dtype, quant)
    q = torch.from_numpy(rng.standard_normal((b, NH, DH), dtype=np.float32)
                         ).to(dev, dtype)
    pt = torch.from_numpy(table.astype(np.int32)).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    sc = scales or ()
    if quant:
        name = "paged_decode_int8"
        run = lambda **kw: cdec.paged_decode_int8(q, kp, vp, *sc, pt, pos_t,
                                                  **kw)
    else:
        name = "paged_decode"
        run = lambda **kw: cdec.paged_decode(q, kp, vp, pt, pos_t, **kw)

    out, visits = run(return_visits=True)
    torch.cuda.synchronize()
    ref = pa._plain_paged_attention(q, kp, vp, pt, pos_t, *sc)
    err = (out.float() - ref.float()).abs().max().item()
    want = cdec.pages_needed(pos_t, PS, MAXP).to(torch.int32)
    visits_ok = bool(torch.equal(visits, want[:, None].expand_as(visits)))

    # yardstick: SDPA over the already-gathered (dequantized) window
    kw = library_window(kp, sc[0] if quant else None, pt, dtype)
    vw = library_window(vp, sc[1] if quant else None, pt, dtype)
    lmax = kw.shape[2]
    mask = (torch.arange(lmax, device=dev)[None, :] <= pos_t[:, None].long()
            )[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    walked = [int(n) for n in want]
    distinct = len({int(p) for bi in range(b) for p in table[bi, :walked[bi]]})
    keys = torch.clamp(pos_t.long() + 1, max=MAXP * PS)
    item = q.element_size()
    nbytes = (pool_bytes(distinct * PS, kp.element_size(), quant)  # pages
              + 2 * q.numel() * item                       # q in, out
              + 4 * sum(walked) + 4 * b)                   # table, pos
    ops = 4 * DH * NH * int(keys.sum())
    b_ms, b_by = bound(nbytes, ops, dtype)
    line = {
        "phase": "kernel", "kernel": name, "dtype": dtype_name(dtype),
        "pool": "int8" if quant else dtype_name(dtype), "case": case,
        "shape": {"B": b, "nh": NH, "dh": DH, "page_size": PS,
                  "pages_per_slot": MAXP, "num_pages": NUM_PAGES,
                  "pos": pos.tolist()},
        "max_abs_err": err, "tol": TOL[dtype], "visits_ok": visits_ok,
        "visits": visits[:, 0].tolist(), "pages_needed": want.tolist(),
        "kernel_ms": timer.ms(run),
        "plain_ms": timer.ms(lambda: pa._plain_paged_attention(
            q, kp, vp, pt, pos_t, *sc)),
        "library_ms": timer.ms(lambda: sdpa(qs, kw, vw, attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    line.update(arm=cdec.arm(DH), splits=cdec.splits(b, NH, MAXP, PS, sms),
                grid=list(cdec.grid(b, NH, MAXP, PS, sms, DH)))
    line["vs_library"] = line["kernel_ms"] / line["library_ms"]
    emit(line)
    if not (err <= TOL[dtype] and visits_ok):
        raise SystemExit(f"{name} {dtype} {case}: err {err} or visits wrong")
    return line


def check_prefill(dev, timer, dtype, c, start, valid, quant=False):
    rng = np.random.default_rng(SEED + c + start)
    kp, vp, scales = random_pools(rng, dev, dtype, quant)
    row = torch.from_numpy((1 + rng.permutation(NUM_PAGES - 1)[:MAXP])
                           .astype(np.int32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((c, NH, DH), dtype=np.float32)
                         ).to(dev, dtype)
    sc = scales or ()
    # start and valid on the card, as the engine's packed upload holds
    # them; made once, outside the timed calls
    dev_s, dev_v = torch.tensor([start, valid], dtype=torch.int32,
                                device=dev)
    if quant:
        name = "paged_prefill_int8"
        run = lambda **kw: cpre.paged_prefill_int8(q, kp, vp, *sc, row,
                                                   dev_s, dev_v, **kw)
    else:
        name = "paged_prefill"
        run = lambda **kw: cpre.paged_prefill(q, kp, vp, row, dev_s, dev_v,
                                              **kw)

    out, visits = run(return_visits=True)
    torch.cuda.synchronize()
    ref = pa._plain_prefill_attention(q[None], kp, vp, row, start, valid,
                                      *sc)[0]
    err = (out.float() - ref.float()).abs().max().item()
    bq = cpre.default_block_q(c, dtype, DH)
    want = [min(cpre.block_visits(start, valid, i * bq, bq, PS), MAXP)
            for i in range(visits.shape[0])]
    visits_ok = bool((visits == torch.tensor(want, dtype=torch.int32,
                                             device=dev)[:, None]).all())
    padded_zero = bool((out[valid:] == 0).all())

    kw = library_window(kp, sc[0] if quant else None, row[None], dtype)
    vw = library_window(vp, sc[1] if quant else None, row[None], dtype)
    lmax = kw.shape[2]
    qpos = start + torch.arange(c, device=dev)
    mask = torch.arange(lmax, device=dev)[None, :] <= qpos[:, None]
    qs = q.transpose(0, 1)[None].contiguous()                # [1, nh, C, dh]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    npages = -(-(start + valid) // PS)
    item = q.element_size()
    nbytes = (pool_bytes(npages * PS, kp.element_size(), quant)
              + 2 * q.numel() * item + 4 * npages)
    ops = 4 * DH * NH * sum(start + r + 1 for r in range(valid))
    b_ms, b_by = bound(nbytes, ops, dtype)
    line = {
        "phase": "kernel", "kernel": name, "dtype": dtype_name(dtype),
        "pool": "int8" if quant else dtype_name(dtype),
        "shape": {"C": c, "start": start, "valid": valid, "nh": NH, "dh": DH,
                  "page_size": PS, "pages_per_slot": MAXP, "block_q": bq},
        "arm": cpre.arm(dtype, DH), "grid": list(cpre.grid(c, NH, dtype, DH)),
        "max_abs_err": err, "tol": TOL[dtype], "visits_ok": visits_ok,
        "padded_rows_zero": padded_zero,
        "visits": sorted(set(visits[:, 0].tolist())),
        "block_visits": sorted(set(want)),
        "kernel_ms": timer.ms(run),
        "plain_ms": timer.ms(lambda: pa._plain_prefill_attention(
            q[None], kp, vp, row, start, valid, *sc)),
        "library_ms": timer.ms(lambda: sdpa(qs, kw, vw, attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
    }
    line["vs_library"] = line["kernel_ms"] / line["library_ms"]
    emit(line)
    if not (err <= TOL[dtype] and visits_ok and padded_zero):
        raise SystemExit(f"{name} {dtype} C={c}: err {err}, visits "
                         f"{visits_ok}, padded rows zero {padded_zero}")
    return line


# the device-scalar sweep (`prefill_scalars`): a chunk of PREFILL_SCALAR_C
# rows with valid 0, 1 and the whole chunk, at start 0, mid-page in the
# slot, and at the slot's capacity (every key visible; only the kernel's
# clamp keeps the visible range in the slot)
PREFILL_SCALAR_C = 256
PREFILL_SCALAR_STARTS = (0, 501, MAXP * PS)
PREFILL_SCALAR_VALIDS = (0, 1, PREFILL_SCALAR_C)


def prefill_scalars(dev, dtype, quant=False):
    """Both prefill kernels with ``start`` and ``valid`` read from device
    memory across PREFILL_SCALAR_STARTS x PREFILL_SCALAR_VALIDS, each held
    against the plain version on the same values within TOL (padded rows
    zero). One line a kernel and dtype, its largest error."""
    rng = np.random.default_rng(SEED + 13)
    kp, vp, scales = random_pools(rng, dev, dtype, quant)
    sc = scales or ()
    row = torch.from_numpy((1 + rng.permutation(NUM_PAGES - 1)[:MAXP])
                           .astype(np.int32)).to(dev)
    c = PREFILL_SCALAR_C
    q = torch.from_numpy(rng.standard_normal((c, NH, DH), dtype=np.float32)
                         ).to(dev, dtype)
    fn = cpre.paged_prefill_int8 if quant else cpre.paged_prefill
    name = "paged_prefill_int8" if quant else "paged_prefill"
    errs, ok = {}, True
    for start in PREFILL_SCALAR_STARTS:
        for valid in PREFILL_SCALAR_VALIDS:
            s, v = torch.tensor([start, valid], dtype=torch.int32,
                                device=dev)
            out = fn(q, kp, vp, *sc, row, s, v)
            ref = pa._plain_prefill_attention(q[None], kp, vp, row, s, v,
                                              *sc)[0]
            err = (out.float() - ref.float()).abs().max().item()
            errs[f"{start}/{valid}"] = err
            ok &= err <= TOL[dtype] and bool((out[valid:] == 0).all())
    emit({"phase": "prefill_scalars", "kernel": name,
          "dtype": dtype_name(dtype), "pool": "int8" if quant
          else dtype_name(dtype), "shape": {"C": c, "nh": NH, "dh": DH,
                                             "page_size": PS,
                                             "pages_per_slot": MAXP},
          "max_abs_err_by_start_valid": errs, "tol": TOL[dtype], "ok": ok})
    if not ok:
        raise SystemExit(f"prefill_scalars {name} {dtype}: a device-scalar "
                         "call disagrees with the plain version")


def visible_pairs(sq, sk, causal):
    """(query, key) pairs the attention sees: every pair, or those on or
    below the bottom-right causal diagonal."""
    if not causal:
        return sq * sk
    return sum(min(sk, i + sk - sq + 1) for i in range(sq))


def flash_tol(dtype, ref, f32_tol):
    """f32: ``f32_tol`` times the largest reference value when it exceeds
    1; bf16: one bf16 step of the largest reference value, and never less
    than the f32 bound."""
    big = ref.float().abs().max().item()
    f32 = f32_tol * max(1.0, big)
    return f32 if dtype == torch.float32 else max(f32, 2.0 ** -7 * big)


def check_flash(dev, timer, dtype, case):
    """The three flash kernels against their plain versions at one shape,
    timed beside SDPA; one ``kernel`` line per kernel."""
    name, b, h, sq, sk, d, causal = case
    rng = np.random.default_rng(SEED + sq + sk)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dtype)
    q, k, v, do = rand(b * h, sq, d), rand(b * h, sk, d), \
        rand(b * h, sk, d), rand(b * h, sq, d)
    scale = 1.0 / float(np.sqrt(d))

    out, lse = cfa.flash_fwd(q, k, v, scale, causal)
    torch.cuda.synchronize()
    rout, rlse = tfa._plain_flash_fwd(q, k, v, scale, causal)
    delta = (do.float() * rout.float()).sum(-1)
    dq = cfa.flash_dq(q, k, v, do, rlse, delta, scale, causal)
    dk, dv = cfa.flash_dkv(q, k, v, do, rlse, delta, scale, causal)
    torch.cuda.synchronize()
    rdq = tfa._plain_flash_dq(q, k, v, do, rlse, delta, scale, causal)
    rdk, rdv = tfa._plain_flash_dkv(q, k, v, do, rlse, delta, scale, causal)
    checks = {
        "flash_fwd": [(out, rout, 2e-5), (lse, rlse, 2e-5)],
        "flash_dq": [(dq, rdq, 1e-4)],
        "flash_dkv": [(dk, rdk, 1e-4), (dv, rdv, 1e-4)]}

    # yardsticks: SDPA forward, and forward plus backward
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (t.view(b, h, t.shape[1], d) for t in (q, k, v, do))
    mask = tfa._visible(sq, sk, causal, dev) if causal and sq != sk else None
    kw = {"attn_mask": mask, "is_causal": causal and mask is None}
    gq, gk, gv = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
    library = {"flash_fwd": lambda: sdpa(q4, k4, v4, **kw)}
    library["flash_dq"] = library["flash_dkv"] = \
        lambda: sdpa(gq, gk, gv, **kw).backward(do4)
    runs = {
        "flash_fwd": (lambda: cfa.flash_fwd(q, k, v, scale, causal),
                      lambda: tfa._plain_flash_fwd(q, k, v, scale, causal)),
        "flash_dq": (lambda: cfa.flash_dq(q, k, v, do, rlse, delta, scale,
                                          causal),
                     lambda: tfa._plain_flash_dq(q, k, v, do, rlse, delta,
                                                 scale, causal)),
        "flash_dkv": (lambda: cfa.flash_dkv(q, k, v, do, rlse, delta, scale,
                                            causal),
                      lambda: tfa._plain_flash_dkv(q, k, v, do, rlse, delta,
                                                   scale, causal))}
    item = q.element_size()
    pairs = b * h * visible_pairs(sq, sk, causal)
    qbytes, kbytes = q.numel() * item, k.numel() * item
    rows = 4 * b * h * sq                          # one f32 per query row
    cost = {   # (bytes: inputs read once, outputs written once; operations)
        "flash_fwd": (2 * qbytes + 2 * kbytes + rows, 4 * d * pairs),
        "flash_dq": (3 * qbytes + 2 * kbytes + 2 * rows, 6 * d * pairs),
        "flash_dkv": (2 * qbytes + 4 * kbytes + 2 * rows, 8 * d * pairs)}
    lines = {}
    for kern, outs in checks.items():
        errs = [((g.float() - r.float()).abs().max().item(),
                 flash_tol(dtype, r, t)) for g, r, t in outs]
        err = max(e for e, _ in errs)
        ok = all(e <= t for e, t in errs)
        nbytes, ops = cost[kern]
        b_ms, b_by = bound(nbytes, ops, dtype)
        line = {
            "phase": "kernel", "kernel": kern, "dtype": dtype_name(dtype),
            "case": name,
            "shape": {"B": b, "H": h, "Sq": sq, "Sk": sk, "D": d,
                      "causal": causal},
            "max_abs_err": err, "tol": [t for _, t in errs], "within_tol": ok,
            "kernel_ms": timer.ms(runs[kern][0]),
            "plain_ms": timer.ms(runs[kern][1]),
            "library_ms": timer.ms(library[kern]),
            "library": "sdpa forward" if kern == "flash_fwd"
                       else "sdpa forward + backward",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops}
        line["vs_library"] = line["kernel_ms"] / line["library_ms"]
        if kern == "flash_fwd":
            line.update(arm=cfa.arm(dtype, d),
                        grid=list(cfa.grid(b * h, sq, dtype, d)))
        elif kern == "flash_dq":
            line.update(arm=cfa.dq_arm(dtype, d),
                        grid=list(cfa.dq_grid(b * h, sq, dtype, d)))
        elif kern == "flash_dkv":
            line.update(arm=cfa.dkv_arm(dtype, d),
                        grid=list(cfa.dkv_grid(b * h, sk, dtype, d)))
        emit(line)
        if not ok:
            raise SystemExit(f"{kern} {dtype} {name}: err {err} over "
                             f"{line['tol']}")
        lines[kern] = line
    return lines


def serve(engine, prompts, n, params=None):
    """Serve ``prompts`` to the end, ``n`` new tokens each; ``params``: one
    (temperature, top_k, seed) per prompt, or None (greedy)."""
    params = params or [(1.0, 0, 0)] * len(prompts)
    reqs = [engine.submit(p, max_new_tokens=n, temperature=t, top_k=k,
                          seed=s) for p, (t, k, s) in zip(prompts, params)]
    engine.run_until_idle(max_steps=10_000)
    return [r.result(timeout=0) for r in reqs]


def reset_launches():
    """Set every kernel's launch count to 0, just before a path's run."""
    for k in _build.kernels():
        k.launches = 0


def read_launches(phase, expected):
    """Every kernel's launches since `reset_launches`. ``expected`` maps the
    kernels the path must launch to their counts; every other kernel must
    show 0. A kernel that launched another number of times fails the run.
    """
    launches = {k.source: k.launches for k in _build.kernels()}
    for name, n in launches.items():
        want = expected.get(name, 0)
        if n != want or (name in expected and n <= 0):
            raise SystemExit(f"{phase}: {name} launched {n} times, expected "
                             f"{want}")
    return launches


def engine_launches(engine, before, phase):
    """The serve path's launches against the counts the engine's steps
    since ``before`` imply: one decode launch per layer per decode step,
    one prefill launch per layer per one-shot prefill or chunk, of the int8
    kernels on an int8 pool. A verify step (speculative decode) launches
    none: its attention is a gather and a dense softmax, as in the JAX
    package."""
    ran = {k: engine.counters[k] - before[k] for k in before}
    nl = engine.cfg.num_layers
    suffix = "_int8" if engine._quant_kv else ""
    expected = {"paged_decode" + suffix: nl * (ran["steps"]
                                               - ran["spec_steps"]),
                "paged_prefill" + suffix: nl * (ran["prefills"]
                                                + ran["prefill_chunks"])}
    expected = {k: n for k, n in expected.items() if n}
    return read_launches(phase, expected), expected, ran


def empty_pools(params, n, dev, cfg, quant=False):
    """K/V pools just big enough for ``n`` tokens (the trash page and
    ceil(n / PS) pages, int8 with scale pools under ``quant``) and the
    slot's page row over them."""
    npages = -(-n // PS)
    nh = cfg.num_heads
    shape = (cfg.num_layers, npages + 1, PS, nh, cfg.hidden_size // nh)
    kp = torch.zeros(shape, device=dev, dtype=torch.int8 if quant
                     else params["gpt.wte.weight"].dtype)
    vp = torch.zeros_like(kp)
    scales = {}
    if quant:
        scales = {"k_scale": torch.zeros(shape[:4], device=dev),
                  "v_scale": torch.zeros(shape[:4], device=dev)}
    row = torch.arange(1, npages + 1, dtype=torch.int32, device=dev)
    return kp, vp, scales, row


def padded(ids, n, cfg):
    """``ids`` padded with zeros to the engine's bucket for ``n`` tokens (a
    power of two, at least 16, at most the position table)."""
    out = np.zeros(min(max(16, 1 << (n - 1).bit_length()),
                       cfg.max_position_embeddings), np.int32)
    out[:len(ids)] = ids
    return out


def prefill_logits(params, prompt, dev, cfg, quant=False):
    """Greedy logits after ``prompt``: one-shot `prefill_step` into a pool
    just big enough for it, int8 with scale pools under ``quant``. Returns
    the logits and the pools ``(k, v[, k_scale, v_scale])``."""
    n = len(prompt)
    kp, vp, scales, row = empty_pools(params, n, dev, cfg, quant)
    ids = padded(prompt, n, cfg)
    out = gpt_mod.prefill_step(params, torch.from_numpy(ids).to(dev), n, row,
                               kp, vp, cfg=cfg, **scales)
    return out[0], out[1:]


def serve_parity(model, dev, kv_dtype="native"):
    """Engines on the card and on the CPU in the model's dtype, chunked
    prefill at 256, the same 4 requests; the phase ``serve_parity`` (float32)
    or, with an int8 pool, ``serve_int8_parity``, or for a bfloat16 model
    ``serve_bf16_parity``, which holds the bf16 tensor-core prefill end to
    end: its logits within `bf16_logit_bound` and its tokens equal wherever
    the CPU's top-2 margin exceeds that bound (a smaller margin can flip
    under bf16 noise; see BF16_LOGIT_STEPS)."""
    quant = kv_dtype == "int8"
    bf16 = model.gpt.wte.weight.dtype == torch.bfloat16
    phase = ("serve_bf16_parity" if bf16 else
             "serve_int8_parity" if quant else "serve_parity")
    rng = np.random.default_rng(SEED + 1)
    lens = (5, 17, 300, 600)
    cfg = model.cfg
    prompts = [rng.integers(0, min(VOCAB, cfg.vocab_size), n)
               .astype(np.int32) for n in lens]
    ecfg = EngineConfig(prefill_chunk_tokens=256, kv_dtype=kv_dtype,
                        prefix_cache=False, inflight=1)
    eng = DecodeEngine(model, ecfg, device=dev)
    t0 = time.perf_counter()
    counters0 = dict(eng.counters)
    reset_launches()                       # the chunked path's run
    card = serve(eng, prompts, 16)
    launches, expected, ran = engine_launches(eng, counters0, phase)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = serve(DecodeEngine(model, ecfg, device="cpu"), prompts, 16)
    t_cpu = time.perf_counter() - t0

    cpu_params = {k: v.detach() for k, v in model.state_dict().items()}
    card_params = {k: v.to(dev) for k, v in cpu_params.items()}
    runs = [[prefill_logits(params, p, where, cfg, quant) for p in prompts]
            for params, where in ((cpu_params, "cpu"), (card_params, dev))]
    lg_cpu = torch.stack([lg for lg, _ in runs[0]])
    lg_card = torch.stack([lg for lg, _ in runs[1]])
    bound = (bf16_logit_bound(lg_cpu) if bf16 else
             INT8_LOGIT_BOUND if quant else LOGIT_BOUND)
    margin_gate = bound if bf16 else MARGIN
    diff, logits_ok = margin_gated_parity(lg_cpu, lg_card, bound)
    line = {}
    if quant:
        # int8 K/V the card and the CPU wrote one quantization step apart
        # (page 0, the trash page, left out: padding rows land there in
        # an unspecified order)
        steps = [(a[:, 1:].cpu().int() - b[:, 1:].int()).abs()
                 for (_, pc), (_, pg) in zip(*runs) for a, b in
                 zip(pg[:2], pc[:2])]
        line = {"int8_values_off": sum(int((d > 0).sum()) for d in steps),
                "int8_values": sum(d.numel() for d in steps),
                "int8_max_step": max(int(d.max()) for d in steps)}

    reqs, tokens_ok = [], True
    for p, a, b in zip(prompts, card, cpu):
        rec = {"prompt_len": len(p), "tokens_equal": bool(np.array_equal(a, b))}
        if not rec["tokens_equal"]:
            t = int(np.flatnonzero(a != b)[0])          # first divergence
            top2 = prefill_logits(cpu_params, b[:t], "cpu", cfg,
                                  quant)[0].topk(2).values
            margin = float(top2[0] - top2[1])
            rec["first_divergence"] = {"position": t, "cpu_margin": margin}
            tokens_ok &= margin <= margin_gate
        reqs.append(rec)
    emit({"phase": phase, "model": "gpt2-small",
          "dtype": "bfloat16" if bf16 else "float32", "kv_dtype": kv_dtype,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "prefill_chunk_tokens": 256, "max_new_tokens": 16,
          "prefill_logit_max_abs_diff": diff, "logit_bound": bound,
          "margin_gate": margin_gate, "logits_ok": logits_ok,
          "tokens_ok": tokens_ok, "requests": reqs, **line,
          "one_shot_prefills": ran["prefills"],
          "prefill_chunks": ran["prefill_chunks"],
          "decode_steps": ran["steps"], "launches": launches,
          "expected_launches": expected,
          "card_seconds": t_card, "cpu_seconds": t_cpu})
    if not (logits_ok and tokens_ok):
        raise SystemExit(f"{phase}: card and CPU engines disagree")


def ulp_at(x):
    """One float32 unit in the last place at max(|x|, 1), per row of x."""
    big = x.abs().amax(dim=-1).clamp_min(1.0)
    return 2.0 ** (torch.floor(torch.log2(big)) - 23)


def sampler_phase(dev, smi, steps=5):
    """The card's fused sampler against the same torch code on the CPU: B=8
    slots of GPT-2's 50257 logits drawn from the seed, SAMPLER_PARAMS, one
    key chain a slot (seeds 0-7) through ``steps`` chained draws. Bits,
    uniforms and keys exact; Gumbel noise within GUMBEL_CARD_ULPS; tokens
    equal for greedy rows and wherever the CPU's perturbed top-2 margin
    exceeds the gate. Also the card's time per call (host clock, ending in a
    synchronize: the call is some hundreds of small launches)."""
    rng = np.random.default_rng(SEED + 5)
    b, v = len(SAMPLER_PARAMS), VOCAB
    temps = torch.tensor([t for t, _ in SAMPLER_PARAMS])
    topks = torch.tensor([k for _, k in SAMPLER_PARAMS])
    greedy = (temps == 1.0) & (topks == 0)
    keys = {"cpu": torch.stack([prng.prng_key(s) for s in range(b)])}
    keys[dev] = keys["cpu"].to(dev)
    recs, ok = [], True
    for _ in range(steps):
        lg = torch.from_numpy(rng.standard_normal((b, v), dtype=np.float32)
                              * 2)
        out = {}
        for where in ("cpu", dev):
            sub = prng.split(keys[where])[:, 1]
            out[where] = [t.cpu() for t in (
                prng.random_bits(sub, (v,)),
                prng.uniform(sub, (v,), np.finfo(np.float32).tiny, 1.0),
                prng.gumbel(sub, (v,)),
                smp.perturbed_logits(lg.to(where), sub, temps.to(where),
                                     topks.to(where)))]
            tok, keys[where] = smp.fused_sample(
                lg.to(where), keys[where], temps.to(where), topks.to(where))
            out[where].append(tok.cpu())
        (bits_c, u_c, g_c, p_c, t_c), (bits_g, u_g, g_g, p_g, t_g) = \
            out["cpu"], out[dev]
        ulp = ulp_at(g_c)
        top2 = p_c.topk(2, dim=-1).values
        # the rounding of the sum is one place at the top values (not at
        # the masked -1e30 entries)
        gate = 2 * (GUMBEL_CARD_ULPS * ulp + ulp_at(top2))
        sure = ((top2[:, 0] - top2[:, 1]) > gate) | greedy
        rec = {"bits_equal": torch.equal(bits_g, bits_c),
               "uniforms_equal": torch.equal(u_g.view(torch.int32),
                                             u_c.view(torch.int32)),
               "keys_equal": torch.equal(keys[dev].cpu(), keys["cpu"]),
               "gumbel_max_ulps": float(((g_g - g_c).abs().amax(-1)
                                         / ulp).max()),
               "tokens_equal": int((t_g == t_c).sum()),
               "tokens_gated": int(sure.sum()),
               "gated_tokens_differ": int((sure & (t_g != t_c)).sum())}
        ok &= (rec["bits_equal"] and rec["uniforms_equal"]
               and rec["keys_equal"] and rec["gated_tokens_differ"] == 0
               and rec["gumbel_max_ulps"] <= GUMBEL_CARD_ULPS)
        recs.append(rec)
    lg = torch.from_numpy(rng.standard_normal((b, v), dtype=np.float32)
                          ).to(dev)
    ms = []
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smp.fused_sample(lg, keys[dev], temps.to(dev), topks.to(dev))
        torch.cuda.synchronize()
        if i >= 3:
            ms.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "sampler", "card": smi, "slots": b, "vocab": v,
          "params": [list(p) for p in SAMPLER_PARAMS], "steps": recs,
          "gumbel_ulp_bound": GUMBEL_CARD_ULPS,
          "sample_ms_p50": statistics.median(ms), "ok": ok})
    if not ok:
        raise SystemExit("sampler: the card's sampler disagrees with the "
                         "CPU's")


def divergence_margin(params, cfg, context, t, param):
    """The CPU's top-2 margin at a request's generated token ``t``, after
    ``context`` (its prompt and generated tokens 0..t-1): of the logits for
    a greedy request, of the perturbed logits its key chain gives at that
    token (the seed key split once per earlier token) for a sampled one."""
    temp, top_k, seed = param
    lg = prefill_logits(params, context, "cpu", cfg)[0][None]
    if temp == 1.0 and top_k == 0:
        top2 = lg.topk(2).values[0]
    else:
        key = prng.prng_key(seed)
        for _ in range(t):
            key = prng.split(key)[0]
        pert = smp.perturbed_logits(lg, prng.split(key)[1][None],
                                    torch.tensor([temp]),
                                    torch.tensor([top_k]))
        top2 = pert.topk(2).values[0]
    return float(top2[0] - top2[1])


def compare_tokens(got, want, prompts, params, cfg, cpu_params):
    """Per request: tokens equal, else the first divergence with the CPU's
    margin there (`divergence_margin`)."""
    recs = []
    for p, a, b, param in zip(prompts, got, want, params):
        rec = {"prompt_len": len(p), "params": list(param),
               "tokens_equal": bool(np.array_equal(a, b))}
        if not rec["tokens_equal"]:
            t = int(np.flatnonzero(a != b)[0]) - len(p)
            rec["first_divergence"] = {
                "position": t, "cpu_margin": divergence_margin(
                    cpu_params, cfg, b[:len(p) + t], t, param)}
        recs.append(rec)
    return recs


def serve_sampled_parity(model, dev):
    """float32 engines with ``sampling=True`` on the card and on the CPU,
    chunked prefill at 256, 3 requests of mixed (temperature, top_k, seed)
    (one greedy), 16 new tokens: the tokens must be EQUAL (the sampler is
    exact on both; a difference prints the CPU's perturbed top-2 margin
    there and fails)."""
    phase, cfg = "serve_sampled_parity", model.cfg
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, min(VOCAB, cfg.vocab_size), n)
               .astype(np.int32) for n in (5, 300, 600)]
    params = [SAMPLED_PARAMS[0], SAMPLED_PARAMS[1], SAMPLED_PARAMS[3]]
    ecfg = EngineConfig(prefill_chunk_tokens=256, sampling=True,
                        prefix_cache=False, inflight=1)
    eng = DecodeEngine(model, ecfg, device=dev)
    counters0 = dict(eng.counters)
    reset_launches()                       # the sampled chunked path's run
    card = serve(eng, prompts, 16, params)
    launches, expected, ran = engine_launches(eng, counters0, phase)
    cpu = serve(DecodeEngine(model, ecfg, device="cpu"), prompts, 16, params)
    cpu_params = {k: v.detach() for k, v in model.state_dict().items()}
    reqs = compare_tokens(card, cpu, prompts, params, cfg, cpu_params)
    ok = all(r["tokens_equal"] for r in reqs)
    emit({"phase": phase, "model": "gpt2-small", "dtype": "float32",
          "prefill_chunk_tokens": 256, "max_new_tokens": 16,
          "requests": reqs, "tokens_ok": ok,
          "prefill_chunks": ran["prefill_chunks"],
          "one_shot_prefills": ran["prefills"], "decode_steps": ran["steps"],
          "d2h_transfers": ran["d2h_transfers"],
          "launches": launches, "expected_launches": expected})
    if not ok:
        raise SystemExit(f"{phase}: card and CPU sampled tokens differ")


def serve_spec_parity(model, dev):
    """float32, ``speculate_k=SPEC_K``, greedy and sampled requests on
    prompts repeating a SPEC_PATTERN-token pattern: the card's speculative
    engine must give the tokens of the card's plain engine and of the
    CPU's speculative engine (a difference prints the CPU's margin there
    and fails)."""
    phase, cfg = "serve_spec_parity", model.cfg
    rng = np.random.default_rng(SEED + 4)
    prompts = spec_prompts(rng, (64, 300, 600), cfg.vocab_size)
    params = [SAMPLED_PARAMS[1], SAMPLED_PARAMS[0], SAMPLED_PARAMS[4]]
    plain = EngineConfig(prefill_chunk_tokens=256, sampling=True,
                         prefix_cache=False, inflight=1)
    spec = EngineConfig(prefill_chunk_tokens=256, sampling=True,
                        speculate_k=SPEC_K, prefix_cache=False, inflight=1)
    eng = DecodeEngine(model, spec, device=dev)
    counters0 = dict(eng.counters)
    reset_launches()                       # the speculative path's run
    card = serve(eng, prompts, 16, params)
    launches, expected, ran = engine_launches(eng, counters0, phase)
    card_plain = serve(DecodeEngine(model, plain, device=dev), prompts, 16,
                       params)
    cpu = serve(DecodeEngine(model, spec, device="cpu"), prompts, 16, params)
    cpu_params = {k: v.detach() for k, v in model.state_dict().items()}
    vs_plain = compare_tokens(card, card_plain, prompts, params, cfg,
                              cpu_params)
    vs_cpu = compare_tokens(card, cpu, prompts, params, cfg, cpu_params)
    ok = all(r["tokens_equal"] for r in vs_plain + vs_cpu)
    emit({"phase": phase, "model": "gpt2-small", "dtype": "float32",
          "speculate_k": SPEC_K, "prefill_chunk_tokens": 256,
          "max_new_tokens": 16, "vs_card_plain": vs_plain, "vs_cpu": vs_cpu,
          "tokens_ok": ok, "verify_steps": ran["spec_steps"],
          "drafted": ran["spec_drafted"], "accepted": ran["spec_accepted"],
          "d2h_transfers": ran["d2h_transfers"],
          "launches": launches, "expected_launches": expected})
    if not ok:
        raise SystemExit(f"{phase}: speculative tokens differ")


SERVE_LENS = (7, 64, 129, 250, 380, 511, 700, 900)


def spec_prompts(rng, lens, vocab):
    """Prompts of ``lens`` tokens repeating one SPEC_PATTERN-token pattern,
    which the n-gram drafter finds (repetitive text: code edits,
    retrieval)."""
    pattern = rng.integers(0, min(VOCAB, vocab), SPEC_PATTERN)
    return [np.resize(pattern, n).astype(np.int32) for n in lens]


def warm(eng, prompt_lens, tail_lens=()):
    """``eng.warmup(prompt_lens, tail_lens)``, as a server does before its
    traffic: the kernels built and every step program the run will use
    captured, so no capture lands in a timed step. Returns the seconds it
    took (synchronized) and the card memory it reserved."""
    torch.cuda.synchronize()
    # each capture empties the allocator's cache; start from an empty one
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eng.warmup(prompt_lens=prompt_lens, tail_lens=tail_lens)
    torch.cuda.synchronize()
    return {"warmup_s": time.perf_counter() - t0,
            "warmup_programs": len(eng._programs),
            "warmup_reserved_bytes": torch.cuda.memory_reserved() - reserved}


def serve_engine(model, dev, tiled=False, **ecfg):
    """A serve run's engine (``ecfg``: its kv_dtype / weight_dtype, sampling,
    speculate_k), kernels built and warm, and its 8 prompts (repeating one
    pattern when ``tiled``). The prefix cache is off, as before it was
    ported, so that a request never hits the warm-up's pages (nor, in the
    tiled runs, another request's) and these runs stay comparable with
    earlier ones; `serve_prefix` measures it. The readback window is one
    step (``inflight=1``: each step's tokens are read back before the next
    is dispatched), as before the window was ported, unless ``ecfg``
    gives another (`serve_inflight`). Returns the engine, the prompts and
    `warm`'s line (the step programs of SERVE_LENS captured)."""
    rng = np.random.default_rng(SEED + 2)
    if tiled:
        prompts = spec_prompts(rng, SERVE_LENS, model.cfg.vocab_size)
    else:
        prompts = [rng.integers(0, min(VOCAB, model.cfg.vocab_size), n)
                   .astype(np.int32) for n in SERVE_LENS]
    eng = DecodeEngine(model, EngineConfig(**{
        "page_size": PS, "max_slots": 8, "prefix_cache": False,
        "inflight": 1, **ecfg}), device=dev)
    warmed = warm(eng, SERVE_LENS)
    serve(eng, prompts[:1], 2)             # first cuBLAS/allocator touches
    torch.cuda.synchronize()
    return eng, prompts, warmed


def prefill_graph_memory(model, dev, smi):
    """The card memory a serve engine's step programs take when it is
    warmed for SERVE_LENS (the decode graph and the prefill graphs of
    buckets 16-1024): its prefill graphs sharing one memory pool, the
    engine's default, and with a pool each (``_prefill_pool = None``).
    Per arm, `warm`'s reserved bytes and the peak allocated above the
    engine's own tensors during the captures."""
    line = {"phase": "prefill_graph_memory", "model": "gpt2-small",
            "dtype": "bfloat16", "card": smi, "prompt_lens": list(SERVE_LENS)}
    for arm in ("shared_pool", "pool_per_graph"):
        eng = DecodeEngine(model, EngineConfig(page_size=PS, max_slots=8,
                                               prefix_cache=False,
                                               inflight=1),
                           device=dev)
        if arm == "pool_per_graph":
            eng._prefill_pool = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        line[arm] = dict(warm(eng, SERVE_LENS), capture_peak_bytes=(
            torch.cuda.max_memory_allocated(dev) - base))
        del eng
    torch.cuda.empty_cache()
    emit(line)
    return line


# the host's runtime calls that put work on the card: kernel launches (the
# runtime's and the driver's entry points), graph launches and async copies
HOST_RUNTIME_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                      "cudaMemcpyAsync")


def host_runtime_calls(prof):
    """``{name: calls}`` of HOST_RUNTIME_CALLS among a profile's CPU
    events."""
    calls = {}
    for e in prof.key_averages():
        if e.key in HOST_RUNTIME_CALLS and e.count:
            calls[e.key] = calls.get(e.key, 0) + e.count
    return calls


def device_us(evt):
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0)


def profiled(run):
    """``run()`` under `torch.profiler`, synchronized: (the kernels the
    card ran, all of them, the port's and PyTorch's, graph-launched or
    not; their device milliseconds; the host's runtime calls by name,
    `host_runtime_calls`)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in kern), sum(map(device_us, kern)) / 1e3,
            host_runtime_calls(prof))


def launches_per_step(eng, prompts, params, steps=3):
    """From `torch.profiler`, a fresh admission of ``prompts`` (the step
    that admits them all, prefills them and runs the first decode step):
    its kernels, device milliseconds and host runtime calls; then per
    decode (or verify) step over ``steps`` steps: the kernels and the host
    runtime calls, by name and in all. The run is drained after."""
    reqs = [eng.submit(p, max_new_tokens=16, temperature=t, top_k=k, seed=s)
            for p, (t, k, s) in zip(prompts, params)]
    torch.cuda.synchronize()
    adm_kernels, adm_ms, adm_calls = profiled(eng.step)
    kernels, _, calls = profiled(lambda: [eng.step() for _ in range(steps)])
    eng.run_until_idle(max_steps=10_000)
    if not all(r.done for r in reqs):
        raise SystemExit("launches_per_step: requests left unfinished")
    return {"admission_kernel_launches": adm_kernels,
            "admission_device_ms": adm_ms,
            "admission_host_runtime_calls": sum(adm_calls.values()),
            "admission_host_runtime_calls_by_name": adm_calls,
            "kernel_launches_per_step": kernels / steps,
            "host_runtime_calls_per_step": sum(calls.values()) / steps,
            "host_runtime_calls_by_name": {k: n / steps
                                           for k, n in calls.items()}}


def timed_serve(eng, prompts, params, dev, phase):
    """Serve ``prompts`` (``params``: (temperature, top_k, seed) each), 32
    new tokens each, one synchronized step at a time, with every kernel's
    launch count set to 0 just before and checked just after against the
    engine's steps (`engine_launches`). Returns the timing line (with
    ``step_tokens``), the outputs and the counters' deltas."""
    counters0 = dict(eng.counters)
    reset_launches()                       # the path's run
    torch.cuda.reset_peak_memory_stats(dev)
    reqs = [eng.submit(p, max_new_tokens=32, temperature=t, top_k=k, seed=s)
            for p, (t, k, s) in zip(prompts, params)]
    step_ms, step_tokens = [], []
    t_run = time.perf_counter()
    more = True
    while more:
        before = sum(len(r.generated) for r in reqs)
        t0 = time.perf_counter()
        more = eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_tokens.append(sum(len(r.generated) for r in reqs) - before)
    wall = time.perf_counter() - t_run
    launches, expected, ran = engine_launches(eng, counters0, phase)
    outs = [r.result(timeout=0) for r in reqs]
    ok = all(o.shape == (len(p) + 32,)
             and ((o >= 0) & (o < eng.cfg.vocab_size)).all()
             for o, p in zip(outs, prompts))
    # step 1 admits and prefills all requests; the later steps only decode
    dec_ms, dec_tok = sum(step_ms[1:]), sum(step_tokens[1:])
    line = {"tokens_served": sum(step_tokens),
            "wall_s": wall, "decode_steps": len(step_ms) - 1,
            "decode_tokens_per_s": dec_tok / (dec_ms / 1e3),
            "ttft_ms_p50": statistics.median(
                (r.first_token_t - r.submit_t) * 1e3 for r in reqs),
            "step_ms_p50": statistics.median(step_ms[1:]),
            "first_step_ms": step_ms[0],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "reserved_memory_bytes": torch.cuda.memory_reserved(dev),
            "kv_bytes_per_token": eng.kv_bytes_per_token,
            "launches": launches, "expected_launches": expected,
            "outputs_ok": ok, "step_tokens": step_tokens}
    return line, outs, ran


def serve_run(model, dev, smi, phase="serve", params=None, greedy_ref=None,
              **ecfg):
    """The bf16 engine on the card serves the 8 prompts, 32 new tokens
    each, one-shot bucketed prefill; ``params`` gives each request its
    (temperature, top_k, seed) on a sampling engine, and where
    ``greedy_ref`` (the greedy run's outputs) is given, the greedy requests
    among them must equal it. Returns the line (``launches`` in it) and the
    outputs."""
    lens, cfg = SERVE_LENS, model.cfg
    spec = ecfg.get("speculate_k") is not None
    eng, prompts, warmed = serve_engine(model, dev, tiled=spec, **ecfg)
    params = params or [(1.0, 0, 0)] * len(prompts)

    line, outs, ran = timed_serve(eng, prompts, params, dev, phase)
    step_tokens = line.pop("step_tokens")
    ok = line["outputs_ok"]
    line = {"phase": phase, "model": "gpt2-small", "dtype": "bfloat16",
            "kv_dtype": eng.ecfg.kv_dtype,
            "weight_dtype": eng.ecfg.weight_dtype,
            "card": smi, "requests": len(prompts), "prompt_lens": list(lens),
            "max_new_tokens": 32, **warmed, **line}
    if eng.ecfg.sampling:
        line["request_params"] = [list(p) for p in params]
    if greedy_ref is not None:
        greedy = [i for i, (t, k, _) in enumerate(params)
                  if t == 1.0 and k == 0]
        line["greedy_equal_serve"] = [bool(np.array_equal(outs[i],
                                                          greedy_ref[i]))
                                      for i in greedy]
        ok = ok and all(line["greedy_equal_serve"])
    if spec:
        # each slot in a verify step emits 1 + its accepted drafts; the
        # first token of each request comes from its prefill
        emitted = sum(step_tokens) - len(prompts)
        line.update(speculate_k=eng.ecfg.speculate_k,
                    verify_steps=ran["spec_steps"],
                    drafted=ran["spec_drafted"],
                    accepted=ran["spec_accepted"],
                    accept_rate=ran["spec_accepted"]
                    / max(1, ran["spec_drafted"]),
                    tokens_per_slot_step=emitted
                    / max(1, emitted - ran["spec_accepted"]))
    line.update(launches_per_step(eng, prompts, params))
    if eng._quant_kv or eng.ecfg.weight_dtype != "native":
        # each prompt's first-token logits against the native bf16 ones
        native = {k: v.detach().to(dev) for k, v in model.state_dict().items()}
        lg_q = torch.stack([prefill_logits(eng._params, p, dev, cfg,
                                           eng._quant_kv)[0]
                            for p in prompts])
        lg_n = torch.stack([prefill_logits(native, p, dev, cfg)[0]
                            for p in prompts])
        diff, parity_ok = margin_gated_parity(lg_n, lg_q, QUANT_LOGIT_BOUND)
        line.update(first_token_logit_max_abs_diff=diff,
                    logit_bound=QUANT_LOGIT_BOUND, parity_ok=parity_ok)
        ok = ok and parity_ok
    emit(line)
    if not ok:
        raise SystemExit(f"{phase}: malformed outputs, logits out of bound "
                         "or greedy tokens unlike serve's")
    return line, outs


# the prefix phases: a shared system prompt and each request's own suffix
PREFIX_PARITY_SYSTEM, PREFIX_PARITY_SUFFIXES = 100, (5, 17, 29, 40)
PREFIX_SYSTEM = 768                              # 48 pages of 16
PREFIX_SUFFIXES = (9, 31, 64, 100, 129, 160, 200, 224)
PREFIX_HOST_TIER = 64 << 20                      # host tier of the timed run
PREFIX_ARMS = ("cold", "hbm", "host_tier")


def prefix_prompts(rng, vocab, system_len, suffixes):
    """A random system prompt and one prompt a suffix: system + suffix."""
    v = min(VOCAB, vocab)
    system = rng.integers(0, v, system_len).astype(np.int32)
    return system, [np.concatenate([system, rng.integers(0, v, n).astype(
        np.int32)]) for n in suffixes]


def demote_all(eng):
    """Evict every idle cached page through the prefix store's evict hook
    (their contents demote to the engine's KV tiers) and return them to
    the free list; returns how many pages went."""
    idle = eng._evict_prefix_pages(len(eng._prefix_idle))
    if idle:
        eng.allocator.reclaim(idle)
    return len(idle)


def system_pages(eng, system):
    """The pages the prefix store holds for ``system``'s full pages, and
    their contents (values, and scales on an int8 pool) copied to the
    host."""
    pages = eng._prefix_lookup(prompt_page_hashes(system, PS))
    return pages, [t.cpu() for t in pa.export_pages(
        eng._kc, eng._vc, pages, *((eng._ks, eng._vs) if eng._quant_kv
                                   else ()))]


def page_blob_bytes(cfg, quant, item):
    """One page's values (and int8 scales) across the layers, in bytes:
    the body of its tier blob."""
    nh = cfg.num_heads
    dh = cfg.hidden_size // nh
    return cfg.num_layers * 2 * PS * nh * (dh * item + (4 if quant else 0))


PREFIX_COUNTERS = ("prefix_hit", "prefix_miss", "prefix_pages_reused",
                   "prefix_evictions", "prefix_evictions_demoted",
                   "prefill_tokens", "kvtier_hits_host", "kvtier_hits_disk",
                   "kvtier_reuploads_host", "kvtier_reuploads_disk")


def tail_logits(params, prompt, cached, dev, cfg, quant=False):
    """Logits after ``prompt`` the way a prefix hit computes them: its first
    ``cached`` tokens one-shot into their pages (`prefill_step`), then the
    rest through ONE `prefill_chunk_step` at start=cached at the tail's
    bucket, the engine's tail path."""
    kp, vp, scales, row = empty_pools(params, len(prompt), dev, cfg, quant)
    gpt_mod.prefill_step(params, torch.from_numpy(padded(
        prompt[:cached], cached, cfg)).to(dev), cached, row, kp, vp, cfg=cfg,
        **scales)
    tail = len(prompt) - cached
    return gpt_mod.prefill_chunk_step(
        params, torch.from_numpy(padded(prompt[cached:], tail, cfg)).to(dev),
        cached, tail, row, kp, vp, cfg=cfg, **scales)[0]


def serve_prefix_parity(model, dev, kv_dtype="native"):
    """float32 engines on the card and on the CPU with the prefix cache on
    and a host tier of 3 page blobs over a disk tier: a seeding request of
    a PREFIX_PARITY_SYSTEM-token system prompt, then 4 requests of it plus
    their own 5-40-token suffixes, 16 new tokens each. The tails prefill at
    start > 0 over the shared pages. Holds the tokens (margin-gated as in
    `serve_parity`), every prefix counter equal on both devices, and each
    tail's logits (`tail_logits`) within serve_parity's bound. Then the
    tier arm, on a fresh engine a device: the seeding request's pages
    demoted (3 to host RAM, the rest to disk), then the 4 requests: the
    system prompt's pages re-uploaded byte-equal to the pages exported
    before the spill, the tails prefilled from the same position as in the
    first run, and the tokens equal to the first run's."""
    quant = kv_dtype == "int8"
    phase = "serve_prefix_parity" + ("_int8" if quant else "")
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 7)
    system, prompts = prefix_prompts(rng, cfg.vocab_size,
                                     PREFIX_PARITY_SYSTEM,
                                     PREFIX_PARITY_SUFFIXES)
    blob = page_blob_bytes(cfg, quant, 1 if quant else 4)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tier_") as tmp:
        for i, where in enumerate((dev, "cpu")):
            def engine(arm):
                return DecodeEngine(model, EngineConfig(
                    inflight=1,
                    kv_dtype=kv_dtype, kv_host_tier_bytes=3 * (blob + 1024),
                    kv_disk_tier_bytes=1 << 30,
                    kv_disk_tier_dir=f"{tmp}/{i}-{arm}"), device=where)
            on_card = i == 0
            eng = engine("hbm")
            serve(eng, [system], 2)                  # seeds the store
            counters0 = dict(eng.counters)
            if on_card:
                reset_launches()                     # the prefix path's run
            first = serve(eng, prompts, 16)
            if on_card:
                launches, expected, ran = engine_launches(eng, counters0,
                                                          phase)
            counters = {k: eng.counters[k] - counters0[k]
                        for k in PREFIX_COUNTERS}
            # the tier arm: a fresh engine seeded alike, its system pages
            # demoted (3 to host RAM, the rest to disk), then the requests
            eng = engine("tier")
            serve(eng, [system], 2)
            pages, before = system_pages(eng, system)
            demoted = demote_all(eng)
            tiers = (eng._tiers.host_pages(), eng._tiers.disk_pages())
            tier0 = dict(eng.counters)
            again = serve(eng, prompts, 16)
            pages_after, after = system_pages(eng, system)
            runs[i] = {
                "outs": first, "counters": counters,
                "tier_counters": {k: eng.counters[k] - tier0[k]
                                  for k in PREFIX_COUNTERS},
                "again_equal": all(np.array_equal(a, b)
                                   for a, b in zip(first, again)),
                "pages_byte_equal": len(pages_after) == len(pages) > 0
                and all(torch.equal(a, b) for a, b in zip(before, after)),
                "demoted": demoted, "tiers": tiers,
                "free_pages_ok": eng.allocator.free_pages
                == eng.allocator.num_pages - 1}
    card, cpu = runs[0], runs[1]

    cached = [min((len(p) - 1) // PS, PREFIX_PARITY_SYSTEM // PS) * PS
              for p in prompts]
    cpu_params = {k: v.detach() for k, v in model.state_dict().items()}
    card_params = {k: v.to(dev) for k, v in cpu_params.items()}
    lg = [torch.stack([tail_logits(params, p, c, where, cfg, quant)
                       for p, c in zip(prompts, cached)])
          for params, where in ((cpu_params, "cpu"), (card_params, dev))]
    bound = INT8_LOGIT_BOUND if quant else LOGIT_BOUND
    diff, logits_ok = margin_gated_parity(lg[0], lg[1], bound)
    reqs, tokens_ok = [], True
    for p, a, b in zip(prompts, card["outs"], cpu["outs"]):
        rec = {"prompt_len": len(p), "tokens_equal": bool(np.array_equal(a,
                                                                         b))}
        if not rec["tokens_equal"]:
            t = int(np.flatnonzero(a != b)[0])
            top2 = prefill_logits(cpu_params, b[:t], "cpu", cfg,
                                  quant)[0].topk(2).values
            rec["first_divergence"] = {"position": t,
                                       "cpu_margin": float(top2[0] - top2[1])}
            tokens_ok &= rec["first_divergence"]["cpu_margin"] <= MARGIN
        reqs.append(rec)
    counters_ok = card["counters"] == cpu["counters"] \
        and card["tier_counters"] == cpu["tier_counters"]
    n_sys = PREFIX_PARITY_SYSTEM // PS
    tier_ok = all(r["again_equal"] and r["pages_byte_equal"]
                  and r["free_pages_ok"] and r["demoted"] == n_sys
                  and r["tiers"][0] > 0 and r["tiers"][1] > 0
                  and r["tier_counters"]["kvtier_reuploads_host"]
                  + r["tier_counters"]["kvtier_reuploads_disk"] == n_sys
                  for r in runs.values())
    hit_ok = card["counters"]["prefix_hit"] >= len(prompts)
    emit({"phase": phase, "model": "gpt2-small", "dtype": "float32",
          "kv_dtype": kv_dtype, "system_len": PREFIX_PARITY_SYSTEM,
          "suffixes": list(PREFIX_PARITY_SUFFIXES), "max_new_tokens": 16,
          "tail_starts": cached, "tail_logit_max_abs_diff": diff,
          "logit_bound": bound, "logits_ok": logits_ok,
          "tokens_ok": tokens_ok, "requests": reqs,
          "counters_card": card["counters"], "counters_cpu": cpu["counters"],
          "counters_equal": counters_ok,
          "tier_arm": {w: {k: r[k] for k in ("demoted", "tiers",
                                              "tier_counters",
                                              "again_equal",
                                              "pages_byte_equal",
                                              "free_pages_ok")}
                       for w, r in (("card", card), ("cpu", cpu))},
          "tier_ok": tier_ok, "one_shot_prefills": ran["prefills"],
          "prefill_chunks": ran["prefill_chunks"],
          "decode_steps": ran["steps"], "launches": launches,
          "expected_launches": expected})
    if not (logits_ok and tokens_ok and counters_ok and tier_ok and hit_ok):
        raise SystemExit(f"{phase}: the prefix path disagrees")


def prefix_engine(model, dev, arm):
    """A warm bf16 engine of one `serve_prefix` arm: ``cold`` (prefix cache
    off), ``hbm`` (on, seeded with the system prompt) or ``host_tier`` (on,
    seeded, and every cached page demoted to a PREFIX_HOST_TIER host tier).
    Warmed for the prompts' lengths (and, with the cache on, their tails'
    buckets) before the seeding. Returns the engine, the system prompt, the
    8 prompts, the spill's milliseconds (synchronized) and pages for
    ``host_tier``, and `warm`'s line."""
    system, prompts = prefix_prompts(np.random.default_rng(SEED + 6),
                                     model.cfg.vocab_size, PREFIX_SYSTEM,
                                     PREFIX_SUFFIXES)
    ecfg = dict(page_size=PS, max_slots=8, prefix_cache=arm != "cold",
                inflight=1)
    if arm == "host_tier":
        ecfg["kv_host_tier_bytes"] = PREFIX_HOST_TIER
    eng = DecodeEngine(model, EngineConfig(**ecfg), device=dev)
    warmed = warm(eng, [PREFIX_SYSTEM, 64] + [len(p) for p in prompts],
                  PREFIX_SUFFIXES if arm != "cold" else ())
    touch = np.random.default_rng(SEED + 8).integers(0, VOCAB, 64)
    eng.submit(touch, max_new_tokens=2, cache=False)   # first touches
    eng.run_until_idle(max_steps=100)
    spill = None
    if arm != "cold":
        serve(eng, [system], 2)                   # seeds the store
    if arm == "host_tier":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = demote_all(eng)
        torch.cuda.synchronize()
        spill = ((time.perf_counter() - t0) * 1e3, n)
    torch.cuda.synchronize()
    return eng, system, prompts, spill, warmed


def bf16_gated_tokens(got, want, prompts, card_params, cfg, dev,
                      name="want"):
    """Per request: the bf16 tokens ``got`` equal to ``want``, else the
    first divergence, which must come where ``want``'s top-2 margin there
    (the card's logits) is within `bf16_logit_bound`, as
    `serve_bf16_parity` gates. Returns the records and whether all pass."""
    recs, ok = [], True
    for p, a, b in zip(prompts, got, want):
        rec = {"prompt_len": len(p), "tokens_equal": bool(np.array_equal(a,
                                                                         b))}
        if not rec["tokens_equal"]:
            t = int(np.flatnonzero(a != b)[0])
            lg = prefill_logits(card_params, b[:t], dev, cfg)[0]
            top2 = lg.topk(2).values
            rec["first_divergence"] = {
                "position": t, name + "_margin": float(top2[0] - top2[1]),
                "gate": bf16_logit_bound(lg)}
            ok &= rec["first_divergence"][name + "_margin"] \
                <= rec["first_divergence"]["gate"]
        recs.append(rec)
    return recs, ok


def serve_prefix(model, dev, smi):
    """The bf16 engine on the card serves 8 requests that share a
    PREFIX_SYSTEM-token system prompt, each with its own suffix
    (PREFIX_SUFFIXES), 32 new tokens each, in three arms (`prefix_engine`):
    cold, a seeded HBM prefix store, and a host tier that the seeded pages
    were demoted to. Each arm's line: TTFT, steps, tokens/s, memory,
    prefill tokens computed, hits, pages reused, re-uploads, the exact
    kernel launches (a tail is a chunk), and for the tier its spill and
    re-upload milliseconds a page (synchronized host clock). The hbm and
    host_tier tokens must be EQUAL (the same bytes); against cold they are
    gated as `serve_bf16_parity`'s: a difference must come where the cold
    run's top-2 margin is within `bf16_logit_bound`."""
    lines, outs = {}, {}
    params = [(1.0, 0, 0)] * len(PREFIX_SUFFIXES)
    card_params = {k: v.detach().to(dev) for k, v in
                   model.state_dict().items()}
    for arm in PREFIX_ARMS:
        eng, system, prompts, spill, warmed = prefix_engine(model, dev, arm)
        line, outs[arm], ran = timed_serve(eng, prompts, params, dev,
                                           "serve_prefix:" + arm)
        line.pop("step_tokens")
        line = {"phase": "serve_prefix", "arm": arm, "model": "gpt2-small",
                "dtype": "bfloat16", "card": smi,
                "system_len": PREFIX_SYSTEM,
                "suffixes": list(PREFIX_SUFFIXES), "max_new_tokens": 32,
                **warmed, **line, **{k: ran[k] for k in PREFIX_COUNTERS},
                "one_shot_prefills": ran["prefills"],
                "prefill_chunks": ran["prefill_chunks"]}
        if spill is not None:
            # the re-upload alone: the spilled chain into fresh pages
            hashes = prompt_page_hashes(system, PS)
            pages = eng.allocator.alloc(len(hashes))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = eng._tier_reupload(hashes, PREFIX_SYSTEM + 1, [], pages)
            torch.cuda.synchronize()
            reup_ms = (time.perf_counter() - t0) * 1e3
            eng.allocator.free(pages)
            line.update(spill_pages=spill[1],
                        spill_ms_per_page=spill[0] / max(1, spill[1]),
                        reupload_pages=n,
                        reupload_ms_per_page=reup_ms / max(1, n),
                        page_bytes=page_blob_bytes(model.cfg, False, 2),
                        host_tier_pages=eng._tiers.host_pages())
            line["outputs_ok"] &= n == spill[1] == len(hashes)
        line.update(launches_per_step(eng, prompts, params))
        lines[arm] = line
        del eng
        torch.cuda.empty_cache()

    ok = all(ln["outputs_ok"] for ln in lines.values())
    lines["host_tier"]["tokens_equal_hbm"] = eq = [
        bool(np.array_equal(a, b))
        for a, b in zip(outs["host_tier"], outs["hbm"])]
    ok &= all(eq)
    recs, gated = bf16_gated_tokens(outs["hbm"], outs["cold"], prompts,
                                    card_params, model.cfg, dev, "cold")
    ok &= gated
    lines["hbm"]["vs_cold"] = recs
    want = {"cold": (8 * PREFIX_SYSTEM + sum(PREFIX_SUFFIXES), 0),
            "hbm": (sum(PREFIX_SUFFIXES), 8),
            "host_tier": (sum(PREFIX_SUFFIXES), 7)}
    for arm, (tokens, hits) in want.items():
        ln = lines[arm]
        ln["expected_prefill_tokens"] = tokens
        ok &= ln["prefill_tokens"] == tokens and ln["prefix_hit"] == hits
        emit(ln)
    if not ok:
        raise SystemExit("serve_prefix: malformed outputs, prefill work "
                         "unlike the prefix store's, or tokens that differ "
                         "between arms")
    return lines


# serve_inflight: the readback window's arms, in turns, and the new tokens
# a request: as many as the longest prompt (900) leaves of the position
# table (1024), so that decode dominates the run
INFLIGHT_TURNS = (1, 2, 3, 3, 2, 1)
INFLIGHT_NEW_TOKENS = 124


def windowed_serve(eng, prompts, n, phase):
    """Serve ``prompts``, ``n`` new tokens each, with NO synchronization
    between steps (the window stays full) and one `torch.cuda.synchronize`
    at the end; every kernel's launch count set to 0 just before and held
    just after (`engine_launches`). The host's step intervals are the
    clock: step 1 admits and prefills every request; decode tokens/s is
    the tokens delivered in steps 2.. over the time from step 1's end to
    the final synchronize, `timed_serve`'s definition. Returns the line
    and the outputs."""
    counters0 = dict(eng.counters)
    reset_launches()                       # the path's run
    torch.cuda.synchronize()
    reqs = [eng.submit(p, max_new_tokens=n) for p in prompts]
    stamps = [time.perf_counter()]
    delivered = []
    more = True
    while more:
        more = eng.step()
        stamps.append(time.perf_counter())
        delivered.append(sum(len(r.generated) for r in reqs))
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches, expected, ran = engine_launches(eng, counters0, phase)
    outs = [r.result(timeout=0) for r in reqs]
    step_ms = np.diff(stamps) * 1e3
    ok = all(o.shape == (len(p) + n,)
             and ((o >= 0) & (o < eng.cfg.vocab_size)).all()
             for o, p in zip(outs, prompts))
    line = {"inflight": eng.ecfg.inflight,
            "decode_tokens_per_s": (delivered[-1] - delivered[0])
            / (end - stamps[1]),
            "step_ms_p50": float(np.median(step_ms[1:])),
            "first_step_ms": float(step_ms[0]),
            "ttft_ms_p50": statistics.median(
                (r.first_token_t - r.submit_t) * 1e3 for r in reqs),
            "wall_s": end - stamps[0], "engine_steps": len(step_ms),
            "decode_steps": ran["steps"],
            "d2h_transfers": ran["d2h_transfers"],
            "h2d_transfers": ran["h2d_transfers"],
            "launches": launches, "expected_launches": expected,
            "outputs_ok": ok}
    return line, outs


def serve_inflight(model, dev, smi, serve_outs):
    """The bf16 engine of `serve` (8 requests of SERVE_LENS prompts, one-shot
    prefill, prefix cache off) at readback windows 1, 2 and 3, one warm
    engine each, INFLIGHT_NEW_TOKENS new tokens a request, run in the turns
    of INFLIGHT_TURNS (`windowed_serve`: no synchronization between
    steps). The tokens must be identical in every turn, and their first 32
    equal to ``serve_outs`` (the `serve` phase's, ``inflight=1``); each
    turn's launches exact. One line: each turn's numbers, and per window
    the mean of its two turns."""
    phase = "serve_inflight"
    engines, prompts, warmed = {}, None, {}
    for k in sorted(set(INFLIGHT_TURNS)):
        engines[k], prompts, warmed[k] = serve_engine(model, dev, inflight=k)
    turns, ok, first = [], True, None
    for turn, k in enumerate(INFLIGHT_TURNS):
        line, outs = windowed_serve(engines[k], prompts, INFLIGHT_NEW_TOKENS,
                                    f"{phase}:{k}")
        first = first or outs
        line["turn"] = turn
        line["tokens_equal_first_turn"] = all(
            np.array_equal(a, b) for a, b in zip(outs, first))
        line["first_32_equal_serve"] = all(
            np.array_equal(a[:len(p) + 32], b)
            for a, b, p in zip(outs, serve_outs, prompts))
        ok &= (line["outputs_ok"] and line["tokens_equal_first_turn"]
               and line["first_32_equal_serve"])
        turns.append(line)
    by_window = {}
    for k in sorted(set(INFLIGHT_TURNS)):
        mine = [t for t in turns if t["inflight"] == k]
        by_window[str(k)] = {
            m: statistics.mean(t[m] for t in mine)
            for m in ("decode_tokens_per_s", "step_ms_p50", "ttft_ms_p50",
                      "first_step_ms")}
    emit({"phase": phase, "model": "gpt2-small", "dtype": "bfloat16",
          "card": smi, "requests": len(prompts),
          "prompt_lens": list(SERVE_LENS),
          "max_new_tokens": INFLIGHT_NEW_TOKENS,
          "warmup_s": {str(k): w["warmup_s"] for k, w in warmed.items()},
          "by_inflight": by_window, "turns": turns, "ok": ok})
    if not ok:
        raise SystemExit(f"{phase}: tokens differ between readback windows "
                         "or from serve's, or malformed outputs")
    del engines
    torch.cuda.empty_cache()


# serve_lifecycle: engine A's two waves (prompt lengths; its request 5 is
# request 1's first LIFECYCLE_SYSTEM tokens plus a suffix of its own, and
# is cancelled mid-decode), their new tokens, and engine B's prompts
LIFECYCLE_WAVE1 = (40, 100, 200, 64, 129, 250, 380, 511)
LIFECYCLE_WAVE2 = (30, 90, 150, 47, 77, 120, 200, 60)
LIFECYCLE_SYSTEM = 64                      # 4 pages shared by requests 1, 5
LIFECYCLE_KEY = bytes(range(16))
LADDER_PRIME = 200                         # 12 full pages, idle when queued
LADDER_LENS = (64, 96, 128, 160, 192, 224, 256, 288)
LADDER_QUEUE = 6                           # 6 / max_queue_depth 8: level 2


def lifecycle_admission(model, dev, card_params):
    """Engine A of `serve_lifecycle` (B=8, ``max_queue_depth=8``, prefix
    cache on, ``inflight=2``): returns its record and whether every check
    passed."""
    cfg, rng = model.cfg, np.random.default_rng(SEED + 10)
    vocab = min(VOCAB, cfg.vocab_size)
    wave1 = [rng.integers(0, vocab, n).astype(np.int32)
             for n in LIFECYCLE_WAVE1]
    wave1[5][:LIFECYCLE_SYSTEM] = wave1[1][:LIFECYCLE_SYSTEM]
    wave2 = [rng.integers(0, vocab, n).astype(np.int32)
             for n in LIFECYCLE_WAVE2]
    ecfg = EngineConfig(page_size=PS, max_slots=8, max_queue_depth=8,
                        inflight=2)
    eng = DecodeEngine(model, ecfg, device=dev)
    warm(eng, LIFECYCLE_WAVE1 + LIFECYCLE_WAVE2,
         [LIFECYCLE_WAVE1[5] - LIFECYCLE_SYSTEM])
    counters0 = dict(eng.counters)
    reset_launches()                       # the lifecycle path's run
    rec, ok = {}, True
    news = [96 if i == 5 else 48 for i in range(8)]
    first = [eng.submit(wave1[0], news[0], request_key=LIFECYCLE_KEY)] \
        + [eng.submit(p, n) for p, n in zip(wave1[1:], news[1:])]
    eng.step()                             # all eight admitted
    rec["admitted"] = sum(r is not None for r in eng._slot_req)
    rec["dedup_in_flight_same_request"] = eng.submit(
        wave1[0], news[0], request_key=LIFECYCLE_KEY) is first[0]
    second = [eng.submit(p, 32) for p in wave2]
    try:
        eng.submit(wave2[0], 32)
        rec["shed"] = None
    except Overloaded as e:
        rec["shed"] = f"Overloaded: {e}"
    rec["queue_depth"] = eng.gauges["queue_depth"]
    rec["cancel_queued"] = [eng.cancel(r.request_id) for r in second[:2]]
    for _ in range(3):
        eng.step()
    victim = first[5]
    slot = eng._slot_req.index(victim)
    rec["cancel_running"] = eng.cancel(victim.request_id,
                                       reason="client went away")
    eng.step()
    rec["freed_slot_went_to_next_queued"] = eng._slot_req[slot] is second[2]
    with faults.scoped("engine.step_delay", times=1, delay_s=0.1):
        late = eng.submit(wave2[3], 32, deadline_s=0.05)
        eng.step()
    eng.run_until_idle(max_steps=10_000)
    launches, expected, ran = engine_launches(eng, counters0,
                                              "serve_lifecycle:admission")
    rec["replay_same_request"] = eng.submit(
        wave1[0], news[0], request_key=LIFECYCLE_KEY) is first[0]

    def error(r):
        try:
            r.result(timeout=0)
        except RuntimeError as e:
            return f"{type(e).__name__}: {e}"
        return None

    rec["errors"] = {"queued_cancelled": [error(r) for r in second[:2]],
                     "running_cancelled": error(victim),
                     "deadline": error(late)}
    ran.update((k, eng.counters[k] - counters0[k]) for k in (
        "requests", "shed", "dedup_hits", "dedup_replays", "cancelled",
        "deadline_exceeded", "prefix_hit", "prefix_pages_reused"))
    survivors = [r for r in first + second
                 if r is not victim and r not in second[:2]]
    want_prefill = sum(r.prompt.size for r in survivors + [victim]) \
        - PS * ran["prefix_pages_reused"]
    rec.update(counters=ran, expected_prefill_tokens=want_prefill,
               free_pages=eng.allocator.free_pages,
               pool_pages=eng.allocator.num_pages - 1,
               launches=launches, expected_launches=expected)
    ok &= (rec["admitted"] == 8 and rec["dedup_in_flight_same_request"]
           and rec["shed"] == "Overloaded: engine queue full: depth 8 >= "
                             "max_queue_depth 8"
           and rec["queue_depth"] == 8
           and rec["cancel_queued"] == [True, True]
           and rec["cancel_running"] and rec["freed_slot_went_to_next_queued"]
           and rec["replay_same_request"]
           and rec["errors"]["queued_cancelled"]
           == ["Cancelled: cancelled by client"] * 2
           and rec["errors"]["running_cancelled"]
           == "Cancelled: client went away"
           and rec["errors"]["deadline"]
           == "DeadlineExceeded: request deadline (0.05s) passed after 0 "
              "generated tokens"
           and ran["requests"] == 17 and ran["shed"] == 1
           and ran["dedup_hits"] == 1 and ran["dedup_replays"] == 1
           and ran["cancelled"] == 3 and ran["deadline_exceeded"] == 1
           and ran["prefix_hit"] == 1
           and ran["prefix_pages_reused"] == LIFECYCLE_SYSTEM // PS
           and ran["prefill_tokens"] == want_prefill
           and rec["free_pages"] == rec["pool_pages"])
    # the survivors' tokens against an undisturbed engine's (no queue
    # bound: it takes them all at once)
    calm = DecodeEngine(model, EngineConfig(page_size=PS, max_slots=8,
                                            inflight=2), device=dev)
    again = [calm.submit(r.prompt, r.max_new_tokens) for r in survivors]
    calm.run_until_idle(max_steps=10_000)
    want = [r.result(timeout=0) for r in again]
    got = [r.result(timeout=0) for r in survivors]
    rec["survivors_vs_undisturbed"], gated = bf16_gated_tokens(
        got, want, [r.prompt for r in survivors], card_params, cfg, dev,
        "undisturbed")
    ok &= gated
    del eng, calm
    return rec, ok


def lifecycle_ladder(model, dev):
    """Engine B of `serve_lifecycle` (B=8, ``speculate_k=SPEC_K``, a host
    tier, ``max_queue_depth=8``): a primed idle prefix, 8 staggered
    speculative requests, then LADDER_QUEUE queued ones push the ladder to
    level 2. Returns its record and whether every check passed."""
    cfg, rng = model.cfg, np.random.default_rng(SEED + 11)
    prime = spec_prompts(rng, (LADDER_PRIME,), cfg.vocab_size)[0]
    # a pattern each, so that no request hits another's pages
    runs, queued_prompts = ([spec_prompts(rng, (n,), cfg.vocab_size)[0]
                             for n in lens]
                            for lens in (LADDER_LENS, (48,) * LADDER_QUEUE))
    eng = DecodeEngine(model, EngineConfig(
        page_size=PS, max_slots=8, max_queue_depth=8, speculate_k=SPEC_K,
        kv_host_tier_bytes=PREFIX_HOST_TIER, inflight=2), device=dev)
    warm(eng, (LADDER_PRIME, 48) + LADDER_LENS)
    counters0 = dict(eng.counters)
    reset_launches()                       # the ladder path's run
    serve(eng, [prime], 4)                 # its pages stay, idle, indexed
    prime_hashes = [h.hex() for h in prompt_page_hashes(prime, PS)]
    rec = {"primed_pages_indexed": sum(h in eng.prefix_hashes()
                                       for h in prime_hashes)}
    reqs = [eng.submit(p, 24 + 8 * i) for i, p in enumerate(runs)]
    eng.step()                             # all eight admitted
    drafted = [eng.counters["spec_drafted"]]
    reqs += [eng.submit(p, 2) for p in queued_prompts]
    levels = []
    more = True
    while more:
        more = eng.step()
        levels.append(eng.gauges["degradation_level"])
        drafted.append(eng.counters["spec_drafted"])
        if len(levels) == 1:
            rec["after_first_queued_step"] = {
                "level": levels[0],
                "primed_pages_indexed": sum(
                    h in eng.prefix_hashes() for h in prime_hashes),
                "primed_pages_in_host_tier": sum(
                    h in eng.tier_hashes() for h in prime_hashes)}
    launches, expected, ran = engine_launches(eng, counters0,
                                              "serve_lifecycle:ladder")
    frozen = all(now == prev for lvl, prev, now in
                 zip(levels, drafted, drafted[1:]) if lvl >= 1)
    outs = [r.result(timeout=0) for r in reqs]
    rec.update(levels=levels, drafted_frozen_from_level_1=frozen,
               drafted_while_level_0=drafted[-1] - drafted[0],
               counters={k: eng.counters[k] - counters0[k] for k in (
                   "spec_drafted", "prefix_evictions",
                   "prefix_evictions_demoted", "kvtier_spills_host")},
               free_pages=eng.allocator.free_pages,
               pool_pages=eng.allocator.num_pages - 1,
               launches=launches, expected_launches=expected)
    after = rec["after_first_queued_step"]
    n_prime = len(prime_hashes)
    ok = (rec["primed_pages_indexed"] == n_prime and after["level"] == 2
          and after["primed_pages_indexed"] == 0
          and after["primed_pages_in_host_tier"] == n_prime
          and rec["counters"]["prefix_evictions_demoted"] >= n_prime
          and frozen and levels[-1] == 0 and 1 in levels
          and rec["free_pages"] == rec["pool_pages"]
          and all(o.shape == (len(r.prompt) + r.max_new_tokens,)
                  for o, r in zip(outs, reqs)))
    del eng
    return rec, ok


def serve_lifecycle(model, dev, smi):
    """The request lifecycle on the card, bf16 at full width, two engines
    with the default readback window (``inflight=2``), every outcome held
    exactly. Engine A (`lifecycle_admission`): 8 requests fill the slots,
    8 more the queue (``max_queue_depth=8``), the 17th is shed with
    ``Overloaded``; two queued requests are cancelled (they never
    prefill: ``prefill_tokens`` is the admitted prompts' tokens less the
    pages the prefix cache reused), one running request that shares 4
    prefix pages with another is cancelled mid-decode and its slot goes
    to the next queued request, a request with a 0.05 s deadline meets an
    injected 0.1 s step delay (``DeadlineExceeded``, 0 tokens), a keyed
    request is resubmitted in flight (the same request) and after it
    finished (replayed); the pool ends at its baseline and the survivors'
    tokens equal an undisturbed engine's (margin-gated as
    `serve_bf16_parity`). Engine B (`lifecycle_ladder`): speculative with
    a host tier; a queue at 6/8 puts the ladder at level 2, which drops
    the idle primed prefix pages into the host tier, drafting stops from
    level 1 on, and the level falls back to 0 as the queue drains."""
    card_params = {k: v.detach().to(dev) for k, v in
                   model.state_dict().items()}
    admission, ok_a = lifecycle_admission(model, dev, card_params)
    ladder, ok_b = lifecycle_ladder(model, dev)
    emit({"phase": "serve_lifecycle", "model": "gpt2-small",
          "dtype": "bfloat16", "card": smi, "inflight": 2,
          "admission": admission, "ladder": ladder,
          "ok": bool(ok_a and ok_b)})
    torch.cuda.empty_cache()
    if not (ok_a and ok_b):
        raise SystemExit("serve_lifecycle: an outcome differs from the "
                         "expected one")


# serve_observe: the 9th prompt's length, whose prefill bucket (128) no
# SERVE_LENS prompt uses, so its graph is captured inside the loop; the
# watchdog deadlines of the healthy and the stalled loop, and the stall
OBSERVE_UNWARMED = 100
OBSERVE_DEADLINE_S = 30.0
STALL_DEADLINE_S = 0.5
STALL_DELAY_S = 2.0
REQUEST_SPANS = ("request.queue", "request.prefill", "request.decode",
                 "request.e2e")

# the Prometheus text exposition grammar (format 0.0.4) of the JAX
# package's tests/test_tracing.py::check_exposition, which this script
# cannot import (it loads JAX)
_PROM_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_PROM_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\\\|\\"|\\n)*"'
_PROM_VALUE = r"(?:[+-]?(?:\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|Inf)|NaN)"
PROM_SAMPLE = re.compile(rf"^{_PROM_NAME}(?:\{{{_PROM_LABEL}"
                         rf"(?:,{_PROM_LABEL})*\}})? {_PROM_VALUE}$")
PROM_TYPE = re.compile(
    rf"^# TYPE {_PROM_NAME} (?:counter|gauge|summary|histogram|untyped)$")


def exposition_ok(text):
    """Every line within the exposition grammar, every sample under its
    one ``# TYPE`` (a summary's ``_sum`` / ``_count`` too)."""
    typed, current = {}, None
    if not text.endswith("\n"):
        return False
    for line in text.splitlines():
        if line.startswith("#"):
            if not PROM_TYPE.match(line):
                return False
            name, kind = line.split()[2:4]
            if name in typed:
                return False
            typed[name], current = kind, name
            continue
        if not PROM_SAMPLE.match(line):
            return False
        base = re.match(_PROM_NAME, line).group(0)
        allowed = (current, current + "_sum", current + "_count") \
            if typed.get(current) == "summary" else (current,)
        if base not in allowed:
            return False
    return bool(typed)


# the histograms whose summed seconds `serve_observe` reports a loop:
# where its wall went (inside steps, inside the graph capture, blocked on
# readbacks)
TIMED_TOTALS = ("engine.step_seconds", "engine.compile_seconds",
                "engine.device_ms", "engine.host_ms")


class Observed:
    """What the port's observability layer records over one serving run:
    the ``engine.*`` counter deltas and histogram count deltas of the
    metrics registry (and the summed values of TIMED_TOTALS), the flight
    events and the usage records since it began."""

    def __init__(self):
        snap = metrics.snapshot()
        self.counters0 = snap["counters"]
        self.hists0 = {k: v["count"] for k, v in snap["histograms"].items()}
        self.totals0 = {k: snap["histograms"].get(k, {}).get("total", 0.0)
                        for k in TIMED_TOTALS}
        evs = flight.events()
        self.seq0 = evs[-1]["seq"] if evs else 0
        self.used0 = usage_log.emitted

    def read(self, reqs):
        snap = metrics.snapshot()
        ids = {r.request_id: i for i, r in enumerate(reqs)}
        counters = {k: v - self.counters0.get(k, 0)
                    for k, v in snap["counters"].items()
                    if k.startswith(("engine.", "usage.", "serve."))
                    and v != self.counters0.get(k, 0)}
        hists = {k: v["count"] - self.hists0.get(k, 0)
                 for k, v in snap["histograms"].items()
                 if v["count"] != self.hists0.get(k, 0)}
        events = [e for e in flight.events() if e["seq"] > self.seq0]
        n = usage_log.emitted - self.used0
        usage = sorted(
            ({k: (v if k not in ("t", "queue_wait_s", "ttft_s", "e2e_s")
                  else v is None) for k, v in r.items()
              if k != "request_id"} | {"request": ids.get(r["request_id"])}
             for r in (usage_log.records()[-n:] if n else ())),
            key=lambda r: r["request"])
        spans = {i: [] for i in range(len(reqs))}
        for e in metrics.chrome_trace()["traceEvents"]:
            i = ids.get((e.get("args") or {}).get("request_id"))
            if i is not None:
                spans[i].append(e["name"])
        totals = {k: snap["histograms"].get(k, {}).get("total", 0.0)
                  - self.totals0[k] for k in TIMED_TOTALS}
        return {"counters": counters, "histograms": hists, "events": events,
                "usage": usage, "spans": spans, "totals": totals}


def observe_run(eng, prompts, n, loop, phase):
    """Serve ``prompts`` (``n`` new tokens each, a `RequestTrace` each)
    on ``eng``, with every kernel's launch count set to 0 just before and
    held just after: through `run_until_idle` here, or (``loop``) through
    `serve_loop` on a thread of its own, every request submitted from
    this thread, all but the last before the loop takes its first step
    and the last while it runs (it queues behind 8 busy slots, so both
    loops take the same steps). Returns the outputs, what the
    observability layer recorded, the launches, the engine's counter
    deltas and the seconds from the first submit to the last result."""
    counters0 = dict(eng.counters)
    torch.cuda.synchronize()
    reset_launches()                       # the path's run
    seen = Observed()
    t0 = time.perf_counter()
    if loop:
        stop, go = threading.Event(), threading.Event()

        def drive():
            go.wait()
            eng.serve_loop(stop)
        thread = threading.Thread(target=drive, name="serve-loop")
        thread.start()
        try:
            reqs = [eng.submit(p, n, RequestTrace()) for p in prompts[:-1]]
            go.set()
            reqs.append(eng.submit(prompts[-1], n, RequestTrace()))
            outs = [r.result(timeout=300) for r in reqs]
            wall = time.perf_counter() - t0
        finally:
            stop.set()
            thread.join(timeout=300)
        if thread.is_alive():
            raise SystemExit(f"{phase}: serve_loop did not stop")
    else:
        reqs = [eng.submit(p, n, RequestTrace()) for p in prompts]
        eng.run_until_idle(max_steps=10_000)
        outs = [r.result(timeout=0) for r in reqs]
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches, expected, ran = engine_launches(eng, counters0, phase)
    return outs, seen.read(reqs), launches, ran, wall


def observe_stall(model, dev, prompts, dump_dir):
    """A warm engine's `serve_loop` under a watchdog of STALL_DEADLINE_S
    while one step sleeps STALL_DELAY_S (the ``engine.step_delay`` fault):
    exactly one dump, holding the flight ring, the stalled requests'
    traces and the metrics snapshot. Returns the dump's summary."""
    eng, _, _ = serve_engine(model, dev, inflight=2)
    os.environ["PADDLE_WATCHDOG_S"] = str(STALL_DEADLINE_S)
    stop = threading.Event()
    thread = threading.Thread(target=eng.serve_loop, args=(stop,),
                              name="serve-loop-stall")
    thread.start()
    try:
        with faults.scoped("engine.step_delay", delay_s=STALL_DELAY_S,
                           times=1):
            reqs = [eng.submit(p, 8, RequestTrace()) for p in prompts[:2]]
            outs = [r.result(timeout=300) for r in reqs]
    finally:
        stop.set()
        thread.join(timeout=300)
    dumps = sorted(glob.glob(os.path.join(dump_dir,
                                          "watchdog_engine_*.json")))
    payloads = [json.load(open(p)) for p in dumps]
    ids = {r.request_id for r in reqs}
    return {"dumps": len(dumps),
            "stalled_for_s": [p["stalled_for_s"] for p in payloads],
            "events": [len(p["events"]) for p in payloads],
            "event_kinds": sorted({e["kind"] for p in payloads
                                   for e in p["events"]}),
            "stalled_traces": [sorted(t["phase"] for t in p["traces"]
                                      if t["request_id"] in ids)
                               for p in payloads],
            "metrics_keys": [sorted(p["metrics"]) for p in payloads],
            "outputs_ok": all(o.shape == (len(p) + 8,)
                              for o, p in zip(outs, prompts))}


def serve_observe(model, dev, smi, serve_outs):
    """The observability layer on the card (bf16, full width, ``inflight``
    2): `serve`'s 8 prompts and a 9th of OBSERVE_UNWARMED tokens, 32 new
    tokens each, a `RequestTrace` each. Engine B runs them through
    `run_until_idle`; engine A through `serve_loop` on a thread of its
    own under its watchdog, every request submitted from this thread, the
    9th's prefill graph captured inside the loop. Held: the 8 outputs
    equal `serve`'s, A's 9 equal B's, the ``engine.*`` / ``usage.*`` /
    ``serve.*`` counter deltas and the usage records (all but the times)
    equal between the two loops, every request's four ``request.*`` spans,
    one ``engine.device_ms`` (and ``host_ms``, ``step_seconds``)
    observation a step that did work, `render()` within the exposition
    grammar, no dump from the healthy loop, and exactly one, holding the
    ring, the stalled traces and the snapshot, from a loop whose step
    sleeps past a 0.5 s deadline."""
    phase = "serve_observe"
    rng = np.random.default_rng(SEED + 11)
    dump_dir = tempfile.mkdtemp(prefix="serve_observe_")
    saved = {k: os.environ.get(k) for k in ("PADDLE_WATCHDOG_S",
                                            "PADDLE_WATCHDOG_DIR")}
    os.environ["PADDLE_WATCHDOG_DIR"] = dump_dir
    os.environ["PADDLE_WATCHDOG_S"] = str(OBSERVE_DEADLINE_S)
    try:
        runs = {}
        for name, loop in (("run_until_idle", False), ("serve_loop", True)):
            eng, prompts, _ = serve_engine(model, dev, inflight=2)
            extra = rng.integers(0, min(VOCAB, model.cfg.vocab_size),
                                 OBSERVE_UNWARMED).astype(np.int32) \
                if not runs else runs["run_until_idle"]["extra"]
            outs, seen, launches, ran, wall = observe_run(
                eng, prompts + [extra], 32, loop, f"{phase}:{name}")
            runs[name] = {"outs": outs, "seen": seen, "launches": launches,
                          "ran": ran, "wall": wall, "extra": extra}
            del eng
        healthy_dumps = len(os.listdir(dump_dir))
        stall = observe_stall(model, dev, prompts, dump_dir)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(dump_dir, ignore_errors=True)
    a, b = runs["serve_loop"], runs["run_until_idle"]
    sa, sb = a["seen"], b["seen"]
    steps = [e for e in sa["events"] if e["kind"] == "engine.step"]
    worked = sa["histograms"].get("engine.device_ms", 0)
    text = metrics.to_prometheus()
    checks = {
        "tokens_equal_serve": all(np.array_equal(o, r) for o, r in
                                  zip(a["outs"][:8], serve_outs)),
        "tokens_equal_run_until_idle": all(
            np.array_equal(x, y) for x, y in zip(a["outs"], b["outs"])),
        "counters_equal": sa["counters"] == sb["counters"],
        "usage_equal": sa["usage"] == sb["usage"] and len(sa["usage"]) == 9,
        "spans_ok": all(sorted(set(v)) == sorted(REQUEST_SPANS)
                        for s in (sa, sb) for v in s["spans"].values()),
        "histogram_counts_equal": sa["histograms"] == sb["histograms"],
        "device_ms_per_step": worked == len(steps) > 0
        and sa["histograms"].get("engine.host_ms") == worked
        and sa["histograms"].get("engine.step_seconds") == worked,
        "capture_in_loop": a["ran"]["compile_count"] == 1
        and sa["histograms"].get("engine.compile_seconds") == 1,
        "exposition_ok": exposition_ok(text),
        "healthy_dumps_zero": healthy_dumps == 0,
        "stall_dumped_once": stall["dumps"] == 1
        and stall["stalled_traces"][0] != []
        and {"counters", "gauges", "histograms"} <=
        set(stall["metrics_keys"][0])
        and "engine.step" in stall["event_kinds"],
        "launches_exact": a["launches"] == b["launches"]}
    ok = all(checks.values()) and stall["outputs_ok"]
    emit({"phase": phase, "model": "gpt2-small", "dtype": "bfloat16",
          "card": smi, "inflight": 2, "requests": 9,
          "prompt_lens": list(SERVE_LENS) + [OBSERVE_UNWARMED],
          "max_new_tokens": 32, **checks,
          "counters": {k: sa["counters"][k] for k in sorted(sa["counters"])
                       if k.startswith("engine.")},
          "histogram_counts": {"serve_loop": sa["histograms"],
                               "run_until_idle": sb["histograms"]},
          "worked_steps": worked, "flight_events": len(sa["events"]),
          "wall_s": {"serve_loop": a["wall"], "run_until_idle": b["wall"]},
          "timed_totals": {"serve_loop": sa["totals"],
                           "run_until_idle": sb["totals"]},
          "launches": a["launches"], "stall": stall,
          "exposition_lines": text.count("\n"), "ok": ok})
    if not ok:
        raise SystemExit(f"{phase}: a check failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    torch.cuda.empty_cache()


# the serve_graph phase's engines a dtype: (name, EngineConfig keywords);
# the float32 run adds an int8-KV engine, the bfloat16 run int8 KV with
# int8 weights (serve_int8's engine)
GRAPH_ARMS = {
    torch.float32: (("greedy", {}), ("sampled", {"sampling": True}),
                    ("speculative", {"sampling": True,
                                     "speculate_k": SPEC_K}),
                    ("int8_kv", {"kv_dtype": "int8"})),
    torch.bfloat16: (("greedy", {}), ("sampled", {"sampling": True}),
                     ("speculative", {"speculate_k": SPEC_K}),
                     ("int8", {"kv_dtype": "int8", "weight_dtype": "int8"}),
                     ("int8_sampled_speculative", {
                         "kv_dtype": "int8", "weight_dtype": "int8",
                         "sampling": True, "speculate_k": SPEC_K})),
}
GRAPH_LENS = (5, 16, 33, 64, 100, 129, 200, 250)   # one prompt a slot
GRAPH_CHUNK_START = 96                             # a 154-token tail


def graph_vs_eager(eng, graph, eager):
    """A `check_step_graph` or `check_prefill_graph` pair held: tokens and
    key chains equal, every pool page but the trash page equal (page 0,
    where masked writes such as a verify step's padding drafts collide in
    an unspecified order, is reported, not held), and the logits within
    the serve bound of the engine's dtype (the gap is printed; 0 is
    expected: the same kernels on the same inputs). Returns (line, ok)."""
    tokens_equal = torch.equal(graph["tokens"], eager["tokens"])
    keys_equal = graph["keys"] is None or torch.equal(graph["keys"],
                                                      eager["keys"])
    # every pool, scale pools included, is [nl, pages, ...]
    pool_diff = [int((a[:, 1:] != b[:, 1:]).sum())
                 for a, b in zip(graph["pools"], eager["pools"])]
    trash_diff = [int((a[:, 0] != b[:, 0]).sum())
                  for a, b in zip(graph["pools"], eager["pools"])]
    line = {"tokens_equal": tokens_equal, "keys_equal": keys_equal,
            "pool_values_differ": pool_diff,
            "trash_page_values_differ": trash_diff}
    ok = tokens_equal and keys_equal and not any(pool_diff)
    if graph["logits"] is not None:
        bound = (bf16_logit_bound(eager["logits"])
                 if eng._cdtype == torch.bfloat16 else
                 INT8_LOGIT_BOUND if eng._quant_kv else LOGIT_BOUND)
        diff = float((graph["logits"] - eager["logits"]).abs().max())
        line.update(logit_max_abs_diff=diff, logit_bound=bound)
        ok &= diff <= bound
    return line, ok


def serve_graph(model, other, dev):
    """The captured step programs against their eager bodies, at full
    width (B=8), for each engine of GRAPH_ARMS[the model's dtype]: 8
    requests (GRAPH_LENS prompts, SAMPLED_PARAMS on a sampling engine) are
    admitted and decoded for two steps; then `check_step_graph` runs the
    next decode (or verify) step from one state through the graph and
    through the eager body, and `check_prefill_graph` a one-shot prefill
    and a chunk (``prefill`` and ``chunk``, with SAMPLED_PARAMS[0] on a
    sampling engine), each held by `graph_vs_eager`. Then
    `refresh_params(other)` copies the second model's weights into the
    engine: the weights keep their addresses, nothing is recaptured, and
    the replayed steps' tokens for the 8 prompts must equal a fresh
    engine's on ``other``."""
    dtype = model.gpt.wte.weight.dtype
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(0, min(VOCAB, cfg.vocab_size), n)
               .astype(np.int32) for n in GRAPH_LENS]
    for arm, kw in GRAPH_ARMS[dtype]:
        ecfg = EngineConfig(page_size=PS, max_slots=8, prefix_cache=False,
                            inflight=1, **kw)
        params = SAMPLED_PARAMS if ecfg.sampling \
            else [(1.0, 0, 0)] * len(prompts)
        eng = DecodeEngine(model, ecfg, device=dev)
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        reqs = [eng.submit(p, max_new_tokens=8, temperature=t, top_k=k,
                           seed=sd)
                for p, (t, k, sd) in zip(prompts, params)]
        eng.step()
        eng.step()
        line, ok = graph_vs_eager(eng, *eng.check_step_graph())
        # the prefill and chunk programs from one state, while the 8 slots
        # are live: a one-shot prefill of GRAPH_LENS[-1] tokens (bucket
        # 256) and its tail from GRAPH_CHUNK_START (the chunk program at
        # the tail's bucket, as a prefix hit runs it)
        sample = dict(zip(("temperature", "top_k", "seed"),
                          SAMPLED_PARAMS[0])) if ecfg.sampling else {}
        for name, start in (("prefill", 0), ("chunk", GRAPH_CHUNK_START)):
            line[name], arm_ok = graph_vs_eager(
                eng, *eng.check_prefill_graph(prompts[-1], start, **sample))
            key = ("prefill", 256, eng._impl) if not start else \
                ("prefill_chunk", 256, eng._impl)
            line[name]["replays"] = eng._programs[key].graph.replays
            ok &= arm_ok
        eng.run_until_idle(max_steps=1000)
        ok &= all(r.done for r in reqs)

        def serve_new(engine):
            return serve(engine, prompts, 8, params)

        ptrs = {k: getattr(v, "q", v).data_ptr()
                for k, v in eng._params.items()}
        compiles = eng.counters["compile_count"]
        before = serve_new(eng)
        eng.refresh_params(other)
        after = serve_new(eng)
        kept = ptrs == {k: getattr(v, "q", v).data_ptr()
                        for k, v in eng._params.items()}
        key = ("verify", SPEC_K) if eng._spec else ("decode", eng._impl)
        replays = getattr(eng._programs[key], "replays", None)
        fresh_eng = DecodeEngine(other, ecfg, device=dev)
        fresh = serve_new(fresh_eng)
        refresh_equal = [bool(np.array_equal(a, b))
                         for a, b in zip(after, fresh)]
        moved = sum(not np.array_equal(a, b) for a, b in zip(before, after))
        recaptured = eng.counters["compile_count"] - compiles
        ok &= (all(refresh_equal) and kept and moved > 0 and not recaptured
               and (replays is not None or eng.device.type != "cuda"))
        emit({"phase": "serve_graph", "arm": arm, "model": "gpt2-small",
              "dtype": dtype_name(dtype), "kv_dtype": ecfg.kv_dtype,
              "weight_dtype": ecfg.weight_dtype, "sampling": ecfg.sampling,
              "speculate_k": ecfg.speculate_k, "slots": ecfg.max_slots,
              "program": list(key), "capture_s": capture_s,
              "replays": replays, **line,
              "refresh_weights_kept_addresses": kept,
              "refresh_recaptured": recaptured,
              "refresh_tokens_equal_fresh_engine": refresh_equal,
              "refresh_requests_changed": moved, "ok": ok})
        if not ok:
            raise SystemExit(f"serve_graph {arm}: the captured step and the "
                             "eager step disagree, or the refreshed graph "
                             "did not follow the new weights")
        del eng, fresh_eng
        torch.cuda.empty_cache()


def train_batch(rng, b, s, vocab):
    ids = rng.integers(0, vocab, (b, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def first_grads(step, x, y):
    """{leaf: f32 gradient, on the CPU} of a step's first gradient pass,
    at its initial weights and before any update."""
    m = step.microbatches
    xs, ys = (torch.as_tensor(t).to(step.device).reshape(m, -1, t.shape[-1])
              for t in (x, y))
    _, grads = step._grads(xs, ys)
    return {f"{grp}.{k}": g.cpu()
            for (grp, k), g in zip(_leaf_keys(step._params), grads)}


def train_launches(cfg, microbatches, steps):
    """The kernel launches ``steps`` train steps of ``cfg`` make: each flash
    kernel once per layer per microbatch (``flash_fwd`` twice under
    ``recompute``, whose backward reruns each block); with hidden dropout
    the embedding's and every layer's two masks forward and backward, and
    the layers' masks once more under ``recompute``."""
    nl, runs = cfg.num_layers, microbatches * steps
    want = {"flash_fwd": nl * runs * (2 if cfg.recompute else 1),
            "flash_dq": nl * runs, "flash_dkv": nl * runs}
    if cfg.hidden_dropout:
        want["dropout"] = runs * (2 * (1 + 2 * nl)
                                  + (2 * nl if cfg.recompute else 0))
    return want


def train_parity(dev, smi, dtype=torch.float32, hidden_dropout=0.0):
    """Train steps of a 2-layer GPT-2-small-width model on the card and on
    the CPU, from the same weights and batch: ``train_parity`` in float32
    (the first step's gradients within TRAIN_GRAD_TOL, losses within
    TRAIN_LOSS_TOL), ``train_bf16_parity`` in bfloat16 with float32
    masters, which holds the bf16 tensor-core flash forward, dQ and dK/dV
    loops end to end: the first step's gradients within
    TRAIN_BF16_GRAD_TOL, each step's losses within TRAIN_BF16_LOSS_TOL.
    With ``hidden_dropout`` (``train_dropout_parity``,
    ``train_dropout_bf16_parity``) both sides draw the same masks from the
    steps' key chains (seed 0), the card's through the dropout kernel."""
    bf16 = dtype == torch.bfloat16
    phase = "train_" + ("dropout_" if hidden_dropout else "") + \
        ("bf16_parity" if bf16 else "parity")
    cfg = dict(num_layers=2, hidden_dropout=hidden_dropout,
               attention_dropout=0.0)
    x, y = train_batch(np.random.default_rng(SEED + 3), 4, 256, VOCAB)
    losses, grads, launches = {}, {}, None
    for where in (dev, "cpu"):
        model = gpt_mod.gpt2_small(
            generator=torch.Generator().manual_seed(SEED), **cfg).to(dtype)
        step = ScanTrainStep(model, AdamW(learning_rate=1e-3, clip_norm=1.0),
                             microbatches=2, device=where)
        grads[str(where)] = first_grads(step, x, y)
        t0 = time.perf_counter()
        if where == dev:
            reset_launches()               # the train path's run
            registry.reset_counts()
        losses[str(where)] = [step.step(x, y) for _ in range(3)]
        if where == dev:
            expected = train_launches(model.cfg, 2, 3)
            launches = read_launches(phase, expected)
            dispatch = registry.counts()
            card_s = time.perf_counter() - t0
    card, cpu = losses[str(dev)], losses["cpu"]
    diffs = [abs(a - c) for a, c in zip(card, cpu)]
    tol = TRAIN_BF16_LOSS_TOL if bf16 else TRAIN_LOSS_TOL
    rel = {n: ((g - grads["cpu"][n]).norm() / grads["cpu"][n].norm()).item()
           for n, g in grads[str(dev)].items()}
    worst = max(rel, key=rel.get)
    grad_tol = TRAIN_BF16_GRAD_TOL if bf16 else TRAIN_GRAD_TOL
    want_dispatch = {"kernel.dispatch.flash_attention.cuda": 12}
    if hidden_dropout:
        want_dispatch["kernel.dispatch.fused_dropout.cuda"] = \
            expected["dropout"]
    ok = max(diffs) <= tol and rel[worst] <= grad_tol and \
        dispatch == want_dispatch
    emit({"phase": phase, "model": "gpt2-small width, 2 layers",
          "card": smi, "dtype": dtype_name(dtype),
          "master_weights": "float32" if bf16 else None,
          "hidden_dropout": hidden_dropout,
          "flash_fwd_arm": cfa.arm(dtype, DH),
          "batch": 4, "microbatches": 2, "seq": 256,
          "steps": 3, "card_losses": card, "cpu_losses": cpu,
          "loss_max_abs_diff": max(diffs), "loss_abs_diff": diffs,
          "tol": tol, "grad_rel_l2_max": rel[worst], "grad_rel_l2_leaf": worst,
          "grad_rel_l2": rel, "grad_tol": grad_tol,
          "launches": launches, "dispatch": dispatch,
          "expected_dispatch": want_dispatch,
          "card_seconds": card_s, "ok": ok})
    if not ok:
        raise SystemExit(f"{phase}: card and CPU train steps disagree")


def train_run(dev, smi, phase="train", warmup=2, timed=8, **over):
    """GPT-2 small in bf16 with f32 masters: warm-up steps, then timed
    steps on one fixed batch. ``over`` overrides config fields (``train``
    trains without dropout, ``train_dropout`` with the config's 0.1).
    Returns the phase's line."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dict(dict(hidden_dropout=0.0, attention_dropout=0.0), **over)
    model = gpt_mod.gpt2_small(generator=torch.Generator().manual_seed(SEED),
                               **cfg)
    model = model.to(torch.bfloat16)
    step = ScanTrainStep(model, AdamW(learning_rate=1e-4, clip_norm=1.0),
                         microbatches=2, device=dev)
    x, y = train_batch(np.random.default_rng(SEED + 4), 16, 1024, VOCAB)
    torch.cuda.reset_peak_memory_stats(dev)
    steps0 = metrics.counter("train.steps").value
    dump_dir = tempfile.mkdtemp(prefix=f"{phase}_watchdog_")
    watchdog = step.start_watchdog(deadline_s=OBSERVE_DEADLINE_S,
                                   dump_dir=dump_dir)
    try:
        losses = [step.step(x, y) for _ in range(warmup)]
        reset_launches()                   # the train path's timed run
        losses += [step.step(x, y) for _ in range(timed)]
    finally:
        watchdog.stop()
    expected = train_launches(model.cfg, 2, timed)
    launches = read_launches(phase, expected)
    # the train step's series: its MFU gauge is its last record's, every
    # step counted, and the healthy loop left no dump
    observed = {
        "train_mfu_gauge": metrics.gauge("train.mfu").value,
        "train_mfu_equals_record": metrics.gauge("train.mfu").value
        == step.records[-1]["mfu"],
        "train_steps_counted": metrics.counter("train.steps").value - steps0,
        "watchdog_dumps": watchdog.dump_count + len(os.listdir(dump_dir))}
    shutil.rmtree(dump_dir, ignore_errors=True)
    recs = step.records[warmup:]
    step_ms = statistics.median(r["step_ms"] for r in recs)
    tokens = x.size
    flops = gpt_mod.analytic_flops_per_token(model.cfg, x.shape[1]) * tokens
    ok = bool(np.isfinite(losses).all()) and losses[-1] < losses[0] \
        and step.bad_steps == 0 and observed["train_mfu_equals_record"] \
        and observed["train_steps_counted"] == warmup + timed \
        and observed["watchdog_dumps"] == 0
    line = {"phase": phase, "model": "gpt2-small", "dtype": "bfloat16",
            "master_weights": "float32", "card": smi,
            "hidden_dropout": model.cfg.hidden_dropout,
            "recompute": model.cfg.recompute,
            "recompute_granularity": model.cfg.recompute_granularity,
            "batch": 16, "microbatches": 2, "seq": 1024,
            "tokens_per_step": tokens, "warmup_steps": warmup,
            "timed_steps": timed, "step_ms_p50": step_ms,
            "step_ms": [r["step_ms"] for r in recs],
            "tokens_per_s": tokens / (step_ms / 1e3),
            "mfu": flops / (step_ms / 1e3 * H100_BF16_PEAK),
            "flops_per_step": flops,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "losses": losses, "launches": launches,
            "expected_launches": expected, **observed, "ok": ok}
    if model.cfg.hidden_dropout:
        line["dropout_launches_per_step"] = launches["dropout"] / timed
    emit(line)
    if not ok:
        raise SystemExit(f"{phase}: losses {losses} not finite and "
                         f"falling, or the train series off: {observed}")
    return line


def fc_out_product_ms(dev, timer, b=8, s=1024):
    """One microbatch's fc_out product, ``up @ W + b`` at [8, 1024, 3072] x
    [3072, 768] in bf16: what the "mlp" and "mlp_up" recompute settings
    rerun per layer beyond what JAX's remat policy reruns."""
    rng = np.random.default_rng(SEED + 11)
    up, w, bias = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, torch.bfloat16)
        for shape in ((b, s, FFN), (FFN, D_MODEL), (D_MODEL,)))
    return timer.ms(lambda: up @ w + bias)


def train_recompute(dev, smi, plain):
    """The ``train_dropout`` run once under each recompute setting
    (RECOMPUTE_ARMS), against ``plain``, that run's line without recompute:
    full-block recompute must lower the peak memory and no arm may raise
    it; the losses must stay those of the run without recompute (the same
    ops on the same inputs)."""
    arms = {}
    for name, over in RECOMPUTE_ARMS:
        line = train_run(dev, smi, f"train_recompute_{name}",
                         hidden_dropout=DROPOUT_P, **over)
        diff = max(abs(a - b) for a, b in zip(line["losses"],
                                              plain["losses"]))
        arms[name] = {"step_ms_p50": line["step_ms_p50"],
                      "peak_memory_bytes": line["peak_memory_bytes"],
                      "launches": line["launches"],
                      "loss_max_abs_diff_vs_plain": diff}
    timer = Timer(dev)
    product_ms = fc_out_product_ms(dev, timer)
    del timer
    nl = gpt_mod.GPTConfig().num_layers
    peak = plain["peak_memory_bytes"]
    ok = arms["full_block"]["peak_memory_bytes"] < peak and all(
        a["peak_memory_bytes"] <= peak and
        a["loss_max_abs_diff_vs_plain"] <= TRAIN_BF16_LOSS_TOL
        for a in arms.values())
    emit({"phase": "train_recompute", "card": smi, "dtype": "bfloat16",
          "hidden_dropout": DROPOUT_P,
          "no_recompute": {"step_ms_p50": plain["step_ms_p50"],
                           "peak_memory_bytes": peak},
          "arms": arms,
          "fc_out_product_ms": product_ms,
          "fc_out_recompute_ms_per_step": product_ms * nl * 2,
          "loss_tol": TRAIN_BF16_LOSS_TOL, "ok": ok})
    if not ok:
        raise SystemExit("train_recompute: a recompute setting raised the "
                         "peak memory, full-block recompute did not lower "
                         "it, or the losses moved")


def check_dropout(dev, timer, smi, dtype, shape=DROPOUT_SHAPE):
    """The dropout kernel against its plain version at a microbatch's
    hidden states: zero mismatched mask bits, bit-equal outputs, and the op's
    gradient (the kernel on the incoming gradient) bit-equal to the plain
    version's; timed beside `F.dropout`, another RNG (not a yardstick of
    the same function: no PyTorch call draws threefry masks)."""
    rng = np.random.default_rng(SEED + 10)
    x, g = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, dtype) for _ in "xg")
    key = prng.split(prng.prng_key(SEED + 10, dev), 2)[1]
    p = DROPOUT_P
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    got = cdrop.dropout(x, key, p)
    ref = tdrop._plain_dropout(x, key, p)
    mask = cdrop.dropout(torch.ones_like(x), key, p) != 0
    want_mask = prng.bernoulli(key, 1.0 - p, shape)
    xg = x.detach().requires_grad_(True)
    tdrop.hidden_dropout(xg, key, p).backward(g)
    torch.cuda.synchronize()
    mismatched = int((mask != want_mask).sum().item())
    out_equal = torch.equal(got.view(ints), ref.view(ints))
    grad_equal = torch.equal(xg.grad.view(ints),
                             tdrop._plain_dropout(g, key, p).view(ints))
    n = x.numel()
    nbytes = 2 * n * x.element_size()
    ops = cdrop.INT_OPS_PER_ELEMENT * n
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_INT32_OPS * 1e3
    ok = mismatched == 0 and out_equal and grad_equal
    line = {
        "phase": "kernel", "kernel": "dropout", "dtype": dtype_name(dtype),
        "card": smi, "shape": list(shape), "p": p,
        "kept_share": mask.float().mean().item(),
        "mask_bits_mismatched": mismatched, "outputs_bit_equal": out_equal,
        "grads_bit_equal": grad_equal, "within_tol": ok,
        "max_abs_err": max_err(got, ref), "tol": 0.0,
        "kernel_ms": timer.ms(lambda: cdrop.dropout(x, key, p)),
        "plain_ms": timer.ms(lambda: tdrop._plain_dropout(x, key, p)),
        "library_ms": None, "library": None,
        "other_rng_F_dropout_ms": timer.ms(
            lambda: F.dropout(x, p, training=True)),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "bytes": nbytes, "int_ops": ops,
        "int_ops_per_element": cdrop.INT_OPS_PER_ELEMENT,
        "peak_int32_ops_per_s": PEAK_INT32_OPS}
    emit(line)
    if not ok:
        raise SystemExit(f"dropout {dtype}: {mismatched} mask bits differ, "
                         f"outputs equal {out_equal}, grads equal "
                         f"{grad_equal}")
    return line


def rel_tol(ref, tol):
    """``tol`` times the largest reference value when that exceeds 1."""
    return tol * max(1.0, ref.float().abs().max().item())


def max_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def check_layernorm(dev, timer, dtype, n=8 * 1024, d=D_MODEL):
    """The two fused layernorm kernels against their plain versions at the
    incubate path's rows, timed beside PyTorch's layernorm forward and
    backward; one ``kernel`` line per kernel."""
    rng = np.random.default_rng(SEED + 5)

    def rand(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dt)
    x, dy = rand(n, d), rand(n, d)
    gamma, beta = rand(d, dt=torch.float32), rand(d, dt=torch.float32)
    eps, rpb = 1e-5, cln.ROWS_PER_BLOCK
    y, mu, rstd = cln.fused_layernorm_fwd(x, gamma, beta, eps)
    dx, dgp, dbp = cln.fused_layernorm_bwd(x, gamma, mu, rstd, dy)
    torch.cuda.synchronize()
    ry, rmu, rrs = tfl._plain_ln_fwd(x, gamma, beta, eps)
    rdx, rdg, rdb = tfl._plain_ln_bwd(x, gamma, mu, rstd, dy, rpb)
    checks = {
        "fused_layernorm_fwd": [
            (y, ry, flash_tol(dtype, ry, INCUBATE_TOL["ln_fwd"])),
            (mu, rmu, rel_tol(rmu, INCUBATE_TOL["ln_fwd"])),
            (rstd, rrs, rel_tol(rrs, INCUBATE_TOL["ln_fwd"]))],
        "fused_layernorm_bwd": [
            (dx, rdx, flash_tol(dtype, rdx, INCUBATE_TOL["ln_bwd"])),
            (dgp, rdg, rel_tol(rdg, INCUBATE_TOL["ln_bwd"])),
            (dbp, rdb, rel_tol(rdb, INCUBATE_TOL["ln_bwd"]))]}

    # yardsticks: PyTorch's own layernorm, gamma/beta in x's dtype
    gl, bl = gamma.to(dtype), beta.to(dtype)
    _, lmu, lrs = torch.ops.aten.native_layer_norm(x, [d], gl, bl, eps)
    mask = [True, True, True]
    library = {
        "fused_layernorm_fwd": lambda: torch.nn.functional.layer_norm(
            x, (d,), gl, bl, eps),
        "fused_layernorm_bwd": lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [d], lmu, lrs, gl, bl, mask)}
    runs = {
        "fused_layernorm_fwd": (
            lambda: cln.fused_layernorm_fwd(x, gamma, beta, eps),
            lambda: tfl._plain_ln_fwd(x, gamma, beta, eps)),
        "fused_layernorm_bwd": (
            lambda: cln.fused_layernorm_bwd(x, gamma, mu, rstd, dy),
            lambda: tfl._plain_ln_bwd(x, gamma, mu, rstd, dy, rpb))}
    # (bytes: inputs read once, outputs written once; operations). The
    # backward's outputs are dx and dgamma, dbeta [d]: the kernel's [nb, d]
    # partials are its own choice, not work the function must do.
    xbytes = x.numel() * x.element_size()
    cost = {
        "fused_layernorm_fwd": (2 * xbytes + 2 * d * 4 + 8 * n, 7 * n * d),
        "fused_layernorm_bwd": (3 * xbytes + d * 4 + 8 * n + 2 * d * 4,
                                13 * n * d)}
    lines = {}
    for kern, outs in checks.items():
        errs = [(max_err(g, r), t) for g, r, t in outs]
        ok = all(e <= t for e, t in errs)
        nbytes, ops = cost[kern]
        b_ms, b_by = bound(nbytes, ops, torch.float32)   # f32 arithmetic
        line = {
            "phase": "kernel", "kernel": kern, "dtype": dtype_name(dtype),
            "gamma_dtype": "float32", "shape": {"n": n, "d": d},
            "rows_per_block": rpb if kern == "fused_layernorm_bwd" else 1,
            "max_abs_err": max(e for e, _ in errs),
            "tol": [t for _, t in errs], "within_tol": ok,
            "kernel_ms": timer.ms(runs[kern][0]),
            "plain_ms": timer.ms(runs[kern][1]),
            "library_ms": timer.ms(library[kern]),
            "library": "F.layer_norm" if kern == "fused_layernorm_fwd"
                       else "aten.native_layer_norm_backward",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops}
        emit(line)
        if not ok:
            raise SystemExit(f"{kern} {dtype}: errors {errs}")
        lines[kern] = line
    return lines


def rope_tables(s, d, dev, base=10000.0):
    """GPT-NeoX cos/sin tables [S, D/2] in float32."""
    inv = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv[None, :]
    return ang.cos().to(dev), ang.sin().to(dev)


def check_rope(dev, timer, dtype, b=8, s=1024):
    """The rotary kernel against its plain version at the incubate path's
    q, k [8, 12, 1024, 64] with float32 NeoX tables."""
    rng = np.random.default_rng(SEED + 6)
    q, k = (torch.from_numpy(rng.standard_normal(
        (b, NH, s, DH), dtype=np.float32)).to(dev, dtype) for _ in "qk")
    cos, sin = rope_tables(s, DH, dev)
    qo, ko = crot.rotary(q, k, cos, sin)
    torch.cuda.synchronize()
    rq, rk = trot._plain_rope(q, k, cos, sin)
    errs = []
    for got, ref in ((qo, rq), (ko, rk)):
        big = ref.float().abs().max().item()
        tol = (INCUBATE_TOL["rope"] * big if dtype == torch.float32
               else 2.0 ** -7 * big)
        errs.append((max_err(got, ref), tol))
    ok = all(e <= t for e, t in errs)
    nbytes = 4 * q.numel() * q.element_size() + 2 * cos.numel() * 4
    ops = 6 * q.numel()                  # 3 per element, for q and for k
    b_ms, b_by = bound(nbytes, ops, torch.float32)
    line = {
        "phase": "kernel", "kernel": "rotary", "dtype": dtype_name(dtype),
        "table_dtype": "float32",
        "shape": {"B": b, "H": NH, "S": s, "D": DH},
        "max_abs_err": max(e for e, _ in errs), "tol": [t for _, t in errs],
        "within_tol": ok,
        "kernel_ms": timer.ms(lambda: crot.rotary(q, k, cos, sin)),
        "plain_ms": timer.ms(lambda: trot._plain_rope(q, k, cos, sin)),
        "library_ms": None, "library": None,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops}
    emit(line)
    if not ok:
        raise SystemExit(f"rotary {dtype}: errors {errs}")
    return line


def incubate_parity(dev):
    """float32 `incubate.nn` layers on the card against the same layers on
    the CPU, on the same weights and inputs."""
    rng = np.random.default_rng(SEED + 7)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    results, launches = {}, {}
    gen = torch.Generator().manual_seed(SEED)
    cpu = FusedMultiTransformer(D_MODEL, NH, FFN, num_layers=2,
                                device="cpu", generator=gen).eval()
    card = FusedMultiTransformer(D_MODEL, NH, FFN, num_layers=2,
                                 device=dev).eval()
    card.load_state_dict(cpu.state_dict())
    x, mask = rand(2, 256, D_MODEL), rand(2, 1, 256, 256)
    for name, m in (("stack_masked", mask), ("stack_no_mask", None)):
        reset_launches()                 # the stack's run on the card
        with torch.no_grad():
            got = card(x.to(dev), attn_mask=None if m is None
                       else m.to(dev)).cpu()
        launches[name] = read_launches(
            f"incubate_parity {name}",
            {} if m is not None else {"flash_fwd": 2})
        with torch.no_grad():
            ref = cpu(x, attn_mask=m)
        results[name] = (max_err(got, ref),
                         rel_tol(ref, INCUBATE_TOL["stack"]))

    state = {"weight": rand(D_MODEL), "bias": rand(D_MODEL)}
    x, w = rand(2, 256, D_MODEL) * 2 + 0.5, rand(2, 256, D_MODEL)
    grads = {}
    for where in ("cpu", dev):
        ln = FusedLayerNorm(D_MODEL, device=where)
        ln.load_state_dict(state)
        xx = x.to(where).detach().requires_grad_(True)
        if where == dev:
            reset_launches()             # the layernorm's run on the card
        y = ln(xx)
        (y * w.to(where)).sum().backward()
        if where == dev:
            launches["layernorm"] = read_launches(
                "incubate_parity layernorm", dict.fromkeys(LN_KERNELS, 1))
        grads[str(where)] = [t.detach().cpu() for t in
                             (y, xx.grad, ln.weight.grad, ln.bias.grad)]
    for i, name in enumerate(("ln_y", "ln_dx", "ln_dweight", "ln_dbias")):
        ref = grads["cpu"][i]
        results[name] = (max_err(grads[str(dev)][i], ref), rel_tol(
            ref, INCUBATE_TOL["ln_fwd" if i == 0 else "ln_bwd"]))

    q, k = rand(2, NH, 256, DH), rand(2, NH, 256, DH)
    cos, sin = rope_tables(256, DH, "cpu")
    reset_launches()                     # the rope's run on the card
    got = fused_rotary_position_embedding(q.to(dev), k.to(dev), cos.to(dev),
                                          sin.to(dev))
    launches["rope"] = read_launches("incubate_parity rope", {"rotary": 1})
    ref = fused_rotary_position_embedding(q, k, cos, sin)
    for name, g, r in (("rope_q", got[0], ref[0]), ("rope_k", got[1],
                                                    ref[1])):
        results[name] = (max_err(g.cpu(), r), INCUBATE_TOL["rope"] * max(
            1.0, r.abs().max().item()))
    ok = all(e <= t for e, t in results.values())
    emit({"phase": "incubate_parity", "dtype": "float32",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "stack": {"embed_dim": D_MODEL, "num_heads": NH, "ffn": FFN,
                    "num_layers": 2, "input": [2, 256, D_MODEL]},
          "max_abs_diff": {k: e for k, (e, _) in results.items()},
          "bound": {k: t for k, (_, t) in results.items()},
          "launches": launches, "ok": ok})
    if not ok:
        raise SystemExit(f"incubate_parity: card and CPU disagree: {results}")


def incubate_run(dev, smi, reps=3, b=8, s=1024, nl=12):
    """The incubate entry points at full width in bfloat16: one warm-up call
    of each, then ``reps`` timed calls of each under one launch count."""
    rng = np.random.default_rng(SEED + 8)

    def rand(*shape, dt=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dt)
    stack = FusedMultiTransformer(
        D_MODEL, NH, FFN, num_layers=nl, device=dev,
        generator=torch.Generator().manual_seed(SEED)).to(
            torch.bfloat16).eval()
    ln = FusedLayerNorm(D_MODEL, device=dev)
    x, dy = rand(b, s, D_MODEL), rand(b, s, D_MODEL)
    q, k = rand(b, NH, s, DH), rand(b, NH, s, DH)
    cos, sin = rope_tables(s, DH, dev)
    xg = x.detach().requires_grad_(True)

    def run_stack():
        with torch.no_grad():
            return stack(x)

    def run_ln():
        y = ln(xg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y.backward(dy)
        torch.cuda.synchronize()
        return y, (time.perf_counter() - t0) * 1e3

    def run_rope():
        return fused_rotary_position_embedding(q, k, cos, sin)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for fn in (run_stack, run_ln, run_rope):      # warm-up, first touches
        fn()
    torch.cuda.synchronize()
    xg.grad = None
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()                     # the incubate path's timed run
    stack_ms, ln_ms, ln_bwd_ms, rope_ms = [], [], [], []
    for _ in range(reps):
        out, ms = timed(run_stack)
        stack_ms.append(ms)
        (y, bwd_ms), ms = timed(run_ln)
        ln_ms.append(ms - bwd_ms)
        ln_bwd_ms.append(bwd_ms)
        (qo, ko), ms = timed(run_rope)
        rope_ms.append(ms)
    launches = read_launches("incubate", {
        "flash_fwd": nl * reps, "fused_layernorm_fwd": reps,
        "fused_layernorm_bwd": reps, "rotary": reps})
    peak = torch.cuda.max_memory_allocated(dev)
    # what came out: finite, of the expected shapes, the layernorm and the
    # rope as their plain versions compute them on the card
    with torch.no_grad():
        ry, _, _ = tfl._plain_ln_fwd(x.reshape(-1, D_MODEL), ln.weight,
                                     ln.bias, ln.epsilon)
        rq, _ = trot._plain_rope(q, k, cos, sin)
        y = y.detach()
    ok = (tuple(out.shape) == (b, s, D_MODEL) and bool(out.isfinite().all())
          and tuple(xg.grad.shape) == (b, s, D_MODEL)
          and bool(xg.grad.isfinite().all())
          and max_err(y.reshape(-1, D_MODEL), ry) <= flash_tol(
              torch.bfloat16, ry, INCUBATE_TOL["ln_fwd"])
          and max_err(qo, rq) <= 2.0 ** -7 * rq.float().abs().max().item())
    emit({"phase": "incubate", "dtype": "bfloat16", "card": smi,
          "stack": {"embed_dim": D_MODEL, "num_heads": NH, "ffn": FFN,
                    "num_layers": nl, "input": [b, s, D_MODEL],
                    "mask": None},
          "reps": reps, "stack_forward_ms": stack_ms,
          "stack_forward_ms_p50": statistics.median(stack_ms),
          "layernorm_forward_ms": ln_ms, "layernorm_backward_ms": ln_bwd_ms,
          "rope_ms": rope_ms, "rope_shape": [b, NH, s, DH],
          "peak_memory_bytes": peak, "launches": launches, "outputs_ok": ok})
    if not ok:
        raise SystemExit("incubate: outputs not finite, misshapen or off "
                         "their plain versions")
    return launches


def nvidia_smi():
    """Card 0's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(dev)
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "capability": list(cap),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if tuple(cap) != (9, 0):
        raise SystemExit(f"expected a Hopper card (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {k: {"seconds": v["seconds"],
                       "ptxas": [ln.strip() for ln in v["ptxas"].splitlines()
                                 if "Used" in ln or "spill" in ln]}
                   for k, v in libs.items()}})

    timer = Timer(dev)
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        for quant, suffix in ((False, ""), (True, "_int8")):
            cases[("paged_decode" + suffix, dtype)] = check_decode(
                dev, timer, dtype, quant)
            check_decode(dev, timer, dtype, quant, "b1_long")
            for c, start, valid in PREFILL_CASES:
                cases[("paged_prefill" + suffix, dtype, c)] = check_prefill(
                    dev, timer, dtype, c, start, valid, quant)
            prefill_scalars(dev, dtype, quant)
        for case in FLASH_CASES:
            for kern, line in check_flash(dev, timer, dtype, case).items():
                cases[(kern, dtype, case[0])] = line
        for kern, line in check_layernorm(dev, timer, dtype).items():
            cases[(kern, dtype)] = line
        cases[("rotary", dtype)] = check_rope(dev, timer, dtype)
        cases[("dropout", dtype)] = check_dropout(dev, timer, smi, dtype)
    del timer
    torch.cuda.empty_cache()

    sampler_phase(dev, smi)
    model = gpt_mod.gpt2_small(generator=torch.Generator().manual_seed(SEED))
    serve_parity(model, dev)
    serve_parity(model, dev, kv_dtype="int8")
    serve_sampled_parity(model, dev)
    serve_spec_parity(model, dev)
    serve_prefix_parity(model, dev)
    serve_prefix_parity(model, dev, kv_dtype="int8")
    other = gpt_mod.gpt2_small(
        generator=torch.Generator().manual_seed(SEED + 9))
    serve_graph(model, other, dev)
    model = model.to(torch.bfloat16)
    serve_graph(model, other.to(torch.bfloat16), dev)
    del other
    serve_parity(model, dev)
    line, greedy_outs = serve_run(model, dev, smi)
    launches = line["launches"]
    prefill_graph_memory(model, dev, smi)
    serve_run(model, dev, smi, "serve_sampled", params=SAMPLED_PARAMS,
              greedy_ref=greedy_outs, sampling=True)
    serve_run(model, dev, smi, "serve_spec", speculate_k=SPEC_K)
    quantized = serve_run(model, dev, smi, "serve_int8", kv_dtype="int8",
                          weight_dtype="int8")[0]["launches"]
    serve_prefix(model, dev, smi)
    serve_inflight(model, dev, smi, greedy_outs)
    serve_lifecycle(model, dev, smi)
    serve_observe(model, dev, smi, greedy_outs)
    launches.update((k, quantized[k]) for k in INT8_KERNELS)
    del model
    torch.cuda.empty_cache()
    train_parity(dev, smi)
    train_parity(dev, smi, torch.bfloat16)
    train_parity(dev, smi, hidden_dropout=DROPOUT_P)
    train_parity(dev, smi, torch.bfloat16, hidden_dropout=DROPOUT_P)
    trained = train_run(dev, smi)["launches"]
    launches.update((k, trained[k]) for k in FLASH_KERNELS)
    dropped = train_run(dev, smi, "train_dropout", hidden_dropout=DROPOUT_P)
    launches["dropout"] = dropped["launches"]["dropout"]
    train_recompute(dev, smi, dropped)
    torch.cuda.empty_cache()
    incubate_parity(dev)
    incubated = incubate_run(dev, smi)
    launches.update((k, incubated[k]) for k in (*LN_KERNELS, "rotary"))

    # the shapes of the paths' runs: bfloat16, decode at B=8, prefill up to
    # C=1024, flash at the train shape, layernorm and rope at the incubate
    # run's
    bf16 = torch.bfloat16
    head = {k: cases[(k, bf16)] for k in ("paged_decode",
                                          "paged_decode_int8")}
    head.update((k, cases[(k, bf16, 1024)]) for k in ("paged_prefill",
                                                      "paged_prefill_int8"))
    head.update((k, cases[(k, bf16, "train")]) for k in FLASH_KERNELS)
    head.update((k, cases[(k, bf16)]) for k in (*LN_KERNELS, "rotary",
                                                "dropout"))
    summary = []
    for k in _build.kernels():
        h = head[k.source]
        summary.append({
            "name": k.source, "route": "cuda", "source": k.path,
            "replaces": REPLACES[k.source], "launches": launches[k.source],
            "max_abs_err": h["max_abs_err"], "ms": h["kernel_ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
