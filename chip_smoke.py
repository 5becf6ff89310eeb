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
   (that raw line is also printed alone), its SM and memory clocks,
   temperature, power draw and active throttle reasons (``clocks``,
   `card_clocks`), and its compute capability, which must be (9, 0).
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
   ``block_q`` is in ``shape``; on the prefill's CUDA-core loop the grid
   is (query tiles, heads, splits), ``splits`` the blocks that share a
   tile's keys, and ``visits_ok`` also holds each split's page count
   against `split_pages`); the ``paged_decode`` and
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
   ``train_f32``: GPT-2 small in its default float32 (no cast to bf16),
   B=16 as 2 microbatches of 8, S=1024, 2 warm-up and 4 timed steps: the
   f32 CUDA-core loops of the three flash kernels on the main path, each
   24 times a step (held exact, ``flash_launches_per_step``), with the
   step's share of the H100's 67 TFLOP/s f32 rate (``f32_peak_share``)
   beside its MFU. Every train line carries the card's clocks.
   ``train_eager``: GPT-2 small as a Paddle program trains it (the
   Layers of `models/gpt.py`, built after ``paddle.seed(SEED)`` on the
   card, float32, hidden dropout 0.1, fused CE,
   ``paddle.optimizer.AdamW(parameters=model.parameters())``), B=8,
   S=1024, 6 steps of ``loss.backward(); opt.step(); opt.clear_grad()``:
   step ms p50, tokens/s, MFU and f32 share, peak memory, launches a step
   (12 of each flash kernel, 50 ``dropout``, exact); the losses fall, and
   with dropout off each of the 6 steps' losses equals the port's
   `ScanTrainStep`'s on the same weights (TRAIN_LOSS_TOL), and the
   parameters after them (within 2 x lr, all but 0.1% within 1e-5).
   ``generate_eager``: the same Layer with `serve`'s f32 weights decodes
   `serve`'s 8 prompts with its eager ``generate``, 32 greedy tokens each
   (flash at Sq = 1 against the growing cache, held as the ``decode``
   flash case): tokens equal to an f32 `DecodeEngine`'s where the CPU's
   top-2 margin exceeds MARGIN, ms a token; then two of the decodes
   (prompts of 250 and 380 tokens) once more under `torch.profiler`: the
   card's busy ms a token (all kernels, and flash's share), kernels a
   token, and the unprofiled wall's ratio to the busy time.
   ``train_static``: the JAX bench's GPT-2 program (`bench.py:155-196`)
   on the port: GPT-2 small from ``paddle.seed(SEED)`` on the card,
   AdamW 1e-4, ``paddle.amp.decorate(O2, bfloat16)``, the step under
   ``auto_cast(O2)`` decorated with ``paddle.jit.to_static`` and driven
   by ``multi_steps(32)`` on one batch of B=16, S=1024: 2 warm-up calls
   (the step's first 2 runs eager, then one CUDA graph captured and
   replayed), 3 timed calls; step ms, tokens/s, MFU (6N over 989
   TFLOP/s), peak memory, the capture's seconds, the launches of each
   flash kernel a step read through the replays (12, exact), the first
   loss (near ln 50304) and the last, and the same step eagerly (2 + 3
   steps) beside it. Then 4 to_static calls against 4 eager steps from
   the same seed (B=8): losses, parameters and the key chain bit for
   bit, and one more call at a rate set to 0 between calls must leave
   the parameters as they were; the same with hidden dropout 0.1; and a
   to_static dropout's replays draw new masks, equal to the eager
   draws. ``train_bert_static``: the bench's BERT-base program
   (`bench.py:264-295`, `models/bert.py`) the same way: B=128, S=128,
   AdamW 2e-5, ``multi_steps(16)``, sequences/s, and 4 calls against 4
   eager steps bit for bit; its attention is the non-causal flash op
   (the ``bert`` flash case's shape).
   ``train_resnet_static``: the bench's ResNet50 program
   (`bench.py:233-261`, `vision/models/resnet.py`): B=256 at 224 x 224,
   NCHW, Momentum 0.1 with weight decay 1e-4 on float32 masters, amp O2
   bfloat16, ``multi_steps(8)``; images/s, step ms, MFU (3 x 2 x the
   forward multiply-adds an image, counted from the convolution and
   linear shapes, `resnet_macs`), peak memory, capture seconds, the eager
   step beside it; the batch norm kernels 53 launches each a step through
   the replays; 4 calls against 4 eager steps at B=32 under
   ``cudnn.deterministic`` (losses, parameters, running statistics and
   the key chain bit for bit, one more call at rate 0), and one float32
   training call on the card against the port on the CPU at B=2
   (RESNET_CPU_TOL). The batch norm kernels (``batch_norm_fwd``,
   ``batch_norm_bwd``) get ``kernel`` lines at ResNet50's first and last
   norm shapes (BN_CASES), float32 and bfloat16, against their plain
   versions (BN_TOL), beside `torch.nn.functional.batch_norm` and
   `aten.native_batch_norm_backward`.
   ``phase_seconds``: each group of phases' seconds, before the
   ``kernels`` line.
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
   every turn and their first 32 equal to `serve`'s. ``serve_handoff``
   (bf16 engines, over bf16 pools and over int8 pools with int8 weights,
   `serve_engine`'s settings at ``inflight=2``, `serve`'s 8 prompts and a
   9th): engine A exports and engine B imports, in four arms a dtype:
   ``one_shot`` (`prefill_export`, `pack`, `unpack`, `import_request`),
   ``streamed`` (`submit_prefill_stream` with 256-token chunks, the
   records into a `KVStreamAssembler`, `submit_import`), ``migration``
   (8 requests decode 5 steps, the 9th queued; `drain(migrate=True)`,
   `take_migrated`, `pack_migration` / `unpack_migration`, warm items by
   `submit_import`, the cold one by `submit`) and ``sampled_migration``
   (the same with SAMPLED_PARAMS). Gates: each request's tokens equal an
   uninterrupted engine's of A's config (a bf16 streamed request, whose
   short prompts run a chunk program where the reference runs the
   one-shot one, may differ only where `serve_bf16_parity`'s margin
   allows), B captures no prefill graph in the first two arms, every
   pool ends at its baseline, ``migrations_out`` equals ``migrations_in``
   plus the cold item, a flipped body byte is refused
   (``HandoffCorrupt``), and the launches are exact. Each line: export,
   pack, unpack and import ms (medians over the requests), blob bytes a
   token, the migration's wall from `drain` to `take_migrated`, the
   decode side's TTFT. ``serve_wire`` (after ``serve_handoff``; the serve
   tier, `inference/serve.py`, over the wire on this host; `serve`'s 8
   prompts, 32 new tokens, ``inflight=2``, prefix cache off), one line an
   arm: ``cli`` (GPT-2 small's float32 weights from the seed written by
   `framework.io.save`, ``python -m paddle_tpu_torch.inference.serve
   --gpt-config`` in a process of its own: start to ``LISTENING``, a first
   request, the 8 at once twice, STATS and PROMETHEUS, a wrong secret
   dropped, SIGTERM drains it to exit 0; its launches from its STATS'
   ``kernel.dispatch.*``), ``inproc`` (an `InferenceServer` over a bf16
   engine here: 8 clients, then a 900-token request cancelled by the
   CANCEL op and a 511-token one whose client disconnects, both typed),
   ``migrate`` (8 requests on replica A, after its 5th step
   ``A.drain(migrate_peers=[B])``: zero client errors, 8 migrations out
   and in, the drain's wall, pack ms an item) and ``disagg`` (a
   ``role="prefill"`` replica's OP_PREFILL records relayed by hand to a
   ``role="decode"`` replica's OP_KV_STREAM: no prefill graph on the
   decode side; tokens against a 256-token-chunk engine, a bf16
   difference within ``serve_bf16_parity``'s margin allowed, ROADMAP
   C11). Every answered request's tokens equal an in-process engine's of
   the same config and weights, every pool ends at its baseline, the
   launches are exact; each line has request walls (p50, p90), tokens/s
   beside the in-process engine's, bytes and the card's clocks. Then
   ``b14``: each graph capture's seconds on a fresh server's serve thread
   (8 clients at once, and one at a time) and on the building thread of
   a warmed engine, three runs each (ROADMAP B14). ``serve_router``
   (run last, after ``incubate``, on ``serve_wire``'s prompts and
   references; the port's router, `serving/router.py`, and
   autoscaler, `serving/autoscale.py`, in front of bf16 replicas of
   ``serve_wire``'s settings in this process), one line an arm:
   ``routed`` (two replicas, `serve`'s 8 prompts at once straight to
   them, then through a router under ``round_robin`` and under
   ``least_outstanding``: request walls and tokens/s beside
   ``serve_wire``'s ``inproc`` ones, each replica's share),
   ``failover`` (two replicas under a 10 ms step delay, one stopped hard
   with requests mid-decode on it: zero client errors, resubmits, its
   breaker open; then a replacement registers in a node registry that
   the router watches and takes a share of the next 8), ``disagg`` (two
   ``role="prefill"`` replicas with the prefix cache and one
   ``role="decode"`` replica in a registry; `serve_prefix`'s 8 prompts,
   the first alone: the 768-token system prompt prefilled once fleet
   wide, 7 affinity hits, no prefill graph on the decode replica, bf16
   tokens gated as ``serve_wire``'s ``disagg``), ``cli`` (``python -m
   paddle_tpu_torch.serving.router`` in a process of its own in front of
   two replicas: ``LISTENING``, the 8 prompts, STATS and PROMETHEUS,
   SIGTERM to exit 0) and ``autoscale`` (an `Autoscaler` over a router
   and one replica, `tick()` by hand: 16 clients of sustained load scale
   it to 2, spawning a warmed replica; a quiet fleet, one request in
   flight a replica, scales it back to 1, the spawned replica drained by
   migration to its peer: the spawn's seconds and the drain's wall).
   Every arm: tokens equal to the in-process engine's, pools at their
   baseline, exact launches, the card's clocks.
   ``serve_lifecycle`` (bf16, ``inflight=2``): engine
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
   ``train_ckpt`` and ``train_elastic`` (run after ``serve_router``):
   GPT-2 small's widths at 6 of its 12 layers (FT_LAYERS) in bf16 on
   f32 masters, S=1024, AdamW over an
   `optimizer/lr.py` schedule (a warm-up into a cosine decay) that the
   checkpoints carry, the checkpoints under a temporary directory removed
   at the end. ``train_ckpt``, one process, B=16 as 2 microbatches,
   `CheckpointManager(every=2, keep=2)` with async saves, one line an
   arm: ``resume`` (6 steps; a fresh step restored from step 4 runs steps
   5-6: losses and every leaf equal to the uninterrupted run's; the host
   snapshot's blocking ms, the background write's s, the restore's s, the
   checkpoint's bytes and GB/s, iteration ms with saves beside ``train``'s
   p50), ``corrupt`` (a flipped byte in the newest checkpoint: `restore`
   falls back to the previous one and counts
   ``train.resume_corrupt_skipped``), ``bad_steps`` (``train.step_nan``:
   the update and the clock skipped; two in a row roll back to the last
   checkpoint and raise `TooManyBadSteps`), ``sigterm`` (a worker process
   of this script, ``--ckpt-worker``, gets SIGTERM as its third step
   starts, finishes it, checkpoints synchronously and exits 0; a resume
   from that checkpoint equals the uninterrupted run). ``train_elastic``:
   rank processes of this script (``--elastic-worker``, each its own
   CUDA context on the card; `run_elastic_worker` over the fleet's
   TCPStore), 8 of the 16 rows a rank at world 2: ``world2`` (4 steps;
   losses against one process with 2 microbatches on the same global
   batches, gate 2e-3, exactness reported; a second run from the step-2
   checkpoint equal to the first; step ms, the reducer's ms by piece and
   bytes, each rank's peak memory), ``stop_vote`` (SIGTERM to rank 1:
   both ranks stop at one step boundary after a fleet-complete
   checkpoint and exit 0), ``peer_dead`` (``PADDLE_FAULTS=
   train.peer_dead`` on rank 1: rank 0 raises `PeerLost` within the
   deadline and exits 23, `ElasticController` reforms the fleet at world
   1, which resumes from the step-2 checkpoint equal to one process
   restored from it; kill to `PeerLost`, reform to first step).
   ``generate_fast`` and ``quant_comms`` (run after ``train_elastic``):
   the JAX bench's decode, engine-decode and quantization rungs.
   ``generate_fast``: `GPTForCausalLM.fast_generate`, one captured CUDA
   graph a signature. `bench_decode` (GPT-2 small, float32, from
   ``paddle.seed(0)``, B=8, S0=128, N=64, greedy): a capture call, then
   the timed call: tokens/s, ms a token, the capture's seconds, kernels a
   call and device ms (one more call under the profiler), the replay's
   CUDA-event ms, peak and reserved memory; no registry kernel launches
   (the program's attention is dense). `bench_engine_decode`: 8 prompts
   of 128 as sequential B=1 calls and through a `DecodeEngine` (8 slots,
   page 16): both tokens/s and their ratio, the bench's exact-token
   assertion (the first divergence and the CPU's margin reported before
   it raises), the engine's paged-kernel launches exact. Gates on
   ``generate_eager``'s model and prompts: greedy tokens (8 signatures,
   the reserved memory after each capture) and a sampled B=8 call
   (FAST_SAMPLED) equal to eager `generate` on the card where the CPU's
   margin exceeds MARGIN (`fast_margin`), a second call equal to the
   first, ``wte`` written in place seen with no capture, a
   `set_state_dict` that rebinds a frozen ``wte`` re-captured once and
   equal to a fresh model with those weights. ``quant_comms``:
   `bench_quant`'s three claims with its config (vocab 1024, hidden 256,
   4 layers, S=48, N=24, page 16): the int8 pool's slots at the float32
   pool's bytes (>= 1.9x) run as one engine, the margin-gated int8
   prefill parity, a quantized all-reduce of a 2^20-value float32
   gradient at >= 3x fewer ``collective.bytes`` within
   `roundtrip_bound`; then a world-2 arm of `testing/collective_drill.py`
   ranks on this card (every collective on CUDA tensors against numpy's
   closed forms, the quantized ones within the sum of the ranks'
   bounds, the byte counters against the JAX formula, ms a call of the
   store transport, which is not NCCL).
   ``fit_hapi`` (after ``quant_comms``): the data pipeline and
   `Model.fit` (`io`, `vision.datasets` / `transforms`, `metric`,
   `hapi`), one line an arm, every DataLoader worker a spawn child that
   reports whether it holds a CUDA context (it must not). ``gpt_fused``:
   GPT-2 small as ``train`` trains it (bf16 on f32 masters, no dropout,
   AdamW 1e-4, clip 1.0) fitted over 48 rows of 1025 ids from ``SEED``,
   batch 8, ``accumulate_grad_batches=2``, 2 shm workers (3 steps of two
   microbatches of 8): the parameters bit-equal to `ScanTrainStep
   (microbatches=2)` stepped directly on the same three groups, a fit
   preempted after epoch 0 by `CheckpointManager` and resumed by a fresh
   Model bit-equal to an uninterrupted 2-epoch fit; tokens/s of the fit
   and of the direct step (steady: from the first group's end to the
   last's), the flash launches of the fit exact. ``resnet_fit``:
   ``resnet50()`` in float32 on the eager route (Momentum 0.1, weight
   decay 1e-4, ``CrossEntropyLoss``, ``Accuracy(topk=(1, 5))``) over
   `FakeData` 256 x 256 images cropped to 224 (`RandomResizedCrop`,
   `RandomHorizontalFlip`), batch 32: 4 seeded in-process steps under
   ``cudnn.deterministic`` equal a hand-written loop over the same
   batches (losses, accuracies, parameters and running statistics bit
   for bit); then 8 steps with 4 shm workers: images/s and the share of
   the loop blocked in the loader from the first batch's end to the
   last's, the batch norm launches exact. ``dataloader``: `bench.py`'s
   `bench_dataloader` rung (pump and overlap, in-process and with 4 shm
   workers, batch 64), images/s, ``os.cpu_count()`` and the `Resize`
   branch taken (PIL or numpy).
12. ``kernels``: per kernel, its source, the TPU kernel it replaces, its
   launches in the run of the path that uses it (serve for the float paged
   kernels, serve_int8 for the int8 ones, train, train_ckpt and
   train_elastic (every rank's) and ``fit_hapi``'s ``gpt_fused`` fit for
   the flash kernels, ``train_resnet_static`` and ``fit_hapi``'s timed
   ``resnet_fit`` for the batch norm kernels, incubate for the
   layernorm and rotary kernels, train_dropout for the dropout kernel; the
   float paged kernels also count ``generate_fast``'s engine and both
   paged pairs ``quant_comms``'s engines) and its numbers at that run's
   shapes.
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

import dataclasses
import gc
import glob
import json
import math
import os
import random
import re
import shutil
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.tensor import Tensor as PTensor, torch_state
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.distributed.fleet.elastic import NodeRegistry
from paddle_tpu_torch.incubate.nn import (FusedLayerNorm,
                                          FusedMultiTransformer,
                                          fused_rotary_position_embedding)
from paddle_tpu_torch.framework import io as pio
from paddle_tpu_torch.inference import serve as serve_mod
from paddle_tpu_torch.inference.engine import (Cancelled, DecodeEngine,
                                               EngineConfig, HandoffCorrupt,
                                               KVHandoff, Overloaded,
                                               pack_migration,
                                               unpack_migration)
from paddle_tpu_torch.inference.serve import InferenceServer, RemotePredictor
from paddle_tpu_torch.kernels import _build, registry
from paddle_tpu_torch.kernels import batch_norm as tbn
from paddle_tpu_torch.kernels import dropout as tdrop
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_layernorm as tfl
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.kernels import rotary as trot
from paddle_tpu_torch.kernels import sampling as smp
from paddle_tpu_torch.kernels.cuda import batch_norm as cbn
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
from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                           LinearWarmup)
from paddle_tpu_torch.quantization import comms as tcomms
from paddle_tpu_torch.quantization.serving import (QUANT_LOGIT_BOUND,
                                                   margin_gated_parity)
from paddle_tpu_torch.serving.autoscale import (Autoscaler, AutoscalePolicy,
                                                CallbackLauncher)
from paddle_tpu_torch.serving.disagg import (KVStreamAssembler,
                                             prompt_page_hashes)
from paddle_tpu_torch.serving.router import Router
from paddle_tpu_torch.testing import collective_drill, faults
from paddle_tpu_torch.train import (EXIT_PEER_LOST, H100_BF16_PEAK,
                                    CheckpointManager,
                                    ElasticController, PeerLost,
                                    ScanTrainStep, TooManyBadSteps,
                                    run_elastic_worker)
from paddle_tpu_torch.train import elastic as elastic_mod
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
    # computed in XLA by the JAX package: no pl.pallas_call behind them
    "dropout": "paddle_tpu/models/gpt.py:655 (_fdropout, XLA, not Pallas)",
    "batch_norm_fwd": "paddle_tpu/nn/functional/norm.py:27 (batch_norm's "
                      "training prim, XLA, not Pallas)",
    "batch_norm_bwd": "paddle_tpu/nn/functional/norm.py:27 (the prim's "
                      "gradient, XLA, not Pallas)",
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
# "incubate" are the shapes the train and incubate runs give the kernels,
# "decode" one token against a cache of 900 + 32 (`generate_eager`),
# "bert" BERT-base's training shape (`train_bert_static`)
FLASH_CASES = (("train", 8, 12, 1024, 1024, 64, True),
               ("incubate", 8, 12, 1024, 1024, 64, False),
               ("ragged", 1, 12, 200, 200, 64, True),
               ("cross", 1, 12, 64, 300, 64, True),
               ("decode", 1, 12, 1, 932, 64, True),
               ("noncausal", 2, 12, 256, 256, 64, False),
               ("bert", 128, 12, 128, 128, 64, False))
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
# gradients 1e-4 (the dgamma/dbeta partials add 32- or 256-row blocks);
# the stack 1e-4 (matrix products and layernorms in a row); rope 1e-6 (one
# f32 rounding of each product and sum on both sides).
INCUBATE_TOL = {"ln_fwd": 2e-5, "ln_bwd": 1e-4, "stack": 1e-4,
                "rope": 1e-6}
LN_KERNELS = ("fused_layernorm_fwd", "fused_layernorm_bwd")
BN_KERNELS = ("batch_norm_fwd", "batch_norm_bwd")
# the batch norm kernels' checks: ResNet50's largest norm at B=256 (bn1
# over [256, 64, 112, 112]; the kernels line's case) and its last stage's
# (7 x 7: one element a load); tolerances against the plain version on the
# card, relative to the largest reference value when that exceeds 1:
# outputs within 2e-5 in f32 and two bfloat16 steps (2^-6) in bf16, where
# the plain version rounds to bf16 after each of its four ops (x - mean,
# the division, the weight, the bias) and the kernel once; the
# per-channel sums (dw, db) within 1e-4 in f32 and one bfloat16 step
# (2^-7) in bf16, where the plain version's mean and variance come out of
# `torch.var_mean` in bf16 (2^-9 apart from the kernel's f32 ones, and dw
# scales with rstd)
BN_CASES = (("bn1", (256, 64, 112, 112)), ("layer4", (256, 2048, 7, 7)))
BN_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2.0 ** -6,
                                                       2.0 ** -7)}
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


def host_gpt2_small(**kw):
    """`models/gpt.py::gpt2_small` built on the host, as every phase's model
    is: the engines and train steps copy its weights to their devices."""
    with tdevice.device_scope("cpu"):
        return gpt_mod.gpt2_small(**kw)


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

    out, split_visits = run(return_visits="splits")
    torch.cuda.synchronize()
    ref = pa._plain_prefill_attention(q[None], kp, vp, row, start, valid,
                                      *sc)[0]
    err = (out.float() - ref.float()).abs().max().item()
    bq = cpre.default_block_q(c, dtype, DH)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = cpre.grid(c, NH, dtype, DH, MAXP, PS, sms)
    n = grid[2] if len(grid) == 3 else 1
    visits = split_visits.sum(-1)
    want = [min(cpre.block_visits(start, valid, i * bq, bq, PS), MAXP)
            for i in range(visits.shape[0])]
    visits_ok = bool((visits == torch.tensor(want, dtype=torch.int32,
                                             device=dev)[:, None]).all())
    if len(grid) == 3:   # each split's pages: its units, each page once
        per_split = [[len(p) for p in cpre.split_pages(
            start, valid, i * bq, bq, PS, MAXP, DH, n)]
            for i in range(visits.shape[0])]
        visits_ok &= bool((split_visits == torch.tensor(
            per_split, dtype=torch.int32, device=dev)[:, None, :]).all())
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
        "arm": cpre.arm(dtype, DH), "grid": list(grid), "splits": n,
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

    cpu_params = torch_state(model)
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
    cpu_params = torch_state(model)
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
    cpu_params = torch_state(model)
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
    line = {"phase": phase, "model": "gpt2-small",
            "dtype": dtype_name(model.parameters()[0].dtype),
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
        native = {k: v.to(dev) for k, v in torch_state(model).items()}
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
    cpu_params = torch_state(model)
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
    card_params = {k: v.to(dev) for k, v in torch_state(model).items()}
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


# serve_handoff: the streamed arm's prefill chunk, the steps engine A
# decodes before its migrating drain, the 9th request's prompt length
# (queued behind the 8 slots at the drain, so it leaves cold) and its
# sampler parameters in the sampled arm
HANDOFF_CHUNK = 256
HANDOFF_STEPS = 5
HANDOFF_QUEUED = 129
HANDOFF_QUEUED_PARAMS = (0.8, 40, 7)
HANDOFF_NEW_TOKENS = 32
HANDOFF_ARMS = ("one_shot", "streamed", "migration", "sampled_migration")


def handoff_engine(model, dev, warm_lens=SERVE_LENS, **ecfg):
    """An engine of `serve_engine`'s settings at ``inflight=2`` (``ecfg``:
    its pools, weights, sampling, prefill chunk), warmed for ``warm_lens``
    (none: the decode step's graph alone, a decode-only engine)."""
    eng = DecodeEngine(model, EngineConfig(**{
        "page_size": PS, "max_slots": 8, "prefix_cache": False,
        "inflight": 2, **ecfg}), device=dev)
    eng.warmup(prompt_lens=warm_lens)
    torch.cuda.synchronize()
    return eng


def steps_launches(engines, before):
    """The launches the steps of ``engines`` since ``before`` (their
    counters then) imply, as `engine_launches` counts one engine's."""
    expected = {}
    for eng, c0 in zip(engines, before):
        ran = {k: eng.counters[k] - c0[k] for k in c0}
        nl = eng.cfg.num_layers
        suffix = "_int8" if eng._quant_kv else ""
        for name, n in (("paged_decode" + suffix,
                         nl * (ran["steps"] - ran["spec_steps"])),
                        ("paged_prefill" + suffix,
                         nl * (ran["prefills"] + ran["prefill_chunks"]))):
            expected[name] = expected.get(name, 0) + n
    return {k: n for k, n in expected.items() if n}


def handoff_launches(engines, before, phase):
    """The kernels' launches since `reset_launches` against what the steps
    of ``engines`` since ``before`` imply (`steps_launches`)."""
    expected = steps_launches(engines, before)
    return read_launches(phase, expected), expected


def p50(xs):
    return statistics.median(xs) if xs else None


def handoff_tokens(outs, refs, prompts, gated, card_params, cfg, dev):
    """Each request's tokens against the uninterrupted engine's: equal, or
    (``gated``: a bf16 arm whose exporter ran other prefill programs than
    the reference's) a first divergence within `serve_bf16_parity`'s
    margin (`bf16_gated_tokens`). Returns the record and whether it
    passes."""
    eq = [bool(np.array_equal(a, b)) for a, b in zip(outs, refs)]
    rec = {"tokens_equal": eq}
    if all(eq) or not gated:
        return rec, all(eq)
    rec["vs_ref"], ok = bf16_gated_tokens(outs, refs, prompts, card_params,
                                          cfg, dev, "ref")
    return rec, ok


def corrupt_refused(blob, unpack):
    """``unpack`` of ``blob`` with one body byte flipped raises the typed
    HandoffCorrupt."""
    bad = bytearray(blob)
    bad[-3] ^= 0x40
    try:
        unpack(bytes(bad))
    except HandoffCorrupt:
        return True
    return False


def feed_records(records):
    """The handoff a `KVStreamAssembler` assembles from ``records``."""
    asm = KVStreamAssembler()
    for rec in records:
        out = asm.feed(rec)
    return out


def stream_records_of(eng, prompt):
    """One prefill-stream job of ``prompt`` run by ``eng``'s next step:
    its PTKS1 records."""
    sink = eng.submit_prefill_stream(prompt)
    eng.step()
    items = []
    while True:
        kind, val = sink.get_nowait()
        items.append((kind, val))
        if kind == "err":
            raise SystemExit(f"serve_handoff: prefill stream failed: {val}")
        if kind == "done":
            break
    recs = [v for k, v in items if k == "rec"]
    if items[0] != ("count", len(recs)):
        raise SystemExit("serve_handoff: the stream's record count is "
                         "not the one it announced")
    return recs


def migrate_arm(src, dst, prompts, params, n):
    """Engine ``src`` serves ``prompts`` (``params`` each), HANDOFF_STEPS
    steps, then a migrating drain; the items go through PTMG1 to ``dst``,
    warm ones by `submit_import`, cold ones by `submit`. Returns each
    request's answer from ``dst`` in prompt order, the timings and the
    item counts."""
    reqs = [src.submit(p, max_new_tokens=n, temperature=t, top_k=k, seed=s)
            for p, (t, k, s) in zip(prompts, params)]
    for _ in range(HANDOFF_STEPS):
        src.step()
    t0 = time.perf_counter()
    src.drain(migrate=True)
    src.step()
    items = src.take_migrated(timeout=120)
    wall = time.perf_counter() - t0
    times = {"pack": [], "unpack": [], "import": []}
    blobs, backs = [], []
    for item in items:
        t0 = time.perf_counter()
        blobs.append(pack_migration(item))
        times["pack"].append((time.perf_counter() - t0) * 1e3)
    for blob in blobs:
        t0 = time.perf_counter()
        backs.append(unpack_migration(blob))
        times["unpack"].append((time.perf_counter() - t0) * 1e3)
    warm = [(b, back) for b, back in zip(blobs, backs)
            if back.handoff is not None]
    nbytes = sum(len(b) for b, _ in warm)
    ctx = sum(back.handoff.prompt.size for _, back in warm)
    answers = {}
    for item, back in zip(items, backs):
        idx = next(i for i, r in enumerate(reqs) if r is item.request)
        if back.handoff is not None:
            t0 = time.perf_counter()
            answers[idx] = dst.submit_import(
                back.handoff, max_new_tokens=back.max_new_tokens)
            times["import"].append((time.perf_counter() - t0) * 1e3)
        else:
            s = back.sample or {}
            answers[idx] = dst.submit(
                back.prompt, back.max_new_tokens,
                temperature=s.get("temperature", 1.0),
                top_k=s.get("top_k", 0), seed=s.get("seed", 0))
    t0 = time.perf_counter()
    dst.step()                           # places the imports
    torch.cuda.synchronize()
    place_ms = (time.perf_counter() - t0) * 1e3
    dst.run_until_idle(max_steps=10_000)
    torch.cuda.synchronize()
    out = [answers[i].result(timeout=0) for i in range(len(prompts))]
    n_cold = sum(1 for i in items if i.handoff is None)
    return out, {
        "ttft_ms": [(r.first_token_t - r.submit_t) * 1e3
                    for r in answers.values()],
        "migration_wall_ms": wall * 1e3, "place_step_ms": place_ms,
        "pack_ms_p50": p50(times["pack"]),
        "unpack_ms_p50": p50(times["unpack"]),
        "import_ms_p50": p50(times["import"]),
        "blob_bytes_per_token": nbytes / max(1, ctx),
        "items": len(items), "warm": len(items) - n_cold,
        "cold": n_cold, "all_futures_open": not any(r.done for r in reqs),
        "corrupt_refused": corrupt_refused(warm[0][0], unpack_migration)}


def serve_handoff(model, dev, smi):
    """The KV handoff, the streamed prefill and live migration of the
    bf16 GPT-2 small engines at full width, over bf16 pools and over int8
    pools with int8 weights, `serve`'s 8 prompts (and a 9th that is queued
    at the migration's drain), 32 new tokens each, `serve_engine`'s
    settings at ``inflight=2``. Four arms a dtype (`handoff_arm`): engine
    A exports (one-shot `prefill_export` and `pack`; the prefill stream
    with HANDOFF_CHUNK-token chunks into a `KVStreamAssembler`; a
    migrating drain after HANDOFF_STEPS steps, greedy, then sampled with
    SAMPLED_PARAMS) and a decode engine B imports. Each request's tokens
    must equal an uninterrupted engine's of A's config; B captures no
    prefill graph in the first two arms; every pool ends at its baseline;
    ``migrations_out`` equals ``migrations_in`` plus the cold items; a
    flipped byte is refused. One line an arm and dtype."""
    rng = np.random.default_rng(SEED + 2)      # serve_engine's prompts
    prompts = [rng.integers(0, min(VOCAB, model.cfg.vocab_size), n)
               .astype(np.int32) for n in SERVE_LENS]
    extra = rng.integers(0, min(VOCAB, model.cfg.vocab_size),
                         HANDOFF_QUEUED).astype(np.int32)
    card_params = {k: v.to(dev) for k, v in torch_state(model).items()}
    ok = True
    for q in ({}, {"kv_dtype": "int8", "weight_dtype": "int8"}):
        ok &= handoff_dtype(model, dev, smi, prompts, extra, q, card_params)
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("serve_handoff: tokens unlike the uninterrupted "
                         "engine's, a prefill graph on the decode engine, "
                         "pages not back at baseline, migration counts "
                         "that do not add up or a corrupt blob accepted")


def handoff_dtype(model, dev, smi, prompts, extra, q, card_params):
    """`serve_handoff`'s four arms over one pool dtype; True if all pass."""
    n, cfg = HANDOFF_NEW_TOKENS, model.cfg
    pools = "int8" if q else "bfloat16"
    greedy = [(1.0, 0, 0)] * (len(prompts) + 1)
    sampled = list(SAMPLED_PARAMS) + [HANDOFF_QUEUED_PARAMS]
    everyone = prompts + [extra]
    # the uninterrupted engines: one of each exporter's config
    ref_eng = handoff_engine(model, dev, **q)
    ref = serve(ref_eng, everyone, n)
    chunked = handoff_engine(model, dev, prefill_chunk_tokens=HANDOFF_CHUNK,
                             **q)
    ref_chunked = serve(chunked, prompts, n)
    sampler = handoff_engine(model, dev, sampling=True, **q)
    ref_sampled = serve(sampler, everyone, n, sampled)
    dst = handoff_engine(model, dev, warm_lens=(), **q)
    # (exporter, importer) an arm: the uninterrupted engines export once
    # their reference run is done, and the sampled one imports
    engines = {"one_shot": (ref_eng, dst), "streamed": (chunked, dst),
               "migration": (ref_eng, dst),
               "sampled_migration": (handoff_engine(
                   model, dev, sampling=True, **q), sampler)}
    ok = True
    for arm in HANDOFF_ARMS:
        src, dst_arm = engines[arm]
        before = [dict(e.counters) for e in (src, dst_arm)]
        reset_launches()                   # the path's run
        torch.cuda.synchronize()
        t_arm = time.perf_counter()
        if arm in ("one_shot", "streamed"):
            outs, line = handoff_arm(arm, src, dst_arm, prompts, n)
            refs = ref if arm == "one_shot" else ref_chunked
            refs = refs[:len(prompts)]
            want = prompts
        else:
            params = greedy if arm == "migration" else sampled
            outs, line = migrate_arm(src, dst_arm, everyone, params, n)
            refs = ref if arm == "migration" else ref_sampled
            want = everyone
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_arm
        launches, expected = handoff_launches((src, dst_arm), before,
                                              f"serve_handoff:{arm}")
        ran = {e: {k: eng.counters[k] - c0[k] for k in (
            "kv_exports", "kv_imports", "kv_stream_exports",
            "migrations_out", "migrations_in", "prefills",
            "prefill_chunks", "prefill_tokens", "steps")}
            for e, eng, c0 in (("a", src, before[0]),
                               ("b", dst_arm, before[1]))}
        tokens, tok_ok = handoff_tokens(
            outs, refs, want, not q and arm == "streamed", card_params, cfg,
            dev)
        line.update(tokens)
        ttft = line.pop("ttft_ms")
        line.update(
            phase="serve_handoff", arm=arm, pools=pools,
            model="gpt2-small", dtype="bfloat16",
            kv_dtype=src.ecfg.kv_dtype, weight_dtype=src.ecfg.weight_dtype,
            card=smi, clocks=card_clocks(), requests=len(want),
            prompt_lens=[len(p) for p in want], max_new_tokens=n,
            wall_s=wall, launches=launches, expected_launches=expected,
            counters=ran,
            ttft_decode_side_ms_p50=p50(ttft),
            pools_at_baseline=all(
                e.allocator.free_pages == e.allocator.num_pages - 1
                for e in (src, dst_arm)))
        arm_ok = tok_ok and line["pools_at_baseline"] \
            and line["corrupt_refused"]
        if arm in ("one_shot", "streamed"):
            line["no_prefill_graph_on_b"] = not any(
                k[0] in ("prefill", "prefill_chunk") for k in dst._programs)
            arm_ok &= line["no_prefill_graph_on_b"]
        else:
            line["migrations_add_up"] = (
                ran["a"]["migrations_out"] == line["items"]
                == ran["b"]["migrations_in"] + line["cold"]
                and line["cold"] == 1 and line["all_futures_open"])
            arm_ok &= line["migrations_add_up"]
        line["ok"] = bool(arm_ok)
        ok &= line["ok"]
        emit(line)
    return ok


def handoff_arm(arm, src, dst, prompts, n):
    """The one-shot or the streamed arm: each prompt exported by ``src``,
    carried as bytes and imported by ``dst`` (at once by
    `import_request`, or through the mailbox by `submit_import` and the
    step that places it), then ``dst`` decodes them to the end. Returns
    the answers in prompt order and the line's timings."""
    times = {k: [] for k in ("export", "pack", "unpack", "import", "place",
                             "ttft")}
    nbytes = tokens = 0
    reqs = []
    for p in prompts:
        t0 = time.perf_counter()
        if arm == "one_shot":
            h = src.prefill_export(p)
            t1 = time.perf_counter()
            blob = h.pack()
            t2 = time.perf_counter()
            back = KVHandoff.unpack(blob)
            t3 = time.perf_counter()
            nbytes += len(blob)
            times["pack"].append((t2 - t1) * 1e3)
            r = dst.import_request(back, max_new_tokens=n)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
        else:
            recs = stream_records_of(src, p)
            t1 = t2 = time.perf_counter()
            back = feed_records(recs)
            t3 = time.perf_counter()
            nbytes += sum(len(rec) for rec in recs)
            r = dst.submit_import(back, max_new_tokens=n)
            t4 = time.perf_counter()
            dst.step()                       # places it
            torch.cuda.synchronize()
            times["place"].append((time.perf_counter() - t4) * 1e3)
        tokens += p.size
        times["export"].append((t1 - t0) * 1e3)
        times["unpack"].append((t3 - t2) * 1e3)
        times["import"].append((t4 - t3) * 1e3)
        times["ttft"].append((r.first_token_t - r.submit_t) * 1e3)
        reqs.append(r)
    # the last prompt's blob, or its first page record, one byte flipped
    corrupt = corrupt_refused(blob, KVHandoff.unpack) if arm == "one_shot" \
        else corrupt_refused(recs[1], lambda bad: feed_records([recs[0],
                                                                 bad]))
    dst.run_until_idle(max_steps=10_000)
    return [r.result(timeout=0) for r in reqs], {
        "export_ms_p50": p50(times["export"]),
        "pack_ms_p50": p50(times["pack"]),
        "unpack_ms_p50": p50(times["unpack"]),
        "import_ms_p50": p50(times["import"]),
        "place_step_ms_p50": p50(times["place"]),
        "blob_bytes_per_token": nbytes / tokens, "ttft_ms": times["ttft"],
        "corrupt_refused": corrupt}


# serve_wire: the serve tier over the wire (`inference/serve.py`), after
# serve_handoff: `serve`'s 8 prompts, 32 new tokens each, four arms and the
# B14 measurement
WIRE_SECRET = "smoke"
WIRE_ENGINE = {"page_size": PS, "max_slots": 8, "prefix_cache": False,
               "inflight": 2}
WIRE_CANCEL_TOKENS = 124      # the 9th request: 900 + 124 fill the table
WIRE_DISCONNECT_LEN = 511     # the 10th request's prompt
WIRE_STEP_DELAY_S = 0.01      # pins the cancel, the disconnect and the drain
WIRE_DRAIN_STEPS = 5
WIRE_DRAIN_DEADLINE_S = 60
B14_RUNS = 3
ROOT = os.path.dirname(os.path.abspath(__file__))


class WireWindow:
    """One arm's window: the port registry's counter deltas and new
    histogram observations since it opened, and the card's clocks at
    both ends."""

    HISTS = ("serve.ttft_seconds", "engine.compile_seconds")

    def __init__(self):
        self.c0 = metrics.snapshot()["counters"]
        self.h0 = {n: metrics.histogram(n).count for n in self.HISTS}
        self.clocks = {"before": card_clocks()}

    def delta(self, name):
        return metrics.snapshot()["counters"].get(name, 0) \
            - self.c0.get(name, 0)

    def observed(self, name):
        h = metrics.histogram(name)
        n = h.count - self.h0[name]
        return list(h._recent)[-n:] if n > 0 else []

    def close(self):
        self.clocks["after"] = card_clocks()
        return self.clocks


def wire_replica(model, dev, warm_lens=SERVE_LENS, role="both", **ecfg):
    """An `InferenceServer` over a new engine of WIRE_ENGINE's settings
    (``ecfg`` on top), warmed on this thread for ``warm_lens`` (None: not
    warmed) before its `serve_loop` starts; it accepts on a thread of its
    own. Returns the server and that thread."""
    eng = DecodeEngine(model, EngineConfig(**{**WIRE_ENGINE, **ecfg}),
                       device=dev)
    if warm_lens is not None:
        eng.warmup(prompt_lens=warm_lens)
        torch.cuda.synchronize()
    srv = InferenceServer(None, engine=eng, auth_name=WIRE_SECRET, role=role)
    accept = threading.Thread(target=srv.serve_forever, daemon=True)
    accept.start()
    return srv, accept


def stop_replica(srv, accept, phase="serve_wire"):
    """Stop the engine thread and the accept loop of a replica."""
    srv._stop.set()
    if srv._engine_thread is not None:
        srv._engine_thread.join(timeout=60)
    srv._sock.close()
    accept.join(timeout=10)
    if accept.is_alive() or (srv._engine_thread is not None
                             and srv._engine_thread.is_alive()):
        raise SystemExit(f"{phase}: a replica's thread did not stop")


def at_baseline(eng):
    return eng.allocator.free_pages == eng.allocator.num_pages - 1


def wait_until(pred, what, timeout=120.0, phase="serve_wire"):
    t_end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > t_end:
            raise SystemExit(f"{phase}: timed out waiting for {what}")
        time.sleep(0.002)


def wire_generate(port, prompts, n, **kw):
    """One client a prompt, all at once: each answer (or the exception it
    raised), each request's wall and the wall of them all."""
    outs, walls = [None] * len(prompts), [None] * len(prompts)

    def one(i):
        t0 = time.perf_counter()
        try:
            cli = RemotePredictor(port=port, secret=WIRE_SECRET,
                                  timeout=600.0)
            outs[i] = cli.generate(prompts[i], max_new_tokens=n, **kw)
            cli.close()
        except Exception as e:  # noqa: BLE001 - gated by the caller
            outs[i] = e
        walls[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise SystemExit("serve_wire: a client hung")
    return outs, walls, time.perf_counter() - t0


def wall_stats(walls):
    qs = statistics.quantiles(walls, n=10, method="inclusive")
    return {"request_wall_ms_p50": statistics.median(walls) * 1e3,
            "request_wall_ms_p90": qs[8] * 1e3}


def timed_reference(eng, prompts, n):
    """``eng``'s answers for ``prompts`` in process, the generated tokens a
    second over that run and its steps."""
    steps = eng.counters["steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = serve(eng, prompts, n)
    torch.cuda.synchronize()
    return (outs, len(prompts) * n / (time.perf_counter() - t0),
            eng.counters["steps"] - steps)


def exact_tokens(outs, refs):
    return [isinstance(o, np.ndarray) and bool(np.array_equal(o, r))
            for o, r in zip(outs, refs)]


def read_line(proc, prefix, timeout, phase="serve_wire"):
    """The first stdout line of ``proc`` that starts with ``prefix``."""
    box = {}

    def reader():
        for line in proc.stdout:
            if line.startswith(prefix):
                box["line"] = line.strip()
                return
    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout)
    if "line" not in box:
        raise SystemExit(f"{phase}: no {prefix} line from the server "
                         f"(exit code {proc.poll()})")
    return box["line"]


def wrong_secret_dropped(port):
    """A connection whose hello carries another secret's digest is dropped
    before any op is read: the PING after it gets no answer."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        sock.sendall(struct.pack("<I", serve_mod.MAGIC)
                     + serve_mod.auth_token("not-" + WIRE_SECRET))
        sock.sendall(struct.pack("<III", serve_mod.MAGIC, serve_mod.OP_PING,
                                 0))
        sock.settimeout(10)
        try:
            return sock.recv(12) == b""
        except ConnectionResetError:
            return True
    finally:
        sock.close()


def cli_launches(stats, nl):
    """The paged kernels' dispatches in the server process (its STATS
    ``kernel.dispatch.*``, graph replays counted) against what its engine
    counters imply, as `engine_launches` holds an in-process engine."""
    c = stats["counters"]
    got = {"paged_decode": c.get("kernel.dispatch.paged_attention.cuda", 0),
           "paged_prefill": c.get(
               "kernel.dispatch.prefill_attention.cuda", 0)}
    # prefix cache off, no chunking: one one-shot prefill a request (the
    # registry keeps no count of prefills, the port's own counter)
    want = {"paged_decode": nl * (c.get("engine.steps", 0)
                                  - c.get("engine.spec_steps", 0)),
            "paged_prefill": nl * (c.get("engine.requests", 0)
                                   + c.get("engine.prefill_chunks", 0))}
    return got, want, got == want and all(v > 0 for v in got.values())


def wire_cli(dev, smi, prompts, serve_tps, workdir):
    """The user's path: GPT-2 small's float32 weights from the seed, saved
    with `framework.io.save`, served by ``python -m
    paddle_tpu_torch.inference.serve`` in a process of its own; its
    tokens against an in-process float32 engine of the same config."""
    n = HANDOFF_NEW_TOKENS
    f32 = host_gpt2_small(generator=torch.Generator().manual_seed(SEED))
    weights = os.path.join(workdir, "gpt2_small.pdparams")
    pio.save(f32, weights)
    cfg_path = os.path.join(workdir, "gpt2_small.json")
    with open(cfg_path, "w") as f:
        json.dump({**dataclasses.asdict(f32.cfg), "weights": weights,
                   "engine": WIRE_ENGINE}, f)
    ref_eng = DecodeEngine(f32, EngineConfig(**WIRE_ENGINE), device=dev)
    ref_eng.warmup(prompt_lens=SERVE_LENS)
    refs, inproc_tps, _ = timed_reference(ref_eng, prompts, n)
    nl = f32.cfg.num_layers
    del ref_eng, f32
    gc.collect()
    torch.cuda.empty_cache()
    win = WireWindow()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    errlog = os.path.join(workdir, "server.err")
    t0 = time.perf_counter()
    with open(errlog, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
             "--gpt-config", cfg_path, "--auth-name", WIRE_SECRET,
             "--port", "0", "--drain-deadline", str(WIRE_DRAIN_DEADLINE_S)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err,
            text=True)
    try:
        port = int(read_line(proc, "LISTENING", 300).split()[1])
        start_s = time.perf_counter() - t0
        first, first_wall, _ = wire_generate(port, prompts[:1], n)
        # the first round captures the other buckets' graphs on the
        # server's serve thread, the second finds them all
        outs, walls, wall = wire_generate(port, prompts, n)
        warm, warm_walls, warm_wall = wire_generate(port, prompts, n)
        cli = RemotePredictor(port=port, secret=WIRE_SECRET, timeout=60.0)
        stats = cli.stats()
        prom = cli.prometheus()
        cli.close()
        dropped = wrong_secret_dropped(port)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=WIRE_DRAIN_DEADLINE_S + 60)
        exit_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    got, want, launches_ok = cli_launches(stats, nl)
    tokens = exact_tokens(first + outs + warm, refs[:1] + refs + refs)
    c = stats["counters"]
    line = {
        "phase": "serve_wire", "arm": "cli", "model": "gpt2-small",
        "dtype": "float32", "card": smi, "requests": len(prompts) + 1,
        "prompt_lens": [len(p) for p in prompts], "max_new_tokens": n,
        "engine": WIRE_ENGINE, "start_to_listening_s": start_s,
        "first_request_wall_s": first_wall[0], **wall_stats(walls),
        "tokens_per_s": len(prompts) * n / wall,
        "warm_round": {**wall_stats(warm_walls),
                       "tokens_per_s": len(prompts) * n / warm_wall},
        "engine_steps": c.get("engine.steps", 0),
        "graph_captures": c.get("engine.compile_count", 0),
        "inproc_tokens_per_s": inproc_tps,
        "serve_decode_tokens_per_s": serve_tps,
        "request_bytes": c.get("serve.request_bytes", 0),
        "response_bytes": c.get("serve.response_bytes", 0),
        "launches": got, "expected_launches": want,
        "tokens_equal": tokens, "wrong_secret_dropped": dropped,
        "exposition_ok": exposition_ok(prom),
        "stats_keys_ok": stats.get("role") == "both"
        and "node" in stats and stats.get("prefix", {}).get("page_size")
        == PS, "sigterm_exit_code": code, "sigterm_exit_s": exit_s,
        "clocks": win.close()}
    line["ok"] = bool(all(tokens) and launches_ok and dropped
                      and line["exposition_ok"] and line["stats_keys_ok"]
                      and code == 0)
    if not line["ok"]:
        with open(errlog) as f:
            line["server_stderr_tail"] = f.read()[-2000:]
    emit(line)
    return line["ok"]


def wire_inproc(model, dev, smi, prompts, refs, inproc_tps, inproc_steps,
                serve_tps):
    """`InferenceServer` over a bf16 engine in this process: 8 concurrent
    clients; then, under WIRE_STEP_DELAY_S steps, a 9th request (the
    900-token prompt, WIRE_CANCEL_TOKENS new tokens, a cancel tag)
    cancelled by the CANCEL op from another connection, and a 10th whose
    client disconnects mid-decode."""
    n = HANDOFF_NEW_TOKENS
    srv, accept = wire_replica(model, dev)
    eng = srv._engine
    before = [dict(eng.counters)]
    win = WireWindow()
    reset_launches()                       # the path's run
    outs, walls, wall = wire_generate(srv.port, prompts, n)
    steps_8 = eng.counters["steps"] - before[0]["steps"]
    tokens = exact_tokens(outs, refs)
    long_p = prompts[SERVE_LENS.index(900)]
    mid_p = prompts[SERVE_LENS.index(WIRE_DISCONNECT_LEN)]
    res = {}
    victim = RemotePredictor(port=srv.port, secret=WIRE_SECRET,
                             timeout=600.0)

    def cancelled():
        res["cancelled"] = wire_generate(srv.port, [long_p],
                                         WIRE_CANCEL_TOKENS,
                                         tag="wire-cancel")[0][0]

    def disconnected():
        try:
            res["disconnected"] = victim.generate(
                mid_p, max_new_tokens=WIRE_CANCEL_TOKENS)
        except Exception as e:  # noqa: BLE001 - the expected outcome
            res["disconnected"] = e

    def live(pred):
        return any(r is not None and len(r.generated) >= 2 and pred(r)
                   for r in eng._slot_req)

    with faults.scoped("engine.step_delay", times=-1,
                       delay_s=WIRE_STEP_DELAY_S):
        ths = [threading.Thread(target=f) for f in (cancelled, disconnected)]
        for t in ths:
            t.start()
        wait_until(lambda: b"wire-cancel" in srv._tags
                   and live(lambda r: r.request_id
                            == srv._tags.get(b"wire-cancel")),
                   "the 9th request mid-decode")
        ctl = RemotePredictor(port=srv.port, secret=WIRE_SECRET)
        hit = ctl.cancel("wire-cancel")
        ctl.close()
        wait_until(lambda: live(lambda r: r.prompt.size
                                == WIRE_DISCONNECT_LEN),
                   "the 10th request mid-decode")
        victim._sock.shutdown(socket.SHUT_RDWR)
        victim._sock.close()
        for t in ths:
            t.join(timeout=120)
        wait_until(lambda: not eng._has_work(), "the engine idle")
    torch.cuda.synchronize()
    launches, expected = handoff_launches((eng,), before,
                                          "serve_wire:inproc")
    line = {
        "phase": "serve_wire", "arm": "inproc", "model": "gpt2-small",
        "dtype": "bfloat16", "card": smi, "requests": len(prompts) + 2,
        "prompt_lens": [len(p) for p in prompts], "max_new_tokens": n,
        "engine": WIRE_ENGINE, **wall_stats(walls),
        "tokens_per_s": len(prompts) * n / wall,
        "engine_steps_8": steps_8, "inproc_engine_steps": inproc_steps,
        "inproc_tokens_per_s": inproc_tps,
        "serve_decode_tokens_per_s": serve_tps,
        "request_bytes": win.delta("serve.request_bytes"),
        "response_bytes": win.delta("serve.response_bytes"),
        "ttft_ms_p50": p50([v * 1e3 for v in win.observed(
            "serve.ttft_seconds")]),
        "launches": launches, "expected_launches": expected,
        "tokens_equal": tokens, "cancel_hit": hit,
        "cancelled_typed": isinstance(res.get("cancelled"), Cancelled),
        "disconnected_raised": isinstance(res.get("disconnected"),
                                          Exception),
        "disconnect_cancels": win.delta("serve.disconnect_cancels"),
        "cancels": win.delta("serve.cancels"),
        "pool_at_baseline": at_baseline(eng), "clocks": win.close()}
    stop_replica(srv, accept)
    line["ok"] = bool(all(tokens) and hit and line["cancelled_typed"]
                      and line["disconnected_raised"]
                      and line["disconnect_cancels"] == 1
                      and line["pool_at_baseline"])
    emit(line)
    return line


def wire_migrate(model, dev, smi, prompts, refs, serve_tps):
    """Replicas A and B; 8 clients generate on A; after A's
    WIRE_DRAIN_STEPS-th step, with every request mid-decode,
    ``A.drain(migrate_peers=[B])`` ships them over OP_MIGRATE."""
    n = HANDOFF_NEW_TOKENS
    a, a_acc = wire_replica(model, dev)
    b, b_acc = wire_replica(model, dev, warm_lens=())
    engines = (a._engine, b._engine)
    before = [dict(e.counters) for e in engines]
    win = WireWindow()
    pack_ms = []
    packer = serve_mod.pack_migration

    def timed_pack(item):
        t0 = time.perf_counter()
        blob = packer(item)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        return blob

    reset_launches()                       # the path's run
    box = {}
    clients = threading.Thread(target=lambda: box.update(
        r=wire_generate(a.port, prompts, n)))
    serve_mod.pack_migration = timed_pack
    try:
        with faults.scoped("engine.step_delay", times=-1,
                           delay_s=WIRE_STEP_DELAY_S):
            s0 = a._engine.step_seq
            clients.start()
            wait_until(lambda: a._engine.step_seq - s0 >= WIRE_DRAIN_STEPS
                       and sum(r is not None and len(r.generated) >= 2
                               for r in a._engine._slot_req)
                       == len(prompts), "8 requests mid-decode on A")
            drain_step = a._engine.step_seq - s0
            t0 = time.perf_counter()
            clean = a.drain(deadline_s=WIRE_DRAIN_DEADLINE_S,
                            migrate_peers=[f"127.0.0.1:{b.port}"])
            drain_s = time.perf_counter() - t0
            clients.join(timeout=600)
            wait_until(lambda: not b._engine._has_work(), "B idle")
    finally:
        serve_mod.pack_migration = packer
    torch.cuda.synchronize()
    outs, walls, wall = box["r"]
    tokens = exact_tokens(outs, refs)
    errors = [f"{type(o).__name__}: {o}" for o in outs
              if isinstance(o, Exception)]
    launches, expected = handoff_launches(engines, before,
                                          "serve_wire:migrate")
    moved = {k: win.delta(k) for k in ("serve.migrations_out",
                                       "serve.migrations_in")}
    warm = b._engine.counters["migrations_in"] - before[1]["migrations_in"]
    line = {
        "phase": "serve_wire", "arm": "migrate", "model": "gpt2-small",
        "dtype": "bfloat16", "card": smi, "requests": len(prompts),
        "prompt_lens": [len(p) for p in prompts], "max_new_tokens": n,
        "engine": WIRE_ENGINE, "step_delay_s": WIRE_STEP_DELAY_S,
        "drain_after_steps": drain_step, **wall_stats(walls),
        "tokens_per_s": len(prompts) * n / wall,
        "serve_decode_tokens_per_s": serve_tps,
        "drain_wall_ms": drain_s * 1e3, "drain_clean": clean,
        "pack_ms_per_item": pack_ms, "pack_ms_p50": p50(pack_ms),
        "request_bytes": win.delta("serve.request_bytes"),
        "response_bytes": win.delta("serve.response_bytes"),
        "launches": launches, "expected_launches": expected,
        "tokens_equal": tokens, "client_errors": errors, **moved,
        "warm_items": warm,
        "pools_at_baseline": [at_baseline(e) for e in engines],
        "clocks": win.close()}
    stop_replica(b, b_acc)
    a_acc.join(timeout=10)
    line["ok"] = bool(all(tokens) and clean and not errors
                      and moved["serve.migrations_out"]
                      == moved["serve.migrations_in"] == warm
                      == len(prompts) and all(line["pools_at_baseline"]))
    emit(line)
    return line["ok"]


def relay_stream(p_port, d_port, prompt, n):
    """The router's two-phase flow by hand: OP_PREFILL to the prefill
    worker, each PTKS1 record relayed to the decode replica's OP_KV_STREAM
    as it arrives. Returns the decode replica's answer, the stream's wall
    (request to last record) and the request's wall."""
    def authed(port):
        sock = socket.create_connection(("127.0.0.1", port), timeout=600)
        sock.sendall(struct.pack("<I", serve_mod.MAGIC)
                     + serve_mod.auth_token(WIRE_SECRET))
        return sock

    t0 = time.perf_counter()
    ps, ds = authed(p_port), authed(d_port)
    try:
        ps.sendall(struct.pack("<III", serve_mod.MAGIC, serve_mod.OP_PREFILL,
                               2))
        serve_mod.send_arrays(ps, [prompt, np.asarray([1], np.int32)])
        magic, status, n_rec = struct.unpack("<III",
                                             serve_mod._recv_exact(ps, 12))
        if status != 0:
            raise serve_mod.from_wire(
                serve_mod._recv_exact(ps, n_rec).decode())
        ds.sendall(struct.pack("<III", serve_mod.MAGIC,
                               serve_mod.OP_KV_STREAM, 2 + n_rec))
        serve_mod.send_arrays(ds, [np.asarray([n, 1, 1, 0], np.int32),
                                   np.zeros(0, np.uint8)])
        for _ in range(n_rec):
            serve_mod.send_arrays(ds, serve_mod.recv_arrays(ps, 1))
        stream_s = time.perf_counter() - t0
        magic, status, m = struct.unpack("<III",
                                         serve_mod._recv_exact(ds, 12))
        if status != 0:
            raise serve_mod.from_wire(serve_mod._recv_exact(ds, m).decode())
        (out,) = serve_mod.recv_arrays(ds, m)
        return out, stream_s, time.perf_counter() - t0
    finally:
        ps.close()
        ds.close()


def wire_disagg(model, dev, smi, prompts, card_params, serve_tps):
    """A ``role="prefill"`` replica (HANDOFF_CHUNK-token chunks) and a
    ``role="decode"`` one; each prompt's OP_PREFILL records relayed by
    hand to OP_KV_STREAM, all 8 at once. Tokens against a bf16 engine of
    the prefill worker's chunking (a bf16 difference within
    `serve_bf16_parity`'s margin is C11's)."""
    n = HANDOFF_NEW_TOKENS
    chunked = handoff_engine(model, dev, prefill_chunk_tokens=HANDOFF_CHUNK)
    refs = serve(chunked, prompts, n)
    del chunked
    torch.cuda.empty_cache()
    pf, pf_acc = wire_replica(model, dev, warm_lens=(HANDOFF_CHUNK + 1,),
                              role="prefill",
                              prefill_chunk_tokens=HANDOFF_CHUNK)
    dc, dc_acc = wire_replica(model, dev, warm_lens=(), role="decode")
    engines = (pf._engine, dc._engine)
    before = [dict(e.counters) for e in engines]
    win = WireWindow()
    reset_launches()                       # the path's run
    outs = [None] * len(prompts)
    times = [None] * len(prompts)

    def one(i):
        try:
            out, stream_s, wall_s = relay_stream(pf.port, dc.port,
                                                 prompts[i], n)
            outs[i], times[i] = out, (stream_s, wall_s)
        except Exception as e:  # noqa: BLE001 - gated below
            outs[i], times[i] = e, (0.0, 0.0)
    ths = [threading.Thread(target=one, args=(i,))
           for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    wait_until(lambda: not dc._engine._has_work(), "the decode side idle")
    torch.cuda.synchronize()
    launches, expected = handoff_launches(engines, before,
                                          "serve_wire:disagg")
    errors = [f"{type(o).__name__}: {o}" for o in outs
              if isinstance(o, Exception)]
    if errors:
        tokens, tok_ok = {"tokens_equal": exact_tokens(outs, refs)}, False
    else:
        tokens, tok_ok = handoff_tokens(outs, refs, prompts, True,
                                        card_params, model.cfg, dev)
    line = {
        "phase": "serve_wire", "arm": "disagg", "model": "gpt2-small",
        "dtype": "bfloat16", "card": smi, "requests": len(prompts),
        "prompt_lens": [len(p) for p in prompts], "max_new_tokens": n,
        "prefill_chunk_tokens": HANDOFF_CHUNK, "engine": WIRE_ENGINE,
        **wall_stats([t[1] for t in times]),
        "stream_wall_ms_p50": p50([t[0] * 1e3 for t in times]),
        "ttft_decode_side_ms_p50": p50([v * 1e3 for v in win.observed(
            "serve.ttft_seconds")]),
        "tokens_per_s": len(prompts) * n / wall,
        "serve_decode_tokens_per_s": serve_tps,
        "request_bytes": win.delta("serve.request_bytes"),
        "response_bytes": win.delta("serve.response_bytes"),
        "launches": launches, "expected_launches": expected, **tokens,
        "errors": errors,
        "no_prefill_graph_on_decode": not any(
            k[0] in ("prefill", "prefill_chunk")
            for k in dc._engine._programs),
        "pools_at_baseline": [at_baseline(e) for e in engines],
        "kv_stream_in": win.delta("serve.kv_stream_in"),
        "prefill_streams": win.delta("serve.prefill_streams"),
        "clocks": win.close()}
    for srv, acc in ((pf, pf_acc), (dc, dc_acc)):
        stop_replica(srv, acc)
    line["ok"] = bool(tok_ok and not errors
                      and line["no_prefill_graph_on_decode"]
                      and all(line["pools_at_baseline"])
                      and line["kv_stream_in"] == line["prefill_streams"]
                      == len(prompts))
    emit(line)
    return line["ok"]


def capture_seconds(run):
    """``{program key: seconds}`` of each graph capture ``run`` makes
    (the ``engine.compile_start`` events in order beside the
    ``engine.compile_seconds`` observations)."""
    evs = flight.events()
    seq0 = evs[-1]["seq"] if evs else 0
    win = WireWindow()
    run()
    torch.cuda.synchronize()
    keys = [e["program"] for e in flight.events()
            if e["seq"] > seq0 and e["kind"] == "engine.compile_start"]
    return dict(zip(keys, win.observed("engine.compile_seconds")))


def wire_b14(model, dev, smi, prompts):
    """ROADMAP B14: each capture's seconds on the serve thread of a fresh
    `InferenceServer` (no warm-up; 8 clients at once, 2 new tokens each;
    then the 8 requests one after another, so no other thread of this
    process is busy during a capture) and on the building thread of an
    engine warmed for SERVE_LENS before it is served, B14_RUNS times each.
    A measurement, no gate."""
    runs = {"serve_thread": [], "serve_thread_one_client": [],
            "building_thread": []}
    clocks = {"before": card_clocks()}
    for _ in range(B14_RUNS):
        srv, acc = wire_replica(model, dev, warm_lens=None)
        runs["serve_thread"].append(capture_seconds(
            lambda: wire_generate(srv.port, prompts, 2)))
        stop_replica(srv, acc)
        srv, acc = wire_replica(model, dev, warm_lens=None)
        runs["serve_thread_one_client"].append(capture_seconds(
            lambda: [wire_generate(srv.port, [p], 2) for p in prompts]))
        stop_replica(srv, acc)
        eng = DecodeEngine(model, EngineConfig(**WIRE_ENGINE), device=dev)
        runs["building_thread"].append(capture_seconds(
            lambda: eng.warmup(prompt_lens=SERVE_LENS)))
        del eng, srv
        gc.collect()
        torch.cuda.empty_cache()
    clocks["after"] = card_clocks()
    emit({"phase": "serve_wire", "arm": "b14", "model": "gpt2-small",
          "dtype": "bfloat16", "card": smi, "engine": WIRE_ENGINE,
          **runs, **{f"{k}_total_s": [sum(r.values()) for r in v]
                     for k, v in runs.items()},
          "clocks": clocks})


def serve_wire(model, dev, smi, serve_line):
    """The serve tier on the card (`inference/serve.py`): arms ``cli``
    (float32, the CLI in a process of its own), ``inproc``, ``migrate``
    and ``disagg`` (bf16 ``model``), then B14's captures. Every answered
    request's tokens equal an in-process engine's of the same config and
    weights; see each arm for its other gates."""
    rng = np.random.default_rng(SEED + 2)          # serve_engine's prompts
    prompts = [rng.integers(0, min(VOCAB, model.cfg.vocab_size), n)
               .astype(np.int32) for n in SERVE_LENS]
    serve_tps = serve_line["decode_tokens_per_s"]
    card_params = {k: v.to(dev) for k, v in torch_state(model).items()}
    ok = True
    with tempfile.TemporaryDirectory() as workdir:
        ok &= wire_cli(dev, smi, prompts, serve_tps, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    ref_eng = handoff_engine(model, dev)
    refs, inproc_tps, inproc_steps = timed_reference(ref_eng, prompts,
                                                     HANDOFF_NEW_TOKENS)
    del ref_eng
    torch.cuda.empty_cache()
    inproc = wire_inproc(model, dev, smi, prompts, refs, inproc_tps,
                         inproc_steps, serve_tps)
    ok &= inproc["ok"]
    ok &= wire_migrate(model, dev, smi, prompts, refs, serve_tps)
    ok &= wire_disagg(model, dev, smi, prompts, card_params, serve_tps)
    gc.collect()
    torch.cuda.empty_cache()
    wire_b14(model, dev, smi, prompts)
    if not ok:
        raise SystemExit("serve_wire: tokens unlike the in-process "
                         "engine's, a request not ended typed, a pool off "
                         "its baseline, migration counts that do not add "
                         "up, a prefill graph on the decode replica, a "
                         "wrong secret answered, bad exposition or STATS, "
                         "inexact launches or a non-zero exit on SIGTERM")
    return {"prompts": prompts, "refs": refs, "inproc_tps": inproc_tps,
            "inproc": {k: inproc[k] for k in (
                "request_wall_ms_p50", "request_wall_ms_p90",
                "tokens_per_s", "ttft_ms_p50")}}


# serve_router: the port's router (`serving/router.py`) and autoscaler
# (`serving/autoscale.py`) in front of `wire_replica`s on this card
ROUTER_POLICIES = ("round_robin", "least_outstanding")
ROUTER_POLL_S = 0.2              # the registry poll of the failover arm
ROUTER_STEP_DELAY_S = 0.01       # holds requests in flight (every engine)
AUTOSCALE_CLIENTS = 16
AUTOSCALE_SHARE = 8              # requests the spawned replica serves first
AUTOSCALE_LONG = (7, 64)         # in flight at the scale-down (SERVE_LENS)
AUTOSCALE_LONG_TOKENS = 124


def endpoint(srv):
    return f"127.0.0.1:{srv.port}"


def start_router(replicas=None, registry=None, **kw):
    """A port `Router` in front of static ``replicas`` and / or a
    ``registry``, accepting on a thread of its own; WIRE_SECRET is both
    the fleet's secret and its clients'."""
    router = Router(registry=registry, replicas=replicas,
                    auth_name=WIRE_SECRET, replica_secret=WIRE_SECRET, **kw)
    accept = threading.Thread(target=router.serve_forever, daemon=True)
    accept.start()
    return router, accept


def stop_router(router, accept):
    """Stop a router and join its accept, poll, probe and stats threads."""
    router.stop()
    threads = (accept, router._poll_thread, router._probe_thread,
               router._stats_thread)
    for t in threads:
        t.join(timeout=10)
    if any(t.is_alive() for t in threads):
        raise SystemExit("serve_router: a router's thread did not stop")


def counter_delta(c0, name):
    return metrics.snapshot()["counters"].get(name, 0) - c0.get(name, 0)


def shares(c0, ids):
    """Each replica's routed requests since the counters ``c0``."""
    return {rid: counter_delta(c0, f"router.replica_requests{{replica={rid}}}")
            for rid in ids}


def launch_check(engines, before):
    """The kernels' launches since `reset_launches`, what the steps of
    ``engines`` imply (`steps_launches`) and whether they agree exactly.
    Unlike `read_launches` it does not raise: the arm's line prints
    first."""
    want = steps_launches(engines, before)
    got = {k.source: k.launches for k in _build.kernels()}
    ok = bool(want) and all(n == want.get(k, 0) for k, n in got.items())
    return {k: n for k, n in got.items() if n or k in want}, want, ok


def token_record(outs, refs):
    """How many answers equal their reference, the client errors, and
    each request's equality only when one differs."""
    eq = exact_tokens(outs, refs)
    rec = {"tokens_equal": f"{sum(eq)}/{len(eq)}",
           "client_errors": [f"{type(o).__name__}: {o}" for o in outs
                             if isinstance(o, Exception)]}
    if not all(eq):
        rec["tokens_equal_each"] = eq
    return rec, all(eq)


def wait_idle(engines):
    wait_until(lambda: not any(e._has_work() for e in engines),
               "the replicas idle", phase="serve_router")
    torch.cuda.synchronize()


def router_routed(model, dev, smi, wire):
    """Two replicas behind a router, `serve`'s 8 prompts at once through a
    `RemotePredictor` on the router, once a policy of ROUTER_POLICIES
    (a router each); first the same 8 straight to the replicas (``direct``,
    round_robin's split). Beside them, `serve_wire`'s ``inproc`` figures
    (one replica)."""
    prompts, refs, n = wire["prompts"], wire["refs"], HANDOFF_NEW_TOKENS
    reps = [wire_replica(model, dev) for _ in range(2)]
    engines = [srv._engine for srv, _ in reps]
    before = [dict(e.counters) for e in engines]
    ids = {f"r{i}": endpoint(srv) for i, (srv, _) in enumerate(reps)}
    win = WireWindow()
    reset_launches()                       # the path's run
    # the same split as round_robin's, each client straight to its
    # replica: what two replicas on one card cost without the router
    box = {}
    direct = [threading.Thread(target=lambda i=i, port=srv.port: box.update(
        {i: wire_generate(port, prompts[i::2], n)}))
        for i, (srv, _) in enumerate(reps)]
    t0 = time.perf_counter()
    for t in direct:
        t.start()
    for t in direct:
        t.join(timeout=600)
    d_wall = time.perf_counter() - t0
    d_toks, d_ok = token_record(box[0][0] + box[1][0],
                                refs[0::2] + refs[1::2])
    per = {"direct": {**wall_stats(box[0][1] + box[1][1]),
                      "tokens_per_s": len(prompts) * n / d_wall, **d_toks}}
    ok = d_ok and not d_toks["client_errors"]
    for policy in ROUTER_POLICIES:
        router, acc = start_router(replicas=ids, policy=policy)
        c0 = metrics.snapshot()["counters"]
        outs, walls, wall = wire_generate(router.port, prompts, n)
        stop_router(router, acc)
        toks, tok_ok = token_record(outs, refs)
        share = shares(c0, ids)
        per[policy] = {**wall_stats(walls),
                       "tokens_per_s": len(prompts) * n / wall, **toks,
                       "replica_requests": share}
        ok &= tok_ok and not toks["client_errors"] \
            and all(v >= 1 for v in share.values())
    wait_idle(engines)
    launches, want, l_ok = launch_check(engines, before)
    inproc = wire["inproc"]
    line = {"phase": "serve_router", "arm": "routed", "model": "gpt2-small",
            "dtype": "bfloat16", "card": smi, "requests": len(prompts),
            "max_new_tokens": n, "engine": WIRE_ENGINE, "replicas": 2,
            **per, "serve_wire_inproc": inproc,
            "inproc_tokens_per_s": wire["inproc_tps"],
            "added_wall_ms_p50": {p: per[p]["request_wall_ms_p50"]
                                  - inproc["request_wall_ms_p50"]
                                  for p in per},
            "router_hop_ms_p50": {p: per[p]["request_wall_ms_p50"]
                                  - per["direct"]["request_wall_ms_p50"]
                                  for p in ROUTER_POLICIES},
            "launches": launches, "expected_launches": want,
            "pools_at_baseline": [at_baseline(e) for e in engines],
            "clocks": win.close()}
    for srv, acc in reps:
        stop_replica(srv, acc, "serve_router")
    line["ok"] = bool(ok and l_ok and all(line["pools_at_baseline"]))
    emit(line)
    return line["ok"]


def router_failover(model, dev, smi, wire, workdir):
    """Replicas r0 and r1 behind a router that also watches a node
    registry; the 8 prompts at once under ROUTER_STEP_DELAY_S steps (the
    fault site is the process's, so both replicas step slowly), r0 stopped
    hard with requests mid-decode on it. Then r2 registers and the 8
    prompts go again."""
    prompts, refs, n = wire["prompts"], wire["refs"], HANDOFF_NEW_TOKENS
    a, a_acc = wire_replica(model, dev)
    b, b_acc = wire_replica(model, dev)
    engines = [a._engine, b._engine]
    before = [dict(e.counters) for e in engines]
    reg_dir = os.path.join(workdir, "registry")
    router, r_acc = start_router(
        replicas={"r0": endpoint(a), "r1": endpoint(b)},
        registry=NodeRegistry(reg_dir), poll_interval_s=ROUTER_POLL_S,
        connect_deadline_s=1.0, evict_cooldown_s=600.0)
    win = WireWindow()
    c0 = metrics.snapshot()["counters"]
    reset_launches()                       # the path's run
    box = {}
    clients = threading.Thread(target=lambda: box.update(
        r=wire_generate(router.port, prompts, n)))
    with faults.scoped("engine.step_delay", times=-1,
                       delay_s=ROUTER_STEP_DELAY_S):
        clients.start()
        wait_until(lambda: sum(r is not None and len(r.generated) >= 2
                               for r in a._engine._slot_req) >= 2,
                   "requests mid-decode on r0", phase="serve_router")
        in_flight = sum(r is not None for r in a._engine._slot_req)
        stop_replica(a, a_acc, "serve_router")
        clients.join(timeout=600)
    outs, walls, wall = box["r"]
    toks, tok_ok = token_record(outs, refs)
    breaker = router._replicas["r0"].breaker
    resubmits = counter_delta(c0, "router.resubmits")
    # the replacement: registered in the registry, routed on the next poll
    c, c_acc = wire_replica(model, dev)
    engines.append(c._engine)
    before.append(dict(c._engine.counters))
    t0 = time.perf_counter()
    lease = NodeRegistry(reg_dir, "r2", endpoint(c), ttl=30.0,
                         heartbeat_interval=0.5).register()
    wait_until(lambda: "r2" in router.replica_ids(healthy_only=True),
               "r2 in the rotation", phase="serve_router")
    join_s = time.perf_counter() - t0
    c1 = metrics.snapshot()["counters"]
    outs2, walls2, wall2 = wire_generate(router.port, prompts, n)
    toks2, tok2_ok = token_record(outs2, refs)
    share2 = shares(c1, ("r1", "r2"))
    lease.leave()
    stop_router(router, r_acc)
    wait_idle(engines[1:])
    launches, want, l_ok = launch_check(engines, before)
    line = {"phase": "serve_router", "arm": "failover",
            "model": "gpt2-small", "dtype": "bfloat16", "card": smi,
            "requests": len(prompts), "max_new_tokens": n,
            "step_delay_s": ROUTER_STEP_DELAY_S,
            "in_flight_on_r0_at_stop": in_flight, **wall_stats(walls),
            "tokens_per_s": len(prompts) * n / wall, **toks,
            "resubmits": resubmits, "r0_breaker": breaker,
            "replica_errors": counter_delta(c0, "router.replica_errors"),
            "replacement": {"register_to_rotation_s": join_s,
                            **wall_stats(walls2),
                            "tokens_per_s": len(prompts) * n / wall2,
                            **toks2, "replica_requests": share2},
            "launches": launches, "expected_launches": want,
            "pools_at_baseline": [at_baseline(e) for e in engines[1:]],
            "clocks": win.close()}
    for srv, acc in ((b, b_acc), (c, c_acc)):
        stop_replica(srv, acc, "serve_router")
    line["ok"] = bool(tok_ok and tok2_ok and not toks["client_errors"]
                      and not toks2["client_errors"] and resubmits >= 1
                      and breaker == "open" and share2["r2"] >= 1
                      and l_ok and all(line["pools_at_baseline"]))
    emit(line)
    return line["ok"]


def router_disagg(model, dev, smi, wire, workdir):
    """Two ``role="prefill"`` replicas (prefix cache on, HANDOFF_CHUNK-token
    chunks) and one ``role="decode"`` replica, all registered in a node
    registry that the router watches; `serve_prefix`'s 8 prompts (one
    PREFIX_SYSTEM-token system prompt), the first alone, then the other 7
    at once: the router's two-phase flow with prefix affinity."""
    n = HANDOFF_NEW_TOKENS
    _, prompts = prefix_prompts(np.random.default_rng(SEED + 6),
                                model.cfg.vocab_size, PREFIX_SYSTEM,
                                PREFIX_SUFFIXES)
    chunked = handoff_engine(model, dev, prefill_chunk_tokens=HANDOFF_CHUNK)
    refs = serve(chunked, prompts, n)
    del chunked
    torch.cuda.empty_cache()
    pfs = [wire_replica(model, dev, warm_lens=(HANDOFF_CHUNK + 1,),
                        role="prefill", prefill_chunk_tokens=HANDOFF_CHUNK,
                        prefix_cache=True) for _ in range(2)]
    dc, dc_acc = wire_replica(model, dev, warm_lens=(), role="decode")
    engines = [srv._engine for srv, _ in pfs] + [dc._engine]
    before = [dict(e.counters) for e in engines]
    reg_dir = os.path.join(workdir, "disagg_registry")
    leases = [NodeRegistry(reg_dir, rid, endpoint(srv), ttl=30.0,
                           heartbeat_interval=0.5).register()
              for rid, srv in (("prefill:p0", pfs[0][0]),
                               ("prefill:p1", pfs[1][0]),
                               ("decode:d0", dc))]
    # the first STATS pull of every replica (roles, page size, the
    # workers' empty prefix exports) lands before the first request, the
    # next ones seconds later: a pull that predates the first request's
    # prefill cannot land after the router registers its pages
    router, r_acc = start_router(registry=NodeRegistry(reg_dir),
                                 page_size=PS)
    wait_until(lambda: len(router.replica_ids()) == 3 and all(
        r.stats is not None for r in router._replicas.values()),
        "the router's first STATS pull", phase="serve_router")
    win = WireWindow()
    c0 = metrics.snapshot()["counters"]
    reset_launches()                       # the path's run
    first, first_walls, _ = wire_generate(router.port, prompts[:1], n)
    h_ttft = metrics.histogram("serve.ttft_seconds").count
    rest, walls, wall = wire_generate(router.port, prompts[1:], n)
    wait_idle(engines)
    ttft = win.observed("serve.ttft_seconds")
    n_aff = metrics.histogram("serve.ttft_seconds").count - h_ttft
    outs = first + rest
    launches, want, l_ok = launch_check(engines, before)
    errors = [f"{type(o).__name__}: {o}" for o in outs
              if isinstance(o, Exception)]
    if errors:
        tokens, tok_ok = {"tokens_equal": exact_tokens(outs, refs)}, False
    else:
        tokens, tok_ok = handoff_tokens(outs, refs, prompts, True,
                                        wire["card_params"], model.cfg, dev)
        tokens["tokens_equal"] = f"{sum(tokens['tokens_equal'])}/" \
                                 f"{len(outs)}"
    computed = [e.counters["prefill_tokens"] - c["prefill_tokens"]
                for e, c in zip(engines[:2], before[:2])]
    once = len(prompts[0]) + sum(len(p) - PREFIX_SYSTEM for p in prompts[1:])
    line = {"phase": "serve_router", "arm": "disagg", "model": "gpt2-small",
            "dtype": "bfloat16", "card": smi, "requests": len(prompts),
            "system_len": PREFIX_SYSTEM, "suffixes": list(PREFIX_SUFFIXES),
            "max_new_tokens": n, "prefill_chunk_tokens": HANDOFF_CHUNK,
            "first_request_wall_ms": first_walls[0] * 1e3,
            "affinity_round": {**wall_stats(walls),
                               "tokens_per_s": len(rest) * n / wall,
                               "ttft_decode_side_ms_p50": p50(
                                   [v * 1e3 for v in ttft[-n_aff:]])
                               if n_aff else None},
            "prefill_tokens_computed": computed,
            "prefill_tokens_once_fleet_wide": once,
            "prefill_tokens_without_affinity": sum(len(p) for p in prompts),
            **{k.split(".", 1)[1]: counter_delta(c0, k) for k in (
                "router.affinity_hits", "router.affinity_misses",
                "router.disagg_requests", "router.disagg_fallbacks",
                "serve.kv_stream_in", "serve.prefill_streams")},
            **tokens, "errors": errors,
            "no_prefill_graph_on_decode": not any(
                k[0] in ("prefill", "prefill_chunk")
                for k in dc._engine._programs),
            "launches": launches, "expected_launches": want,
            "pools_at_baseline": [at_baseline(e) for e in engines],
            "clocks": win.close()}
    stop_router(router, r_acc)
    for lease in leases:
        lease.leave()
    for srv, acc in pfs + [(dc, dc_acc)]:
        stop_replica(srv, acc, "serve_router")
    line["ok"] = bool(tok_ok and not errors and l_ok
                      and sum(computed) == once
                      and line["affinity_hits"] == len(prompts) - 1
                      and line["affinity_misses"] == 1
                      and line["disagg_fallbacks"] == 0
                      and line["kv_stream_in"] == line["prefill_streams"]
                      == len(prompts)
                      and line["no_prefill_graph_on_decode"]
                      and all(line["pools_at_baseline"]))
    emit(line)
    return line["ok"]


def router_cli(model, dev, smi, wire, workdir):
    """``python -m paddle_tpu_torch.serving.router`` in a process of its
    own (``--replica`` twice, ``--policy least_outstanding``) in front of
    two replicas here: `serve`'s 8 prompts at once, STATS and PROMETHEUS
    through it, then SIGTERM."""
    prompts, refs, n = wire["prompts"], wire["refs"], HANDOFF_NEW_TOKENS
    reps = [wire_replica(model, dev) for _ in range(2)]
    engines = [srv._engine for srv, _ in reps]
    before = [dict(e.counters) for e in engines]
    argv = [sys.executable, "-m", "paddle_tpu_torch.serving.router",
            "--port", "0", "--auth-name", WIRE_SECRET, "--replica-secret",
            WIRE_SECRET, "--policy", "least_outstanding"]
    for i, (srv, _) in enumerate(reps):
        argv += ["--replica", f"r{i}={endpoint(srv)}"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    errlog = os.path.join(workdir, "router.err")
    win = WireWindow()
    reset_launches()                       # the path's run
    t0 = time.perf_counter()
    with open(errlog, "w") as err:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
    try:
        port = int(read_line(proc, "LISTENING", 120,
                             "serve_router").split()[1])
        start_s = time.perf_counter() - t0
        outs, walls, wall = wire_generate(port, prompts, n)
        cli = RemotePredictor(port=port, secret=WIRE_SECRET, timeout=60.0)
        stats = cli.stats()
        prom = cli.prometheus()
        cli.close()
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
        exit_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    wait_idle(engines)
    launches, want, l_ok = launch_check(engines, before)
    toks, tok_ok = token_record(outs, refs)
    c = stats.get("counters", {})
    share = {f"r{i}": c.get(f"router.replica_requests{{replica=r{i}}}", 0)
             for i in range(len(reps))}
    line = {"phase": "serve_router", "arm": "cli", "model": "gpt2-small",
            "dtype": "bfloat16", "card": smi, "requests": len(prompts),
            "max_new_tokens": n, "policy": "least_outstanding",
            "start_to_listening_s": start_s, **wall_stats(walls),
            "tokens_per_s": len(prompts) * n / wall, **toks,
            "stats_role": stats.get("role"),
            "router_requests": c.get("router.requests", 0),
            "replica_requests": share,
            "exposition_ok": exposition_ok(prom)
            and "router_requests" in prom,
            "sigterm_exit_code": code, "sigterm_exit_s": exit_s,
            "launches": launches, "expected_launches": want,
            "pools_at_baseline": [at_baseline(e) for e in engines],
            "clocks": win.close()}
    for srv, acc in reps:
        stop_replica(srv, acc, "serve_router")
    line["ok"] = bool(tok_ok and not toks["client_errors"] and l_ok
                      and line["stats_role"] == "router"
                      and line["router_requests"] == len(prompts)
                      and all(v >= 1 for v in share.values())
                      and line["exposition_ok"] and code == 0
                      and all(line["pools_at_baseline"]))
    if not line["ok"]:
        with open(errlog) as f:
            line["router_stderr_tail"] = f.read()[-2000:]
    emit(line)
    return line["ok"]


def router_autoscale(model, dev, smi, wire):
    """An `Autoscaler` over a router with one seed replica; its
    `CallbackLauncher` spawns a warmed replica on this card and drains one
    by migration to its peer. `tick()` by hand: under AUTOSCALE_CLIENTS
    clients of sustained load (each `serve`'s prompts in turn) one tick
    scales 1 -> 2; after the spawned replica served AUTOSCALE_SHARE
    requests the load stops, one AUTOSCALE_LONG request lands on each
    replica under ROUTER_STEP_DELAY_S steps, and with both mid-decode a
    tick scales 2 -> 1 (at most one request a replica counts as quiet)."""
    prompts, refs, n = wire["prompts"], wire["refs"], HANDOFF_NEW_TOKENS
    long_p = [prompts[SERVE_LENS.index(k)] for k in AUTOSCALE_LONG]
    ref_eng = handoff_engine(model, dev)
    long_refs = serve(ref_eng, long_p, AUTOSCALE_LONG_TOKENS)
    del ref_eng
    torch.cuda.empty_cache()
    seed, seed_acc = wire_replica(model, dev)
    engines, before = [seed._engine], [dict(seed._engine.counters)]
    router, r_acc = start_router(replicas={"r0": endpoint(seed)},
                                 evict_cooldown_s=600.0)
    servers, spawned, drained = {}, {}, {}

    def spawn():
        t0 = time.perf_counter()
        srv, acc = wire_replica(model, dev)
        rid = scaler.next_replica_id()
        servers[rid] = (srv, acc)
        engines.append(srv._engine)
        before.append(dict(srv._engine.counters))
        spawned[rid] = (t0, time.perf_counter() - t0)
        return rid, endpoint(srv)

    def drain(rid, ep, peers):
        srv, acc = servers.pop(rid)
        t0 = time.perf_counter()
        clean = srv.drain(deadline_s=WIRE_DRAIN_DEADLINE_S,
                          migrate_peers=peers)
        drained[rid] = (time.perf_counter() - t0, clean)
        acc.join(timeout=10)
        return clean

    scaler = Autoscaler(router, CallbackLauncher(spawn, drain),
                        AutoscalePolicy(min_replicas=1, max_replicas=2,
                                        hysteresis_ticks=1,
                                        up_cooldown_s=0.0,
                                        down_cooldown_s=0.0,
                                        down_outstanding_per_replica=1.0),
                        replica_secret=WIRE_SECRET)
    win = WireWindow()
    c0 = metrics.snapshot()["counters"]
    reset_launches()                       # the path's run
    errs, wrong, served, stop = [], [], [0], threading.Event()

    def loader(i):
        try:
            cli = RemotePredictor(port=router.port, secret=WIRE_SECRET,
                                  timeout=600.0)
            j = i
            while not stop.is_set():
                k = j % len(prompts)
                out = cli.generate(prompts[k], max_new_tokens=n)
                if not np.array_equal(out, refs[k]):
                    wrong.append(k)
                served[0] += 1
                j += 1
            cli.close()
        except Exception as e:  # noqa: BLE001 - gated below
            errs.append(f"{type(e).__name__}: {e}")

    loaders = [threading.Thread(target=loader, args=(i,))
               for i in range(AUTOSCALE_CLIENTS)]
    t_load = time.perf_counter()
    for t in loaders:
        t.start()
    wait_until(lambda: router.replica_view()[0]["outstanding"]
               >= AUTOSCALE_CLIENTS // 2, "sustained load on r0",
               phase="serve_router")
    actions = [scaler.tick()]
    rid = next(iter(servers), None)
    first_routed_s = None
    if rid is not None:
        new = servers[rid][0]._engine
        wait_until(lambda: new.counters["requests"] > 0,
                   "a request on the spawned replica", phase="serve_router")
        first_routed_s = time.perf_counter() - spawned[rid][0]
        wait_until(lambda: counter_delta(
            c0, f"router.replica_requests{{replica={rid}}}")
            >= AUTOSCALE_SHARE, "the spawned replica's share",
            phase="serve_router")
    stop.set()
    for t in loaders:
        t.join(timeout=600)
    load_s = time.perf_counter() - t_load
    share = shares(c0, ["r0"] + ([rid] if rid else []))
    box = {}
    with faults.scoped("engine.step_delay", times=-1,
                       delay_s=ROUTER_STEP_DELAY_S):
        longs = threading.Thread(target=lambda: box.update(
            r=wire_generate(router.port, long_p, AUTOSCALE_LONG_TOKENS)))
        longs.start()
        if rid is not None:
            wait_until(lambda: all(any(
                r is not None and len(r.generated) >= 2
                for r in e._slot_req) for e in engines),
                "a long request mid-decode on each replica",
                phase="serve_router")
        actions.append(scaler.tick())
        longs.join(timeout=600)
    wait_idle(engines[:1])
    long_outs = box["r"][0]
    long_toks, long_ok = token_record(long_outs, long_refs)
    launches, want, l_ok = launch_check(engines, before)
    line = {"phase": "serve_router", "arm": "autoscale",
            "model": "gpt2-small", "dtype": "bfloat16", "card": smi,
            "clients": AUTOSCALE_CLIENTS, "max_new_tokens": n,
            "policy": dataclasses.asdict(scaler.policy), "actions": actions,
            "spawn_s": spawned[rid][1] if rid else None,
            "spawn_to_first_routed_request_s": first_routed_s,
            "load_s": load_s, "load_requests": served[0],
            "load_tokens_per_s": served[0] * n / load_s,
            "replica_requests": share, "load_client_errors": errs,
            "load_wrong_tokens": len(wrong),
            **({"load_wrong_prompt_lens": sorted({len(prompts[k])
                                                   for k in wrong})}
               if wrong else {}),
            "long_requests": {"max_new_tokens": AUTOSCALE_LONG_TOKENS,
                              **long_toks},
            "drain_wall_ms": drained[rid][0] * 1e3 if rid in drained
            else None, "drain_clean": drained[rid][1] if rid in drained
            else None,
            "migrations_out": counter_delta(c0, "serve.migrations_out"),
            "rotation_after": router.replica_ids(),
            **{k.split(".", 1)[1]: counter_delta(c0, k) for k in (
                "autoscaler.scale_ups", "autoscaler.scale_downs",
                "autoscaler.errors")},
            "launches": launches, "expected_launches": want,
            "pool_at_baseline": at_baseline(seed._engine),
            "clocks": win.close()}
    stop_router(router, r_acc)
    scaler.stop()
    for srv, acc in list(servers.values()) + [(seed, seed_acc)]:
        stop_replica(srv, acc, "serve_router")
    line["ok"] = bool(actions == ["up", "down"] and not errs and not wrong
                      and long_ok and not long_toks["client_errors"]
                      and line["drain_clean"] and line["migrations_out"] >= 1
                      and line["rotation_after"] == ["r0"] and not servers
                      and l_ok and line["pool_at_baseline"])
    emit(line)
    return line["ok"]


def serve_router(model, dev, smi, wire):
    """The router tier on the card (`serving/router.py`,
    `serving/autoscale.py`): arms ``routed``, ``failover``, ``disagg``,
    ``cli`` and ``autoscale`` over bf16 `wire_replica`s, one line each.
    ``wire``: `serve_wire`'s prompts, references and ``inproc`` figures.
    See each arm for its gates; every arm frees its replicas before the
    next."""
    wire = dict(wire, card_params={k: v.to(dev) for k, v in torch_state(model).items()})
    ok = True
    with tempfile.TemporaryDirectory() as workdir:
        for arm in (router_routed, router_failover, router_disagg,
                    router_cli, router_autoscale):
            args = (model, dev, smi, wire)
            if arm in (router_failover, router_disagg, router_cli):
                args += (workdir,)
            ok &= arm(*args)
            gc.collect()
            torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("serve_router: tokens unlike the in-process "
                         "engine's, a client error, a replica without a "
                         "share, no resubmit or an unopened breaker, the "
                         "system prompt prefilled more than once, a "
                         "prefill graph on the decode replica, a pool off "
                         "its baseline, bad STATS or exposition, a non-zero "
                         "exit on SIGTERM, scale actions other than up then "
                         "down, or inexact launches")


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
    card_params = {k: v.to(dev) for k, v in torch_state(model).items()}
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
        model = host_gpt2_small(
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


def train_run(dev, smi, phase="train", warmup=2, timed=8,
              dtype=torch.bfloat16, **over):
    """GPT-2 small in ``dtype`` (bf16 with f32 masters, or the config's
    own float32): warm-up steps, then timed steps on one fixed batch.
    ``over`` overrides config fields (``train`` trains without dropout,
    ``train_dropout`` with the config's 0.1). Returns the phase's line."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dict(dict(hidden_dropout=0.0, attention_dropout=0.0), **over)
    model = host_gpt2_small(generator=torch.Generator().manual_seed(SEED),
                               **cfg)
    model = model.to(dtype)
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
    line = {"phase": phase, "model": "gpt2-small",
            "dtype": dtype_name(model.parameters()[0].dtype),
            "master_weights": "float32" if dtype != torch.float32 else None,
            "card": smi,
            "hidden_dropout": model.cfg.hidden_dropout,
            "recompute": model.cfg.recompute,
            "recompute_granularity": model.cfg.recompute_granularity,
            "batch": 16, "microbatches": 2, "seq": 1024,
            "tokens_per_step": tokens, "warmup_steps": warmup,
            "timed_steps": timed, "step_ms_p50": step_ms,
            "step_ms": [r["step_ms"] for r in recs],
            "tokens_per_s": tokens / (step_ms / 1e3),
            "mfu": flops / (step_ms / 1e3 * H100_BF16_PEAK),
            "flops_per_step": flops, "clocks": card_clocks(),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "losses": losses, "launches": launches,
            "expected_launches": expected, **observed, "ok": ok}
    if model.cfg.hidden_dropout:
        line["dropout_launches_per_step"] = launches["dropout"] / timed
    if dtype == torch.float32:   # the matrix products' own peak: f32 FFMA
        line["f32_peak_share"] = flops / (step_ms / 1e3
                                          * PEAK_OPS[torch.float32])
        line["flash_launches_per_step"] = {
            k: launches[k] / timed for k in FLASH_KERNELS}
        line["flash_arm"] = cfa.arm(dtype, DH)
    emit(line)
    if not ok:
        raise SystemExit(f"{phase}: losses {losses} not finite and "
                         f"falling, or the train series off: {observed}")
    return line


def train_f32(dev, smi):
    """GPT-2 small trained in its default float32 (no cast): B=16 as 2
    microbatches of 8, S=1024, AdamW, 2 warm-up and 4 timed steps. Every
    attention call runs the f32 CUDA-core flash loops, each kernel 24 times
    a step (12 layers x 2 microbatches), held exact."""
    return train_run(dev, smi, "train_f32", warmup=2, timed=4,
                     dtype=torch.float32)


EAGER_STEPS = 6                 # train_eager's steps (the first warms)
EAGER_LR = 1e-3                 # paddle.optimizer.AdamW's default rate
GENERATE_TOKENS = 32
PROFILED_PROMPTS = (3, 4)       # generate_eager's prompts run profiled:
                                # 250 and 380 tokens, near their mean


def eager_batch(dev, b, s):
    x, y = train_batch(np.random.default_rng(SEED + 4), b, s, VOCAB)
    return x, y, (PTensor(torch.from_numpy(a).long().to(dev)) for a in (x, y))


def eager_step(model, opt, xt, yt):
    """One step of a Paddle program's own loop; the loss as a float."""
    _, loss = model(xt, labels=yt)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss)


def eager_vs_scan(dev, b, s):
    """EAGER_STEPS steps of the eager loop against as many of the port's
    ScanTrainStep on the same weights and batch, hidden dropout off, AdamW
    at EAGER_LR with no clip on both sides: (each step's eager loss, the
    scan step's, the largest parameter difference after the last step, its
    99.9th percentile)."""
    cfg = dict(hidden_dropout=0.0, attention_dropout=0.0)
    x, y, (xt, yt) = eager_batch(dev, b, s)
    paddle.seed(SEED)
    with tdevice.device_scope(dev):
        model = gpt_mod.gpt2_small(**cfg)
    w0 = {k: v.to("cpu", copy=True) for k, v in torch_state(model).items()}
    opt = paddle.optimizer.AdamW(parameters=model.parameters())
    eager_losses = [eager_step(model, opt, xt, yt)
                    for _ in range(EAGER_STEPS)]
    eager = {k: v.to("cpu", copy=True)
             for k, v in torch_state(model).items()}
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    ref = host_gpt2_small(**cfg)
    ref.set_state_dict(w0)
    step = ScanTrainStep(ref, AdamW(learning_rate=EAGER_LR),
                         microbatches=1, device=dev)
    scan_losses = [step.step(x, y) for _ in range(EAGER_STEPS)]
    step.sync_to_model()
    diff = torch.cat([(eager[k] - v).abs().reshape(-1)
                      for k, v in torch_state(ref).items()])
    del step, ref
    gc.collect()
    torch.cuda.empty_cache()
    q999 = float(diff.topk(max(1, diff.numel() // 1000)).values[-1])
    return eager_losses, scan_losses, float(diff.max()), q999


def train_eager(dev, smi, b=8, s=1024):
    """GPT-2 small as a Paddle program trains it: built after
    ``paddle.seed(SEED)`` on the card in its default float32, hidden
    dropout 0.1, attention dropout 0 (the flash kernels), fused CE,
    ``paddle.optimizer.AdamW(parameters=model.parameters())``, B=8, S=1024,
    EAGER_STEPS steps of ``loss.backward(); opt.step(); opt.clear_grad()``.
    Gates: the losses fall; with dropout off, every one of EAGER_STEPS
    steps' losses equals the port's ScanTrainStep's on the same weights
    within TRAIN_LOSS_TOL, and the parameters after the last step too
    (every one within AdamW's two steps of the rate, all but 0.1% within
    1e-5); every attention call on the flash kernels
    (``kernel.dispatch.flash_attention.cuda``, no plain arm), exact
    launches."""
    gc.collect()
    torch.cuda.empty_cache()
    eager_losses, scan_losses, param_max, param_q999 = \
        eager_vs_scan(dev, b, s)
    loss_diffs = [abs(a - c) for a, c in zip(eager_losses, scan_losses)]
    x, _, (xt, yt) = eager_batch(dev, b, s)
    paddle.seed(SEED)
    with tdevice.device_scope(dev):
        model = gpt_mod.gpt2_small(hidden_dropout=DROPOUT_P,
                                   attention_dropout=0.0)
    opt = paddle.optimizer.AdamW(parameters=model.parameters())
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()                       # the eager path's run
    registry.reset_counts()
    losses, ms = [], []
    for _ in range(EAGER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(eager_step(model, opt, xt, yt))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    expected = train_launches(model.cfg, 1, EAGER_STEPS)
    launches = read_launches("train_eager", expected)
    dispatch = registry.counts()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = statistics.median(ms[1:])
    tokens = x.size
    flops = gpt_mod.analytic_flops_per_token(model.cfg, s) * tokens
    nl = model.cfg.num_layers
    ok = (bool(np.isfinite(losses).all()) and losses[-1] < losses[0]
          and bool(np.isfinite(scan_losses).all())
          and max(loss_diffs) <= TRAIN_LOSS_TOL and param_max <= 2 * EAGER_LR
          and param_q999 <= 1e-5
          and dispatch.get("kernel.dispatch.flash_attention.cuda")
          == nl * EAGER_STEPS
          and "kernel.dispatch.flash_attention.plain" not in dispatch)
    line = {"phase": "train_eager", "model": "gpt2-small",
            "dtype": "float32", "card": smi, "batch": b, "seq": s,
            "hidden_dropout": DROPOUT_P, "optimizer": "AdamW",
            "learning_rate": EAGER_LR, "steps": EAGER_STEPS,
            "step_ms": ms, "step_ms_p50": step_ms,
            "tokens_per_s": tokens / (step_ms / 1e3),
            "mfu": flops / (step_ms / 1e3 * H100_BF16_PEAK),
            "f32_peak_share": flops / (step_ms / 1e3
                                       * PEAK_OPS[torch.float32]),
            "flops_per_step": flops, "peak_memory_bytes": peak,
            "losses": losses, "launches": launches,
            "launches_per_step": {k: n / EAGER_STEPS
                                  for k, n in launches.items() if n},
            "dispatch": dispatch, "vs_scan_step": {
                "hidden_dropout": 0.0, "eager_losses": eager_losses,
                "scan_losses": scan_losses, "loss_abs_diff": loss_diffs,
                "loss_tol": TRAIN_LOSS_TOL,
                "param_max_abs_diff": param_max,
                "param_abs_diff_q999": param_q999},
            "clocks": card_clocks(), "ok": ok}
    emit(line)
    if not ok:
        raise SystemExit(f"train_eager: losses {losses}, against the scan "
                         f"step {line['vs_scan_step']}, dispatch {dispatch}")
    return launches


def eager_decode_profile(model, prompts, n, dev, wall_ms_per_token):
    """The eager decode of ``prompts`` (``n`` greedy tokens each) once
    more under `torch.profiler`: the card's busy milliseconds a token
    (every kernel's device time summed, the port's and PyTorch's; and the
    flash kernels' part of it), kernels a token, the profiled run's wall,
    and ``wall_ms_per_token`` (the unprofiled run's mean) over the busy
    time: how many times its device work the host's eager decode takes."""
    ids = [PTensor(torch.from_numpy(p[None].astype(np.int64)).to(dev))
           for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in ids:
            model.generate(x, max_new_tokens=n)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    tokens = n * len(prompts)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(map(device_us, kern)) / 1e3
    flash = sum(device_us(e) for e in kern if "flash" in e.key) / 1e3
    top = sorted(kern, key=device_us, reverse=True)[:8]
    return {"tokens": tokens,
            "device_ms_per_token": busy / tokens,
            "flash_device_ms_per_token": flash / tokens,
            "kernels_per_token": sum(e.count for e in kern) / tokens,
            "profiled_wall_ms_per_token": wall / tokens,
            "wall_ms_per_token": wall_ms_per_token,
            "wall_over_device": wall_ms_per_token / (busy / tokens),
            "top_kernels_device_ms": {e.key[:80]: device_us(e) / 1e3
                                      for e in top}}


def generate_eager(dev, smi):
    """GPT-2 small (float32, `serve`'s weights from the seed) as a Paddle
    Layer on the card decodes `serve`'s 8 prompts one at a time with its
    eager ``generate``, GENERATE_TOKENS greedy tokens each: the prompt's
    forward, then one forward a token over the growing caches (flash at
    Sq = 1). The tokens must equal a float32 DecodeEngine's on the same
    weights wherever the CPU's top-2 margin exceeds MARGIN. After the
    counts are read, two of the decodes run once more under
    `torch.profiler` (`eager_decode_profile`, PROFILED_PROMPTS)."""
    with tdevice.device_scope(dev):
        model = gpt_mod.gpt2_small(
            generator=torch.Generator().manual_seed(SEED),
            hidden_dropout=0.0, attention_dropout=0.0)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, min(VOCAB, model.cfg.vocab_size), n)
               .astype(np.int32) for n in SERVE_LENS]
    n = GENERATE_TOKENS
    reset_launches()                       # the eager decode's run
    registry.reset_counts()
    outs, ms = [], []
    for p in prompts:
        ids = PTensor(torch.from_numpy(p[None].astype(np.int64)).to(dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=n)
        outs.append(out.numpy()[0])
        ms.append((time.perf_counter() - t0) * 1e3 / n)
    nl = model.cfg.num_layers
    launches = read_launches("generate_eager",
                             {"flash_fwd": nl * n * len(prompts)})
    dispatch = registry.counts()
    prof = eager_decode_profile(
        model, [prompts[i] for i in PROFILED_PROMPTS], n, dev,
        statistics.mean(ms[i] for i in PROFILED_PROMPTS))
    eng = DecodeEngine(model, EngineConfig(page_size=PS, max_slots=8,
                                           prefix_cache=False, inflight=1),
                       device=dev)
    refs = serve(eng, prompts, n)
    del eng
    cpu_params = {k: v.cpu() for k, v in torch_state(model).items()}
    reqs = compare_tokens(outs, refs, prompts, [(1.0, 0, 0)] * len(prompts),
                          model.cfg, cpu_params)
    ok = all(r["tokens_equal"] or r["first_divergence"]["cpu_margin"]
             <= MARGIN for r in reqs) \
        and dispatch.get("kernel.dispatch.flash_attention.cuda") \
        == nl * n * len(prompts)
    emit({"phase": "generate_eager", "model": "gpt2-small",
          "dtype": "float32", "card": smi, "prompt_lens": list(SERVE_LENS),
          "new_tokens": n, "ms_per_token": ms,
          "ms_per_token_p50": statistics.median(ms), "requests": reqs,
          "margin_gate": MARGIN, "launches": launches, "dispatch": dispatch,
          "profile": prof, "clocks": card_clocks(), "ok": ok})
    if not ok:
        raise SystemExit(f"generate_eager: tokens off the engine's: {reqs}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


STATIC_BATCH, STATIC_SEQ, STATIC_K = 16, 1024, 32   # bench_gpt2's program
STATIC_LR = 1e-4
STATIC_CALLS = (2, 3)            # warm-up calls, timed calls (bench's)
STATIC_EAGER_STEPS = (2, 3)      # the same step without to_static
PARITY_STEPS = 4                 # to_static against eager, bit for bit
PARITY_BATCH = 8
BERT_BATCH, BERT_SEQ, BERT_K = 128, 128, 16       # bench_bert's program
BERT_LR = 2e-5


def static_program(model, lr, amp_loss=None):
    """`bench.py`'s training program over a Paddle Layer: AdamW at ``lr``,
    ``amp.decorate(O2, bfloat16)``, and the step (the forward under
    ``auto_cast(O2)``, ``backward``, ``step``, ``clear_grad``), not yet
    decorated. ``amp_loss(model, x, y)`` gives the loss (GPT's own by
    default). Returns (model, optimizer, step)."""
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=model.parameters())
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    loss_of = amp_loss or (lambda m, x, y: m(x, labels=y)[1])

    def step(x, y):
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = loss_of(model, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, step


def bert_loss(model, x, y):
    """`bench_bert`'s loss: the logits cast to float32, cross-entropy."""
    return paddle.nn.functional.cross_entropy(
        model(x).astype("float32"), y)


def static_gpt(dev, **over):
    paddle.seed(SEED)
    with tdevice.device_scope(dev):
        return gpt_mod.gpt2_small(**dict(dict(hidden_dropout=0.0,
                                              attention_dropout=0.0),
                                         **over))


def static_bert(dev):
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    paddle.seed(SEED)
    with tdevice.device_scope(dev):
        return BertForSequenceClassification(
            BertConfig(hidden_dropout=0.0, attention_dropout=0.0),
            num_classes=2)


def static_batches(dev, vocab, b, s, k, labels=None):
    """`bench.py`'s batch: RandomState(0) ids, the same batch every step;
    one step's (x, y) and the k-step stack of it, on the card."""
    rng = np.random.RandomState(0)
    if labels is None:
        ids = rng.randint(0, vocab, (b, s + 1))
        x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64)
    else:
        x = rng.randint(0, vocab, (b, s)).astype(np.int32)
        y = rng.randint(0, labels, b).astype(np.int64)
    one = [paddle.to_tensor(a, place=dev) for a in (x, y)]
    stacked = [paddle.to_tensor(np.broadcast_to(a, (k,) + a.shape).copy(),
                                place=dev) for a in (x, y)]
    return one, stacked


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def static_vs_eager(dev, make, lr, batch, steps=PARITY_STEPS, loss=None,
                    change_lr=False, program=None):
    """``steps`` calls of the to_static step (`EAGER_RUNS` eager, the
    capture, replays) against ``steps`` eager steps of the same program
    from the same seed (``make()`` builds the model; ``program(model)``
    gives (model, optimizer, step), `static_program` by default): the
    losses and then every parameter and buffer bit for bit, the key chain
    where the eager run leaves it, and the graph's replays. With
    ``change_lr`` one more call at a rate of 0 must leave every parameter
    as it was."""
    x, y = batch
    out = {}
    for static in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        model, opt, step = (program or (lambda m: static_program(
            m, lr, loss)))(make())
        fn = paddle.jit.to_static(step) if static else step
        losses = [fn(x, y).numpy() for _ in range(steps)]
        out[static] = (losses, {k: v.numpy() for k, v in
                                model.state_dict().items()},
                       paddle.get_rng_state()[0].numpy())
        if static:
            prog = fn.concrete_program(x, y)
            replays = prog.graph.replays
            held = True
            if change_lr:
                opt.set_lr(0.0)
                fn(x, y)
                held = all(np.array_equal(v.numpy(), out[True][1][k])
                           for k, v in model.named_parameters())
        del model, opt, step, fn
    (el, ep, ek), (sl, sp, sk) = out[False], out[True]
    return {"steps": steps, "eager_losses": [float(a) for a in el],
            "static_losses": [float(a) for a in sl],
            "losses_bit_equal": [a.tobytes() for a in el]
            == [a.tobytes() for a in sl],
            "params_bit_equal": all(np.array_equal(ep[k], sp[k])
                                    for k in ep),
            "param_max_abs_diff": max(float(np.abs(
                ep[k].astype(np.float64) - sp[k]).max()) for k in ep),
            "key_chain_equal": bool(np.array_equal(ek, sk)),
            "replays": replays, "zero_lr_held_params": held}


def dropout_replays(dev, calls=5):
    """A to_static hidden dropout (the ``dropout`` kernel) over ones of
    DROPOUT_SHAPE in bfloat16: the masks of ``calls`` calls, the last
    ``calls - EAGER_RUNS`` of them graph replays, against the same draws
    made eagerly from the same seed; each replay's mask must differ from
    the one before."""
    from paddle_tpu_torch.jit.static_function import EAGER_RUNS
    ones = paddle.to_tensor(torch.ones(DROPOUT_SHAPE, dtype=torch.bfloat16,
                                       device=dev))
    drop = paddle.jit.to_static(
        lambda a: paddle.nn.functional.dropout(a, p=DROPOUT_P))
    paddle.seed(SEED)
    masks = [drop(ones)._data != 0 for _ in range(calls)]
    paddle.seed(SEED)
    eager = [paddle.nn.functional.dropout(ones, p=DROPOUT_P)._data != 0
             for _ in range(calls)]
    return {"calls": calls, "replays": calls - EAGER_RUNS,
            "masks_equal_eager": all(torch.equal(a, b)
                                     for a, b in zip(masks, eager)),
            "consecutive_masks_differ": all(
                not torch.equal(a, b) for a, b in zip(masks, masks[1:])),
            "keep_share": float(masks[-1].float().mean())}


def static_launches(nl, steps, phase):
    """Each flash kernel once a layer a step (no dropout), through the
    graph's replays as through the eager runs."""
    return read_launches(phase, {k: nl * steps for k in FLASH_KERNELS})


def timed_static(step_k, xk, yk, k, calls):
    """`bench.py::_timed_steps_k`: warm-up calls, then timed calls of the
    k-step program, the card synchronized around the timed ones. Returns
    (ms a step of each timed call, every call's losses)."""
    warm, timed = calls
    losses = [step_k(xk, yk).numpy() for _ in range(warm)]
    reset_launches()                       # the timed calls' run
    ms = []
    for _ in range(timed):
        out, t = sync_ms(lambda: step_k(xk, yk))
        ms.append(t / k)
        losses.append(out.numpy())
    return ms, losses


def timed_eager(step, x, y, calls):
    """The same step without to_static: ms a step of the timed steps."""
    warm, timed = calls
    for _ in range(warm):
        step(x, y)
    return [sync_ms(lambda: step(x, y))[1] for _ in range(timed)]


def train_static(dev, smi):
    """`bench_gpt2`'s program on the port: GPT-2 small from
    ``paddle.seed(SEED)`` on the card, AdamW 1e-4, ``amp.decorate(O2,
    bfloat16)``, the step under ``auto_cast(O2)`` decorated with
    ``jit.to_static`` and driven by ``multi_steps(32)`` on one batch of
    B=16, S=1024: 2 warm-up calls, then 3 timed calls (96 steps); the
    same step eagerly (2 + 3 steps) beside it. Then the graph held
    against the eager steps (`static_vs_eager`, with dropout 0.1 too, and
    a rate changed between calls) and the dropout's replays. Gates: the
    first loss near ln(50304), the losses falling and finite, graph and
    eager bit for bit, launches exact."""
    from paddle_tpu_torch.jit.static_function import EAGER_RUNS
    gc.collect()
    torch.cuda.empty_cache()
    (x, y), (xk, yk) = static_batches(dev, 50304, STATIC_BATCH, STATIC_SEQ,
                                      STATIC_K)
    model, opt, step = static_program(static_gpt(dev), STATIC_LR)
    nl = model.cfg.num_layers
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    static = paddle.jit.to_static(step)
    step_k = static.multi_steps(STATIC_K)
    torch.cuda.reset_peak_memory_stats(dev)
    ms, losses = timed_static(step_k, xk, yk, STATIC_K, STATIC_CALLS)
    launches = static_launches(nl, STATIC_CALLS[1] * STATIC_K,
                               "train_static")
    prog = static.concrete_program(x, y)
    peak = torch.cuda.max_memory_allocated(dev)
    graph_launches = {k.source: n for k, n in
                      prog.graph.kernel_launches.items()}
    capture_s = prog.graph_seconds
    eager_ms = timed_eager(step, x, y, STATIC_EAGER_STEPS)
    del model, opt, step, static, step_k, prog
    step_ms = statistics.median(ms)
    tokens = STATIC_BATCH * STATIC_SEQ
    tps = tokens / (step_ms / 1e3)
    flat = np.concatenate(losses).astype(np.float64)
    parity = static_vs_eager(dev, lambda: static_gpt(dev), STATIC_LR,
                             static_batches(dev, 50304, PARITY_BATCH,
                                            STATIC_SEQ, 1)[0],
                             change_lr=True)
    parity_drop = static_vs_eager(
        dev, lambda: static_gpt(dev, hidden_dropout=DROPOUT_P), STATIC_LR,
        static_batches(dev, 50304, PARITY_BATCH, STATIC_SEQ, 1)[0])
    drop = dropout_replays(dev)
    ok = (bool(np.isfinite(flat).all()) and abs(flat[0] - math.log(50304))
          < 0.5 and flat[-1] < flat[0]
          and all(p["losses_bit_equal"] and p["params_bit_equal"]
                  and p["key_chain_equal"]
                  and p["replays"] == PARITY_STEPS - EAGER_RUNS
                  for p in (parity, parity_drop))
          and parity["zero_lr_held_params"]
          and drop["masks_equal_eager"] and drop["consecutive_masks_differ"]
          and graph_launches == {k: nl for k in FLASH_KERNELS})
    line = {"phase": "train_static", "model": "gpt2-small",
            "program": "bench_gpt2: amp O2 bf16, to_static, multi_steps",
            "card": smi, "batch": STATIC_BATCH, "seq": STATIC_SEQ,
            "multi_steps": STATIC_K, "calls": list(STATIC_CALLS),
            "optimizer": "AdamW", "learning_rate": STATIC_LR,
            "params": n_params, "step_ms": ms, "step_ms_p50": step_ms,
            "tokens_per_s": tps, "mfu": tps * 6.0 * n_params
            / H100_BF16_PEAK, "peak_memory_bytes": peak,
            "capture_seconds": capture_s,
            "graph_launches_per_step": graph_launches,
            "launches": launches,
            "launches_per_step": {k: n / (STATIC_CALLS[1] * STATIC_K)
                                  for k, n in launches.items() if n},
            "first_loss": float(flat[0]), "last_loss": float(flat[-1]),
            "ln_vocab": math.log(50304),
            "eager_step_ms": eager_ms,
            "eager_step_ms_p50": statistics.median(eager_ms),
            "eager_over_graph": statistics.median(eager_ms) / step_ms,
            "vs_eager": parity, "vs_eager_dropout": parity_drop,
            "dropout_replays": drop, "clocks": card_clocks(), "ok": ok}
    emit(line)
    if not ok:
        raise SystemExit(f"train_static: {line}")
    return launches


def train_bert_static(dev, smi):
    """`bench_bert`'s program on the port: BERT-base
    (`models/bert.py::BertForSequenceClassification`, 2 classes) from
    ``paddle.seed(SEED)`` on the card, dropout 0, AdamW 2e-5, amp O2
    bfloat16, the loss over the logits cast to float32, ``to_static`` and
    ``multi_steps(16)`` on one batch of B=128, S=128: 2 warm-up and 3
    timed calls, the same step eagerly beside it, then the graph held
    against the eager steps bit for bit. Attention is the non-causal
    flash op (each kernel once a layer a step, the ``bert`` flash case's
    shape)."""
    from paddle_tpu_torch.jit.static_function import EAGER_RUNS
    gc.collect()
    torch.cuda.empty_cache()
    (x, y), (xk, yk) = static_batches(dev, 30522, BERT_BATCH, BERT_SEQ,
                                      BERT_K, labels=2)
    model, opt, step = static_program(static_bert(dev), BERT_LR, bert_loss)
    nl = model.bert.cfg.num_layers
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    static = paddle.jit.to_static(step)
    step_k = static.multi_steps(BERT_K)
    torch.cuda.reset_peak_memory_stats(dev)
    ms, losses = timed_static(step_k, xk, yk, BERT_K, STATIC_CALLS)
    launches = static_launches(nl, STATIC_CALLS[1] * BERT_K,
                               "train_bert_static")
    prog = static.concrete_program(x, y)
    peak = torch.cuda.max_memory_allocated(dev)
    capture_s = prog.graph_seconds
    graph_launches = {k.source: n for k, n in
                      prog.graph.kernel_launches.items()}
    eager_ms = timed_eager(step, x, y, STATIC_EAGER_STEPS)
    del model, opt, step, static, step_k, prog
    step_ms = statistics.median(ms)
    flat = np.concatenate(losses).astype(np.float64)
    parity = static_vs_eager(dev, lambda: static_bert(dev), BERT_LR,
                             (x, y), loss=bert_loss)
    ok = (bool(np.isfinite(flat).all()) and flat[-1] < flat[0]
          and parity["losses_bit_equal"] and parity["params_bit_equal"]
          and parity["replays"] == PARITY_STEPS - EAGER_RUNS
          and graph_launches == {k: nl for k in FLASH_KERNELS})
    line = {"phase": "train_bert_static", "model": "bert-base",
            "program": "bench_bert: amp O2 bf16, to_static, multi_steps",
            "card": smi, "batch": BERT_BATCH, "seq": BERT_SEQ,
            "multi_steps": BERT_K, "calls": list(STATIC_CALLS),
            "optimizer": "AdamW", "learning_rate": BERT_LR,
            "params": n_params, "step_ms": ms, "step_ms_p50": step_ms,
            "sequences_per_s": BERT_BATCH / (step_ms / 1e3),
            "mfu": BERT_BATCH * BERT_SEQ / (step_ms / 1e3) * 6.0 * n_params
            / H100_BF16_PEAK, "peak_memory_bytes": peak,
            "capture_seconds": capture_s,
            "graph_launches_per_step": graph_launches,
            "launches": launches,
            "launches_per_step": {k: n / (STATIC_CALLS[1] * BERT_K)
                                  for k, n in launches.items() if n},
            "first_loss": float(flat[0]), "last_loss": float(flat[-1]),
            "eager_step_ms": eager_ms,
            "eager_step_ms_p50": statistics.median(eager_ms),
            "eager_over_graph": statistics.median(eager_ms) / step_ms,
            "vs_eager": parity, "clocks": card_clocks(), "ok": ok}
    emit(line)
    if not ok:
        raise SystemExit(f"train_bert_static: {line}")
    return launches


RESNET_BATCH, RESNET_K = 256, 8          # bench_resnet50's program
RESNET_NORMS = 53                        # batch norms a ResNet50 forward
RESNET_LR = 0.1
RESNET_PARITY_BATCH = 32
RESNET_CPU_BATCH = 2
# the card against the port on the CPU, float32 at [2, 3, 224, 224]: the
# logits relative to the CPU's largest, the loss absolute, the running
# statistics relative to each one's largest, and each gradient's L2 error
# over its norm. The CPU's own float32 run sits 1.2e-5, 9e-6 and at most
# 1.6e-2 (gradients; the batch norms' backward cancels most of each
# gradient at random weights) from its float64 run at this shape.
RESNET_CPU_TOL = {"logits": 1e-4, "loss": 1e-4, "stats": 1e-4,
                  "grad_l2": 5e-2}


def resnet_model(dev):
    """``resnet50(num_classes=1000)`` from ``paddle.seed(SEED)`` on
    ``dev``."""
    from paddle_tpu_torch.vision.models import resnet50
    paddle.seed(SEED)
    with tdevice.device_scope(dev):
        return resnet50(num_classes=1000)


def resnet_program(model):
    """`bench_resnet50`'s program over ``model``: Momentum 0.1, momentum
    0.9, weight decay 1e-4, ``amp.decorate(O2, bfloat16)``,
    ``CrossEntropyLoss``, and the step under ``auto_cast(O2)``, not yet
    decorated. Returns (model, optimizer, step)."""
    opt = paddle.optimizer.Momentum(learning_rate=RESNET_LR, momentum=0.9,
                                    parameters=model.parameters(),
                                    weight_decay=1e-4)
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    loss_fn = paddle.nn.CrossEntropyLoss()

    def step(x, y):
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, step


def resnet_batches(dev, b, k):
    """`bench_resnet50`'s batch: RandomState(0) images [b, 3, 224, 224]
    (NCHW, float32) and labels of 1000 classes; one step's (x, y) and the
    k-step stack of it, on the card."""
    rng = np.random.RandomState(0)
    x = rng.randn(b, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, b).astype(np.int64)
    one = [paddle.to_tensor(a, place=dev) for a in (x, y)]
    stacked = [paddle.to_tensor(np.broadcast_to(a, (k,) + a.shape).copy(),
                                place=dev) for a in (x, y)]
    return one, stacked


def resnet_macs(model, dev, hw=224):
    """Forward multiply-adds a ``hw`` x ``hw`` image, from the shapes of
    the model's convolutions (output elements x input channels a group x
    kernel size) and linear layers (in x out), read by hooks over one eval
    forward of one image."""
    from paddle_tpu_torch.nn.layers.conv import _ConvNd
    total = [0]

    def conv(layer, inputs, out):
        total[0] += int(np.prod(out.shape[1:])) * (
            layer._in_channels // layer._groups) * int(
                np.prod(layer._kernel_size))

    def linear(layer, inputs, out):
        total[0] += layer.in_features * layer.out_features

    handles = [sub.register_forward_post_hook(
        conv if isinstance(sub, _ConvNd) else linear)
        for sub in model.sublayers()
        if isinstance(sub, (_ConvNd, paddle.nn.Linear))]
    model.eval()
    with paddle.no_grad(), paddle.amp.auto_cast(level="O2",
                                                dtype="bfloat16"):
        model(paddle.to_tensor(np.zeros((1, 3, hw, hw), np.float32),
                               place=dev))
    model.train()
    for h in handles:
        h.remove()
    return total[0]


def resnet_vs_cpu(dev, b=RESNET_CPU_BATCH):
    """One float32 training call (forward, loss, backward) of
    ``resnet50`` on the card against the port on the CPU on the same
    weights and images: logits, loss, running statistics and every
    gradient within RESNET_CPU_TOL (TF32 off, as `main` sets it)."""
    from paddle_tpu_torch.models import convert
    cpu = torch.device("cpu")
    host = resnet_model(cpu)
    card = resnet_model(dev)
    convert.layer_state_from_numpy(card, convert.layer_state_to_numpy(host))
    rng = np.random.RandomState(1)
    x = rng.randn(b, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, b).astype(np.int64)
    res = {}
    for model, d in ((host, cpu), (card, dev)):
        logits = model(paddle.to_tensor(x, place=d))
        loss = paddle.nn.CrossEntropyLoss()(logits,
                                            paddle.to_tensor(y, place=d))
        loss.backward()
        res[d.type] = (logits.numpy().astype(np.float64), float(loss),
                       {k: p.grad.numpy().astype(np.float64)
                        for k, p in model.named_parameters()},
                       {k: v.numpy().astype(np.float64) for k, v in
                        model.state_dict().items()
                        if k.endswith(("_mean", "_variance"))})
    (hl, hloss, hg, hs), (cl, closs, cg, cs) = res["cpu"], res["cuda"]
    errs = {"logits": float(np.abs(cl - hl).max() / np.abs(hl).max()),
            "loss": abs(closs - hloss),
            "stats": max(float(np.abs(cs[k] - v).max() / np.abs(v).max())
                         for k, v in hs.items()),
            "grad_l2": max(float(np.linalg.norm(cg[k] - g)
                                 / np.linalg.norm(g)) for k, g in hg.items())}
    del host, card
    return {"batch": b, "errors": errs, "tolerances": RESNET_CPU_TOL,
            "loss": closs, "ok": all(errs[k] <= RESNET_CPU_TOL[k]
                                     for k in errs)}


def cudnn_flags():
    c = torch.backends.cudnn
    return {"enabled": c.enabled, "benchmark": c.benchmark,
            "deterministic": c.deterministic, "allow_tf32": c.allow_tf32,
            "version": c.version()}


def train_resnet_static(dev, smi):
    """`bench_resnet50`'s program on the port (`bench.py:233-261`):
    ``resnet50(num_classes=1000)`` from ``paddle.seed(SEED)`` on the card,
    Momentum 0.1 (momentum 0.9, weight decay 1e-4) on float32 masters, amp
    O2 bfloat16, ``CrossEntropyLoss``, the step ``to_static`` and
    ``multi_steps(8)`` on one batch of B=256 at 224 x 224, NCHW: 2
    warm-up and 3 timed calls, the same step eagerly beside it. Then
    `static_vs_eager` at B=32 under ``cudnn.deterministic`` (losses,
    parameters, the batch norms' running statistics and the key chain bit
    for bit, one more call at rate 0), and `resnet_vs_cpu`. MFU counts 3 x
    2 x the forward multiply-adds of an image (`resnet_macs`) over the
    bfloat16 peak. The batch norm kernels launch once a norm a step (53),
    counted through the graph's replays; every other kernel 0."""
    from paddle_tpu_torch.jit.static_function import EAGER_RUNS
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (x, y), (xk, yk) = resnet_batches(dev, RESNET_BATCH, RESNET_K)
    model, opt, step = resnet_program(resnet_model(dev))
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    static = paddle.jit.to_static(step)
    step_k = static.multi_steps(RESNET_K)
    torch.cuda.reset_peak_memory_stats(dev)
    ms, losses = timed_static(step_k, xk, yk, RESNET_K, STATIC_CALLS)
    launches = read_launches("train_resnet_static", {
        k: RESNET_NORMS * STATIC_CALLS[1] * RESNET_K for k in BN_KERNELS})
    prog = static.concrete_program(x, y)
    peak = torch.cuda.max_memory_allocated(dev)
    capture_s = prog.graph_seconds
    slots = {id(h) for h, _, _ in prog.slots.values()}
    stats_found = all(id(v) in slots for k, v in model.state_dict().items()
                      if k.endswith(("_mean", "_variance")))
    eager_ms = timed_eager(step, x, y, STATIC_EAGER_STEPS)
    macs = resnet_macs(model, dev)
    del model, opt, step, static, step_k, prog, xk, yk
    step_ms = statistics.median(ms)
    ips = RESNET_BATCH / (step_ms / 1e3)
    flat = np.concatenate(losses).astype(np.float64)
    gc.collect()
    torch.cuda.empty_cache()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        parity = static_vs_eager(
            dev, lambda: resnet_model(dev), RESNET_LR,
            resnet_batches(dev, RESNET_PARITY_BATCH, 1)[0], change_lr=True,
            program=resnet_program)
        parity["cudnn"] = cudnn_flags()
    finally:
        torch.backends.cudnn.deterministic = prev
    vs_cpu = resnet_vs_cpu(dev)
    ok = (bool(np.isfinite(flat).all()) and flat[-1] < flat[0]
          and stats_found and parity["losses_bit_equal"]
          and parity["params_bit_equal"] and parity["key_chain_equal"]
          and parity["replays"] == PARITY_STEPS - EAGER_RUNS
          and parity["zero_lr_held_params"] and vs_cpu["ok"])
    line = {"phase": "train_resnet_static", "model": "resnet50",
            "program": "bench_resnet50: amp O2 bf16, Momentum, to_static, "
                       "multi_steps", "card": smi, "batch": RESNET_BATCH,
            "image": [3, 224, 224], "multi_steps": RESNET_K,
            "calls": list(STATIC_CALLS), "optimizer": "Momentum",
            "learning_rate": RESNET_LR, "params": n_params,
            "forward_macs_per_image": macs, "step_ms": ms,
            "step_ms_p50": step_ms, "images_per_s": ips,
            "mfu": ips * 3 * 2 * macs / H100_BF16_PEAK,
            "peak_memory_bytes": peak, "capture_seconds": capture_s,
            "running_stats_in_slots": stats_found, "launches": launches,
            "first_loss": float(flat[0]), "last_loss": float(flat[-1]),
            "ln_classes": math.log(1000),
            "eager_step_ms": eager_ms,
            "eager_step_ms_p50": statistics.median(eager_ms),
            "eager_over_graph": statistics.median(eager_ms) / step_ms,
            "vs_eager": parity, "vs_cpu": vs_cpu, "cudnn": cudnn_flags(),
            "seconds": time.perf_counter() - t0, "clocks": card_clocks(),
            "ok": ok}
    emit(line)
    if not ok:
        raise SystemExit(f"train_resnet_static: {line}")
    return launches


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


def check_batch_norm(dev, timer, smi, dtype, case):
    """The batch norm kernels against their plain versions
    (`kernels/batch_norm.py`) at ``case`` (BN_CASES) in training: the
    forward's output and statistics, and the backward's dx, dw and db,
    within BN_TOL; weight and bias in x's dtype, as amp O2 leaves them.
    Timed beside `torch.nn.functional.batch_norm` (cuDNN or PyTorch's
    native kernel; float32 weight and running statistics) and
    `aten.native_batch_norm_backward`: yardsticks the port never calls.
    Returns {kernel: line}."""
    name, shape = case
    rng = np.random.default_rng(SEED + 11)
    n, c = int(np.prod(shape)) // shape[1], shape[1]
    x, dy = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, dtype) for _ in "xd")
    w = torch.from_numpy(rng.standard_normal(c, dtype=np.float32) + 1.0).to(
        dev, dtype)
    b = torch.from_numpy(rng.standard_normal(c, dtype=np.float32)).to(
        dev, dtype)
    x3, dy3 = tbn.view3(x, 1), tbn.view3(dy, 1)
    eps = 1e-5
    out_tol, sum_tol = BN_TOL[dtype]
    got = tbn.train_fwd("cuda", x3, w, b, eps)
    ref = tbn._plain_fwd(x3, w, b, eps)
    gotb = tbn.train_bwd("cuda", x3, dy3, got[1], got[3], w)
    refb = tbn._plain_bwd(x3, dy3, ref[1], ref[3], w)
    torch.cuda.synchronize()
    errs = {"y": (max_err(got[0], ref[0]), rel_tol(ref[0], out_tol)),
            "mean": (max_err(got[1], ref[1]), rel_tol(ref[1], out_tol)),
            "var": (max_err(got[2], ref[2]), rel_tol(ref[2], out_tol)),
            "dx": (max_err(gotb[0], refb[0]), rel_tol(refb[0], out_tol)),
            "dw": (max_err(gotb[1], refb[1]), rel_tol(refb[1], sum_tol)),
            "db": (max_err(gotb[2], refb[2]), rel_tol(refb[2], sum_tol))}
    w32, b32 = w.float(), b.float()
    rm = torch.zeros(c, device=dev)
    rv = torch.ones(c, device=dev)
    _, save_mean, save_invstd = torch.ops.aten.native_batch_norm(
        x, w32, b32, rm, rv, True, 0.1, eps)
    item = x.element_size()
    lines = {}
    for kern, errs_of, fn, plain, lib, nbytes, ops in (
            ("batch_norm_fwd", ("y", "mean", "var"),
             lambda: cbn.batch_norm_fwd(x3, w32, b32, eps, dtype),
             lambda: tbn._plain_fwd(x3, w, b, eps),
             lambda: F.batch_norm(x, rm, rv, w32, b32, training=True,
                                  eps=eps),
             2 * n * c * item, 7 * n * c),
            ("batch_norm_bwd", ("dx", "dw", "db"),
             lambda: cbn.batch_norm_bwd(x3, dy3, got[1], got[3], w32),
             lambda: tbn._plain_bwd(x3, dy3, ref[1], ref[3], w),
             lambda: torch.ops.aten.native_batch_norm_backward(
                 dy, x, w32, rm, rv, save_mean, save_invstd, True, eps,
                 [True, True, True]),
             3 * n * c * item, 8 * n * c)):
        bms, by = bound(nbytes, ops, dtype)
        ok = all(errs[k][0] <= errs[k][1] for k in errs_of)
        line = {"phase": "kernel", "kernel": kern, "dtype": dtype_name(dtype),
                "card": smi, "case": name, "shape": list(shape),
                "errors": {k: errs[k][0] for k in errs_of},
                "tolerances": {k: errs[k][1] for k in errs_of},
                "within_tol": ok,
                "max_abs_err": max(errs[k][0] for k in errs_of),
                "kernel_ms": timer.ms(fn), "plain_ms": timer.ms(plain),
                "library_ms": timer.ms(lib),
                "library": "F.batch_norm" if kern == "batch_norm_fwd"
                else "aten.native_batch_norm_backward",
                "bound_ms": bms, "bound_by": by,
                "bytes": nbytes}
        emit(line)
        if not ok:
            raise SystemExit(f"{kern} {dtype} {name}: {line}")
        lines[kern] = line
    return lines


def rel_tol(ref, tol):
    """``tol`` times the largest reference value when that exceeds 1."""
    return tol * max(1.0, ref.float().abs().max().item())


def max_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def check_layernorm(dev, timer, dtype, n=8 * 1024, d=D_MODEL):
    """The two fused layernorm kernels against their plain versions at the
    incubate path's rows, timed beside PyTorch's layernorm forward and
    backward; one ``kernel`` line per kernel. The backward's line also
    times the op's whole backward (``op_ms``: the kernel, then the sums of
    its partials and their casts, as `_LayerNorm.backward` runs them), and
    each line a streaming yardstick of the same bytes (``stream_ms``:
    ``y.copy_(x)`` for the forward, ``torch.add(x, dy, out=dx)`` for the
    backward), which nothing on the path calls."""
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

    def op_bwd():
        dxo, dgo, dbo = cln.fused_layernorm_bwd(x, gamma, mu, rstd, dy)
        return dxo, dgo.sum(0).to(gamma.dtype), dbo.sum(0).to(gamma.dtype)
    ys, dxs = torch.empty_like(x), torch.empty_like(x)
    stream = {"fused_layernorm_fwd": lambda: ys.copy_(x),
              "fused_layernorm_bwd": lambda: torch.add(x, dy, out=dxs)}
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
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
            "stream_ms": timer.ms(stream[kern])}
        if kern == "fused_layernorm_bwd":
            line["op_ms"] = timer.ms(op_bwd)
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
    paddle.seed(SEED)
    with tdevice.device_scope("cpu"):
        cpu = FusedMultiTransformer(D_MODEL, NH, FFN, num_layers=2).eval()
    with tdevice.device_scope(dev):
        card = FusedMultiTransformer(D_MODEL, NH, FFN, num_layers=2).eval()
    card.set_state_dict(cpu.state_dict())
    x, mask = rand(2, 256, D_MODEL), rand(2, 1, 256, 256)
    for name, m in (("stack_masked", mask), ("stack_no_mask", None)):
        reset_launches()                 # the stack's run on the card
        with torch.no_grad():
            got = card(x.to(dev), attn_mask=None if m is None
                       else m.to(dev))._data.cpu()
        launches[name] = read_launches(
            f"incubate_parity {name}",
            {} if m is not None else {"flash_fwd": 2})
        with torch.no_grad():
            ref = cpu(x, attn_mask=m)._data
        results[name] = (max_err(got, ref),
                         rel_tol(ref, INCUBATE_TOL["stack"]))

    state = {"weight": rand(D_MODEL), "bias": rand(D_MODEL)}
    x, w = rand(2, 256, D_MODEL) * 2 + 0.5, rand(2, 256, D_MODEL)
    grads = {}
    for where in ("cpu", dev):
        with tdevice.device_scope(where):
            ln = FusedLayerNorm(D_MODEL)
        ln.set_state_dict(state)
        xx = PTensor(x.to(where), stop_gradient=False)
        if where == dev:
            reset_launches()             # the layernorm's run on the card
        y = ln(xx)
        (y * PTensor(w.to(where))).sum().backward()
        if where == dev:
            launches["layernorm"] = read_launches(
                "incubate_parity layernorm", dict.fromkeys(LN_KERNELS, 1))
        grads[str(where)] = [t._data.detach().cpu() for t in
                             (y, xx.grad, ln.weight.grad, ln.bias.grad)]
    for i, name in enumerate(("ln_y", "ln_dx", "ln_dweight", "ln_dbias")):
        ref = grads["cpu"][i]
        results[name] = (max_err(grads[str(dev)][i], ref), rel_tol(
            ref, INCUBATE_TOL["ln_fwd" if i == 0 else "ln_bwd"]))

    q, k = rand(2, NH, 256, DH), rand(2, NH, 256, DH)
    cos, sin = rope_tables(256, DH, "cpu")
    reset_launches()                     # the rope's run on the card
    got = [t._data for t in fused_rotary_position_embedding(
        q.to(dev), k.to(dev), cos.to(dev), sin.to(dev))]
    launches["rope"] = read_launches("incubate_parity rope", {"rotary": 1})
    ref = [t._data for t in fused_rotary_position_embedding(q, k, cos, sin)]
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
    paddle.seed(SEED)
    with tdevice.device_scope(dev):
        stack = FusedMultiTransformer(D_MODEL, NH, FFN, num_layers=nl).to(
            torch.bfloat16).eval()
        ln = FusedLayerNorm(D_MODEL)
    x, dy = rand(b, s, D_MODEL), rand(b, s, D_MODEL)
    q, k = rand(b, NH, s, DH), rand(b, NH, s, DH)
    cos, sin = rope_tables(s, DH, dev)
    xg = PTensor(x, stop_gradient=False)

    def run_stack():
        with torch.no_grad():
            return stack(x)._data

    def run_ln():
        y = ln(xg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y.backward(PTensor(dy))
        torch.cuda.synchronize()
        return y._data, (time.perf_counter() - t0) * 1e3

    def run_rope():
        return [t._data for t in fused_rotary_position_embedding(
            q, k, cos, sin)]

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
        ry, _, _ = tfl._plain_ln_fwd(x.reshape(-1, D_MODEL),
                                     ln.weight._data, ln.bias._data,
                                     ln.epsilon)
        rq, _ = trot._plain_rope(q, k, cos, sin)
        y = y.detach()
    ok = (tuple(out.shape) == (b, s, D_MODEL) and bool(out.isfinite().all())
          and tuple(xg.grad.shape) == (b, s, D_MODEL)
          and bool(xg.grad._data.isfinite().all())
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


# ------------------------------------- fault-tolerant and elastic training

CKPT_LR = 1e-4
CKPT_ROWS = 16                  # the global batch: 2 microbatches of 8
CKPT_SEQ = 1024
ELASTIC_DEADLINE_S = 20.0       # train_elastic's liveness deadline
ELASTIC_STEPS = 4               # step 1 warms, steps 2-4 are timed
FLEET_TIMEOUT_S = 420           # one fleet launch's bound
# train_ckpt's and train_elastic's depth: 6 of GPT-2 small's 12 layers at
# its full widths (cut for the script's time when fit_hapi came; their
# checkpoint bytes and the elastic reducer's bytes a step shrink with it)
FT_LAYERS = 6


def ft_step(dev, microbatches=2, reducer=None, seed=SEED):
    """GPT-2 small at FT_LAYERS layers in bf16 on f32 masters, AdamW (clip
    1.0) over an `optimizer/lr.py` schedule (a 2-step linear warm-up into
    a cosine decay), which the checkpoints carry."""
    model = host_gpt2_small(generator=torch.Generator().manual_seed(seed),
                            hidden_dropout=0.0, attention_dropout=0.0,
                            num_layers=FT_LAYERS)
    sched = LinearWarmup(CosineAnnealingDecay(CKPT_LR, 20), 2, 1e-5, CKPT_LR)
    return ScanTrainStep(model.to(torch.bfloat16),
                         AdamW(learning_rate=sched, clip_norm=1.0),
                         microbatches=microbatches, device=dev,
                         grad_reducer=reducer)


def ft_batch(cursor, rank=0, world=1):
    """Rank ``rank``'s rows of global batch ``cursor`` (16 x 1024 tokens
    from the cursor's own seed): any world size sees one data stream."""
    x, y = train_batch(np.random.default_rng(SEED + 200 + int(cursor)),
                       CKPT_ROWS, CKPT_SEQ, VOCAB)
    lo, hi = rank * CKPT_ROWS // world, (rank + 1) * CKPT_ROWS // world
    return x[lo:hi], y[lo:hi]


def ft_iterate(step, mgr, cursor):
    """One managed iteration: the step, the schedule's step where the
    step was taken, the manager's ladder and periodic save. Returns the
    loss and the iteration's wall seconds."""
    t0 = time.perf_counter()
    loss = step.step(*ft_batch(cursor))
    if step.last_step_ok:
        step.opt.learning_rate.step()
    if mgr is not None:
        mgr.after_step(data_cursor=cursor + 1)
    torch.cuda.synchronize()
    return loss, time.perf_counter() - t0


def same_state(a, b):
    """Every parameter and optimizer leaf, the key chain, the clock and
    the schedule of two steps equal bit for bit."""
    for grp in ("blocks", "top"):
        for k, p in a._params[grp].items():
            if not torch.equal(p, b._params[grp][k]):
                return False
            for n, v in a._opt_state[grp][k].items():
                if not torch.equal(v, b._opt_state[grp][k][n]):
                    return False
    return torch.equal(a._key, b._key) \
        and a.opt.global_step == b.opt.global_step \
        and a.opt.learning_rate.state_dict() \
        == b.opt.learning_rate.state_dict()


def worst(diffs):
    """The largest difference, infinity where there is none to read."""
    return max(diffs) if diffs else math.inf


def flight_seq():
    events = flight.events()
    return events[-1]["seq"] if events else 0


def flight_since(seq, kind):
    return [e for e in flight.events() if e["seq"] > seq
            and e["kind"] == kind]


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def flip_byte(ckpt_dir):
    shard = next(f for f in sorted(os.listdir(ckpt_dir))
                 if f.startswith("params") and f.endswith(".npy"))
    p = os.path.join(ckpt_dir, shard)
    blob = bytearray(open(p, "rb").read())
    blob[-1] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    return shard


def ft_launches(calls, microbatches=2, nl=FT_LAYERS):
    """A bf16 `ft_step` without dropout launches each flash kernel once per
    layer per microbatch, bad steps included."""
    return {k: nl * microbatches * calls for k in FLASH_KERNELS}


def read_log(path):
    """A worker's ``KIND {json}`` lines, by kind."""
    out = {}
    for line in open(path, errors="replace"):
        kind, _, rest = line.strip().partition(" ")
        if kind in ("BEGIN", "STEP", "DONE", "PEERLOST"):
            out.setdefault(kind, []).append(json.loads(rest))
    return out


def wait_procs(procs, phase, timeout=FLEET_TIMEOUT_S):
    t_end = time.time() + timeout
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, t_end - time.time())))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SystemExit(f"{phase}: a worker ran past {timeout} s")
    return rcs


def train_ckpt(dev, smi, train_line):
    """`CheckpointManager` over `ft_step`'s GPT-2 small (FT_LAYERS layers)
    on the card, one process: B=16 as 2 microbatches, S=1024, bf16 on f32
    masters, AdamW over the lr schedule, ``every=2``, ``keep=2``, async
    saves. Arms ``resume``,
    ``bad_steps``, ``sigterm`` (a worker process of this script) and
    ``corrupt``, one line each, then the phase's line."""
    phase = "train_ckpt"
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="train_ckpt_")
    calls = 0
    reset_launches()
    try:
        # resume: 6 steps with saves, then a fresh step restored from step 4
        root = os.path.join(work, "run")
        step = ft_step(dev)
        mgr = CheckpointManager(root, step, every=2, keep=2, use_async=True)
        seq0 = flight_seq()
        losses, walls, writers = [], [], []
        torch.cuda.reset_peak_memory_stats(dev)
        for c in range(6):
            loss, wall = ft_iterate(step, mgr, c)
            calls += 1
            losses.append(loss)
            walls.append(wall * 1e3)
            if mgr._pending is not None and mgr._pending[0] not in writers:
                writers.append(mgr._pending[0])
        mgr.wait()
        peak = torch.cuda.max_memory_allocated(dev)
        stalls = [e["stall_ms"] for e in flight_since(seq0,
                                                      "train.checkpoint")]
        complete = [n for n, _ in mgr.complete_checkpoints()]
        ck_dir = os.path.join(root, "step-00000004")
        ck_bytes = dir_bytes(ck_dir)
        root4 = os.path.join(work, "from4")
        shutil.copytree(ck_dir, os.path.join(root4, "step-00000004"))
        with open(os.path.join(root4, "LATEST"), "w") as f:
            f.write("step-00000004\n")
        fresh = ft_step(dev, seed=SEED + 1)
        mgr4 = CheckpointManager(root4, fresh, every=2, keep=2)
        t0 = time.perf_counter()
        info = mgr4.restore(require=True)
        restore_s = time.perf_counter() - t0
        resumed = []
        for c in (4, 5):
            resumed.append(ft_iterate(fresh, mgr4, c)[0])
            calls += 1
        mgr4.wait()
        resume_ok = info["step"] == 4 and info["data_cursor"] == 4 \
            and resumed == losses[4:] and same_state(fresh, step)
        write_s = [w.seconds for w in writers]
        save_walls = [walls[i] for i in (1, 3, 5)]
        resume_line = {
            "phase": phase, "arm": "resume", "card": smi,
            "model": "gpt2-small", "dtype": "bfloat16",
            "master_weights": "float32", "batch": CKPT_ROWS,
            "microbatches": 2, "seq": CKPT_SEQ,
            "lr_schedule": "LinearWarmup(CosineAnnealingDecay)",
            "losses": losses, "resumed_losses": resumed,
            "complete_checkpoints": complete,
            "restored_from": info["step"],
            "losses_equal": resumed == losses[4:],
            "state_equal": same_state(fresh, step),
            "snapshot_blocking_ms": stalls,
            "background_write_s": write_s,
            "restore_s": restore_s, "checkpoint_bytes": ck_bytes,
            "write_gb_per_s": [ck_bytes / s / 1e9 for s in write_s if s],
            "iteration_ms": walls,
            "step_ms_p50_with_saves": p50(walls),
            "saving_iteration_ms_p50": p50(save_walls),
            "step_ms_p50_without_saves": p50(
                [r["step_ms"] for r in step.records[1:]]),
            "train_step_ms_p50": train_line["step_ms_p50"],
            "peak_memory_bytes": peak, "clocks": card_clocks(),
            "ok": resume_ok}
        emit(resume_line)

        # corrupt: a flipped byte in the newest checkpoint's shard
        skipped0 = metrics.counter("train.resume_corrupt_skipped").value
        shard = flip_byte(os.path.join(root, "step-00000006"))
        info_c = CheckpointManager(root, fresh).restore(require=True)
        skipped = metrics.counter("train.resume_corrupt_skipped").value - skipped0
        corrupt_ok = info_c["step"] == 4 and skipped == 1
        emit({"phase": phase, "arm": "corrupt", "flipped_shard": shard,
              "restored_from": info_c["step"], "corrupt_skipped": skipped,
              "ok": corrupt_ok})
        del fresh, mgr4

        # bad_steps: the run's step goes on under a ladder of 2
        mgr_b = CheckpointManager(os.path.join(work, "bad"), step, every=2,
                                  keep=2, max_consecutive_bad=2)
        ft_iterate(step, mgr_b, 6)          # step 7, saved
        ref7 = step._params["top"]["gpt.wte.weight"].detach().clone()
        ft_iterate(step, mgr_b, 7)          # step 8
        calls += 2
        ref8 = step._params["top"]["gpt.wte.weight"].detach().clone()
        bad0 = metrics.counter("train.bad_steps").value
        rb0 = metrics.counter("train.rollbacks").value
        with faults.scoped("train.step_nan", times=1):
            nan_loss, _ = ft_iterate(step, mgr_b, 8)
        calls += 1
        skipped_ok = not math.isfinite(nan_loss) \
            and step.opt.global_step == 8 and step.consecutive_bad_steps == 1 \
            and torch.equal(step._params["top"]["gpt.wte.weight"], ref8)
        raised = None
        with faults.scoped("train.step_nan", times=1):
            try:
                ft_iterate(step, mgr_b, 9)
            except TooManyBadSteps as e:
                raised = str(e)
        calls += 1
        mgr_b.wait()
        bad_ok = skipped_ok and raised is not None \
            and "rolled back to step 7" in raised \
            and step.opt.global_step == 7 \
            and step.opt.learning_rate.last_epoch == 7 \
            and torch.equal(step._params["top"]["gpt.wte.weight"], ref7) \
            and metrics.counter("train.bad_steps").value - bad0 == 2 \
            and metrics.counter("train.rollbacks").value - rb0 == 1
        emit({"phase": phase, "arm": "bad_steps", "nan_loss": repr(nan_loss),
              "skip_kept_state_and_clock": skipped_ok, "raised": raised,
              "clock_after_rollback": step.opt.global_step,
              "ok": bad_ok})
        del step, mgr
        gc.collect()
        torch.cuda.empty_cache()

        # sigterm: a worker process gets SIGTERM at the start of its 3rd
        # step, finishes it, checkpoints synchronously and exits 0
        root_s = os.path.join(work, "sigterm")
        log_path = os.path.join(work, "sigterm.log")
        with open(log_path, "wb") as log:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ckpt-worker",
                 "--root", root_s], stdout=log, stderr=subprocess.STDOUT,
                env=worker_env())
        try:
            t_end = time.time() + FLEET_TIMEOUT_S
            sent = None
            while time.time() < t_end and proc.poll() is None:
                begins = read_log(log_path).get("BEGIN", [])
                if any(b["cursor"] == 2 for b in begins):
                    proc.send_signal(signal.SIGTERM)
                    sent = time.time()
                    break
                time.sleep(0.02)
            rc = wait_procs([proc], phase)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
        wlog = read_log(log_path)
        done = (wlog.get("DONE") or [{}])[-1]
        latest = open(os.path.join(root_s, "LATEST")).read().strip() \
            if os.path.exists(os.path.join(root_s, "LATEST")) else None
        worker_losses = [s["loss"] for s in wlog.get("STEP", [])]
        resumed_s = []
        if latest:
            st = ft_step(dev, seed=SEED + 2)
            CheckpointManager(root_s, st).restore(require=True)
            for c in (3, 4):
                resumed_s.append(ft_iterate(st, None, c)[0])
                calls += 1
            del st
        sig_ok = rc == 0 and sent is not None and latest == "step-00000003" \
            and os.path.exists(os.path.join(root_s, latest, "COMPLETE")) \
            and worker_losses == losses[:3] and resumed_s == losses[3:5] \
            and done.get("global_step") == 3
        emit({"phase": phase, "arm": "sigterm", "rc": rc, "latest": latest,
              "worker_losses": worker_losses, "resumed_losses": resumed_s,
              "sigterm_to_exit_s": (done.get("t", sent) - sent)
              if sent else None,
              "worker_launches": done.get("launches"),
              "worker_peak_memory_bytes": done.get("peak_memory_bytes"),
              "ok": sig_ok})
        expected = ft_launches(calls)
        launches = read_launches(phase, expected)
        for k, n in (done.get("launches") or {}).items():
            launches[k] += n
        ok = resume_ok and corrupt_ok and bad_ok and sig_ok
        emit({"phase": phase, "arms": {"resume": resume_ok,
                                       "corrupt": corrupt_ok,
                                       "bad_steps": bad_ok,
                                       "sigterm": sig_ok},
              "step_calls": calls, "launches": launches,
              "expected_in_process": expected, "ok": ok})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not ok:
        raise SystemExit(f"{phase}: an arm failed")
    return launches


def worker_env(**extra):
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PADDLE_FAULTS", None)
    env.update(extra)
    return env


def ckpt_worker(argv):
    """``--ckpt-worker --root DIR``: `CheckpointManager.run` over
    `ft_step` with SIGTERM installed, one ``BEGIN``/``STEP`` line a step
    and a ``DONE`` line at the end."""
    root = argv[argv.index("--root") + 1]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    step = ft_step(dev)
    mgr = CheckpointManager(root, step, every=2, keep=2)
    reset_launches()

    def batch_fn(cursor):
        print("BEGIN " + json.dumps({"cursor": cursor, "t": time.time()}),
              flush=True)
        return ft_batch(cursor)

    def on_step(n, loss, ok):
        if ok:
            step.opt.learning_rate.step()
        print("STEP " + json.dumps({"n": n, "loss": loss,
                                    "t": time.time()}), flush=True)

    mgr.run(batch_fn, until_step=10_000, on_step=on_step,
            install_sigterm=True)
    print("DONE " + json.dumps({
        "global_step": step.opt.global_step, "t": time.time(),
        "launches": {k.source: k.launches for k in _build.kernels()},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}),
        flush=True)
    return 0


def elastic_worker(argv):
    """``--elastic-worker --root DIR --until-step N --deadline-s S
    --hb-dir DIR``: one rank of `run_elastic_worker` over `ft_step`
    (rank and world from the launch env; each rank takes 16 / world rows
    of every global batch, as 2 / world microbatches of 8). Prints a
    ``STEP`` line a step (loss, step ms, the reducer's seconds by piece,
    peak memory), ``DONE`` at the end, ``PEERLOST`` and exit 23 on a
    dead peer."""
    opt = {a: argv[argv.index(a) + 1] for a in
           ("--root", "--until-step", "--deadline-s", "--hb-dir")}
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    box = {}
    reset_launches()

    def make_step(reducer):
        box["reducer"] = reducer
        box["step"] = ft_step(dev, microbatches=2 // world, reducer=reducer)
        return box["step"]

    def on_step(n, loss, ok):
        st, red = box["step"], box["reducer"]
        if ok:
            st.opt.learning_rate.step()
        print("STEP " + json.dumps({
            "n": n, "loss": loss, "t": time.time(),
            "step_ms": st.records[-1]["step_ms"] if ok else None,
            "reduce": dict(red.timings) if red is not None else None,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}),
            flush=True)

    try:
        out = run_elastic_worker(
            make_step, ft_batch, root=opt["--root"],
            until_step=int(opt["--until-step"]), every=2,
            deadline_s=float(opt["--deadline-s"]), hb_dir=opt["--hb-dir"],
            on_step=on_step)
    except PeerLost as e:
        print("PEERLOST " + json.dumps({"t": time.time(), "error": str(e)}),
              flush=True)
        os._exit(EXIT_PEER_LOST)
    st = box["step"]
    print("DONE " + json.dumps({
        "rank": out["rank"], "world": out["world"],
        "resumed_step": out["resumed_step"], "stopped": out["stopped"],
        "global_step": st.opt.global_step, "calls": len(out["losses"]),
        "launches": {k.source: k.launches for k in _build.kernels()},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}),
        flush=True)
    return 0


def spawn_ranks(world, root, until, logs, attempt, env_for_rank=None):
    """``world`` rank processes of `elastic_worker` on this card, the
    launch env wired as `train/elastic.py::spawn_local_fleet` wires it
    (a fresh store port each call, per-attempt heartbeat dirs)."""
    port = elastic_mod._free_port()
    procs = []
    for rank in range(world):
        env = worker_env(PADDLE_TRAINER_ID=str(rank),
                         PADDLE_TRAINERS_NUM=str(world),
                         PADDLE_MASTER=f"127.0.0.1:{port}",
                         PADDLE_WATCHDOG_DIR=os.path.join(logs, "dumps"))
        env.update((env_for_rank or (lambda r: {}))(rank))
        path = os.path.join(logs, f"rank{rank}.a{attempt}.log")
        with open(path, "ab") as log:
            p = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--elastic-worker", "--root", root, "--until-step",
                 str(until), "--deadline-s", str(ELASTIC_DEADLINE_S),
                 "--hb-dir", os.path.join(root, f"hb-a{attempt}")],
                env=env, stdout=log, stderr=subprocess.STDOUT)
        p.log_path = path
        procs.append(p)
    return procs


def fleet_record(procs):
    return [read_log(p.log_path) for p in procs]


def rank_losses(rec):
    return [s["loss"] for s in rec.get("STEP", [])]


def reduce_pieces(recs):
    """Median seconds of each reducer piece over the timed steps (2 on)
    of every rank, and the bytes a rank publishes and reads a step."""
    steps = [s for r in recs for s in r.get("STEP", [])[1:] if s["reduce"]]
    out = {k: p50([s["reduce"][k] * 1e3 for s in steps])
           for k in ("pack", "publish", "read", "barrier", "unpack")}
    return {"ms": out, "stored_bytes_a_step": steps[0]["reduce"]["bytes"]
            if steps else None}


def one_process(dev, cursors, root=None):
    """The one-process reference: `ft_step` with the global batch as 2
    microbatches, optionally restored from ``root``; returns its losses
    and the number of step calls."""
    st = ft_step(dev)
    if root is not None:
        CheckpointManager(root, st).restore(require=True)
    out = [ft_iterate(st, None, c)[0] for c in cursors]
    del st
    return out


def copy_checkpoint(root, name, dst):
    shutil.copytree(os.path.join(root, name), os.path.join(dst, name))
    with open(os.path.join(dst, "LATEST"), "w") as f:
        f.write(name + "\n")


def train_elastic(dev, smi):
    """Elastic training on one card: rank processes of this script
    (`elastic_worker`), each its own CUDA context, GPT-2 small as
    `train_ckpt`'s, batch 8 a rank of the global 16. Arms ``world2``,
    ``stop_vote`` and ``peer_dead``, one line each, then the phase's
    line."""
    phase = "train_elastic"
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="train_elastic_")
    logs = os.path.join(work, "logs")
    os.makedirs(logs)
    calls, worker_launches, live = 0, [], []
    ok = False
    reset_launches()
    try:
        # world2: 2 ranks, ELASTIC_STEPS steps, against one process
        root = os.path.join(work, "w2")
        procs = spawn_ranks(2, root, ELASTIC_STEPS, logs, 0)
        live += procs
        rcs = wait_procs(procs, phase)
        if rcs != [0, 0]:
            raise SystemExit(f"{phase}: the world-2 ranks exited {rcs}")
        recs = fleet_record(procs)
        l0, l1 = rank_losses(recs[0]), rank_losses(recs[1])
        ref = one_process(dev, range(ELASTIC_STEPS))
        calls += ELASTIC_STEPS
        diffs = [abs(a - b) for a, b in zip(l0, ref)]
        # a second world-2 run from the step-2 checkpoint, to step 4
        root_b = os.path.join(work, "w2b")
        copy_checkpoint(root, "step-00000002", root_b)
        procs_b = spawn_ranks(2, root_b, 4, logs, 1)
        live += procs_b
        rcs_b = wait_procs(procs_b, phase)
        recs_b = fleet_record(procs_b)
        again = rank_losses(recs_b[0])
        run_to_run = [abs(a - b) for a, b in zip(again, l0[2:])]
        w2_steps = [s["step_ms"] for r in recs for s in r["STEP"][1:]
                    if s["step_ms"] is not None]
        for r in recs + recs_b:
            worker_launches.append((r.get("DONE") or [{}])[-1].get(
                "launches"))
        w2_ok = rcs == [0, 0] and rcs_b == [0, 0] \
            and len(l0) == ELASTIC_STEPS and l0 == l1 \
            and worst(diffs) <= TRAIN_BF16_LOSS_TOL \
            and len(again) == 2 \
            and again == rank_losses(recs_b[1]) and worst(run_to_run) == 0.0
        emit({"phase": phase, "arm": "world2", "card": smi, "world": 2,
              "model": "gpt2-small", "dtype": "bfloat16",
              "rows_a_rank": CKPT_ROWS // 2, "seq": CKPT_SEQ, "rcs": rcs,
              "losses": l0, "one_process_losses": ref,
              "loss_abs_diff": diffs, "tol": TRAIN_BF16_LOSS_TOL,
              "exact": l0 == ref,
              "resumed_from_step2": again, "run_to_run_abs_diff": run_to_run,
              "step_ms_p50": p50(w2_steps), "step_ms": w2_steps,
              "reducer": reduce_pieces(recs),
              "peak_memory_bytes": [max(s["peak_memory_bytes"]
                                        for s in r["STEP"]) for r in recs],
              "clocks": card_clocks(), "ok": w2_ok})
        tol = worst(run_to_run)

        # stop_vote: SIGTERM to rank 1 once it has taken a step
        root_v = os.path.join(work, "vote")
        procs_v = spawn_ranks(2, root_v, 10_000, logs, 2)
        live += procs_v
        t_end = time.time() + FLEET_TIMEOUT_S
        sent = False
        while time.time() < t_end and all(p.poll() is None
                                          for p in procs_v):
            if read_log(procs_v[1].log_path).get("STEP"):
                procs_v[1].send_signal(signal.SIGTERM)
                sent = True
                break
            time.sleep(0.05)
        rcs_v = wait_procs(procs_v, phase)
        recs_v = fleet_record(procs_v)
        dones = [(r.get("DONE") or [{}])[-1] for r in recs_v]
        latest = open(os.path.join(root_v, "LATEST")).read().strip() \
            if os.path.exists(os.path.join(root_v, "LATEST")) else None
        stop_steps = [d.get("global_step") for d in dones]
        worker_launches += [d.get("launches") for d in dones]
        vote_ok = sent and rcs_v == [0, 0] \
            and all(d.get("stopped") for d in dones) \
            and stop_steps[0] == stop_steps[1] and latest is not None \
            and latest == f"step-{stop_steps[0]:08d}" \
            and os.path.exists(os.path.join(root_v, latest, "COMPLETE"))
        emit({"phase": phase, "arm": "stop_vote", "rcs": rcs_v,
              "stopped_at": stop_steps, "latest": latest,
              "ok": bool(vote_ok)})

        # peer_dead: rank 1 SIGKILLs itself at its 3rd step boundary, past
        # the fleet-complete checkpoint of step 2
        root_d = os.path.join(work, "dead")
        ref_d = os.path.join(work, "dead_ref")
        spawned = {}

        def spawn(world, attempt):
            if attempt == 1:
                copy_checkpoint(root_d, open(os.path.join(
                    root_d, "LATEST")).read().strip(), ref_d)
            env = (lambda r: {"PADDLE_FAULTS": "train.peer_dead:times=3"}
                   if (attempt == 0 and r == 1) else {})
            spawned[attempt] = time.time()
            ps = spawn_ranks(world, root_d, ELASTIC_STEPS, logs,
                             10 + attempt, env)
            live.extend(ps)
            spawned[f"procs{attempt}"] = ps
            return ps

        ctl = ElasticController(spawn, world_size=2, settle_s=60,
                                max_restarts=1)
        ctl_rc = ctl.run()
        a0 = fleet_record(spawned["procs0"])
        a1 = fleet_record(spawned.get("procs1", []))
        lost = (a0[0].get("PEERLOST") or [{}])[-1]
        # the victim's last heartbeat: its last sign of life before the
        # kill (it beats per shard and barrier poll while it saves)
        hb = os.path.join(root_d, "hb-a10", "hb-1.json")
        t_kill = json.load(open(hb))["t"] if os.path.exists(hb) else None
        kill_to_lost = lost.get("t", 0) - t_kill if t_kill else None
        resumed_d = rank_losses(a1[0]) if a1 else []
        done_d = (a1[0].get("DONE") or [{}])[-1] if a1 else {}
        ref_losses = one_process(dev, range(2, ELASTIC_STEPS), ref_d) \
            if os.path.isdir(ref_d) else []
        calls += len(ref_losses)
        diff_d = [abs(a - b) for a, b in zip(resumed_d, ref_losses)]
        w1_steps = [s["step_ms"] for s in (a1[0].get("STEP") or [])[1:]
                    if s["step_ms"] is not None] if a1 else []
        worker_launches += [(r.get("DONE") or [{}])[-1].get("launches")
                            for r in a0 + a1]
        dead_ok = ctl_rc == 0 and [a[1] for a in ctl.attempts] == [
            [EXIT_PEER_LOST, -signal.SIGKILL], [0]] \
            and kill_to_lost is not None \
            and kill_to_lost <= ELASTIC_DEADLINE_S + 1.0 \
            and done_d.get("resumed_step") == 2 \
            and len(resumed_d) == ELASTIC_STEPS - 2 \
            and len(ref_losses) == len(resumed_d) and worst(diff_d) <= tol
        emit({"phase": phase, "arm": "peer_dead", "attempts": ctl.attempts,
              "deadline_s": ELASTIC_DEADLINE_S,
              "kill_to_peer_lost_s": kill_to_lost,
              "peer_lost": lost.get("error"),
              "reform_to_first_step_s": (a1[0]["STEP"][0]["t"] - spawned[1])
              if a1 and a1[0].get("STEP") else None,
              "resumed_step": done_d.get("resumed_step"),
              "resumed_losses": resumed_d, "one_process_losses": ref_losses,
              "abs_diff": diff_d, "tol": tol,
              "world1_step_ms_p50": p50(w1_steps),
              "peak_memory_bytes": {
                  f"a{i}.rank{r}": max((s["peak_memory_bytes"]
                                        for s in rec.get("STEP", [])),
                                       default=None)
                  for i, att in enumerate((a0, a1)) for r, rec in
                  enumerate(att)},
              "ok": bool(dead_ok)})
        expected = ft_launches(calls)
        launches = read_launches(phase, expected)
        for wl in worker_launches:
            for k, n in (wl or {}).items():
                launches[k] += n
        ok = bool(w2_ok and vote_ok and dead_ok)
        emit({"phase": phase, "arms": {"world2": w2_ok,
                                       "stop_vote": bool(vote_ok),
                                       "peer_dead": bool(dead_ok)},
              "step_calls_in_process": calls, "launches": launches,
              "expected_in_process": expected, "ok": ok})
    finally:
        for p in live:
            if p.poll() is None:
                p.kill()
                p.wait()
            if not ok:             # the ranks' own account of a failure
                sys.stderr.write(f"--- {phase} {p.log_path} (rc "
                                 f"{p.returncode}):\n" + open(
                                     p.log_path, errors="replace").read()[
                                         -3000:] + "\n")
        shutil.rmtree(work, ignore_errors=True)
    if not ok:
        raise SystemExit(f"{phase}: an arm failed")
    return launches


# ---------------------------------------------------------------- decode
# the bench's decode rungs (`bench.py:512-582`): GPT-2 small at full width
# in float32 from paddle.seed(0), 256 positions
DECODE_CFG = dict(hidden_size=768, num_layers=12, num_heads=12,
                  intermediate_size=3072, max_position_embeddings=256,
                  hidden_dropout=0.0, attention_dropout=0.0)
DECODE_B, DECODE_S0, DECODE_N = 8, 128, 64          # bench_decode
ENGINE_NREQ = 8                                     # bench_engine_decode
FAST_SAMPLED = (0.8, 40, 3)                         # temperature, top_k, seed
FAST_SAMPLED_SHAPE = (8, 128, 16)                   # B, S0, N


def bench_decode(dev):
    """`bench_decode` (`bench.py:512-535`) on the port: one capture call,
    then the timed call. The bench wraps the ids with ``paddle.Tensor(...,
    _internal=True)``, which takes a numpy array as it is only in the JAX
    package; here ``paddle.to_tensor``. Returns the bench's two figures
    and what the phase reads around them."""
    paddle.seed(0)
    B, S0, N = DECODE_B, DECODE_S0, DECODE_N
    cfg = gpt_mod.GPTConfig(**DECODE_CFG)
    with tdevice.device_scope(dev):
        model = gpt_mod.GPTForCausalLM(cfg)
    rng = np.random.RandomState(0)
    ids = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (B, S0))
                           .astype(np.int32), place=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = model.fast_generate(ids, max_new_tokens=N)     # capture
    first = np.asarray(out.numpy())
    prog = model._fast_decode_cache[(B, S0, N, 1.0, 0, "float32")]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = model.fast_generate(ids, max_new_tokens=N)
    end.record()
    toks = np.asarray(out.numpy())
    dt = time.perf_counter() - t0
    kernels, device_ms, host_calls = profiled(
        lambda: model.fast_generate(ids, max_new_tokens=N))
    fig = {"tokens_per_s": B * N / dt, "ms_per_token": dt / N * 1e3,
           "call_ms": dt * 1e3, "replay_event_ms": start.elapsed_time(end),
           "capture_seconds": prog.capture_seconds,
           "kernels_a_call": kernels, "profiled_device_ms": device_ms,
           "host_runtime_calls_a_call": host_calls,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "reserved_memory_bytes": torch.cuda.memory_reserved(dev),
           "captures": prog.captures, "replays": prog.graph.replays,
           "graph_kernel_launches": {k.source: n for k, n in
                                     prog.graph.kernel_launches.items()},
           "second_call_equal": bool(np.array_equal(first, toks)),
           "shape_ok": toks.shape == (B, S0 + N)
           and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())}
    del model, out
    return fig


def bench_engine_decode(dev, phase):
    """`bench_engine_decode` (`bench.py:537-582`) on the port: 8 requests
    as sequential B=1 `fast_generate` calls, then through a
    `DecodeEngine` (8 slots, page 16) on the card, and the bench's
    assertion that the engine's first request equals `fast_generate`'s
    tokens. Lines changed: ``paddle.to_tensor`` for ``paddle.Tensor(...,
    _internal=True)``, and the engine's launches are read around its run
    (`engine_launches`). On a failed assertion the first divergence and
    the CPU's top-2 margin there are reported before it raises."""
    paddle.seed(0)
    NREQ, S0, N = ENGINE_NREQ, DECODE_S0, DECODE_N
    cfg = gpt_mod.GPTConfig(**DECODE_CFG)
    with tdevice.device_scope(dev):
        model = gpt_mod.GPTForCausalLM(cfg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, S0).astype(np.int32)
               for _ in range(NREQ)]

    def ids(p):
        return paddle.to_tensor(p[None], place=dev)

    model.fast_generate(ids(prompts[0]), max_new_tokens=N)   # capture
    t0 = time.perf_counter()
    for p in prompts:
        out = model.fast_generate(ids(p), max_new_tokens=N)
        np.asarray(out.numpy())
    seq_tps = NREQ * N / (time.perf_counter() - t0)

    eng = DecodeEngine(model, EngineConfig(
        page_size=16, max_slots=NREQ, max_seq_len=S0 + N), device=dev)
    eng.warmup(prompt_lens=[S0])
    counters0 = dict(eng.counters)
    reset_launches()                       # the engine's run
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=N) for p in prompts]
    eng.run_until_idle()
    eng_tps = NREQ * N / (time.perf_counter() - t0)
    launches, expected, _ = engine_launches(eng, counters0, phase)
    ref = np.asarray(model.fast_generate(ids(prompts[0]),
                                         max_new_tokens=N).numpy())[0]
    got = reqs[0].result(timeout=60)
    rec = {"engine_tokens_per_s": eng_tps, "sequential_tokens_per_s": seq_tps,
           "engine_over_sequential": eng_tps / seq_tps,
           "launches": launches, "expected_launches": expected,
           "tokens_equal": bool(np.array_equal(got, ref))}
    if not rec["tokens_equal"]:
        cpu_params = {k: v.cpu() for k, v in torch_state(model).items()}
        rec["requests"] = compare_tokens([got], [ref], prompts[:1],
                                         [(1.0, 0, 0)], cfg, cpu_params)
        emit({"phase": phase, "arm": "engine_decode", **rec, "ok": False})
    assert np.array_equal(got, ref)
    del eng, model
    return rec


def fast_margin(cpu_params, cfg, context, t, row, rows, param):
    """The CPU's top-2 margin at a `fast_generate` row's generated token
    ``t`` after ``context``: of the logits for a greedy call; for a sampled
    one, of the tempered, top-k masked logits plus the Gumbel noise that
    row draws (one key for the call's ``rows`` rows, split once per earlier
    token)."""
    temp, top_k, seed = param
    lg = prefill_logits(cpu_params, context, "cpu", cfg)[0][None]
    if temp != 1.0 or top_k:
        key = prng.prng_key(seed)
        for _ in range(t):
            key = prng.split(key)[0]
        lg = lg / torch.full((), temp)
        if top_k:
            kth = lg.topk(top_k).values[..., -1:]
            lg = torch.where(lg < kth, smp.NEG_INF, lg)
        lg = lg + prng.gumbel(prng.split(key)[1],
                              (rows, lg.shape[-1]))[row][None]
    top2 = lg.topk(2).values[0]
    return float(top2[0] - top2[1])


def fast_vs_eager(fast, eager, prompts, param, cfg, cpu_params, rows=1):
    """Per row: `fast_generate`'s tokens equal eager `generate`'s, else the
    first divergence with the CPU's margin there (`fast_margin`); rows of
    one call when ``rows`` > 1, else one call each."""
    recs = []
    for b, (p, a, w) in enumerate(zip(prompts, fast, eager)):
        rec = {"prompt_len": len(p), "tokens_equal": bool(np.array_equal(a,
                                                                          w))}
        if not rec["tokens_equal"]:
            t = int(np.flatnonzero(a != w)[0]) - len(p)
            rec["first_divergence"] = {
                "position": t, "cpu_margin": fast_margin(
                    cpu_params, cfg, w[:len(p) + t], t,
                    b if rows > 1 else 0, rows, param)}
        recs.append(rec)
    return recs


def gated(recs):
    return all(r["tokens_equal"] or r["first_divergence"]["cpu_margin"]
               <= MARGIN for r in recs)


def fast_arms(dev):
    """The gates on `generate_eager`'s model (GPT-2 small, float32, seed
    SEED) and prompts: greedy `fast_generate` (one signature a prompt
    length, 8 captures) against eager `generate` on the card, margin-gated;
    the reserved memory after each capture; a sampled B=8 call against
    eager `generate` with the same parameters; ``wte`` perturbed in place
    between two calls (new tokens, no capture); a `set_state_dict` that
    rebinds a frozen ``wte`` (one re-capture, tokens equal to a fresh
    model's with those weights)."""
    with tdevice.device_scope(dev):
        model = gpt_mod.gpt2_small(
            generator=torch.Generator().manual_seed(SEED),
            hidden_dropout=0.0, attention_dropout=0.0)
    cfg = model.cfg
    cpu_params = {k: v.cpu() for k, v in torch_state(model).items()}
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, min(VOCAB, cfg.vocab_size), n)
               .astype(np.int32) for n in SERVE_LENS]
    n = GENERATE_TOKENS

    def ids(p):
        return PTensor(torch.from_numpy(np.asarray(p)).to(dev))

    fast, reserved, capture_s = [], [], []
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    for p in prompts:          # 8 signatures, one shared pool
        fast.append(model.fast_generate(ids(p[None]), max_new_tokens=n)
                    .numpy()[0])
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev) - reserved0)
        capture_s.append(model._fast_decode_cache[
            (1, len(p), n, 1.0, 0, "float32")].capture_seconds)
    eager = [model.generate(ids(p[None]), max_new_tokens=n).numpy()[0]
             for p in prompts]
    greedy = fast_vs_eager(fast, eager, prompts, (1.0, 0, 0), cfg,
                           cpu_params)
    cached = len(model._fast_decode_cache)

    b, s0, ns = FAST_SAMPLED_SHAPE
    temp, top_k, seed = FAST_SAMPLED
    batch = rng.integers(0, min(VOCAB, cfg.vocab_size), (b, s0)).astype(
        np.int32)
    kw = dict(max_new_tokens=ns, temperature=temp, top_k=top_k, seed=seed)
    sf = model.fast_generate(ids(batch), **kw).numpy()
    se = model.generate(ids(batch), **kw).numpy()
    sampled = fast_vs_eager(sf, se, list(batch), FAST_SAMPLED, cfg,
                            cpu_params, rows=b)

    # wte written in place: the graph reads the new values
    sig = (1, len(prompts[1]), n, 1.0, 0, "float32")
    prog = model._fast_decode_cache[sig]
    recaptures0 = metrics.counter("generate.recaptures").value
    wte = model.gpt.wte.weight
    noise = torch.randn(wte.shape, generator=torch.Generator().manual_seed(
        SEED + 5)).to(dev) * 0.02
    wte._write(wte._data + noise)
    moved = model.fast_generate(ids(prompts[1][None]),
                                max_new_tokens=n).numpy()[0]
    moved_eager = model.generate(ids(prompts[1][None]),
                                 max_new_tokens=n).numpy()[0]
    in_place = {"tokens_changed": bool(not np.array_equal(moved, fast[1])),
                "captures": prog.captures,
                "recaptures": metrics.counter("generate.recaptures").value
                - recaptures0,
                "vs_eager": fast_vs_eager(
                    [moved], [moved_eager], prompts[1:2], (1.0, 0, 0), cfg,
                    {**cpu_params, "gpt.wte.weight": wte._data.cpu()})}

    # a frozen wte rebound by set_state_dict: one re-capture
    wte.stop_gradient = True
    new = (wte._data + noise).detach().clone()
    model.set_state_dict({"gpt.wte.weight": new})
    rebound = model.gpt.wte.weight._data.data_ptr() == new.data_ptr()
    after = model.fast_generate(ids(prompts[1][None]),
                                max_new_tokens=n).numpy()[0]
    with tdevice.device_scope(dev):
        fresh = gpt_mod.gpt2_small(
            generator=torch.Generator().manual_seed(SEED),
            hidden_dropout=0.0, attention_dropout=0.0)
    fresh.set_state_dict({"gpt.wte.weight": new.clone()})
    want = fresh.fast_generate(ids(prompts[1][None]),
                               max_new_tokens=n).numpy()[0]
    rebind = {"rebound": rebound, "captures": prog.captures,
              "recaptures": metrics.counter("generate.recaptures").value
              - recaptures0 - in_place["recaptures"],
              "tokens_equal_fresh_model": bool(np.array_equal(after, want)),
              "tokens_changed": bool(not np.array_equal(after, moved))}
    del model, fresh
    return {"greedy": greedy, "signatures_cached": cached,
            "reserved_bytes_over_weights_after_each_capture": reserved,
            "capture_seconds": capture_s, "sampled": sampled,
            "sampled_params": list(FAST_SAMPLED),
            "sampled_shape": list(FAST_SAMPLED_SHAPE),
            "in_place_write": in_place, "set_state_dict_rebind": rebind}


def generate_fast(dev, smi):
    """`fast_generate` on the card, one captured CUDA graph a signature:
    the bench's `bench_decode` and `bench_engine_decode` (GPT-2 small,
    float32, from ``paddle.seed(0)``) and the gates of `fast_arms`. Every
    kernel's launch count is read around the decode runs (none: the
    program's attention is dense, as in the JAX package) and around the
    engine's run (the paged kernels, `engine_launches`)."""
    phase = "generate_fast"
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()                       # bench_decode's run
    decode = bench_decode(dev)
    fast_launches = read_launches(phase, {})
    arms = fast_arms(dev)
    engine = bench_engine_decode(dev, phase)
    ok = (decode["second_call_equal"] and decode["shape_ok"]
          and decode["graph_kernel_launches"] == {}
          and gated(arms["greedy"]) and gated(arms["sampled"])
          and arms["signatures_cached"] == len(SERVE_LENS)
          and arms["in_place_write"]["tokens_changed"]
          and arms["in_place_write"]["captures"] == 1
          and arms["in_place_write"]["recaptures"] == 0
          and gated(arms["in_place_write"]["vs_eager"])
          and arms["set_state_dict_rebind"]["rebound"]
          and arms["set_state_dict_rebind"]["captures"] == 2
          and arms["set_state_dict_rebind"]["recaptures"] == 1
          and arms["set_state_dict_rebind"]["tokens_equal_fresh_model"]
          and engine["tokens_equal"])
    line = {"phase": phase, "model": "gpt2-small", "dtype": "float32",
            "card": smi, "bench_decode": {
                "batch": DECODE_B, "prompt": DECODE_S0,
                "new_tokens": DECODE_N, **decode},
            "bench_engine_decode": engine, **arms,
            "margin_gate": MARGIN, "launches": fast_launches,
            "clocks": card_clocks(), "ok": bool(ok)}
    emit(line)
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"{phase}: a gate failed")
    return engine["launches"]


# ----------------------------------------------------------------- quant
QUANT_CFG = dict(vocab_size=1024, hidden_size=256, num_layers=4,
                 num_heads=4, intermediate_size=1024,
                 hidden_dropout=0.0, attention_dropout=0.0)
QUANT_S, QUANT_N, QUANT_PS = 48, 24, 16           # bench.py:1024
COMMS_NUMEL = 1 << 20                             # the bench's gradient
DRILL_WORLD = 2


def int8_kv_prefill_parity(model, cfg, prompt, pps, page_size, dev):
    """`_int8_kv_prefill_parity` (`bench.py:968-995`) in torch: one
    prefill on float32 pages against int8 pages and scales, the
    margin-gated parity at its default bound. The bench passes one zero
    pool as both K and V (JAX arrays are immutable); the port writes its
    pools in place, so each gets its own."""
    params = torch_state(model)
    nh, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    nl = cfg.num_layers
    s0 = int(prompt.size)
    need = -(-s0 // page_size)
    npg = 1 + need
    row = F.pad(torch.arange(1, npg, dtype=torch.int32, device=dev),
                (0, pps - need))
    ids = torch.from_numpy(np.asarray(prompt, np.int32)).to(dev)

    def zeros(dtype, shape=(nl, npg, page_size, nh, dh)):
        return torch.zeros(shape, dtype=dtype, device=dev)

    lg_f = gpt_mod.prefill_step(params, ids, s0, row, zeros(torch.float32),
                                zeros(torch.float32), cfg=cfg)[0]
    lg_q = gpt_mod.prefill_step(
        params, ids, s0, row, zeros(torch.int8), zeros(torch.int8),
        cfg=cfg, k_scale=zeros(torch.float32, (nl, npg, page_size, nh)),
        v_scale=zeros(torch.float32, (nl, npg, page_size, nh)))[0]
    return margin_gated_parity(lg_f, lg_q)


def bench_quant(dev):
    """`bench_quant` (`bench.py:998-1110`) on the port: its three claims,
    each asserted. Lines changed: the ids as torch tensors in the parity
    harness (`int8_kv_prefill_parity`), and the gradient read back with
    ``.numpy()`` / ``.cpu()`` where the bench calls ``np.asarray`` on a
    device array (`bench.py:1093, 1101-1102`)."""
    paddle.seed(0)
    S, N, PS = QUANT_S, QUANT_N, QUANT_PS
    cfg = gpt_mod.GPTConfig(**QUANT_CFG, max_position_embeddings=S + N)
    with tdevice.device_scope(dev):
        model = gpt_mod.GPTForCausalLM(cfg)
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, cfg.vocab_size, S).astype(np.int32)

    f32_slots = 4
    probe = {}
    for kvd in ("f32", "int8"):
        e = DecodeEngine(model, EngineConfig(page_size=PS, max_slots=1,
                                             max_seq_len=S + N,
                                             kv_dtype=kvd), device=dev)
        probe[kvd] = (e.kv_bytes_per_token, e.pages_per_slot)
        del e
    pps = probe["f32"][1]
    page_bytes = {k: v[0] * PS for k, v in probe.items()}
    pool_bytes = (1 + f32_slots * pps) * page_bytes["f32"]
    int8_pages = pool_bytes // page_bytes["int8"]
    int8_slots = int((int8_pages - 1) // pps)
    slot_ratio = int8_slots / f32_slots
    assert slot_ratio >= 1.9, (
        f"int8 KV admits only {int8_slots} slots vs f32's {f32_slots} at "
        f"{pool_bytes} pool bytes — expected >= 1.9x")

    def run(kv_dtype, max_slots, num_pages, nreq):
        eng = DecodeEngine(model, EngineConfig(
            page_size=PS, max_slots=max_slots, max_seq_len=S + N,
            num_pages=num_pages, prefix_cache=False, kv_dtype=kv_dtype),
            device=dev)
        eng.warmup(prompt_lens=[S])
        r = eng.submit(prompt, max_new_tokens=2)       # prime execution
        eng.run_until_idle(max_steps=100)
        r.result(timeout=300)
        prompts = [rng.randint(0, cfg.vocab_size, S).astype(np.int32)
                   for _ in range(nreq)]
        counters0 = dict(eng.counters)
        reset_launches()                   # the engine's run
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=N) for p in prompts]
        eng.run_until_idle(max_steps=4000)
        outs = [r.result(timeout=300) for r in reqs]
        dt = time.perf_counter() - t0
        launches.append(engine_launches(eng, counters0, "quant_comms")[0])
        return outs, nreq * N / dt

    launches = []
    f32_outs, f32_tps = run("f32", f32_slots, 1 + f32_slots * pps,
                            f32_slots)
    int8_outs, int8_tps = run("int8", int8_slots, int(int8_pages),
                              int8_slots)

    logit_diff, kv_quant_ok = int8_kv_prefill_parity(model, cfg, prompt,
                                                     pps, PS, dev)
    assert kv_quant_ok, (
        f"int8 KV parity violated: logit diff {logit_diff:.4f} vs bound "
        f"{QUANT_LOGIT_BOUND}")

    with tdevice.device_scope(dev):
        grad = paddle.to_tensor(rng.randn(COMMS_NUMEL).astype(np.float32))

    def bytes_now():
        snap = metrics.snapshot()["counters"]
        return sum(v for k, v in snap.items()
                   if k.startswith("collective.bytes"))
    b0 = bytes_now()
    tcoll.all_reduce(grad)
    plain_bytes = bytes_now() - b0
    with tdevice.device_scope(dev):
        gq = paddle.to_tensor(grad.numpy().copy())
    b1 = bytes_now()
    tcoll.all_reduce(gq, quantized=True)
    quant_bytes = bytes_now() - b1
    payload_ratio = plain_bytes / max(1, quant_bytes)
    assert payload_ratio >= 3.0, (
        f"quantized allreduce moved {quant_bytes} bytes vs {plain_bytes} "
        f"plain — expected >= 3x reduction")
    err = np.abs(gq.numpy() - grad.numpy())
    bound = tcomms.roundtrip_bound(grad._data).cpu().numpy()
    assert (err <= bound + 1e-7).all(), "allreduce error outside the bound"

    del model
    return dict(slot_ratio=slot_ratio, f32_slots=f32_slots,
                int8_slots=int8_slots, pool_bytes=int(pool_bytes),
                f32_tok_s=f32_tps, int8_tok_s=int8_tps,
                logit_diff=logit_diff, kv_quant_ok=kv_quant_ok,
                payload_ratio=payload_ratio,
                plain_bytes=int(plain_bytes), quant_bytes=int(quant_bytes),
                requests_ok=all(len(o) == S + N for o in f32_outs + int8_outs)
                and len(int8_outs) == int8_slots,
                comms_max_err=float(err.max()),
                comms_within_bound=bool((err <= bound + 1e-7).all()),
                grad_device=str(grad._data.device),
                launches={k: sum(ln[k] for ln in launches)
                          for k in launches[0]})


def round_trip(x, block, dev):
    """One rank's codec round trip on ``dev`` (the device its rank ran
    on: the card's scales may sit an ulp off the CPU's, ROADMAP C25) and
    its bound."""
    t = torch.from_numpy(x).to(dev)
    return tcomms.dequantize_blockwise(
        *tcomms.quantize_blockwise(t, block)).cpu().numpy(), \
        tcomms.roundtrip_bound(t, block).cpu().numpy()


def drill_checks(out, world, numel, dev):
    """The world-2 drill's results (`testing/collective_drill.py`) against
    numpy's closed forms; each quantized call against the sum of every
    rank's codec round trip on ``dev`` (equal, reported) and within the
    sum of their bounds of the exact result (the gate); the byte counters against the JAX package's formula (the
    payload's bytes; a quantized call's int8 blocks and f32 scales)."""
    xs = [collective_drill.inputs(r, numel) for r in range(world)]
    arrays = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
              for r in range(world)]
    recs = [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(world)]
    total = xs[0].copy()
    for x in xs[1:]:
        total = total + x
    rows = numel // world
    closed = {"all_reduce/sum": lambda r: total,
              "all_reduce/avg": lambda r: total / np.float32(world),
              "all_reduce/max": lambda r: np.max(xs, axis=0),
              "all_reduce/min": lambda r: np.min(xs, axis=0),
              "all_reduce/prod": lambda r: np.prod(xs, axis=0),
              "broadcast": lambda r: xs[world - 1],
              "scatter": lambda r: np.split(xs[0], world)[r],
              "reduce_scatter": lambda r: np.sum(
                  [np.split(x, world)[r] for x in xs], axis=0),
              "alltoall_single": lambda r: np.concatenate(
                  [np.split(x, world)[r] for x in xs])}
    checks = {}
    for name, fn in closed.items():
        checks[name] = all(np.array_equal(arrays[r][f"{name}/0"], fn(r))
                           for r in range(world))
    checks["all_gather"] = all(np.array_equal(arrays[r][f"all_gather/{p}"],
                                              xs[p])
                               for r in range(world) for p in range(world))
    checks["alltoall"] = all(np.array_equal(
        arrays[r][f"alltoall/{p}"], np.split(xs[p], world)[r])
        for r in range(world) for p in range(world))
    sends = [collective_drill.alltoall_single_splits(p, world, numel)[0]
             for p in range(world)]
    checks["alltoall_single_uneven"] = all(np.array_equal(
        arrays[r]["alltoall_single_uneven/0"], np.concatenate(
            [np.split(xs[p], np.cumsum(sends[p])[:-1])[r]
             for p in range(world)])) for r in range(world))
    checks["p2p"] = all(np.array_equal(
        arrays[r][f"p2p/{i}"], xs[(r - 1) % world] * np.float32(i + 1))
        for r in range(world) for i in range(collective_drill.P2P_ROUNDS))
    checks["isend_irecv"] = all(np.array_equal(
        arrays[r]["isend_irecv/0"], xs[(r - 1) % world] + np.float32(1.0))
        for r in range(world))
    bf = [torch.from_numpy(x).bfloat16().float() for x in xs]
    checks["all_reduce/sum_bf16"] = all(np.array_equal(
        arrays[r]["all_reduce/sum_bf16/0"],
        sum(bf[1:], bf[0]).bfloat16().float().numpy())
        for r in range(world))
    checks["all_gather_object"] = all(
        rec["objects"] == [{"rank": p, "tag": "r" * (p + 1)}
                           for p in range(world)] for rec in recs)
    quant = {}
    for op in ("sum", "avg"):
        for block in collective_drill.QUANT_BLOCKS:
            b = block or tcomms.DEFAULT_BLOCK
            trips = [round_trip(x, b, dev) for x in xs]
            want = trips[0][0].copy()
            bound = trips[0][1].copy()
            for dq, bd in trips[1:]:
                want, bound = want + dq, bound + bd
            exact = total
            if op == "avg":
                want, bound, exact = (v / np.float32(world)
                                      for v in (want, bound, exact))
            name = f"all_reduce_quantized/{op}/{block or 'default'}"
            got = [arrays[r][f"{name}/0"] for r in range(world)]
            nblocks = -(-numel // b)
            quant[name] = {
                "max_err": max(float(np.abs(g - exact).max()) for g in got),
                "within_bound": all(bool((np.abs(g - exact)
                                          <= bound + 1e-6).all())
                                    for g in got),
                "equal_round_trip_sum": all(np.array_equal(g, want)
                                            for g in got),
                "bytes_ok": all(rec["ops"][name]["counts"] == {
                    "collective.calls{mode=eager,op=all_reduce}": 1,
                    "collective.bytes{mode=eager,op=all_reduce}":
                        nblocks * b + nblocks * 4,
                    "collective.quantized_calls": 1} for rec in recs)}
    nb = numel * 4
    byte_ops = {"all_reduce/sum": ("all_reduce", nb),
                "all_reduce/sum_bf16": ("all_reduce", numel * 2),
                "all_gather": ("all_gather", nb),
                "broadcast": ("broadcast", nb),
                "reduce_scatter": ("reduce_scatter", nb),
                "alltoall": ("alltoall", nb),
                "alltoall_single": ("alltoall_single", nb),
                "send/0": ("send", nb), "recv/0": ("recv", nb)}
    checks["bytes"] = all(rec["ops"][name]["counts"] == {
        f"collective.calls{{mode=eager,op={op}}}": 1,
        f"collective.bytes{{mode=eager,op={op}}}": n}
        for rec in recs for name, (op, n) in byte_ops.items())
    checks["refusals"] = all(
        rec["ops"][f"quantized_refused/{op}"]
        == f"quantized all_reduce supports SUM/AVG, got {op!r}"
        for rec in recs for op in ("max", "min", "prod"))
    checks["tasks_done"] = all(rec["tasks_done"] == [True, True]
                               for rec in recs)
    checks["groups"] = all(rec["groups"]["new_group"] == list(range(world))
                           and rec["groups"]["rank_in_g"] == rec["rank"]
                           for rec in recs)
    checks["on_the_card"] = all(rec["device"].startswith("cuda")
                                for rec in recs)
    ms = {name: statistics.median(rec["ops"][name]["seconds"] * 1e3
                                  for rec in recs)
          for name in recs[0]["ops"]
          if isinstance(recs[0]["ops"][name], dict)}
    return checks, quant, ms


def quant_comms(dev, smi):
    """`bench_quant`'s three claims on the card (`bench_quant`), then the
    world-2 arm: two rank processes of `testing/collective_drill.py` on
    this card, joined by `init_parallel_env` over the fleet's TCPStore as
    `train_elastic`'s ranks are, run every collective on CUDA tensors of
    COMMS_NUMEL values (`drill_checks`). NCCL cannot put two ranks on one
    device, and the JAX transport is the key-value store: the arm's ms
    a call are that host transport's, not NCCL's."""
    phase = "quant_comms"
    gc.collect()
    torch.cuda.empty_cache()
    figures = bench_quant(dev)
    work = tempfile.mkdtemp(prefix="quant_comms_")
    try:
        t0 = time.perf_counter()
        rcs = collective_drill.spawn(DRILL_WORLD, work, "cuda", COMMS_NUMEL,
                                     env=worker_env(), timeout=600)
        drill_s = time.perf_counter() - t0
        logs = [open(os.path.join(work, f"rank{r}.log"),
                     errors="replace").read()[-3000:]
                for r in range(DRILL_WORLD)]
        checks, quant, ms = drill_checks(work, DRILL_WORLD, COMMS_NUMEL,
                                         dev) \
            if rcs == [0] * DRILL_WORLD else ({}, {}, {})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = (figures["slot_ratio"] >= 1.9 and figures["kv_quant_ok"]
          and figures["payload_ratio"] >= 3.0
          and figures["comms_within_bound"] and figures["requests_ok"]
          and rcs == [0] * DRILL_WORLD and bool(checks)
          and all(checks.values())
          and all(q["within_bound"] and q["bytes_ok"]
                  for q in quant.values()))
    emit({"phase": phase, "card": smi, "bench_quant": figures,
          "world2": {"rcs": rcs, "numel": COMMS_NUMEL, "seconds": drill_s,
                     "transport": "TCPStore through the host (not NCCL)",
                     "checks": checks, "quantized": quant,
                     "ms_a_call": ms},
          "clocks": card_clocks(), "ok": bool(ok)})
    if not ok:
        for r, log in enumerate(logs):
            sys.stderr.write(f"--- {phase} rank {r}:\n{log}\n")
        raise SystemExit(f"{phase}: a claim or a check failed")
    return figures["launches"]


# ------------------------------------------ the data pipeline and Model.fit

FIT_ROWS, FIT_SEQ = 48, 1024        # gpt_fused's dataset: 48 rows of 1025 ids
FIT_BATCH, FIT_ACCUM = 8, 2         # 6 loader batches, 3 steps of 2 x 8
FIT_WORKERS = 2
FIT_LR = 1e-4                       # the train phase's AdamW (clip 1.0)
RESNET_FIT_BATCH = 32
RESNET_FIT_PARITY_STEPS = 4         # seeded, in-process, against a hand loop
RESNET_FIT_TIMED_STEPS = 8          # with RESNET_FIT_WORKERS shm workers
RESNET_FIT_WORKERS = 4
DL_BATCH, DL_WORKERS = 64, 4        # bench_dataloader's
DL_PUMP_SIZE, DL_OVERLAP_SIZE = 512, 2048
DL_OVERLAP_DRAIN = 8                # batches drawn before the timed window

_PROBED: dict = {}


def note_worker(probe_dir, parent):
    """In a process other than ``parent``: write whether it holds a CUDA
    context into ``probe_dir/<pid>`` when that is new (a DataLoader worker
    must never hold one). Called as a worker unpickles its dataset and at
    each sample, so every worker reports, whether or not it fetched."""
    pid = os.getpid()
    if probe_dir is None or pid == parent:
        return
    state = bool(torch.cuda.is_initialized())
    if _PROBED.get(pid) == state:
        return
    _PROBED[pid] = state
    with open(os.path.join(probe_dir, str(pid)), "w") as f:
        json.dump(state, f)


class WorkerProbe:
    """Mixin of the datasets workers fetch from: `note_worker` as the
    worker unpickles the dataset and at each sample."""

    def __setstate__(self, state):
        self.__dict__.update(state)
        note_worker(self.probe_dir, self.parent)


def read_probes(probe_dir):
    """{worker pid: CUDA initialised} since the last read; empties the
    directory."""
    out = {}
    for name in os.listdir(probe_dir):
        with open(os.path.join(probe_dir, name)) as f:
            out[int(name)] = json.load(f)
        os.remove(os.path.join(probe_dir, name))
    return out


class TokenRows(WorkerProbe, paddle.io.Dataset):
    """FIT_ROWS rows of FIT_SEQ + 1 token ids drawn with numpy from ``SEED``
    (ids, next-token labels). Module-level, as every dataset and
    transform here: spawn workers unpickle them."""

    def __init__(self, probe_dir=None):
        rng = np.random.default_rng(SEED + 28)
        self.rows = rng.integers(0, VOCAB, (FIT_ROWS, FIT_SEQ + 1)).astype(
            np.int32)
        self.probe_dir, self.parent = probe_dir, os.getpid()

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        note_worker(self.probe_dir, self.parent)
        return self.rows[i][:-1], self.rows[i][1:].astype(np.int64)


class ProbedFakeData(WorkerProbe, paddle.vision.datasets.FakeData):
    """`FakeData` whose workers report their CUDA state (`note_worker`)."""

    def __init__(self, probe_dir=None, **kw):
        super().__init__(**kw)
        self.probe_dir, self.parent = probe_dir, os.getpid()

    def __getitem__(self, idx):
        note_worker(self.probe_dir, self.parent)
        return super().__getitem__(idx)


def _chw_to_hwc_u8(img):
    """CHW float [0, 1] -> HWC uint8 (`bench.py`'s helper): the jitter
    family works on image-range uint8 as on decoded inputs."""
    return (img.transpose(1, 2, 0) * 255).astype(np.uint8)


def _hwc_u8_to_chw(img):
    return np.ascontiguousarray(
        np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0)


def _host_collate(batch):
    """The pipeline alone (workers and transport), not the host-to-card
    copy: the images stacked as numpy (`bench.py`'s)."""
    return np.stack([b[0] for b in batch])


def resize_branch():
    """The branch `vision.transforms.Resize` takes for uint8 images here:
    PIL's C path when PIL imports, else the numpy bilinear."""
    try:
        from PIL import Image  # noqa: F401
        return "pil"
    except Exception:
        return "numpy"


class BatchClock(paddle.callbacks.Callback):
    """A fit's train batches: each one's begin and end on the host clock
    (the end after `train_batch`'s loss readback, or after a fused step's
    group) and its logs."""

    def __init__(self):
        super().__init__()
        self.begin, self.end, self.logs = [], [], []

    def on_train_batch_begin(self, step, logs=None):
        self.begin.append(time.perf_counter())

    def on_train_batch_end(self, step, logs=None):
        self.end.append(time.perf_counter())
        self.logs.append(dict(logs or {}))


def fit_gpt(dev, seed=SEED):
    """GPT-2 small as `train_run` trains it (bf16 on f32 masters, no
    dropout) on ``dev`` and a hapi Model over it with the eager AdamW."""
    net = host_gpt2_small(generator=torch.Generator().manual_seed(seed),
                          hidden_dropout=0.0, attention_dropout=0.0)
    net = net.to(torch.bfloat16).to(dev)
    opt = paddle.optimizer.AdamW(learning_rate=FIT_LR, clip_norm=1.0,
                                 parameters=net.parameters())
    return paddle.Model(net).prepare(optimizer=opt)


def host_params(net):
    return {k: v.detach().cpu() for k, v in torch_state(net).items()}


def same_params(a, b):
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def fit_gpt_fused(dev, probe_dir):
    """The fused route at full width: `Model.fit` over `TokenRows` with
    FIT_WORKERS shm workers, k = FIT_ACCUM (3 steps of 2 microbatches of
    8), against `ScanTrainStep(microbatches=2)` stepped directly on the
    same three concatenated groups from the same weights; then a fit
    preempted after epoch 0 by `CheckpointManager` and resumed by a fresh
    Model against an uninterrupted 2-epoch fit. Returns the arm's line
    and the flash launches of the main fit."""
    gc.collect()
    torch.cuda.empty_cache()
    ds = TokenRows(probe_dir=probe_dir)
    hm = fit_gpt(dev)
    clock = BatchClock()
    reset_launches()
    t0 = time.perf_counter()
    hm.fit(ds, batch_size=FIT_BATCH, epochs=1, shuffle=False, verbose=0,
           accumulate_grad_batches=FIT_ACCUM, num_workers=FIT_WORKERS,
           callbacks=[clock])
    torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    steps = FIT_ROWS // (FIT_BATCH * FIT_ACCUM)
    expected = train_launches(hm.network.cfg, FIT_ACCUM, steps)
    launches = read_launches("fit_hapi", expected)
    workers = read_probes(probe_dir)
    fused = hm._fused_step
    fitted = host_params(hm.network)
    del hm
    # the direct step on the same groups
    net = host_gpt2_small(generator=torch.Generator().manual_seed(SEED),
                          hidden_dropout=0.0, attention_dropout=0.0)
    step = ScanTrainStep(net.to(torch.bfloat16),
                         AdamW(learning_rate=FIT_LR, clip_norm=1.0),
                         microbatches=FIT_ACCUM, device=dev)
    group = FIT_BATCH * FIT_ACCUM
    ends = []
    for g in range(steps):
        rows = ds.rows[g * group:(g + 1) * group]
        step.step(rows[:, :-1], rows[:, 1:].astype(np.int64))
        ends.append(time.perf_counter())
    step.sync_to_model()
    direct = host_params(net)
    fit_equal = same_params(fitted, direct)
    tokens = group * FIT_SEQ
    group_ends = clock.end[FIT_ACCUM - 1::FIT_ACCUM]
    fit_tps = tokens * (steps - 1) / (group_ends[-1] - group_ends[0])
    direct_tps = tokens * (steps - 1) / (ends[-1] - ends[0])
    del step, net, fused, fitted, direct
    gc.collect()
    torch.cuda.empty_cache()
    # preempted after epoch 0 and resumed, against an uninterrupted fit
    root = tempfile.mkdtemp(prefix="fit_hapi_ckpt_")
    try:
        kw = dict(batch_size=FIT_BATCH, shuffle=False, verbose=0,
                  accumulate_grad_batches=FIT_ACCUM)
        ref = fit_gpt(dev)
        ref.fit(ds, epochs=2, **kw)
        want = host_params(ref.network)
        del ref
        part1 = fit_gpt(dev)
        part1.fit(ds, epochs=1, checkpoint_manager=CheckpointManager(root),
                  **kw)
        del part1
        part2 = fit_gpt(dev, seed=SEED + 77)
        mgr = CheckpointManager(root)
        part2.fit(ds, epochs=2, checkpoint_manager=mgr, **kw)
        resumed = host_params(part2.network)
        latest = mgr.latest()[0]
        del part2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    resume_equal = same_params(resumed, want)
    del resumed, want
    gc.collect()
    torch.cuda.empty_cache()
    line = {"arm": "gpt_fused", "model": "gpt2-small", "dtype": "bfloat16",
            "master_weights": "float32", "rows": FIT_ROWS, "seq": FIT_SEQ,
            "batch_size": FIT_BATCH, "accumulate_grad_batches": FIT_ACCUM,
            "optimizer_steps": steps, "num_workers": FIT_WORKERS,
            "transport": "shm", "hidden_dropout": 0.0,
            "fit_seconds": fit_s, "fit_tokens_per_s": fit_tps,
            "direct_tokens_per_s": direct_tps,
            "fit_over_direct": fit_tps / direct_tps,
            "fit_bit_equal_direct": fit_equal,
            "resume_bit_equal_uninterrupted": resume_equal,
            "resume_latest_step": latest, "launches": launches,
            "expected_launches": expected,
            "workers_cuda_initialised": workers}
    line["ok"] = bool(fit_equal and resume_equal and latest == 2 * steps
                      and len(workers) == FIT_WORKERS
                      and not any(workers.values()))
    return line, {k: launches[k] for k in FLASH_KERNELS}


def fit_transform(size=224):
    T = paddle.vision.transforms
    return T.Compose([_chw_to_hwc_u8, T.RandomResizedCrop(size),
                      T.RandomHorizontalFlip(), _hwc_u8_to_chw])


def resnet_fit_model(dev):
    model = resnet_model(dev)
    opt = paddle.optimizer.Momentum(learning_rate=RESNET_LR, momentum=0.9,
                                    parameters=model.parameters(),
                                    weight_decay=1e-4)
    return model, opt


def seed_host():
    random.seed(SEED)
    np.random.seed(SEED)


def resnet_hand_loop(dev, ds, steps):
    """The eager loop a user writes by hand over the same seeded batches:
    `Model.train_batch`'s calls, one optimizer step a batch."""
    model, opt = resnet_fit_model(dev)
    loss_fn = paddle.nn.CrossEntropyLoss()
    acc = paddle.metric.Accuracy(topk=(1, 5))
    seed_host()
    loader = paddle.io.DataLoader(ds, batch_size=RESNET_FIT_BATCH,
                                  shuffle=True)
    losses, accs = [], []
    for i, (x, y) in enumerate(loader):
        if i == steps:
            break
        model.train()
        out = model(x)
        loss = loss_fn(out, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        acc.update(acc.compute(out, y))
        losses.append(float(loss.numpy()))
        accs.append(acc.accumulate())
    return losses, accs, host_params(model)


def fit_resnet(dev, probe_dir):
    """The eager route at full width: `resnet50()` in float32, Momentum,
    `CrossEntropyLoss`, `Accuracy(topk=(1, 5))`, over `FakeData` images
    of 256 x 256 cropped to 224 by the transforms. Seeded and in-process
    (cuDNN deterministic), RESNET_FIT_PARITY_STEPS steps equal a hand loop
    bit for bit; then RESNET_FIT_TIMED_STEPS steps with shm workers,
    timed. Returns the arm's line and the batch norm launches of the timed
    run."""
    gc.collect()
    torch.cuda.empty_cache()
    n = RESNET_FIT_BATCH * RESNET_FIT_PARITY_STEPS
    ds = ProbedFakeData(size=n, image_shape=(3, 256, 256), num_classes=1000,
                        transform=fit_transform())
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model, opt = resnet_fit_model(dev)
        hm = paddle.Model(model).prepare(
            optimizer=opt, loss=paddle.nn.CrossEntropyLoss(),
            metrics=paddle.metric.Accuracy(topk=(1, 5)))
        clock = BatchClock()
        seed_host()
        hm.fit(ds, batch_size=RESNET_FIT_BATCH, epochs=1, verbose=0,
               callbacks=[clock])
        fit_losses = [lg["loss"] for lg in clock.logs]
        fit_accs = [lg["acc_top1"] for lg in clock.logs]
        fitted = host_params(model)
        hand_losses, hand_accs, hand = resnet_hand_loop(
            dev, ds, RESNET_FIT_PARITY_STEPS)
        flags = cudnn_flags()
    finally:
        torch.backends.cudnn.deterministic = prev
    parity = {"losses_equal": fit_losses == hand_losses,
              "accuracies_equal": fit_accs == hand_accs,
              "params_bit_equal": same_params(fitted, hand),
              "steps": RESNET_FIT_PARITY_STEPS, "cudnn": flags,
              "losses": fit_losses,
              "accuracies": [[float(v) for v in a] for a in fit_accs]}
    del fitted, hand
    timed = ProbedFakeData(probe_dir, size=RESNET_FIT_BATCH
                           * RESNET_FIT_TIMED_STEPS,
                           image_shape=(3, 256, 256), num_classes=1000,
                           transform=fit_transform())
    clock = BatchClock()
    reset_launches()
    t0 = time.perf_counter()
    hm.fit(timed, batch_size=RESNET_FIT_BATCH, epochs=1, verbose=0,
           num_workers=RESNET_FIT_WORKERS, callbacks=[clock])
    wall = time.perf_counter() - t0
    launches = read_launches("fit_hapi", {
        k: RESNET_NORMS * RESNET_FIT_TIMED_STEPS for k in BN_KERNELS})
    workers = read_probes(probe_dir)
    # the steady window: from the first batch's end to the last's (the
    # first batch waits for the workers to start)
    window = clock.end[-1] - clock.end[0]
    blocked = sum(b - e for b, e in zip(clock.begin[1:], clock.end[:-1]))
    step_s = [e - b for b, e in zip(clock.begin, clock.end)]
    del hm, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    line = {"arm": "resnet_fit", "model": "resnet50", "dtype": "float32",
            "optimizer": "Momentum", "batch_size": RESNET_FIT_BATCH,
            "image": [3, 224, 224], "source_image": [3, 256, 256],
            "transforms": "RandomResizedCrop(224), RandomHorizontalFlip",
            "resize_branch": resize_branch(), "parity": parity,
            "timed_steps": RESNET_FIT_TIMED_STEPS,
            "num_workers": RESNET_FIT_WORKERS, "transport": "shm",
            "fit_seconds": wall,
            "images_per_s": RESNET_FIT_BATCH * (RESNET_FIT_TIMED_STEPS - 1)
            / window,
            "loader_blocked_share": blocked / window,
            "train_batch_ms_p50": statistics.median(step_s[1:]) * 1e3,
            "first_batch_wait_s": clock.begin[0] - t0,
            "launches": launches, "workers_cuda_initialised": workers,
            "last_loss": clock.logs[-1]["loss"]}
    line["ok"] = bool(parity["losses_equal"] and parity["accuracies_equal"]
                      and parity["params_bit_equal"]
                      and len(workers) == RESNET_FIT_WORKERS
                      and not any(workers.values())
                      and np.isfinite(line["last_loss"]))
    return line, {k: launches[k] for k in BN_KERNELS}


def bench_dataloader(dev, probe_dir):
    """`bench.py:1768-1860` on the port: the raw pump (workers only
    produce) and the overlap (each batch followed by a device step and a
    synchronous readback: a bf16 [4096, 4096] product on the card, scaled
    and summed in f32, read back with ``float()``), in-process and with
    DL_WORKERS shm workers, on the bench's datasets at batch 64. Returns
    the arm's line and no launches (no kernel of the port runs here)."""
    T = paddle.vision.transforms
    from paddle_tpu_torch.framework.flags import set_flags
    aug = T.Compose([_chw_to_hwc_u8, T.RandomResizedCrop(224),
                     T.RandomHorizontalFlip(), T.ColorJitter(0.4, 0.4, 0.4),
                     _hwc_u8_to_chw])
    ds = ProbedFakeData(probe_dir, size=DL_PUMP_SIZE,
                        image_shape=(3, 256, 256), transform=aug)
    aug_small = T.Compose([_chw_to_hwc_u8, T.RandomResizedCrop(28),
                           T.RandomHorizontalFlip(), _hwc_u8_to_chw])
    ds_small = ProbedFakeData(probe_dir, size=DL_OVERLAP_SIZE,
                              image_shape=(3, 32, 32), transform=aug_small)
    a = torch.ones((4096, 4096), dtype=torch.bfloat16, device=dev)

    def device_step():
        return float(((a @ a).float() * (1.0 / 4096)).sum())

    def pump(num_workers, use_shared_memory):
        dl = paddle.io.DataLoader(ds, batch_size=DL_BATCH,
                                  num_workers=num_workers,
                                  use_shared_memory=use_shared_memory,
                                  drop_last=True, collate_fn=_host_collate)
        it = iter(dl)
        next(it)                      # worker start-up outside the window
        n, t0 = 0, time.perf_counter()
        for _ in it:
            n += 1
        return n * DL_BATCH / (time.perf_counter() - t0)

    def overlap(num_workers):
        device_step()
        dl = paddle.io.DataLoader(ds_small, batch_size=DL_BATCH,
                                  num_workers=num_workers,
                                  use_shared_memory=num_workers > 0,
                                  drop_last=True, collate_fn=_host_collate)
        it = iter(dl)
        for _ in range(DL_OVERLAP_DRAIN):
            next(it)
        n, t0 = 0, time.perf_counter()
        for _ in it:
            device_step()
            n += 1
        return n * DL_BATCH / (time.perf_counter() - t0)

    set_flags({"FLAGS_dataloader_auto_fallback": False})
    try:
        figures = {"pump_in_process": pump(0, False),
                   "pump_shm_workers": pump(DL_WORKERS, True)}
        pump_workers = read_probes(probe_dir)
        figures["overlap_in_process"] = overlap(0)
        figures["overlap_shm_workers"] = overlap(DL_WORKERS)
        overlap_workers = read_probes(probe_dir)
    finally:
        set_flags({"FLAGS_dataloader_auto_fallback": True})
    del a
    line = {"arm": "dataloader", "images_per_s": figures,
            "batch_size": DL_BATCH, "num_workers": DL_WORKERS,
            "cpu_count": os.cpu_count(), "resize_branch": resize_branch(),
            "workers_cuda_initialised": {"pump": pump_workers,
                                         "overlap": overlap_workers}}
    line["ok"] = bool(
        all(np.isfinite(v) and v > 0 for v in figures.values())
        and len(pump_workers) == len(overlap_workers) == DL_WORKERS
        and not any(pump_workers.values())
        and not any(overlap_workers.values()))
    return line, {}


def fit_hapi(dev, smi):
    """The data pipeline and `Model.fit` on the card (`io`, `vision`'s
    datasets and transforms, `metric`, `hapi`): arms ``gpt_fused``,
    ``resnet_fit`` and ``dataloader``, one line each. Every worker is a
    spawn child and must not hold a CUDA context. Returns the flash and
    batch norm launches of the two fits."""
    probe_dir = tempfile.mkdtemp(prefix="fit_hapi_workers_")
    launches = {}
    try:
        for arm in (fit_gpt_fused, fit_resnet, bench_dataloader):
            t0 = time.perf_counter()
            line, arm_launches = arm(dev, probe_dir)
            launches.update(arm_launches)
            line.update(phase="fit_hapi", card=smi,
                        seconds=time.perf_counter() - t0,
                        clocks=card_clocks())
            emit(line)
            if not line["ok"]:
                raise SystemExit(f"fit_hapi {line['arm']}: {line}")
    finally:
        shutil.rmtree(probe_dir, ignore_errors=True)
    return launches


def nvidia_smi():
    """Card 0's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()


# the state a speed line is read in: SM and memory clocks now and at most,
# temperature, power draw, and the active throttle reasons (a bit mask;
# 0x0 none, 0x1 idle). Newer drivers name the last field
# clocks_event_reasons; older ones clocks_throttle_reasons.
CLOCK_FIELDS = ("clocks.sm", "clocks.mem", "clocks.max.sm",
                "temperature.gpu", "power.draw")
THROTTLE_FIELDS = ("clocks_event_reasons.active",
                   "clocks_throttle_reasons.active")


def card_clocks():
    """Card 0's clocks, temperature, power draw and active throttle
    reasons as nvidia-smi gives them, a dict of strings; ``{"error": ...}``
    where nvidia-smi answers none of the queries."""
    err = ""
    for reasons in THROTTLE_FIELDS:
        fields = (*CLOCK_FIELDS, reasons)
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(fields),
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=60)
        vals = [v.strip() for v in proc.stdout.strip().split(",")]
        if proc.returncode == 0 and len(vals) == len(fields):
            out = dict(zip(CLOCK_FIELDS, vals))
            out["throttle_reasons"] = vals[-1]
            return out
        err = (proc.stderr or proc.stdout).strip()[-200:]
    return {"error": err}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(dev)
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "capability": list(cap),
          "clocks": card_clocks(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
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
        for case in BN_CASES:
            for kern, line in check_batch_norm(dev, timer, smi, dtype,
                                               case).items():
                cases[(kern, dtype, case[0])] = line
        torch.cuda.empty_cache()
    del timer
    torch.cuda.empty_cache()

    seconds = {"kernels": time.perf_counter() - t0}
    clock = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - clock[0]
        clock[0] = now

    sampler_phase(dev, smi)
    mark("sampler")
    model = host_gpt2_small(generator=torch.Generator().manual_seed(SEED))
    serve_parity(model, dev)
    serve_parity(model, dev, kv_dtype="int8")
    serve_sampled_parity(model, dev)
    serve_spec_parity(model, dev)
    serve_prefix_parity(model, dev)
    serve_prefix_parity(model, dev, kv_dtype="int8")
    mark("serve_parity")
    other = host_gpt2_small(
        generator=torch.Generator().manual_seed(SEED + 9))
    serve_graph(model, other, dev)
    model = model.to(torch.bfloat16)
    serve_graph(model, other.to(torch.bfloat16), dev)
    del other
    mark("serve_graph")
    serve_parity(model, dev)
    line, greedy_outs = serve_run(model, dev, smi)
    launches = line["launches"]
    prefill_graph_memory(model, dev, smi)
    serve_run(model, dev, smi, "serve_sampled", params=SAMPLED_PARAMS,
              greedy_ref=greedy_outs, sampling=True)
    serve_run(model, dev, smi, "serve_spec", speculate_k=SPEC_K)
    quantized = serve_run(model, dev, smi, "serve_int8", kv_dtype="int8",
                          weight_dtype="int8")[0]["launches"]
    mark("serve")
    serve_prefix(model, dev, smi)
    serve_inflight(model, dev, smi, greedy_outs)
    serve_handoff(model, dev, smi)
    mark("serve_prefix_inflight_handoff")
    wire = serve_wire(model, dev, smi, line)
    mark("serve_wire")
    serve_lifecycle(model, dev, smi)
    serve_observe(model, dev, smi, greedy_outs)
    launches.update((k, quantized[k]) for k in INT8_KERNELS)
    torch.cuda.empty_cache()
    mark("serve_lifecycle_observe")
    train_parity(dev, smi)
    train_parity(dev, smi, torch.bfloat16)
    train_parity(dev, smi, hidden_dropout=DROPOUT_P)
    train_parity(dev, smi, torch.bfloat16, hidden_dropout=DROPOUT_P)
    mark("train_parity")
    trained_line = train_run(dev, smi)
    trained = trained_line["launches"]
    launches.update((k, trained[k]) for k in FLASH_KERNELS)
    dropped = train_run(dev, smi, "train_dropout", hidden_dropout=DROPOUT_P)
    launches["dropout"] = dropped["launches"]["dropout"]
    train_recompute(dev, smi, dropped)
    train_f32(dev, smi)
    mark("train")
    # the Paddle front end: a user's own eager loop and eager decode
    for phase_launches in (train_eager(dev, smi), generate_eager(dev, smi)):
        for k in (*FLASH_KERNELS, "dropout"):
            launches[k] += phase_launches[k]
    mark("train_eager_generate_eager")
    # the bench's programs: amp O2 and to_static, each step one graph
    for phase_launches in (train_static(dev, smi),
                           train_bert_static(dev, smi)):
        for k in FLASH_KERNELS:
            launches[k] += phase_launches[k]
    mark("train_static")
    # the bench's ResNet50 program: convolution, pooling and batch norm
    # (no registry kernel on its path)
    resnet_launches = train_resnet_static(dev, smi)
    launches.update((k, resnet_launches[k]) for k in BN_KERNELS)
    mark("train_resnet_static")
    torch.cuda.empty_cache()
    incubate_parity(dev)
    incubated = incubate_run(dev, smi)
    launches.update((k, incubated[k]) for k in (*LN_KERNELS, "rotary"))
    mark("incubate")
    # last, so that every phase before it runs as it ran before the
    # router tier came
    serve_router(model, dev, smi, wire)
    del model, wire
    torch.cuda.empty_cache()
    mark("serve_router")
    # after the router tier: fault-tolerant and elastic training
    for name, run in (("train_ckpt", lambda: train_ckpt(dev, smi,
                                                        trained_line)),
                      ("train_elastic", lambda: train_elastic(dev, smi))):
        phase_launches = run()
        for k in FLASH_KERNELS:
            launches[k] += phase_launches[k]
        mark(name)
    # after train_elastic: the bench's decode rungs (fast_generate as one
    # graph a signature; the engine's paged kernels) and its quantization
    # rung with the eager collectives
    for k, n in generate_fast(dev, smi).items():
        launches[k] += n
    mark("generate_fast")
    for k, n in quant_comms(dev, smi).items():
        launches[k] += n
    mark("quant_comms")
    # after quant_comms: the data pipeline and Model.fit (io, vision's
    # datasets and transforms, metric, hapi)
    for k, n in fit_hapi(dev, smi).items():
        launches[k] += n
    mark("fit_hapi")
    emit({"phase": "phase_seconds", "seconds": seconds,
          "total": sum(seconds.values())})

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
    head.update((k, cases[(k, bf16, "bn1")]) for k in BN_KERNELS)
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
    if sys.argv[1:2] == ["--ckpt-worker"]:
        sys.exit(ckpt_worker(sys.argv))
    if sys.argv[1:2] == ["--elastic-worker"]:
        sys.exit(elastic_worker(sys.argv))
    sys.exit(main())
