"""GPT-2 (counterpart of `paddle_tpu/models/gpt.py`): the model as Paddle
Layers that train and generate eagerly (`GPTForCausalLM`) or decode as
one program a signature (`fast_generate`: `_fast_decode`, one captured
CUDA graph on the card, `_FastDecode`), its serving step functions over
a paged KV cache and its scanned training forward, `scan_hidden` /
`scan_logits` / `scan_loss`.

The weights keep the JAX package's layout and names, so carrying a JAX
state_dict across is a copy (`models/convert.py`): ``x @ W`` with ``W``
stored ``[in, out]``, the token table ``gpt.wte.weight`` tied to the LM
head, and per-layer keys ``gpt.h.{i}.…``. The step functions take those
weights as a plain ``{name: tensor}`` dict, the same dict the JAX step
functions take.

`verify_step`, the speculative verify, scores a window of positions per
slot with a gather and a dense f32 softmax, as the JAX package does in XLA
(there is no Pallas kernel behind it, so plain PyTorch ops on both
devices); its sampled arms and `_make_sampler` draw through the port's
threefry chain (`kernels/prng.py`, `kernels/sampling.py`).

The pools are updated IN PLACE: where the JAX step functions return new
pools (arrays are immutable there), these write into the tensors they are
given and return the same tensors.

Quantized serving: with int8 pools the step functions take the f32 scale
pools too (``k_scale``/``v_scale``), quantize each K/V write per token slot
and head, and write the scales beside the values. A params leaf may be a
`quantization/serving.py::QuantizedLeaf` (weight-only int8); it is
dequantized where it is used (`_deq`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import ops
from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import prng
from paddle_tpu_torch.kernels import sampling as smp
from paddle_tpu_torch.kernels.dropout import hidden_dropout
from paddle_tpu_torch.kernels.flash_attention import (NEG_INF,
                                                      flash_attention_fn)
from paddle_tpu_torch.kernels.fused_ce import fused_linear_cross_entropy
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.observability import metrics

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt2_small", "INIT_CACHE", "decode_step",
           "prefill_step", "prefill_chunk_step", "verify_step",
           "BLOCK_SUFFIXES",
           "analytic_param_count", "analytic_flops_per_token",
           "stack_gpt_params", "unstack_gpt_params", "check_trainable",
           "scan_blocks", "scan_hidden", "scan_logits", "scan_loss"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304          # 50257 padded to a multiple of 64
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1      # training only (embeddings, residuals)
    attention_dropout: float = 0.1   # training only; > 0 is refused (A8)
    initializer_range: float = 0.02
    use_flash: bool = True           # flash attention in training, else dense
    recompute: bool = False          # rematerialize each block in training
    recompute_granularity: str = "full"  # "full" | "mlp" | "mlp_up": with
                                     # recompute=False, "mlp" recomputes
                                     # ln_2 and the MLP, "mlp_up" the MLP
    fused_ce: bool = True            # chunked LM-head CE, no [N, V] logits


INIT_CACHE = "init"     # generate()'s first step: attention returns the
                        # fresh K/V as the cache


def _winit(cfg):
    return ParamAttr(initializer=I.Normal(0.0, cfg.initializer_range))


class GPTAttention(pnn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv_proj = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, weight_attr=_winit(cfg),
            gather_output=False)
        self.out_proj = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, weight_attr=_winit(cfg),
            input_is_parallel=True)
        self.attn_drop_p = cfg.attention_dropout
        self.resid_drop = pnn.Dropout(cfg.hidden_dropout)

    def forward(self, x, cache=None):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape([b, s, 3, self.num_heads,
                                        self.head_dim])
        q, k, v = qkv.unbind(axis=2)
        if cache == INIT_CACHE:
            cache = (k, v)
        elif cache is not None:
            k = ops.concat([cache[0], k], axis=1)
            v = ops.concat([cache[1], v], axis=1)
            cache = (k, v)
        drop = self.attn_drop_p if self.training else 0.0
        out = PF.scaled_dot_product_attention(q, k, v, dropout_p=drop,
                                              is_causal=True,
                                              training=self.training)
        out = self.resid_drop(self.out_proj(out.reshape([b, s, -1])))
        return out if cache is None else (out, cache)


class GPTMLP(pnn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc_in = ColumnParallelLinear(
            cfg.hidden_size, cfg.intermediate_size, weight_attr=_winit(cfg),
            gather_output=False)
        self.fc_out = RowParallelLinear(
            cfg.intermediate_size, cfg.hidden_size, weight_attr=_winit(cfg),
            input_is_parallel=True)
        self.drop = pnn.Dropout(cfg.hidden_dropout)

    def forward(self, x):
        return self.drop(self.fc_out(PF.gelu(self.fc_in(x),
                                             approximate=True)))


def _no_eager_recompute(cfg):
    raise NotImplementedError(
        f"eager training with recompute={cfg.recompute}, "
        f"recompute_granularity={cfg.recompute_granularity!r} needs "
        "fleet/recompute.py, which is not ported (ROADMAP A7.3); the "
        "ScanTrainStep recomputes (train/scan_step.py)")


class GPTBlock(pnn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        if cfg.recompute_granularity not in ("full", "mlp", "mlp_up"):
            raise ValueError(
                f"recompute_granularity={cfg.recompute_granularity!r}: "
                "expected 'full', 'mlp', or 'mlp_up'")
        self.cfg = cfg
        self.ln_1 = pnn.LayerNorm(cfg.hidden_size)
        self.attn = GPTAttention(cfg)
        self.ln_2 = pnn.LayerNorm(cfg.hidden_size)
        self.mlp = GPTMLP(cfg)

    def forward(self, x, cache=None):
        if cache is None:
            x = x + self.attn(self.ln_1(x))
        else:
            a, cache = self.attn(self.ln_1(x), cache)
            x = x + a
        if self.cfg.recompute_granularity in ("mlp", "mlp_up") and \
                self.training and cache is None and not self.cfg.recompute:
            _no_eager_recompute(self.cfg)
        x = x + self.mlp(self.ln_2(x))
        return x if cache is None else (x, cache)


class GPTModel(pnn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                          weight_attr=_winit(cfg))
        self.wpe = pnn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                 weight_attr=_winit(cfg))
        self.drop = pnn.Dropout(cfg.hidden_dropout)
        self.h = pnn.LayerList([GPTBlock(cfg) for _ in range(cfg.num_layers)])
        self.ln_f = pnn.LayerNorm(cfg.hidden_size)

    def forward(self, input_ids, position_ids=None, caches=None):
        input_ids = ops.ensure_tensor(input_ids)
        s = input_ids.shape[1]
        if position_ids is None:
            past = (0 if caches is None or caches == INIT_CACHE
                    else caches[0][0].shape[1])
            position_ids = Tensor(torch.arange(
                past, past + s, device=input_ids._data.device)[None],
                _internal=True)
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if caches == INIT_CACHE:
            caches = [INIT_CACHE] * len(self.h)
        new_caches = [] if caches is not None else None
        if self.cfg.recompute and self.training and caches is None:
            _no_eager_recompute(self.cfg)
        for i, block in enumerate(self.h):
            if caches is None:
                x = block(x)
            else:
                x, c = block(x, caches[i])
                new_caches.append(c)
        x = self.ln_f(x)
        return x if caches is None else (x, new_caches)


class GPTForCausalLM(pnn.Layer):
    """GPT-2 as a Paddle Layer (the JAX package's Layers of the same names),
    with the JAX state_dict keys (``gpt.wte.weight``, ``gpt.h.{i}.…``).

    Built after ``paddle.seed(s)`` it draws the JAX package's weights:
    N(0, initializer_range) matrices and tables from the global stream in
    the JAX creation order, zero biases, unit layernorm scales. With
    ``generator`` (a ``torch.Generator``, the port's extra) the matrices
    and tables are redrawn N(0, initializer_range) from it on the host in
    ``named_parameters`` order instead (the stream is left alone), the
    weights the serving and training phases of `chip_smoke.py` use.

    ``forward(input_ids, labels=None, loss_mask=None)`` gives the [B, S, V]
    logits (tied LM head), or ``(None, loss)`` with labels: the fused
    LM-head cross entropy (`kernels/fused_ce.py`, ``cfg.fused_ce``), else
    ``(logits, loss)``, the mean over tokens or over ``loss_mask``.
    ``generate`` decodes eagerly with growing KV caches. The serving and
    scanned-training paths run the step functions below over
    `core.tensor.torch_state` of this Layer."""

    def __init__(self, cfg: GPTConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        if generator is None:
            self.gpt = GPTModel(cfg)
        else:
            with I.skip_draws():
                self.gpt = GPTModel(cfg)
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Biases 0, layernorm scales 1, the rest N(0, initializer_range)
        drawn on the host from ``generator``, in ``named_parameters``
        order."""
        for name, p in self.named_parameters():
            d = p._data
            if name.endswith("bias"):
                d.zero_()
            elif d.dim() == 1:
                d.fill_(1.0)
            else:
                w = torch.empty(d.shape, dtype=d.dtype).normal_(
                    0.0, self.cfg.initializer_range, generator=generator)
                d.copy_(w)

    def forward(self, input_ids, labels=None, loss_mask=None):
        h = self.gpt(input_ids)
        wte = self.gpt.wte.weight
        if labels is not None and self.cfg.fused_ce:
            n = h.shape[0] * h.shape[1]
            loss = apply(lambda hh, ww, ll: fused_linear_cross_entropy(
                hh.reshape(n, -1), ww, ll.reshape(-1).long()),
                h, wte, ops.ensure_tensor(labels),
                op_name="fused_linear_cross_entropy")
            logits = None
        else:
            logits = ops.matmul(h, wte, transpose_y=True)
        if labels is None:
            return logits
        if logits is not None:
            loss = PF.cross_entropy(
                logits.reshape([-1, self.cfg.vocab_size]).astype("float32"),
                ops.ensure_tensor(labels).reshape([-1]), reduction="none")
        if loss_mask is not None:
            m = ops.ensure_tensor(loss_mask).reshape([-1]).astype("float32")
            loss = (loss * m).sum() / m.sum()
        else:
            loss = loss.mean()
        return logits, loss

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, seed=0):
        """Greedy or sampled decode with KV caches, eagerly (one forward
        per token, caches growing): the JAX `generate`. Sampling is
        `_make_sampler`'s: temperature before the top-k mask, one key split
        per token from ``PRNGKey(seed)``. Returns [B, S + max_new_tokens]
        ids."""
        self.eval()
        x = ops.ensure_tensor(input_ids)
        wte = self.gpt.wte.weight
        sample = _make_sampler(float(temperature), int(top_k))
        key = prng.prng_key(seed, wte._data.device)
        caches, out_ids, cur = None, [x], x
        for _ in range(max_new_tokens):
            h, caches = self.gpt(cur, caches=INIT_CACHE if caches is None
                                 else caches)
            logits = ops.matmul(h[:, -1], wte, transpose_y=True)
            nxt, key = sample(logits._data.float(), key)
            cur = Tensor(nxt[:, None].to(x.dtype), _internal=True)
            out_ids.append(cur)
        return ops.concat(out_ids, axis=1)

    @torch.no_grad()
    def fast_generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                      top_k=0, seed=0):
        """Decode as ONE program a signature: the JAX `fast_generate`.

        The prefill and the whole decode loop (``max_new_tokens - 1`` steps,
        unrolled) over a static ``[nl, B, S0+N, nh, dh]`` KV cache in the
        weights' dtype, written in place a position a step; the prefill
        attends with a dense f32 causal softmax, each step over the whole
        cache with the ``arange(L) <= pos`` mask; sampling is
        `_make_sampler`'s (greedy, or temperature then top-k), the key
        split once per sampled token from ``PRNGKey(seed)``.

        The program is cached per ``(B, S0, N, temperature, top_k, dtype)``
        signature, at most 8, the oldest evicted first. On the CPU it runs
        eagerly. On the card the first call of a signature captures it as
        one CUDA graph (`_FastDecode`) and every call replays that graph
        once. The graph reads the weights where they lay at its capture:
        a weight written in place (`Tensor._write` of the same shape,
        dtype and device) is seen by the next replay, and a call that
        finds any weight rebound to other storage (a frozen parameter's
        `set_state_dict`, `.to()`) captures again (``generate.recaptures``)
        rather than replay over stale storage. A capture that fails
        raises. Returns ``[B, S0 + N]`` ids in the input's dtype."""
        self.eval()
        cfg = self.cfg
        x = ops.ensure_tensor(input_ids)
        B, S0 = int(x.shape[0]), int(x.shape[1])
        N = int(max_new_tokens)
        if N < 1:
            return input_ids
        L = S0 + N
        if L > cfg.max_position_embeddings:
            raise ValueError(
                f"fast_generate: prompt {S0} + max_new_tokens {N} exceeds "
                f"max_position_embeddings={cfg.max_position_embeddings} — "
                "positions past the table would silently clamp")
        params = {k: t._data for k, t in self.state_dict().items()}
        cdtype = params["gpt.wte.weight"].dtype
        sig = (B, S0, N, float(temperature), int(top_k),
               str(cdtype).replace("torch.", ""))
        cache = self.__dict__.setdefault("_fast_decode_cache", {})
        if sig not in cache and len(cache) >= 8:
            # bound the per-model cache: callers with varying prompt
            # lengths should bucket S0; oldest-first eviction keeps the
            # worst case from growing without bound
            cache.pop(next(iter(cache)))
        prog = cache.get(sig)
        compiled_now = prog is None
        if prog is None:
            prog = cache[sig] = _FastDecode(
                cfg, N, _make_sampler(float(temperature), int(top_k)))
            metrics.counter("generate.compile_count").inc()
        ids = x._data
        key = prng.prng_key(seed, ids.device)
        t0 = time.perf_counter()
        if ids.is_cuda:
            compiled_now |= prog.ensure_graph(params, ids, key, self)
            toks = prog.replay(ids, key)
            torch.cuda.current_stream(ids.device).synchronize()
        else:
            toks = prog.run(params, ids, key)
        dt = time.perf_counter() - t0
        metrics.counter("generate.calls").inc()
        metrics.counter("generate.tokens").inc(B * N)
        if compiled_now:
            # the signature's first call (or a re-capture): the capture
            # dominates
            metrics.histogram("generate.compile_seconds").observe(dt)
            metrics.add_span("generate.compile", t0, dt, cat="compile")
        else:
            metrics.histogram("generate.decode_seconds").observe(dt)
            metrics.gauge("generate.tokens_per_s").set(B * N / dt if dt > 0
                                                       else 0.0)
            metrics.add_span("generate.decode", t0, dt, cat="generate")
        return ops.concat([x, Tensor(toks, _internal=True)], axis=1)


def gpt2_small(generator: torch.Generator | None = None, **kwargs):
    """GPT-2 small (124M): 12 layers, 768 wide, 12 heads, 3072 FFN, vocab
    50304, 1024 positions; keyword arguments override GPTConfig fields."""
    return GPTForCausalLM(GPTConfig(**kwargs), generator=generator)


# --------------------------------------------------------------------------
# Decode math over the state_dict layout. decode_step, prefill_step and
# prefill_chunk_step run THESE functions, so their numerics agree by
# construction.

def _deq(v):
    """A weight-only int8 leaf (`QuantizedLeaf`) dequantized at use; a
    tensor as it is."""
    return v.dequant() if hasattr(v, "dequant") else v


def _pget(p, layer, suffix):
    return _deq(p[f"gpt.h.{layer}.{suffix}"])


def _ln_ref(x, w, b):
    """Layernorm with f32 statistics, eps 1e-5, result in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) / torch.sqrt(var + 1e-5)
    return (y * w + b).to(x.dtype)


def _attention_branch(p, layer, x, nh, dh, attend):
    """Layer ``layer``'s attention branch over x ([..., H], H = nh*dh):
    ln_1, the qkv projection, ``attend(layer, q, k, v)`` on [..., nh, dh]
    q/k/v (returning the context in x.dtype with q's shape) and out_proj.
    The residual add is the caller's."""
    lead = x.shape[:-1]
    hpre = _ln_ref(x, _pget(p, layer, "ln_1.weight"),
                   _pget(p, layer, "ln_1.bias"))
    qkv = hpre @ _pget(p, layer, "attn.qkv_proj.weight") + \
        _pget(p, layer, "attn.qkv_proj.bias")
    q, k, v = qkv.split(nh * dh, dim=-1)
    att = attend(layer, q.reshape(*lead, nh, dh), k.reshape(*lead, nh, dh),
                 v.reshape(*lead, nh, dh))
    att = att.reshape(*lead, nh * dh)
    return att @ _pget(p, layer, "attn.out_proj.weight") + \
        _pget(p, layer, "attn.out_proj.bias")


def _mlp_ln(p, layer, x):
    """ln_2 of x: the MLP's input (the JAX checkpoint name ``mlp_ln``)."""
    return _ln_ref(x, _pget(p, layer, "ln_2.weight"),
                   _pget(p, layer, "ln_2.bias"))


def _mlp_up(p, layer, hn):
    """gelu(hn @ fc_in + b), the [..., 4H] activation (``mlp_up``)."""
    m = hn @ _pget(p, layer, "mlp.fc_in.weight") + \
        _pget(p, layer, "mlp.fc_in.bias")
    return F.gelu(m, approximate="tanh")


def _mlp_down(p, layer, up):
    return up @ _pget(p, layer, "mlp.fc_out.weight") + \
        _pget(p, layer, "mlp.fc_out.bias")


def _block_stack(p, x, nl, nh, dh, attend):
    """All nl transformer blocks over x ([..., H], H = nh*dh); ``attend`` as
    `_attention_branch` takes it."""
    for i in range(nl):
        x = x + _attention_branch(p, i, x, nh, dh, attend)
        x = x + _mlp_down(p, i, _mlp_up(p, i, _mlp_ln(p, i, x)))
    return x


def _final_logits(p, x):
    x = _ln_ref(x, p["gpt.ln_f.weight"], p["gpt.ln_f.bias"])
    return (x @ _deq(p["gpt.wte.weight"]).T).float()


def _write_kv(pools, scales, i, page, off, k, v):
    """Scatter one layer's K/V rows ``[n, nh, dh]`` to ``(page, off)``. With
    scale pools the rows are quantized per token slot and head and the
    scales land at the same coordinates as the values."""
    kc, vc = pools
    if scales is not None:
        k, sk = pa.quantize_kv(k)
        v, sv = pa.quantize_kv(v)
        scales[0][i, page, off] = sk
        scales[1][i, page, off] = sv
    kc[i, page, off] = k.to(kc.dtype)
    vc[i, page, off] = v.to(vc.dtype)


def _layer_scales(scales, i):
    """``{"k_scale", "v_scale"}`` of layer i for the attention ops, or {}."""
    if scales is None:
        return {}
    return {"k_scale": scales[0][i], "v_scale": scales[1][i]}


def _check_scales(k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale (int8 pools) or "
                         "neither")
    return None if k_scale is None else (k_scale, v_scale)


def _make_sampler(temperature, top_k):
    """Greedy, temperature or top-k sampling of ``[..., V]`` f32 logits with
    a threaded key, for one static (temperature, top_k): temperature divides
    before the top-k mask, and the key splits once per sampled token. Key
    ``[2]`` draws every row from one key; keys ``[B, 2]`` with logits ``[B,
    ..., V]`` draw each slot's rows from its own (`prng.categorical`).
    Returns ``sample(logits, key) -> (tokens, key)``."""
    def sample(logits, key):
        if temperature != 1.0:
            # a tensor on the logits' device, not a Python scalar: CUDA
            # turns division by a host scalar into a product with its
            # reciprocal, one rounding more
            logits = logits / torch.full((), temperature, dtype=torch.float32,
                                         device=logits.device)
        if top_k:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, smp.NEG_INF, logits)
        if top_k or temperature != 1.0:
            split = prng.split(key)
            return prng.categorical(split[..., 1, :], logits), \
                split[..., 0, :]
        return logits.argmax(dim=-1), key
    return sample


def _fast_decode(p, ids, key, cfg, n, sample):
    """`fast_generate`'s program: the prompt ``ids`` [B, S0] and a key ->
    the ``n`` new tokens [B, n] in ids' dtype. Every shape and position is
    a Python int, so on the card the whole program is one graph."""
    nl, nh = cfg.num_layers, cfg.num_heads
    dh = cfg.hidden_size // nh
    b, s0 = ids.shape
    L = s0 + n
    wte, wpe = p["gpt.wte.weight"], p["gpt.wpe.weight"]
    kc = torch.zeros((nl, b, L, nh, dh), dtype=wte.dtype, device=wte.device)
    vc = torch.zeros_like(kc)
    scale = 1.0 / (dh ** 0.5)

    # prefill: a causal pass over the prompt writes the cache's prefix
    # (dense f32 softmax; decode reuses the same math)
    x = wte[ids.long()] + wpe[None, :s0]                      # [B, S0, H]
    causal = torch.ones((s0, s0), dtype=torch.bool,
                        device=ids.device).tril()

    def attend_prefill(i, q, k, v):
        kc[i, :, :s0] = k
        vc[i, :, :s0] = v
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
        pr = torch.softmax(torch.where(causal, sc, NEG_INF), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", pr, v.float()).to(q.dtype)

    x = _block_stack(p, x, nl, nh, dh, attend_prefill)
    tok, key = sample(_final_logits(p, x[:, -1]), key)
    toks = [tok.to(ids.dtype)]
    positions = torch.arange(L, device=ids.device)

    # decode: one token a step, unrolled
    for pos in range(s0, L - 1):
        x = wte[toks[-1].long()] + wpe[pos][None, :]          # [B, H]
        mask = positions <= pos

        def attend(i, q, k, v):
            kc[i, :, pos] = k
            vc[i, :, pos] = v
            sc = torch.einsum("bhd,blhd->bhl", q.float() * scale,
                              kc[i].float())
            pr = torch.softmax(torch.where(mask, sc, NEG_INF), dim=-1)
            return torch.einsum("bhl,blhd->bhd", pr,
                                vc[i].float()).to(q.dtype)

        x = _block_stack(p, x, nl, nh, dh, attend)
        tok, key = sample(_final_logits(p, x), key)
        toks.append(tok.to(ids.dtype))
    return torch.stack(toks, dim=1)


def _weight_layout(params):
    """What a captured graph assumes of the weights: each one's storage
    address, shape, strides, dtype and device."""
    return {k: (v.data_ptr(), tuple(v.shape), v.stride(), v.dtype, v.device)
            for k, v in params.items()}


class _FastDecode:
    """One `fast_generate` signature's program. ``run`` is `_fast_decode`
    eagerly (the CPU path and the body a capture records). On the card
    ``ensure_graph`` captures it once as a `inference.graphs.StepGraph`
    over static id and key buffers, on the capture stream, under the
    lock that captures and replays of every graph of the process share;
    the graphs of one model share one memory pool (they replay one at a
    time and each keeps only its token buffer), so cached signatures do
    not each hold a decode's temporaries. ``replay`` copies the ids and
    key into the static buffers, replays once and returns a copy of the
    tokens."""

    def __init__(self, cfg, n, sample):
        self.cfg, self.n, self.sample = cfg, n, sample
        self.graph = None
        self.capture_seconds = None
        self.captures = 0

    def run(self, params, ids, key):
        return _fast_decode(params, ids, key, self.cfg, self.n, self.sample)

    def ensure_graph(self, params, ids, key, model) -> bool:
        """Capture unless a graph over these very weights exists; True
        when this call captured."""
        from paddle_tpu_torch.inference.graphs import StepGraph
        layout = _weight_layout(params)
        if self.graph is not None and layout == self.layout:
            return False
        if self.graph is not None:
            metrics.counter("generate.recaptures").inc()
        self.graph = None
        self.ids, self.key = ids.clone(), key.clone()
        pools = model.__dict__.setdefault("_fast_decode_pools", {})
        pool = pools.get(ids.device)
        if pool is None:
            pool = pools[ids.device] = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        try:
            self.graph = StepGraph(
                lambda: self.run(params, self.ids, self.key), ids.device,
                pool=pool)
        except Exception as e:
            raise RuntimeError(
                f"fast_generate: capturing the decode program as a CUDA "
                f"graph failed ({type(e).__name__}: {e}); nothing runs it "
                "eagerly instead") from e
        self.capture_seconds = time.perf_counter() - t0
        self.layout = layout
        self.captures += 1
        return True

    def replay(self, ids, key):
        self.ids.copy_(ids)
        self.key.copy_(key)
        return self.graph().to(ids.dtype, copy=True)


@torch.no_grad()
def decode_step(params, ids, cache, slot_mask, *, cfg):
    """One fixed-shape batched decode step over a PAGED KV cache.

    params    : state_dict tensors
    ids       : [B] int, current token per slot
    cache     : dict with
                  k_pages/v_pages : [nl, num_pages, page_size, nh, dh]
                  page_table      : [B, pages_per_slot] int32, contiguous
                  lengths         : [B] int32 tokens already cached
                  k_scale/v_scale : OPTIONAL [nl, num_pages, page_size, nh]
                                    f32, present iff the pools are int8
    slot_mask : [B] bool, active slots; inactive slots write to the trash
                page and keep their lengths
    returns   : (logits [B, V] f32, cache with the pools (and scales)
                written in place and lengths advanced)
    """
    nl, nh = cfg.num_layers, cfg.num_heads
    dh = cfg.hidden_size // nh
    kc, vc = cache["k_pages"], cache["v_pages"]
    scales = _check_scales(cache.get("k_scale"), cache.get("v_scale"))
    page_table, lengths = cache["page_table"], cache["lengths"]
    ps = kc.shape[2]
    wpe = params["gpt.wpe.weight"]
    # write position = current length; clamped only to keep the position
    # lookup in range for slots sitting at capacity
    pos = lengths.clamp(0, wpe.shape[0] - 1)
    x = params["gpt.wte.weight"][ids.long()] + wpe[pos.long()]
    page, off = pa.token_page_coords(page_table, pos, slot_mask, ps)

    def attend(i, q, k, v):
        _write_kv((kc, vc), scales, i, page, off, k, v)
        return pa.paged_attention(q.contiguous(), kc[i], vc[i], page_table,
                                  pos, **_layer_scales(scales, i))

    x = _block_stack(params, x, nl, nh, dh, attend)
    logits = _final_logits(params, x)
    return logits, dict(cache, lengths=torch.where(slot_mask, lengths + 1,
                                                   lengths))


def _last_row(x, n):
    """Row ``n - 1`` of ``x`` [S, H], clamped to [0, S - 1], gathered on
    the device: ``n`` (an int, or a 0-d device tensor from the packed
    upload) is never read on the host, so a captured graph serves any
    length."""
    idx = torch.as_tensor(n, device=x.device) - 1
    return x.index_select(0, idx.clamp(0, x.shape[0] - 1).reshape(1).long())[0]


@torch.no_grad()
def prefill_step(params, ids, length, page_table, k_pages, v_pages, *, cfg,
                 k_scale=None, v_scale=None):
    """Bucketed single-sequence prefill into the paged cache.

    ids is PADDED to its bucket length S; ``length`` (an int, or a 0-d int
    tensor on the device, as the engine's packed upload gives it) is the
    true prompt length. Writes positions < length into the slot's pages
    (padding lands on the trash page), attends every query over the pages
    just written (prefill attention with start=0, valid=length), and
    returns the last REAL token's logits. Float pools carry the weights'
    dtype, so this reads back exactly the K/V just computed; int8 pools
    (``k_scale`` / ``v_scale`` given) read back their quantize-dequantize
    round trip, as every later step does, so one-shot and chunked prefill
    condition on the same cache.

    returns : (logits [V] f32, k_pages, v_pages[, k_scale, v_scale]), pools
              written in place
    """
    nl, nh = cfg.num_layers, cfg.num_heads
    dh = cfg.hidden_size // nh
    ps = k_pages.shape[2]
    s = ids.shape[0]
    scales = _check_scales(k_scale, v_scale)
    x = (params["gpt.wte.weight"][ids.long()]
         + params["gpt.wpe.weight"][:s])[None]             # [1, S, H]
    page, off = pa.prompt_page_coords(page_table, length, s, ps)

    def attend(i, q, k, v):
        _write_kv((k_pages, v_pages), scales, i, page, off, k[0], v[0])
        return pa.prefill_attention(q.contiguous(), k_pages[i], v_pages[i],
                                    page_table, 0, length,
                                    **_layer_scales(scales, i)).to(x.dtype)

    x = _block_stack(params, x, nl, nh, dh, attend)
    return (_final_logits(params, _last_row(x[0], length)), k_pages,
            v_pages, *(scales or ()))


@torch.no_grad()
def prefill_chunk_step(params, ids, start, valid, page_table, k_pages,
                       v_pages, *, cfg, k_scale=None, v_scale=None):
    """One CHUNK of a decode-priority chunked prefill into the paged cache.

    ``ids`` is ONE chunk padded to the chunk length C; ``start`` is the
    absolute position of ``ids[0]``; ``valid`` the true token count in this
    chunk (each an int, or a 0-d int tensor on the device). Writes the
    chunk's K/V into the slot's pages (padding and overflow land on the
    trash page), then attends the chunk's queries over ALL cached
    positions, previous chunks and the current one, masked by absolute
    position. With ``k_scale``/``v_scale`` the pools are
    int8, as in :func:`prefill_step`.

    returns : (logits [V] f32 of the chunk's LAST valid token, k_pages,
               v_pages[, k_scale, v_scale]), pools written in place
    """
    nl, nh = cfg.num_layers, cfg.num_heads
    dh = cfg.hidden_size // nh
    ps = k_pages.shape[2]
    c = ids.shape[0]
    scales = _check_scales(k_scale, v_scale)
    wpe = params["gpt.wpe.weight"]
    pos = start + torch.arange(c, device=ids.device)
    x = (params["gpt.wte.weight"][ids.long()]
         + wpe[pos.clamp(0, wpe.shape[0] - 1)])[None]       # [1, C, H]
    page, off = pa.chunk_page_coords(page_table, start, valid, c, ps)

    def attend(i, q, k, v):
        _write_kv((k_pages, v_pages), scales, i, page, off, k[0], v[0])
        return pa.prefill_attention(q.contiguous(), k_pages[i], v_pages[i],
                                    page_table, start, valid,
                                    **_layer_scales(scales, i)).to(x.dtype)

    x = _block_stack(params, x, nl, nh, dh, attend)
    return (_final_logits(params, _last_row(x[0], valid)), k_pages, v_pages,
            *(scales or ()))


@torch.no_grad()
def verify_step(params, tok_seq, draft_len, cache, slot_mask, *, cfg,
                sampler=None, keys=None, sample_state=None):
    """Speculative-decode VERIFY: score K+1 positions per slot in one
    fixed-shape step over the paged cache, and accept the longest draft
    prefix that plain decode would have emitted plus ONE corrected token.
    Rejected drafts need no rollback on the device: the caller keeps the
    slot's length, and later steps write those positions before any query
    attends them.

    tok_seq   : [B, K+1] int; column 0 is each slot's current token (as
                `decode_step`'s ids), columns 1..K its drafts (padding past
                ``draft_len``)
    draft_len : [B] int, true drafts per slot (0 is one plain decode step)
    cache     : as `decode_step` (k_pages/v_pages/page_table/lengths, and
                k_scale/v_scale over int8 pools, written by `quantize_kv`)
    slot_mask : [B] bool; inactive slots write to TRASH_PAGE, emit 0 and
                keep their lengths
    sampler   : a `_make_sampler` function, with ``keys`` [B, 2]: the chain
                splits once per position as plain sampled decode splits once
                per token
    sample_state : the fused per-slot sampler, ``(keys [B, 2], temperatures
                [B] f32, top_ks [B] int)`` (`kernels/sampling.py`); greedy
                slots take the argmax and keep their chain. Not with
                ``sampler``
    returns   : (emitted [B, K+1] in tok_seq's dtype, positions < n_emitted
                being the step's tokens; n_emitted [B] int32 in 0..K+1; the
                cache with lengths advanced by n_emitted[; new_keys [B, 2],
                each chain advanced by its n_emitted positions, an inactive
                slot's unmoved])

    Acceptance is EXACT: position i's logits condition on drafts 1..i and
    count only when each of them equals the token the model chose there.
    """
    if sampler is not None and sample_state is not None:
        raise ValueError("verify_step takes sampler= OR sample_state=, "
                         "not both")
    if (sampler is None) != (keys is None):
        raise ValueError("sampler= and keys= go together")
    nl, nh = cfg.num_layers, cfg.num_heads
    dh = cfg.hidden_size // nh
    scale = 1.0 / (dh ** 0.5)
    kc, vc = cache["k_pages"], cache["v_pages"]
    scales = _check_scales(cache.get("k_scale"), cache.get("v_scale"))
    page_table, lengths = cache["page_table"], cache["lengths"]
    ps = kc.shape[2]
    b, kp1 = tok_seq.shape
    dev = tok_seq.device
    offs = torch.arange(kp1, device=dev)
    pos = lengths[:, None].long() + offs[None, :]              # [B, K+1]
    valid = slot_mask[:, None] & (offs[None, :] <= draft_len[:, None])
    wpe = params["gpt.wpe.weight"]
    x = params["gpt.wte.weight"][tok_seq.long()] + \
        wpe[pos.clamp(0, wpe.shape[0] - 1)]                    # [B, K+1, H]
    page, off = pa.verify_page_coords(page_table, pos, valid, ps)
    lmax = page_table.shape[1] * ps
    # absolute-position causality: the query at position p sees keys 0..p,
    # so drafts later in the window mask out like unwritten pages
    mask = torch.arange(lmax, device=dev)[None, None, :] <= pos[:, :, None]

    def attend(i, q, k, v):
        _write_kv((kc, vc), scales, i, page, off, k, v)
        ks, vs = scales if scales is not None else (None, None)
        kk = pa._gather_f32(kc[i], None if ks is None else ks[i], page_table)
        vv = pa._gather_f32(vc[i], None if vs is None else vs[i], page_table)
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk)
        sc = sc.masked_fill(~mask[:, None], -1e30)
        pr = torch.softmax(sc, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", pr, vv).to(x.dtype)

    x = _block_stack(params, x, nl, nh, dh, attend)
    logits = _final_logits(params, x)                          # [B, K+1, V]

    keys_after = None
    if sample_state is not None:
        keys, temps, topks = sample_state
        out, keys_after = smp.sample_chain(logits, keys, temps, topks)
    elif sampler is not None:
        toks, after, key = [], [], keys
        for j in range(kp1):
            t, key = sampler(logits[:, j:j + 1], key)
            toks.append(t[:, 0])
            after.append(key)
        out, keys_after = torch.stack(toks, 1), torch.stack(after, 1)
    else:
        out = logits.argmax(dim=-1)
    out = out.to(tok_seq.dtype)
    n_emitted = smp.accept_drafts(tok_seq[:, 1:], out, draft_len, slot_mask)
    new_cache = dict(cache, lengths=torch.where(
        slot_mask, lengths + n_emitted, lengths))
    if keys_after is None:
        return out, n_emitted, new_cache
    last = (n_emitted.long() - 1).clamp(min=0)
    new_keys = keys_after[torch.arange(b, device=dev), last]
    # an inactive slot emitted nothing: its chain must not move at all
    new_keys = torch.where((n_emitted > 0)[:, None], new_keys, keys)
    return out, n_emitted, new_cache, new_keys


# --------------------------------------------------------------------------
# Training forward over STACKED block weights (the JAX package's scanned
# layer stack). The stacked layout {"blocks": {suffix: [nl, ...]}, "top":
# {name: tensor}} is the training state's layout, so one optimizer update
# covers a suffix of every layer at once. PyTorch has no `lax.scan`: the
# layers run in a Python loop over `unbind`, whose backward stacks the
# per-layer gradients into one [nl, ...] gradient.

BLOCK_SUFFIXES = (
    "ln_1.weight", "ln_1.bias",
    "attn.qkv_proj.weight", "attn.qkv_proj.bias",
    "attn.out_proj.weight", "attn.out_proj.bias",
    "ln_2.weight", "ln_2.bias",
    "mlp.fc_in.weight", "mlp.fc_in.bias",
    "mlp.fc_out.weight", "mlp.fc_out.bias",
)

_BLOCK_PREFIX = "gpt.h."


def analytic_param_count(cfg) -> int:
    """Parameter count from the config: embeddings (tied LM head), the
    blocks' qkv, projection, MLP and two layernorms, and the final
    layernorm."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    per_block = (3 * h * h + 3 * h + h * h + h + h * i + i + i * h + h
                 + 4 * h)
    return (cfg.vocab_size * h + cfg.max_position_embeddings * h
            + cfg.num_layers * per_block + 2 * h)


def analytic_flops_per_token(cfg, seq_len: int) -> float:
    """Training FLOPs per token: 6 per parameter (forward and backward) plus
    the attention scores and context, 12 * layers * hidden * seq_len."""
    return (6.0 * analytic_param_count(cfg)
            + 12.0 * cfg.num_layers * cfg.hidden_size * seq_len)


def _num_layers(params) -> int:
    idx = [int(k[len(_BLOCK_PREFIX):].split(".", 1)[0]) for k in params
           if k.startswith(_BLOCK_PREFIX)]
    if not idx:
        raise ValueError("no gpt.h.<i>.* leaves: not a GPT state dict")
    return 1 + max(idx)


def stack_gpt_params(params):
    """state_dict layout {name: tensor} -> {"blocks": {suffix: [nl, ...]},
    "top": {name: tensor}}."""
    nl = _num_layers(params)
    blocks = {s: torch.stack([params[f"{_BLOCK_PREFIX}{i}.{s}"]
                              for i in range(nl)])
              for s in BLOCK_SUFFIXES}
    top = {k: v for k, v in params.items() if not k.startswith(_BLOCK_PREFIX)}
    return {"blocks": blocks, "top": top}


def unstack_gpt_params(stacked):
    """Inverse of :func:`stack_gpt_params` (per-layer views of the stacked
    leaves)."""
    out = dict(stacked["top"])
    for suffix, leaf in stacked["blocks"].items():
        for i, t in enumerate(leaf.unbind(0)):
            out[f"{_BLOCK_PREFIX}{i}.{suffix}"] = t
    return out


def check_trainable(cfg):
    """Raise NotImplementedError for what training does not port: attention
    dropout, which the JAX scan path refuses too."""
    if cfg.attention_dropout:
        raise NotImplementedError(
            "training with attention_dropout > 0 is not ported: the JAX scan "
            "step has no attention-dropout implementation either (ROADMAP "
            "A8.1); set attention_dropout=0")


def _dense_causal_attend(q, k, v):
    """Causal attention on [B, S, nh, dh] with a dense f32 softmax (the JAX
    `_causal_attend`), result in q.dtype."""
    s = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~mask, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", pr, v.float()).to(q.dtype)


def _recomputed(fn, *args):
    """``fn(*args)`` whose activations are recomputed in the backward
    instead of saved (`jax.checkpoint`). The dropout keys make the
    recomputation deterministic, so no RNG state is saved."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _train_block(p, layer, x, nh, dh, attend, cfg, keys, p_drop):
    """One block in training: hidden dropout after out_proj and after
    fc_out (``keys[0]``, ``keys[1]``) when ``p_drop``, and the MLP
    recomputed by ``cfg.recompute_granularity`` unless the whole block is.

    A torch checkpoint region recomputes everything it holds, and a region
    that drops the gelu output ``up`` must hold fc_out too, whose backward
    reads ``up``. So "mlp" (ln_2 through fc_out) and "mlp_up" (fc_in
    through fc_out) recompute the fc_out product as well, one product a
    layer that JAX's ``save_anything_except_these_names`` policy does not
    recompute; the results are the same ops on the same inputs."""
    def drop(t, j):
        return hidden_dropout(t, keys[j], p_drop) if p_drop else t

    x = x + drop(_attention_branch(p, layer, x, nh, dh, attend), 0)
    gran = None if cfg.recompute else cfg.recompute_granularity
    if gran == "mlp":
        m = _recomputed(lambda t: _mlp_down(p, layer, _mlp_up(
            p, layer, _mlp_ln(p, layer, t))), x)
    elif gran == "mlp_up":
        m = _recomputed(lambda hn: _mlp_down(p, layer, _mlp_up(p, layer, hn)),
                        _mlp_ln(p, layer, x))
    else:
        m = _mlp_down(p, layer, _mlp_up(p, layer, _mlp_ln(p, layer, x)))
    return x + drop(m, 1)


def scan_blocks(blocks, x, cfg, *, training=False, dropout_keys=None):
    """All nl transformer blocks over x [B, S, H], from the stacked block
    leaves; attention is causal flash attention (``cfg.use_flash``) or the
    dense softmax. A stacked `QuantizedLeaf` unbinds into per-layer leaves,
    each dequantized where its layer uses it.

    In training, ``dropout_keys`` [nl, 2, 2] holds each layer's key pair
    (attention residual, MLP residual) when ``cfg.hidden_dropout > 0``;
    ``cfg.recompute`` recomputes each whole block in the backward, else
    ``cfg.recompute_granularity`` "mlp" / "mlp_up" part of its MLP."""
    nh = cfg.num_heads
    dh = cfg.hidden_size // nh
    nl = next(iter(blocks.values())).shape[0]
    per_layer = unstack_gpt_params({"blocks": blocks, "top": {}})
    flash = flash_attention_fn(causal=True) if cfg.use_flash \
        else _dense_causal_attend

    def attend(i, q, k, v):
        return flash(q, k, v)

    if not training:
        return _block_stack(per_layer, x, nl, nh, dh, attend)
    check_trainable(cfg)
    p_drop = float(cfg.hidden_dropout)
    if p_drop and dropout_keys is None:
        raise ValueError("hidden_dropout > 0 needs dropout_keys")
    for i in range(nl):
        args = (per_layer, i, x, nh, dh, attend, cfg,
                dropout_keys[i] if p_drop else None, p_drop)
        x = _recomputed(_train_block, *args) if cfg.recompute \
            else _train_block(*args)
    return x


def scan_hidden(stacked, ids, cfg, *, training=False, dropout_key=None):
    """[B, S] ids -> final-layernorm hidden states [B, S, H]. Training with
    ``cfg.hidden_dropout > 0`` needs ``dropout_key`` ([2] int64, on the
    weights' device): it splits into the embedding's key and the layers'
    [nl, 2] keys, and the embedding sum is dropped out, as in JAX."""
    if training:
        check_trainable(cfg)
    top = stacked["top"]
    s = ids.shape[-1]
    x = top["gpt.wte.weight"][ids.long()] + top["gpt.wpe.weight"][:s]
    keys = None
    if training and cfg.hidden_dropout:
        if dropout_key is None:
            raise ValueError("hidden_dropout > 0 needs a dropout_key")
        nl = next(iter(stacked["blocks"].values())).shape[0]
        emb_key, layer_key = prng.split(dropout_key)
        x = hidden_dropout(x, emb_key, cfg.hidden_dropout)
        keys = prng.split(layer_key, (nl, 2))
    x = scan_blocks(stacked["blocks"], x, cfg, training=training,
                    dropout_keys=keys)
    return _ln_ref(x, top["gpt.ln_f.weight"], top["gpt.ln_f.bias"])


def scan_logits(stacked, ids, cfg, *, training=False, dropout_key=None):
    """[B, S] ids -> [B, S, V] f32 logits (tied LM head)."""
    h = scan_hidden(stacked, ids, cfg, training=training,
                    dropout_key=dropout_key)
    return (h @ stacked["top"]["gpt.wte.weight"].T).float()


def scan_loss(stacked, ids, labels, cfg, *, loss_mask=None, training=True,
              dropout_key=None):
    """Scalar f32 causal-LM loss: the fused LM-head cross-entropy
    (``cfg.fused_ce``) or dense logits and log-softmax, averaged over the
    tokens, or over ``loss_mask`` [B, S] as ``sum(loss * m) / sum(m)``."""
    h = scan_hidden(stacked, ids, cfg, training=training,
                    dropout_key=dropout_key)
    wte = stacked["top"]["gpt.wte.weight"]
    n = h.shape[0] * h.shape[1]
    labels = labels.reshape(-1).long()
    if cfg.fused_ce:
        loss = fused_linear_cross_entropy(h.reshape(n, -1), wte, labels)
    else:
        logits = (h @ wte.T).float().reshape(n, -1)
        loss = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    if loss_mask is not None:
        m = loss_mask.reshape(-1).to(torch.float32)
        return (loss * m).sum() / m.sum()
    return loss.mean()
