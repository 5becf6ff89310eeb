"""Runtime flag registry (counterpart of `paddle_tpu/framework/flags.py`;
ref: gflags `paddle/fluid/platform/flags.cc`, python `get_flags/set_flags`
at `python/paddle/fluid/framework.py:7611,7636`).

Flags are read from env ``FLAGS_*`` at import and mutable at runtime. Every
flag keeps the JAX package's name, default and parsing. What each drives
in the port:

- ``check_nan_inf`` / ``benchmark``: the eager per-op checks at the
  dispatch point (`core/autograd.py::apply`): a non-finite output raises
  FloatingPointError, ``benchmark`` waits for the card after each op.
  (JAX's ``jax_debug_nans`` for compiled code has no counterpart: a
  `to_static` capture runs no check, as a JAX trace runs none.)
- ``use_bfloat16_matmul``: float32 `matmul` rounds its inputs to bfloat16
  and accumulates in float32 (`ops/linalg.py`).
- ``tpu_donate_buffers``: `jit.to_static`'s default ``donate_state``.
- ``dataloader_auto_fallback`` / ``dataloader_mp_method``: `io.DataLoader`.
- Arms the port lacks raise when set to anything but their default:
  ``tpu_flash_impl``, ``tpu_paged_impl``, ``tpu_prefill_impl`` and
  ``autotune_verbose`` (the JAX autotuner and its other arms, ROADMAP
  A8.5), ``moe_dispatch`` (MoE, ROADMAP A7), ``dy2static_max_trip_count``
  (dy2static, ROADMAP A10.1). A refused value is not stored.
- ``tpu_fused_optimizer``: both JAX arms (one update over concatenated
  buffers, or one a parameter) give the same numbers, the update being
  elementwise; the port's one arm, a parameter at a time, serves both.
- ``paddle_num_threads``, ``seed``, ``log_level``, ``allocator_strategy``
  and ``eager_delete_tensor_gb`` are kept for scripts that set them; no
  code of either package reads them (ROADMAP C27).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["FlagInfo", "define_flag", "get_flags", "set_flags", "flag_value"]


@dataclass
class FlagInfo:
    name: str
    default: Any
    doc: str
    parser: Callable[[str], Any]
    value: Any = None
    on_change: Callable[[Any], None] | None = None


_REGISTRY: dict[str, FlagInfo] = {}


def _parse_bool(s):
    return str(s).lower() in ("1", "true", "yes", "on")


def _assign(info, value):
    """Store ``value`` and run the flag's wiring; a value the wiring
    refuses is not kept."""
    old = info.value
    info.value = value
    if info.on_change:
        try:
            info.on_change(value)
        except Exception:
            info.value = old
            raise


def define_flag(name, default, doc="", parser=None, on_change=None):
    if parser is None:
        if isinstance(default, bool):
            parser = _parse_bool
        elif isinstance(default, int):
            parser = int
        elif isinstance(default, float):
            parser = float
        else:
            parser = str
    info = FlagInfo(name, default, doc, parser, default, on_change)
    env = os.environ.get(f"FLAGS_{name}")
    _REGISTRY[name] = info
    if env is not None:
        # env-set flags must fire their wiring too (FLAGS_check_nan_inf=1
        # python train.py is the canonical gflags usage)
        _assign(info, parser(env))
    return info


def get_flags(flags):
    single = isinstance(flags, str)
    names = [flags] if single else list(flags)
    out = {}
    for n in names:
        n = n.removeprefix("FLAGS_")
        if n not in _REGISTRY:
            raise ValueError(f"unknown flag {n}")
        out[f"FLAGS_{n}"] = _REGISTRY[n].value
    return out


def set_flags(flags: dict):
    for k, v in flags.items():
        n = k.removeprefix("FLAGS_")
        if n not in _REGISTRY:
            raise ValueError(f"unknown flag {n}")
        info = _REGISTRY[n]
        _assign(info, info.parser(v) if isinstance(v, str) else v)


def flag_value(name):
    return _REGISTRY[name].value


# ---- core flags (the JAX package's set, its names and defaults) ------------
def _sync_debug_hooks(_value=None):
    """check_nan_inf / benchmark wiring: a module-level switch on the
    autograd dispatch path (eager per-op checks, `core/autograd.py`)."""
    from paddle_tpu_torch.core import autograd
    autograd._DEBUG_CHECKS = bool(
        _REGISTRY["check_nan_inf"].value or _REGISTRY["benchmark"].value)


def _unported(default, what):
    """Wiring of a flag whose other values select what the port lacks."""
    def check(value):
        if value != default:
            raise NotImplementedError(
                f"{what}; the port has only the {default!r} setting")
    return check


define_flag("check_nan_inf", False,
            "check outputs of every op for nan/inf (ref FLAGS_check_nan_inf)",
            on_change=_sync_debug_hooks)
define_flag("benchmark", False, "sync after each op for timing",
            on_change=_sync_debug_hooks)
define_flag("paddle_num_threads", 1, "host compute threads")
define_flag("use_bfloat16_matmul", False,
            "run fp32 matmuls on bf16 inputs with f32 accumulation")
define_flag("seed", 0, "global random seed (0 = nondeterministic)")
define_flag("log_level", "INFO", "framework log level")
define_flag("allocator_strategy", "xla",
            "kept for compat; PyTorch's caching allocator owns device memory")
define_flag("eager_delete_tensor_gb", 0.0,
            "kept for compat; tensors are freed by reference counting")
define_flag("tpu_donate_buffers", True,
            "donate param/opt-state buffers in captured train steps")
define_flag("tpu_fused_optimizer", True,
            "multi-tensor optimizer path (same numbers as the per-parameter "
            "update, which the port runs for both values)")
define_flag("moe_dispatch", "auto",
            "MoE token dispatch path: auto | scatter | einsum",
            on_change=_unported(
                "auto", "FLAGS_moe_dispatch selects a MoE dispatch path and "
                "MoE is not ported (ROADMAP A7, incubate's moe)"))
define_flag("dataloader_auto_fallback", True,
            "drop multi-worker DataLoader to the in-process path on "
            "single-core hosts, where the worker pipeline loses to it. Set "
            "False only to force workers for measurement, or on multi-core "
            "hosts where decode parallelism is real")
define_flag("dataloader_mp_method", "spawn",
            "multiprocessing start method for DataLoader workers: spawn "
            "(default) | forkserver | fork (requires a parent that has not "
            "initialised CUDA; kept for unpicklable datasets at the "
            "caller's risk)")
define_flag("tpu_flash_impl", "auto",
            "flash-attention backend: auto (the port's CUDA flash kernels "
            "on the card, their plain versions on the CPU)",
            on_change=_unported(
                "auto", "FLAGS_tpu_flash_impl selects an arm of the JAX "
                "flash op (splash | mosaic | authored | xla) and the port "
                "has none of them but its own kernels (ROADMAP A8.5)"))
define_flag("tpu_paged_impl", "auto",
            "paged-attention decode backend: auto (the port's CUDA "
            "paged-decode kernels on the card, the plain versions on the "
            "CPU)",
            on_change=_unported(
                "auto", "FLAGS_tpu_paged_impl selects an arm of the JAX "
                "paged decode (xla | pallas) and the port has only its own "
                "kernels (ROADMAP A8.5)"))
define_flag("tpu_prefill_impl", "auto",
            "ragged prefill-attention backend: auto (the port's CUDA "
            "paged-prefill kernels on the card, the plain versions on the "
            "CPU)",
            on_change=_unported(
                "auto", "FLAGS_tpu_prefill_impl selects an arm of the JAX "
                "ragged prefill (xla | pallas) and the port has only its "
                "own kernels (ROADMAP A8.5)"))
define_flag("autotune_verbose", False,
            "log kernel autotune decisions with measured timings",
            on_change=_unported(
                False, "FLAGS_autotune_verbose logs the JAX autotuner's "
                "decisions and the autotuner is not ported (ROADMAP A8.5)"))
define_flag("dy2static_max_trip_count", 0,
            "when > 0, traced loops of dy2static conversion lower to a "
            "bounded scan of this many steps",
            on_change=_unported(
                0, "FLAGS_dy2static_max_trip_count bounds dy2static's "
                "traced loops and dy2static is not ported (ROADMAP A10.1)"))
