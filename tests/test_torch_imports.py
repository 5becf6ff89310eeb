"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry point runs on the card unless asked for the CPU, its
CUDA wrappers refuse input the kernels do not take (CPU tensors among
it), and its kernel build refuses to run without nvcc instead of falling
back to the plain versions."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.cuda import dropout as cdrop
from paddle_tpu_torch.kernels.cuda import flash_attention as cfa
from paddle_tpu_torch.kernels.cuda import fused_layernorm as cln
from paddle_tpu_torch.kernels.cuda import paged_attention as cdec
from paddle_tpu_torch.kernels.cuda import prefill_attention as cpre
from paddle_tpu_torch.kernels.cuda import rotary as crot

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke, profile_serve, profile_train
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print("LOADED", len([m for m in sys.modules if m.startswith("paddle_tpu_torch")]))
print("BAD", bad)
print("SAMPLING", all(m in sys.modules for m in (
    "paddle_tpu_torch.kernels.prng", "paddle_tpu_torch.kernels.sampling")))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert int(r.stdout.split("LOADED ")[1].split()[0]) >= 20
    # the sampled and speculative serving modules are among those held
    assert "SAMPLING True" in r.stdout, r.stdout


_PREFIX_PROBE = r"""
import sys
import paddle_tpu_torch.inference.kv_tiers, paddle_tpu_torch.serving.disagg
import paddle_tpu_torch.inference.engine
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu", "ml_dtypes"))
print("BAD", bad)
"""


def test_prefix_and_tier_modules_import_no_jax_or_ml_dtypes():
    """The prefix cache's modules load neither JAX, the JAX package nor
    ml_dtypes: the card's machine has none of them, so bf16 pages travel
    as raw int16 bits."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _PREFIX_PROBE], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


_TESTING_PROBE = r"""
import sys
from paddle_tpu_torch.testing import faults
import paddle_tpu_torch.inference.engine as engine
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print("BAD", bad)
print("ARMED", faults.ENABLED, faults.remaining("engine.step_delay"),
      engine.faults is faults)
"""


def test_testing_package_imports_no_jax_and_reads_paddle_faults():
    """`paddle_tpu_torch.testing` (the port's copy of the JAX package's
    stdlib-only `testing/faults.py`) loads neither JAX nor the JAX
    package, is the module the engine's fault sites read, and arms the
    sites ``PADDLE_FAULTS`` names when it is imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO),
               PADDLE_FAULTS="engine.step_delay:delay_s=0:times=2")
    r = subprocess.run([sys.executable, "-c", _TESTING_PROBE], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert "ARMED True 2 True" in r.stdout, r.stdout


_OBSERVABILITY_PROBE = r"""
import sys
import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.observability import (flight_recorder, prometheus,
                                            slo, tracing, usage)
stdlib_only = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "numpy"))
import paddle_tpu_torch.inference.engine as engine
import paddle_tpu_torch.train.scan_step as scan_step
import paddle_tpu_torch.kernels.registry as registry
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print("BAD", bad)
print("STDLIB", stdlib_only)
print("SAME", engine.metrics is obs.metrics is registry.metrics
      is scan_step.metrics, engine.flight is flight_recorder.flight)
print("DEADLINE", flight_recorder.default_deadline())
"""


def test_observability_package_imports_no_jax_and_keeps_its_own_registry():
    """`paddle_tpu_torch.observability` (the port's copies of the JAX
    package's stdlib-only modules) loads neither JAX, the JAX package,
    torch nor numpy; the engine, the train step and the kernel registry
    report to its one process-wide registry and flight ring; and its
    watchdog reads the JAX package's ``PADDLE_WATCHDOG_S``."""
    env = dict(os.environ, PYTHONPATH=str(REPO), PADDLE_WATCHDOG_S="42")
    r = subprocess.run([sys.executable, "-c", _OBSERVABILITY_PROBE],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert "STDLIB []" in r.stdout, r.stdout
    assert "SAME True True" in r.stdout, r.stdout
    assert "DEADLINE 42.0" in r.stdout, r.stdout


def test_engine_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from paddle_tpu_torch.inference.engine import DecodeEngine
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    m = GPTForCausalLM(GPTConfig(vocab_size=11, hidden_size=8, num_layers=1,
                                 num_heads=2, intermediate_size=16,
                                 max_position_embeddings=8))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DecodeEngine(m)


def _decode_args(dtype=torch.float32, dh=8):
    q = torch.zeros(2, 2, dh, dtype=dtype)
    kp = torch.zeros(5, 4, 2, dh, dtype=dtype)
    return q, kp, kp.clone(), torch.zeros(2, 2, dtype=torch.int32), \
        torch.zeros(2, dtype=torch.int32)


@pytest.mark.parametrize("case,match", [
    ("float16", "not supported"), ("mixed_dtype", "share one dtype"),
    ("noncontig_q", "contiguous"), ("head_dim_320", "head_dim 320"),
    ("int64_table", "int32"), ("pool_shape", "pools must"),
    ("cpu_tensors", "CUDA tensors")])
def test_decode_wrapper_refuses_bad_input(case, match):
    q, kp, vp, pt, pos = _decode_args()
    if case == "float16":
        q, kp, vp, pt, pos = _decode_args(torch.float16)
    elif case == "mixed_dtype":
        q = q.to(torch.bfloat16)
    elif case == "noncontig_q":
        q = torch.zeros(2, 2, 16)[..., ::2]
    elif case == "head_dim_320":
        q, kp, vp, pt, pos = _decode_args(dh=320)
    elif case == "int64_table":
        pt = pt.long()
    elif case == "pool_shape":
        vp = vp[:4]
    with pytest.raises(ValueError, match=match):
        cdec.paged_decode(q, kp, vp, pt, pos)


@pytest.mark.parametrize("start,valid,match", [
    (0, 9, "out of range"), (20, 4, "out of range"), (-1, 2, "out of range"),
    (0, 4, "CUDA tensors")])
def test_prefill_wrapper_refuses_bad_input(start, valid, match):
    q = torch.zeros(8, 2, 8)
    kp = torch.zeros(5, 4, 2, 8)
    row = torch.arange(1, 6, dtype=torch.int32)   # 5 pages = 20 positions
    with pytest.raises(ValueError, match=match):
        cpre.paged_prefill(q, kp, kp.clone(), row, start, valid)


def test_kernel_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "_BUILT", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    k = cdec.KERNEL
    monkeypatch.setattr(k, "_fn", None)
    before = k.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k.launch(*([None] * 7 + [1] * 6 + [None]))
    assert k.launches == before
    sources = ["dropout", "flash_dkv", "flash_dq", "flash_fwd",
               "fused_layernorm_bwd", "fused_layernorm_fwd", "paged_decode",
               "paged_decode_int8", "paged_prefill", "paged_prefill_int8",
               "rotary"]
    assert {x.source for x in _build.kernels()} >= set(sources)
    assert sorted(s.stem for s in _build.CSRC.glob("*.cu")) == sources


def _int8_args():
    q = torch.zeros(2, 2, 8)
    kp = torch.zeros(5, 4, 2, 8, dtype=torch.int8)
    ks = torch.ones(5, 4, 2)
    return q, kp, kp.clone(), ks, ks.clone()


@pytest.mark.parametrize("case,match", [
    ("cpu_tensors", "CUDA tensors"), ("no_scales", "need their k_scale"),
    ("float_pools", "takes int8 pools"), ("scale_shape", "k_scale must be"),
    ("scale_dtype", "v_scale must be"), ("noncontig_scale", "contiguous"),
    ("bf16_q", "CUDA tensors"), ("float16_q", "not supported")])
def test_int8_wrappers_refuse_bad_input(case, match):
    """The int8 decode and prefill wrappers: int8 pools with float32 scale
    pools of the pools' [num_pages, page_size, nh], q in f32 or bf16, on the
    card; anything else raises before a launch."""
    q, kp, vp, ks, vs = _int8_args()
    if case == "float_pools":
        kp, vp = kp.float(), vp.float()
    elif case == "scale_shape":
        ks = ks[:, :3]
    elif case == "scale_dtype":
        vs = vs.double()
    elif case == "noncontig_scale":
        ks = torch.ones(5, 4, 4)[..., ::2]
    elif case == "bf16_q":
        q = q.to(torch.bfloat16)
    elif case == "float16_q":
        q = q.half()
    pt, pos = torch.zeros(2, 2, dtype=torch.int32), \
        torch.zeros(2, dtype=torch.int32)
    row = torch.arange(1, 5, dtype=torch.int32)
    if case == "no_scales":
        calls = [lambda: cdec.paged_decode(q, kp, vp, pt, pos),
                 lambda: cpre.paged_prefill(q, kp, vp, row, 0, 2)]
    else:
        calls = [lambda: cdec.paged_decode_int8(q, kp, vp, ks, vs, pt, pos),
                 lambda: cpre.paged_prefill_int8(q, kp, vp, ks, vs, row, 0,
                                                 2)]
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("case,match", [
    ("cpu_tensors", "CUDA tensors"), ("float16", "not supported"),
    ("head_dim_320", "head_dim 320"), ("causal_longer_q", "seq_q <= seq_k"),
    ("noncontig_k", "contiguous"), ("mixed_dtype", "must be torch.float32"),
    ("lse_shape", "lse must be")])
def test_flash_wrappers_refuse_bad_input(case, match):
    q, k = torch.zeros(2, 8, 16), torch.zeros(2, 12, 16)
    v, do = k.clone(), q.clone()
    lse, delta = torch.zeros(2, 8), torch.zeros(2, 8)
    causal = True
    if case == "float16":
        q, k, v, do = (t.half() for t in (q, k, v, do))
    elif case == "head_dim_320":
        q, k, v, do = (torch.zeros(2, t.shape[1], 320) for t in (q, k, v, do))
    elif case == "causal_longer_q":
        q, do, lse, delta = (torch.cat([t, t], 1) for t in (q, do, lse, delta))
    elif case == "noncontig_k":
        k = torch.zeros(2, 12, 32)[..., ::2]
    elif case == "mixed_dtype":
        delta = delta.double()
    elif case == "lse_shape":
        lse = lse[:, :4]
    if case not in ("mixed_dtype", "lse_shape"):
        with pytest.raises(ValueError, match=match):
            cfa.flash_fwd(q, k, v, 0.25, causal)
    with pytest.raises(ValueError, match=match):
        cfa.flash_dq(q, k, v, do, lse, delta, 0.25, causal)
    with pytest.raises(ValueError, match=match):
        cfa.flash_dkv(q, k, v, do, lse, delta, 0.25, causal)


@pytest.mark.parametrize("case,match", [
    ("cpu_tensors", "CUDA tensors"), ("float16", "not supported"),
    ("d_too_wide", "1 <= d <= 8192"), ("gamma_dtype", "float32 or x's"),
    ("beta_shape", "beta must be"), ("noncontig_x", "x must be contiguous"),
    ("mixed_devices", "one device"), ("rstd_dtype", "rstd must be"),
    ("dy_shape", "dy must be"), ("mu_shape", "mu must be")])
def test_layernorm_wrappers_refuse_bad_input(case, match):
    """The fused layernorm wrappers: rows [n, d] in f32 or bf16 with
    1 <= d <= 8192, gamma/beta [d] in f32 or x's dtype, f32 statistics
    [n, 1], all contiguous and on the card; anything else raises before a
    launch."""
    x, dy = torch.zeros(6, 16), torch.zeros(6, 16)
    g, b = torch.ones(16), torch.zeros(16)
    mu, rstd = torch.zeros(6, 1), torch.ones(6, 1)
    if case == "float16":
        x, dy = x.half(), dy.half()
    elif case == "d_too_wide":
        x = dy = torch.zeros(2, 8200)
    elif case == "gamma_dtype":
        x, dy = x.bfloat16(), dy.bfloat16()
        g = b = g.double()
    elif case == "beta_shape":
        b = b[:8]
    elif case == "noncontig_x":
        x = torch.zeros(6, 32)[:, ::2]
    elif case == "mixed_devices":
        g = torch.ones(16, device="meta")
        b = torch.zeros(16, device="meta")
    elif case == "rstd_dtype":
        rstd = rstd.double()
    elif case == "dy_shape":
        dy = dy[:3]
    elif case == "mu_shape":
        mu = mu.view(6)
    calls = []
    if case not in ("rstd_dtype", "dy_shape", "mu_shape"):
        calls.append(lambda: cln.fused_layernorm_fwd(x, g, b, 1e-5))
    if case != "beta_shape":
        calls.append(lambda: cln.fused_layernorm_bwd(x, g, mu, rstd, dy))
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("case,match", [
    ("cpu_tensors", "CUDA tensors"), ("float16", "not supported"),
    ("k_shape", "share one shape"), ("cos_shape", "cos must be"),
    ("noncontig_q", "q must be contiguous"), ("table_dtype", "cos and sin")])
def test_rotary_wrapper_refuses_bad_input(case, match):
    q, k = torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16)
    cos, sin = torch.ones(8, 8), torch.zeros(8, 8)
    if case == "float16":
        q, k = q.half(), k.half()
    elif case == "k_shape":
        k = k[:, :1]
    elif case == "cos_shape":
        cos = cos[:, :4]
    elif case == "noncontig_q":
        q = torch.zeros(1, 2, 16, 8).transpose(2, 3)
    elif case == "table_dtype":
        sin = sin.bfloat16()
    with pytest.raises(ValueError, match=match):
        crot.rotary(q, k, cos, sin)


@pytest.mark.parametrize("case,match", [
    ("cpu_tensors", "CUDA tensors"), ("float16", "not supported"),
    ("noncontig_x", "x must be contiguous"), ("key_dtype", "key must be"),
    ("key_shape", "key must be")])
def test_dropout_wrapper_refuses_bad_input(case, match):
    x, key = torch.zeros(4, 8), torch.zeros(2, dtype=torch.int64)
    if case == "float16":
        x = x.half()
    elif case == "noncontig_x":
        x = torch.zeros(8, 4).t()
    elif case == "key_dtype":
        key = key.int()
    elif case == "key_shape":
        key = torch.zeros(2, 2, dtype=torch.int64)
    before = cdrop.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        cdrop.dropout(x, key, 0.1)
    assert cdrop.KERNEL.launches == before


@pytest.mark.parametrize("fault", ["mask_leak", "pv_pair_swap",
                                   "pv_round_toward_zero", "lse_log2",
                                   "dkv_mask_leak", "dq_mask_leak",
                                   "decode_split_drop"])
def test_bf16_parity_controls_plant_into_the_sources(fault, tmp_path):
    """Each planted fault of `bf16_parity_controls.py` changes the kernel
    sources as they are now (each text it replaces occurs once), so the
    controls of the bf16 end-to-end checks keep running on the card."""
    sys.path.insert(0, str(REPO))
    try:
        import bf16_parity_controls as ctl
    finally:
        sys.path.remove(str(REPO))
    edits = ctl.FAULTS[fault][1]
    for rel, _, _ in edits:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text((REPO / rel).read_text())
    ctl.plant(tmp_path, edits)
    for rel, text, planted in edits:
        src = (tmp_path / rel).read_text()
        assert planted in src and src != (REPO / rel).read_text()


@pytest.mark.parametrize("stem", ["flash_dkv", "flash_dq"])
def test_profile_dkv_variants_apply_to_the_sources(stem):
    """Each block-shape variant `profile_dkv.py` builds changes its loop's
    source as it is now (each text it replaces occurs once), so the sweep
    keeps running on the card."""
    sys.path.insert(0, str(REPO))
    try:
        import profile_dkv as prof
    finally:
        sys.path.remove(str(REPO))
    loop, variants = prof.LOOPS[stem]
    text = (REPO / "paddle_tpu_torch/kernels/csrc" / loop).read_text()
    assert (REPO / "paddle_tpu_torch/kernels/csrc" / f"{stem}.cu").exists()
    for variant, edits in variants.items():
        for old, _ in edits:
            assert text.count(old) == 1, (variant, old)
