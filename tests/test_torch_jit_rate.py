"""The JAX bench's float32 GPT program (`bench.py:155-196`: AdamW, the step
under ``to_static``, then ``multi_steps``) at a rate of 1e-3, ten times the
bench's, on the port against the JAX package's on the CPU (ROADMAP C21):
the same 7 steps as `tests/test_torch_jit.py::
test_bench_program_matches_jax`.

Every parameter but the key part of each qkv bias is held within 1e-5 (and
every loss within 1e-5). The key bias's true gradient is zero (softmax
ignores a shift common to a row's keys), so its computed gradient is
rounding noise, which Adam normalizes into steps of about the rate in
either direction: after 7 steps it stands 1.3e-5 from the JAX package's
(measured on this test's seed), and is held within 7 steps of the rate
(7e-3). The query and value parts of the same bias are held within 1e-5
with the rest.
"""
import numpy as np

import paddle_tpu as jp
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tp
from paddle_tpu_torch.models import gpt as tgpt
from tests.test_torch_jit import (  # noqa: F401 - the two fixtures
    TINY, _bench_program, _batch, _f64, _port_on_cpu, jax_eager)

RATE = 1e-3
STEPS = 7


def test_bench_program_at_rate_1e3_drifts_only_on_the_key_bias(jax_eager):
    progs = {m: _bench_program(m, g, lr=RATE)
             for m, g in ((tp, tgpt), (jp, jgpt))}
    x, y = _batch()
    xk, yk = _batch(k=4)
    losses = {}
    for m in (tp, jp):
        step = progs[m][2]
        losses[m] = [float(step(m.to_tensor(x), m.to_tensor(y)))
                     for _ in range(3)]
        losses[m] += list(np.asarray(step.multi_steps(4)(
            m.to_tensor(xk), m.to_tensor(yk)).numpy(), np.float64))
    assert len(losses[tp]) == STEPS
    assert np.abs(np.subtract(losses[tp], losses[jp])).max() <= 1e-5
    ts, js = progs[tp][0].state_dict(), progs[jp][0].state_dict()
    h = TINY["hidden_size"]
    key_drift = 0.0
    for k, v in js.items():
        a, b = _f64(ts[k]), _f64(v)
        if k.endswith("attn.qkv_proj.bias"):
            key_drift = max(key_drift, float(np.abs(a[h:2 * h]
                                                    - b[h:2 * h]).max()))
            a, b = np.delete(a, np.s_[h:2 * h]), np.delete(b, np.s_[h:2 * h])
        assert np.abs(a - b).max() <= 1e-5, k
    assert key_drift <= STEPS * RATE, key_drift
