"""The port's LR schedulers (`paddle_tpu_torch/optimizer/lr.py`) held
against the JAX package's (`paddle_tpu/optimizer/lr.py`): every one of
the seventeen schedules gives the same learning rate at each of 50 steps
(float equality: the same Python arithmetic), its ``state_dict`` is the
same and round-trips into a fresh schedule of the other package, and the
port's AdamW reads a schedule through ``get_lr()``."""
import json
import math

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 50


def _triangle(n):
    return 1.0 / (1 + 0.1 * n)


# name -> (args, kwargs) of one construction; a value "SCHED" is replaced
# by an inner schedule of the same package (LinearWarmup's wrapped one)
SCHEDULES = {
    "NoamDecay": ((), dict(d_model=64, warmup_steps=10, learning_rate=2.0)),
    "PiecewiseDecay": (([5, 20, 35], [0.1, 0.05, 0.01, 0.001]), {}),
    "NaturalExpDecay": ((0.5, 0.1), {}),
    "InverseTimeDecay": ((0.5, 0.1), {}),
    "PolynomialDecay": ((0.3, 20), dict(end_lr=0.01, power=2.0)),
    "PolynomialDecay_cycle": ((0.3, 20), dict(end_lr=0.01, cycle=True)),
    "LinearWarmup": (("SCHED", 10, 0.0, 0.1), {}),
    "LinearWarmup_float": ((0.1, 10, 0.0, 0.1), {}),
    "ExponentialDecay": ((0.2, 0.9), {}),
    "MultiStepDecay": ((0.2, [10, 25, 40]), dict(gamma=0.5)),
    "StepDecay": ((0.2, 7), dict(gamma=0.3)),
    "LambdaDecay": ((0.2, _triangle), {}),
    "ReduceOnPlateau": ((0.1,), dict(patience=2, factor=0.5, cooldown=1)),
    "CosineAnnealingDecay": ((0.1, 30), dict(eta_min=0.001)),
    "CosineAnnealingWarmRestarts": ((0.1, 8), dict(T_mult=2,
                                                   eta_min=0.001)),
    "OneCycleLR": ((0.5, 40), dict(three_phase=False)),
    "OneCycleLR_linear": ((0.5, 40), dict(anneal_strategy="linear")),
    "CyclicLR": ((0.01, 0.1, 5), dict(step_size_down=8)),
    "CyclicLR_triangular2": ((0.01, 0.1, 5), dict(mode="triangular2")),
    "CyclicLR_exp_range": ((0.01, 0.1, 5), dict(mode="exp_range",
                                                exp_gamma=0.97)),
    "LinearLR": ((0.1, 30), dict(start_factor=0.2, end_factor=0.9)),
    "CosineAnnealingWithWarmupDecay": ((0.1, 0.01, 8, 40), {}),
}


def _make(mod, name):
    args, kwargs = SCHEDULES[name]
    args = tuple(mod.CosineAnnealingDecay(0.1, 30) if a == "SCHED" else a
                 for a in args)
    return getattr(mod, name.split("_")[0])(*args, **kwargs)


def _drive(s, name, steps=STEPS):
    out = []
    for i in range(steps):
        out.append(s())
        if name.startswith("ReduceOnPlateau"):
            s.step(metrics=1.0 if i % 5 else 2.0 - i * 0.01)
        else:
            s.step()
    return out


def test_every_scheduler_class_is_ported():
    names = {n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)}
    assert len(names) == 18          # LRScheduler and the 17 schedules
    assert names <= set(dir(tlr))
    assert {n.split("_")[0] for n in SCHEDULES} == names - {"LRScheduler"}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_over_50_steps_equal(name):
    j, t = _make(jlr, name), _make(tlr, name)
    got, want = _drive(t, name), _drive(j, name)
    assert got == want
    assert all(math.isfinite(x) for x in got)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_state_dict_round_trips_across_packages(name):
    """The state after 17 steps is the same dict (and the same JSON a
    checkpoint's ``meta/lr_sched`` holds); a fresh schedule of each
    package set from the other's continues with the same rates."""
    j, t = _make(jlr, name), _make(tlr, name)
    _drive(j, name, 17)
    _drive(t, name, 17)
    assert t.state_dict() == j.state_dict()
    assert json.dumps(t.state_dict()) == json.dumps(j.state_dict())
    j2, t2 = _make(jlr, name), _make(tlr, name)
    t2.set_state_dict(json.loads(json.dumps(j.state_dict())))
    j2.set_state_dict(json.loads(json.dumps(t.state_dict())))
    assert _drive(t2, name, 10) == _drive(j, name, 10)
    assert _drive(j2, name, 10) == _drive(t, name, 10)


def test_adamw_reads_the_schedule():
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, 20), 4, 0.0,
                             1e-3)
    opt = AdamW(learning_rate=sched)
    seen = []
    for _ in range(8):
        seen.append(opt.get_lr())
        sched.step()
    assert seen == _drive(tlr.LinearWarmup(tlr.CosineAnnealingDecay(
        1e-3, 20), 4, 0.0, 1e-3), "LinearWarmup", 8)
    assert AdamW(learning_rate=0.5).get_lr() == 0.5
