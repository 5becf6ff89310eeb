"""The port's soak harness (`paddle_tpu_torch/testing/soak.py`) held
against the JAX package's (`paddle_tpu/testing/soak.py`): the same
rotations, the typed PeerLost drill in both, ``run_micro(2)`` over one
tiny CPU engine of each package (every scenario passes, pages clean),
and a failing scenario dumps the flight ring and returns 1 in both. The
port's chaos suites are its own test files, one for each JAX suite."""
import json
import os
from pathlib import Path

import pytest

from paddle_tpu.testing import soak as jsoak
from paddle_tpu_torch.testing import soak as tsoak

REPO = Path(__file__).resolve().parents[1]


def test_rotations_equal():
    for seq in ([], [1], list("abcde"), tsoak.CHAOS_SUITES):
        for i in range(-3, 12):
            assert tsoak.rotated(seq, i) == jsoak.rotated(seq, i)


def test_chaos_suites_are_the_port_files():
    assert len(tsoak.CHAOS_SUITES) == len(jsoak.CHAOS_SUITES)
    for suite in tsoak.CHAOS_SUITES:
        assert suite.startswith("tests/test_torch_"), suite
        assert (REPO / suite).is_file(), suite


def test_peer_lost_drill_typed_in_both(tmp_path):
    assert jsoak.peer_lost_drill(str(tmp_path / "j")) is True
    assert tsoak.peer_lost_drill(str(tmp_path / "t")) is True
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))


def test_run_micro_two_iterations_on_cpu(tmp_path):
    assert jsoak.run_micro(2, out_dir=str(tmp_path / "j")) == 0
    assert tsoak.run_micro(2, out_dir=str(tmp_path / "t"),
                           device="cpu") == 0
    assert not os.path.exists(tmp_path / "t")     # no failure dump
    assert [s.__name__ for s in tsoak._micro_scenarios()] == \
        [s.__name__ for s in jsoak._micro_scenarios()]


@pytest.mark.parametrize("mod", [jsoak, tsoak], ids=["jax", "torch"])
def test_run_micro_failure_dumps_the_ring(tmp_path, monkeypatch, mod):
    def broken(eng):
        raise AssertionError("planted")
    scen = mod._micro_scenarios
    monkeypatch.setattr(mod, "_micro_scenarios",
                        lambda: scen()[:1] + [broken])
    kw = {"device": "cpu"} if mod is tsoak else {}
    assert mod.run_micro(1, out_dir=str(tmp_path), **kw) == 1
    (dump,) = os.listdir(tmp_path)
    assert dump.startswith("soak_micro_")
    payload = json.load(open(tmp_path / dump))
    assert payload["label"] == "soak_micro" and "events" in payload


def test_main_micro_cli(tmp_path):
    assert tsoak.main(["--micro", "--iterations", "1", "--device", "cpu",
                       "--out-dir", str(tmp_path)]) == 0
