"""Weight and training-state carry-over from numpy arrays (for example a JAX
state_dict, or a JAX train step's state, read out with ``np.asarray``) to
the port's tensors. The layouts are the same, so this is a copy."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "train_state_from_numpy"]


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")   # a copy: the caller's array stays its own
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(state: dict[str, np.ndarray], device,
                      dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """``{name: array}`` -> ``{name: tensor}`` on ``device``, in ``dtype``
    when given, else in each array's own dtype. Feed the result to
    ``GPTForCausalLM.load_state_dict`` or straight to the step functions."""
    return {k: _to_tensor(v).to(device=device, dtype=dtype)
            for k, v in state.items()}


def _per_layer(stacked):
    """(state_dict name, array) pairs of a stacked {"blocks": {suffix:
    [nl, ...]}, "top": {name: array}} tree: block leaf i of ``suffix`` is
    ``gpt.h.{i}.{suffix}``."""
    for suffix, leaf in stacked["blocks"].items():
        for i in range(leaf.shape[0]):
            yield f"gpt.h.{i}.{suffix}", leaf[i]
    yield from stacked["top"].items()


def train_state_from_numpy(params, opt_state, device,
                           dtype: torch.dtype | None = None):
    """A JAX ``ScanTrainStep``'s ``_params`` and ``_opt_state`` (stacked
    trees of numpy arrays; each optimizer leaf a dict {"moment1",
    "moment2"[, "master"]}) -> (per-layer params {name: tensor} for
    ``GPTForCausalLM.load_state_dict``, per-layer AdamW state {name:
    {state name: float32 tensor}} for ``AdamW.state``), on ``device``; the
    params in ``dtype`` when given, else in their own dtype."""
    out_params = {n: _to_tensor(a).to(device=device, dtype=dtype)
                  for n, a in _per_layer(params)}
    per_state = {}
    names = {s for grp in ("blocks", "top") for st in opt_state[grp].values()
             for s in st}
    for sname in sorted(names):
        tree = {grp: {k: st[sname] for k, st in opt_state[grp].items()
                      if sname in st} for grp in ("blocks", "top")}
        for n, a in _per_layer(tree):
            per_state.setdefault(n, {})[sname] = _to_tensor(a).to(
                device=device, dtype=torch.float32)
    return out_params, per_state
