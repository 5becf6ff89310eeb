"""Weight and training-state carry-over from numpy arrays (for example a JAX
state_dict, or a JAX train step's state, read out with ``np.asarray``) to
the port's tensors. The layouts are the same, so this is a copy. A
weight-only int8 leaf (anything with ``.q``, ``.scale`` and
``.dtype_name``, such as the JAX package's ``QuantizedLeaf``) becomes the
port's `QuantizedLeaf` with the same int8 values and scales, bit for bit.
A JAX ``Layer.state_dict()`` loads into the port's Layer of the same class
by key (`layer_state_from_numpy`; GPT-2 and BERT alike), a JAX
``Optimizer.state_dict()`` into the port's optimizer of the same class
(`optimizer_state_from_numpy`); the port's Layer comes back out as numpy
arrays by key (`layer_state_to_numpy`), which the JAX Layer's
``set_state_dict`` loads."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.quantization.serving import QuantizedLeaf

__all__ = ["params_from_numpy", "train_state_from_numpy",
           "layer_state_from_numpy", "layer_state_to_numpy",
           "optimizer_state_from_numpy"]


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")   # a copy: the caller's array stays its own
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf(v, device, dtype):
    if all(hasattr(v, a) for a in ("q", "scale", "dtype_name")):
        return QuantizedLeaf(_to_tensor(np.asarray(v.q)).to(device),
                             _to_tensor(np.asarray(v.scale)).to(device),
                             str(v.dtype_name))
    return _to_tensor(v).to(device=device, dtype=dtype)


def params_from_numpy(state: dict, device,
                      dtype: torch.dtype | None = None) -> dict:
    """``{name: array}`` -> ``{name: tensor}`` on ``device``, in ``dtype``
    when given, else in each array's own dtype. A quantized leaf keeps its
    int8 values and f32 scales as they are (``dtype`` does not apply) and
    comes out as a `QuantizedLeaf`. Feed the result to
    ``GPTForCausalLM.set_state_dict`` (float leaves only) or straight to
    the step functions."""
    return {k: _leaf(v, device, dtype) for k, v in state.items()}


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
    ``GPTForCausalLM.set_state_dict``, per-layer AdamW state {name:
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


def layer_state_from_numpy(layer, state: dict):
    """Load ``{key: array}`` (a JAX ``Layer.state_dict()`` read out with
    ``np.asarray``) into the port's Layer of the same class by key,
    strictly: each parameter keeps its array's dtype and stays on its
    device. A missing or extra key raises KeyError naming both key lists.
    Returns ``layer``."""
    own = layer.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"layer_state_from_numpy: keys differ; missing "
                       f"{missing}, unexpected {extra}")
    for name, t in own.items():
        t._write(_to_tensor(np.asarray(state[name])).to(t._data.device))
    return layer


def layer_state_to_numpy(layer) -> dict:
    """``{key: np.ndarray}`` of the port's Layer (its ``state_dict()``,
    on the host): what the JAX Layer of the same class loads with
    ``set_state_dict``. bfloat16 values come out as float32 (exactly:
    numpy has no bfloat16)."""
    out = {}
    for name, t in layer.state_dict().items():
        d = t._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        out[name] = d.cpu().numpy()
    return out


def optimizer_state_from_numpy(optimizer, state: dict):
    """Load a JAX ``Optimizer.state_dict()`` (its Tensors read out with
    ``np.asarray``; ``global_step``, ``__param_keys__`` and
    ``LR_Scheduler`` as they are) into the port's optimizer of the same
    class: its accumulators by parameter name, or by position where the
    names differ (`Optimizer.set_state_dict`). Returns ``optimizer``."""
    optimizer.set_state_dict({
        k: (v if k in ("global_step", "__param_keys__", "LR_Scheduler")
            else _to_tensor(np.asarray(v))) for k, v in state.items()})
    return optimizer
