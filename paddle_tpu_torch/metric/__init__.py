"""paddle.metric of the port (counterpart of `paddle_tpu/metric/__init__.py`;
ref `python/paddle/metric/metrics.py` — Metric base, Accuracy, Precision,
Recall, Auc).

The streaming metrics count on the host in numpy, as the JAX package's do
(`Accuracy.compute` ranks with ``np.argsort(-pred)``, the same call).
`accuracy` runs on the tensors' device and ranks with a stable sort, which
keeps the lower index on ties as ``jnp.argsort`` does.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.tensor import Tensor


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = np.asarray(pred.numpy() if isinstance(pred, Tensor) else pred)
        label_np = np.asarray(label.numpy() if isinstance(label, Tensor) else label)
        order = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        correct = (order == label_np[..., None]).astype(np.float32)
        return Tensor(correct)

    def update(self, correct, *args):
        c = np.asarray(correct.numpy() if isinstance(correct, Tensor) else correct)
        num_samples = c.shape[0]
        accs = []
        for i, k in enumerate(self.topk):
            num_corrects = c[..., :k].sum()
            self.total[i] += num_corrects
            self.count[i] += num_samples
            accs.append(float(num_corrects) / num_samples)
        return accs[0] if len(self.topk) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = np.asarray(preds.numpy() if isinstance(preds, Tensor) else preds)
        l = np.asarray(labels.numpy() if isinstance(labels, Tensor) else labels)
        p = (p.reshape(-1) > 0.5).astype(np.int64)
        l = l.reshape(-1).astype(np.int64)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom > 0 else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = np.asarray(preds.numpy() if isinstance(preds, Tensor) else preds)
        l = np.asarray(labels.numpy() if isinstance(labels, Tensor) else labels)
        p = (p.reshape(-1) > 0.5).astype(np.int64)
        l = l.reshape(-1).astype(np.int64)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom > 0 else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = np.asarray(preds.numpy() if isinstance(preds, Tensor) else preds)
        l = np.asarray(labels.numpy() if isinstance(labels, Tensor) else labels)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        l = l.reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate trapezoid over descending thresholds
        area = 0.0
        pos = 0.0
        neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2.0
            pos, neg = new_pos, new_neg
        return float(area / (tot_pos * tot_neg))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    import torch
    from paddle_tpu_torch.core.autograd import apply
    from paddle_tpu_torch.ops.common import ensure_tensor
    input, label = ensure_tensor(input), ensure_tensor(label)

    def prim(p, l):
        topk_idx = torch.argsort(-p, dim=-1, stable=True)[..., :k]
        ll = l if l.dim() == 1 else l[..., 0]
        hit = torch.any(topk_idx == ll[..., None], dim=-1)
        # the mean as XLA computes jnp.mean: the sum times the f32
        # reciprocal of the count
        inv = torch.tensor(1.0 / max(hit.numel(), 1), dtype=torch.float32,
                           device=hit.device)
        return torch.sum(hit.to(torch.float32)) * inv

    return apply(prim, input, label, op_name="accuracy")
