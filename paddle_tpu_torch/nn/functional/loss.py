"""Loss functionals (counterpart of `paddle_tpu/nn/functional/loss.py`),
each the JAX package's formula in torch ops."""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.common import ensure_tensor

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "sigmoid_focal_loss", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "square_error_cost", "log_loss", "ctc_loss", "soft_margin_loss",
           "multi_label_soft_margin_loss", "dice_loss", "npair_loss",
           "hsigmoid_loss", "margin_cross_entropy", "class_center_sample"]


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _zero(like):
    return torch.zeros((), dtype=like.dtype, device=like.device)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    input, label = ensure_tensor(input), ensure_tensor(label)
    ts = [input, label] + ([ensure_tensor(weight)] if weight is not None
                           else [])

    def prim(logits, lab, *w):
        if use_softmax:
            logp = torch.log_softmax(logits, dim=axis)
        else:
            logp = torch.log(torch.clamp(logits, min=1e-15))
        nclass = logits.shape[axis]
        if soft_label or (lab.dim() == logits.dim()
                          and lab.shape == logits.shape):
            soft = lab
            if label_smoothing > 0:
                soft = soft * (1 - label_smoothing) + label_smoothing / nclass
            loss = -torch.sum(soft * logp, dim=axis)
        else:
            li = lab
            if li.dim() == logits.dim():
                li = li.squeeze(axis)
            li = li.long()
            valid = li != ignore_index
            safe = torch.where(valid, li, torch.zeros_like(li))
            picked = torch.take_along_dim(logp, safe.unsqueeze(axis),
                                          dim=axis).squeeze(axis)
            if label_smoothing > 0:
                smooth = -torch.mean(logp, dim=axis)
                loss = -(1 - label_smoothing) * picked + \
                    label_smoothing * smooth
            else:
                loss = -picked
            if w:
                wv = w[0][safe]
                loss = loss * wv
                if reduction == "mean":
                    denom = torch.sum(torch.where(valid, wv, _zero(wv)))
                    return torch.sum(torch.where(valid, loss,
                                                 _zero(loss))) / denom
            loss = torch.where(valid, loss, _zero(loss))
            if reduction == "mean":
                return torch.sum(loss) / torch.clamp(valid.sum(), min=1)
        return _reduce(loss, reduction)

    return apply(prim, *ts, op_name="cross_entropy")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from paddle_tpu_torch.nn.functional.activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    input, label = ensure_tensor(input), ensure_tensor(label)
    ts = [input, label] + ([ensure_tensor(weight)] if weight is not None
                           else [])

    def prim(logp, lab, *w):
        li = lab.long()
        valid = li != ignore_index
        safe = torch.where(valid, li, torch.zeros_like(li))
        loss = -torch.take_along_dim(logp, safe.unsqueeze(1), dim=1
                                     ).squeeze(1)
        if w:
            wv = w[0][safe]
            loss = torch.where(valid, loss * wv, _zero(loss))
            if reduction == "mean":
                return torch.sum(loss) / torch.sum(
                    torch.where(valid, wv, _zero(wv)))
        loss = torch.where(valid, loss, _zero(loss))
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(valid.sum(), min=1)
        return _reduce(loss, reduction)

    return apply(prim, *ts, op_name="nll_loss")


def mse_loss(input, label, reduction="mean", name=None):
    return apply(lambda a, b: _reduce((a - b) ** 2, reduction),
                 ensure_tensor(input), ensure_tensor(label),
                 op_name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return apply(lambda a, b: _reduce(torch.abs(a - b), reduction),
                 ensure_tensor(input), ensure_tensor(label),
                 op_name="l1_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def prim(a, b):
        d = torch.abs(a - b)
        return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                                   d - 0.5 * delta), reduction)

    return apply(prim, ensure_tensor(input), ensure_tensor(label),
                 op_name="smooth_l1_loss")


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    ts = [ensure_tensor(input), ensure_tensor(label)] + (
        [ensure_tensor(weight)] if weight is not None else [])

    def prim(p, y, *w):
        p = torch.clamp(p, 1e-12, 1 - 1e-12)
        loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)

    return apply(prim, *ts, op_name="binary_cross_entropy")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    ts = [ensure_tensor(logit), ensure_tensor(label)]
    has_w, has_pw = weight is not None, pos_weight is not None
    if has_w:
        ts.append(ensure_tensor(weight))
    if has_pw:
        ts.append(ensure_tensor(pos_weight))

    def prim(z, y, *rest):
        it = iter(rest)
        w = next(it) if has_w else None
        pw = next(it) if has_pw else None
        max_val = torch.clamp(-z, min=0)
        lse = torch.log(torch.exp(-max_val) + torch.exp(-z - max_val))
        if pw is not None:
            loss = (1 - y) * z + ((pw - 1) * y + 1) * (lse + max_val)
        else:
            loss = (1 - y) * z + max_val + lse
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)

    return apply(prim, *ts, op_name="binary_cross_entropy_with_logits")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    ts = [ensure_tensor(logit), ensure_tensor(label)] + (
        [ensure_tensor(normalizer)] if normalizer is not None else [])

    def prim(z, y, *n):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + torch.log1p(
            torch.exp(-torch.abs(z)))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * ((1 - p_t) ** gamma) * ce
        if n:
            loss = loss / n[0]
        return _reduce(loss, reduction)

    return apply(prim, *ts, op_name="sigmoid_focal_loss")


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def prim(logp, y):
        if log_target:
            loss = torch.exp(y) * (y - logp)
        else:
            loss = y * (torch.log(torch.clamp(y, min=1e-12)) - logp)
        if reduction == "batchmean":
            return torch.sum(loss) / logp.shape[0]
        return _reduce(loss, reduction)

    return apply(prim, ensure_tensor(input), ensure_tensor(label),
                 op_name="kl_div")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply(lambda a, b, y: _reduce(
        torch.clamp(-y * (a - b) + margin, min=0), reduction),
        ensure_tensor(input), ensure_tensor(other), ensure_tensor(label),
        op_name="margin_ranking_loss")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return apply(lambda a, y: _reduce(torch.where(
        y == 1, a, torch.clamp(margin - a, min=0)), reduction),
        ensure_tensor(input), ensure_tensor(label),
        op_name="hinge_embedding_loss")


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    def prim(a, b, y):
        cos = torch.sum(a * b, -1) / (torch.linalg.norm(a, dim=-1) *
                                      torch.linalg.norm(b, dim=-1) + 1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin, min=0))
        return _reduce(loss, reduction)

    return apply(prim, ensure_tensor(input1), ensure_tensor(input2),
                 ensure_tensor(label), op_name="cosine_embedding_loss")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def prim(a, pos, neg):
        def dist(u, v):
            return torch.sum(torch.abs(u - v) ** p + epsilon,
                             dim=-1) ** (1.0 / p)
        d_ap, d_an = dist(a, pos), dist(a, neg)
        if swap:
            d_an = torch.minimum(d_an, dist(pos, neg))
        return _reduce(torch.clamp(d_ap - d_an + margin, min=0), reduction)

    return apply(prim, ensure_tensor(input), ensure_tensor(positive),
                 ensure_tensor(negative), op_name="triplet_margin_loss")


def square_error_cost(input, label):
    return apply(lambda a, b: (a - b) ** 2, ensure_tensor(input),
                 ensure_tensor(label), op_name="square_error_cost")


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply(lambda p, y: -y * torch.log(p + epsilon) -
                 (1 - y) * torch.log(1 - p + epsilon), ensure_tensor(input),
                 ensure_tensor(label), op_name="log_loss")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over the alpha lattice, as the JAX package's scan: ``log_probs``
    [T, B, C] logits (log-softmaxed here)."""
    def prim(lp, lab, in_len, lab_len):
        lp = torch.log_softmax(lp, dim=-1)
        T, B, C = lp.shape
        S = lab.shape[1]
        ext = 2 * S + 1
        neg = -1e30
        ext_lab = torch.full((B, ext), blank, dtype=torch.long,
                             device=lp.device)
        ext_lab[:, 1::2] = lab.long()
        same2 = torch.cat([torch.zeros(B, 2, dtype=torch.bool,
                                       device=lp.device),
                           ext_lab[:, 2:] == ext_lab[:, :-2]], dim=1)

        def emit(t):
            return torch.gather(lp[t], 1, ext_lab)

        full = torch.full((B, ext), neg, dtype=lp.dtype, device=lp.device)
        e0 = emit(0)
        alpha = torch.cat([e0[:, :2], full[:, 2:]], dim=1)
        for t in range(1, T):
            prev1 = torch.cat([full[:, :1], alpha[:, :-1]], dim=1)
            prev2 = torch.cat([full[:, :2], alpha[:, :-2]], dim=1)
            prev2 = torch.where(same2 | (ext_lab == blank), full, prev2)
            merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
            new = merged + emit(t)
            alpha = torch.where((t < in_len)[:, None], new, alpha)
        end1 = 2 * lab_len.long()
        end2 = torch.clamp(2 * lab_len.long() - 1, min=0)
        ll = torch.logaddexp(torch.gather(alpha, 1, end1[:, None])[:, 0],
                             torch.gather(alpha, 1, end2[:, None])[:, 0])
        loss = -ll
        if reduction == "mean":
            return torch.mean(loss / torch.clamp(lab_len, min=1))
        return _reduce(loss, reduction)

    return apply(prim, ensure_tensor(log_probs), ensure_tensor(labels),
                 ensure_tensor(input_lengths), ensure_tensor(label_lengths),
                 op_name="ctc_loss")


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply(lambda x, y: _reduce(TF.softplus(-y.to(x.dtype) * x),
                                      reduction),
                 ensure_tensor(input), ensure_tensor(label),
                 op_name="soft_margin_loss")


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    ts = [ensure_tensor(input), ensure_tensor(label)] + (
        [ensure_tensor(weight)] if weight is not None else [])

    def prim(x, y, *w):
        y = y.to(x.dtype)
        per = -(y * TF.logsigmoid(x) + (1 - y) * TF.logsigmoid(-x))
        if w:
            per = per * w[0]
        return _reduce(torch.mean(per, dim=-1), reduction)

    return apply(prim, *ts, op_name="multi_label_soft_margin_loss")


def dice_loss(input, label, epsilon=1e-5, name=None):
    def prim(x, y):
        oh = TF.one_hot(y.squeeze(-1).long(), x.shape[-1]).to(x.dtype)
        red = tuple(range(1, x.dim()))
        inter = torch.sum(x * oh, dim=red)
        union = torch.sum(x, dim=red) + torch.sum(oh, dim=red)
        return torch.mean(1 - (2 * inter) / (union + epsilon))

    return apply(prim, ensure_tensor(input), ensure_tensor(label),
                 op_name="dice_loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    def prim(a, p, y):
        y = y.reshape(-1)
        tgt = (y[:, None] == y[None, :]).to(a.dtype)
        tgt = tgt / torch.sum(tgt, dim=1, keepdim=True)
        ce = torch.mean(torch.sum(-tgt * torch.log_softmax(a @ p.T, dim=1),
                                  dim=1))
        reg = l2_reg * (torch.mean(torch.sum(a * a, dim=1))
                        + torch.mean(torch.sum(p * p, dim=1))) * 0.25
        return ce + reg

    return apply(prim, ensure_tensor(anchor), ensure_tensor(positive),
                 ensure_tensor(labels), op_name="npair_loss")


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the complete binary tree of the
    reference's MatrixBitCodeFunctor, or a custom tree given by
    ``path_table`` / ``path_code`` [N, L] with -1 padding."""
    ts = [ensure_tensor(input), ensure_tensor(label), ensure_tensor(weight)]
    if bias is not None:
        ts.append(ensure_tensor(bias))
    custom = path_table is not None
    if custom:
        ts += [ensure_tensor(path_table), ensure_tensor(path_code)]
    max_len = int(math.ceil(math.log2(max(num_classes, 2)))) + 1

    def prim(x, y, w, *rest):
        b = rest[0] if bias is not None else None
        if custom:
            table = rest[-2].long()
            code = rest[-1].to(x.dtype)
            mask = (table >= 0).to(x.dtype)
            nodes = torch.clamp(table, min=0)
        else:
            c = y.reshape(-1).long() + num_classes
            length = torch.floor(torch.log2(c.float())).long()
            j = torch.arange(max_len, device=x.device)[None, :]
            valid = j < length[:, None]
            shift = torch.clamp(length[:, None] - j, min=0)
            nodes = torch.where(valid, (c[:, None] >> shift) - 1,
                                torch.zeros_like(shift))
            code = ((c[:, None] >> torch.clamp(shift - 1, min=0)) & 1
                    ).to(x.dtype)
            mask = valid.to(x.dtype)
        pre = torch.einsum("nd,nld->nl", x, w[nodes])
        if b is not None:
            pre = pre + b.reshape(-1)[nodes]
        per = torch.clamp(pre, min=0) - pre * code + torch.log1p(
            torch.exp(-torch.abs(pre)))
        return torch.sum(per * mask, dim=1, keepdim=True)

    return apply(prim, *ts, op_name="hsigmoid_loss")


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """Combined-margin softmax cross entropy: the target logit
    cos(theta) becomes ``cos(m1 * theta + m2) - m3`` before scaling."""
    def prim(lg, y):
        y = y.reshape(-1)
        oh = TF.one_hot(y.long(), lg.shape[1]).to(lg.dtype)
        cos = torch.clamp(lg, -1.0, 1.0)
        tgt = torch.cos(margin1 * torch.acos(cos) + margin2) - margin3
        logp = torch.log_softmax(torch.where(oh > 0, tgt, cos) * scale,
                                 dim=-1)
        loss = -torch.sum(oh * logp, dim=-1, keepdim=True)
        if reduction == "mean":
            loss = torch.mean(loss)
        elif reduction == "sum":
            loss = torch.sum(loss)
        if return_softmax:
            return loss, torch.exp(logp)
        return loss

    return apply(prim, ensure_tensor(logits), ensure_tensor(label),
                 op_name="margin_cross_entropy")


def class_center_sample(label, num_classes, num_samples, group=None):
    """All positive classes plus sampled negatives (seeded by the labels'
    crc32, as the JAX package), and the labels remapped into them; on the
    host. Returns (remapped_label, sampled_class_indices)."""
    lab = ensure_tensor(label).numpy().reshape(-1)
    pos = np.unique(lab)
    n_sample = max(int(num_samples), len(pos))
    neg_pool = np.setdiff1d(np.arange(num_classes), pos)
    rng = np.random.RandomState(zlib.crc32(lab.tobytes()) % (2**31))
    extra = rng.choice(neg_pool, size=min(n_sample - len(pos),
                                          len(neg_pool)), replace=False) \
        if n_sample > len(pos) else np.array([], np.int64)
    sampled = np.concatenate([pos, np.sort(extra)]).astype(lab.dtype)
    remap = {c: i for i, c in enumerate(sampled)}
    remapped = np.array([remap[c] for c in lab], dtype=lab.dtype)
    return Tensor(remapped), Tensor(sampled)
