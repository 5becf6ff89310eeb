"""Linear algebra ops (counterpart of `paddle_tpu/ops/linalg.py`), on
``torch.linalg``; the host-side ones of the JAX package (``lstsq``) stay on
the host."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.amp.state import amp_cast_inputs
from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor, to_torch
from paddle_tpu_torch.framework.flags import flag_value
from paddle_tpu_torch.ops.common import ensure_tensor, promote_pair

__all__ = ["matmul", "bmm", "mv", "norm", "vector_norm", "matrix_norm",
           "dist", "cdist", "cholesky", "cholesky_solve", "qr", "svd",
           "svdvals", "eig", "eigvals", "eigh", "eigvalsh", "inv", "inverse",
           "pinv", "det", "slogdet", "solve", "triangular_solve", "lstsq",
           "matrix_power", "matrix_rank", "cond", "multi_dot", "trace", "lu",
           "lu_unpack", "corrcoef", "cov", "householder_product",
           "pca_lowrank", "matrix_exp"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = promote_pair(ensure_tensor(x), ensure_tensor(y))
    x, y = amp_cast_inputs("matmul", x, y)

    def prim(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        if use_bf16 and a.dtype == torch.float32:
            # FLAGS_use_bfloat16_matmul: bf16 inputs, f32 accumulation (a
            # product of two bf16 values is exact in f32)
            return torch.matmul(a.to(torch.bfloat16).float(),
                                b.to(torch.bfloat16).float())
        return torch.matmul(a, b)

    use_bf16 = flag_value("use_bfloat16_matmul")
    return apply(prim, x, y, op_name="matmul")


def bmm(x, y, name=None):
    return apply(torch.matmul, ensure_tensor(x), ensure_tensor(y),
                 op_name="bmm")


def mv(x, vec, name=None):
    return apply(torch.matmul, ensure_tensor(x), ensure_tensor(vec),
                 op_name="mv")


def _axis(axis):
    if axis is None:
        return None
    return tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = _axis(axis)
    pp = "fro" if p is None else p

    def prim(a):
        dims = tuple(range(a.dim())) if ax is None else ax
        if pp == "fro":
            return torch.sqrt(torch.sum(a * a, dim=dims, keepdim=keepdim))
        if pp == "nuc":
            return torch.sum(torch.linalg.svdvals(a), dim=-1)
        if pp == float("inf"):
            return torch.amax(torch.abs(a), dim=dims, keepdim=keepdim)
        if pp == float("-inf"):
            return torch.amin(torch.abs(a), dim=dims, keepdim=keepdim)
        if pp == 0:
            return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
        return torch.sum(torch.abs(a) ** pp, dim=dims,
                         keepdim=keepdim) ** (1.0 / pp)

    return apply(prim, x, op_name="norm")


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    x = ensure_tensor(x)
    return apply(lambda a: torch.linalg.matrix_norm(
        a, ord=p, dim=tuple(axis), keepdim=keepdim), x, op_name="matrix_norm")


def dist(x, y, p=2, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)

    def prim(a, b):
        d = a - b
        if p == float("inf"):
            return torch.amax(torch.abs(d))
        if p == float("-inf"):
            return torch.amin(torch.abs(d))
        if p == 0:
            return torch.sum((d != 0).to(d.dtype))
        return torch.sum(torch.abs(d) ** p) ** (1.0 / p)

    return apply(prim, x, y, op_name="dist")


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)

    def prim(a, b):
        d = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(d * d, dim=-1))
        return torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)

    return apply(prim, x, y, op_name="cdist")


def cholesky(x, upper=False, name=None):
    x = ensure_tensor(x)
    return apply(lambda a: torch.linalg.cholesky(a, upper=upper), x,
                 op_name="cholesky")


def cholesky_solve(x, y, upper=False, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply(lambda b, L: torch.cholesky_solve(b, L, upper=upper), x, y,
                 op_name="cholesky_solve")


def qr(x, mode="reduced", name=None):
    x = ensure_tensor(x)
    if mode == "r":
        return apply(lambda a: torch.linalg.qr(a, mode="r").R, x,
                     op_name="qr")
    return apply(lambda a: tuple(torch.linalg.qr(a, mode=mode)), x,
                 op_name="qr")


def svd(x, full_matrices=False, name=None):
    x = ensure_tensor(x)
    return apply(lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), x, op_name="svd")


def svdvals(x, name=None):
    return apply(torch.linalg.svdvals, ensure_tensor(x), op_name="svdvals")


def eig(x, name=None):
    return apply(lambda a: tuple(torch.linalg.eig(a)), ensure_tensor(x),
                 op_name="eig")


def eigvals(x, name=None):
    return apply(torch.linalg.eigvals, ensure_tensor(x), op_name="eigvals")


def eigh(x, UPLO="L", name=None):
    return apply(lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)),
                 ensure_tensor(x), op_name="eigh")


def eigvalsh(x, UPLO="L", name=None):
    return apply(lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO),
                 ensure_tensor(x), op_name="eigvalsh")


def inv(x, name=None):
    return apply(torch.linalg.inv, ensure_tensor(x), op_name="inverse")


inverse = inv


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                             hermitian=hermitian),
                 ensure_tensor(x), op_name="pinv")


def det(x, name=None):
    return apply(torch.linalg.det, ensure_tensor(x), op_name="det")


def slogdet(x, name=None):
    return apply(lambda a: tuple(torch.linalg.slogdet(a)), ensure_tensor(x),
                 op_name="slogdet")


def solve(x, y, name=None):
    return apply(torch.linalg.solve, ensure_tensor(x), ensure_tensor(y),
                 op_name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)

    def prim(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up, left=True,
                                             unitriangular=unitriangular)

    return apply(prim, x, y, op_name="triangular_solve")


def lstsq(x, y, rcond=None, driver=None, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    sol, res, rank, sv = np.linalg.lstsq(x.numpy(), y.numpy(), rcond=rcond)
    dev = x._data.device
    return tuple(Tensor(to_torch(np.asarray(a), None, dev), _internal=True)
                 for a in (sol, res, rank, sv))


def matrix_power(x, n, name=None):
    return apply(lambda a: torch.linalg.matrix_power(a, n), ensure_tensor(x),
                 op_name="matrix_power")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply(lambda a: torch.linalg.matrix_rank(a, atol=tol,
                                                    hermitian=hermitian),
                 ensure_tensor(x), op_name="matrix_rank")


def cond(x, p=None, name=None):
    return apply(lambda a: torch.linalg.cond(a, p), ensure_tensor(x),
                 op_name="cond")


def multi_dot(x, name=None):
    ts = [ensure_tensor(t) for t in x]
    return apply(lambda *arrs: torch.linalg.multi_dot(arrs), *ts,
                 op_name="multi_dot")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1),
                 ensure_tensor(x), op_name="trace")


def lu(x, pivot=True, get_infos=False, name=None):
    x = ensure_tensor(x)
    out = apply(lambda a: tuple(torch.linalg.lu_factor(a)), x, op_name="lu")
    if get_infos:
        info = Tensor(torch.zeros(x.shape[:-2] or (1,), dtype=torch.int32,
                                  device=x._data.device), _internal=True)
        return out[0], out[1], info
    return out


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    return apply(lambda lu_, piv: tuple(torch.lu_unpack(lu_, piv)),
                 ensure_tensor(x), ensure_tensor(y), op_name="lu_unpack")


def corrcoef(x, rowvar=True, name=None):
    return apply(lambda a: torch.corrcoef(a if rowvar else a.T),
                 ensure_tensor(x), op_name="corrcoef")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = ensure_tensor(x)
    fw = None if fweights is None else ensure_tensor(fweights)._data
    aw = None if aweights is None else ensure_tensor(aweights)._data
    return apply(lambda a: torch.cov(a if rowvar else a.T,
                                     correction=1 if ddof else 0,
                                     fweights=fw, aweights=aw), x,
                 op_name="cov")


def householder_product(x, tau, name=None):
    return apply(torch.linalg.householder_product, ensure_tensor(x),
                 ensure_tensor(tau), op_name="householder_product")


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    x = ensure_tensor(x)
    m, n = x.shape[-2], x.shape[-1]
    k = q if q is not None else min(6, m, n)

    def prim(a):
        if center:
            a = a - a.mean(dim=-2, keepdim=True)
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        return u[..., :k], s[..., :k], vt.transpose(-1, -2)[..., :k]

    return apply(prim, x, op_name="pca_lowrank")


def matrix_exp(x, name=None):
    return apply(torch.linalg.matrix_exp, ensure_tensor(x),
                 op_name="matrix_exp")
