"""One sweep over the port's ops (`paddle_tpu_torch/ops/`, and the
nn.functional ops the sweep of `tests/test_ops_sweep.py` drives) against
the JAX package's, on the same numpy inputs, on the CPU.

Each case runs the op in both packages. Float outputs agree within 1e-6
of max(1, |value|) (float32), as do the gradients that ``paddle.grad``
takes of a fixed random projection of the first output with respect to
every float input (an input the output does not reach has no gradient
in the port and a zero one in the JAX package); integer, bool and search
outputs agree exactly. A case with a ``tol`` names its reason beside it.
``mode`` is held against numpy: the JAX package's misses the mode
(ROADMAP C18)."""
import numpy as np
import pytest

import paddle_tpu as jp

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's new tensors and Layers go to the CPU here (its default
    is the card)."""
    with tdevice.device_scope("cpu"):
        yield


R = np.random.RandomState(0)
A = R.randn(3, 4).astype(np.float32)
B = R.randn(3, 4).astype(np.float32)
POS = (np.abs(A) + 0.5).astype(np.float32)
UNIT = np.clip(A * 0.3, -0.9, 0.9).astype(np.float32)
M1 = R.randn(4, 5).astype(np.float32)
M2 = R.randn(5, 3).astype(np.float32)
SQ = (R.randn(4, 4) + 4 * np.eye(4)).astype(np.float32)
B3 = R.randn(2, 3, 4).astype(np.float32)
IDX = np.array([2, 0, 1], np.int64)
INTS = np.array([[3, -1, 4], [1, -5, 9]], np.int64)
V3 = R.randn(3, 3).astype(np.float32)
NANS = np.array([[1.0, np.nan], [2.0, 3.0]], np.float32)


def C(name, fn, *inputs, grad=True, tol=None):
    return pytest.param(fn, inputs, grad, tol, id=name)


def F(m):
    return m.nn.functional


CASES = [
    # unary elementwise
    *[C(n, (lambda n: lambda m, x: getattr(m, n)(x))(n), x) for n, x in [
        ("exp", A), ("log", POS), ("log2", POS), ("log10", POS),
        ("log1p", POS), ("sqrt", POS), ("rsqrt", POS), ("square", A),
        ("abs", POS), ("neg", A), ("reciprocal", POS), ("sin", A),
        ("cos", A), ("tan", UNIT), ("asin", UNIT), ("acos", UNIT),
        ("atan", A), ("sinh", A), ("cosh", A), ("tanh", A), ("asinh", A),
        ("acosh", POS + 1.0), ("atanh", UNIT), ("erf", A), ("sigmoid", A),
        ("expm1", A), ("logit", UNIT * 0.4 + 0.5), ("deg2rad", A * 90),
        ("rad2deg", A), ("lgamma", POS), ("digamma", POS), ("erfinv", UNIT),
        ("frac", A * 3), ("stanh", A), ("i0", A), ("i0e", A), ("i1", A),
        ("i1e", A)]],
    *[C(n, (lambda n: lambda m, x: getattr(m, n)(x))(n), A + 0.3, grad=False)
      for n in ("floor", "ceil", "round", "trunc", "sign", "isnan",
                "isinf", "isfinite")],
    C("nan_to_num", lambda m, x: m.nan_to_num(x),
      np.array([[1.0, np.nan], [np.inf, -np.inf]], np.float32), grad=False),
    C("logical_not", lambda m, x: m.logical_not(x > 0), A, grad=False),
    C("bitwise_not", lambda m, x: m.bitwise_not(x), INTS, grad=False),
    # binary elementwise
    *[C(n, (lambda n: lambda m, x, y: getattr(m, n)(x, y))(n), x, y)
      for n, x, y in [
          ("add", A, B), ("subtract", A, B), ("multiply", A, B),
          ("divide", A, POS), ("pow", POS, B), ("maximum", A, B),
          ("minimum", A, B), ("fmax", A, B), ("fmin", A, B),
          ("atan2", POS, A), ("hypot", POS, B), ("logaddexp", A, B),
          ("multiply_no_nan", A, B), ("add_bcast", A, B[0:1])]
      if n != "add_bcast"],
    C("add_broadcast", lambda m, x, y: m.add(x, y), A, B[0:1]),
    C("copysign", lambda m, x, y: m.copysign(x, y), A, B),
    *[C(n, (lambda n: lambda m, x, y: getattr(m, n)(x, y))(n), x, y,
        grad=False) for n, x, y in [
        ("mod", POS * 7, POS + 1), ("fmod", A * 7, POS + 1),
        ("floor_divide", POS * 7, POS + 1), ("heaviside", A, B),
        ("nextafter", A, B), ("equal", IDX, IDX), ("not_equal", A, B),
        ("less_than", A, B), ("less_equal", A, B), ("greater_than", A, B),
        ("greater_equal", A, B), ("gcd", INTS, INTS + 2),
        ("lcm", INTS, INTS + 2), ("bitwise_and", INTS, INTS + 1),
        ("bitwise_or", INTS, INTS + 1), ("bitwise_xor", INTS, INTS + 1),
        ("remainder", INTS, np.full_like(INTS, 3)),
        ("floor_divide_int", INTS, np.full_like(INTS, 2))]
      if n != "floor_divide_int"],
    C("floor_divide_int", lambda m, x, y: m.floor_divide(x, y), INTS,
      np.full_like(INTS, 2), grad=False),
    C("logical_ops", lambda m, x, y: m.logical_xor(
        m.logical_and(x > 0, y > 0), m.logical_or(x > 1, y < -1)), A, B,
      grad=False),
    C("isclose", lambda m, x, y: m.isclose(x, y), A, B, grad=False),
    C("allclose", lambda m, x, y: m.allclose(x, x + 1e-9), A, B, grad=False),
    C("equal_all", lambda m, x, y: m.equal_all(x, y), A, A, grad=False),
    C("scale", lambda m, x: m.scale(x, 2.5, 0.5), A),
    C("scale_before", lambda m, x: m.scale(x, 2.5, 0.5,
                                           bias_after_scale=False), A),
    C("clip", lambda m, x: m.clip(x, -0.5, 0.5), A),
    C("lerp", lambda m, x, y: m.lerp(x, y, 0.3), A, B),
    C("lerp_tensor", lambda m, x, y, w: m.lerp(x, y, w), A, B, POS * 0.2),
    C("add_n", lambda m, x, y: m.add_n([x, y, x]), A, B),
    C("addmm", lambda m, i, x, y: m.addmm(i, x, y, 0.5, 2.0),
      R.randn(4, 3).astype(np.float32), M1, M2),
    C("inner", lambda m, x, y: m.inner(x, y), A, B),
    C("outer", lambda m, x, y: m.outer(x, y), A[0], B[0]),
    C("kron", lambda m, x, y: m.kron(x, y), A[:2, :2], B[:2, :2]),
    C("cross", lambda m, x, y: m.cross(x, y, axis=1), V3, V3[::-1].copy()),
    C("dot", lambda m, x, y: m.dot(x, y), A[0], B[0]),
    C("clip_by_norm", lambda m, x: m.clip_by_norm(x, 1.0), A),
    C("frobenius_norm", lambda m, x: m.frobenius_norm(x, axis=[0, 1]), A),
    # reductions
    *[C(f"{n}_{ax}", (lambda n, ax: lambda m, x: getattr(m, n)(
        x, axis=ax))(n, ax), POS if n == "prod" else A)
      for n in ("sum", "mean", "prod", "max", "min", "amax", "amin",
                "logsumexp") for ax in (None, 1, [0, 1])],
    C("sum_keepdim", lambda m, x: m.sum(x, axis=0, keepdim=True), A),
    C("sum_bool", lambda m, x: m.sum(x > 0), A, grad=False),
    C("std", lambda m, x: m.std(x), A),
    C("var_axis", lambda m, x: m.var(x, axis=1, unbiased=False), A),
    C("all", lambda m, x: m.all(x > -1, axis=1), A, grad=False),
    C("any", lambda m, x: m.any(x > 1), A, grad=False),
    C("count_nonzero", lambda m, x: m.count_nonzero(m.sign(x), axis=1), A,
      grad=False),
    C("nansum", lambda m, x: m.nansum(x), NANS, grad=False),
    C("nanmean", lambda m, x: m.nanmean(x, axis=0), NANS, grad=False),
    C("median", lambda m, x: m.median(x), A[:, :3], grad=False),
    C("median_axis", lambda m, x: m.median(x, axis=1), A, grad=False),
    C("median_min", lambda m, x: m.median(x, axis=1, mode="min"), A,
      grad=False),
    C("nanmedian", lambda m, x: m.nanmedian(x), NANS, grad=False),
    C("quantile", lambda m, x: m.quantile(x, 0.3, axis=1), A),
    C("cumsum", lambda m, x: m.cumsum(x, axis=1), A),
    C("cumsum_flat", lambda m, x: m.cumsum(x), A),
    C("cumprod", lambda m, x: m.cumprod(x, dim=1), POS),
    C("cummax", lambda m, x: m.cummax(x, axis=1)[1], A, grad=False),
    C("cummin_vals", lambda m, x: m.cummin(x, axis=0)[0], A),
    C("logcumsumexp", lambda m, x: m.logcumsumexp(x, axis=1), A),
    C("diff", lambda m, x: m.diff(x, axis=1), A),
    C("trapezoid", lambda m, x: m.trapezoid(x, dx=0.5), A),
    C("cumulative_trapezoid", lambda m, x: m.cumulative_trapezoid(x), A),
    # linalg
    C("matmul", lambda m, x, y: m.matmul(x, y), M1, M2),
    C("matmul_t", lambda m, x, y: m.matmul(x, y, transpose_y=True), M1, M1),
    C("bmm", lambda m, x, y: m.bmm(x, y), B3, R.randn(2, 4, 5).astype(
        np.float32)),
    C("mv", lambda m, x, v: m.mv(x, v), M1, M2[:, 0].copy()),
    C("t", lambda m, x: m.t(x), M1),
    C("trace", lambda m, x: m.trace(x), SQ),
    C("einsum", lambda m, x, y: m.einsum("ij,jk->ik", x, y), M1, M2),
    C("norm_fro", lambda m, x: m.norm(x), A),
    C("norm_1", lambda m, x: m.norm(x, p=1, axis=1), A),
    C("norm_inf", lambda m, x: m.norm(x, p=float("inf"), axis=0), A),
    C("dist", lambda m, x, y: m.dist(x, y, p=3), A, B),
    C("cdist", lambda m, x, y: m.cdist(x, y), A, B),
    C("inverse", lambda m, x: m.inverse(x), SQ, tol=1e-5),   # LU solves
    C("det", lambda m, x: m.det(x), SQ, tol=1e-4),          # |det| ~ 300
    C("solve", lambda m, x, y: m.solve(x, y), SQ, M1[:4, :2].copy(),
      tol=1e-5),
    C("cholesky", lambda m, x: m.cholesky(m.matmul(x, x, transpose_y=True)),
      SQ, tol=1e-5),
    C("matrix_power", lambda m, x: m.matrix_power(x, 3), SQ * 0.3,
      tol=1e-5),
    C("multi_dot", lambda m, x, y: m.multi_dot([x, y, y.T]), M1, M2),
    C("triangular_solve", lambda m, x, y: m.triangular_solve(
        m.triu(x), y, upper=True), SQ, M1[:4, :2].copy(), tol=1e-5),
    C("svdvals", lambda m, x: m.svdvals(x), SQ, grad=False, tol=1e-5),
    C("eigvalsh", lambda m, x: m.eigvalsh(x + x.T), SQ, grad=False,
      tol=1e-5),
    C("slogdet", lambda m, x: m.slogdet(x)[1], SQ, tol=1e-5),
    C("matrix_exp", lambda m, x: m.matrix_exp(x * 0.1), SQ, tol=1e-5),
    C("corrcoef", lambda m, x: m.corrcoef(x), A, tol=1e-5),
    C("cov", lambda m, x: m.cov(x), A),
    # manipulation
    C("reshape", lambda m, x: m.reshape(x, [4, 3]), A),
    C("reshape_neg", lambda m, x: x.reshape([-1, 2]), A),
    C("transpose", lambda m, x: m.transpose(x, [1, 0]), A),
    C("squeeze", lambda m, x: m.squeeze(x, axis=0), A[None]),
    C("unsqueeze", lambda m, x: m.unsqueeze(x, [0, 2]), A),
    C("flatten", lambda m, x: m.flatten(x), B3),
    C("flatten_range", lambda m, x: m.flatten(x, 1, 2), B3),
    C("concat", lambda m, x, y: m.concat([x, y], axis=1), A, B),
    C("stack", lambda m, x, y: m.stack([x, y], axis=1), A, B),
    C("split", lambda m, x: m.split(x, [1, -1], axis=1)[1], A),
    C("chunk", lambda m, x: m.chunk(x, 2, axis=1)[1], A),
    C("tensor_split", lambda m, x: m.tensor_split(x, 3, axis=1)[2], A),
    C("tile", lambda m, x: m.tile(x, [2, 1]), A),
    C("roll", lambda m, x: m.roll(x, 1, axis=0), A),
    C("roll_flat", lambda m, x: m.roll(x, 2), A),
    C("flip", lambda m, x: m.flip(x, [0, 1]), A),
    C("rot90", lambda m, x: m.rot90(x), SQ),
    C("moveaxis", lambda m, x: m.moveaxis(x, 0, 2), B3),
    C("swapaxes", lambda m, x: m.swapaxes(x, 0, 2), B3),
    C("repeat_interleave", lambda m, x: m.repeat_interleave(x, 2, axis=1),
      A),
    C("expand", lambda m, x: m.expand(x, [2, 3, 4]), A[0:1]),
    C("broadcast_to", lambda m, x: m.broadcast_to(x, [3, 4]), A[0:1]),
    C("expand_as", lambda m, x, y: m.expand_as(x, y), A[0:1], B),
    C("unbind", lambda m, x: m.unbind(x, axis=1)[2], A),
    C("unstack", lambda m, x: m.unstack(x, axis=0)[1], A),
    C("gather", lambda m, x, i: m.gather(x, i), A, IDX),
    C("gather_nd", lambda m, x, i: m.gather_nd(x, i), A,
      np.array([[0, 1], [2, 3]], np.int64)),
    C("index_select", lambda m, x, i: m.index_select(x, i, axis=1), A,
      np.array([3, 0], np.int64)),
    C("index_sample", lambda m, x, i: m.index_sample(x, i), A,
      np.array([[0, 1], [2, 3], [1, 1]], np.int64)),
    C("take_along_axis", lambda m, x, i: m.take_along_axis(x, i, 0), A,
      np.array([[0, 1, 2, 0]], np.int64)),
    C("put_along_axis", lambda m, x, i, v: m.put_along_axis(
        x, i, v, 1), A, np.array([[0], [2], [3]], np.int64),
      np.array([[9.0], [8.0], [7.0]], np.float32)),
    C("put_along_axis_add", lambda m, x, i, v: m.put_along_axis(
        x, i, v, 1, reduce="add"), A, np.array([[0], [2], [3]], np.int64),
      np.array([[9.0], [8.0], [7.0]], np.float32)),
    C("scatter", lambda m, x, i, u: m.scatter(x, i, u), A,
      np.array([2, 0], np.int64), B[:2]),
    C("scatter_add", lambda m, x, i, u: m.scatter(x, i, u, overwrite=False),
      A, np.array([2, 2], np.int64), B[:2]),
    C("scatter_nd_add", lambda m, x, i, u: m.scatter_nd_add(x, i, u), A,
      np.array([[1, 1], [0, 2]], np.int64), np.array([5.0, 6.0],
                                                      np.float32)),
    C("index_add", lambda m, x, i, v: m.index_add(x, i, 0, v), A,
      np.array([0, 2], np.int64), B[:2]),
    C("index_put", lambda m, x, i, v: m.index_put(x, [i], v), A,
      np.array([1], np.int64), B[:1]),
    C("index_fill", lambda m, x, i: m.index_fill(x, i, 1, -2.0), A,
      np.array([0, 3], np.int64)),
    C("masked_fill", lambda m, x: m.masked_fill(x, x > 0, 0.5), A),
    C("masked_select", lambda m, x: m.masked_select(x, x > 0), A),
    C("masked_scatter", lambda m, x, v: m.masked_scatter(x, x > 0, v), A,
      B),
    C("take", lambda m, x, i: m.take(x, i), A,
      np.array([[0, 5], [11, 3]], np.int64)),
    C("where", lambda m, x, y: m.where(x > 0, x, y), A, B),
    C("slice", lambda m, x: m.slice(x, [0, 1], [1, 0], [3, 3]), A),
    C("strided_slice", lambda m, x: m.strided_slice(x, [1], [0], [4], [2]),
      A),
    C("crop", lambda m, x: m.crop(x, [2, 2], [1, 1]), A),
    C("diag", lambda m, x: m.diag(x), A[0]),
    C("diag_offset_pad", lambda m, x: m.diag(x, 1, padding_value=2.0), A[0]),
    C("diagflat", lambda m, x: m.diagflat(x), A[0]),
    C("diag_embed", lambda m, x: m.diag_embed(x), A),
    C("diagonal", lambda m, x: m.diagonal(x, 1), SQ),
    C("tril", lambda m, x: m.tril(x, -1), SQ),
    C("triu", lambda m, x: m.triu(x, 1), SQ),
    C("renorm", lambda m, x: m.renorm(x, 2.0, 0, 1.0), A),
    C("atleast_3d", lambda m, x: m.atleast_3d(x), A),
    C("one_hot", lambda m, x: m.nn.functional.one_hot(x, 4),
      np.array([0, 2, 3], np.int64), grad=False),
    C("shard_index", lambda m, x: m.shard_index(x, 10, 2, 1), INTS,
      grad=False),
    # search
    C("argmax", lambda m, x: m.argmax(x, axis=1), A, grad=False),
    C("argmax_flat", lambda m, x: m.argmax(x), A, grad=False),
    C("argmin_keep", lambda m, x: m.argmin(x, axis=0, keepdim=True), A,
      grad=False),
    C("argsort", lambda m, x: m.argsort(x, axis=1), A, grad=False),
    C("argsort_desc", lambda m, x: m.argsort(x, descending=True), A,
      grad=False),
    C("sort", lambda m, x: m.sort(x, axis=1), A),
    C("topk_vals", lambda m, x: m.topk(x, 2, axis=1)[0], A),
    C("topk_idx", lambda m, x: m.topk(x, 2, axis=0, largest=False)[1], A,
      grad=False),
    C("kthvalue", lambda m, x: m.kthvalue(x, 2, axis=1)[0], A),
    C("nonzero", lambda m, x: m.nonzero(x > 0), A, grad=False),
    C("searchsorted", lambda m, s, v: m.searchsorted(s, v),
      np.sort(A[0]), B[0], grad=False),
    C("bucketize", lambda m, x, s: m.bucketize(x, s, right=True), B[0],
      np.sort(A[0]), grad=False),
    C("unique", lambda m, x: m.unique(x), INTS, grad=False),
    C("bincount", lambda m, x: m.bincount(x), np.array([0, 1, 1, 3],
                                                       np.int64),
      grad=False),
    # creation
    C("arange", lambda m, x: m.arange(1, 10, 2), A, grad=False),
    C("arange_float", lambda m, x: m.arange(0.0, 1.0, 0.25), A, grad=False),
    C("linspace", lambda m, x: m.linspace(0, 1, 5), A, grad=False),
    C("eye", lambda m, x: m.eye(3, 4), A, grad=False),
    C("full", lambda m, x: m.full([2, 3], 1.5), A, grad=False),
    C("full_like", lambda m, x: m.full_like(x, 7, dtype="int32"), A,
      grad=False),
    C("tril_indices", lambda m, x: m.tril_indices(4, 3, -1), A, grad=False),
    C("triu_indices", lambda m, x: m.triu_indices(3, 4, 1), A, grad=False),
    C("meshgrid", lambda m, x, y: m.meshgrid(x, y)[1], A[0], B[1]),
    C("assign", lambda m, x: m.assign(x), A),
    C("cast", lambda m, x: m.cast(x, "int32"), A * 3, grad=False),
    C("numel", lambda m, x: m.numel(x), A, grad=False),
    # nn.functional
    *[C(n, (lambda n: lambda m, x: getattr(F(m), n)(x))(n), x) for n, x in [
        ("relu", POS), ("relu6", A * 4), ("gelu", A), ("silu", A),
        ("mish", A), ("softplus", A), ("softsign", A), ("hardswish", A),
        ("hardsigmoid", A), ("tanhshrink", A), ("elu", A), ("celu", A),
        ("selu", A), ("leaky_relu", A), ("log_sigmoid", A),
        ("hardshrink", A), ("softshrink", A), ("hardtanh", A * 0.3),
        ("thresholded_relu", A * 2)]],
    C("gelu_tanh", lambda m, x: F(m).gelu(x, approximate=True), A),
    C("softmax", lambda m, x: F(m).softmax(x, axis=1), A),
    C("log_softmax", lambda m, x: F(m).log_softmax(x, axis=0), A),
    C("glu", lambda m, x: F(m).glu(x, axis=1), A),
    C("maxout", lambda m, x: F(m).maxout(x, 2, axis=1), A),
    C("prelu", lambda m, x, w: F(m).prelu(x, w), B3, np.array(
        [0.1, 0.2, 0.3], np.float32)),
    C("linear", lambda m, x, w, b: F(m).linear(x, w, b), A,
      R.randn(4, 6).astype(np.float32), R.randn(6).astype(np.float32)),
    C("layer_norm", lambda m, x: F(m).layer_norm(x, 4), A),
    C("embedding", lambda m, i, w: F(m).embedding(i, w, padding_idx=1),
      np.array([[0, 1], [2, 0]], np.int64), A),
    C("pad_full", lambda m, x: F(m).pad(x, [1, 1, 0, 2]), A),
    C("pad_reflect", lambda m, x: F(m).pad(x, [1, 2], mode="reflect"), B3),
    C("pad_replicate_nhwc", lambda m, x: F(m).pad(
        x[None], [1, 0, 0, 1], mode="replicate", data_format="NHWC"), B3),
    C("cosine_similarity", lambda m, x, y: F(m).cosine_similarity(x, y), A,
      B),
    C("normalize", lambda m, x: F(m).normalize(x, axis=1), A),
    C("label_smooth", lambda m, x: F(m).label_smooth(x), POS),
    C("pixel_shuffle", lambda m, x: F(m).pixel_shuffle(x, 2),
      R.randn(1, 8, 2, 3).astype(np.float32)),
    C("channel_shuffle", lambda m, x: F(m).channel_shuffle(x, 2),
      R.randn(1, 4, 2, 3).astype(np.float32)),
    C("sdpa_causal", lambda m, q, k: F(m).scaled_dot_product_attention(
        q, k, k, attn_mask=m.zeros([1, 1, 3, 5]), is_causal=True),
      R.randn(2, 3, 2, 4).astype(np.float32),
      R.randn(2, 5, 2, 4).astype(np.float32)),
    # losses
    C("cross_entropy", lambda m, x, y: F(m).cross_entropy(x, y), A,
      np.array([1, 0, 3], np.int64)),
    C("cross_entropy_ignore_smooth", lambda m, x, y: F(m).cross_entropy(
        x, y, ignore_index=0, label_smoothing=0.1), A,
      np.array([1, 0, 3], np.int64)),
    C("cross_entropy_soft", lambda m, x, y: F(m).cross_entropy(
        x, F(m).softmax(y), soft_label=True, reduction="sum"), A, B),
    C("cross_entropy_weight", lambda m, x, y, w: F(m).cross_entropy(
        x, y, weight=w), A, np.array([1, 0, 3], np.int64), POS[0]),
    C("nll_loss", lambda m, x, y: F(m).nll_loss(F(m).log_softmax(x), y), A,
      np.array([1, 0, 3], np.int64)),
    C("mse_loss", lambda m, x, y: F(m).mse_loss(x, y), A, B),
    C("l1_loss", lambda m, x, y: F(m).l1_loss(x, y, reduction="sum"), A, B),
    C("smooth_l1_loss", lambda m, x, y: F(m).smooth_l1_loss(x, y), A, B),
    C("bce", lambda m, x, y: F(m).binary_cross_entropy(
        F(m).sigmoid(x), (y > 0).astype("float32")), A, B),
    C("bce_logits", lambda m, x, y: F(m).binary_cross_entropy_with_logits(
        x, (y > 0).astype("float32")), A, B),
    C("kl_div", lambda m, x, y: F(m).kl_div(F(m).log_softmax(x),
                                            F(m).softmax(y)), A, B),
    C("margin_ranking", lambda m, x, y: F(m).margin_ranking_loss(
        x, y, m.sign(x - y), 0.1), A, B),
    C("hinge_embedding", lambda m, x, y: F(m).hinge_embedding_loss(
        x, m.sign(y)), A, B),
    C("cosine_embedding", lambda m, x, y: F(m).cosine_embedding_loss(
        x, y, m.to_tensor(np.array([1, -1, 1], np.int64))), A, B),
    C("triplet_margin", lambda m, x, y: F(m).triplet_margin_loss(
        x, y, x * 0.5), A, B),
    C("sigmoid_focal", lambda m, x, y: F(m).sigmoid_focal_loss(
        x, (y > 0).astype("float32")), A, B),
    C("soft_margin", lambda m, x, y: F(m).soft_margin_loss(x, m.sign(y)),
      A, B),
    C("multi_label_soft_margin", lambda m, x, y:
      F(m).multi_label_soft_margin_loss(x, (y > 0).astype("float32")), A, B),
    C("log_loss", lambda m, x, y: F(m).log_loss(F(m).sigmoid(x),
                                                (y > 0).astype("float32")),
      A, B),
    C("ctc_loss", lambda m, lp, lab: F(m).ctc_loss(
        lp, lab, m.to_tensor(np.array([6, 5], np.int64)),
        m.to_tensor(np.array([2, 3], np.int64))),
      R.randn(6, 2, 5).astype(np.float32),
      np.array([[1, 2, 0], [3, 3, 1]], np.int64), tol=1e-5),
    C("margin_cross_entropy", lambda m, x, y: F(m).margin_cross_entropy(
        x, y), UNIT, np.array([1, 0, 3], np.int64), tol=1e-5),  # scale 64
]


def _run(m, fn, inputs, grad):
    ts = [m.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
          for a in inputs]
    out = fn(m, *ts)
    first = out[0] if isinstance(out, (list, tuple)) else out
    g = []
    if grad:
        w = m.to_tensor(np.asarray(np.random.RandomState(1).randn(
            *first.shape), np.float32))
        diff = [t for t in ts if not t.stop_gradient]
        g = m.grad([(first * w.astype(first.dtype)).sum()], diff,
                   allow_unused=True)
    return first, g


def _check(t, j, tol, what):
    t, j = np.asarray(t.numpy()), np.asarray(j.numpy())
    assert t.shape == j.shape, (what, t.shape, j.shape)
    if t.dtype.kind in "fc":
        assert t.dtype == j.dtype or j.dtype == np.float64, (what, t.dtype,
                                                             j.dtype)
        scale = max(1.0, float(np.nanmax(np.abs(j))) if j.size else 1.0)
        bad = ~np.isclose(t, j, rtol=0, atol=tol * scale, equal_nan=True)
        assert not bad.any(), (what, float(np.nanmax(np.abs(t - j))))
    else:
        np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=what)


@pytest.mark.parametrize("fn,inputs,grad,tol", CASES)
def test_op_matches_jax(fn, inputs, grad, tol):
    tol = tol or 1e-6
    tout, tg = _run(tp, fn, inputs, grad)
    jout, jg = _run(jp, fn, inputs, grad)
    _check(tout, jout, tol, "forward")
    assert len(tg) == len(jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        if a is None:
            assert b is None or not np.asarray(b.numpy()).any(), i
        else:
            _check(a, b, tol, f"grad {i}")


@pytest.mark.parametrize("keepdim", [False, True])
def test_mode_is_the_smallest_most_frequent_value(keepdim):
    a = np.array([[1, 2, 2, 3], [4, 4, 1, 1], [5, 6, 7, 5], [3, 3, 3, 1],
                  [1, 2, 2, 2], [7, 7, 9, 9]], np.float32)
    v, i = tp.mode(tp.to_tensor(a), axis=1, keepdim=keepdim)
    want_v = np.array([2, 1, 5, 3, 2, 7], np.float32)
    want_i = np.array([2, 3, 3, 2, 3, 1])
    if keepdim:
        want_v, want_i = want_v[:, None], want_i[:, None]
    np.testing.assert_array_equal(v.numpy(), want_v)
    np.testing.assert_array_equal(i.numpy(), want_i)
