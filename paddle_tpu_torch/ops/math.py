"""Math ops (counterpart of `paddle_tpu/ops/math.py`): each op is the torch
function with the jnp function's semantics, through `core.autograd.apply`."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.autograd import apply
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.common import (binary, ensure_tensor, inplace_guard,
                                         make_inplace, rebind, unary)

__all__ = [
    "abs", "acos", "asin", "atan", "acosh", "asinh", "atanh", "ceil", "cos",
    "cosh", "exp", "expm1", "floor", "log", "log2", "log10", "log1p", "neg",
    "negative", "reciprocal", "round", "rsqrt", "sigmoid", "sign", "sgn",
    "sin", "sinh", "sqrt", "square", "tan", "tanh", "trunc", "erf", "erfinv",
    "digamma", "lgamma", "gammaln", "i0", "i0e", "i1", "i1e", "angle",
    "conj", "real", "imag", "isnan", "isinf", "isfinite", "logical_not",
    "bitwise_not", "logit", "frac", "deg2rad", "rad2deg",
    "exp_", "sqrt_", "rsqrt_", "reciprocal_", "ceil_", "floor_", "round_",
    "abs_", "sigmoid_", "tanh_", "square_", "neg_",
    "add", "subtract", "multiply", "mul", "divide", "div", "floor_divide",
    "remainder", "mod", "floor_mod", "fmod", "pow", "maximum", "minimum",
    "fmax", "fmin", "atan2", "logaddexp", "heaviside", "nextafter", "gcd",
    "lcm", "hypot", "copysign", "ldexp", "logical_and", "logical_or",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor", "equal",
    "not_equal", "less_than", "less_equal", "greater_than", "greater_equal",
    "add_", "subtract_", "multiply_", "divide_", "remainder_",
    "floor_divide_", "pow_",
    "scale", "scale_", "clip", "clip_", "lerp", "lerp_", "stanh",
    "nan_to_num", "multiply_no_nan",
    "sum", "mean", "prod", "amax", "amin", "nansum", "nanmean", "max", "min",
    "all", "any", "logsumexp", "count_nonzero", "std", "var", "median",
    "nanmedian", "quantile", "nanquantile",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp", "diff",
    "trapezoid", "cumulative_trapezoid",
    "increment", "isclose", "allclose", "equal_all", "add_n", "addmm",
    "inner", "outer", "kron", "cross", "dot", "broadcast_shape", "rsub",
    "clip_by_norm", "frobenius_norm",
]

# ------------------------------------------------------------ unary


def _imag(a):
    return torch.imag(a) if a.is_complex() else torch.zeros_like(a)


def _real(a):
    return torch.real(a) if a.is_complex() else a


def _int_to_float(fn):
    """A float-only torch function taking an int tensor as the default
    float dtype (jnp promotes ints for transcendental functions)."""
    def f(a):
        if not (a.is_floating_point() or a.is_complex()):
            a = a.to(dtype_mod.get_default_dtype())
        return fn(a)
    return f


abs = unary(torch.abs, "abs")
acos = unary(_int_to_float(torch.acos), "acos")
asin = unary(_int_to_float(torch.asin), "asin")
atan = unary(_int_to_float(torch.atan), "atan")
acosh = unary(_int_to_float(torch.acosh), "acosh")
asinh = unary(_int_to_float(torch.asinh), "asinh")
atanh = unary(_int_to_float(torch.atanh), "atanh")
ceil = unary(lambda a: torch.ceil(a) if a.is_floating_point() else a, "ceil")
cos = unary(_int_to_float(torch.cos), "cos")
cosh = unary(_int_to_float(torch.cosh), "cosh")
exp = unary(_int_to_float(torch.exp), "exp")
expm1 = unary(_int_to_float(torch.expm1), "expm1")
floor = unary(lambda a: torch.floor(a) if a.is_floating_point() else a,
              "floor")
log = unary(_int_to_float(torch.log), "log")
log2 = unary(_int_to_float(torch.log2), "log2")
log10 = unary(_int_to_float(torch.log10), "log10")
log1p = unary(_int_to_float(torch.log1p), "log1p")
neg = unary(torch.neg, "neg")
negative = neg
reciprocal = unary(_int_to_float(torch.reciprocal), "reciprocal")
round = unary(torch.round, "round")
rsqrt = unary(_int_to_float(torch.rsqrt), "rsqrt")
sigmoid = unary(_int_to_float(torch.sigmoid), "sigmoid")
sign = unary(torch.sign, "sign")
sgn = sign
sin = unary(_int_to_float(torch.sin), "sin")
sinh = unary(_int_to_float(torch.sinh), "sinh")
sqrt = unary(_int_to_float(torch.sqrt), "sqrt")
square = unary(torch.square, "square")
tan = unary(_int_to_float(torch.tan), "tan")
tanh = unary(_int_to_float(torch.tanh), "tanh")
trunc = unary(lambda a: torch.trunc(a) if a.is_floating_point() else a,
              "trunc")
erf = unary(_int_to_float(torch.special.erf), "erf")
erfinv = unary(_int_to_float(torch.special.erfinv), "erfinv")
digamma = unary(_int_to_float(torch.special.digamma), "digamma")
lgamma = unary(_int_to_float(torch.lgamma), "lgamma")
gammaln = lgamma
i0 = unary(_int_to_float(torch.special.i0), "i0")
i0e = unary(_int_to_float(torch.special.i0e), "i0e")
i1 = unary(_int_to_float(torch.special.i1), "i1")
i1e = unary(_int_to_float(torch.special.i1e), "i1e")
angle = unary(torch.angle, "angle")
conj = unary(torch.conj_physical, "conj")
real = unary(_real, "real")
imag = unary(_imag, "imag")
isnan = unary(torch.isnan, "isnan")
isinf = unary(torch.isinf, "isinf")
isfinite = unary(torch.isfinite, "isfinite")
logical_not = unary(torch.logical_not, "logical_not")
bitwise_not = unary(torch.bitwise_not, "bitwise_not")
logit = unary(_int_to_float(torch.logit), "logit")
frac = unary(lambda a: a - torch.trunc(a), "frac")
deg2rad = unary(_int_to_float(torch.deg2rad), "deg2rad")
rad2deg = unary(_int_to_float(torch.rad2deg), "rad2deg")

exp_ = make_inplace(exp)
sqrt_ = make_inplace(sqrt)
rsqrt_ = make_inplace(rsqrt)
reciprocal_ = make_inplace(reciprocal)
ceil_ = make_inplace(ceil)
floor_ = make_inplace(floor)
round_ = make_inplace(round)
abs_ = make_inplace(abs)
sigmoid_ = make_inplace(sigmoid)
tanh_ = make_inplace(tanh)
square_ = make_inplace(square)
neg_ = make_inplace(neg)

# ------------------------------------------------------------ binary


def _true_divide(a, b):
    if not (a.is_floating_point() or a.is_complex() or b.is_floating_point()
            or b.is_complex()):
        a = a.to(dtype_mod.get_default_dtype())
    return torch.true_divide(a, b)


def _ldexp(a, b):
    return a * torch.pow(torch.full((), 2.0, dtype=a.dtype, device=a.device),
                         b.to(a.dtype))


def _heaviside(a, b):
    return torch.heaviside(a, b.to(a.dtype))


add = binary(torch.add, "add")
subtract = binary(torch.sub, "subtract")
multiply = binary(torch.mul, "multiply")
mul = multiply
divide = binary(_true_divide, "divide")
div = divide
floor_divide = binary(torch.floor_divide, "floor_divide")
remainder = binary(torch.remainder, "remainder")
mod = remainder
floor_mod = remainder
fmod = binary(torch.fmod, "fmod")
pow = binary(torch.pow, "pow")
maximum = binary(torch.maximum, "maximum")
minimum = binary(torch.minimum, "minimum")
fmax = binary(torch.fmax, "fmax")
fmin = binary(torch.fmin, "fmin")
atan2 = binary(torch.atan2, "atan2")
logaddexp = binary(torch.logaddexp, "logaddexp")
heaviside = binary(_heaviside, "heaviside")
nextafter = binary(torch.nextafter, "nextafter")
gcd = binary(torch.gcd, "gcd")
lcm = binary(torch.lcm, "lcm")
hypot = binary(torch.hypot, "hypot")
copysign = binary(torch.copysign, "copysign")
ldexp = binary(_ldexp, "ldexp")
logical_and = binary(torch.logical_and, "logical_and", promote=False)
logical_or = binary(torch.logical_or, "logical_or", promote=False)
logical_xor = binary(torch.logical_xor, "logical_xor", promote=False)
bitwise_and = binary(torch.bitwise_and, "bitwise_and", promote=False)
bitwise_or = binary(torch.bitwise_or, "bitwise_or", promote=False)
bitwise_xor = binary(torch.bitwise_xor, "bitwise_xor", promote=False)
equal = binary(torch.eq, "equal", promote=False)
not_equal = binary(torch.ne, "not_equal", promote=False)
less_than = binary(torch.lt, "less_than", promote=False)
less_equal = binary(torch.le, "less_equal", promote=False)
greater_than = binary(torch.gt, "greater_than", promote=False)
greater_equal = binary(torch.ge, "greater_equal", promote=False)

add_ = make_inplace(add)
subtract_ = make_inplace(subtract)
multiply_ = make_inplace(multiply)
divide_ = make_inplace(divide)
remainder_ = make_inplace(remainder)
floor_divide_ = make_inplace(floor_divide)
pow_ = make_inplace(pow)

# ------------------------------------------------------------ scalar attrs


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``scale * x + bias`` (or ``(x + bias) * scale``)."""
    x = ensure_tensor(x)
    if isinstance(scale, Tensor):
        if bias_after_scale:
            return apply(lambda a, sc: a * sc + bias, x, scale, op_name="scale")
        return apply(lambda a, sc: (a + bias) * sc, x, scale, op_name="scale")
    s = float(scale)
    if bias_after_scale:
        return apply(lambda a: a * s + bias, x, op_name="scale")
    return apply(lambda a: (a + bias) * s, x, op_name="scale")


scale_ = make_inplace(scale)


def clip(x, min=None, max=None, name=None):
    x = ensure_tensor(x)
    lo = min._data.item() if isinstance(min, Tensor) else min
    hi = max._data.item() if isinstance(max, Tensor) else max
    return apply(lambda a: torch.clamp(a, lo, hi), x, op_name="clip")


clip_ = make_inplace(clip)


def lerp(x, y, weight, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    if isinstance(weight, Tensor):
        return apply(lambda a, b, w: a + w * (b - a), x, y, weight,
                     op_name="lerp")
    return apply(lambda a, b: a + weight * (b - a), x, y, op_name="lerp")


lerp_ = make_inplace(lerp)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    x = ensure_tensor(x)
    return apply(lambda a: scale_b * torch.tanh(scale_a * a), x,
                 op_name="stanh")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    x = ensure_tensor(x)
    return apply(lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf,
                                            neginf=neginf), x,
                 op_name="nan_to_num")


def multiply_no_nan(x, y):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply(lambda a, b: torch.where(b == 0, torch.zeros_like(a), a * b),
                 x, y, op_name="multiply_no_nan")


# ------------------------------------------------------------ reductions


def _axis_arg(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a, ax):
    """``ax`` as a tuple of dims of ``a`` (None: every dim)."""
    if ax is None:
        return tuple(range(a.dim()))
    return (ax,) if isinstance(ax, int) else tuple(ax)


def _reduce_with(tfn, a, ax, keepdim):
    """``tfn(a, dim=tuple, keepdim=)`` over ``ax``; a 0-d tensor or an
    empty axis list reduces nothing, as jnp does."""
    dims = _dims(a, ax)
    if not dims:
        return tfn(a.reshape(1), dim=(0,), keepdim=False).reshape(()) \
            if a.dim() == 0 else a.clone()
    return tfn(a, dim=dims, keepdim=keepdim)


def _mean(a, dim, keepdim):
    if not (a.is_floating_point() or a.is_complex()):
        a = a.to(torch.float64)
    return torch.mean(a, dim=dim, keepdim=keepdim)


def _prod(a, dim, keepdim):
    out = a
    for d in sorted((d % a.dim() for d in dim), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _nansum(a, dim, keepdim):
    return torch.nansum(a, dim=dim, keepdim=keepdim)


def _nanmean(a, dim, keepdim):
    return torch.nanmean(a, dim=dim, keepdim=keepdim)


def _reduce(tfn, opname, bool_to_int64=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        x = ensure_tensor(x)
        ax = _axis_arg(axis)

        def prim(a):
            r = _reduce_with(tfn, a, ax, keepdim)
            if dtype is not None:
                r = r.to(dtype_mod.convert_dtype(dtype))
            elif bool_to_int64 and a.dtype == torch.bool:
                r = r.to(torch.int64)
            return r

        return apply(prim, x, op_name=opname)

    op.__name__ = opname
    return op


sum = _reduce(torch.sum, "sum", bool_to_int64=True)
mean = _reduce(_mean, "mean")
prod = _reduce(_prod, "prod")
amax = _reduce(torch.amax, "amax")
amin = _reduce(torch.amin, "amin")
nansum = _reduce(_nansum, "nansum")
nanmean = _reduce(_nanmean, "nanmean")


def max(x, axis=None, keepdim=False, name=None):
    """The maximum values (ties share the gradient, as jnp.max's)."""
    x = ensure_tensor(x)
    ax = _axis_arg(axis)
    return apply(lambda a: _reduce_with(torch.amax, a, ax, keepdim), x,
                 op_name="max")


def min(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = _axis_arg(axis)
    return apply(lambda a: _reduce_with(torch.amin, a, ax, keepdim), x,
                 op_name="min")


def _all(a, dim, keepdim):
    return a.bool().all(dim=dim, keepdim=keepdim)


def _any(a, dim, keepdim):
    return a.bool().any(dim=dim, keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = _axis_arg(axis)
    return apply(lambda a: _reduce_with(_all, a, ax, keepdim), x,
                 op_name="all")


def any(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = _axis_arg(axis)
    return apply(lambda a: _reduce_with(_any, a, ax, keepdim), x,
                 op_name="any")


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = _axis_arg(axis)
    return apply(lambda a: _reduce_with(torch.logsumexp, a, ax, keepdim), x,
                 op_name="logsumexp")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = _axis_arg(axis)
    return apply(lambda a: _reduce_with(torch.sum, (a != 0).to(torch.int64),
                                        ax, keepdim), x,
                 op_name="count_nonzero")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = _axis_arg(axis)
    ddof = 1 if unbiased else 0
    return apply(lambda a: torch.std(a, dim=_dims(a, ax), correction=ddof,
                                     keepdim=keepdim), x, op_name="std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = _axis_arg(axis)
    ddof = 1 if unbiased else 0
    return apply(lambda a: torch.var(a, dim=_dims(a, ax), correction=ddof,
                                     keepdim=keepdim), x, op_name="var")


def _flat_or(a, ax):
    return (a.reshape(-1), 0) if ax is None else (a, ax)


def _keep(r, a, ax, keepdim):
    """Reshape a reduction over ``ax`` (None: all) to keep its dims."""
    if not keepdim:
        return r
    if ax is None:
        return r.reshape((1,) * a.dim())
    return r.unsqueeze(ax)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The median; ``mode="avg"`` averages the two middle values of an even
    count (jnp.median), ``"min"`` takes the lower one."""
    x = ensure_tensor(x)
    ax = None if axis is None else int(axis)

    def prim(a):
        flat, d = _flat_or(a, ax)
        n = flat.shape[d]
        srt = torch.sort(flat, dim=d).values
        lo = srt.select(d, (n - 1) // 2)
        if mode == "avg" and n % 2 == 0:
            r = (lo + srt.select(d, n // 2)) / 2
        else:
            r = lo
        return _keep(r, a, ax, keepdim)

    return apply(prim, x, op_name="median")


def nanmedian(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = _axis_arg(axis)

    def prim(a):
        flat, d = _flat_or(a, ax)
        return _keep(torch.nanquantile(flat, 0.5, dim=d), a, ax, keepdim)

    return apply(prim, x, op_name="nanmedian")


def _q(q, like):
    qv = q._data if isinstance(q, Tensor) else torch.as_tensor(q)
    return qv.to(like.device, like.dtype)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    x = ensure_tensor(x)
    ax = None if axis is None else int(axis)
    return apply(lambda a: torch.quantile(
        a, _q(q, a), dim=ax, keepdim=keepdim, interpolation=interpolation),
        x, op_name="quantile")


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = None if axis is None else int(axis)
    return apply(lambda a: torch.nanquantile(a, _q(q, a), dim=ax,
                                             keepdim=keepdim), x,
                 op_name="nanquantile")


# ------------------------------------------------------------ cumulative


def cumsum(x, axis=None, dtype=None, name=None):
    x = ensure_tensor(x)

    def prim(a):
        aa = a.reshape(-1) if axis is None else a
        d = dtype_mod.convert_dtype(dtype) if dtype else None
        return torch.cumsum(aa, dim=0 if axis is None else int(axis), dtype=d)

    return apply(prim, x, op_name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    x = ensure_tensor(x)

    def prim(a):
        d = dtype_mod.convert_dtype(dtype) if dtype else None
        return torch.cumprod(a, dim=int(dim), dtype=d)

    return apply(prim, x, op_name="cumprod")


def _cum_arg(cum, ax_of_a, dtype):
    """(running values, index of the last element equal to them)."""
    def prim(a):
        aa, d = (a.reshape(-1), 0) if ax_of_a is None else (a, ax_of_a)
        vals = cum(aa, dim=d).values
        shape = [1] * aa.dim()
        shape[d] = aa.shape[d]
        iota = torch.arange(aa.shape[d], device=a.device).reshape(shape)
        idx = torch.cummax(torch.where(aa == vals, iota, -1), dim=d).values
        return vals, idx.to(dtype_mod.convert_dtype(dtype))
    return prim


def cummax(x, axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    ax = None if axis is None else int(axis)
    return apply(_cum_arg(torch.cummax, ax, dtype), x, op_name="cummax")


def cummin(x, axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    ax = None if axis is None else int(axis)
    return apply(_cum_arg(torch.cummin, ax, dtype), x, op_name="cummin")


def logcumsumexp(x, axis=None, name=None):
    x = ensure_tensor(x)

    def prim(a):
        aa = a.reshape(-1) if axis is None else a
        return torch.logcumsumexp(aa, dim=0 if axis is None else int(axis))

    return apply(prim, x, op_name="logcumsumexp")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = ensure_tensor(x)
    extras = [ensure_tensor(t) for t in (prepend, append) if t is not None]
    has = (prepend is not None, append is not None)

    def prim(a, *ex):
        it = iter(ex)
        p = next(it) if has[0] else None
        ap = next(it) if has[1] else None
        return torch.diff(a, n=n, dim=axis, prepend=p, append=ap)

    return apply(prim, x, *extras, op_name="diff")


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = ensure_tensor(y)
    if x is not None:
        return apply(lambda a, b: torch.trapezoid(a, b, dim=axis), y,
                     ensure_tensor(x), op_name="trapezoid")
    d = 1.0 if dx is None else dx
    return apply(lambda a: torch.trapezoid(a, dx=d, dim=axis), y,
                 op_name="trapezoid")


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = ensure_tensor(y)

    def cumtrap(a, b=None, d=1.0):
        n = a.shape[axis]
        avg = (a.narrow(axis, 1, n - 1) + a.narrow(axis, 0, n - 1)) / 2.0
        step = d if b is None else \
            b.narrow(axis, 1, n - 1) - b.narrow(axis, 0, n - 1)
        return torch.cumsum(avg * step, dim=axis)

    if x is not None:
        return apply(lambda a, b: cumtrap(a, b), y, ensure_tensor(x),
                     op_name="cumulative_trapezoid")
    return apply(lambda a: cumtrap(a, d=(1.0 if dx is None else dx)), y,
                 op_name="cumulative_trapezoid")


# ------------------------------------------------------------ misc


def increment(x, value=1.0, name=None):
    inplace_guard(x)
    return rebind(x, apply(lambda a: a + value, x, op_name="increment"))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply(lambda a, b: torch.isclose(a, b.to(a.dtype), rtol=rtol,
                                            atol=atol, equal_nan=equal_nan),
                 x, y, op_name="isclose")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply(lambda a, b: torch.isclose(
        a, b.to(a.dtype), rtol=rtol, atol=atol, equal_nan=equal_nan).all(),
        x, y, op_name="allclose")


def equal_all(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply(lambda a, b: torch.tensor(
        a.shape == b.shape and bool(torch.equal(a, b.to(a.dtype))),
        device=a.device), x, y, op_name="equal_all")


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs
    ts = [ensure_tensor(t) for t in inputs]

    def prim(*arrs):
        out = arrs[0]
        for a in arrs[1:]:
            out = out + a
        return out

    return apply(prim, *ts, op_name="add_n")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    input, x, y = ensure_tensor(input), ensure_tensor(x), ensure_tensor(y)
    return apply(lambda i, a, b: beta * i + alpha * (a @ b), input, x, y,
                 op_name="addmm")


def _inner(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.inner(a, b)


def inner(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply(_inner, x, y, op_name="inner")


def outer(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)), x, y,
                 op_name="outer")


def kron(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply(torch.kron, x, y, op_name="kron")


def cross(x, y, axis=9, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    if axis == 9:      # paddle default: the first axis of size 3
        ax = next((i for i, s in enumerate(x.shape) if s == 3), None)
        if ax is None:
            raise ValueError(f"cross: no dimension of size 3 in shape "
                             f"{x.shape}; pass axis=")
    else:
        ax = axis
    return apply(lambda a, b: torch.linalg.cross(a, b, dim=ax), x, y,
                 op_name="cross")


def dot(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply(lambda a, b: torch.sum(a * b, dim=-1), x, y, op_name="dot")


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def rsub(x, y, alpha=1):
    return subtract(y, multiply(x, alpha) if alpha != 1 else x)


def clip_by_norm(x, max_norm, name=None):
    """Scale ``x`` so its Frobenius norm is at most ``max_norm``."""
    x = ensure_tensor(x)

    def prim(a):
        norm = torch.sqrt(torch.sum(a * a))
        s = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
        return a * s.to(a.dtype)

    return apply(prim, x, op_name="clip_by_norm")


def frobenius_norm(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return apply(lambda a: torch.sqrt(_reduce_with(torch.sum, a * a, ax,
                                                   keepdim)), x,
                 op_name="frobenius_norm")

