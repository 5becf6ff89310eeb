"""The op surface of the port (counterpart of `paddle_tpu/ops/__init__.py`):
every public op of the submodules, re-exported here and bound as a Tensor
method where Paddle has one (`TENSOR_METHODS`, the JAX package's
``tensor_method`` entries of its op inventory)."""
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops import (creation, linalg, manipulation, math,
                                  random, search)
from paddle_tpu_torch.ops.common import ensure_tensor  # noqa: F401
from paddle_tpu_torch.ops.creation import *  # noqa: F401,F403
from paddle_tpu_torch.ops.einsum import einsum  # noqa: F401
from paddle_tpu_torch.ops.indexing import getitem, setitem  # noqa: F401
from paddle_tpu_torch.ops.linalg import *  # noqa: F401,F403
from paddle_tpu_torch.ops.manipulation import *  # noqa: F401,F403
from paddle_tpu_torch.ops.math import *  # noqa: F401,F403
from paddle_tpu_torch.ops.random import (  # noqa: F401
    Generator, bernoulli, bernoulli_, default_generator, exponential_,
    get_rng_state, gumbel_softmax, multinomial, normal, normal_, poisson,
    rand, randint, randint_like, randn, randperm, seed, set_rng_state,
    shuffle, standard_normal, uniform, uniform_)
from paddle_tpu_torch.ops.search import *  # noqa: F401,F403

__all__ = (["ensure_tensor", "einsum", "getitem", "setitem"]
           + creation.__all__ + linalg.__all__ + manipulation.__all__
           + math.__all__ + random.__all__ + search.__all__)

TENSOR_METHODS = """
abs abs_ acos acosh add add_ addmm all allclose amax amin angle any argmax
argmin argsort as_strided asin asinh atan atan2 atanh atleast_1d atleast_2d
atleast_3d bernoulli_ bincount bitwise_and bitwise_not bitwise_or bitwise_xor
bmm broadcast_to bucketize cast_ ceil ceil_ cholesky cholesky_solve chunk clip
clip_ concat cond conj copysign cos cosh count_nonzero cross cummax cummin
cumprod cumsum deg2rad det diag diagonal diff digamma dist divide divide_ dot
eig eigh eigvals eigvalsh einsum equal equal_all erf erfinv exp exp_ expand
expand_as expm1 exponential_ flatten flatten_ flip floor floor_ floor_divide
floor_divide_ fmax fmin fmod frac full_like gather gather_nd gcd greater_equal
greater_than heaviside histogram hypot imag increment index_add index_add_
index_fill index_put index_put_ index_sample index_select inner inv inverse
isclose isfinite isinf isnan kron kthvalue lcm ldexp lerp lerp_ less_equal
less_than lgamma log log10 log1p log2 logaddexp logcumsumexp logical_and
logical_not logical_or logical_xor logit logsumexp lstsq lu masked_fill
masked_fill_ masked_scatter masked_select matmul matrix_exp matrix_power
matrix_rank max maximum mean median min minimum mod mode moveaxis multinomial
multiply multiply_ multiply_no_nan mv nan_to_num nanmean nanmedian
nanquantile nansum neg nextafter nonzero norm normal_ not_equal numel one_hot
ones_like outer pinv pow pow_ prod put_along_axis put_along_axis_ qr quantile
rad2deg real reciprocal reciprocal_ remainder remainder_ repeat_interleave
reshape reshape_ roll rot90 round round_ rsqrt rsqrt_ scale scale_ scatter
scatter_ scatter_nd_add searchsorted sigmoid sigmoid_ sign sin sinh slice
slogdet solve sort split sqrt sqrt_ square square_ squeeze squeeze_ stack
stanh std strided_slice subtract subtract_ sum svd swapaxes t take
take_along_axis tan tanh tanh_ tensor_split tile topk trace transpose
triangular_solve tril triu trunc unbind uniform_ unique unique_consecutive
unsqueeze unsqueeze_ unstack var view view_as where where_ zeros_like
""".split()

_g = globals()
for _name in TENSOR_METHODS:
    _fn = _g.get(_name)
    if _fn is not None and not hasattr(Tensor, _name):
        setattr(Tensor, _name, _fn)
del _g, _name, _fn
