"""Tensor-parallel layers at model-parallel degree 1 (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel.py:133-216`):
VocabParallelEmbedding, ColumnParallelLinear, RowParallelLinear and
ParallelCrossEntropy, the layers GPT is built from. On one card they are
the plain embedding, linear and cross entropy with the JAX layers'
parameters and initializers. An ``mp_group`` of more than one rank raises
NotImplementedError: sharding over cards, pipeline and sharding-stage
layers, and the RNG tracker wait for ROADMAP A6.4."""
from __future__ import annotations

from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


def _degree_one(mp_group, who):
    n = getattr(mp_group, "nranks", 1) if mp_group is not None else 1
    if n != 1:
        raise NotImplementedError(
            f"{who} over a model-parallel group of {n} ranks: tensor "
            "parallelism across cards is ROADMAP A6.4; the port runs these "
            "layers at degree 1")


class VocabParallelEmbedding(Layer):
    """The embedding table [num_embeddings, embedding_dim] (Xavier-normal
    unless ``weight_attr`` says otherwise)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        _degree_one(mp_group, "VocabParallelEmbedding")
        self._num = num_embeddings
        attr = ParamAttr._to_attr(weight_attr)
        if attr is None:
            attr = ParamAttr(initializer=I.XavierNormal())
        elif isinstance(attr, ParamAttr) and attr.initializer is None:
            attr.initializer = I.XavierNormal()
        self.weight = self.create_parameter((num_embeddings, embedding_dim),
                                            attr=attr)

    def forward(self, x):
        return F.embedding(x, self.weight)


class ColumnParallelLinear(Layer):
    """``x @ W + b`` with W [in, out]; ``gather_output`` has nothing to
    gather at degree 1."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        _degree_one(mp_group, "ColumnParallelLinear")
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            (in_features, out_features), attr=ParamAttr._to_attr(weight_attr))
        self.bias = None if has_bias is False else \
            self.create_parameter((out_features,), is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(Layer):
    """``x @ W + b`` with W [in, out]; no partial sums to reduce at degree
    1."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        _degree_one(mp_group, "RowParallelLinear")
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            (in_features, out_features), attr=ParamAttr._to_attr(weight_attr))
        self.bias = self.create_parameter((out_features,), is_bias=True) \
            if has_bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class ParallelCrossEntropy(Layer):
    """Per-token cross entropy (``reduction="none"``)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        _degree_one(mp_group, "ParallelCrossEntropy")
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.cross_entropy(input, label, reduction="none",
                               ignore_index=self.ignore_index)
