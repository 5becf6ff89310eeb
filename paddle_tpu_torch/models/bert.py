"""BERT (counterpart of `paddle_tpu/models/bert.py`): the JAX package's
Layers, on the port's `nn`, with the JAX state_dict keys.

Attention is bidirectional. With no mask and no attention dropout it goes
through `nn.functional.scaled_dot_product_attention`'s flash op, non-causal
(the ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` kernels on the card);
with a mask it takes the plain softmax path, as the JAX package's does.
Built after ``paddle.seed(s)`` a model draws the JAX package's weights (the
same initializers in the same creation order, `nn/initializer.py`).
"""
from __future__ import annotations

from dataclasses import dataclass

from paddle_tpu_torch import nn
from paddle_tpu_torch import ops
from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertModel", "BertForSequenceClassification",
           "BertForPretraining"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12


def _winit(cfg):
    return ParamAttr(initializer=I.Normal(0.0, cfg.initializer_range))


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            weight_attr=_winit(cfg))
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size,
                                                weight_attr=_winit(cfg))
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size,
                                                  weight_attr=_winit(cfg))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        input_ids = ops.ensure_tensor(input_ids)
        S = input_ids.shape[1]
        if position_ids is None:
            position_ids = ops.arange(S, dtype="int64").unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = ops.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids) +
             self.position_embeddings(position_ids) +
             self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size,
                             weight_attr=_winit(cfg))
        self.out = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                             weight_attr=_winit(cfg))
        self.attn_drop_p = cfg.attention_dropout

    def forward(self, x, attention_mask=None):
        B, S = x.shape[0], x.shape[1]
        qkv = self.qkv(x).reshape([B, S, 3, self.num_heads, self.head_dim])
        q, k, v = qkv.unbind(axis=2)
        drop = self.attn_drop_p if self.training else 0.0
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attention_mask, dropout_p=drop,
            training=self.training)
        return self.out(out.reshape([B, S, -1]))


class BertLayer(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertSelfAttention(cfg)
        self.attn_norm = nn.LayerNorm(cfg.hidden_size,
                                      epsilon=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                      weight_attr=_winit(cfg))
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                weight_attr=_winit(cfg))
        self.out_norm = nn.LayerNorm(cfg.hidden_size,
                                     epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, attention_mask=None):
        x = self.attn_norm(x + self.dropout(self.attention(x,
                                                           attention_mask)))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.out_norm(x + self.dropout(h))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = nn.LayerList([BertLayer(cfg)
                                     for _ in range(cfg.num_layers)])
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.ndim == 2:
            # [B, S] 1/0 mask -> additive [B, 1, 1, S]
            am = (1.0 - attention_mask.astype("float32")) * -1e30
            attention_mask = am.unsqueeze(1).unsqueeze(1)
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, attention_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForSequenceClassification(nn.Layer):
    def __init__(self, cfg: BertConfig, num_classes=2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        loss = F.cross_entropy(logits, labels)
        return logits, loss


class BertForPretraining(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.transform_norm = nn.LayerNorm(cfg.hidden_size,
                                           epsilon=cfg.layer_norm_eps)
        self.nsp = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_labels=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        h = self.transform_norm(F.gelu(self.transform(seq)))
        # tied decoder
        mlm_logits = ops.matmul(
            h, self.bert.embeddings.word_embeddings.weight, transpose_y=True)
        nsp_logits = self.nsp(pooled)
        if masked_lm_labels is None:
            return mlm_logits, nsp_logits
        mlm_loss = F.cross_entropy(
            mlm_logits.reshape([-1, mlm_logits.shape[-1]]).astype("float32"),
            masked_lm_labels.reshape([-1]), ignore_index=-100)
        loss = mlm_loss
        if next_sentence_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits,
                                          next_sentence_labels.reshape([-1]))
        return loss
