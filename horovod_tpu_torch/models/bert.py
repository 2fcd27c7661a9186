"""BERT encoder and pretraining head: port of ``horovod_tpu/models/bert.py``.

The module computes at the precision of the flax model, with every cast
written out (no autocast):

- parameters are fp32; projections and embeddings compute in
  ``config.dtype`` (bf16 for ``BERT_LARGE``), as flax's ``dtype=`` does;
- one fused qkv projection (``qkv``, ``[3 * heads * head_dim, hidden]``
  in (3, heads, head_dim) order) and one output projection over all heads;
- dense attention with fp32 logits and softmax, the probabilities cast
  back to ``config.dtype`` for the product with V, as ``bert.py`` computes
  it outside any Pallas kernel (no flash kernel runs on this path);
- post-LN: LayerNorm in fp32 (epsilon 1e-6, flax's default) after each
  residual add; GELU the tanh approximation (flax's ``nn.gelu``);
- the MLM head's LayerNorm and logits in fp32.

Module names follow the flax tree (``encoder.layer_<i>.attention.qkv``,
...) so ``models.convert`` maps one onto the other.  With
``sp_axis_name`` set, the sequence is sharded over that mesh axis: position
ids are global and attention is non-causal ring attention
(``parallel.ring_attention``; the flash kernels on each hop under
``sp_use_flash``), which ignores ``attention_mask`` as the reference's
does (it passes none to its ring).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import axis_index
from ..parallel.ring_attention import ring_attention
from ._layers import LN_EPS, layer_norm, linear, make_dense, make_embed


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024          # BERT-Large
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    sp_axis_name: Optional[str] = None  # sequence-parallel mesh axis
    sp_use_flash: bool = False          # flash kernels per ring hop


BERT_BASE = BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                       intermediate_size=3072)
BERT_LARGE = BertConfig()
BERT_TINY = BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                       num_heads=2, intermediate_size=512,
                       max_position_embeddings=128)


def _ln(hidden: int) -> nn.LayerNorm:
    return nn.LayerNorm(hidden, eps=LN_EPS)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = make_dense(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = make_dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, mask=None):
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = linear(x, self.qkv, cfg.dtype).view(
            b, s, 3, cfg.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cfg.sp_axis_name is not None:
            ctx = ring_attention(q, k, v, cfg.sp_axis_name, causal=False,
                                 use_flash=cfg.sp_use_flash)
            return linear(ctx.reshape(b, s, cfg.hidden_size), self.out,
                          cfg.dtype)
        # fp32 logits and softmax whatever the activation dtype.
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * \
            self.head_dim ** -0.5
        if mask is not None:
            logits = torch.where(mask[:, None, None, :].bool(), logits,
                                 torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return linear(ctx.reshape(b, s, cfg.hidden_size), self.out,
                       cfg.dtype)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg)
        self.ln_attn = _ln(cfg.hidden_size)
        self.mlp_in = make_dense(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_out = make_dense(cfg.intermediate_size, cfg.hidden_size)
        self.ln_mlp = _ln(cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, mask=None, deterministic: bool = True):
        dt = self.cfg.dtype
        drop = (lambda t: t) if deterministic else self.dropout
        attn = drop(self.attention(x, mask))
        x = layer_norm(x + attn, self.ln_attn, dt)
        h = F.gelu(linear(x, self.mlp_in, dt), approximate="tanh")
        h = drop(linear(h, self.mlp_out, dt))
        return layer_norm(x + h, self.ln_mlp, dt)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = make_embed(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = make_embed(cfg.max_position_embeddings,
                                              cfg.hidden_size)
        self.token_type_embeddings = make_embed(cfg.type_vocab_size,
                                                cfg.hidden_size)
        self.ln_embed = _ln(cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", TransformerLayer(cfg))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic: bool = True):
        cfg = self.cfg
        dt = cfg.dtype
        s = input_ids.shape[-1]
        # Under sequence parallelism this rank holds global positions
        # [index * s, (index + 1) * s).
        offset = 0 if cfg.sp_axis_name is None else \
            axis_index(cfg.sp_axis_name) * s
        pos = torch.arange(offset, offset + s, device=input_ids.device)[None]
        # Gather, then cast: the same values as flax's cast-then-gather.
        x = self.word_embeddings(input_ids).to(dt) + \
            self.position_embeddings(pos).to(dt)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids).to(dt)
        x = layer_norm(x, self.ln_embed, dt)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, attention_mask, deterministic)
        return x


class BertForPreTraining(nn.Module):
    """Encoder + MLM head; returns fp32 logits ``[B, S, vocab]``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = BertEncoder(cfg)
        self.mlm_transform = make_dense(cfg.hidden_size, cfg.hidden_size)
        self.mlm_ln = _ln(cfg.hidden_size)
        self.mlm_head = make_dense(cfg.hidden_size, cfg.vocab_size)

    def forward(self, input_ids, token_type_ids=None,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True):
        hidden = self.encoder(input_ids, token_type_ids, attention_mask,
                              deterministic)
        h = F.gelu(linear(hidden, self.mlm_transform, self.cfg.dtype),
                   approximate="tanh")
        h = self.mlm_ln(h.float())
        return self.mlm_head(h)


def mlm_loss(logits, labels, label_weights):
    """Masked-LM cross entropy: the mean over positions whose weight is 1."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    w = label_weights.float()
    return -(ll * w).sum() / w.sum().clamp_min(1.0)
