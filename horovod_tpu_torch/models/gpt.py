"""Decoder-only (GPT-2 style) causal language model in PyTorch.

Port of ``horovod_tpu/models/gpt.py``.  The module computes at the precision
of the flax model it mirrors, with every cast written out (no autocast):

- parameters are fp32; each projection and embedding casts its parameters
  and input to ``config.dtype`` (bf16 for ``GPT_SMALL``), as flax's
  ``dtype=`` does, so the residual stream is in that dtype;
- LayerNorm runs in fp32 (epsilon 1e-6, flax's default) and its output is
  cast back to the compute dtype;
- GELU is the tanh approximation (flax's ``nn.gelu``);
- ``ln_f`` and ``lm_head`` run in fp32, so the logits are fp32.

Attention is causal with ``scale = head_dim ** -0.5``, through the flash
kernels (``config.use_flash``) or dense attention, or, with
``config.sp_axis_name`` set, through ring attention over that mesh axis
(``parallel.ring_attention``; each hop's chunk by the flash kernels under
``config.sp_use_flash``), the sequence sharded over the axis and the
positions global.  ``config.remat`` checkpoints each block
(``torch.utils.checkpoint``), so its activations are recomputed in
backward, ring hops included.  ``config.dropout_rate`` (0 by default)
drops the attention's and the MLP's outputs before each residual add, as
the reference's ``nn.Dropout`` does, when ``forward`` is called with
``deterministic=False`` on a module in training mode (the default
``deterministic=True`` is the reference's eval); torch's generator draws
the mask, so only the keep rate and the ``1/(1-p)`` scale match the
reference's, not the mask.

The forward is DTensor-aware for the gspmd data plane
(``ops/gspmd_plane.py``): given ``Shard(0)`` ids on a mesh and replicated
DTensor parameters, the positions become a replicated DTensor on that
mesh, attention (dense and flash alike) runs per rank on its batch shard
through ``local_map``, and :func:`lm_loss` is the global mean of the
per-token losses, with no collective in the forward.  Plain tensors take
the plain path unchanged.  Parameter names follow
the flax tree (``h.<i>.attn.qkv`` for ``h_<i>/attn/qkv``, ...), so
``models.convert.gpt_params_from_jax`` maps one onto the other.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import dense_attention, flash_attention
from ..parallel.collectives import axis_index
from ..parallel.ring_attention import ring_attention
from ._layers import LN_EPS
from ._layers import layer_norm as _layer_norm
from ._layers import linear as _linear


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # GPT-2 vocab padded to a multiple of 128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    use_flash: bool = True           # the hand-written kernels on a card
    sp_axis_name: Optional[str] = None   # sequence-parallel mesh axis
    sp_use_flash: bool = False           # flash kernels per ring hop
    remat: bool = False                  # checkpoint each block


GPT_SMALL = GPTConfig()
GPT_TINY = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                     num_heads=4, max_seq_len=256, use_flash=False,
                     dtype=torch.float32)


def _mesh_of(x):
    """The ``DeviceMesh`` of a DTensor, None for a plain tensor (DTensor's
    module is loaded whenever a DTensor exists)."""
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is not None and isinstance(x, dt.DTensor):
        return x.device_mesh
    return None


def _per_shard(fn, mesh, *xs):
    """``fn`` applied to each rank's shards of DTensors ``xs`` that are
    sharded on the batch dim (or replicated), its output placed as the
    first input is.  Only activations enter: a replicated parameter's
    gradient would come back labelled replicated without being reduced."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    placements = [tuple(x.placements) for x in xs]
    for pl in placements:
        if any(p != Shard(0) and p != Replicate() for p in pl):
            raise ValueError(f"GPT runs DTensors sharded on the batch dim "
                             f"only, got placements {pl}")
    return local_map(fn, list(placements[0]), in_placements=tuple(placements),
                     device_mesh=mesh)(*xs)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = _linear(x, self.qkv, cfg.dtype).view(
            b, s, 3, cfg.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cfg.sp_axis_name is not None:
            ctx = ring_attention(q, k, v, cfg.sp_axis_name, causal=True,
                                 use_flash=cfg.sp_use_flash)
        else:
            attend = flash_attention if cfg.use_flash else dense_attention
            mesh = _mesh_of(q)
            if mesh is None:
                ctx = attend(q, k, v, causal=True)
            else:
                ctx = _per_shard(lambda q, k, v: attend(q, k, v, causal=True),
                                 mesh, q, k, v)
        return _linear(ctx.reshape(b, s, cfg.hidden_size), self.out,
                       cfg.dtype)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.attn = CausalSelfAttention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.mlp_in = nn.Linear(cfg.hidden_size, 4 * cfg.hidden_size)
        self.mlp_out = nn.Linear(4 * cfg.hidden_size, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, deterministic: bool = True):
        dt = self.cfg.dtype
        drop = (lambda t: t) if deterministic else self.dropout
        x = x + drop(self.attn(_layer_norm(x, self.ln_1, dt)))
        m = _linear(_layer_norm(x, self.ln_2, dt), self.mlp_in, dt)
        m = F.gelu(m, approximate="tanh")
        return x + drop(_linear(m, self.mlp_out, dt))


class GPT(nn.Module):
    """Causal LM: returns next-token logits ``[B, S, V]`` (fp32)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size)
        self.h = nn.ModuleList(GPTBlock(cfg) for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def forward(self, input_ids, deterministic: bool = True):
        cfg = self.cfg
        dt = cfg.dtype
        s = input_ids.shape[-1]
        # Under sequence parallelism this rank holds global positions
        # [index * s, (index + 1) * s).
        offset = 0 if cfg.sp_axis_name is None else \
            axis_index(cfg.sp_axis_name) * s
        pos = torch.arange(offset, offset + s, device=input_ids.device)[None]
        mesh = _mesh_of(input_ids)
        if mesh is not None:
            from torch.distributed.tensor import DTensor, Replicate

            pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        # Gather, then cast: the same values as flax's cast-then-gather.
        x = (self.wte(input_ids).to(dt) + self.wpe(pos).to(dt))
        for block in self.h:
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    block, x, deterministic, use_reentrant=False)
            else:
                x = block(x, deterministic)
        x = self.ln_f(x.float())
        return self.lm_head(x)


def lm_loss(logits, input_ids):
    """Next-token cross entropy (shifted), mean over positions.  On a
    sequence shard the shift stays inside the shard, so the one token at
    each boundary between shards is not predicted (as the reference's
    ``examples/jax_gpt_long_context.py`` says).  On ``Shard(0)`` DTensors
    each rank takes its shard's per-token losses and the mean of the
    DTensor is the global mean, ``Partial`` until read."""
    mesh = _mesh_of(logits)
    if mesh is None:
        return F.cross_entropy(logits[:, :-1].flatten(0, 1).float(),
                               input_ids[:, 1:].flatten())
    return _per_shard(_token_losses, mesh, logits, input_ids).mean()


def _token_losses(logits, input_ids):
    return F.cross_entropy(logits[:, :-1].flatten(0, 1).float(),
                           input_ids[:, 1:].flatten(),
                           reduction="none").view(logits.shape[0], -1)
