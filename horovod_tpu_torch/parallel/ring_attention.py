"""Ring attention and Ulysses: sequence-parallel exact attention over a mesh
axis.  Port of ``horovod_tpu/parallel/ring_attention.py``.

Each rank holds one chunk of the sequence.  Q stays; K and V rotate around
the axis's ring (one exchange a hop, both in one autograd node) while the
softmax accumulates online in fp32, so the [S, S] scores never exist.  A
hop's chunk is computed densely (fp32 logits, masked with
``finfo(float32).min``) or, with ``use_flash``, by the flash kernels
(``ops.flash_attention.flash_attention_with_lse``: K4 forward, K5 and K6
backward on a card; their plain versions on the CPU), whose ``(out, lse)``
is the ``(ctx, m, l)`` triple with ``m := lse`` and ``l := 1``.  The hops
merge through ``lse``, so the backward hands K5 a non-zero lse cotangent.

The reference learns which chunk a hop holds from a traced index and
switches among three compiled branches; here the source position is a
Python int, so the branches are plain: a past chunk is non-causal, the
diagonal causal, and a future chunk (causal only) contributes the zero
statistics ``(0, -inf, 0)`` with no launch.  The launches therefore depend
on the rank: at sp = 2, causal, rank 0 runs each flash kernel once a layer
and rank 1 twice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import flash_attention_with_lse
from .collectives import all_to_all, ppermute, resolve, tie

_F32_MIN = torch.finfo(torch.float32).min


def _chunk_attention(q, k, v, scale, mask):
    """Attention statistics of one (q-chunk, kv-chunk) pair: the
    unnormalised context ``[B, Sq, H, D]`` fp32, the running max ``m`` and
    sum ``l`` ``[B, H, Sq]``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, _F32_MIN)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return ctx, m, l


def _flash_chunk(q, kc, vc, scale, causal, block_size):
    out, lse = flash_attention_with_lse(q, kc, vc, causal=causal, scale=scale,
                                        block_q=block_size,
                                        block_k=block_size)
    return out.float(), lse, torch.ones_like(lse)


def _bh(x):
    """``[B, H, S]`` -> ``[B, S, H, 1]``."""
    return x.transpose(1, 2)[..., None]


def merge(acc, m, l, ctx, m_c, l_c):
    """Online-softmax merge of ``(acc, m, l)`` with a chunk's statistics.
    A fully masked chunk has ``m_c = -inf``; the ``-inf`` guards and
    ``nan_to_num`` keep ``exp(-inf - -inf)`` out of the values and the
    gradients."""
    m_new = torch.maximum(m, m_c)
    alpha = torch.exp(torch.where(m == -torch.inf, -torch.inf, m - m_new))
    beta = torch.exp(torch.where(m_c == -torch.inf, -torch.inf, m_c - m_new))
    alpha = torch.nan_to_num(alpha)
    beta = torch.nan_to_num(beta)
    l_new = l * alpha + l_c * beta
    acc_new = acc * _bh(alpha) + ctx * _bh(beta)
    return acc_new, m_new, l_new


def ring_attention(q, k, v, axis_name, causal: bool = False,
                   scale: Optional[float] = None, use_flash: bool = False,
                   block_size: int = 128):
    """Exact attention with the sequence dimension sharded over
    ``axis_name``.

    Args:
      q, k, v: ``[batch, seq_local, heads, head_dim]``, this rank's chunk
        (chunk i holds global positions ``[i*seq_local, (i+1)*seq_local)``).
      axis_name: the mesh axis carrying the sequence shards.
      causal: a causal mask over global positions.
      scale: logit scale; ``head_dim ** -0.5`` by default.
      use_flash: each hop's chunk through the flash kernels (bf16, head_dim
        64 or 128 on a card) instead of dense fp32 attention.
      block_size: the plain flash version's tile (the CPU path).

    Returns ``[batch, seq_local, heads, head_dim]`` in q's dtype.  The
    reference rotates K/V n times and drops the last rotation's result;
    the port makes only the n - 1 rotations whose chunks it uses, on every
    rank, forward and backward.
    """
    ax = resolve(axis_name)
    n, me = ax.size, ax.index
    b, s, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), -torch.inf, device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    kc, vc = k, v
    for i in range(n):
        if i:
            kc, vc = ppermute((kc, vc), ax, perm)
        src = (me - i) % n          # whose chunk this hop holds
        if causal and src > me:     # entirely in the future
            acc = tie(acc, kc, vc)
            stats = (torch.zeros_like(acc), torch.full_like(m, -torch.inf),
                     torch.zeros_like(l))
        elif use_flash:
            stats = _flash_chunk(q, kc, vc, scale, causal and src == me,
                                 block_size)
        else:
            mask = None
            if causal and src == me:
                mask = torch.ones((s, s), dtype=torch.bool,
                                  device=q.device).tril()
            stats = _chunk_attention(q, kc, vc, scale, mask)
        acc, m, l = merge(acc, m, l, *stats)
    denom = _bh(torch.clamp_min(l, 1e-30))
    return (acc / denom).to(q.dtype)


def ulysses_attention(q, k, v, axis_name, causal: bool = False,
                      scale: Optional[float] = None):
    """DeepSpeed-Ulysses sequence parallelism: an all-to-all swaps the
    sharded dimension from sequence to heads, dense fp32-softmax attention
    runs over the full sequence on heads/n heads, and a second all-to-all
    swaps back.  Raises ValueError unless the axis size divides the
    heads."""
    n = resolve(axis_name).size
    if q.shape[2] % n != 0:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible by "
                         f"axis size ({n})")
    scale = q.shape[-1] ** -0.5 if scale is None else scale

    def to_full_seq(x):  # [B, S/n, H, D] -> [B, S, H/n, D]
        return all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    qf, kf, vf = to_full_seq(q), to_full_seq(k), to_full_seq(v)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf.float(), kf.float()) * scale
    if causal:
        sf = qf.shape[1]
        mask = torch.ones((sf, sf), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, _F32_MIN)
    probs = torch.softmax(logits, dim=-1).to(vf.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    # [B, S, H/n, D] -> [B, S/n, H, D]
    return all_to_all(ctx, axis_name, split_axis=1, concat_axis=2)
