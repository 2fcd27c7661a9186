"""Expert parallelism: switch-routed mixture of experts over a mesh axis.
Port of ``horovod_tpu/parallel/moe.py``.

One expert per ep rank; top-1 (switch) routing with fp32 router logits and
a fixed capacity per expert, so every shape is static; the dispatch and the
return are each one tiled all-to-all.  Tokens over capacity get a zero
expert output, scaled by their gate as usual.  The all-to-alls move the
activations as they are: the reference's layer does not quantize, so
neither does this one (``hvd.quantized_alltoall`` is not used).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .collectives import all_to_all, axis_size


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _route(x, router_kernel):
    """fp32 router logits -> softmax gates, each token's expert and gate."""
    logits = torch.einsum("td,de->te", x.float(), router_kernel.float())
    gates = torch.softmax(logits, dim=-1)
    expert_idx = gates.argmax(dim=-1)  # the first of equal maxima
    gate = gates.gather(1, expert_idx[:, None])[:, 0]
    return gates, expert_idx, gate


def switch_moe(x, router_kernel, expert_fn: Callable, axis_name: str = "ep",
               capacity_factor: float = 1.25):
    """Top-1 MoE layer with one expert per ep rank.

    Args:
      x: ``[tokens_local, d]``, this rank's tokens.
      router_kernel: ``[d, n_experts]`` router weights (replicated).
      expert_fn: this rank's expert, ``[n_experts * capacity, d] -> same``.
      axis_name: the expert-parallel axis; n_experts is its size.
      capacity_factor: per-expert capacity ``ceil(T * factor / E)``.

    Returns ``[tokens_local, d]``.
    """
    tokens, d = x.shape
    n_expert = axis_size(axis_name)
    capacity = int(-(-tokens * capacity_factor // n_expert))  # ceil

    gates, expert_idx, gate = _route(x, router_kernel)
    # Position of each token within its expert's capacity bucket.
    onehot = F.one_hot(expert_idx, n_expert)                 # [T, E]
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(
        1, expert_idx[:, None])[:, 0]                        # [T]
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, torch.zeros_like(pos))

    # Scatter tokens into the dispatch buffer [E, C, d].
    kept = torch.where(keep[:, None], x, torch.zeros_like(x))
    dispatch = torch.zeros((n_expert * capacity, d), dtype=x.dtype,
                           device=x.device).index_add(
        0, expert_idx * capacity + safe_pos, kept)
    # Shard e of every rank -> rank e: [E_src, C, d], each peer's tokens
    # for this rank's expert.
    received = all_to_all(dispatch.view(n_expert, capacity, d), axis_name,
                          split_axis=0, concat_axis=0)
    expert_out = expert_fn(received.reshape(n_expert * capacity, d))
    expert_out = expert_out.reshape(n_expert, capacity, d).to(x.dtype)
    # Return trip: chunk s goes back to source rank s.
    returned = all_to_all(expert_out, axis_name, split_axis=0,
                          concat_axis=0)                     # [E, C, d]
    out = returned[expert_idx, safe_pos]                     # [T, d]
    out = torch.where(keep[:, None], out, torch.zeros_like(out))
    return out * gate[:, None].to(x.dtype)


def moe_ffn(w_in_local, w_out_local, activation=_gelu):
    """An ``expert_fn`` for :func:`switch_moe` from this rank's FFN weights
    (``[d, hidden]``, ``[hidden, d]``)."""

    def fn(tokens):
        h = activation(torch.einsum("td,dh->th", tokens, w_in_local))
        return torch.einsum("th,hd->td", h, w_out_local)

    return fn


def load_balancing_loss(x, router_kernel, axis_name: str = "ep"):
    """Switch-transformer auxiliary load-balance loss ``E * sum_e f_e P_e``
    (the fraction of this rank's tokens routed to e times the mean router
    probability of e)."""
    n_expert = axis_size(axis_name)
    gates, expert_idx, _ = _route(x, router_kernel)
    frac = F.one_hot(expert_idx, n_expert).float().mean(dim=0)
    prob = gates.mean(dim=0)
    return n_expert * torch.sum(frac * prob)
