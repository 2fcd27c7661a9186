"""Tensor (model) parallelism over a mesh axis: port of
``horovod_tpu/parallel/tensor_parallel.py``.

The Megatron building blocks: each rank holds a slice of the weight, and
the pair column -> row costs one psum per MLP block.

- **column parallel**: kernel sharded on the OUTPUT dim; the input is
  replicated over the tp axis (its gradient is summed over the axis, as
  JAX's pvary transposes); the output is this rank's feature slice.
- **row parallel**: kernel sharded on the INPUT dim; the input is a
  column-parallel output; the fp32 partial products are combined by one
  psum, whose gradient passes through unchanged.

Kernels are ``[d_in, d_out]``, as flax's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .collectives import (all_gather, axis_index, axis_size, ensure_varying,
                          psum)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def column_parallel_dense(x, kernel_local, bias_local=None,
                          axis_name: str = "tp",
                          gather_output: bool = False):
    """``y_local = x @ W[:, shard] (+ b[shard])``, accumulated in fp32 and
    cast to x's dtype; ``gather_output`` all-gathers the feature dim back to
    ``[..., d_out]``."""
    x = ensure_varying(x, axis_name)
    y = torch.einsum("...i,ij->...j", x.float(),
                     kernel_local.float()).to(x.dtype)
    if bias_local is not None:
        y = y + bias_local
    if gather_output:
        y = all_gather(y, axis_name, axis=-1)
    return y


def row_parallel_dense(x_local, kernel_local, bias=None,
                       axis_name: str = "tp"):
    """``y = psum_tp(x_local @ W[shard, :]) (+ b)``: the partial products
    summed in fp32, cast to x's dtype, the replicated bias added once after
    the psum."""
    partial = torch.einsum("...i,ij->...j", x_local.float(),
                           kernel_local.float())
    y = psum(partial, axis_name).to(x_local.dtype)
    if bias is not None:
        y = y + bias
    return y


def tp_mlp(x, w_in_local, w_out_local, b_in_local=None, b_out=None,
           axis_name: str = "tp", activation=_gelu):
    """The canonical TP transformer MLP: column -> act -> row, one psum."""
    h = column_parallel_dense(x, w_in_local, b_in_local, axis_name)
    h = activation(h)
    return row_parallel_dense(h, w_out_local, b_out, axis_name)


def vocab_parallel_embedding(ids, table_local, axis_name: str = "tp"):
    """Embedding with the vocab dim sharded: each rank looks up its own
    vocab range, out-of-range rows give zeros, and one psum combines."""
    vocab_local = table_local.shape[0]
    start = axis_index(axis_name) * vocab_local
    local_ids = ids - start
    in_range = (local_ids >= 0) & (local_ids < vocab_local)
    safe_ids = torch.clamp(local_ids, 0, vocab_local - 1)
    emb = table_local[safe_ids]
    emb = torch.where(in_range[..., None], emb, torch.zeros_like(emb))
    return psum(emb, axis_name)


def shard_kernel(kernel, axis_name: str, dim: int):
    """This rank's slice of a replicated kernel along ``dim``; raises
    ValueError when the axis size does not divide that dim."""
    n = axis_size(axis_name)
    if kernel.shape[dim] % n != 0:
        raise ValueError(
            f"shard_kernel: dim {dim} of shape {tuple(kernel.shape)} is not "
            f"divisible by axis {axis_name!r} size {n}")
    size = kernel.shape[dim] // n
    return kernel.narrow(dim, axis_index(axis_name) * size, size)
