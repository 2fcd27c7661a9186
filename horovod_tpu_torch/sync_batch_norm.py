"""Batch normalization over the global batch, with statistics reduced
through the negotiated spine.

Port of ``horovod_tpu/torch/sync_batch_norm.py`` (reference:
horovod/torch/sync_batch_norm.py).  One ``torch.autograd.Function`` does
the arithmetic for two faces:

- the forward sums ``[sum x, sum x^2, count]`` per channel in fp32 and,
  when synced, reduces them with one named Sum allreduce; the batch mean is
  ``sum / count`` and the biased variance ``max(sum x^2 / count - mean^2,
  0)``; the output ``(x - mean) * rsqrt(var + eps) * weight + bias`` is
  computed in fp32 and cast to the input's dtype;
- the backward reduces ``[sum dy, sum dy * (x - mean)]`` (``dy`` the
  output's gradient) with one more named allreduce and applies the chain
  rule through the global mean and variance.  These are the sums
  ``torch.nn.SyncBatchNorm`` reduces; the reference's ``[sum g, sum g *
  xhat]`` (``g = dy * weight``) are the same sums times the per-channel
  constants ``weight`` and ``weight * invstd``, which a zero-initialized
  scale (the last BatchNorm of every ResNet block) would make impossible
  to divide back out.

On the card the passes are PyTorch's CUDA batch-norm kernels (those of
``torch.nn.SyncBatchNorm``); on the CPU they are plain fp32 PyTorch
arithmetic, the version the tests hold against the JAX package.

Both run inside ``torch.profiler.record_function`` ranges
(``batch_norm.forward``, ``batch_norm.backward``), so a profiler trace can
tell their kernels from the model's other elementwise work.

:class:`SyncBatchNorm` is the torch API of the reference's torch binding:
momentum 0.1 as ``running = (1 - m) * running + m * batch``, the unbiased
batch variance in ``running_var``, ``process_set=`` and ``name=``, and
plain ``nn.BatchNorm`` at world 1 or in eval mode.

:class:`BatchNorm` is the normalization the ported model zoo computes:
flax's ``nn.BatchNorm`` (flax 0.12.3 ``linen/normalization.py``), synced
over the global batch of every rank when built with ``sync=True`` (the
reference models' ``bn_axis_name``).  Its ``momentum`` runs the other way (0.9 means
``running = 0.9 * running + 0.1 * batch``), its running variance is the
biased batch variance, its parameters are fp32 and its output is in the
layer's ``dtype``.  Unsynced, at world 1 or in eval mode it makes no
collective.  Each layer's collectives are named by its module path
(:func:`name_batch_norms`), so the names match across ranks whatever else
a rank has built.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch.profiler import record_function

from . import basics, mpi_ops
from .process_sets import ProcessSet


def _world(process_set: Optional[ProcessSet]) -> int:
    if not basics.is_initialized():
        return 1
    return process_set.size() if process_set is not None else basics.size()


def _channel_dims(x: torch.Tensor):
    return [0] + list(range(2, x.dim()))


def _view(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.view([1, -1] + [1] * (x.dim() - 2))


def _stats_from_sums(stats: torch.Tensor, c: int, eps: float):
    """(mean, biased var, invstd, count) from ``[sum x, sum x^2, count]``,
    as flax computes them: ``var = max(E[x^2] - E[x]^2, 0)``."""
    count = stats[-1:].clamp_min(1.0)
    mean = stats[:c] / count
    var = (stats[c:2 * c] / count - mean * mean).clamp_min(0.0)
    return mean, var, torch.rsqrt(var + eps), count


def plain_forward(x, weight, bias, mean, invstd):
    """The normalized output in fp32 arithmetic, cast to ``x``'s dtype."""
    out = (x.float() - _view(mean, x)) * _view(invstd, x)
    if weight is not None:
        out = out * _view(weight.float(), x)
    if bias is not None:
        out = out + _view(bias.float(), x)
    return out.to(x.dtype)


def plain_backward_sums(grad_out, x, mean, invstd):
    """``[sum dy, sum dy * (x - mean)]`` (what the backward reduces across
    ranks) and the parameter gradients ``sum dy * xhat`` and ``sum dy``."""
    dims = _channel_dims(x)
    xmu = x.float() - _view(mean, x)
    dy = grad_out.float()
    sum_dy, sum_dy_xmu = dy.sum(dims), (dy * xmu).sum(dims)
    return torch.cat([sum_dy, sum_dy_xmu]), sum_dy_xmu * invstd, sum_dy


def plain_backward_input(grad_out, x, mean, invstd, weight, sums, count):
    """``dx = w * invstd * (dy - sum dy / n - (x - mean) * invstd^2 *
    sum dy (x - mean) / n)`` over the global sums and count."""
    c = x.size(1)
    xmu = x.float() - _view(mean, x)
    scale = invstd if weight is None else invstd * weight.float()
    dx = (grad_out.float() - _view(sums[:c] / count, x)
          - xmu * _view(invstd * invstd * sums[c:] / count, x))
    return (dx * _view(scale, x)).to(x.dtype)


def _contiguous(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    fmt = (torch.channels_last if like.dim() == 4 and
           like.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return t.contiguous(memory_format=fmt)


class _BatchNormFn(torch.autograd.Function):
    """Training-mode batch normalization; returns ``(out, mean, var,
    count)``, where ``mean``, the biased ``var`` and the element count per
    channel are the batch statistics in fp32, global when ``name`` is set.

    On a CUDA tensor the passes are PyTorch's CUDA batch-norm kernels, the
    ones ``torch.nn.SyncBatchNorm`` runs: ``batch_norm_stats`` (one read,
    fp32 Welford), ``batch_norm_elemt``, ``batch_norm_backward_reduce`` and
    ``batch_norm_backward_elemt``.  On a CPU tensor it is the plain fp32
    arithmetic above (``plain_*``), which ``chip_smoke.py`` holds the CUDA
    passes against on the card."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, process_set, name):
        with record_function("batch_norm.forward"):
            return _BatchNormFn._forward(ctx, x, weight, bias, eps,
                                         process_set, name)

    @staticmethod
    def _forward(ctx, x, weight, bias, eps, process_set, name):
        c = x.size(1)
        n = x.numel() // c
        native = x.is_cuda
        if native:
            x = _contiguous(x, x)
            mean, invstd = torch.batch_norm_stats(x, eps)
            var = (invstd.pow(-2) - eps).clamp_min(0.0)
            sums = (mean * n, (var + mean * mean) * n)
        else:
            dims = _channel_dims(x)
            xf = x.float()
            sums = (xf.sum(dims), (xf * xf).sum(dims))
        count = torch.full((1,), float(n), dtype=torch.float32,
                           device=x.device)
        if name is not None or not native:
            stats = torch.cat([*sums, count])
            if name is not None:
                stats = mpi_ops.allreduce(stats, op=mpi_ops.Sum,
                                          name=f"{name}.fwd",
                                          process_set=process_set)
            mean, var, invstd, count = _stats_from_sums(stats, c, eps)
        if native:
            out = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            out = plain_forward(x, weight, bias, mean, invstd)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.process_set, ctx.name = process_set, name
        ctx.mark_non_differentiable(mean, var, count)
        return out, mean, var, count

    @staticmethod
    def backward(ctx, grad_out, *_stats):
        with record_function("batch_norm.backward"):
            return _BatchNormFn._backward(ctx, grad_out)

    @staticmethod
    def _backward(ctx, grad_out):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c = x.size(1)
        need_w = weight is not None and ctx.needs_input_grad[1]
        if x.is_cuda:
            grad_out = _contiguous(grad_out, x)
            sum_dy, sum_dy_xmu, grad_w, grad_b = \
                torch.batch_norm_backward_reduce(
                    grad_out, x, mean, invstd, weight, True, need_w,
                    ctx.needs_input_grad[2])
            sums = torch.cat([sum_dy, sum_dy_xmu])
        else:
            sums, grad_w, grad_b = plain_backward_sums(grad_out, x, mean,
                                                       invstd)
        # The two sums the chain rule through the global mean and variance
        # needs, in one allreduce.
        if ctx.name is not None:
            sums = mpi_ops.allreduce(sums, op=mpi_ops.Sum,
                                     name=f"{ctx.name}.bwd",
                                     process_set=ctx.process_set)
        if x.is_cuda:
            grad_x = torch.batch_norm_backward_elemt(
                grad_out, x, mean, invstd,
                None if weight is None else weight.float(),
                sums[:c], sums[c:], count.to(torch.int32))
        else:
            grad_x = plain_backward_input(grad_out, x, mean, invstd, weight,
                                          sums, count)
        if not need_w:
            grad_w = None
        elif grad_w is not None:
            grad_w = grad_w.to(weight.dtype)
        if not ctx.needs_input_grad[2]:
            grad_b = None
        return grad_x, grad_w, grad_b, None, None, None


class SyncBatchNorm(_BatchNorm):
    """Drop-in ``nn.BatchNorm*d`` whose training statistics are computed
    over the global batch across the ranks of ``process_set`` (torch
    semantics; see the module docstring)."""

    _instances = 0

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 process_set: Optional[ProcessSet] = None,
                 name: Optional[str] = None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        self._process_set = process_set
        # Collective names must match across ranks.  By default they follow
        # construction order, which holds when every rank builds the same
        # models the same way; pin ``name=`` (e.g. the module's path)
        # otherwise.
        if name is not None:
            self._name = f"sync_bn.{name}"
        else:
            self._name = f"sync_bn.{SyncBatchNorm._instances}"
            SyncBatchNorm._instances += 1

    def _check_input_dim(self, x) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input (got {x.dim()}D)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training or _world(self._process_set) == 1:
            return super().forward(x)
        if self.momentum is None:
            raise ValueError(
                "SyncBatchNorm requires a fixed momentum (cumulative "
                "moving average is not supported; reference restriction)")
        out, mean, var, count = _BatchNormFn.apply(
            x, self.weight, self.bias, self.eps, self._process_set,
            self._name)
        if self.track_running_stats:
            self.num_batches_tracked.add_(1)
            with torch.no_grad():
                # Unbiased for the running variance, biased to normalize.
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (count / (count - 1.0).clamp_min(1.0)))
        return out


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over dim 1 of an NC... tensor (the model zoo's
    normalization; see the module docstring).  ``weight``/``bias`` are
    flax's ``scale``/``bias``, ``running_mean``/``running_var`` its
    ``batch_stats`` ``mean``/``var``."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 sync: bool = False, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.sync = sync
        self.name = "batch_norm"  # set to the module path by the model
        self.weight = nn.Parameter(
            torch.zeros(num_features) if zero_scale
            else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            invstd = torch.rsqrt(self.running_var + self.eps)
            out = (x.float() - _view(self.running_mean, x)) * \
                _view(invstd * self.weight, x) + _view(self.bias, x)
            return out.to(self.dtype)
        name = None
        if self.sync and _world(None) > 1:
            name = f"zoo_bn.{self.name}"
        out, mean, var, _ = _BatchNormFn.apply(
            x, self.weight, self.bias, self.eps, None, name)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return out.to(self.dtype)


def name_batch_norms(model: nn.Module) -> nn.Module:
    """Name every zoo :class:`BatchNorm` in ``model`` by its module path
    (the names its collectives are negotiated under)."""
    for path, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.name = path
    return model
