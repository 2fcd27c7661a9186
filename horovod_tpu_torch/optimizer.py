"""Grad-hook DistributedOptimizer for torch models.

Reference: horovod/torch/optimizer.py; the API of
``horovod_tpu/torch/optimizer.py`` and the arithmetic of
``horovod_tpu/optimizer.py:DistributedOptimizer``.  A hook on every
parameter fires when autograd has accumulated that parameter's gradient and
starts an async in-place allreduce of it at once, so communication overlaps
the rest of the backward pass; ``step()`` waits for every outstanding
reduction and then runs the wrapped optimizer.

``backward_passes_per_step=k`` lets k backward passes accumulate locally
before one reduction, prescaled by ``1/k`` so the reduced gradient is the
mean over passes as well as ranks.  ``gradient_predivide_factor=f`` splits
the average around the wire: prescale ``1/f``, sum, postscale ``f/size``.

``device_compression="int8"|"int4"|"int8g"`` sends every eligible gradient
(fp32, at least HOROVOD_WIRE_COMPRESSION_MIN_BYTES, world > 1) through the
quantized ring of that codec with error feedback, as
``horovod_tpu/optimizer.py``'s ``reduce_grads_ef``: the ring reduces
``corrected = grad + residual``, and the residual keeps this rank's own
quantization error, ``corrected - fake_quantize(corrected)``, for the next
step.  The fp32 residual lives in ``optimizer.state[p]["ef_residual"]``, so
it travels with ``state_dict()`` and ``broadcast_optimizer_state``.
Ineligible gradients take the plain allreduce and keep a zero residual.

Like the reference, the factory builds a dynamic subclass of the wrapped
optimizer's own class, so the result isinstance-checks as (say)
``torch.optim.AdamW`` and keeps working with LR schedulers.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional, Tuple

import torch

from . import basics
from .compression import Compression
from .mpi_ops import allreduce_async_, synchronize
from .ops import collectives as _ops
from .ops import quantize as _qz
from .wire import ReduceOp


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 gradient_predivide_factor: float = 1.0,
                 ef_codec: str = "none"):
        super(self.__class__, self).__init__(params)
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if gradient_predivide_factor != 1.0 and op != ReduceOp.AVERAGE:
            raise ValueError(
                "gradient_predivide_factor is only supported with op=Average")
        if op == ReduceOp.ADASUM:
            raise NotImplementedError(
                "Adasum arrives with the negotiated core, a later slice")
        named_parameters = list(named_parameters or [])
        if len(named_parameters) != len({n for n, _ in named_parameters}):
            raise ValueError("named_parameters contains duplicate names")
        self._requires_update = [p for group in self.param_groups
                                 for p in group["params"] if p.requires_grad]
        self._compression = compression
        self._bpps = int(backward_passes_per_step)
        self._op = ReduceOp(op)
        self._predivide = float(gradient_predivide_factor)
        self._handles: dict = {}  # param id -> (handle, ctx, wire tensor, p)
        self._passes: dict = {}   # param id -> local backward passes
        # Error feedback: the codec ("none" when off), the parameters whose
        # gradients wait for their ring in synchronize(), and the residuals
        # computed there.  Those enter self.state only after the inner
        # step: optimizers such as Adam set up a parameter's state when it
        # is empty, and a residual stored first would make it look set up.
        self._ef_codec = ef_codec
        self._ef_min_bytes = _ops._device_codec_defaults()[1]
        self._ef_ready: set = set()
        self._ef_residuals: dict = {}
        self._should_sync = True
        self._hooks = [p.register_post_accumulate_grad_hook(self._hook)
                       for p in self._requires_update]

    def _hook(self, p: torch.nn.Parameter) -> None:
        pid = id(p)
        self._passes[pid] = self._passes.get(pid, 0) + 1
        if self._passes[pid] >= self._bpps:
            self._passes[pid] = 0
            self._allreduce_grad_async(p)

    def _scales(self):
        """(op, prescale, postscale) of one gradient reduction."""
        if self._predivide != 1.0:
            return (ReduceOp.SUM, 1.0 / (self._bpps * self._predivide),
                    self._predivide / basics.size())
        return self._op, 1.0 / self._bpps, 1.0

    def _allreduce_grad_async(self, p: torch.nn.Parameter) -> None:
        if p.grad.is_sparse:
            raise NotImplementedError(
                "sparse gradients arrive with the negotiated core, a later "
                "slice of the port")
        if self._ef_codec != "none" and _ops.quantized_collective_eligible(
                p.grad, basics.size(), self._ef_min_bytes):
            self._ef_ready.add(id(p))  # its ring runs in synchronize()
            return
        op, prescale, postscale = self._scales()
        wire, ctx = self._compression.compress(p.grad)
        h = allreduce_async_(wire, op=op, prescale_factor=prescale,
                             postscale_factor=postscale)
        self._handles[id(p)] = (h, ctx, wire, p)

    def synchronize(self) -> None:
        """Wait for every outstanding gradient allreduce and leave the
        reduced gradients in ``p.grad``.

        A parameter whose hook did not fire this round (a branch the data
        skipped) is reduced here with its current, possibly zero, gradient,
        so every rank issues the same collectives in the same order.  The
        quantized rings of error feedback run here, after the plain
        reductions have been issued, in parameter order."""
        for p in self._requires_update:
            if id(p) in self._handles or id(p) in self._ef_ready:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self._passes[id(p)] = 0
            self._allreduce_grad_async(p)
        try:
            for p in self._requires_update:
                if id(p) in self._ef_ready:
                    self._reduce_with_error_feedback(p)
            for h, ctx, wire, p in self._handles.values():
                restored = self._compression.decompress(synchronize(h), ctx)
                if restored.data_ptr() != p.grad.data_ptr():
                    with torch.no_grad():
                        p.grad.copy_(restored)
        finally:
            self._handles.clear()
            self._ef_ready.clear()

    def _reduce_with_error_feedback(self, p: torch.nn.Parameter) -> None:
        residual = self.state.get(p, {}).get("ef_residual")
        # + 0.0 where no residual is kept yet: adding the zero residual
        # turns -0.0 into +0.0, as the reference's zero-initialised one does.
        corrected = p.grad + (0.0 if residual is None else residual)
        reduced = _ops.quantized_allreduce(corrected, self._op,
                                           min_bytes=self._ef_min_bytes,
                                           codec=self._ef_codec)
        self._ef_residuals[p] = corrected - _qz.fake_quantize(
            corrected, self._ef_codec)
        with torch.no_grad():
            p.grad.copy_(reduced)

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Inside this context ``step()`` skips the implicit synchronize,
        for callers that invoked :meth:`synchronize` themselves."""
        self._should_sync = False
        try:
            yield
        finally:
            self._should_sync = True

    def step(self, closure=None):
        if self._should_sync:
            self.synchronize()
        loss = super(self.__class__, self).step(closure)
        for p, residual in self._ef_residuals.items():
            self.state[p]["ef_residual"] = residual
        self._ef_residuals.clear()
        return loss

    def zero_grad(self, *args, **kwargs):
        if self._handles or self._ef_ready:
            raise AssertionError(
                "zero_grad called with allreduces in flight; call step() "
                "or synchronize() first")
        self._passes = {}
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters: Optional[
                             Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = ReduceOp.AVERAGE,
                         gradient_predivide_factor: float = 1.0,
                         process_set=None,
                         num_groups: Optional[int] = None,
                         groups=None,
                         shard_optimizer_states: bool = False,
                         device_compression: Optional[str] = None
                         ) -> torch.optim.Optimizer:
    """Wrap a torch optimizer so gradients are averaged across ranks during
    backward (reference factory: horovod/torch/optimizer.py).

    ``device_compression=None`` follows HOROVOD_WIRE_COMPRESSION's
    ``device=`` plane; ``"none"`` turns error feedback off whatever the
    environment says.  As in the reference, an active codec refuses
    ``compression`` other than none, ``gradient_predivide_factor`` and ops
    other than Average and Sum, and an explicit one refuses
    ``backward_passes_per_step`` > 1; a codec from the environment leaves
    accumulating optimizers on the plain path."""
    later = {
        "process_set": (process_set is not None,
                        "the negotiated core binding (ROADMAP Queue 1 item 1)"),
        "num_groups/groups": (num_groups is not None or groups is not None,
                              "grouped fusion in the eager spine "
                              "(ROADMAP Queue 1 item 1)"),
        "shard_optimizer_states": (bool(shard_optimizer_states),
                                   "ZeRO-1 with the eager spine "
                                   "(ROADMAP Queue 1 item 1)"),
    }
    for arg, (asked, where) in later.items():
        if asked:
            raise NotImplementedError(
                f"DistributedOptimizer({arg}=...) arrives with {where}, a "
                "later slice of the port")
    codec = device_compression
    if codec is None:
        codec = _ops._device_codec_defaults()[0]
    codec = (codec or "none").lower()
    if codec not in _qz.DEVICE_WIRE_CODECS:
        raise ValueError("device_compression must be one of "
                         f"{_qz.DEVICE_WIRE_CODECS}, got {codec!r}")
    if codec != "none":
        if compression is not Compression.none:
            raise ValueError(
                f"device_compression={codec!r} already quantizes the wire; "
                "combine it with Compression.none")
        if backward_passes_per_step != 1:
            if device_compression is not None:
                raise ValueError(
                    f"device_compression={codec!r} requires "
                    "backward_passes_per_step=1 (error feedback needs to "
                    "see every communicated gradient)")
            codec = "none"
        elif gradient_predivide_factor != 1.0:
            raise ValueError(f"device_compression={codec!r} does not "
                             "support gradient_predivide_factor")
        elif ReduceOp(op) not in (ReduceOp.AVERAGE, ReduceOp.SUM):
            raise ValueError(f"device_compression={codec!r} supports "
                             "op=Average or Sum")
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, gradient_predivide_factor,
               codec)
