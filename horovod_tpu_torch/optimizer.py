"""Grad-hook DistributedOptimizer for torch models.

Reference: horovod/torch/optimizer.py; port of
``horovod_tpu/torch/optimizer.py`` with the error feedback of
``horovod_tpu/optimizer.py:DistributedOptimizer``.  A hook on every
parameter fires when autograd has accumulated that parameter's gradient and
enqueues an async in-place allreduce of it on the negotiated spine at once,
under the parameter's name (``allreduce.noname.<i>`` by position without
``named_parameters``), so negotiation and fusion overlap the rest of the
backward pass; ``step()`` waits for every outstanding reduction and then
runs the wrapped optimizer.  ``process_set=`` reduces over a set's ranks.

``num_groups=n`` (contiguous chunks of the parameters in registration
order) or ``groups=[[params...], ...]`` makes fusion groups: a group is
enqueued when every member's gradient is ready and negotiates as one
atomic unit, under a name derived from its members' names.

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
Ineligible gradients take the negotiated allreduce and keep a zero
residual.  The error-feedback rings run in ``synchronize()`` on the
caller's thread, on the caller's process group (``basics.caller_group``),
so they never interleave with the executor's collectives.

Like the reference, the factory builds a dynamic subclass of the wrapped
optimizer's own class, so the result isinstance-checks as (say)
``torch.optim.AdamW`` and keeps working with LR schedulers.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Iterable, Optional, Tuple

import torch

from . import mpi_ops
from .compression import Compression
from .ops import collectives as _ops
from .ops import quantize as _qz
from .process_sets import ProcessSet, effective_size
from .wire import ReduceOp


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 gradient_predivide_factor: float = 1.0,
                 process_set: Optional[ProcessSet] = None,
                 num_groups: Optional[int] = None, groups=None,
                 ef_codec: str = "none"):
        super(self.__class__, self).__init__(params)
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if gradient_predivide_factor != 1.0 and op != ReduceOp.AVERAGE:
            raise ValueError(
                "gradient_predivide_factor is only supported with op=Average")
        named_parameters = list(named_parameters or [])
        if len(named_parameters) != len({n for n, _ in named_parameters}):
            raise ValueError("named_parameters contains duplicate names")
        all_params = [p for group in self.param_groups
                      for p in group["params"]]
        named = {id(p): name for name, p in named_parameters}
        # Names must match across ranks for negotiation: the fallback is
        # positional, not id()-based.
        self._param_names = {
            id(p): named.get(id(p), f"allreduce.noname.{i}")
            for i, p in enumerate(all_params)}
        self._p_by_id = {id(p): p for p in all_params}
        self._requires_update = [p for p in all_params if p.requires_grad]
        self._compression = compression
        self._bpps = int(backward_passes_per_step)
        self._op = ReduceOp(op)
        self._predivide = float(gradient_predivide_factor)
        self._process_set = process_set
        self._handles: dict = {}  # param id -> (handle, ctx, wire tensor, p)
        self._passes: dict = {}   # param id -> local backward passes
        # Fusion groups (reference: num_groups/groups, group_table.cc).
        if groups is not None and num_groups is not None:
            raise ValueError("specify either num_groups or groups, not both")
        self._group_of: dict = {}      # pid -> group index
        self._group_members: list = []  # group -> [pid] in fixed order
        self._group_fired: list = []   # group -> pids locally ready
        if groups is not None:
            for members in groups:
                self._add_group([id(p) for p in members])
        elif num_groups:
            # Contiguous chunks in registration order (upstream's
            # split_list): groups late in backward enqueue while earlier
            # layers still compute.
            pids = [id(p) for p in self._requires_update]
            n = min(max(1, int(num_groups)), max(1, len(pids)))
            per, extra = divmod(len(pids), n)
            off = 0
            for gi in range(n):
                take = per + (1 if gi < extra else 0)
                if take:
                    self._add_group(pids[off:off + take])
                off += take
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

    def _add_group(self, pids) -> None:
        g = len(self._group_members)
        updatable = {id(p) for p in self._requires_update}
        for pid in pids:
            if pid in self._group_of:
                raise ValueError("a parameter appears in multiple groups")
            if pid not in updatable:
                raise ValueError(
                    "groups= contains a tensor that is not a requires-grad "
                    "optimizer parameter: a frozen member never fires its "
                    "hook, so its group could never complete")
            self._group_of[pid] = g
        self._group_members.append(list(pids))
        self._group_fired.append(set())

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
                    self._predivide / effective_size(self._process_set))
        return self._op, 1.0 / self._bpps, 1.0

    def _ef_eligible(self, p: torch.nn.Parameter) -> bool:
        return self._ef_codec != "none" and \
            _ops.quantized_collective_eligible(
                p.grad, effective_size(self._process_set),
                self._ef_min_bytes)

    def _allreduce_grad_async(self, p: torch.nn.Parameter) -> None:
        pid = id(p)
        if p.grad.is_sparse:
            raise NotImplementedError(
                "sparse gradients are not ported yet (ROADMAP Queue 1 "
                "item 1)")
        g = self._group_of.get(pid)
        if self._ef_eligible(p):
            self._ef_ready.add(pid)  # its ring runs in synchronize()
        if g is not None:
            # Enqueued once every member's gradient is locally ready; the
            # group then negotiates atomically.
            self._group_fired[g].add(pid)
            if len(self._group_fired[g]) == len(self._group_members[g]):
                self._enqueue_group(g)
            return
        if pid in self._ef_ready:
            return
        op, prescale, postscale = self._scales()
        wire, ctx = self._compression.compress(p.grad)
        h = mpi_ops.allreduce_async_(
            wire, name=self._param_names[pid], op=op,
            prescale_factor=prescale, postscale_factor=postscale,
            process_set=self._process_set)
        self._handles[pid] = (h, ctx, wire, p)

    def _group_name(self, g: int) -> str:
        # From the members' parameter names, which match across ranks, so
        # two optimizers in one process never share a group key.
        sig = ",".join(self._param_names[pid]
                       for pid in self._group_members[g])
        return "hvd.grouped." + hashlib.sha1(sig.encode()).hexdigest()[:12]

    def _enqueue_group(self, g: int) -> None:
        # Members that ride error feedback are not in the collective; every
        # rank drops the same ones (eligibility is shape and dtype).
        members = [pid for pid in self._group_members[g]
                   if pid not in self._ef_ready]
        op, prescale, postscale = self._scales()
        comp = [self._compression.compress(self._p_by_id[pid].grad)
                for pid in members]
        if members:
            handles = mpi_ops.grouped_allreduce_async_(
                [t for t, _ in comp], name=self._group_name(g), op=op,
                prescale_factor=prescale, postscale_factor=postscale,
                process_set=self._process_set)
            for pid, h, (t, ctx) in zip(members, handles, comp):
                self._handles[pid] = (h, ctx, t, self._p_by_id[pid])
        self._group_fired[g].clear()

    def synchronize(self) -> None:
        """Wait for every outstanding gradient allreduce and leave the
        reduced gradients in ``p.grad``.

        A parameter whose hook did not fire this round (a branch the data
        skipped) is reduced here with its current, possibly zero, gradient,
        so every rank negotiates the same collectives.  The quantized rings
        of error feedback run here, in parameter order."""
        for p in self._requires_update:
            pid = id(p)
            if pid in self._handles or pid in self._ef_ready:
                continue
            g = self._group_of.get(pid)
            if g is not None and pid in self._group_fired[g]:
                continue  # its group completes with the fill-ins below
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self._passes[pid] = 0
            self._allreduce_grad_async(p)
        try:
            for p in self._requires_update:
                if id(p) in self._ef_ready:
                    self._reduce_with_error_feedback(p)
            for h, ctx, wire, p in self._handles.values():
                restored = self._compression.decompress(
                    mpi_ops.synchronize(h), ctx)
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
        for fired in self._group_fired:
            fired.clear()  # zeroed grads invalidate partial group fires
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
    accumulating optimizers on the plain path.  Error feedback runs over
    the whole world: it refuses ``process_set``."""
    if process_set is not None and not isinstance(process_set, ProcessSet):
        raise TypeError(f"process_set must be a ProcessSet, got "
                        f"{type(process_set).__name__}")
    if shard_optimizer_states:
        raise NotImplementedError(
            "DistributedOptimizer(shard_optimizer_states=...) arrives with "
            "ZeRO-1, a later slice of the port (ROADMAP Queue 1 item 1)")
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
        elif process_set is not None:
            if device_compression is not None:
                raise ValueError(f"device_compression={codec!r} reduces "
                                 "over the whole world; it takes no "
                                 "process_set")
            codec = "none"
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, gradient_predivide_factor,
               process_set, num_groups, groups, codec)
