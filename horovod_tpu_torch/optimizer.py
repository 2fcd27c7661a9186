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

A sparse gradient (``nn.Embedding(sparse=True)``) rides
``hvd.sparse_allreduce`` on its own, out of any fusion group;
``sparse_as_dense=True`` densifies it for the dense path instead, and
``sparse_params=[names]`` declares such parameters up front, so that a rank
whose batch skipped one still sends a zero-nnz sparse collective.  Error
feedback and ZeRO-1 take dense gradients only: a sparse one raises there
unless ``sparse_as_dense=True``.

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

``shard_optimizer_states=True`` is ZeRO-1, the counterpart of
``horovod_tpu/optimizer.py:_sharded_distributed_optimizer``: ``step()``
flattens every gradient into one fp32 vector padded to ``size * chunk``,
reduce-scatters it through the spine (Average or Sum), lets the wrapped
optimizer step on this rank's ``chunk`` of fp32 master weights (so its
momentum or moments live once across the ranks, and a bf16 model keeps
its sub-ulp updates), allgathers the master shards and casts them back
into the parameters.  :func:`clip_by_global_norm` is the torch form of
``optax.chain(hvd.clip_by_global_norm(max_norm, axis_name), inner)``.

Like the reference, the factory builds a dynamic subclass of the wrapped
optimizer's own class, so the result isinstance-checks as (say)
``torch.optim.AdamW`` and keeps working with LR schedulers.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Iterable, Optional, Tuple

import torch

from . import basics, mpi_ops
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
                 sparse_as_dense: bool = False, sparse_params=None,
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
        # Parameters whose gradients are sparse: learned from the first
        # sparse gradient a hook sees, or declared by name up front, so that
        # a rank whose batch skipped the layer still sends a (zero-nnz)
        # sparse collective and not a dense one its peers never match.
        self._sparse_as_dense = bool(sparse_as_dense)
        self._sparse_params: set = set()
        name_to_pid = {n: pid for pid, n in self._param_names.items()}
        for n in (sparse_params or ()):
            if n not in name_to_pid:
                raise ValueError(
                    f"sparse_params entry {n!r} is not a known parameter "
                    f"name")
            self._sparse_params.add(name_to_pid[n])
        if self._sparse_params and ef_codec != "none":
            raise ValueError(_ef_sparse_message(ef_codec, sparse_params))
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
            # layers still compute.  Sparse parameters ride
            # sparse_allreduce one by one.
            pids = [id(p) for p in self._requires_update
                    if id(p) not in self._sparse_params]
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
        if p.grad.is_sparse and self._sparse_as_dense:
            with torch.no_grad():
                p.grad = p.grad.to_dense()
        if p.grad.is_sparse:
            self._sparse_allreduce_async(p)
            return
        g = self._group_of.get(pid)
        if self._ef_eligible(p):
            self._ef_ready.add(pid)  # its ring runs in synchronize()
        if g is not None:
            # Enqueued once every member's gradient is locally ready; the
            # group then negotiates atomically.
            self._group_fired[g].add(pid)
            self._maybe_enqueue_group(g)
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

    def _sparse_allreduce_async(self, p: torch.nn.Parameter) -> None:
        """A sparse gradient (``nn.Embedding(sparse=True)``) rides
        ``sparse_allreduce`` on its own, under the parameter's name."""
        pid = id(p)
        if self._ef_codec != "none":
            raise ValueError(_ef_sparse_message(
                self._ef_codec, [self._param_names[pid]]))
        if self._predivide != 1.0:
            raise ValueError("gradient_predivide_factor is not supported "
                             "for sparse gradients")
        g = self._group_of.pop(pid, None)
        if g is not None:
            # Out of its fusion group (every rank drops the same member);
            # the shrunk group may be complete now.
            self._group_members[g].remove(pid)
            self._group_fired[g].discard(pid)
            self._maybe_enqueue_group(g)
        self._sparse_params.add(pid)
        grad = p.grad.coalesce()
        if self._bpps > 1:
            v = grad.values()
            v.div_(torch.tensor(self._bpps, dtype=v.dtype, device=v.device))
        token = mpi_ops.sparse_allreduce_async(
            grad, name=self._param_names[pid], op=self._op,
            process_set=self._process_set)
        self._handles[pid] = ("sparse", token, None, p)

    def _maybe_enqueue_group(self, g: int) -> None:
        if self._group_members[g] and \
                len(self._group_fired[g]) == len(self._group_members[g]):
            self._enqueue_group(g)

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
                if pid in self._sparse_params:
                    # A zero-nnz sparse contribution: the collectives the
                    # other ranks enqueue under this name are sparse too.
                    p.grad = torch.sparse_coo_tensor(
                        torch.zeros((1, 0), dtype=torch.int64),
                        torch.zeros((0,) + tuple(p.shape[1:]),
                                    dtype=p.dtype),
                        p.shape, device=p.device)
                else:
                    p.grad = torch.zeros_like(p)
            self._passes[pid] = 0
            self._allreduce_grad_async(p)
        try:
            for p in self._requires_update:
                if id(p) in self._ef_ready:
                    self._reduce_with_error_feedback(p)
            for h, ctx, wire, p in self._handles.values():
                if h == "sparse":
                    p.grad = mpi_ops.sparse_synchronize(ctx)
                    continue
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

    def set_backward_passes_per_step(self, passes: int) -> None:
        """Reduce every ``passes`` backward passes from now on (at least
        one), and restart the count of each parameter's passes."""
        passes = max(1, int(passes))
        if passes != 1 and self._ef_codec != "none":
            raise ValueError(
                f"device_compression={self._ef_codec!r} requires "
                "backward_passes_per_step=1 (error feedback needs to see "
                "every communicated gradient)")
        self._bpps = passes
        self._passes = {}

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


def _ef_sparse_message(codec: str, names) -> str:
    return (f"device_compression={codec!r} (error feedback) cannot reduce "
            f"the sparse gradients of {sorted(names)}: its quantized ring "
            "takes dense fp32 gradients; pass sparse_as_dense=True, or "
            "device_compression='none'")


class _ShardedDistributedOptimizer(torch.optim.Optimizer):
    """ZeRO-1 (see the module docstring).  The optimizer's own
    ``param_groups`` hold this rank's slices of the fp32 master shard, one
    slice per group of the wrapped optimizer with that group's
    hyperparameters (empty where the shard misses the group), so LR
    schedulers and ``state_dict()`` work on what this rank steps.  The
    master shard is taken from the parameters at the first step, after any
    ``broadcast_parameters``; later the parameters must change only
    through this optimizer, as in the reference."""

    def __init__(self, param_groups, named_parameters, op: ReduceOp,
                 sparse_as_dense: bool = False):
        self._zero_params = [p for g in param_groups for p in g["params"]]
        self._zero_sparse_as_dense = bool(sparse_as_dense)
        if not self._zero_params:
            raise ValueError(
                "shard_optimizer_states=True needs a non-empty parameter "
                "list (nothing to shard)")
        names = {id(p): n for n, p in (named_parameters or [])}
        self._zero_names = [names.get(id(p), f"allreduce.noname.{i}")
                            for i, p in enumerate(self._zero_params)]
        sig = ",".join(self._zero_names)
        self._zero_name = "hvd.zero1." + hashlib.sha1(
            sig.encode()).hexdigest()[:12]
        self._zero_op = ReduceOp(op)
        self._zero_world = basics.size() if basics.is_initialized() else 1
        total = sum(p.numel() for p in self._zero_params)
        self._zero_chunk = -(-total // self._zero_world)
        rank = basics.rank() if basics.is_initialized() else 0
        lo = rank * self._zero_chunk
        device = self._zero_params[0].device
        self._zero_master = torch.zeros(self._zero_chunk,
                                        dtype=torch.float32, device=device)
        self._zero_grad = torch.zeros_like(self._zero_master)
        self._zero_synced = False
        groups, start = [], 0
        for gi, g in enumerate(param_groups):
            end = start + sum(p.numel() for p in g["params"])
            if gi == len(param_groups) - 1:
                end = self._zero_world * self._zero_chunk  # and the padding
            a, b = max(start, lo) - lo, min(end, lo + self._zero_chunk) - lo
            params = []
            if a < b:
                alias = torch.nn.Parameter(self._zero_master[a:b])
                alias.grad = self._zero_grad[a:b]
                params.append(alias)
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": params})
            start = end
        super(self.__class__, self).__init__(groups)

    def _zero_flat(self, tensors) -> torch.Tensor:
        flat = torch.zeros(self._zero_world * self._zero_chunk,
                           dtype=torch.float32, device=self._zero_master.device)
        off = 0
        for t in tensors:
            flat[off:off + t.numel()] = t.reshape(-1)
            off += t.numel()
        return flat

    def _zero_own(self, flat: torch.Tensor) -> torch.Tensor:
        rank = basics.rank() if basics.is_initialized() else 0
        return flat[rank * self._zero_chunk:(rank + 1) * self._zero_chunk]

    def synchronize(self) -> None:
        """Reduce-scatter the gradients into this rank's shard (the master
        slices' ``.grad``)."""
        grads = []
        for p, name in zip(self._zero_params, self._zero_names):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            if g.is_sparse:
                if not self._zero_sparse_as_dense:
                    raise ValueError(
                        "shard_optimizer_states reduce-scatters one dense "
                        f"fp32 vector; the gradient of {name!r} is sparse: "
                        "pass sparse_as_dense=True")
                g = g.to_dense()
            grads.append(g)
        flat = self._zero_flat(grads)
        with torch.no_grad():
            self._zero_grad.copy_(mpi_ops.reducescatter(
                flat, op=self._zero_op, name=f"{self._zero_name}.grads"))

    def step(self, closure=None):
        with torch.no_grad():
            if not self._zero_synced:
                self._zero_master.copy_(self._zero_own(self._zero_flat(
                    [p.detach() for p in self._zero_params])))
                self._zero_synced = True
        self.synchronize()
        loss = super(self.__class__, self).step(closure)
        with torch.no_grad():
            full = mpi_ops.allgather(self._zero_master,
                                     name=f"{self._zero_name}.master")
            off = 0
            for p in self._zero_params:
                n = p.numel()
                p.copy_(full[off:off + n].view(p.shape))
                off += n
        return loss

    def zero_grad(self, set_to_none: bool = True):
        for p in self._zero_params:
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()
        self._zero_grad.zero_()

    def shard_bytes(self) -> dict:
        """Bytes this rank keeps: the wrapped optimizer's state of its shard
        (``state``: momentum, moments) and the fp32 master shard
        (``master``)."""
        state = sum(v.numel() * v.element_size()
                    for st in self.state.values() for v in st.values()
                    if isinstance(v, torch.Tensor) and v.dim() > 0)
        return {"state": state, "master": self._zero_master.numel() *
                self._zero_master.element_size()}


_clip_count = 0


def clip_by_global_norm(optimizer: torch.optim.Optimizer, max_norm: float,
                        process_set: Optional[ProcessSet] = None
                        ) -> torch.optim.Optimizer:
    """Clip the gradients ``optimizer`` steps on by their global norm before
    each step: the torch form of ``horovod_tpu``'s
    ``optax.chain(hvd.clip_by_global_norm(max_norm, axis_name), inner)``.

    ``process_set`` plays ``axis_name``'s part: None clips by the norm of
    this rank's gradients (optax's ``clip_by_global_norm``); a ProcessSet
    (``hvd.global_process_set`` for every rank) first sums the squared norm
    over its ranks through the spine, which the wrapped optimizer of
    ``DistributedOptimizer(..., shard_optimizer_states=True)`` needs: each
    rank then holds 1/n of the gradient.  The scale is ``min(1, max_norm /
    max(norm, 1e-12))``, cast to each gradient's dtype.  ``optimizer`` is
    re-classed in place (a subclass of its own class) and returned."""
    global _clip_count
    base = optimizer.__class__
    cls = type(base.__name__, (base,), {"step": _clipped_step})
    cls._clip_cls = cls
    cls._clip = (float(max_norm), process_set,
                 f"hvd.clip_by_global_norm.{_clip_count}")
    _clip_count += 1
    optimizer.__class__ = cls
    return optimizer


def _clipped_step(self, closure=None):
    max_norm, process_set, name = self._clip
    grads = [p.grad for g in self.param_groups for p in g["params"]
             if p.grad is not None]
    device = grads[0].device if grads else None
    local = torch.zeros(1, dtype=torch.float32, device=device)
    for g in grads:
        local += g.float().square().sum()
    if process_set is not None:
        local = mpi_ops.allreduce(local, op=mpi_ops.Sum, name=name,
                                  process_set=process_set)
    norm = torch.sqrt(local)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return super(self._clip_cls, self).step(closure)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters: Optional[
                             Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = ReduceOp.AVERAGE,
                         gradient_predivide_factor: float = 1.0,
                         process_set=None,
                         sparse_as_dense: bool = False,
                         sparse_params=None,
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
    codec = device_compression
    if codec is None:
        codec = _ops._device_codec_defaults()[0]
    codec = (codec or "none").lower()
    if codec not in _qz.DEVICE_WIRE_CODECS:
        raise ValueError("device_compression must be one of "
                         f"{_qz.DEVICE_WIRE_CODECS}, got {codec!r}")
    if shard_optimizer_states:
        return _sharded(optimizer, named_parameters, compression,
                        backward_passes_per_step, op,
                        gradient_predivide_factor, process_set,
                        device_compression, codec, sparse_as_dense,
                        sparse_params)
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
               process_set, sparse_as_dense, sparse_params, num_groups,
               groups, codec)


def _sharded(optimizer, named_parameters, compression,
             backward_passes_per_step, op, gradient_predivide_factor,
             process_set, device_compression, codec, sparse_as_dense,
             sparse_params):
    """ZeRO-1's refusals, with the reference's messages; a codec from the
    environment just opts out."""
    if codec != "none" and device_compression is not None:
        raise ValueError(
            f"device_compression={codec!r} is incompatible with "
            "shard_optimizer_states (the sharded path reduce-scatters "
            "exactly once; quantizing it is future work)")
    if compression is not Compression.none:
        raise ValueError(
            "shard_optimizer_states is incompatible with compression "
            "(the shard math runs in fp32 anyway)")
    if backward_passes_per_step != 1:
        raise ValueError("shard_optimizer_states requires "
                         "backward_passes_per_step=1")
    if gradient_predivide_factor != 1.0:
        raise ValueError("shard_optimizer_states does not support "
                         "gradient_predivide_factor")
    if ReduceOp(op) not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError(
            "shard_optimizer_states supports op=Average or Sum")
    if process_set is not None:
        raise ValueError(
            "shard_optimizer_states does not support process_set; it "
            "shards over every rank")
    if sparse_params:
        raise ValueError(
            "shard_optimizer_states reduce-scatters one dense fp32 vector; "
            f"it takes no sparse_params ({list(sparse_params)}): pass "
            "sparse_as_dense=True")
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_ShardedDistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, list(named_parameters or []), op,
               sparse_as_dense)
