"""The eager collective API: ``hvd.allreduce``, ``hvd.alltoall``, ...

Port of ``horovod_tpu/torch/mpi_ops.py`` (reference: horovod/torch/
mpi_ops.py): the same names, arguments and handle contract.  Every op is
enqueued on the negotiated spine (``context.HorovodContext``) under its
name -- ``name=None`` takes the core's deterministic per-op counter, so
unnamed ops must be issued in the same order on every rank -- and
``process_set=`` selects the ranks.  A tensor on the rank's device rides
the device plane (NCCL, or gloo on the CPU); a numpy array, or a CPU tensor
on a card rank, rides the core's host ring.  ``*_async`` returns an int
handle; ``synchronize(handle)`` blocks and returns the result (writing it
into the input first for the in-place ``*_`` forms); ``poll(handle)`` tests
for completion.  ``sparse_allreduce`` reduces a sparse COO tensor by
gathering every rank's indices and values.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .compression import Compression
from .context import HorovodContext
from .process_sets import ProcessSet, _resolve_psid, effective_size
from .wire import (Adasum, Average, Max, Min, OpType, Product,  # noqa: F401
                   ReduceOp, Sum)


class _Targets:
    """In-place write-back targets by handle (the reference's
    handle_manager.cc role)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._targets: dict = {}

    def register(self, handle: int, target) -> int:
        if target is not None:
            with self._lock:
                self._targets[handle] = target
        return handle

    def pop(self, handle: int):
        with self._lock:
            return self._targets.pop(handle, None)


_targets = _Targets()


def _resolve_op(op: Optional[ReduceOp], average: Optional[bool]) -> ReduceOp:
    if average is not None:
        if op is not None:
            raise ValueError(
                "specify either op or the deprecated average=, not both")
        return ReduceOp.AVERAGE if average else ReduceOp.SUM
    return ReduceOp.AVERAGE if op is None else ReduceOp(op)


def _enqueue(tensor, op_type: OpType, inplace: bool = False,
             process_set: Optional[ProcessSet] = None, **kw) -> int:
    h = HorovodContext.instance().enqueue(
        tensor, op_type, process_set_id=_resolve_psid(process_set),
        inplace=inplace, **kw)
    return _targets.register(h, tensor if inplace else None)


def _write_back(target, result):
    """Write ``result`` into the in-place ``target`` (a no-op where the
    device plane wrote it there already)."""
    if isinstance(target, np.ndarray):
        np.copyto(target, np.asarray(result).reshape(target.shape))
        return target
    if result is target:
        return target
    with torch.no_grad():  # targets may be leaves that require grad
        target.copy_(result.reshape(target.shape).to(target.device))
    return target


def synchronize(handle: int):
    """Block until the op behind ``handle`` completes and return its result
    (``(tensor, received_splits)`` for alltoall)."""
    target = _targets.pop(handle)
    result = HorovodContext.instance().synchronize(handle)
    if target is not None:
        return _write_back(target, result)
    if isinstance(result, tuple):
        data, splits = result
        return data, torch.from_numpy(np.asarray(splits).copy())
    return result


def poll(handle: int) -> bool:
    """True if the op behind ``handle`` has completed; a handle already
    synchronized is complete."""
    try:
        return HorovodContext.instance().poll(handle)
    except ValueError:
        return True


# --- allreduce -------------------------------------------------------------

def allreduce_async(tensor, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: Optional[ProcessSet] = None) -> int:
    return _enqueue(tensor, OpType.ALLREDUCE, name=name,
                    reduce_op=_resolve_op(op, average),
                    prescale_factor=prescale_factor,
                    postscale_factor=postscale_factor,
                    process_set=process_set)


def allreduce_async_(tensor, average: Optional[bool] = None,
                     name: Optional[str] = None,
                     op: Optional[ReduceOp] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set: Optional[ProcessSet] = None) -> int:
    """In-place async allreduce: ``synchronize`` leaves the reduction in
    ``tensor``."""
    return _enqueue(tensor, OpType.ALLREDUCE, inplace=True, name=name,
                    reduce_op=_resolve_op(op, average),
                    prescale_factor=prescale_factor,
                    postscale_factor=postscale_factor,
                    process_set=process_set)


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, compression=Compression.none,
              op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None):
    """Average (default) or otherwise reduce ``tensor`` across the set's
    ranks, returning a new tensor."""
    compressed, ctx = compression.compress(tensor)
    h = allreduce_async(compressed, average=average, name=name, op=op,
                        prescale_factor=prescale_factor,
                        postscale_factor=postscale_factor,
                        process_set=process_set)
    return compression.decompress(synchronize(h), ctx)


def allreduce_(tensor, average: Optional[bool] = None,
               name: Optional[str] = None, op: Optional[ReduceOp] = None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               process_set: Optional[ProcessSet] = None):
    """In-place synchronous allreduce."""
    return synchronize(allreduce_async_(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set))


def _grouped_enqueue(tensors: Sequence, op_type: OpType,
                     name: Optional[str],
                     process_set: Optional[ProcessSet],
                     inplace: bool = False, **kw) -> List[int]:
    """One atomic negotiation group (the coordinator releases it
    all-or-nothing; reference: group_table.cc); member names derive from
    the group name."""
    gkey = HorovodContext.instance().group_key_for(name)
    return [_enqueue(t, op_type, inplace=inplace, process_set=process_set,
                     name=f"{name}.{i}" if name else None, group_key=gkey,
                     group_size=len(tensors), **kw)
            for i, t in enumerate(tensors)]


def grouped_allreduce_async(tensors: Sequence,
                            average: Optional[bool] = None,
                            name: Optional[str] = None,
                            op: Optional[ReduceOp] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: Optional[ProcessSet] = None
                            ) -> List[int]:
    return _grouped_enqueue(
        tensors, OpType.ALLREDUCE, name, process_set,
        reduce_op=_resolve_op(op, average), prescale_factor=prescale_factor,
        postscale_factor=postscale_factor)


def grouped_allreduce_async_(tensors: Sequence,
                             average: Optional[bool] = None,
                             name: Optional[str] = None,
                             op: Optional[ReduceOp] = None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             process_set: Optional[ProcessSet] = None
                             ) -> List[int]:
    return _grouped_enqueue(
        tensors, OpType.ALLREDUCE, name, process_set, inplace=True,
        reduce_op=_resolve_op(op, average), prescale_factor=prescale_factor,
        postscale_factor=postscale_factor)


def grouped_allreduce(tensors: Sequence, average: Optional[bool] = None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: Optional[ProcessSet] = None) -> list:
    return [synchronize(h) for h in grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set)]


def grouped_allreduce_(tensors: Sequence, average: Optional[bool] = None,
                       name: Optional[str] = None,
                       op: Optional[ReduceOp] = None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       process_set: Optional[ProcessSet] = None) -> list:
    return [synchronize(h) for h in grouped_allreduce_async_(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set)]


# --- allgather / broadcast -------------------------------------------------

def allgather_async(tensor, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    return _enqueue(tensor, OpType.ALLGATHER, name=name,
                    process_set=process_set)


def allgather(tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None):
    """Concatenate each rank's tensor along dim 0 (dim 0 may differ)."""
    return synchronize(allgather_async(tensor, name=name,
                                       process_set=process_set))


def grouped_allgather_async(tensors: Sequence, name: Optional[str] = None,
                            process_set: Optional[ProcessSet] = None
                            ) -> List[int]:
    return _grouped_enqueue(tensors, OpType.ALLGATHER, name, process_set)


def grouped_allgather(tensors: Sequence, name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None) -> list:
    return [synchronize(h) for h in grouped_allgather_async(
        tensors, name=name, process_set=process_set)]


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    return _enqueue(tensor, OpType.BROADCAST, name=name, root_rank=root_rank,
                    process_set=process_set)


def broadcast_async_(tensor, root_rank: int, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> int:
    return _enqueue(tensor, OpType.BROADCAST, inplace=True, name=name,
                    root_rank=root_rank, process_set=process_set)


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None):
    """``root_rank``'s value of ``tensor``, as a new tensor."""
    return synchronize(broadcast_async(tensor, root_rank, name=name,
                                       process_set=process_set))


def broadcast_(tensor, root_rank: int, name: Optional[str] = None,
               process_set: Optional[ProcessSet] = None):
    return synchronize(broadcast_async_(tensor, root_rank, name=name,
                                        process_set=process_set))


# --- alltoall / reducescatter ----------------------------------------------

def alltoall_async(tensor, splits=None, name: Optional[str] = None,
                   process_set: Optional[ProcessSet] = None) -> int:
    if isinstance(splits, torch.Tensor):
        splits = splits.cpu().numpy()
    return _enqueue(tensor, OpType.ALLTOALL, name=name, splits=splits,
                    process_set=process_set)


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None) -> Tuple:
    """Send slices of dim 0 (``splits[r]`` rows to rank r of the set, an
    even split when None); returns ``(received, received_splits)``."""
    return synchronize(alltoall_async(tensor, splits=splits, name=name,
                                      process_set=process_set))


def reducescatter_async(tensor, op: ReduceOp = ReduceOp.AVERAGE,
                        name: Optional[str] = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        process_set: Optional[ProcessSet] = None) -> int:
    return _enqueue(tensor, OpType.REDUCESCATTER, name=name,
                    reduce_op=ReduceOp(op), prescale_factor=prescale_factor,
                    postscale_factor=postscale_factor,
                    process_set=process_set)


def reducescatter(tensor, op: ReduceOp = ReduceOp.AVERAGE,
                  name: Optional[str] = None, prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0,
                  process_set: Optional[ProcessSet] = None):
    """Reduce across the set's ranks and keep this rank's slice of dim 0
    (the first ``d0 % size`` ranks get one extra row)."""
    return synchronize(reducescatter_async(
        tensor, op=op, name=name, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set))


def grouped_reducescatter_async(tensors: Sequence,
                                op: ReduceOp = ReduceOp.AVERAGE,
                                name: Optional[str] = None,
                                prescale_factor: float = 1.0,
                                postscale_factor: float = 1.0,
                                process_set: Optional[ProcessSet] = None
                                ) -> List[int]:
    return _grouped_enqueue(
        tensors, OpType.REDUCESCATTER, name, process_set,
        reduce_op=ReduceOp(op), prescale_factor=prescale_factor,
        postscale_factor=postscale_factor)


def grouped_reducescatter(tensors: Sequence, op: ReduceOp = ReduceOp.AVERAGE,
                          name: Optional[str] = None,
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          process_set: Optional[ProcessSet] = None) -> list:
    return [synchronize(h) for h in grouped_reducescatter_async(
        tensors, op=op, name=name, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set)]


# --- sparse allreduce ---------------------------------------------------------

def sparse_allreduce_async(tensor: torch.Tensor, name: Optional[str] = None,
                           op: Optional[ReduceOp] = None,
                           process_set: Optional[ProcessSet] = None):
    """Start the allreduce of a sparse COO tensor; returns a token for
    :func:`sparse_synchronize`.  Two ragged allgathers are enqueued at once,
    ``{name}.idx`` with the indices transposed to (nnz, sparse_dim) and
    ``{name}.vals`` with the values; a rank that touched no row sends zero
    rows and still takes part."""
    if not tensor.is_sparse:
        raise ValueError("sparse_allreduce requires a sparse COO tensor")
    rop = _resolve_op(op, None)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("sparse_allreduce supports Sum and Average only")
    sp = tensor.coalesce()
    h_idx = allgather_async(sp.indices().t().contiguous(),
                            name=f"{name}.idx" if name else None,
                            process_set=process_set)
    h_vals = allgather_async(sp.values().contiguous(),
                             name=f"{name}.vals" if name else None,
                             process_set=process_set)
    return (h_idx, h_vals, tuple(sp.shape), rop, process_set)


def sparse_synchronize(token) -> torch.Tensor:
    """Finish :func:`sparse_allreduce_async`: every rank's (indices, values)
    summed into one coalesced sparse tensor; Average then divides the values
    by the set's size.  When the indices' gather fails, the values' handle
    is waited out and dropped before the error propagates."""
    h_idx, h_vals, shape, rop, process_set = token
    try:
        idx = synchronize(h_idx)
    except BaseException:
        try:
            synchronize(h_vals)
        except Exception:  # noqa: BLE001 - the indices' error is the one
            pass
        raise
    vals = synchronize(h_vals)
    out = torch.sparse_coo_tensor(idx.t(), vals, shape,
                                  check_invariants=False).coalesce()
    if rop == ReduceOp.AVERAGE:
        v = out.values()
        # A tensor divisor: CUDA divides by a Python scalar through its
        # reciprocal, which is not correctly rounded.
        v.div_(torch.tensor(effective_size(process_set), dtype=v.dtype,
                            device=v.device))
    return out


def sparse_allreduce(tensor: torch.Tensor, name: Optional[str] = None,
                     op: Optional[ReduceOp] = None,
                     process_set: Optional[ProcessSet] = None
                     ) -> torch.Tensor:
    """Allreduce a sparse COO tensor (the gradient of an
    ``nn.Embedding(sparse=True)``) by gathering every rank's indices and
    values and summing them: fewer bytes than the dense allreduce while the
    rows touched are few.  Average (the default) divides by the set's
    size.  Returns a coalesced sparse tensor."""
    return sparse_synchronize(sparse_allreduce_async(
        tensor, name=name, op=op, process_set=process_set))


# --- barrier / join ----------------------------------------------------------

def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every rank of the set reaches the barrier."""
    synchronize(_enqueue(np.zeros((), dtype=np.float32), OpType.BARRIER,
                         process_set=process_set))


def join() -> int:
    """This rank has no more collectives to submit: block until every rank
    has joined and return the last rank that joined.  Meanwhile the other
    ranks' Sum and Average allreduces and barriers proceed with a zero
    contribution from this one (Average still divides by the full size)."""
    ctx = HorovodContext.instance()
    ctx.join_begin()
    h = ctx.enqueue(np.zeros((), dtype=np.float32), OpType.JOIN,
                    name="__join__")
    return int(np.asarray(ctx.synchronize(h)))
