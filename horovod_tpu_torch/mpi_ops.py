"""The eager collective API: ``hvd.allreduce``, ``hvd.broadcast``, ...

Reference: horovod/torch/mpi_ops.py and ``horovod_tpu/torch/mpi_ops.py``
(the same names and arguments).  The async forms return a handle that
``synchronize`` waits on; the trailing-underscore forms work in place.
``name`` is accepted for signature parity: without the negotiated core
(a later slice) ranks match collectives by issue order.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from .compression import Compression
from .ops import collectives as _ops
from .ops.collectives import Handle
from .wire import Adasum, Average, Max, Min, Product, ReduceOp, Sum  # noqa: F401


def _resolve_op(op: Optional[ReduceOp], average: Optional[bool]) -> ReduceOp:
    if average is not None:
        if op is not None:
            raise ValueError(
                "specify either op or the deprecated average=, not both")
        return ReduceOp.AVERAGE if average else ReduceOp.SUM
    return ReduceOp.AVERAGE if op is None else ReduceOp(op)


def allreduce_async_(tensor: torch.Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None,
                     op: Optional[ReduceOp] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set=None) -> Handle:
    """In-place async allreduce: ``synchronize`` returns ``tensor``, now
    holding the reduction."""
    return _ops.allreduce_async_(tensor, _resolve_op(op, average),
                                 prescale_factor, postscale_factor,
                                 process_set)


def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set=None) -> Handle:
    return _ops.allreduce_async(tensor, _resolve_op(op, average),
                                prescale_factor, postscale_factor,
                                process_set)


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, compression=Compression.none,
              op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set=None) -> torch.Tensor:
    """Average (default) or otherwise reduce ``tensor`` across ranks,
    returning a new tensor."""
    compressed, ctx = compression.compress(tensor)
    h = allreduce_async(compressed, average=average, op=op,
                        prescale_factor=prescale_factor,
                        postscale_factor=postscale_factor,
                        process_set=process_set)
    return compression.decompress(synchronize(h), ctx)


def allreduce_(tensor: torch.Tensor, average: Optional[bool] = None,
               name: Optional[str] = None, op: Optional[ReduceOp] = None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               process_set=None) -> torch.Tensor:
    """In-place synchronous allreduce."""
    return synchronize(allreduce_async_(
        tensor, average=average, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set))


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None, process_set=None) -> Handle:
    return _ops.broadcast_async_(tensor, root_rank, process_set)


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None, process_set=None) -> Handle:
    return _ops.broadcast_async(tensor, root_rank, process_set)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None, process_set=None) -> torch.Tensor:
    """Return ``root_rank``'s value of ``tensor`` (a new tensor)."""
    return synchronize(broadcast_async(tensor, root_rank,
                                       process_set=process_set))


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None, process_set=None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank,
                                        process_set=process_set))


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set=None) -> Handle:
    return _ops.allgather_async(tensor, process_set)


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    """Concatenate each rank's tensor along dim 0 (dim 0 may differ)."""
    return synchronize(allgather_async(tensor, process_set=process_set))


def synchronize(handle: Handle) -> torch.Tensor:
    """Wait for an async collective and return its result."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True once the collective behind ``handle`` has completed."""
    return handle.poll()


def barrier(process_set=None) -> None:
    _ops.barrier(process_set)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None, process_set=None) -> Any:
    return _ops.broadcast_object(obj, root_rank, process_set)


def allgather_object(obj: Any, name: Optional[str] = None,
                     process_set=None) -> List[Any]:
    return _ops.allgather_object(obj, process_set)
