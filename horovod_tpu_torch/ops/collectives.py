"""Collectives on device tensors through ``torch.distributed``.

Port of the uncompressed half of ``horovod_tpu/ops/collectives.py``: where
the JAX package lowers a collective to ``psum``/``all_gather`` over ICI
inside ``jit``, this module issues the NCCL (on a card) or gloo (on the CPU)
collective of the rank's process group.  Tensors stay where they are: no
staging through host memory.

Without the negotiated core (a later slice), ranks match collectives by the
order they issue them, as ``torch.distributed`` requires.  The optimizer's
gradient hooks fire in autograd order, which is the same on every rank of
one program.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from .. import basics
from ..wire import ReduceOp

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


class Handle:
    """An in-flight collective: ``wait()`` returns its result tensor."""

    __slots__ = ("_work", "_result", "_finish", "_done")

    def __init__(self, work, result: torch.Tensor,
                 finish: Optional[Callable[[], Any]] = None):
        self._work = work
        self._result = result
        self._finish = finish
        self._done = False

    def poll(self) -> bool:
        return self._done or self._work is None or self._work.is_completed()

    def wait(self) -> torch.Tensor:
        if not self._done:
            if self._work is not None:
                self._work.wait()
            if self._finish is not None:
                out = self._finish()
                if out is not None:
                    self._result = out
            self._done = True
        return self._result


def _check_process_set(process_set) -> None:
    if process_set is not None:
        raise NotImplementedError(
            "process sets arrive with the negotiated core binding, a later "
            "slice of the port (ROADMAP Queue 1 item 1)")


def _comm_tensor(tensor: torch.Tensor):
    """The tensor the backend can take, and how to write it back.

    NCCL only moves device tensors; a CPU tensor (an optimizer's step
    counter, say) rides a device copy that is written back afterwards."""
    rt = basics._get()
    if rt.backend == "nccl" and tensor.device.type != "cuda":
        return tensor.to(rt.device), True
    return tensor, False


def allreduce_async_(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set=None) -> Handle:
    """Reduce ``tensor`` in place across ranks; returns a handle.

    ``Average`` is a sum divided by the world size after the wire, folded
    into the postscale (the reference's handling)."""
    _check_process_set(process_set)
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum arrives with the negotiated core, a later slice")
    if op == ReduceOp.AVERAGE and not (tensor.is_floating_point()
                                       or tensor.is_complex()):
        raise TypeError(
            f"Average is not defined on {tensor.dtype} tensors; use op=Sum")
    comm, copied = _comm_tensor(tensor)
    if prescale_factor != 1.0:
        comm.mul_(prescale_factor)
    work = dist.all_reduce(comm, op=_DIST_OPS[op], async_op=True)
    post = postscale_factor
    if op == ReduceOp.AVERAGE:
        post = post / basics.size()

    def finish():
        if post != 1.0:
            comm.mul_(post)
        if copied:
            tensor.copy_(comm)

    return Handle(work, tensor, finish)


def allreduce_async(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set=None) -> Handle:
    """Out-of-place async allreduce: ``tensor`` is left unchanged."""
    return allreduce_async_(tensor.clone(), op, prescale_factor,
                            postscale_factor, process_set)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     process_set=None) -> Handle:
    """Overwrite ``tensor`` with ``root_rank``'s value, in place."""
    _check_process_set(process_set)
    if not 0 <= root_rank < basics.size():
        raise ValueError(f"root_rank {root_rank} outside world of "
                         f"{basics.size()}")
    comm, copied = _comm_tensor(tensor)
    work = dist.broadcast(comm, src=root_rank, async_op=True)
    finish = (lambda: tensor.copy_(comm)) if copied else None
    return Handle(work, tensor, finish)


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    process_set=None) -> Handle:
    return broadcast_async_(tensor.clone(), root_rank, process_set)


def allgather_async(tensor: torch.Tensor, process_set=None) -> Handle:
    """Concatenate every rank's tensor along dim 0; ranks may differ in
    dim 0 (sizes are exchanged first, rows padded to the largest)."""
    _check_process_set(process_set)
    n = basics.size()
    src, _ = _comm_tensor(tensor.contiguous())
    if src.dim() == 0:
        src = src.reshape(1)
    rows = torch.tensor([src.shape[0]], dtype=torch.int64, device=src.device)
    all_rows = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(all_rows, rows)
    counts = [int(r.item()) for r in all_rows]
    top = max(counts)
    if src.shape[0] < top:
        pad = src.new_zeros((top - src.shape[0],) + tuple(src.shape[1:]))
        src = torch.cat([src, pad])
    parts = [torch.empty_like(src) for _ in range(n)]
    work = dist.all_gather(parts, src, async_op=True)

    def finish():
        return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(
            tensor.device)

    return Handle(work, tensor, finish)


def barrier(process_set=None) -> None:
    _check_process_set(process_set)
    dist.barrier()


def broadcast_object(obj: Any, root_rank: int = 0,
                     process_set=None) -> Any:
    """Broadcast a picklable object from ``root_rank``."""
    _check_process_set(process_set)
    box = [obj if basics.rank() == root_rank else None]
    rt = basics._get()
    dist.broadcast_object_list(
        box, src=root_rank,
        device=rt.device if rt.backend == "nccl" else None)
    return box[0]


def allgather_object(obj: Any, process_set=None) -> List[Any]:
    """Gather one picklable object per rank into a rank-ordered list."""
    _check_process_set(process_set)
    out: List[Any] = [None] * basics.size()
    dist.all_gather_object(out, obj)
    return out
