"""Differentiable collectives over a mesh axis: the counterparts of the
``lax`` collectives the JAX package's parallel layers use, each a
``torch.autograd.Function`` whose backward is the transpose JAX's AD takes
under shard_map's varying-manual-axes (vma) typing:

| primitive | forward | backward |
|---|---|---|
| :func:`ppermute` | send along ``perm`` | the inverse permutation |
| :func:`psum` (of a varying value) | sum over the axis | identity |
| :func:`ensure_varying` (pvary) | identity | sum over the axis |
| :func:`all_to_all` (tiled) | all-to-all | the reverse all-to-all |
| :func:`all_gather` (tiled) | gather | reduce-scatter |

torch has no vma types, so where JAX inserts a pvary of its own (an
invariant value meeting a varying one) the port inserts none: a replicated
parameter's gradient on a rank is that rank's part, and the sum of the
parts over the axis is JAX's gradient.  The layers call
:func:`ensure_varying` where the reference's argument is replicated by
contract (``column_parallel_dense``'s input, ``gpipe``'s microbatches).

Transfers go through the axis's ``GroupRing`` (``ops/collectives.py``):
point-to-point over the axis's process group, staged through host memory
when the group is gloo.  16-bit floats cross as their ``int16`` bits, never
cast.  Every rank of the axis must call each function in the same order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import Axis, axis as _axis

AxisLike = Union[str, Axis]
_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def resolve(axis_name: AxisLike) -> Axis:
    return axis_name if isinstance(axis_name, Axis) else _axis(axis_name)


def axis_size(axis_name: AxisLike) -> int:
    return resolve(axis_name).size


def axis_index(axis_name: AxisLike) -> int:
    return resolve(axis_name).index


def _to_wire(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    bits = _BITS.get(x.dtype)
    x = x.contiguous()
    return (x.view(bits) if bits is not None else x).to(ax.ring.wire)


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    w = w.to(like.device)
    return w.view(like.dtype) if like.dtype in _BITS else w


def _send_recv(ax: Axis, tensors: Sequence[torch.Tensor],
               dst: Optional[int], src: Optional[int]
               ) -> List[Optional[torch.Tensor]]:
    """Send ``tensors`` to position ``dst`` and receive tensors of their
    shapes from position ``src`` of the axis, in one batch; either may be
    None.  Returns the received tensors (None when ``src`` is None)."""
    got = ax.ring.exchange([_to_wire(t, ax) for t in tensors], dst, src)
    return [None if g is None else _from_wire(g, t)
            for g, t in zip(got, tensors)]


def _permute(ax: Axis, tensors, perm: Sequence[Tuple[int, int]]):
    """``lax.ppermute`` of each tensor: position s's value lands on
    position d for every (s, d) in ``perm``; a position that receives
    nothing gets zeros."""
    me = ax.index
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    if dst == me and src == me:
        return [t.clone() for t in tensors]
    got = _send_recv(ax, tensors, dst, src)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(got, tensors)]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, perm, *tensors):
        ctx.ax, ctx.perm = ax, perm
        return tuple(_permute(ax, tensors, perm))

    @staticmethod
    def backward(ctx, *grads):
        inverse = [(d, s) for s, d in ctx.perm]
        return (None, None) + tuple(_permute(ctx.ax, grads, inverse))


def ppermute(tensors, axis_name: AxisLike, perm: Sequence[Tuple[int, int]]):
    """``lax.ppermute`` over the axis, for one tensor or a tuple of them.
    A tuple moves in one autograd node and one batch of transfers, so its
    backward is one exchange too: two nodes could run their blocking
    exchanges in different orders on two ranks."""
    ax = resolve(axis_name)
    single = isinstance(tensors, torch.Tensor)
    items = (tensors,) if single else tuple(tensors)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if ax.size == 1:
        out = tuple(_permute(ax, items, perm))
    else:
        out = _PPermute.apply(ax, perm, *items)
    return out[0] if single else tuple(out)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *others):
        ctx.like = [(t.shape, t.dtype, t.device) for t in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.like))


def tie(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``x``, with ``others`` reaching the loss through it with zero
    gradients.  A rank that leaves a collective's output unused still runs
    the collective's backward, in step with the ranks that use theirs (the
    reference's ``where`` and ``switch`` keep every branch in its one
    program)."""
    return _Tie.apply(x, *others)


def _all_reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    w = x.contiguous().to(ax.ring.wire, copy=True)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=ax.ring.group)
    return w.to(x.device)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


def psum(x: torch.Tensor, axis_name: AxisLike) -> torch.Tensor:
    """Sum of a varying value over the axis; the result is replicated and
    its gradient passes through unchanged (vma's transpose of psum)."""
    ax = resolve(axis_name)
    return x if ax.size == 1 else _PSum.apply(x, ax)


def ensure_varying(x: torch.Tensor, axis_name: AxisLike) -> torch.Tensor:
    """pvary: a replicated value taken as this rank's; identity forward,
    its gradient summed over the axis."""
    ax = resolve(axis_name)
    return x if ax.size == 1 else _PVary.apply(x, ax)


def _a2a(ax: Axis, x: torch.Tensor, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all: chunk d of ``split_axis`` goes to position d, the
    chunks received are concatenated along ``concat_axis`` in position
    order.  Round t sends to position ``me + t`` and receives from
    ``me - t``: one exchange a round."""
    n, me = ax.size, ax.index
    chunks = list(torch.chunk(x, n, dim=split_axis))
    got = [None] * n
    got[me] = chunks[me]
    for t in range(1, n):
        dst, src = (me + t) % n, (me - t) % n
        got[src] = _send_recv(ax, [chunks[dst]], dst, src)[0]
    return torch.cat(got, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.args = (ax, split_axis, concat_axis)
        return _a2a(ax, x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ax, split_axis, concat_axis = ctx.args
        return _a2a(ax, g, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, axis_name: AxisLike, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``; raises ValueError when the axis
    size does not divide ``x.shape[split_axis]``."""
    ax = resolve(axis_name)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % ax.size:
        raise ValueError(
            f"all_to_all: dim {split_axis} of shape {tuple(x.shape)} is not "
            f"divisible by axis {ax.name!r} size {ax.size}")
    if ax.size == 1:
        return x
    return _AllToAll.apply(x, ax, split_axis, concat_axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.args = (ax, dim)
        w = _to_wire(x, ax)
        parts = [torch.empty_like(w) for _ in range(ax.size)]
        dist.all_gather(parts, w, group=ax.ring.group)
        return torch.cat([_from_wire(p, x) for p in parts], dim=dim)

    @staticmethod
    def backward(ctx, g):
        ax, dim = ctx.args
        rows = g.movedim(dim, 0).contiguous()
        w = rows.to(ax.ring.wire)
        out = torch.empty((w.shape[0] // ax.size,) + tuple(w.shape[1:]),
                          dtype=w.dtype, device=w.device)
        dist.reduce_scatter_tensor(out, w, op=dist.ReduceOp.SUM,
                                   group=ax.ring.group)
        return out.to(g.device).movedim(0, dim), None, None


def all_gather(x: torch.Tensor, axis_name: AxisLike,
               axis: int = 0) -> torch.Tensor:
    """``lax.all_gather(..., axis=axis, tiled=True)``: every rank's ``x``
    concatenated along ``axis`` in position order; the gradient is this
    rank's slice of the cotangents summed over the axis."""
    ax = resolve(axis_name)
    if ax.size == 1:
        return x
    return _AllGather.apply(x, ax, axis % x.dim())
