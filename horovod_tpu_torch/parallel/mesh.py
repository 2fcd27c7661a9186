"""Named mesh axes over the ranks: port of ``horovod_tpu/parallel/mesh.py``.

The JAX package names an axis of a ``jax.sharding.Mesh`` and lets XLA lower
``psum``/``ppermute``/... onto it.  The port lays the ranks of the
``torch.distributed`` world out the same way, row-major as
``np.reshape(devices, sizes)`` does, and gives every axis a process group
of its own per line of ranks along it.  A layer names its axis by string
(``cfg.sp_axis_name = "sp"``) and :func:`axis` resolves the name against
the innermost mesh entered with ``with mesh:``, else the global mesh that
``hvd.init()`` builds over the world (axis ``"hvd"``).

The groups are made by ``dist.new_group``, every rank calling it for every
line of every axis in the same order (an axis of size one needs none).
They are never the executor's group or ``basics.caller_group()``: the
optimizer's gradient hooks run collectives on the executor's thread during
backward, while a ring's backward hops run on the autograd thread, and two
threads issuing on one group can interleave differently on two ranks.
Over NCCL the two threads still drive two communicators at once, and NCCL
warns that concurrent operations on several communicators can deadlock
when ranks issue them in different orders; under gloo (two ranks on one
card, or the CPU) they cannot.  Four cards are needed to see which holds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from .. import basics
from ..ops.collectives import GroupRing

HVD_AXIS = "hvd"

_global_mesh: Optional["Mesh"] = None
# Meshes entered with ``with mesh:``, innermost last.  Process-wide, not
# per thread: a CUDA tensor's backward runs on the autograd engine's
# device thread, and a checkpointed block re-resolves its axes there.
_entered: List["Mesh"] = []


class Axis:
    """This rank's place on one mesh axis: ``index`` (the counterpart of
    ``lax.axis_index``), ``size``, the global ``ranks`` along the axis
    through this rank, and the exchange over their group (``ring``, None
    for an axis of size one)."""

    def __init__(self, name: str, ranks: Sequence[int], me: int, group):
        self.name = name
        self.ranks = [int(r) for r in ranks]
        self.size = len(self.ranks)
        self.index = self.ranks.index(int(me))
        self.ring = (GroupRing(group, self.ranks, me, basics.wire_device())
                     if self.size > 1 else None)

    def __repr__(self) -> str:
        return (f"Axis({self.name!r}, index={self.index}, size={self.size}, "
                f"ranks={self.ranks})")


class Mesh:
    """Ranks laid out on named axes.  ``ranks`` is the array of global ranks
    (the counterpart of ``Mesh.devices``), ``axis_names`` its axes and
    ``shape`` their sizes.  A rank outside the mesh holds no axis."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 axes: Dict[str, Axis]):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self._axes = axes

    def axis(self, name: str) -> Axis:
        if name not in self.shape:
            raise NameError(f"unbound axis name: {name} (mesh axes "
                            f"{self.axis_names})")
        if name not in self._axes:
            raise ValueError(f"rank {basics.rank()} is not in the mesh over "
                             f"ranks {self.ranks.reshape(-1).tolist()}")
        return self._axes[name]

    def __enter__(self) -> "Mesh":
        _entered.append(self)
        return self

    def __exit__(self, *exc) -> None:
        if _entered and _entered[-1] is self:   # reset() may have cleared it
            _entered.pop()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"


def _make_mesh(ranks: np.ndarray, names: Sequence[str]) -> Mesh:
    """Groups for every line of every axis of ``ranks``, made in the same
    order on every rank of the world (``new_group`` is collective)."""
    me = basics.rank()
    axes = {}
    for i, name in enumerate(names):
        size = ranks.shape[i]
        lines = np.moveaxis(ranks, i, -1).reshape(-1, size)
        for line in lines:
            members = [int(r) for r in line]
            group = dist.new_group(members) if size > 1 else None
            if me in members:
                axes[name] = Axis(name, members, me, group)
    return Mesh(ranks, names, axes)


def build_mesh(axis_sizes: dict, ranks: Optional[Sequence[int]] = None
               ) -> Mesh:
    """An N-D mesh from ``{"dp": 2, "sp": 2}``-style specs over the first
    ranks of ``ranks`` (default the world), row-major.  Axis order follows
    insertion order.  Every rank of the world calls it, in the same order
    as its other ``build_mesh``/``sub_mesh`` calls."""
    if ranks is None:
        ranks = range(basics.size())
    ranks = list(ranks)
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    n_needed = int(np.prod(sizes))
    if n_needed > len(ranks):
        raise ValueError(f"mesh needs {n_needed} devices, have {len(ranks)}")
    arr = np.asarray(ranks[:n_needed], dtype=np.int64).reshape(sizes)
    return _make_mesh(arr, names)


def build_global_mesh(axis_name: str = HVD_AXIS,
                      ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build (and remember) the 1-D global mesh over the world."""
    global _global_mesh
    if ranks is None:
        ranks = range(basics.size())
    _global_mesh = _make_mesh(np.asarray(list(ranks), dtype=np.int64),
                              (axis_name,))
    return _global_mesh


def global_mesh() -> Optional[Mesh]:
    """The mesh built at hvd.init() (or None before init)."""
    return _global_mesh


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    _global_mesh = mesh


def reset() -> None:
    global _global_mesh
    _global_mesh = None
    _entered.clear()


def mesh_axis_name() -> str:
    if _global_mesh is not None:
        return _global_mesh.axis_names[0]
    return HVD_AXIS


def sub_mesh(ranks: Sequence[int], axis_name: Optional[str] = None) -> Mesh:
    """1-D mesh over the given ranks of the world: the counterpart of a
    process-set communicator.  Every rank of the world calls it."""
    axis_name = axis_name or mesh_axis_name()
    world = basics.size() if basics.is_initialized() else 0
    members = [int(r) for r in ranks if 0 <= int(r) < world]
    if not members:
        raise ValueError(f"no devices for ranks {list(ranks)}")
    return _make_mesh(np.asarray(members, dtype=np.int64), (axis_name,))


def axis(name: str) -> Axis:
    """This rank's place on the axis ``name`` of the innermost entered mesh
    that has it, else of the global mesh."""
    for mesh in reversed(_entered):
        if name in mesh.shape:
            return mesh.axis(name)
    if _global_mesh is not None and name in _global_mesh.shape:
        return _global_mesh.axis(name)
    raise NameError(f"unbound axis name: {name}")
