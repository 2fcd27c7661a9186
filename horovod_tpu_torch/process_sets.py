"""Process sets: collectives over subsets of ranks.

Port of ``horovod_tpu/process_sets.py`` (reference: horovod/common/
process_sets.py over process_set.cc's ProcessSetTable).  Each registered
set is a set of the native core, which negotiates its collectives, and a
``torch.distributed`` subgroup (``dist.new_group``), on which the device
plane runs them.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

import torch.distributed as dist

from .context import HorovodContext


class ProcessSet:
    """A subset of Horovod ranks over which collectives may run.

    Construct with explicit ranks (``ProcessSet([0, 1])``) or a range, then
    register with :func:`add_process_set` (or pass them to
    ``hvd.init(process_sets=[...])``)."""

    process_set_id: Optional[int] = None

    def __init__(self, ranks_or_range: Union[Sequence[int], range,
                                             Iterable[int]],
                 weight: float = 1.0):
        self.ranks: List[int] = sorted(set(int(r) for r in ranks_or_range))
        self.process_set_id = None
        # QoS weight: orders the coordinator's fused-response schedule
        # (higher first; 1.0 = the global set's priority).
        self.weight: float = float(weight)

    def _check_registered(self) -> None:
        if self.process_set_id is None:
            raise ValueError(
                "process set is not registered; call hvd.add_process_set() first"
            )

    def included(self) -> bool:
        """True if this process's rank belongs to the set."""
        self._check_registered()
        return HorovodContext.instance().core.rank() in self.ranks

    def rank(self) -> int:
        """Rank of this process within the set (-1 if not included)."""
        self._check_registered()
        my = HorovodContext.instance().core.rank()
        return self.ranks.index(my) if my in self.ranks else -1

    def size(self) -> int:
        self._check_registered()
        return len(self.ranks)

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ProcessSet) and self.ranks == other.ranks

    def __hash__(self):
        return hash(tuple(self.ranks))


class _GlobalProcessSet(ProcessSet):
    """The implicit set of all ranks, always registered with id 0."""

    def __init__(self):
        self.process_set_id = 0
        self.ranks = []  # resolved on use: all ranks
        self.weight = 1.0

    def _check_registered(self) -> None:
        pass

    def _resolve(self) -> List[int]:
        return HorovodContext.instance().core.process_set_ranks(0)

    def included(self) -> bool:
        return True

    def rank(self) -> int:
        return HorovodContext.instance().core.rank()

    def size(self) -> int:
        return len(self._resolve())

    def __repr__(self) -> str:
        return "ProcessSet(global)"


global_process_set = _GlobalProcessSet()


def add_process_set(process_set: Union[ProcessSet, Sequence[int]],
                    weight: Optional[float] = None) -> ProcessSet:
    """Register a process set; a collective call that every rank makes in
    the same order.

    Ids come from registration order, so all ranks agree without a
    negotiation round (symmetric registration is the contract, which the
    controller validates during negotiation).  ``weight`` orders the
    coordinator's fused-response schedule (default 1.0)."""
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(process_set)
    if weight is not None:
        process_set.weight = float(weight)
    if process_set.weight <= 0.0:
        # The native scheduler's clamp: a zero or negative weight would
        # starve the set's ranks out of negotiation.
        process_set.weight = 1.0
    ctx = HorovodContext.instance()
    world = ctx.core.process_set_ranks(0)
    for r in process_set.ranks:
        if r not in world:
            raise ValueError(f"rank {r} is not part of the global process set")
    # Every rank forms the subgroup, members or not (dist.new_group is
    # collective over the world).
    group = dist.new_group(process_set.ranks)
    psid = ctx.core.add_process_set(process_set.ranks,
                                    weight=process_set.weight)
    ctx.device_plane.register(psid, group, process_set.ranks)
    process_set.process_set_id = psid
    return process_set


def remove_process_set(process_set: ProcessSet) -> bool:
    if process_set.process_set_id in (None, 0):
        return False
    HorovodContext.instance().remove_process_set(process_set.process_set_id)
    process_set.process_set_id = None
    return True


def _resolve_psid(process_set: Optional[ProcessSet]) -> int:
    if process_set is None:
        return 0
    if isinstance(process_set, int):
        return process_set
    if not isinstance(process_set, ProcessSet):
        raise TypeError(f"process_set must be a ProcessSet, got "
                        f"{type(process_set).__name__}")
    if process_set.process_set_id is None:
        raise ValueError("process set is not registered; call add_process_set()")
    return process_set.process_set_id


def effective_size(process_set: Optional[ProcessSet] = None) -> int:
    """Size of ``process_set``, or the job's size when None."""
    if process_set is not None:
        return process_set.size()
    from . import basics

    return basics.size()
