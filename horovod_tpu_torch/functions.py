"""Parameter, optimizer-state and object broadcast for torch models.

Reference: horovod/torch/functions.py -- the
``hvd.broadcast_parameters(model.state_dict(), root_rank=0)`` idiom every
training script starts with -- and ``horovod_tpu/functions.py``
(``broadcast_parameters``, ``broadcast_optimizer_state``,
``broadcast_object``, ``allgather_object``).  Everything rides the
negotiated spine under names, on the given process set: tensors are
broadcast in place; objects and an optimizer's non-tensor state cross as
pickled bytes on the host ring (two phases: size, then payload).
"""

from __future__ import annotations

import pickle
from typing import Any, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from . import basics
from .mpi_ops import allgather, broadcast, broadcast_async_, synchronize
from .process_sets import ProcessSet


class _TensorPlaceholder:
    """Shape/dtype stand-in for a tensor inside the pickled optimizer-state
    structure (the tensor itself is broadcast natively afterwards)."""

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


def broadcast_object(obj: Any, root_rank: int = 0, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """Broadcast a picklable object from ``root_rank``."""
    name = name or "broadcast.object"
    if basics.rank() == root_rank:
        payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy()
        sz = np.array([payload.size], dtype=np.int64)
    else:
        payload = None
        sz = np.zeros(1, dtype=np.int64)
    sz = np.asarray(broadcast(sz, root_rank, name=f"{name}.size",
                              process_set=process_set))
    if payload is None:
        payload = np.zeros(int(sz[0]), dtype=np.uint8)
    payload = np.asarray(broadcast(payload, root_rank, name=f"{name}.payload",
                                   process_set=process_set))
    return pickle.loads(payload.tobytes())


def allgather_object(obj: Any, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> list:
    """Gather one picklable object per rank into a rank-ordered list."""
    name = name or "allgather.object"
    payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy()
    sizes = np.asarray(allgather(np.array([payload.size], dtype=np.int64),
                                 name=f"{name}.size", process_set=process_set))
    gathered = np.asarray(allgather(payload, name=f"{name}.payload",
                                    process_set=process_set))
    out = []
    offset = 0
    for size in sizes.ravel().tolist():
        out.append(pickle.loads(gathered[offset:offset + size].tobytes()))
        offset += size
    return out


def broadcast_parameters(params: Union[dict, Iterable[Tuple[str, Any]]],
                         root_rank: int = 0, process_set=None) -> None:
    """Broadcast model parameters from ``root_rank`` in place.

    Accepts ``model.state_dict()`` or ``model.named_parameters()``."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else list(params)
    handles = []
    for name, p in items:
        if p is None:
            continue
        if not isinstance(p, torch.Tensor):
            raise ValueError(
                f"broadcast_parameters got a non-tensor entry {name!r}; "
                "broadcast non-tensor state with broadcast_object")
        # detach(): the same storage, without autograd's in-place check on
        # leaves that require grad.
        handles.append(broadcast_async_(p.detach(), root_rank,
                                        name=f"broadcast.params.{name}",
                                        process_set=process_set))
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0, process_set=None) -> None:
    """Broadcast an optimizer's state from ``root_rank``.

    Phase 1 broadcasts the state's structure (param groups, step counters)
    with every tensor replaced by a shape/dtype placeholder; a rank whose
    state differs (a fresh optimizer has none) loads it with zeros of the
    right geometry.  Phase 2 broadcasts every state tensor in place, so the
    moments, about twice the model's size, never ride the pickle."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state "
                         "(the reference has the same restriction)")

    def strip(v):
        if isinstance(v, torch.Tensor):
            return _TensorPlaceholder(tuple(v.shape), v.dtype)
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(strip(x) for x in v)
        return v

    def fill(v):
        if isinstance(v, _TensorPlaceholder):
            return torch.zeros(v.shape, dtype=v.dtype)
        if isinstance(v, dict):
            return {k: fill(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(fill(x) for x in v)
        return v

    synced = broadcast_object(strip(optimizer.state_dict()), root_rank,
                              name="broadcast.opt_state.structure",
                              process_set=process_set)
    if basics.rank() != root_rank:
        optimizer.load_state_dict(fill(synced))

    handles = []
    for pid, pstate in sorted(optimizer.state_dict()["state"].items()):
        for key, value in sorted(pstate.items()):
            if isinstance(value, torch.Tensor):
                handles.append(broadcast_async_(
                    value, root_rank, name=f"broadcast.opt_state.{pid}.{key}",
                    process_set=process_set))
    for h in handles:
        synchronize(h)
