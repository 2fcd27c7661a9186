"""Parameter and optimizer-state broadcast for torch models.

Reference: horovod/torch/functions.py — the
``hvd.broadcast_parameters(model.state_dict(), root_rank=0)`` idiom every
training script starts with — and ``horovod_tpu/functions.py``
(``broadcast_parameters`` over a pytree, ``broadcast_optimizer_state``).
Tensors are broadcast in place; an optimizer's non-tensor state rides one
pickled broadcast of its structure.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple, Union

import torch

from . import basics
from .mpi_ops import (allgather_object, broadcast_async_,  # noqa: F401
                      broadcast_object, synchronize)


class _TensorPlaceholder:
    """Shape/dtype stand-in for a tensor inside the pickled optimizer-state
    structure (the tensor itself is broadcast natively afterwards)."""

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


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
                              process_set=process_set)
    if basics.rank() != root_rank:
        optimizer.load_state_dict(fill(synced))

    handles = []
    for _, pstate in sorted(optimizer.state_dict()["state"].items()):
        for _, value in sorted(pstate.items()):
            if isinstance(value, torch.Tensor):
                handles.append(broadcast_async_(value, root_rank,
                                                process_set=process_set))
    for h in handles:
        synchronize(h)
