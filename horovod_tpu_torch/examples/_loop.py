"""The training loop the ported trainers share."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

from .. import basics, mpi_ops


def init() -> bool:
    """``hvd.init()`` unless the caller initialized already; True when this
    call did (the trainer then shuts down at its end)."""
    if basics.is_initialized():
        return False
    basics.init()
    return True


def run(step: Callable[[], torch.Tensor], steps: int,
        warmup: int = 1) -> Dict[str, List[float]]:
    """``warmup`` then ``steps`` calls of ``step`` (one optimizer step that
    returns its loss).  Each step ends in a host readback of the loss
    averaged over the ranks, so its host time bounds its device work."""
    for _ in range(warmup):
        mpi_ops.allreduce(step().detach(), name="trainer.loss").item()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = mpi_ops.allreduce(step().detach(), name="trainer.loss").item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return {"losses": losses, "step_ms": step_ms}
