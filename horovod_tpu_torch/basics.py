"""Runtime lifecycle and identity API.

Reference: horovod/common/basics.py (init/shutdown/rank/size/local_rank/...)
and ``horovod_tpu/basics.py``.  Where the JAX package starts its negotiated
core and builds a device mesh, this module forms a ``torch.distributed``
process group over the ranks: NCCL when the rank's device is a CUDA card,
gloo when the caller asked for the CPU, or for gloo on the card with
``HOROVOD_GPU_OPERATIONS=GLOO`` (NCCL refuses two ranks of one group on one
card).  The group is formed at world size 1 too, so the gradient allreduce
one card runs is the same call that n cards run.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Union

import torch
import torch.distributed as dist

from .utils.env import Config
from .utils.logging import get_logger

log = get_logger()


@dataclasses.dataclass(frozen=True)
class _Runtime:
    cfg: Config
    device: torch.device
    backend: str


_runtime: Optional[_Runtime] = None


def _select_device(device, local_rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): no CUDA device is available; "
                "pass device='cpu' to run on the CPU over gloo")
        return torch.device("cuda", local_rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"horovod_tpu_torch.init(device={device!r}): CUDA is not "
                "available")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    return dev


def init(device: Union[str, torch.device, None] = None) -> None:
    """Initialize Horovod on this rank.

    Rank, size and local rank come from ``HOROVOD_RANK``/``HOROVOD_SIZE``/
    ``HOROVOD_LOCAL_RANK`` (default: a world of one).  The device defaults
    to ``cuda:<local_rank>``; the CPU is used only when asked for with
    ``device="cpu"``.  Collectives on the card run over NCCL unless
    ``HOROVOD_GPU_OPERATIONS=GLOO`` asks for gloo.  Ranks of a world larger
    than one meet at
    ``tcp://HOROVOD_GLOO_RENDEZVOUS_ADDR:HOROVOD_GLOO_RENDEZVOUS_PORT``;
    a collective waits ``HOROVOD_GLOO_TIMEOUT_SECONDS`` (600) for its peers.
    """
    global _runtime
    if _runtime is not None:
        return
    cfg = Config.from_env()
    dev = _select_device(device, cfg.local_rank)
    if dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is already initialized; horovod_tpu_torch "
            "forms its own process group in init()")
    backend = ("nccl" if dev.type == "cuda" and cfg.gpu_operations == "NCCL"
               else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=cfg.timeout_s)
    if cfg.size == 1 and cfg.rendezvous_port == 0:
        # A world of one needs no rendezvous: an in-process store.
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        if cfg.rendezvous_port == 0:
            raise RuntimeError(
                f"world size {cfg.size} needs HOROVOD_GLOO_RENDEZVOUS_PORT "
                "(and _ADDR) to form the process group")
        dist.init_process_group(
            backend,
            init_method=f"tcp://{cfg.rendezvous_addr}:{cfg.rendezvous_port}",
            rank=cfg.rank, world_size=cfg.size, timeout=timeout)
    _runtime = _Runtime(cfg=cfg, device=dev, backend=backend)
    log.debug("init rank %d/%d on %s (%s)", cfg.rank, cfg.size, dev, backend)


def shutdown() -> None:
    global _runtime
    if _runtime is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _runtime = None


def _get() -> _Runtime:
    if _runtime is None:
        raise ValueError(
            "Horovod has not been initialized; use hvd.init().")
    return _runtime


def is_initialized() -> bool:
    return _runtime is not None


initialized = is_initialized  # reference alias


def rank() -> int:
    return _get().cfg.rank


def size() -> int:
    return _get().cfg.size


def local_rank() -> int:
    return _get().cfg.local_rank


def local_size() -> int:
    return _get().cfg.local_size


def device() -> torch.device:
    """The device this rank's collectives and models run on."""
    return _get().device


def backend() -> str:
    """``"nccl"`` on a card (``"gloo"`` under HOROVOD_GPU_OPERATIONS=GLOO),
    ``"gloo"`` on the CPU."""
    return _get().backend
