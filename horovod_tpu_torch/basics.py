"""Runtime lifecycle and identity API.

Reference: horovod/common/basics.py (init/shutdown/rank/size/local_rank/...)
and ``horovod_tpu/basics.py``.  ``init()`` forms a ``torch.distributed``
process group over the ranks -- NCCL when the rank's device is a CUDA card,
gloo when the caller asked for the CPU, or gloo on the card with
``HOROVOD_GPU_OPERATIONS=GLOO`` (NCCL refuses two ranks of one group on one
card) -- and then starts the negotiation core and its executor
(``context.HorovodContext``) beside it.  Both are formed at world size 1
too, so one card runs the same negotiated path that n cards run.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional, Sequence, Union

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
    # The group of the collectives the caller's thread issues in issue
    # order (the quantized_* functions and error feedback), apart from the
    # world group the executor's negotiated collectives run on.
    caller_group: object


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


def init(device: Union[str, torch.device, None] = None,
         process_sets: Optional[Sequence] = None) -> None:
    """Initialize Horovod on this rank.

    Rank, size and local rank come from ``HOROVOD_RANK``/``HOROVOD_SIZE``/
    ``HOROVOD_LOCAL_RANK`` (default: a world of one).  The device defaults
    to ``cuda:<local_rank>``; the CPU is used only when asked for with
    ``device="cpu"``.  Collectives on the card run over NCCL unless
    ``HOROVOD_GPU_OPERATIONS=GLOO`` asks for gloo.  Ranks of a world larger
    than one meet at
    ``tcp://HOROVOD_GLOO_RENDEZVOUS_ADDR:HOROVOD_GLOO_RENDEZVOUS_PORT``;
    a collective waits ``HOROVOD_GLOO_TIMEOUT_SECONDS`` (600) for its peers.
    The native core's coordinator listens on a port rank 0 picks and
    shares through the process group.  ``process_sets`` are registered
    once the core is up, as ``add_process_set`` does.
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
    from .context import HorovodContext

    try:
        caller_group = dist.new_group(list(range(cfg.size)))
        _runtime = _Runtime(cfg=cfg, device=dev, backend=backend,
                            caller_group=caller_group)
        HorovodContext.start(cfg, dev, backend,
                             core_port=_core_port(cfg, dev, backend))
        for ps in process_sets or ():
            from .process_sets import add_process_set

            add_process_set(ps)
    except BaseException:
        _runtime = None
        HorovodContext.shutdown()
        dist.destroy_process_group()
        raise
    log.debug("init rank %d/%d on %s (%s)", cfg.rank, cfg.size, dev, backend)


def _core_port(cfg: Config, dev: torch.device, backend: str) -> int:
    """The native core's rendezvous port: a free port rank 0 picks, shared
    with the other ranks through the process group (0 for one rank, whose
    core needs none)."""
    if cfg.size == 1:
        return 0
    port = 0
    if cfg.rank == 0:
        with socket.socket() as sock:
            sock.bind((cfg.rendezvous_addr, 0))
            port = sock.getsockname()[1]
    box = [port]
    dist.broadcast_object_list(box, src=0,
                               device=dev if backend == "nccl" else None)
    return int(box[0])


def shutdown() -> None:
    """Stop the negotiation core and its executor, then the process
    groups."""
    global _runtime
    if _runtime is None:
        return
    from .context import HorovodContext

    HorovodContext.shutdown()
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


def cross_rank() -> int:
    """This rank's host among the job's hosts (``HOROVOD_CROSS_RANK``)."""
    return _get().cfg.cross_rank


def cross_size() -> int:
    """The number of hosts (``HOROVOD_CROSS_SIZE``)."""
    return _get().cfg.cross_size


def is_homogeneous() -> bool:
    """True when every host runs the same number of ranks."""
    cfg = _get().cfg
    return cfg.size == cfg.local_size * cfg.cross_size


def caller_group():
    """The process group of collectives issued on the caller's thread."""
    return _get().caller_group


def wire_device() -> torch.device:
    """Where the process group takes tensors: the card under NCCL, the
    host under gloo."""
    rt = _get()
    return rt.device if rt.backend == "nccl" else torch.device("cpu")


def num_devices() -> int:
    """CUDA devices this process sees; 1 for a CPU run (a rank initialized
    with ``device="cpu"``, or no CUDA device at all), whose one device is
    the host."""
    if (_runtime is not None and _runtime.device.type == "cpu") or \
            not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


# -- observability ------------------------------------------------------------

def _core():
    from .context import HorovodContext

    return HorovodContext.instance().core


def metrics() -> dict:
    """This rank's metrics-registry snapshot: counters (cycles, fusion,
    stall warnings, the device plane's quantized wire bytes) and
    power-of-two-bucket histograms (negotiation wait, ring hops); rank 0
    adds ``cluster`` and ``straggler_report``.  The core counts only under
    ``HOROVOD_METRICS=1`` (``enabled``); empty on the pure-Python core."""
    return _core().metrics()


def metrics_prometheus() -> str:
    """The :func:`metrics` snapshot in Prometheus text exposition format
    (``hvd_*`` families, the JAX package's names)."""
    from .utils.metrics import render_prometheus

    return render_prometheus(metrics())


def flight_record() -> dict:
    """This rank's flight-recorder ring, the always-on event black box:
    ``rank``, ``host``, ``slots``, ``dropped``, ``types`` (the event-type
    legend) and ``events`` as ``[ts_us, seq, type, tid, a, b]`` rows,
    oldest first.  Empty under ``HOROVOD_FLIGHT_RECORDER=off``."""
    return _core().flight_record()


def step_trace() -> dict:
    """This rank's causal step trace: ``rank``, ``world``, ``phases``
    (negotiation_wait, fusion, ring, fence, idle) and ``steps`` as
    ``[step, start_us, end_us, <5 phase us>]`` rows; rank 0 adds ``fleet``,
    the per-step cross-rank sums.  Empty under ``HOROVOD_STEP_TRACE=off``."""
    return _core().step_trace()


def fleet_history() -> dict:
    """The coordinator's fleet history and anomaly log
    (``fleethistory-v1``): meaningful on rank 0; empty under
    ``HOROVOD_FLEET_TELEMETRY=off``."""
    return _core().fleet_history()


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Write the core's Chrome-trace timeline (negotiation and data-plane
    phases of every named collective) to ``file_path`` from now on."""
    _core().start_timeline(file_path, mark_cycles)


def stop_timeline() -> None:
    _core().stop_timeline()


_device_trace = None


def start_device_trace(logdir: str) -> None:
    """Start ``torch.profiler`` over CPU and, where there is a card, CUDA
    activity: the on-device half of observability, beside the host
    timeline.  :func:`stop_device_trace` writes it under ``logdir``."""
    global _device_trace
    if _device_trace is not None:
        raise RuntimeError("a device trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _device_trace = (prof, str(logdir))


def stop_device_trace() -> str:
    """Stop the device trace and write it as a Chrome trace,
    ``<logdir>/device_trace.rank<r>.<pid>.json``; returns its path."""
    global _device_trace
    if _device_trace is None:
        raise RuntimeError("no device trace is running")
    prof, logdir = _device_trace
    _device_trace = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    rank = _runtime.cfg.rank if _runtime is not None else 0
    path = os.path.join(logdir, f"device_trace.rank{rank}.{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


# -- build queries ------------------------------------------------------------
# What this package is built with: collectives over NCCL (on a card) or gloo,
# kernels in CUDA.  No MPI, DDL, oneCCL, ROCm or TPU build exists.

def mpi_threads_supported() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def rocm_built() -> bool:
    return False


def tpu_built() -> bool:
    return False


def gloo_enabled() -> bool:
    return dist.is_gloo_available()


def native_core_built() -> bool:
    """True when the native core library builds and loads here."""
    from . import _core

    try:
        _core.load_library()
    except (RuntimeError, OSError):
        return False
    return True


def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()
