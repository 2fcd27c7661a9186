"""Environment parsing for the identity and rendezvous of a rank, the
negotiation core and the device plane's codec.

Own copy of the part of ``horovod_tpu/utils/env.py`` this package needs
(``Config.from_env``'s identity, rendezvous and core fields -- every value
``hvd_init`` takes -- and the ``HOROVOD_WIRE_COMPRESSION``,
``HOROVOD_DEVICE_SCHEDULE``, ``HOROVOD_WIRE_COMPRESSION_MIN_BYTES`` and
``HOROVOD_DATA_PLANE`` parsers, and ``HOROVOD_HLO_INSPECT``), under the
same variable names and defaults, so a launcher that starts ranks of the
JAX package starts ranks of this one unchanged.  As
there, the flight recorder and the step trace are on unless
``HOROVOD_FLIGHT_RECORDER`` / ``HOROVOD_STEP_TRACE`` turn them off, and the
timeline (``HOROVOD_TIMELINE``) and the metrics registry
(``HOROVOD_METRICS``) are off unless turned on; ``hvd.metrics()``,
``hvd.flight_record()``, ``hvd.step_trace()`` and ``hvd.start_timeline()``
read them.  ``HOROVOD_GLOO_TIMEOUT_SECONDS`` is the reference
Horovod's name for how long a collective waits for its peers, and
``HOROVOD_GPU_OPERATIONS`` its choice of the library that runs collectives
on GPU tensors (``NCCL``, the default, or ``GLOO``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from .logging import get_logger

DEFAULT_GLOO_TIMEOUT_S = 600
GPU_OPERATIONS = ("NCCL", "GLOO")
WIRE_COMPRESSION_CODECS = ("none", "bf16", "int8", "int4", "int8g")
# Codecs the device plane implements (ops/quantize.py); bf16 is host-only.
DEVICE_WIRE_COMPRESSION_CODECS = ("none", "int8", "int4", "int8g")
# Ring schedules of the quantized collectives; 'auto' resolves from the
# world size (ops/collectives.py:resolve_device_schedule).
DEVICE_SCHEDULES = ("auto", "ring", "bidi", "torus")
# Gradient-exchange planes DistributedOptimizer can run (ops/gspmd_plane.py):
# 'eager' reduces through the negotiated spine's hooks, 'gspmd' pins DTensor
# gradients replicated and lets the compiled step carry the all-reduce,
# 'auto' takes gspmd where it composes and demotes deterministically
# otherwise.
DATA_PLANES = ("auto", "eager", "gspmd")
# Payload floor below which a quantized collective demotes to the plain one.
DEFAULT_WIRE_COMPRESSION_MIN_BYTES = 1 << 16
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024  # bytes, as the reference
DEFAULT_CYCLE_TIME_MS = 1.0
DEFAULT_CACHE_CAPACITY = 1024
DEFAULT_STALL_WARNING_S = 60.0


def get_bool(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def get_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return float(val)
    except ValueError:
        return default


def get_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return int(val)
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class Config:
    """Identity and rendezvous of this rank, the negotiation core's
    settings and the device plane's codec configuration, read once per
    ``hvd.init()``."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    rendezvous_addr: str = "127.0.0.1"
    rendezvous_port: int = 0
    timeout_s: int = DEFAULT_GLOO_TIMEOUT_S
    gpu_operations: str = "NCCL"
    wire_compression_device: str = "none"
    wire_compression_min_bytes: int = DEFAULT_WIRE_COMPRESSION_MIN_BYTES
    device_schedule: str = "auto"
    # HOROVOD_DATA_PLANE: the plane DistributedOptimizer resolves ("auto" |
    # "eager" | "gspmd"), and HOROVOD_HLO_INSPECT: the inventory of the
    # compiled gspmd steps' collectives (ops/hlo_inspect.py), on by default.
    data_plane: str = "auto"
    hlo_inspect_enabled: bool = True
    # The negotiation core (hvd_init's arguments).  ``controller`` is auto
    # (socket above one rank), local, socket, or python for the pure-Python
    # core; the core's own rendezvous port is chosen by rank 0 at init and
    # shared through the process group's store.
    controller: str = "auto"
    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    autotune: bool = False
    autotune_log: Optional[str] = None
    hierarchical_allreduce: bool = False
    # Host-plane codec of the C++ ring (HOROVOD_WIRE_COMPRESSION's host=).
    wire_compression: str = "none"
    timeline_path: Optional[str] = None
    timeline_mark_cycles: bool = False
    metrics_enabled: bool = False
    metrics_file: Optional[str] = None
    metrics_interval_s: float = 10.0
    flight_recorder_enabled: bool = True
    flight_recorder_slots: int = 4096
    postmortem_dir: Optional[str] = None
    log_level: str = "warning"
    stall_check_enabled: bool = True
    stall_warning_s: float = DEFAULT_STALL_WARNING_S
    stall_shutdown_s: float = 0.0  # 0 = never shut down
    autopilot_port: int = 0
    # Elastic state migration: each rank keeps a replicated shard of its
    # committed training state on HOROVOD_MIGRATE_REPLICAS ring-successor
    # ranks (0 disables replication: a re-formation then falls back to the
    # checkpoint), refreshed every HOROVOD_MIGRATE_INTERVAL_STEPS commits.
    migrate_replicas: int = 2
    migrate_interval_steps: int = 1
    step_trace_enabled: bool = True
    step_trace_slots: int = 256
    # The live cockpit (HOROVOD_COCKPIT, off by default): rank 0 serves
    # /metrics, /state, /history and /events on a loopback port.
    # HOROVOD_COCKPIT_PORT is set by the elastic driver on rank 0 only, the
    # same port every generation; 0 picks a free loopback port.  The
    # HOROVOD_AUTOPILOT_* knobs stay with the driver (runner/autopilot.py).
    cockpit_enabled: bool = False
    cockpit_port: int = 0
    force_pure_python: bool = False

    @staticmethod
    def from_env() -> "Config":
        env = os.environ
        if env.get("HOROVOD_RANK_FROM_JSRUN") == "1":
            # jsrun placed this worker: its rank env is OpenMPI's or
            # JSM's (runner/js_run.py).
            from ..runner.js_run import apply_jsrun_rank_env

            apply_jsrun_rank_env()
        return Config(
            rank=get_int("HOROVOD_RANK", 0),
            size=get_int("HOROVOD_SIZE", 1),
            local_rank=get_int("HOROVOD_LOCAL_RANK", 0),
            local_size=get_int("HOROVOD_LOCAL_SIZE", 1),
            cross_rank=get_int("HOROVOD_CROSS_RANK", 0),
            cross_size=get_int("HOROVOD_CROSS_SIZE", 1),
            # Same variable names the reference's Gloo rendezvous uses.
            rendezvous_addr=env.get(
                "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                env.get("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")),
            rendezvous_port=get_int(
                "HOROVOD_GLOO_RENDEZVOUS_PORT",
                get_int("HOROVOD_RENDEZVOUS_PORT", 0)),
            timeout_s=get_int("HOROVOD_GLOO_TIMEOUT_SECONDS",
                              DEFAULT_GLOO_TIMEOUT_S),
            gpu_operations=get_gpu_operations(),
            wire_compression_device=get_wire_compression_planes()[1],
            wire_compression_min_bytes=get_wire_compression_min_bytes(),
            device_schedule=get_device_schedule(),
            data_plane=get_data_plane(),
            hlo_inspect_enabled=get_bool("HOROVOD_HLO_INSPECT", True),
            controller=env.get("HOROVOD_CONTROLLER", "auto").lower(),
            fusion_threshold_bytes=get_int("HOROVOD_FUSION_THRESHOLD",
                                           DEFAULT_FUSION_THRESHOLD),
            cycle_time_ms=get_float("HOROVOD_CYCLE_TIME",
                                    DEFAULT_CYCLE_TIME_MS),
            cache_capacity=get_int("HOROVOD_CACHE_CAPACITY",
                                   DEFAULT_CACHE_CAPACITY),
            autotune=get_bool("HOROVOD_AUTOTUNE", False),
            autotune_log=env.get("HOROVOD_AUTOTUNE_LOG"),
            hierarchical_allreduce=get_bool("HOROVOD_HIERARCHICAL_ALLREDUCE",
                                            False),
            wire_compression=get_wire_compression_planes()[0],
            timeline_path=env.get("HOROVOD_TIMELINE"),
            timeline_mark_cycles=get_bool("HOROVOD_TIMELINE_MARK_CYCLES",
                                          False),
            metrics_enabled=get_bool("HOROVOD_METRICS",
                                     bool(env.get("HOROVOD_METRICS_FILE"))),
            metrics_file=env.get("HOROVOD_METRICS_FILE"),
            metrics_interval_s=get_float("HOROVOD_METRICS_INTERVAL", 10.0),
            flight_recorder_enabled=get_bool("HOROVOD_FLIGHT_RECORDER",
                                             True),
            flight_recorder_slots=get_int("HOROVOD_FLIGHT_RECORDER_SLOTS",
                                          4096),
            postmortem_dir=env.get("HOROVOD_POSTMORTEM_DIR"),
            log_level=env.get("HOROVOD_LOG_LEVEL", "warning").lower(),
            stall_check_enabled=not get_bool("HOROVOD_STALL_CHECK_DISABLE",
                                             False),
            stall_warning_s=get_float("HOROVOD_STALL_CHECK_TIME_SECONDS",
                                      DEFAULT_STALL_WARNING_S),
            stall_shutdown_s=get_float(
                "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0),
            autopilot_port=get_int("HOROVOD_AUTOPILOT_PORT", 0),
            migrate_replicas=max(0, get_int("HOROVOD_MIGRATE_REPLICAS", 2)),
            migrate_interval_steps=max(
                1, get_int("HOROVOD_MIGRATE_INTERVAL_STEPS", 1)),
            step_trace_enabled=get_bool("HOROVOD_STEP_TRACE", True),
            step_trace_slots=get_int("HOROVOD_STEP_TRACE_SLOTS", 256),
            cockpit_enabled=get_bool("HOROVOD_COCKPIT", False),
            cockpit_port=get_int("HOROVOD_COCKPIT_PORT", 0),
            force_pure_python=get_bool("HVD_TPU_PURE_PY", False),
        )


def get_gpu_operations() -> str:
    """``HOROVOD_GPU_OPERATIONS`` (default NCCL).  GLOO runs the process
    group over gloo while tensors and kernels stay on the card; it is only
    ever the caller's choice."""
    val = os.environ.get("HOROVOD_GPU_OPERATIONS", "").strip().upper()
    if not val:
        return "NCCL"
    if val not in GPU_OPERATIONS:
        raise ValueError(f"HOROVOD_GPU_OPERATIONS={val!r}: the port runs "
                         f"collectives with one of {GPU_OPERATIONS}")
    return val


def get_device_schedule() -> str:
    """Ring schedule request from HOROVOD_DEVICE_SCHEDULE (default 'auto').
    Unrecognised values warn and fall back to 'auto': the resolution is
    deterministic in the world size, so all ranks fall the same way."""
    raw = os.environ.get("HOROVOD_DEVICE_SCHEDULE", "auto")
    val = raw.strip().lower() or "auto"
    if val in DEVICE_SCHEDULES:
        return val
    get_logger().warning(
        "HOROVOD_DEVICE_SCHEDULE=%r: not one of %s; using 'auto'",
        raw, "/".join(DEVICE_SCHEDULES))
    return "auto"


def get_data_plane() -> str:
    """Data-plane request from HOROVOD_DATA_PLANE (default 'auto').
    Unrecognised values warn and fall back to 'auto': plane resolution
    (ops/gspmd_plane.py) is deterministic in the mesh and the optimizer's
    codec, so all ranks fall the same way."""
    raw = os.environ.get("HOROVOD_DATA_PLANE", "auto")
    val = raw.strip().lower() or "auto"
    if val in DATA_PLANES:
        return val
    get_logger().warning(
        "HOROVOD_DATA_PLANE=%r: not one of %s; using 'auto'",
        raw, "/".join(DATA_PLANES))
    return "auto"


def _warn_wire(raw: str, what: str, allowed) -> None:
    get_logger().warning(
        "HOROVOD_WIRE_COMPRESSION=%r: %s not one of %s; using 'none'",
        raw, what, "/".join(allowed))


def get_wire_compression_planes() -> "tuple":
    """HOROVOD_WIRE_COMPRESSION as per-plane codecs ``(host, device)``.

    A bare codec (``int8``) sets the host plane only; comma-separated
    ``plane=codec`` assignments (``host=bf16,device=int8``) set the planes
    they name.  Unset, empty, "0", "off", "false" and "no" mean none;
    anything unrecognised warns and stays none.  The host codec runs in
    the C++ core's ring, the device codec in the quantized ring."""
    raw = os.environ.get("HOROVOD_WIRE_COMPRESSION", "")
    val = raw.strip().lower()
    host, device = "none", "none"
    if val in ("", "0", "off", "false", "no"):
        return host, device
    for token in val.split(","):
        token = token.strip()
        if not token:
            continue
        if "=" in token:
            plane, _, codec = token.partition("=")
            plane, codec = plane.strip(), codec.strip()
            if plane == "host":
                if codec in WIRE_COMPRESSION_CODECS:
                    host = codec
                else:
                    _warn_wire(raw, f"host codec {codec!r}",
                               WIRE_COMPRESSION_CODECS)
            elif plane == "device":
                if codec in DEVICE_WIRE_COMPRESSION_CODECS:
                    device = codec
                else:
                    _warn_wire(raw, f"device codec {codec!r}",
                               DEVICE_WIRE_COMPRESSION_CODECS)
            else:
                _warn_wire(raw, f"plane {plane!r}", ("host", "device"))
        elif token in WIRE_COMPRESSION_CODECS:
            host = token
        else:
            _warn_wire(raw, f"codec {token!r}", WIRE_COMPRESSION_CODECS)
    return host, device


def get_wire_compression_min_bytes() -> int:
    return get_int("HOROVOD_WIRE_COMPRESSION_MIN_BYTES",
                   DEFAULT_WIRE_COMPRESSION_MIN_BYTES)
