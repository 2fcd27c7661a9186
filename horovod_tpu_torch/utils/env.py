"""Environment parsing for the identity and rendezvous of a rank, and for
the device plane's codec.

Own copy of the part of ``horovod_tpu/utils/env.py`` this package needs
(``Config.from_env``'s rank, size and rendezvous fields; the
``HOROVOD_WIRE_COMPRESSION``, ``HOROVOD_DEVICE_SCHEDULE`` and
``HOROVOD_WIRE_COMPRESSION_MIN_BYTES`` parsers), under the same variable
names, so a launcher that starts ranks of the JAX package starts ranks of
this one unchanged.  ``HOROVOD_GLOO_TIMEOUT_SECONDS`` is the reference
Horovod's name for how long a collective waits for its peers, and
``HOROVOD_GPU_OPERATIONS`` its choice of the library that runs collectives
on GPU tensors (``NCCL``, the default, or ``GLOO``).
"""

from __future__ import annotations

import dataclasses
import os

from .logging import get_logger

DEFAULT_GLOO_TIMEOUT_S = 600
GPU_OPERATIONS = ("NCCL", "GLOO")
WIRE_COMPRESSION_CODECS = ("none", "bf16", "int8", "int4", "int8g")
# Codecs the device plane implements (ops/quantize.py); bf16 is host-only.
DEVICE_WIRE_COMPRESSION_CODECS = ("none", "int8", "int4", "int8g")
# Ring schedules of the quantized collectives; 'auto' resolves from the
# world size (ops/collectives.py:resolve_device_schedule).
DEVICE_SCHEDULES = ("auto", "ring", "bidi", "torus")
# Payload floor below which a quantized collective demotes to the plain one.
DEFAULT_WIRE_COMPRESSION_MIN_BYTES = 1 << 16


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
    """Identity and rendezvous of this rank, and the device plane's codec
    configuration, read once per ``hvd.init()``."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    rendezvous_addr: str = "127.0.0.1"
    rendezvous_port: int = 0
    timeout_s: int = DEFAULT_GLOO_TIMEOUT_S
    gpu_operations: str = "NCCL"
    wire_compression_device: str = "none"
    wire_compression_min_bytes: int = DEFAULT_WIRE_COMPRESSION_MIN_BYTES
    device_schedule: str = "auto"

    @staticmethod
    def from_env() -> "Config":
        env = os.environ
        return Config(
            rank=get_int("HOROVOD_RANK", 0),
            size=get_int("HOROVOD_SIZE", 1),
            local_rank=get_int("HOROVOD_LOCAL_RANK", 0),
            local_size=get_int("HOROVOD_LOCAL_SIZE", 1),
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


def _warn_wire(raw: str, what: str, allowed) -> None:
    get_logger().warning(
        "HOROVOD_WIRE_COMPRESSION=%r: %s not one of %s; using 'none'",
        raw, what, "/".join(allowed))


def get_wire_compression_planes() -> "tuple":
    """HOROVOD_WIRE_COMPRESSION as per-plane codecs ``(host, device)``.

    A bare codec (``int8``) sets the host plane only; comma-separated
    ``plane=codec`` assignments (``host=bf16,device=int8``) set the planes
    they name.  Unset, empty, "0", "off", "false" and "no" mean none;
    anything unrecognised warns and stays none.  Only the device plane is
    read by this package: the host ring arrives with the negotiated core."""
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
