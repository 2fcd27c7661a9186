"""Environment parsing for the identity and rendezvous of a rank.

Own copy of the part of ``horovod_tpu/utils/env.py`` this package needs
(``Config.from_env``'s rank, size and rendezvous fields), under the same
variable names, so a launcher that starts ranks of the JAX package starts
ranks of this one unchanged.  ``HOROVOD_GLOO_TIMEOUT_SECONDS`` is the
reference Horovod's name for how long a collective waits for its peers.
"""

from __future__ import annotations

import dataclasses
import os

DEFAULT_GLOO_TIMEOUT_S = 600


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
    """Identity and rendezvous of this rank, one per ``hvd.init()``."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    rendezvous_addr: str = "127.0.0.1"
    rendezvous_port: int = 0
    timeout_s: int = DEFAULT_GLOO_TIMEOUT_S

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
        )
