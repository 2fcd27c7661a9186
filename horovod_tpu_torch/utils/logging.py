"""Leveled logging, analog of the reference's horovod/common/logging.cc.

Controlled by HOROVOD_LOG_LEVEL (trace|debug|info|warning|error|fatal) and
HOROVOD_LOG_TIMESTAMP, the same contract as ``horovod_tpu/utils/logging.py``.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")


def get_logger() -> logging.Logger:
    logger = logging.getLogger("horovod_tpu_torch")
    if logger.handlers:
        return logger
    level = _LEVELS.get(os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower(),
                        logging.WARNING)
    logger.setLevel(level)
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("HOROVOD_LOG_TIMESTAMP", "1") not in ("0", "false"):
        fmt = "[%(asctime)s] [hvd-torch] [%(levelname)s] %(message)s"
    else:
        fmt = "[hvd-torch] [%(levelname)s] %(message)s"
    handler.setFormatter(logging.Formatter(fmt))
    logger.addHandler(handler)
    logger.propagate = False
    return logger
