"""Exception types mirroring the reference's public error contract.

Reference: horovod/common/exceptions.py — HorovodInternalError,
HostsUpdatedInterrupt.  Own copy of ``horovod_tpu/exceptions.py``: this
package never imports the JAX package.
"""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective routine fails."""


class HostsUpdatedInterrupt(RuntimeError):
    """Raised asynchronously when the elastic driver observes a host-set change.

    ``skip_sync`` indicates whether the worker may keep its current state
    (pure host *addition*: no rank lost, state is intact) instead of restoring
    from the last commit.
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class HorovodVersionMismatchError(ImportError):
    """Raised when a native library's ABI does not match the Python layer."""


class TensorShapeMismatchError(HorovodInternalError):
    """Mismatched tensor shapes across ranks."""


class TensorDtypeMismatchError(HorovodInternalError):
    """Mismatched tensor dtypes across ranks."""
