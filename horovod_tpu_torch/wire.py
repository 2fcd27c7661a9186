"""Wire-level enums shared between the Python layer and the C++ core.

Own copy of ``horovod_tpu/wire.py``: the integer values are the ABI of the
native core (``csrc/core/common.h``) and of its negotiation protocol, so a
rank of either package names the same op, dtype and reduction.  Beside the
numpy map this module maps torch dtypes.

bfloat16 has no numpy dtype without ``ml_dtypes``, which this package does
not use.  On the host plane a bf16 tensor crosses as its raw 16 bits, a
``uint16`` array, and its entry carries ``DataType.BFLOAT16`` so the core
reduces it as bf16 (as the reference torch binding's bit view does).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .exceptions import HorovodInternalError


class OpType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ALLTOALL = 3
    REDUCESCATTER = 4
    BARRIER = 5
    JOIN = 6


class ReduceOp(enum.IntEnum):
    """Reduction selector for allreduce and reducescatter.

    AVERAGE is SUM followed by division by the process set's size.
    """

    AVERAGE = 0
    SUM = 1
    MIN = 2
    MAX = 3
    PRODUCT = 4
    ADASUM = 5


# Public aliases with the reference's names (hvd.Average, hvd.Sum, ...).
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT
Adasum = ReduceOp.ADASUM


class DataType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    INT32 = 2
    INT64 = 3
    FLOAT16 = 4
    FLOAT32 = 5
    FLOAT64 = 6
    BOOL = 7
    BFLOAT16 = 8
    UINT16 = 9
    INT16 = 10


class StatusCode(enum.IntEnum):
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


_NUMPY_TO_WIRE = {
    np.dtype(np.uint8): DataType.UINT8,
    np.dtype(np.int8): DataType.INT8,
    np.dtype(np.uint16): DataType.UINT16,
    np.dtype(np.int16): DataType.INT16,
    np.dtype(np.int32): DataType.INT32,
    np.dtype(np.int64): DataType.INT64,
    np.dtype(np.float16): DataType.FLOAT16,
    np.dtype(np.float32): DataType.FLOAT32,
    np.dtype(np.float64): DataType.FLOAT64,
    np.dtype(np.bool_): DataType.BOOL,
}

_WIRE_TO_NUMPY = {v: k for k, v in _NUMPY_TO_WIRE.items()}
# bf16's host buffer holds its raw bits.
_WIRE_TO_NUMPY[DataType.BFLOAT16] = np.dtype(np.uint16)

_TORCH_TO_WIRE = {
    torch.uint8: DataType.UINT8,
    torch.int8: DataType.INT8,
    torch.int16: DataType.INT16,
    torch.int32: DataType.INT32,
    torch.int64: DataType.INT64,
    torch.float16: DataType.FLOAT16,
    torch.bfloat16: DataType.BFLOAT16,
    torch.float32: DataType.FLOAT32,
    torch.float64: DataType.FLOAT64,
    torch.bool: DataType.BOOL,
}
if hasattr(torch, "uint16"):
    _TORCH_TO_WIRE[torch.uint16] = DataType.UINT16

_WIRE_TO_TORCH = {v: k for k, v in _TORCH_TO_WIRE.items()}

_ITEMSIZE = {
    DataType.UINT8: 1,
    DataType.INT8: 1,
    DataType.BOOL: 1,
    DataType.UINT16: 2,
    DataType.INT16: 2,
    DataType.FLOAT16: 2,
    DataType.BFLOAT16: 2,
    DataType.INT32: 4,
    DataType.FLOAT32: 4,
    DataType.INT64: 8,
    DataType.FLOAT64: 8,
}


def wire_dtype(dtype) -> DataType:
    """The wire enum of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        try:
            return _TORCH_TO_WIRE[dtype]
        except KeyError as exc:
            raise ValueError(
                f"unsupported dtype for collective: {dtype!r}") from exc
    try:
        return _NUMPY_TO_WIRE[np.dtype(dtype)]
    except (KeyError, TypeError) as exc:
        raise ValueError(f"unsupported dtype for collective: {dtype!r}") from exc


def numpy_dtype(wire: DataType) -> np.dtype:
    """The numpy dtype of a host buffer of ``wire`` elements (``uint16``
    bits for bf16)."""
    return _WIRE_TO_NUMPY[DataType(wire)]


def torch_dtype(wire: DataType) -> torch.dtype:
    return _WIRE_TO_TORCH[DataType(wire)]


def itemsize(wire: DataType) -> int:
    return _ITEMSIZE[DataType(wire)]


def validate_alltoall_splits(splits, d0: int, k: int) -> np.ndarray:
    """Normalize and validate an alltoall splits vector (shared by the host
    and device planes so their semantics cannot diverge).  ``None`` means
    an even split of the ``d0`` first-dim rows over the ``k`` process-set
    ranks.  Returns the int64 splits vector; raises on inconsistency."""
    if splits is None:
        if d0 % max(k, 1) != 0:
            raise HorovodInternalError(
                f"alltoall without splits requires first dim divisible by "
                f"process set size ({d0} vs {k})")
        return np.full((k,), d0 // max(k, 1), dtype=np.int64)
    splits = np.ascontiguousarray(np.asarray(splits, dtype=np.int64))
    if len(splits) != k:
        raise HorovodInternalError(
            f"alltoall splits must have one entry per process-set rank "
            f"({len(splits)} given, {k} ranks)")
    if int(splits.sum()) != d0:
        raise HorovodInternalError("alltoall splits do not sum to first dim")
    return splits
