"""Reduction selector shared by the collectives and the optimizer.

Own copy of ``ReduceOp`` from ``horovod_tpu/wire.py`` (same integer values,
so a rank of either package names the same reduction).
"""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    """Reduction selector for allreduce.

    AVERAGE is SUM followed by division by the world size.
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
