"""Reduction op constants, with the reference's integer values
(:mod:`horovod_tpu.common.ops_enum`)."""

import enum


class ReduceOp(enum.IntEnum):
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT
