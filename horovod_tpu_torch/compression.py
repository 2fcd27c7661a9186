"""Gradient compression (reference: horovod/torch/compression.py —
Compression.none / Compression.fp16; ``horovod_tpu/compression.py`` adds
``Compression.bf16``, which keeps the fp32 exponent so no loss scaling is
needed).
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface: compress before the wire, decompress after."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = torch.float16

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype not in (torch.float32, torch.float64):
            return tensor, None
        wire = cls.wire_dtype
        if tensor.dtype == torch.float64 and wire == torch.float16:
            # float16's 5-bit exponent overflows float64's range (anything
            # past 65504 becomes inf); bfloat16 keeps the fp32 exponent.
            wire = torch.bfloat16
        return tensor.to(wire), tensor.dtype

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is None:
            return tensor
        return tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Compression:
    """Namespace matching the reference's ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
