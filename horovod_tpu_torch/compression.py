"""Gradient compression, the cast tier of :mod:`horovod_tpu.compression`:
compress before the collective, decompress after.

``Compression.none`` passes tensors through; ``fp16`` and ``bf16`` cast
f32/f64 tensors down and back, returning the original dtype as the
context. Every route that the reference sends through its quantized
reduce-scatter + all-gather (``Compression.int8`` anywhere, and any
codec on an in-graph Sum/Average) is ROADMAP Queue 1 item 8 and raises
here until it is ported.
"""

from __future__ import annotations

import torch

QUANTIZED_TODO = ("the quantized compression path (int8, and codecs on "
                  "the quantized reduce-scatter + all-gather) is not "
                  "ported yet (ROADMAP Queue 1 item 8)")

_WIDE = (torch.float32, torch.float64)


class Compressor:
    #: in-graph codec name this compressor maps to (the reference's
    #: ``ops/quantized.py`` CODECS entry).
    in_jit_codec = None
    #: whether ``compress``/``decompress`` are a framework-level cast.
    cast_tier = True

    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    in_jit_codec = "none"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


def _cast_down(tensor, dtype):
    if tensor.dtype in _WIDE:
        return tensor.to(dtype), tensor.dtype
    return tensor, None


def _cast_back(tensor, ctx):
    return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(Compressor):
    in_jit_codec = "fp16"

    @staticmethod
    def compress(tensor):
        return _cast_down(tensor, torch.float16)

    @staticmethod
    def decompress(tensor, ctx):
        return _cast_back(tensor, ctx)


class BF16Compressor(Compressor):
    in_jit_codec = "bf16"

    @staticmethod
    def compress(tensor):
        return _cast_down(tensor, torch.bfloat16)

    @staticmethod
    def decompress(tensor, ctx):
        return _cast_back(tensor, ctx)


class Int8Compressor(Compressor):
    """Blockwise-scaled int8 with error feedback. It has no cast form
    (int8 values cannot be summed without their scales) and rides the
    quantized collectives, which are not ported yet."""
    in_jit_codec = "int8"
    cast_tier = False

    @staticmethod
    def compress(tensor):
        raise NotImplementedError(f"Compression.int8: {QUANTIZED_TODO}")

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError(f"Compression.int8: {QUANTIZED_TODO}")


def in_jit_codec(compression) -> str:
    """The codec name of a ``compression=`` argument: ``None`` is
    ``"none"``; a :class:`Compressor` maps through its
    ``in_jit_codec``. Anything else is a usage error."""
    if compression is None:
        return "none"
    codec = getattr(compression, "in_jit_codec", None)
    if codec is None:
        raise ValueError(f"compression must be None or a Compression "
                         f"member, got {compression!r}")
    return codec


class Compression:
    """Namespace matching ``hvd.Compression.{none,fp16,bf16,int8}``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
