"""Utilities: logging, frame metrics."""

import torch


def count_bits(value):
    """Population count of the low 32 bits (count_bits,
    TerminalRayTracer.c:231-237; dead code there, carried as the JAX package
    carries it). Takes a Python int, or an integer tensor, whose result is
    an int32 tensor of its shape; a negative value counts as its 32-bit
    two's complement, as JAX's cast to uint32 does."""
    if isinstance(value, int):
        return bin(value & 0xFFFFFFFF).count("1")
    v = value.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)
