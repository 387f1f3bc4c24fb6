"""Homomorphic non-zero index: the exact bitmap (paper §3.2).

The bitmap aggregates with bitwise OR and rides the wire packed 32 bits
to a word: word ``w``, bit ``k`` covers flat element ``32w + k``. Words
are stored as int32 tensors carrying the uint32 bits (torch's CPU
backend cannot shift or sum uint32); the packing itself runs in int64.
The Bloom-filter index comes with a later slice.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def words_to_uint(words: torch.Tensor) -> torch.Tensor:
    """int32 words carrying uint32 bits -> int64 in [0, 2^32)."""
    return words.to(torch.int64) & _MASK32


def uint_to_words(w: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 carrying the same 32 bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool (...,) with total size divisible by 32 -> int32 words (N/32,)."""
    flat = bits.reshape(-1)
    n = flat.shape[0]
    if n % 32 != 0:
        raise ValueError(f"bit count {n} not divisible by 32")
    shifts = torch.arange(32, dtype=torch.int64, device=flat.device)
    w = (flat.reshape(n // 32, 32).to(torch.int64) << shifts).sum(dim=1)
    return uint_to_words(w)


def unpack_bits(words: torch.Tensor, shape) -> torch.Tensor:
    """int32 words (N/32,) -> bool array of ``shape`` (N total elements)."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words_to_uint(words.reshape(-1))[:, None] >> shifts) & 1
    return bits.reshape(shape).to(torch.bool)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits of int32 words, as an int64 scalar (SWAR count)."""
    x = words_to_uint(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101 & _MASK32) >> 24
    return x.sum()


def bitmap_build(xb: torch.Tensor) -> torch.Tensor:
    """(nb, G, c) values -> (nb, G, c) bool non-zero mask."""
    return xb != 0
