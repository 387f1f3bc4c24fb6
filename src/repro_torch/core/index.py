"""Homomorphic non-zero indexes: the exact bitmap (paper §3.2) and the
Bloom filter (§3.3).

Both aggregate with bitwise OR and ride the wire packed 32 bits to a
word: word ``w``, bit ``k`` covers bit ``32w + k`` (for the bitmap, flat
element ``32w + k``). Words are stored as int32 tensors carrying the
uint32 bits (torch's CPU backend cannot shift or sum uint32); the
packing itself runs in int64.

The Bloom filter hashes the global coordinate ids ``0..n-1`` of the whole
stream it is built over, so it cannot be sliced per bucket or per block
range. It may report false-positive candidates, which enter the peel and
recover to ~0, but it never misses a true non-zero. Build and query work
through the coordinates in chunks of :data:`BLOOM_CHUNK`, so the ``(n,
k)`` positions of a full-width stream never exist at once (at n = 446 M
and k = 3 they would take 10.7 GB as int64).
"""

from __future__ import annotations

import math

import torch

from .config import CompressionConfig
from . import hashing

_MASK32 = 0xFFFFFFFF
BLOOM_CHUNK = 1 << 22     # coordinates per chunk of Bloom positions


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


def bloom_size_words(n_elems: int, cfg: CompressionConfig) -> int:
    """Words of the Bloom filter over ``n_elems`` coordinates."""
    m_bits = max(64, int(n_elems * cfg.bloom_bits_ratio))
    return -(-m_bits // 32)


def bloom_build(xb: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """(nb, G, c) values -> int32 words of the Bloom filter over all
    ``xb.numel()`` coordinates.

    Only non-zero coordinates set bits, so only their positions are
    computed; OR does not depend on order, so the filter equals the
    reference's scatter-max over every coordinate bit for bit."""
    n = xb.numel()
    m_bits = bloom_size_words(n, cfg) * 32
    nz = torch.nonzero(xb.reshape(-1)).reshape(-1)
    bits = torch.zeros((m_bits,), dtype=torch.bool, device=xb.device)
    for a in range(0, nz.shape[0], BLOOM_CHUNK):
        ids = nz[a:a + BLOOM_CHUNK]
        pos = hashing.bloom_positions(ids, cfg.bloom_hashes, m_bits, cfg.seed)
        bits[pos.reshape(-1)] = True
    return pack_bits(bits)


def bloom_query(shape, cfg: CompressionConfig, filt: torch.Tensor) -> torch.Tensor:
    """Candidate non-zero mask of ``shape`` from int32 filter words: a
    coordinate is a candidate when all its ``k`` bits are set."""
    n = math.prod(shape)
    m_bits = filt.shape[0] * 32
    fbits = unpack_bits(filt, (m_bits,))
    out = torch.empty((n,), dtype=torch.bool, device=filt.device)
    for a in range(0, n, BLOOM_CHUNK):
        ids = torch.arange(a, min(a + BLOOM_CHUNK, n), dtype=torch.int64,
                           device=filt.device)
        pos = hashing.bloom_positions(ids, cfg.bloom_hashes, m_bits, cfg.seed)
        out[a:a + BLOOM_CHUNK] = fbits[pos].all(dim=-1)
    return out.reshape(shape)
