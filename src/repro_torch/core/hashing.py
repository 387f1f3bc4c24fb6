"""Hash family for the sketch and index structures.

Two flavours of one splitmix32-style mixer, as in the reference:

- a **numpy** version at plan time for the static per-batch row
  assignments ``h_j(i)`` and signs ``g_j(i)`` (shared across blocks);
- a **torch** version for the per-(block, batch, hash) rotation offsets
  and the Bloom filter's bit positions.

Torch on the CPU cannot shift, take a remainder of, or sum ``uint32``,
so the torch mixer computes in int64 masked to 32 bits. A product of two
32-bit values would overflow int64, so each multiply by a constant is
split into 16-bit halves (:func:`_mul32`). The CUDA kernels compute the
same mixer natively in ``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF


def mix32_np(x: np.ndarray) -> np.ndarray:
    """splitmix/murmur3 finalizer on uint32 (numpy, plan time)."""
    x = np.asarray(x, dtype=np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(_M1)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(_M2)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return x


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``m``, without leaving int64: only the low 16 bits of
    ``x * m_hi`` survive the shift by 16."""
    hi, lo = m >> 16, m & 0xFFFF
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & _MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The same mixer on int64 tensors holding uint32 values; returns
    int64 in [0, 2^32)."""
    x = x.to(torch.int64) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


# ----------------------------------------------------------------------
# Static plan-time tables (shared across blocks)
# ----------------------------------------------------------------------

def batch_rows(group: int, rows: int, seed: int) -> np.ndarray:
    """Row assignment h_j(i): hash j lands in rows [j*rows/3,
    (j+1)*rows/3). Returns int32 (group, 3)."""
    per = rows // 3
    i = np.arange(group, dtype=np.uint32)
    out = np.empty((group, 3), dtype=np.int32)
    salt = np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
    for j in range(3):
        h = mix32_np(i * np.uint32(3) + np.uint32(j) + salt)
        out[:, j] = (h % np.uint32(per)).astype(np.int32) + j * per
    return out


def batch_signs(group: int, seed: int) -> np.ndarray:
    """Signs g_j(i) in {-1,+1}; float32 (group, 3)."""
    i = np.arange(group, dtype=np.uint32)
    out = np.empty((group, 3), dtype=np.float32)
    salt = np.uint32((seed ^ 0xA5A5A5A5) & 0xFFFFFFFF)
    for j in range(3):
        h = mix32_np(i * np.uint32(3) + np.uint32(j) + salt)
        out[:, j] = np.where(h & np.uint32(1), 1.0, -1.0)
    return out


def rotation_salt(seed: int) -> int:
    """The seed term of the rotation key, as a uint32."""
    return (seed * 2654435761) & _MASK32


# ----------------------------------------------------------------------
# Per-block tables
# ----------------------------------------------------------------------

def block_rotations(block_ids: torch.Tensor, group: int, lanes: int,
                    seed: int) -> torch.Tensor:
    """Rotation offsets rot_j(i, blk) in [0, lanes): int64 (nb, group, 3).

    The key is ``blk * 0x01000193 + 3i + j + salt`` in uint32, as in the
    reference; different blocks realise different hypergraphs.
    """
    dev = block_ids.device
    ids = block_ids.to(torch.int64) & _MASK32
    i = torch.arange(group, dtype=torch.int64, device=dev)
    j = torch.arange(3, dtype=torch.int64, device=dev)
    key = (_mul32(ids, 0x01000193)[:, None, None]
           + i[None, :, None] * 3 + j[None, None, :]
           + rotation_salt(seed)) & _MASK32
    return mix32(key) % lanes


def bloom_positions(ids: torch.Tensor, k: int, m_bits: int,
                    seed: int) -> torch.Tensor:
    """Bloom-filter bit positions of coordinate ids: int64 (..., k) in
    [0, m_bits).

    The key of hash ``j`` is ``ids * k + j + (seed ^ 0xB10053)`` in
    uint32, mixed and reduced mod ``m_bits``, as in the reference.
    """
    ids = ids.to(torch.int64) & _MASK32
    ks = torch.arange(k, dtype=torch.int64, device=ids.device)
    key = (_mul32(ids, k)[..., None] + ks
           + ((seed ^ 0xB10053) & _MASK32)) & _MASK32
    return mix32(key) % m_bits
