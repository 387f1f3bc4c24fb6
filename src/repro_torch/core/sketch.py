"""Block-local Count Sketch (paper §3.1 + §3.4): the plain PyTorch version.

Every function here works on the block layout ``(nb, G, c)`` of
:mod:`repro_torch.core.blocks`. Batch ``i`` of a block adds its ``c``
values into sketch row ``h_j(i)`` for the three hashes ``j``, rotated by
``rot_j(i, blk)`` lanes and multiplied by the sign ``g_j(i)``:

    Y[h_j(i), (l + rot_j(i,blk)) % c] += g_j(i) * x[i, l]

Linearity gives the homomorphic property ``encode(sum_w X_w) ==
sum_w encode(X_w)`` up to float addition order, so sketches aggregate
with a plain sum.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .config import CompressionConfig
from . import hashing

# coordinates one plain encode or peel pass holds at once: the lane
# gathers materialise (nb, G, 3, c) int64 indices, 3.2 GB at this count,
# so longer streams go through in block ranges (the reference's jnp path
# maps over ``cfg.chunk_blocks`` blocks for the same reason); blocks are
# independent, so the result does not depend on the cut
PASS_ELEMS = 1 << 27


def block_ranges(nb: int, block_elems: int):
    """Slices of at most ``PASS_ELEMS // block_elems`` blocks covering
    ``range(nb)``."""
    per = max(1, PASS_ELEMS // block_elems)
    return [slice(a, min(a + per, nb)) for a in range(0, nb, per)]


def plan_tables(cfg: CompressionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Static (rows, signs) tables: int32 (G, 3), float32 (G, 3)."""
    return (hashing.batch_rows(cfg.group, cfg.rows, cfg.seed),
            hashing.batch_signs(cfg.group, cfg.seed))


@functools.lru_cache(maxsize=64)
def device_tables(cfg: CompressionConfig, device: torch.device):
    """(rows int64 (G*3,), signs f32 (G, 3)) on ``device``, cached."""
    rows_tbl, signs = plan_tables(cfg)
    return (torch.from_numpy(rows_tbl.reshape(-1).astype(np.int64)).to(device),
            torch.from_numpy(signs).to(device))


def plan_row_lists(cfg: CompressionConfig) -> np.ndarray:
    """int64 (rows, K): row r's sources ``t = 3i + j`` (``h_j(i) == r``)
    in ascending order, padded to the longest list with -1."""
    rows_tbl = plan_tables(cfg)[0].reshape(-1)
    lists = [np.flatnonzero(rows_tbl == r) for r in range(cfg.rows)]
    out = np.full((cfg.rows, max(map(len, lists))), -1, np.int64)
    for r, lst in enumerate(lists):
        out[r, :len(lst)] = lst
    return out


class RowLists(NamedTuple):
    """:func:`plan_row_lists` on a device: the sources (padding read as
    source 0), where a list holds no source, how many leading list
    positions every row fills, and each source's row (``index_add_``'s
    index)."""
    src: torch.Tensor       # int64 (rows, K)
    real: torch.Tensor      # bool (rows, K)
    full: int
    rows_flat: torch.Tensor  # int64 (G*3,)


@functools.lru_cache(maxsize=64)
def row_lists(cfg: CompressionConfig, device: torch.device) -> RowLists:
    """:func:`plan_row_lists` on ``device``, cached."""
    lists = plan_row_lists(cfg)
    real = lists >= 0
    return RowLists(src=torch.from_numpy(np.where(real, lists, 0)).to(device),
                    real=torch.from_numpy(real).to(device),
                    full=int(real.all(axis=0).sum()),
                    rows_flat=device_tables(cfg, device)[0])


# ----------------------------------------------------------------------
# Lane rotations (the §3.4 locality randomisation)
# ----------------------------------------------------------------------

def roll_to_sketch(x: torch.Tensor, rot: torch.Tensor, lanes: int) -> torch.Tensor:
    """Forward rotation: x (nb,G,c) -> (nb,G,3,c), out[m] = x[(m-rot)%c]."""
    lane = torch.arange(lanes, device=x.device)
    idx = (lane - rot[..., None]) % lanes                    # (nb,G,3,c)
    return torch.gather(x[:, :, None, :].expand(-1, -1, 3, -1), 3, idx)


def roll_from_sketch(y: torch.Tensor, rot: torch.Tensor, lanes: int) -> torch.Tensor:
    """Inverse rotation: y (nb,G,3,c) -> (nb,G,3,c), out[l] = y[(l+rot)%c]."""
    lane = torch.arange(lanes, device=y.device)
    return torch.gather(y, 3, (lane + rot[..., None]) % lanes)


# ----------------------------------------------------------------------
# Scatter / gather between batches and sketch rows
# ----------------------------------------------------------------------

def scatter_rows(contrib: torch.Tensor, lists: RowLists) -> torch.Tensor:
    """contrib (nb,G,3,c) -> sketch (nb,rows,c), summed at h_j(i).

    Each cell adds its sources in ascending ``t = 3i + j`` from +0.0, the
    hand encode's order, on every device. On the CPU ``index_add_`` adds
    one source slice at a time in index order, which is that order, in
    one call; elsewhere (a CUDA ``index_add_`` adds in atomic order)
    :func:`scatter_rows_ordered` does."""
    if contrib.device.type != "cpu":
        return scatter_rows_ordered(contrib, lists)
    nb, g, _, c = contrib.shape
    out = torch.zeros((nb, lists.src.shape[0], c), dtype=contrib.dtype)
    return out.index_add_(1, lists.rows_flat, contrib.reshape(nb, g * 3, c))


def scatter_rows_ordered(contrib: torch.Tensor, lists: RowLists) -> torch.Tensor:
    """:func:`scatter_rows` by gathers and adds, no atomics: a gather and
    an add a list position (``lists``, :func:`row_lists`). A padding
    entry adds +0.0 (a ``torch.where``, so no infinite source is
    multiplied by 0); no sum that starts at +0.0 can be -0.0, so it
    changes no bit."""
    nb, g, _, c = contrib.shape
    flat = contrib.reshape(nb, g * 3, c)
    zero = torch.zeros((), dtype=contrib.dtype, device=contrib.device)
    out = torch.zeros((nb, lists.src.shape[0], c), dtype=contrib.dtype,
                      device=contrib.device)
    for k in range(lists.src.shape[1]):
        term = flat[:, lists.src[:, k], :]
        if k >= lists.full:
            term = torch.where(lists.real[:, k, None], term, zero)
        out = out + term
    return out


def gather_rows(sketch: torch.Tensor, rows_flat: torch.Tensor) -> torch.Tensor:
    """sketch (nb,rows,c) -> (nb,G,3,c) gathered at h_j(i)."""
    nb, _, c = sketch.shape
    return sketch[:, rows_flat, :].reshape(nb, -1, 3, c)


def median3(est: torch.Tensor) -> torch.Tensor:
    """Median over dim 2 of (nb,G,3,c) as ``v0+v1+v2 - max - min``, in
    the reference's operation order."""
    v0, v1, v2 = est[:, :, 0], est[:, :, 1], est[:, :, 2]
    return (v0 + v1 + v2
            - torch.maximum(torch.maximum(v0, v1), v2)
            - torch.minimum(torch.minimum(v0, v1), v2))


# ----------------------------------------------------------------------
# Encode / estimate
# ----------------------------------------------------------------------

def encode_blocks(xb: torch.Tensor, block_ids: torch.Tensor,
                  cfg: CompressionConfig) -> torch.Tensor:
    """Count-Sketch encode: (nb,G,c) values -> (nb,rows,c) sketch (f32),
    in block ranges of ``PASS_ELEMS`` coordinates."""
    _, signs = device_tables(cfg, xb.device)
    lists = row_lists(cfg, xb.device)
    parts = []
    for sl in block_ranges(xb.shape[0], xb.shape[1] * xb.shape[2]):
        rot = hashing.block_rotations(block_ids[sl], cfg.group, cfg.lanes,
                                      cfg.seed)
        contrib = roll_to_sketch(xb[sl].to(torch.float32), rot, cfg.lanes) \
            * signs[None, :, :, None]
        parts.append(scatter_rows(contrib, lists))
        del contrib
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def estimate_blocks(sketch: torch.Tensor, block_ids: torch.Tensor,
                    cfg: CompressionConfig) -> torch.Tensor:
    """Median-of-3 Count-Sketch estimate for every coordinate: the
    fallback for coordinates peeling cannot resolve, and the whole
    decoder of the sketch-only lossy baseline."""
    rows_flat, signs = device_tables(cfg, sketch.device)
    rot = hashing.block_rotations(block_ids, cfg.group, cfg.lanes, cfg.seed)
    y = roll_from_sketch(gather_rows(sketch, rows_flat), rot, cfg.lanes)
    return median3(y * signs[None, :, :, None])
