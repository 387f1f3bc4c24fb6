"""Parallel peeling recovery (paper §3.2): the plain PyTorch version.

Given the aggregated sketch ``Y`` and non-zero index ``B`` of a set of
blocks, each round:

1. gathers, on the state at the start of the round, the degree of each
   indexed coordinate's three cells;
2. recovers every coordinate that owns a singleton cell exactly, taking
   the value from the first hash ``j`` whose cell has degree 1;
3. subtracts the recovered values and degrees from all three cells in
   one scatter, and clears the recovered bits.

Coordinates still indexed after the last round fall back to the
median-of-3 estimate. The loop exits at the fixpoint, after at most
``cfg.rounds`` rounds; the CUDA kernels stop each block at its own
fixpoint (blocks do not interact), and the reference's Pallas kernel
always runs ``cfg.rounds`` rounds. All give the same result because a
round that peels nothing changes nothing. A long stream is peeled in
block ranges (``sketch.block_ranges``), each to its own fixpoint, for
the same reason.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import CompressionConfig
from . import hashing
from .sketch import (block_ranges, device_tables, gather_rows, median3,
                     roll_from_sketch, roll_to_sketch, row_lists,
                     scatter_rows)


class PeelResult(NamedTuple):
    values: torch.Tensor      # (nb, G, c) f32 — recovered + estimated
    peeled: torch.Tensor      # (nb, G, c) bool — recovered exactly
    residual: torch.Tensor    # (nb, G, c) bool — indexed, estimate used
    rounds_used: int          # rounds until the fixpoint (<= cfg.rounds)


def peel_blocks(sketch: torch.Tensor, bits: torch.Tensor,
                block_ids: torch.Tensor, cfg: CompressionConfig) -> PeelResult:
    """Recover block values from (sketch (nb,rows,c), bits (nb,G,c) bool,
    block_ids (nb,)), a block range of ``sketch.PASS_ELEMS`` coordinates
    at a time; ``rounds_used`` is the most any range took."""
    ranges = block_ranges(bits.shape[0], bits.shape[1] * bits.shape[2])
    if len(ranges) == 1:
        return _peel(sketch, bits, block_ids, cfg)
    parts = [_peel(sketch[sl], bits[sl], block_ids[sl], cfg) for sl in ranges]
    return PeelResult(values=torch.cat([r.values for r in parts]),
                      peeled=torch.cat([r.peeled for r in parts]),
                      residual=torch.cat([r.residual for r in parts]),
                      rounds_used=max(r.rounds_used for r in parts))


def _peel(sketch: torch.Tensor, bits: torch.Tensor, block_ids: torch.Tensor,
          cfg: CompressionConfig) -> PeelResult:
    rows_flat, signs_t = device_tables(cfg, sketch.device)
    lists = row_lists(cfg, sketch.device)
    signs = signs_t[None, :, :, None]                                # (1,G,3,1)
    rot = hashing.block_rotations(block_ids, cfg.group, cfg.lanes, cfg.seed)

    deg = scatter_rows(roll_to_sketch(bits.to(torch.int32), rot, cfg.lanes),
                       lists)                                         # (nb,rows,c)
    y = sketch.to(torch.float32)
    b = bits.clone()
    x_rec = torch.zeros(bits.shape, dtype=torch.float32, device=sketch.device)
    zero = torch.zeros((), dtype=torch.float32, device=sketch.device)

    it = 0
    while it < cfg.rounds:
        d_at = roll_from_sketch(gather_rows(deg, rows_flat), rot, cfg.lanes)
        val_at = roll_from_sketch(gather_rows(y, rows_flat), rot, cfg.lanes) * signs
        peelable = (d_at == 1) & b[:, :, None, :]
        p0, p1 = peelable[:, :, 0], peelable[:, :, 1]
        any_peel = peelable.any(dim=2)
        # the value of the first singleton hash j (the reference's argmax)
        val = torch.where(p0, val_at[:, :, 0],
                          torch.where(p1, val_at[:, :, 1], val_at[:, :, 2]))
        val = torch.where(any_peel, val, zero)
        y = y - scatter_rows(roll_to_sketch(val, rot, cfg.lanes) * signs,
                             lists)
        deg = deg - scatter_rows(
            roll_to_sketch(any_peel.to(torch.int32), rot, cfg.lanes), lists)
        b = b & ~any_peel
        x_rec = x_rec + val
        it += 1
        if not bool(any_peel.any()):
            break

    est = median3(roll_from_sketch(gather_rows(y, rows_flat), rot, cfg.lanes) * signs)
    values = x_rec + torch.where(b, est, zero)
    return PeelResult(values=values, peeled=bits & ~b, residual=b,
                      rounds_used=it)
