"""Flat-vector <-> block layout used by the compressor.

A leaf of ``n`` elements is padded to ``nb * G * c`` and viewed as
``(nb, G, c)``: ``nb`` independent sketch blocks, each covering ``G``
locality batches of ``c`` consecutive elements.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .config import CompressionConfig


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Static geometry for one gradient leaf."""

    n: int           # true element count
    nb: int          # number of blocks
    group: int       # G
    lanes: int       # c

    @property
    def padded(self) -> int:
        return self.nb * self.group * self.lanes

    @property
    def pad(self) -> int:
        return self.padded - self.n


def make_plan(n: int, cfg: CompressionConfig) -> LeafPlan:
    return LeafPlan(n=n, nb=cfg.num_blocks(n), group=cfg.group, lanes=cfg.lanes)


def to_blocks(x: torch.Tensor, plan: LeafPlan) -> torch.Tensor:
    """Flatten, zero-pad, and reshape to (nb, G, c)."""
    flat = x.reshape(-1)
    if flat.shape[0] != plan.n:
        raise ValueError(f"leaf has {flat.shape[0]} elements, plan expects {plan.n}")
    if plan.pad:
        flat = F.pad(flat, (0, plan.pad))
    return flat.reshape(plan.nb, plan.group, plan.lanes)


def from_blocks(xb: torch.Tensor, plan: LeafPlan, shape=None) -> torch.Tensor:
    """Inverse of :func:`to_blocks` (drops padding)."""
    flat = xb.reshape(-1)[: plan.n]
    return flat.reshape(shape) if shape is not None else flat
