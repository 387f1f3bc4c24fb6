"""Top-level training configuration: aggregation mode (the paper's knob),
data-parallel world, optimizer, memory policy.

The reference's ``TrainConfig`` without ``sharding``: ``workers`` stands
in for the data-parallel world (W workers, emulated on one device or run
as W ranks: see ``core/collectives``) and ``dp_levels`` for the mesh's
data-parallel axes (the level sizes, innermost first, that the
in-network tier's ``tor_spine`` tree maps onto; empty means one level of
all W). ``remat`` defaults to ``"none"``, the only policy the port runs.

``zero1`` is the reference's ``ShardingProfile.zero1``, on by default
as there: the optimizer update is sliced over the W workers on each
leaf's ``streams.zero_slice_dim`` and the updates' deltas all-gathered,
and on ranks each keeps only its slice of the moments; ``False`` takes
the replicated update. ``rs_gather_skip`` is the
reference's: with ``compressed_rs`` and ``zero1``, skip the
recovered-chunk gather where the chunk grid aligns with the ZeRO-1
slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.core.config import CompressionConfig
from .optimizer import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    aggregator: str = "compressed"       # "dense" | "compressed" |
                                         # "compressed_rs" |
                                         # "compressed_innet" | "auto"
    compression: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    remat: str = "none"
    accum_steps: int = 1                 # microbatch gradient accumulation
    workers: int = 1                     # data-parallel workers (W)
    dp_levels: Tuple[int, ...] = ()      # DP level sizes, innermost first
    zero1: bool = True                   # slice the optimizer update over W
    rs_gather_skip: bool = True          # compressed_rs + zero1: skip the
                                         # gather where the grid aligns
    seed: int = 0

    def __post_init__(self):
        from repro_torch.core.aggregators import AGGREGATORS
        if self.aggregator not in AGGREGATORS:
            raise ValueError(
                f"unknown aggregator {self.aggregator!r}; this slice has "
                f"{sorted(AGGREGATORS)}")
        if self.remat != "none":
            raise ValueError(
                f"remat={self.remat!r}: only 'none' is supported in this slice")
        if self.workers < 1 or self.accum_steps < 1:
            raise ValueError("workers and accum_steps must be >= 1")
        if self.dp_levels and math.prod(self.dp_levels) != self.workers:
            raise ValueError(f"dp_levels {self.dp_levels} do not multiply "
                             f"to {self.workers} workers")
