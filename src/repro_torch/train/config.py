"""Top-level training configuration: aggregation mode (the paper's knob),
data-parallel world, optimizer, memory policy.

The reference's ``TrainConfig`` without ``sharding``: ``workers`` stands
in for the data-parallel world (W workers emulated on one device, see
``core/collectives.LocalWorkers``). ``remat`` defaults to ``"none"``, the
only policy this slice runs.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.config import CompressionConfig
from .optimizer import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    aggregator: str = "compressed"       # "dense" | "compressed"
    compression: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    remat: str = "none"
    accum_steps: int = 1                 # microbatch gradient accumulation
    workers: int = 1                     # data-parallel workers (W)
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
