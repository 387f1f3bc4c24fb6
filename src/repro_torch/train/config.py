"""Top-level training configuration: aggregation mode (the paper's knob),
data-parallel world, optimizer, memory policy.

The reference's ``TrainConfig``: ``workers`` stands in for the
data-parallel world (W workers, emulated on one device or run as W
ranks: see ``core/collectives``) and ``dp_levels`` for the mesh's
data-parallel axes (the level sizes, innermost first, that the
in-network tier's ``tor_spine`` tree maps onto; empty means one level of
all W). ``sharding`` is the reference's ``ShardingProfile``: on a grid
of W x MP ranks (``launch/mesh.py``) it says which dims of each leaf the
model axis splits (``parallel/sharding.param_pspecs``); the step reads
it where MP > 1, and on W > 1 ranks under a profile with no DP axes
(kimi-k2's: the experts over the data ranks, ``train/step.py``). The
update's ZeRO-1 switch is ``zero1`` below;
the profile's own ``zero1`` field is kept as the reference's.

``remat`` is the reference's memory policy, ``"block"`` by default as
there: ``"none"``, ``"block"`` and ``"block_nocse"`` (one checkpoint a
transformer block; the same in eager PyTorch) and ``"dots"`` (a block's
products with no batch dims saved, the rest recomputed); see
``models/transformer.lm_hidden``. Where the reference runs any other
value as ``"none"``, the port raises.

``ep_exchange`` is the reference's: the wire of the MoE layers'
expert-parallel combine (``"none"`` keeps the local combine;
``"dense"`` / ``"compressed"`` name an exchange of
``core.aggregators.EXCHANGES``), and ``ep_workers`` the size of the
reference's ``ShardingProfile.ep_axes``: the EP ranks each
data-parallel worker's forward emulates (``workers x ep_workers``
devices whose EP ranks share their worker's rows). The exchange runs
only for a MoE model with ``ep_workers > 1``, or on a grid of MP > 1
model ranks, which are then the EP ranks (``ep_workers`` 1 or MP).

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
from repro_torch.parallel.sharding import ShardingProfile
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
    sharding: ShardingProfile = dataclasses.field(
        default_factory=ShardingProfile)
    remat: str = "block"                 # "none" | "block" |
                                         # "block_nocse" | "dots"
    accum_steps: int = 1                 # microbatch gradient accumulation
    workers: int = 1                     # data-parallel workers (W)
    dp_levels: Tuple[int, ...] = ()      # DP level sizes, innermost first
    zero1: bool = True                   # slice the optimizer update over W
    rs_gather_skip: bool = True          # compressed_rs + zero1: skip the
                                         # gather where the grid aligns
    ep_exchange: str = "none"            # MoE combine wire: "none" |
                                         # "dense" | "compressed"
    ep_workers: int = 1                  # EP ranks a data-parallel worker
    seed: int = 0

    def __post_init__(self):
        from repro_torch.core.aggregators import AGGREGATORS, EXCHANGES
        if self.aggregator not in AGGREGATORS:
            raise ValueError(
                f"unknown aggregator {self.aggregator!r}; the port has "
                f"{sorted(AGGREGATORS)}")
        if self.ep_exchange != "none" and self.ep_exchange not in EXCHANGES:
            raise ValueError(
                f"unknown ep_exchange {self.ep_exchange!r}; have "
                f"{['none'] + sorted(EXCHANGES)}")
        if self.ep_workers < 1:
            raise ValueError(f"ep_workers must be >= 1, got {self.ep_workers}")
        from repro_torch.models.transformer import REMAT_POLICIES
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat {self.remat!r}; have "
                             f"{list(REMAT_POLICIES)}")
        if self.workers < 1 or self.accum_steps < 1:
            raise ValueError("workers and accum_steps must be >= 1")
        if self.dp_levels and math.prod(self.dp_levels) != self.workers:
            raise ValueError(f"dp_levels {self.dp_levels} do not multiply "
                             f"to {self.workers} workers")
