"""Architecture registry machinery.

Each ``configs/<arch>.py`` exposes ``ARCH: ArchSpec`` with the published
``model`` configuration, a reduced same-family ``smoke`` config for CPU
tests, the per-arch ``train`` overrides and the ``source`` it cites. The
reference's sharding profile has no counterpart until tensor parallelism
is ported.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig
from repro_torch.train.config import TrainConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    model: ModelConfig
    smoke: ModelConfig
    train: TrainConfig
    source: str = ""
