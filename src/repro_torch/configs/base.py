"""Architecture + shape registry machinery.

Each ``configs/<arch>.py`` exposes ``ARCH: ArchSpec`` with the published
``model`` configuration, a reduced same-family ``smoke`` config for CPU
tests, its ``profile`` (the reference's ``ShardingProfile``: which dims
the model axis splits, ``repro_torch.parallel.sharding``; the default
for every arch but kimi-k2), the per-arch ``train`` overrides and the
``source`` it cites. The profile is threaded into ``train.sharding``, as
the reference's ``ArchSpec`` does.

``SHAPES`` holds the reference's four input-shape cells;
``ArchSpec.shape_supported`` applies its rule (``long_500k`` only for
archs that support long context), and ``make_batch_struct`` gives a
training batch's tensors on the ``meta`` device (shapes and dtypes, no
memory), where the reference gives ``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import ShardingProfile
from repro_torch.train.config import TrainConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    model: ModelConfig
    smoke: ModelConfig
    train: TrainConfig
    profile: ShardingProfile = dataclasses.field(default_factory=ShardingProfile)
    source: str = ""

    def __post_init__(self):
        # the profile is authoritative: the train config carries it
        if self.train.sharding is not self.profile:
            object.__setattr__(self, "train", dataclasses.replace(
                self.train, sharding=self.profile))

    def shape_supported(self, shape: ShapeConfig) -> Tuple[bool, str]:
        if shape.name == "long_500k" and not self.model.supports_long_context:
            return False, ("SKIP: full quadratic attention at 524k context "
                           "(sub-quadratic archs only, per brief)")
        return True, ""


def make_batch_struct(cfg: ModelConfig, global_batch: int, seq_len: int
                      ) -> Dict[str, torch.Tensor]:
    """Stand-ins for one training batch on the ``meta`` device: int32
    tokens and labels (B, S), and f32 ``frames`` (encdec) or
    ``vis_embed`` (vlm)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    d = {"tokens": meta((global_batch, seq_len), torch.int32),
         "labels": meta((global_batch, seq_len), torch.int32)}
    if cfg.family == "encdec":
        d["frames"] = meta((global_batch, cfg.enc_seq, cfg.d_model),
                           torch.float32)
    if cfg.family == "vlm":
        d["vis_embed"] = meta((global_batch, cfg.vis_tokens, cfg.d_model),
                              torch.float32)
    return d
