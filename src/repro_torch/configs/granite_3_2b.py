"""granite-3-2b — dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base].

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""
import dataclasses

from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from .base import ArchSpec

_MODEL = ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155, qkv_bias=False,
    rope_theta=1e4, supports_long_context=False)

_SMOKE = dataclasses.replace(
    _MODEL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, dtype="float32", q_block=64)

ARCH = ArchSpec(
    model=_MODEL, smoke=_SMOKE,
    train=TrainConfig(
        aggregator="compressed",
        accum_steps=8,
        compression=CompressionConfig(ratio=0.1, topk_ratio=0.04),
        optimizer=OptimizerConfig(kind="adamw")),
    source="hf:ibm-granite/granite-3.0-2b-base; hf")
