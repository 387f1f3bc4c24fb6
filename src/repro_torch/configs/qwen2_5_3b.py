"""qwen2.5-3b — dense GQA decoder [hf:Qwen/Qwen2.5 family].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936, QKV bias.
"""
import dataclasses

from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from .base import ArchSpec

_MODEL = ModelConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936, qkv_bias=True,
    rope_theta=1e6, supports_long_context=False)

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
    source="hf:Qwen/Qwen2.5-0.5B; hf")
