"""qwen2-7b — dense GQA decoder [arXiv:2407.10671; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, QKV bias.
"""
import dataclasses

from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from .base import ArchSpec

_MODEL = ModelConfig(
    name="qwen2-7b", family="dense", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, qkv_bias=True,
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
    source="arXiv:2407.10671; hf")
