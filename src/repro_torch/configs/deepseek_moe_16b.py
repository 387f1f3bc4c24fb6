"""deepseek-moe-16b — fine-grained MoE [arXiv:2401.06066; hf].

28L d_model=2048 16H (MHA kv=16) expert_d_ff=1408 vocab=102400;
2 shared + 64 routed experts, top-6.
"""
import dataclasses

from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from .base import ArchSpec

_MODEL = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    moe=MoEConfig(num_experts=64, top_k=6, shared_experts=2,
                  expert_d_ff=1408),
    rope_theta=1e4, supports_long_context=False)

_SMOKE = dataclasses.replace(
    _MODEL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512,
    moe=MoEConfig(num_experts=8, top_k=2, shared_experts=2, expert_d_ff=128),
    dtype="float32", q_block=64)

ARCH = ArchSpec(
    model=_MODEL, smoke=_SMOKE,
    train=TrainConfig(
        aggregator="compressed",
        accum_steps=8,
        # expert grads are naturally sparse (the paper's NCF regime):
        # no top-k needed for losslessness at 10% wire size
        compression=CompressionConfig(ratio=0.1, topk_ratio=0.04),
        optimizer=OptimizerConfig(kind="adamw")),
    source="arXiv:2401.06066; hf")
