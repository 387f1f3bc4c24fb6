"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 with MoE [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; one attention
layer per 8 (offset 4); MoE 16 experts top-2 on every other layer.
Sub-quadratic overall: 28 of the 32 layers carry a fixed-size Mamba
state instead of a KV cache.
"""
import dataclasses

from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from .base import ArchSpec

_MODEL = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
    attn_period=8, attn_offset=4,
    moe=MoEConfig(num_experts=16, top_k=2, shared_experts=0,
                  expert_d_ff=14336, every_k_layers=2),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, d_conv=4, chunk=256),
    supports_long_context=True)

_SMOKE = dataclasses.replace(
    _MODEL, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, attn_period=2, attn_offset=1,
    moe=MoEConfig(num_experts=4, top_k=2, shared_experts=0, expert_d_ff=256,
                  every_k_layers=2),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, d_conv=4, chunk=32),
    dtype="float32", q_block=64)

ARCH = ArchSpec(
    model=_MODEL, smoke=_SMOKE,
    train=TrainConfig(
        aggregator="compressed",
        accum_steps=8,
        compression=CompressionConfig(ratio=0.1, topk_ratio=0.04),
        optimizer=OptimizerConfig(kind="adamw", state_dtype="bfloat16")),
    source="arXiv:2403.19887; hf")
