"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config)
[arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) expert_d_ff=2048 vocab=163840;
384 routed experts top-8 + 1 shared. 1.03T total / ~32B active.

The reference's train settings, field for field: the dense
aggregator, momentum with a bf16 state (AdamW's f32 moments would be
8 TB at this size), top-k without error feedback (its f32 residual would
be 4 TB). Its sharding profile is the reference's: experts over the
data axis and their d_ff over the model axis, gradient DP across pods
only, the batch on the pod and data axes. On a grid of ranks the port runs
it as the reference's pure auto-sharded step (``train/step.py``).
"""
import dataclasses

from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.parallel.sharding import ShardingProfile
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from .base import ArchSpec

_MODEL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840,
    moe=MoEConfig(num_experts=384, top_k=8, shared_experts=1,
                  expert_d_ff=2048),
    rope_theta=1e6, supports_long_context=False)

_SMOKE = dataclasses.replace(
    _MODEL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512,
    moe=MoEConfig(num_experts=8, top_k=2, shared_experts=1, expert_d_ff=128),
    dtype="float32", q_block=64)

ARCH = ArchSpec(
    model=_MODEL, smoke=_SMOKE,
    profile=ShardingProfile(
        dp_axes=(), ep_axes=("data",), ep_ff_axis="model",
        batch_auto_axes=("pod", "data")),
    train=TrainConfig(
        aggregator="dense",
        accum_steps=8,
        # no error feedback: its f32 residual is params-sized
        compression=CompressionConfig(ratio=0.1, topk_ratio=0.04,
                                      error_feedback=False),
        optimizer=OptimizerConfig(kind="momentum", state_dtype="bfloat16")),
    source="arXiv:2501.kimi2 (paper-table)")
