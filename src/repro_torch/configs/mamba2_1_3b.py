"""mamba2-1.3b — attention-free SSD [arXiv:2405.21060].

48L d_model=2048, ssm_state=128, headdim=64, expand 2, vocab 50280.
Sub-quadratic: a fixed-size state a layer, no KV cache.
"""
import dataclasses

from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from .base import ArchSpec

_MODEL = ModelConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=64, n_kv_heads=64, d_ff=0, vocab=50280, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, d_conv=4, chunk=256),
    supports_long_context=True)

_SMOKE = dataclasses.replace(
    _MODEL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, vocab=512,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, d_conv=4, chunk=32),
    dtype="float32")

ARCH = ArchSpec(
    model=_MODEL, smoke=_SMOKE,
    train=TrainConfig(
        aggregator="compressed",
        accum_steps=8,
        compression=CompressionConfig(ratio=0.1, topk_ratio=0.04),
        optimizer=OptimizerConfig(kind="adamw")),
    source="arXiv:2405.21060")
