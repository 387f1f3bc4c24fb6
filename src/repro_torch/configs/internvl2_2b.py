"""internvl2-2b — VLM: InternViT (stub) + InternLM2 backbone
[arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The vision
frontend is a stub: the batch carries precomputed patch embeddings
(``vis_embed``: 256 tokens, the InternVL pixel-shuffle output)
prepended to the text.
"""
import dataclasses

from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from .base import ArchSpec

_MODEL = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92553, vis_tokens=256,
    rope_theta=1e6, supports_long_context=False)

_SMOKE = dataclasses.replace(
    _MODEL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, vis_tokens=8, dtype="float32", q_block=64)

ARCH = ArchSpec(
    model=_MODEL, smoke=_SMOKE,
    train=TrainConfig(
        aggregator="compressed",
        accum_steps=8,
        compression=CompressionConfig(ratio=0.1, topk_ratio=0.04),
        optimizer=OptimizerConfig(kind="adamw")),
    source="arXiv:2404.16821; hf")
