"""whisper-tiny — encoder-decoder, conv/audio frontend stubbed
[arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865, enc_seq=1500.
The batch carries precomputed frame embeddings (``frames``: 1500 a row)
in place of the log-mel convolution frontend; the decoder's positions
use RoPE, as in the reference.
"""
import dataclasses

from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from .base import ArchSpec

_MODEL = ModelConfig(
    name="whisper-tiny", family="encdec", n_layers=4, enc_layers=4,
    d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    enc_seq=1500, tie_embeddings=True, supports_long_context=False)

_SMOKE = dataclasses.replace(
    _MODEL, n_layers=2, enc_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, enc_seq=64, dtype="float32", q_block=64)

ARCH = ArchSpec(
    model=_MODEL, smoke=_SMOKE,
    train=TrainConfig(
        aggregator="compressed",
        accum_steps=8,
        compression=CompressionConfig(ratio=0.1, topk_ratio=0.04),
        optimizer=OptimizerConfig(kind="adamw")),
    source="arXiv:2212.04356")
