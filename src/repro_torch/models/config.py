"""Model architecture configuration.

Field for field the reference's ``ModelConfig``; this slice builds the
dense family only (``models/transformer.py`` raises on the others), so
``moe`` and ``ssm`` stay opaque here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    head_dim: Optional[int] = None
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Any = None
    ssm: Any = None
    attn_period: int = 0
    attn_offset: int = 4
    enc_layers: int = 0
    enc_seq: int = 1500
    vis_tokens: int = 0
    q_block: int = 512            # kept for parity; attention is one block
    dtype: str = "bfloat16"
    supports_long_context: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 128; padded logit columns are masked."""
        return -(-self.vocab // 128) * 128

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32
