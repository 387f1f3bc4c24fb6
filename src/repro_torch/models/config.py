"""Model architecture configuration.

Field for field the reference's ``ModelConfig``, ``MoEConfig`` and
``SSMConfig``. The port builds the dense, moe, ssm, hybrid and vlm
families (``models/transformer.py`` raises on encdec).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    shared_experts: int = 0
    expert_d_ff: int = 0          # per-expert FFN width
    capacity_factor: float = 1.25
    capacity_factor_decode: float = 2.0   # decode batches are small; give
                                          # routing more headroom
    router_aux_coef: float = 0.01
    every_k_layers: int = 1       # 1 = every layer is MoE


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 256              # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0          # hybrid: 1 attention layer per this many
    attn_offset: int = 4          # hybrid: position of attn inside a period
    enc_layers: int = 0
    enc_seq: int = 1500
    vis_tokens: int = 0           # vlm: prepended patch-embedding tokens
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
