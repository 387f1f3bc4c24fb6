"""Model architecture configuration.

Field for field the reference's ``ModelConfig``, ``MoEConfig`` and
``SSMConfig``, with its analytic ``param_count`` and
``active_param_count``. The port builds all six families
(``models/registry.py``).
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
    enc_layers: int = 0           # encdec: encoder depth
    enc_seq: int = 1500           # encdec: encoder frames (whisper stub)
    vis_tokens: int = 0           # vlm: prepended patch-embedding tokens
    q_block: int = 512            # flash_attention's query block
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

    def param_count(self) -> int:
        """The reference's analytic parameter count (embedding + layers,
        for 6ND), formula for formula. It counts the unpadded vocabulary,
        a gated FFN (3·D·F) on every dense layer and two norm vectors an
        attention layer, whatever the family builds: for whisper-tiny
        (GELU MLPs, LayerNorms with biases, a padded vocabulary) it gives
        41,159,040 where the built tree has 36,487,680."""
        D, F, V, hd = self.d_model, self.d_ff, self.vocab, self.hd
        emb = V * D if self.tie_embeddings else 2 * V * D
        total = emb

        def attn_params():
            p = D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * D
            if self.qkv_bias:
                p += self.n_heads * hd + 2 * self.n_kv_heads * hd
            return p

        def dense_ffn():
            return 3 * D * F

        def moe_ffn():
            m = self.moe
            p = D * m.num_experts                                  # router
            p += m.num_experts * 3 * D * m.expert_d_ff             # routed
            p += m.shared_experts * 3 * D * m.expert_d_ff          # shared
            return p

        def ssm_params():
            s = self.ssm
            di = s.d_inner(D)
            nh = s.n_heads(D)
            p = D * di * 2                 # Wx, Wz
            p += 2 * D * s.d_state         # WB, WC
            p += D * nh                    # Wdt
            p += nh * 3                    # A, D, dt_bias
            p += s.d_conv * (di + 2 * s.d_state)
            p += di * D                    # out_proj
            return p

        for layer in range(self.n_layers):
            if self.family == "ssm":
                total += ssm_params() + 2 * D
                continue
            if self.family == "hybrid":
                is_attn = (layer % self.attn_period) == self.attn_offset
                total += (attn_params() if is_attn else ssm_params())
                k = self.moe.every_k_layers if self.moe is not None else 0
                is_moe = k > 0 and (layer % k) == (k - 1)
                total += (moe_ffn() if is_moe else dense_ffn()) + 3 * D
                continue
            # dense / moe / vlm / encdec decoder layers
            total += attn_params() + 2 * D
            if self.moe is not None and (layer % self.moe.every_k_layers == 0):
                total += moe_ffn()
            else:
                total += dense_ffn()
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            total += self.enc_layers * (attn_params() + dense_ffn() + 4 * D)
            total += self.n_layers * attn_params()   # cross-attention
        return total

    def active_param_count(self) -> int:
        """Active (per-token) parameters, for MoE model FLOPs: the
        reference's formula."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_experts = self.n_layers * m.num_experts * 3 * self.d_model * m.expert_d_ff
        if self.family == "hybrid":
            k = m.every_k_layers
            n_moe_layers = sum(1 for l in range(self.n_layers)
                               if l % k == k - 1)
            full_experts = n_moe_layers * m.num_experts * 3 * self.d_model * m.expert_d_ff
            active = n_moe_layers * m.top_k * 3 * self.d_model * m.expert_d_ff
        else:
            active = self.n_layers * m.top_k * 3 * self.d_model * m.expert_d_ff
        return self.param_count() - full_experts + active
