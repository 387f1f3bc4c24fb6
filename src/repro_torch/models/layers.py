"""Shared layers of the dense decoder: norm, RoPE, attention, SwiGLU.

Functional, as in the reference: ``init_*`` build param subtrees (plain
dicts of tensors, weights ``(in, out)``, layers stacked on dim 0 via the
``lead`` shape), and the apply functions are pure tensor functions.

Attention is plain PyTorch math with the reference's semantics (f32
scores, causal mask at -1e30, f32 softmax, unnormalised probabilities
cast to the value dtype before the value product, division by the
softmax sum after it). The reference's ``flash_attention`` is jnp, not a
Pallas kernel, so no hand kernel is owed; its query/key blocking changes
only the rounding.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------

def init_rmsnorm(d: int, lead: Tuple[int, ...] = (), device=None):
    return {"scale": torch.ones(lead + (d,), dtype=torch.float32, device=device)}


def rmsnorm(x: torch.Tensor, p, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e30 in the padding columns of a padded-vocab logit tensor."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < cfg.vocab, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))


# ----------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------

def rope_frequencies(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Initializers
# ----------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_dim: int, dtype) -> torch.Tensor:
    """Uniform(-1/sqrt(in), 1/sqrt(in)) in f32, cast to ``dtype``, drawn
    from ``gen`` on its device."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.uniform_(-scale, scale, generator=gen).to(dtype)


# ----------------------------------------------------------------------
# Attention (GQA, optional QKV bias)
# ----------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   lead: Tuple[int, ...] = ()):
    D, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.activation_dtype
    p = {
        "wq": dense_init(gen, lead + (D, H * hd), D, dt),
        "wk": dense_init(gen, lead + (D, KV * hd), D, dt),
        "wv": dense_init(gen, lead + (D, KV * hd), D, dt),
        "wo": dense_init(gen, lead + (H * hd, D), H * hd, dt),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dt, device=gen.device)
    return p


def _project_qkv(x, p, cfg: ModelConfig):
    """Returns q (B,S,H,hd), k/v (B,S,KV,hd)."""
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.n_heads, cfg.hd),
            k.reshape(B, S, cfg.n_kv_heads, cfg.hd),
            v.reshape(B, S, cfg.n_kv_heads, cfg.hd))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention. q: (B, S, H, hd); k, v: (B, S, KV, hd) ->
    (B, S, H, hd).

    Query head h reads KV head ``h // (H // KV)``. Scores and the value
    product are taken in f32 from the working-dtype operands, as the
    reference's ``preferred_element_type=f32`` einsums do."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kh = k.repeat_interleave(rep, dim=2)
    vh = v.repeat_interleave(rep, dim=2)
    qf = q.to(torch.float32).transpose(1, 2)                      # (B,H,S,hd)
    s = qf @ kh.to(torch.float32).permute(0, 2, 3, 1) * (1.0 / math.sqrt(hd))
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(pos[:, None] < pos[None, :], -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).to(torch.float32) @ vh.to(torch.float32).transpose(1, 2)
    return (o / l).transpose(1, 2).to(q.dtype)


def attention_train(x, p, cfg: ModelConfig, positions=None):
    """Causal self-attention for training. x: (B,S,D)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v).reshape(B, S, -1)
    return o @ p["wo"]


# ----------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int, dtype,
             lead: Tuple[int, ...] = ()):
    return {"w_up": dense_init(gen, lead + (d, f), d, dtype),
            "w_down": dense_init(gen, lead + (f, d), f, dtype),
            "w_gate": dense_init(gen, lead + (d, f), d, dtype)}


def mlp(x, p):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
