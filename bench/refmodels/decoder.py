"""The decoder LM of the dense and moe families, in plain PyTorch: GQA
attention with rotary embeddings, a SwiGLU MLP or a softmax top-k MoE
with shared experts, every layer alike, RMSNorm, a head tied to the
embedding or not. The default reference module (see the package's doc).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from modelparts import Layout, mm, rmsnorm, rope


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def layout(cfg: Dict) -> Layout:
    """Stacked layers on dim 0; a tied head is the embedding's transpose:
    no ``lm_head`` leaf; the vocabulary padded to a multiple of 128."""
    L, D, H, KV = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = head_dim(cfg)
    Vp = -(-cfg["vocab"] // 128) * 128
    bf, f32 = torch.bfloat16, torch.float32
    dt = bf if cfg.get("dtype", "bfloat16") == "bfloat16" else f32
    leaves = [("embed", (Vp, D), dt, D), ("final_norm/scale", (D,), f32, 0),
              ("layers/attn/wq", (L, D, H * hd), dt, D),
              ("layers/attn/wk", (L, D, KV * hd), dt, D),
              ("layers/attn/wv", (L, D, KV * hd), dt, D),
              ("layers/attn/wo", (L, H * hd, D), dt, H * hd),
              ("layers/ln1/scale", (L, D), f32, 0),
              ("layers/ln2/scale", (L, D), f32, 0)]
    if not cfg.get("tie_embeddings"):
        leaves.append(("lm_head", (D, Vp), dt, D))
    moe = cfg.get("moe")
    if moe:
        E, f, s = moe["num_experts"], moe["expert_d_ff"], moe["shared_experts"]
        leaves += [("layers/moe/router", (L, D, E), f32, D),
                   ("layers/moe/we_gate", (L, E, D, f), dt, D),
                   ("layers/moe/we_up", (L, E, D, f), dt, D),
                   ("layers/moe/we_down", (L, E, f, D), dt, f)]
        if s:
            leaves += [("layers/moe/shared/w_gate", (L, D, s * f), dt, D),
                       ("layers/moe/shared/w_up", (L, D, s * f), dt, D),
                       ("layers/moe/shared/w_down", (L, s * f, D), dt, s * f)]
    else:
        F_ = cfg["d_ff"]
        leaves += [("layers/ffn/w_gate", (L, D, F_), dt, D),
                   ("layers/ffn/w_up", (L, D, F_), dt, D),
                   ("layers/ffn/w_down", (L, F_, D), dt, F_)]
    return sorted(leaves, key=lambda t: t[0].split("/"))


def _attention(h, P, l, cfg, prec):
    B, S, D = h.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = head_dim(cfg)
    q = mm(h, P["layers/attn/wq"][l], prec).view(B, S, H, hd)
    k = mm(h, P["layers/attn/wk"][l], prec).view(B, S, KV, hd)
    v = mm(h, P["layers/attn/wv"][l], prec).view(B, S, KV, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k, v = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in (k, v))
    s = mm(q.transpose(1, 2), k.transpose(-1, -2), prec) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
    o = mm(p, v, prec).transpose(1, 2).reshape(B, S, H * hd)
    return mm(o, P["layers/attn/wo"][l], prec)


def _swiglu(x, gate, up, down, prec):
    return mm(F.silu(mm(x, gate, prec)) * mm(x, up, prec), down, prec)


def _moe(h, P, l, cfg, prec):
    """Top-k routing with the weights renormalised, each expert taking at
    most ``C = ceil(T·K·cf/E)`` tokens in token order (later ones
    dropped), the shared experts on every token, and the load-balance
    term ``E · sum_e (share of choices_e) · (mean probability_e)``."""
    m = cfg["moe"]
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    T, E, K = x.shape[0], m["num_experts"], m["top_k"]
    C = max(1, math.ceil(T * K * m["capacity_factor"] / E))
    probs = torch.softmax(mm(x, P["layers/moe/router"][l], prec), dim=-1)
    w, idx = torch.topk(probs, K, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    chosen = torch.zeros(T, E, dtype=torch.int64, device=x.device).scatter_(1, idx, 1)
    rank = (chosen.cumsum(0) - 1).gather(1, idx)
    keep = rank < C
    out = torch.zeros_like(x)
    for e in range(E):
        t, kk = torch.nonzero((idx == e) & keep, as_tuple=True)
        if t.numel():
            y = _swiglu(x[t], P["layers/moe/we_gate"][l, e], P["layers/moe/we_up"][l, e],
                        P["layers/moe/we_down"][l, e], prec)
            out = out.index_add(0, t, y * w[t, kk][:, None])
    if m["shared_experts"]:
        out = out + _swiglu(x, P["layers/moe/shared/w_gate"][l], P["layers/moe/shared/w_up"][l],
                            P["layers/moe/shared/w_down"][l], prec)
    frac = chosen.sum(0).to(torch.float32) / (T * K)
    aux = E * (frac * probs.mean(0)).sum()
    return out.reshape(B, S, D), aux


def loss_fn(P: Dict[str, torch.Tensor], cfg: Dict, tokens, labels, prec="f32"):
    """Mean next-token cross entropy + ``1e-4`` x mean squared
    log-partition + the configuration's ``router_aux_coef`` x the
    load-balance terms."""
    eps = cfg["norm_eps"]
    x = P["embed"][tokens]
    aux = x.new_zeros(())
    for l in range(cfg["n_layers"]):
        x = x + _attention(rmsnorm(x, P["layers/ln1/scale"][l], eps), P, l, cfg, prec)
        h = rmsnorm(x, P["layers/ln2/scale"][l], eps)
        if cfg.get("moe"):
            y, a = _moe(h, P, l, cfg, prec)
            aux = aux + a
        else:
            y = _swiglu(h, P["layers/ffn/w_gate"][l], P["layers/ffn/w_up"][l],
                        P["layers/ffn/w_down"][l], prec)
        x = x + y
    x = rmsnorm(x, P["final_norm/scale"], eps)
    head = P["embed"].T if cfg.get("tie_embeddings") else P["lm_head"]
    logits = mm(x, head, prec)
    V = cfg["vocab"]
    logits = torch.cat([logits[..., :V], torch.full_like(logits[..., V:], -1e30)], dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None])[..., 0]
    coef = cfg["moe"]["router_aux_coef"] if cfg.get("moe") else 0.0
    return (lse - ll).mean() + 1e-4 * lse.square().mean() + coef * aux


def matmul_params_per_token(cfg: Dict) -> int:
    """The attention projections, the dense MLP or the router, its
    ``top_k`` routed experts and the shared ones, and the head over the
    real vocabulary; the embedding is a lookup and counts nothing."""
    D, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    moe = cfg.get("moe")
    if moe:
        f = moe["expert_d_ff"]
        ffn = D * moe["num_experts"] + (moe["top_k"] + moe["shared_experts"]) * 3 * D * f
    else:
        ffn = 3 * D * cfg["d_ff"]
    return cfg["n_layers"] * (attn + ffn) + D * cfg["vocab"]


def attention_flops_per_token(cfg: Dict, seq_len: int) -> int:
    """The causal score and value products, ``2·2·S·hd·H / 2`` a layer
    forward, three times over for forward and backward (no recompute)."""
    return 6 * seq_len * cfg["n_heads"] * head_dim(cfg) * cfg["n_layers"]
