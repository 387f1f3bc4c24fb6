"""Shared layers of the decoder: norm, RoPE, attention, SwiGLU, MoE.

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
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig


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


# ----------------------------------------------------------------------
# Mixture of Experts (capacity-based gather dispatch)
# ----------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = ()):
    """The router (f32), the routed experts' stacked SwiGLU weights and
    the shared experts' MLP (``shared_experts`` experts wide), as the
    reference's ``init_moe``."""
    m = cfg.moe
    D, f, E = cfg.d_model, m.expert_d_ff, m.num_experts
    dt = cfg.activation_dtype
    p = {"router": dense_init(gen, lead + (D, E), D, torch.float32),
         "we_gate": dense_init(gen, lead + (E, D, f), D, dt),
         "we_up": dense_init(gen, lead + (E, D, f), D, dt),
         "we_down": dense_init(gen, lead + (E, f, D), f, dt)}
    if m.shared_experts:
        p["shared"] = init_mlp(gen, D, m.shared_experts * f, dt, lead)
    return p


def _combine(contrib: torch.Tensor, tok_slots: torch.Tensor) -> torch.Tensor:
    """``out[t] = sum_k contrib[tok_slots[t, k]]``, added in ``k`` order
    (``tok_slots`` ascending along k: the order in which a scatter-add
    over the slots visits a token); the last row of ``contrib`` is the
    zero row that dropped slots read. A gather and K adds: no atomics,
    so the sum and its gradient repeat bit for bit from run to run."""
    out = contrib[tok_slots[:, 0]]
    for k in range(1, tok_slots.shape[1]):
        out = out + contrib[tok_slots[:, k]]
    return out


class _Dispatch(torch.autograd.Function):
    """The dispatch gather ``cat(x, 0)[gather_idx]`` with its transpose
    written as :func:`_combine`: a token's gradient is its K slots'
    cotangents added in ascending slot order, where autograd's own
    transpose (an accumulating ``index_put_``) adds them in an order the
    device picks."""

    @staticmethod
    def forward(ctx, x, gather_idx, tok_slots):
        ctx.save_for_backward(tok_slots)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[gather_idx]

    @staticmethod
    def backward(ctx, g):
        (tok_slots,) = ctx.saved_tensors
        return (_combine(torch.cat([g, g.new_zeros(1, g.shape[1])]), tok_slots),
                None, None)


class MoERouting(NamedTuple):
    """Where a batch of tokens goes (:func:`moe_route`)."""
    probs: torch.Tensor        # (T, E) f32 router probabilities
    counts: torch.Tensor       # (E,) (token, choice) entries an expert
    capacity: int              # C: slots an expert
    gather_idx: torch.Tensor   # (E*C,) each slot's token (T: empty)
    slot_w: torch.Tensor       # (E*C,) f32 each slot's routing weight
    tok_slots: torch.Tensor    # (T, K) each token's slots, ascending
                               # (E*C: a dropped choice)


def moe_route(x: torch.Tensor, p, m: MoEConfig,
              capacity_factor: float | None = None) -> MoERouting:
    """The reference's routing: f32 router logits, softmax, top-k, the
    weights normalised by their sum (floored at 1e-9); a stable sort of
    the (token, choice) entries by expert gives each a rank in its
    expert, kept below the capacity ``C = ceil(T·K·cf/E)``, else sent to
    the trash slot ``E·C``."""
    T = x.shape[0]
    E, K = m.num_experts, m.top_k
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    C = max(1, int(math.ceil(T * K * cf / E)))
    dev = x.device

    logits = x.to(torch.float32) @ p["router"]                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, K, dim=-1)                        # (T, K)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    e_flat = idx.reshape(-1)                                     # (T*K,)
    t_flat = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(e_flat, stable=True)
    e_s, t_s, w_s = e_flat[order], t_flat[order], w.reshape(-1)[order]
    counts = torch.bincount(e_s, minlength=E)                    # (E,)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[e_s]
    keep = rank < C
    slot = torch.where(keep, e_s * C + rank, E * C)              # E*C: trash

    gather_idx = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev
                            ).scatter(0, slot, t_s)[:E * C]
    slot_w = torch.zeros(E * C + 1, dtype=torch.float32, device=dev).scatter(
        0, slot, torch.where(keep, w_s, torch.zeros_like(w_s)))[:E * C]
    entry_slot = torch.empty_like(slot).scatter_(0, order, slot)
    tok_slots = entry_slot.reshape(T, K).sort(dim=1).values
    return MoERouting(probs, counts, C, gather_idx, slot_w, tok_slots)


def moe_experts(xg: torch.Tensor, p) -> torch.Tensor:
    """The routed experts' SwiGLU on their slots: ``(E, C, D) -> (E·C,
    D)``, the three products as batched matmuls (the reference's
    einsums, outside any Pallas kernel)."""
    h = F.silu(torch.bmm(xg, p["we_gate"])) * torch.bmm(xg, p["we_up"])
    y = torch.bmm(h, p["we_down"])
    return y.reshape(-1, y.shape[-1])


def moe_partials(contrib: torch.Tensor, rt: MoERouting, group) -> list:
    """Each local EP rank's payload for the exchange: rank r (of W)
    combines only its expert group's slots (experts ``[r·ceil(E/W),
    ...)``), pads to ``W·T_blk`` rows and cuts ``W`` token blocks,
    ``(W, T_blk, D)``; one single-leaf list a local worker of
    ``group``."""
    T, D = rt.tok_slots.shape[0], contrib.shape[1]
    n_slots = contrib.shape[0] - 1
    W = group.workers
    group_size = -(-(n_slots // rt.capacity) // W)
    dev = contrib.device
    slot_rank = torch.cat([torch.arange(n_slots, device=dev) // rt.capacity
                           // group_size, torch.full((1,), W, device=dev)])
    T_blk = -(-T // W)
    out = []
    for r in range(group.first_worker, group.first_worker + group.local_workers):
        mine = torch.where(slot_rank[rt.tok_slots] == r, rt.tok_slots, n_slots)
        out.append([F.pad(_combine(contrib, mine), (0, 0, 0, W * T_blk - T))
                    .reshape(W, T_blk, D)])
    return out


def moe_ffn(x: torch.Tensor, p, m: MoEConfig,
            capacity_factor: float | None = None, ep_exchange=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) tokens -> (out (T, D), aux_loss scalar): the reference's
    dropping MoE, step for step: the routing (:func:`moe_route`), the
    tokens gathered into ``(E, C, D)``, the experts
    (:func:`moe_experts`) and the f32 weighted combine back onto the
    tokens. The combine is a gather over each token's K slots in
    ascending slot order (:func:`_combine`), which adds what the
    reference's scatter-add adds, in its order; the dispatch's gradient
    is the same sum (:class:`_Dispatch`). Neither uses atomics, so the
    layer and its gradients repeat bit for bit from run to run on the
    card.

    ``ep_exchange`` (from :func:`repro_torch.core.aggregators.
    make_exchange`): each EP rank of its group combines only its expert
    group's slots (:func:`moe_partials`); the exchange merges token
    block r at rank r, a gather of the merged blocks restores ``(T,
    D)``, and the forward takes the wire's value, ``out + (wire - out)
    .detach()``: the gradient runs through the local combine, as the
    reference's ``stop_gradient`` splice. On ``LocalWorkers`` the EP
    ranks share ``x`` and the replicated weights, so the experts run
    once and the W partials differ only in their group mask. The wire
    adds each token's terms group by group, so its value differs from
    the local combine's in the last bits where a token's terms span
    several groups.
    """
    T, D = x.shape
    E = m.num_experts
    rt = moe_route(x, p, m, capacity_factor)
    xg = _Dispatch.apply(x, rt.gather_idx, rt.tok_slots)
    y = moe_experts(xg.reshape(E, rt.capacity, D), p)
    contrib = torch.cat([y.to(torch.float32) * rt.slot_w[:, None],
                         y.new_zeros(1, D, dtype=torch.float32)])
    out = _combine(contrib, rt.tok_slots)
    if ep_exchange is not None:
        group = ep_exchange.group
        with torch.no_grad():                 # the wire carries the value only
            merged = ep_exchange(moe_partials(contrib, rt, group))
            wire = group.gather([m_r[0] for m_r in merged])[:T]
        out = out + (wire - out).detach()
    out = out.to(x.dtype)

    if m.shared_experts:
        out = out + mlp(x, p["shared"])

    # Switch-style load-balance aux loss
    frac = rt.counts.to(torch.float32) / max(T * m.top_k, 1)
    aux = E * (frac * rt.probs.mean(dim=0)).sum()
    return out, aux
