"""Shared layers: norms, RoPE, attention, SwiGLU / GELU MLPs, MoE.

Functional, as in the reference: ``init_*`` build param subtrees (plain
dicts of tensors, weights ``(in, out)``, layers stacked on dim 0 via the
``lead`` shape), and the apply functions are pure tensor functions.

Training and prefill attention is the reference's ``flash_attention``,
blockwise with an online softmax (:func:`flash_attention`), causal or
not, self or cross (keys from another sequence, of any length): f32
scores, the causal mask at -1e30, unnormalised probabilities cast to the
value dtype before the value product, division by the softmax sum after
it. The reference's is jnp, not a Pallas kernel, so no hand kernel is
owed: its block products are ``torch.matmul``. Decode
(``attention_decode``, ``attention_cross_decode``) is one pass and
normalises before its value product, as the reference's does.

Inside a model region (``repro_torch.parallel.hints.model_region``) the
training layers run on their shards of the model axis, Megatron-style:
``wq/wk/wv`` (and ``bq/bk/bv``), ``w_gate/w_up`` are column shards
(heads ``H/MP`` and ``KV/MP`` a rank), ``wo`` and ``w_down`` row shards
whose partial outputs are summed over the axis (``reduce_from_model``),
their inputs entering through ``copy_to_model``; the MoE layer's routed
experts are split into contiguous groups of ``E/MP`` (see
:func:`moe_ffn`). Where MP does not divide the KV heads the ``KV·hd``
columns are split evenly all the same, and gathered whole before RoPE
(:func:`attention_train`). Under kimi-k2's profile the routed experts
are split over the data ranks instead, their ``d_ff`` over the model
ranks (:func:`_moe_data_axis`). Outside a region nothing changes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import hints
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


def init_layernorm(d: int, lead: Tuple[int, ...] = (), device=None):
    return {"scale": torch.ones(lead + (d,), dtype=torch.float32, device=device),
            "bias": torch.zeros(lead + (d,), dtype=torch.float32, device=device)}


def layernorm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """The reference's LayerNorm: f32 mean and (biased) variance,
    ``(x - mu) * rsqrt(var + eps)``, scale and bias, cast back."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig,
                      col0: int = 0) -> torch.Tensor:
    """-1e30 in the padding columns of a padded-vocab logit tensor whose
    first column is vocab id ``col0`` (a vocab shard's offset)."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device) + col0
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
                   lead: Tuple[int, ...] = (), cross: bool = False):
    """q/k/v/o projections, and the q/k/v biases where ``cfg.qkv_bias``
    and not ``cross`` (a cross-attention layer has none)."""
    D, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.activation_dtype
    p = {
        "wq": dense_init(gen, lead + (D, H * hd), D, dt),
        "wk": dense_init(gen, lead + (D, KV * hd), D, dt),
        "wv": dense_init(gen, lead + (D, KV * hd), D, dt),
        "wo": dense_init(gen, lead + (H * hd, D), H * hd, dt),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dt, device=gen.device)
    return p


def _kv_split_uneven(cfg: ModelConfig) -> bool:
    """In a model region whose MP does not divide the KV heads: each rank
    holds an even column slice of ``wk`` / ``wv`` (``KV·hd/MP``), which
    may end inside a head."""
    group = hints.model_group()
    return group is not None and cfg.n_kv_heads % group.workers != 0


def _q_split_uneven(cfg: ModelConfig) -> bool:
    """In a model region whose MP does not divide the query heads: each
    rank holds an even column slice of ``wq`` (``H·hd/MP``, which may end
    inside a head) and the same rows of ``wo``."""
    group = hints.model_group()
    return group is not None and cfg.n_heads % group.workers != 0


def _own_columns(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """This model rank's columns of the whole attention output ``o``:
    those its row shard of ``wo`` multiplies."""
    n, t = wo.shape[0], hints.model_index()
    return o[..., t * n:(t + 1) * n]


def _project_qkv(x, p, cfg: ModelConfig, kv_input=None):
    """Returns q (B,S,H,hd), k/v (B,Skv,KV,hd): k and v from ``kv_input``
    (B,Skv,D) where given (cross-attention), else from ``x``. On column
    shards of the projections, the heads are this rank's; where MP does
    not divide the KV heads (:func:`_kv_split_uneven`), k and v are
    every rank's column slices gathered whole (``hints.
    gather_from_model``), all KV heads, and where it does not divide the
    query heads (:func:`_q_split_uneven`) q too."""
    B, S, _ = x.shape
    kv_x = x if kv_input is None else kv_input
    q, k, v = x @ p["wq"], kv_x @ p["wk"], kv_x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if _q_split_uneven(cfg):
        q = hints.gather_from_model(q)
    if _kv_split_uneven(cfg):
        k, v = hints.gather_from_model(k), hints.gather_from_model(v)
    Skv = kv_x.shape[1]
    return (q.reshape(B, S, -1, cfg.hd),
            k.reshape(B, Skv, -1, cfg.hd),
            v.reshape(B, Skv, -1, cfg.hd))


KV_BLOCK = 1024       # the reference's key block (``flash_attention``'s default)


def _block_spans(n: int, block: int):
    """``[start, stop)`` of each block of ``min(block, n)`` over ``range(n)``,
    the last one short where ``n`` is no multiple: the reference pads it,
    and its padded keys (masked) and queries (dropped) change no kept
    value but for the order of a row's sum of ``p``."""
    b = min(block, n)
    return [(a, min(a + b, n)) for a in range(0, n, b)]


def _block_pairs(sq: int, skv: int, causal: bool, q_block: int, kv_block: int,
                 q_offset: int, skip: bool = True):
    """``[(q span, [(k span, masked), ...]), ...]``: the key blocks each
    query block visits in ascending order, and whether the causal mask
    hides some key of the pair. With ``skip`` a causal key block that lies
    wholly above its query block's diagonal is left out: every score there
    is -1e30, so ``p`` underflows to 0 and ``corr`` is 1, and the block
    adds exactly nothing to a row whose first key block holds a key it
    sees (key 0, which every query sees)."""
    out = []
    for qs in _block_spans(sq, q_block):
        first, last = q_offset + qs[0], q_offset + qs[1] - 1
        row = [(ks, causal and ks[1] - 1 > first)
               for ks in _block_spans(skv, kv_block)
               if not (skip and causal and ks[0] > last)]
        out.append((qs, row))
    return out


def _scores(qb, kb, scale, qs, ks, masked, q_offset):
    """f32 scores ``(B, H, bq, bk)`` of a block pair times ``scale``, -1e30
    where the causal mask hides a key (``masked``: some key is hidden)."""
    s = torch.matmul(qb, kb.transpose(-1, -2)).mul_(scale)
    if masked:
        qpos = torch.arange(qs[0], qs[1], device=s.device) + q_offset
        kpos = torch.arange(ks[0], ks[1], device=s.device)
        s.masked_fill_(qpos[:, None] < kpos[None, :], -1e30)
    return s


def _heads_f32(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> a contiguous f32 (B, H, S, hd)."""
    return x.to(torch.float32).transpose(1, 2).contiguous()


def _flash_forward(q, k, v, vdtype, pairs, q_offset):
    """The reference's online softmax over ``pairs`` -> (out, m, l): the
    normalised output f32 ``(B, H, Sq, hd)``, each row's final running
    max and its sum clamped at 1e-30, f32 ``(B, H, Sq)``. q, k, v are f32
    ``(B, H, S, hd)`` copies of the working-dtype operands, k and v on
    all H heads; ``p`` is cast to ``vdtype`` (the values' dtype) before
    its value product, as the reference's ``p.astype(v_blk.dtype)``."""
    B, H, Sq, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = q.new_empty(q.shape)
    m_all, l_all = q.new_empty((B, H, Sq)), q.new_empty((B, H, Sq))
    for qs, row in pairs:
        qb = q[:, :, qs[0]:qs[1]]
        m = q.new_full(qb.shape[:3], -math.inf)
        l = q.new_zeros(qb.shape[:3])
        acc = q.new_zeros(qb.shape)
        for ks, masked in row:
            s = _scores(qb, k[:, :, ks[0]:ks[1]], scale, qs, ks, masked,
                        q_offset)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = s.sub_(m_new[..., None]).exp_()
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            if vdtype != torch.float32:
                p = p.to(vdtype).to(torch.float32)
            acc.mul_(corr[..., None]).add_(torch.matmul(p, v[:, :, ks[0]:ks[1]]))
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, :, qs[0]:qs[1]] = acc / l[..., None]
        m_all[:, :, qs[0]:qs[1]] = m
        l_all[:, :, qs[0]:qs[1]] = l
    return out, m_all, l_all


class _FlashAttention(torch.autograd.Function):
    """Blockwise attention on all H heads: q ``(B, Sq, H, hd)``, k and v
    ``(B, Skv, H, hd)`` -> ``(B, Sq, H, hd)`` in q's dtype.

    Forward: :func:`_flash_forward` under no autograd, so at most one
    block pair's ``(B, H, bq, bk)`` scores live at a time. It saves q, k,
    v (their working dtype), the f32 output and each row's ``m`` and
    ``l``: O(B·S·H·hd), never the O(B·H·Sq·Skv) probabilities. Backward,
    a query block at a time as the reference's ``checkpoint`` on its
    ``q_step`` recomputes one: each visited pair's scores again, ``P =
    exp(s - m) / l``, ``dV += Pᵀ dO``, ``dP = dO Vᵀ``, ``dS = P (dP - D)``
    with ``D`` the row sum of ``dO · O`` (O in f32), then ``dQ += dS K``
    and ``dK += dSᵀ Q`` times ``1/sqrt(hd)``, all in f32."""

    @staticmethod
    def forward(ctx, q, k, v, pairs, q_offset):
        out, m, l = _flash_forward(_heads_f32(q), _heads_f32(k), _heads_f32(v),
                                   v.dtype, pairs, q_offset)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.pairs, ctx.q_offset = pairs, q_offset
        return out.transpose(1, 2).to(q.dtype,
                                      memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, dout):
        q0, k0, v0, out, m, l = ctx.saved_tensors
        q, k, v = _heads_f32(q0), _heads_f32(k0), _heads_f32(v0)
        do = _heads_f32(dout)
        scale = 1.0 / math.sqrt(q.shape[-1])
        d_row = (do * out).sum(dim=-1)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for qs, row in ctx.pairs:
            sl = slice(qs[0], qs[1])
            qb, dob = q[:, :, sl], do[:, :, sl]
            for ks, masked in row:
                kl = slice(ks[0], ks[1])
                p = _scores(qb, k[:, :, kl], scale, qs, ks, masked,
                            ctx.q_offset)
                p.sub_(m[:, :, sl, None]).exp_().div_(l[:, :, sl, None])
                dv[:, :, kl] += torch.matmul(p.transpose(-1, -2), dob)
                dp = torch.matmul(dob, v[:, :, kl].transpose(-1, -2))
                ds = p.mul_(dp.sub_(d_row[:, :, sl, None])).mul_(scale)
                dq[:, :, sl] += torch.matmul(ds, k[:, :, kl])
                dk[:, :, kl] += torch.matmul(ds.transpose(-1, -2), qb)

        def back(g, like):
            return g.transpose(1, 2).to(like.dtype)
        return back(dq, q0), back(dk, k0), back(dv, v0), None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_block: int, kv_block: int = KV_BLOCK,
                    q_offset: int = 0) -> torch.Tensor:
    """Blockwise online-softmax attention, the reference's
    ``flash_attention`` (``models/layers.py:132-217``) step for step.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's
    dtype. Query head h reads KV head ``h // (H // KV)``: the KV heads
    are expanded to H before the score products. Query blocks of
    ``q_block`` and key blocks of ``kv_block`` (each at most the
    sequence); with ``causal`` query i, at position ``q_offset + i``,
    sees keys ``0..q_offset + i``, masked at -1e30. Per query block the
    running max ``m`` (from -inf) and sum ``l`` (from 0) and the
    accumulator (from 0) are f32; per key block the scores are taken in
    f32 from the working-dtype operands times ``1/sqrt(hd)``, ``m_new =
    max(m, rowmax)``, ``p = exp(s - m_new)``, ``corr = exp(m - m_new)``,
    ``l = l·corr + sum p``, ``acc = acc·corr + p (in v's dtype) @ v`` in
    f32; then ``acc / max(l, 1e-30)`` in q's dtype. A causal key block
    wholly above its query block's diagonal is skipped (it adds exactly
    nothing; ``tests/test_torch_attention.py`` holds skip and no skip bit
    for bit). Autograd keeps O(B·S·H·hd) and recomputes a query block at
    a time (:class:`_FlashAttention`); no library attention is used."""
    Sq, H = q.shape[1:3]
    rep = H // k.shape[2]
    pairs = _block_pairs(Sq, k.shape[1], causal, q_block, kv_block, q_offset)
    return _FlashAttention.apply(q, k.repeat_interleave(rep, dim=2),
                                 v.repeat_interleave(rep, dim=2), pairs,
                                 q_offset)


def attention_train(x, p, cfg: ModelConfig, positions=None, causal=True,
                    kv_input=None):
    """Self- (or, with ``kv_input``, cross-) attention for training and
    prefill. x: (B,S,D) -> ``(out, (k, v))``, as the reference's
    ``attention_train``; prefill keeps ``(k, v)`` as its cache.

    RoPE goes on q and k whenever ``kv_input`` is None, causal or not
    (the reference's rule: the encdec encoder's non-causal
    self-attention takes it too), and never on cross-attention. In a
    model region the heads are this rank's shard and the output is summed
    over the model axis. Where MP divides the KV heads, the shard's query
    head h reads its own KV head ``h // (H/KV)``. Where it does not, the
    reference's even split of the ``KV·hd`` columns may end inside a
    head: k and v are gathered whole (:func:`_project_qkv`), RoPE goes on
    the whole k, and then each of this rank's query heads (global head
    ``g``) takes KV head ``g // (H/KV)`` before ``flash_attention``; the
    prefill cache is the whole (k, v). Where MP does not divide the query
    heads either, q is gathered whole too, every rank attends with all H
    heads and keeps its columns of the output for its rows of ``wo``."""
    B, S, _ = x.shape
    x = hints.copy_to_model(x)
    if kv_input is not None:
        kv_input = hints.copy_to_model(kv_input)
    q, k, v = _project_qkv(x, p, cfg, kv_input=kv_input)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if kv_input is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions[:, :k.shape[1]], cfg.rope_theta)
    kq, vq = k, v
    if _kv_split_uneven(cfg) and not _q_split_uneven(cfg):
        H_loc = q.shape[2]
        heads = hints.model_index() * H_loc + torch.arange(H_loc, device=x.device)
        kv_of = heads // (cfg.n_heads // cfg.n_kv_heads)
        kq, vq = k.index_select(2, kv_of), v.index_select(2, kv_of)
    o = flash_attention(q, kq, vq, causal, cfg.q_block).reshape(B, S, -1)
    if _q_split_uneven(cfg):
        o = _own_columns(o, p["wo"])
    return hints.reduce_from_model(o @ p["wo"]), (k, v)


def kv_whole(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig):
    """``attention_train``'s (k, v) ``(B, S, KV_loc, hd)`` with every KV
    head: in a model region whose ranks split the KV heads, every rank's
    heads gathered in one all-gather (as they are where MP does not
    divide them: ``_project_qkv`` gathered them whole already)."""
    if hints.model_group() is None or k.shape[2] == cfg.n_kv_heads:
        return k, v
    B, S = k.shape[:2]
    n = k.shape[2] * k.shape[3]
    kv = hints.gather_from_model(torch.cat([k.reshape(B, S, n),
                                            v.reshape(B, S, n)], dim=-1))
    kv = kv.reshape(B, S, -1, 2, n)
    return (kv[..., 0, :].reshape(B, S, cfg.n_kv_heads, cfg.hd),
            kv[..., 1, :].reshape(B, S, cfg.n_kv_heads, cfg.hd))


def attention_decode(x, p, cfg: ModelConfig, cache_k, cache_v, position: int,
                     rope: bool = True):
    """Single-token decode. x: (B,1,D); cache_k, cache_v: (B,Skv,KV,hd);
    ``position`` (an int) is where the new token sits (tokens
    ``0..position-1`` are in the cache). Returns ``(out, cache_k,
    cache_v)``: the caches are updated **in place** and returned.

    The reference's step, op for op: RoPE at ``position``; the new K/V
    written at ``min(position, Skv - 1)``, the clamp of its
    ``dynamic_update_slice`` (past the end it overwrites the last entry,
    while RoPE keeps the unclamped position); grouped scores ``(B, KV,
    rep, Skv)`` in f32 from the working-dtype operands, times
    ``1/sqrt(hd)``; -1e30 where ``arange(Skv) > position``; the softmax
    normalised in f32 *before* the weights are cast to the cache's dtype
    (the training attention divides after its value product), then the
    value product in f32 and the output cast to ``x.dtype``.

    In a model region, or with the cache's sequence split over
    ``hints.seq_group()``, :func:`_attention_decode_sharded`."""
    if hints.model_group() is not None or hints.seq_group() is not None:
        return _attention_decode_sharded(x, p, cfg, cache_k, cache_v,
                                         position, rope)
    B, Skv = x.shape[0], cache_k.shape[1]
    KV, hd = cfg.n_kv_heads, cfg.hd
    q, k_new, v_new = _project_qkv(x, p, cfg)                    # q (B,1,H,hd)
    if rope:
        pos = torch.full((B, 1), position, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    at = min(position, Skv - 1)
    cache_k[:, at] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, at] = v_new[:, 0].to(cache_v.dtype)
    qg = q.reshape(B, KV, cfg.n_heads // KV, hd).to(torch.float32)
    s = qg @ cache_k.to(torch.float32).permute(0, 2, 3, 1)        # (B,KV,rep,Skv)
    s = s * (1.0 / math.sqrt(hd))
    s = s.masked_fill(torch.arange(Skv, device=x.device) > position, -1e30)
    w = torch.softmax(s, dim=-1).to(cache_v.dtype)
    o = w.to(torch.float32) @ cache_v.to(torch.float32).transpose(1, 2)
    return o.to(x.dtype).reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


def _attention_decode_sharded(x, p, cfg: ModelConfig, cache_k, cache_v,
                              position: int, rope: bool):
    """:func:`attention_decode` on this rank's column shards of the
    projections and its slice of the cache's sequence (the
    flash-decoding combine that the reference leaves to GSPMD, written
    out).

    The new token's q, K and V columns of every model rank are gathered
    in one all-gather, so every rank holds all H query and KV heads, and
    RoPE goes on the whole q and K. The cache ``(B, S_loc, KV, hd)`` is
    this rank's block of the sequence, block ``i`` of ``hints.
    seq_group()``'s ranks (positions ``[i·S_loc, (i+1)·S_loc)`` of a
    cache of ``Skv = n·S_loc``): the new K/V is written at the global
    ``min(position, Skv - 1)`` by the rank whose block holds it. The
    softmax takes two passes over the group, so that the reference's
    order survives: the all-reduced max ``M`` of the local f32 scores
    (-1e30 where the global index exceeds ``position``), the
    all-reduced sum of ``exp(s - M)``; then each rank casts its
    normalised weights to the cache's dtype, takes its partial value
    product in f32, and the partials are summed. Every rank then holds
    ``o`` of all heads, takes its own heads' columns into its row shard
    of ``wo`` and the products are summed over the model axis. Ranks
    that hold the same rows (the batch replicated over a data axis the
    sequence is split over) compute the same values."""
    B, S_loc = x.shape[0], cache_k.shape[1]
    KV, hd = cfg.n_kv_heads, cfg.hd
    x = hints.copy_to_model(x)
    cols = [x @ p["wq"], x @ p["wk"], x @ p["wv"]]
    if "bq" in p:
        cols = [c + p[b] for c, b in zip(cols, ("bq", "bk", "bv"))]
    widths = [c.shape[-1] for c in cols]
    whole = hints.gather_from_model(torch.cat(cols, dim=-1))
    parts = whole.reshape(B, 1, -1, sum(widths)).split(widths, dim=-1)
    q, k_new, v_new = (t.reshape(B, 1, -1, hd) for t in parts)
    if rope:
        pos = torch.full((B, 1), position, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    seq = hints.seq_group()
    n, idx = (1, 0) if seq is None else (seq.workers, seq.first_worker)
    off = idx * S_loc
    at = min(position, n * S_loc - 1)
    if off <= at < off + S_loc:
        cache_k[:, at - off] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, at - off] = v_new[:, 0].to(cache_v.dtype)
    qg = q.reshape(B, KV, cfg.n_heads // KV, hd).to(torch.float32)
    s = qg @ cache_k.to(torch.float32).permute(0, 2, 3, 1)     # (B,KV,rep,S_loc)
    s = s * (1.0 / math.sqrt(hd))
    s = s.masked_fill(torch.arange(off, off + S_loc, device=x.device)
                      > position, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - (m if seq is None else seq.max([m])))
    l = e.sum(dim=-1, keepdim=True)
    w = (e / (l if seq is None else seq.sum([l]))).to(cache_v.dtype)
    o = w.to(torch.float32) @ cache_v.to(torch.float32).transpose(1, 2)
    if seq is not None:
        o = seq.sum([o])
    o = _own_columns(o.to(x.dtype).reshape(B, 1, -1), p["wo"])
    return hints.reduce_from_model(o @ p["wo"]), cache_k, cache_v


def attention_cross_decode(x, p, cfg: ModelConfig, enc_k, enc_v):
    """Cross-attention for decode: x (B,1,D) against the static encoder
    K/V (B,Senc,KV,hd): no mask, no RoPE, no cache write. The grouped
    scores in f32, the softmax normalised in f32 and cast to the values'
    dtype before the value product, as ``attention_decode``. In a model
    region on this rank's query heads (global head ``g`` reads KV head
    ``g // (H/KV)`` of the whole ``enc_k`` / ``enc_v``), its output
    through ``wo``'s row shard summed over the axis; where MP does not
    divide the query heads, on all of them (q gathered whole), each rank
    keeping its columns of the output."""
    B, hd, KV = x.shape[0], cfg.hd, cfg.n_kv_heads
    scale = 1.0 / math.sqrt(hd)
    if hints.model_group() is not None and not _q_split_uneven(cfg):
        x = hints.copy_to_model(x)
        q = (x @ p["wq"]).reshape(B, -1, 1, hd).to(torch.float32)  # (B,H_loc,1,hd)
        H_loc = q.shape[1]
        heads = hints.model_index() * H_loc + torch.arange(H_loc, device=x.device)
        kv_of = heads // (cfg.n_heads // KV)
        k = enc_k.index_select(2, kv_of).to(torch.float32).permute(0, 2, 3, 1)
        w = torch.softmax(q @ k * scale, dim=-1).to(enc_v.dtype)
        o = w.to(torch.float32) @ enc_v.index_select(2, kv_of).to(
            torch.float32).transpose(1, 2)
        return hints.reduce_from_model(o.to(x.dtype).reshape(B, 1, -1) @ p["wo"])
    x = hints.copy_to_model(x)
    q = hints.gather_from_model(x @ p["wq"])
    q = q.reshape(B, KV, cfg.n_heads // KV, hd).to(torch.float32)
    s = q @ enc_k.to(torch.float32).permute(0, 2, 3, 1) * scale
    w = torch.softmax(s, dim=-1).to(enc_v.dtype)
    o = w.to(torch.float32) @ enc_v.to(torch.float32).transpose(1, 2)
    o = o.to(x.dtype).reshape(B, 1, -1)
    if hints.model_group() is not None:
        o = _own_columns(o, p["wo"])
    return hints.reduce_from_model(o @ p["wo"])


# ----------------------------------------------------------------------
# SwiGLU / GELU MLPs
# ----------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int, dtype,
             lead: Tuple[int, ...] = (), gated: bool = True):
    p = {"w_up": dense_init(gen, lead + (d, f), d, dtype),
         "w_down": dense_init(gen, lead + (f, d), f, dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, lead + (d, f), d, dtype)
    return p


def mlp(x, p):
    """SwiGLU where ``p`` has ``w_gate``, else GELU in its tanh form
    (``jax.nn.gelu``'s default); in a model region on this rank's
    ``d_ff`` shard, its output summed over the model axis."""
    x = hints.copy_to_model(x)
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return hints.reduce_from_model(h @ p["w_down"])


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
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, e_s, torch.ones_like(e_s))                            # (E,)
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

    In a model region (:func:`_moe_model_axis`) the routed experts are
    sharded instead: rank t holds experts ``[t·E/MP, (t+1)·E/MP)``. With
    an experts' data group bound (kimi-k2's profile,
    :func:`_moe_data_axis`) data rank d holds experts ``[d·E/W,
    (d+1)·E/W)``, and on a model axis their ``d_ff`` split over it.
    With a row group bound and no experts' group (serving, whose batch
    is split over the data ranks: ``hints.row_group()``) every rank's
    tokens are gathered and routed as one batch, the reference's serve
    step's routing, and this rank keeps its rows of the result.
    """
    if hints.expert_group() is not None:
        return _moe_data_axis(x, p, m, capacity_factor)
    rows = hints.row_group()
    if rows is None:
        return _moe_local(x, p, m, capacity_factor, ep_exchange)
    # every rank's rows routed as one batch (serving), this rank's kept
    T = x.shape[0]
    out, aux = _moe_local(hints.gather_rows(x), p, m, capacity_factor,
                          ep_exchange)
    return out[rows.first_worker * T:(rows.first_worker + 1) * T], aux


def _moe_local(x, p, m: MoEConfig, capacity_factor, ep_exchange):
    """:func:`moe_ffn` on the rows ``x`` (all of them routed as one
    batch), with the routed experts whole or on the model axis."""
    T, D = x.shape
    E = m.num_experts
    rt = moe_route(x, p, m, capacity_factor)
    if hints.model_group() is not None:
        return _moe_model_axis(x, p, m, rt, ep_exchange)
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

    return _moe_tail(out, x, p, m, rt)


def _moe_tail(out, x, p, m: MoEConfig, rt: MoERouting):
    """The combine cast to ``x``'s dtype, plus the shared experts, and
    the Switch-style load-balance aux loss (over the routed tokens,
    ``rt.tok_slots``' rows)."""
    out = out.to(x.dtype)
    if m.shared_experts:
        out = out + mlp(x, p["shared"])
    frac = rt.counts.to(torch.float32) / max(rt.tok_slots.shape[0] * m.top_k, 1)
    aux = m.num_experts * (frac * rt.probs.mean(dim=0)).sum()
    return out, aux


def _moe_model_axis(x, p, m: MoEConfig, rt: MoERouting, ep_exchange):
    """:func:`moe_ffn` on this rank's contiguous group of ``E_loc =
    E/MP`` experts (the reference's ``P("model", ...)`` split of the
    ``we_*`` leaves, the group ``moe_partials`` gives EP rank t).

    The routing is replicated (every model rank sees the same ``x`` and
    router). Rank t runs only its experts' slots, and its partial
    combine sends every other slot to the trash row, as
    :func:`moe_partials` does; the partials are summed over the model
    axis by ``reduce_from_model`` (``ep_exchange`` None) or by the
    exchange's wire over the model group (``hints.exchange_sum``), whose
    backward is the identity to the partial. ``x`` reaches the experts
    and the slots' routing weights reach the combine through
    ``copy_to_model``, so their gradients (partial on each rank: its
    slots only) are summed over the axis; the router's own input
    gradient is whole on every rank."""
    T, D = x.shape
    E_loc, C = p["we_gate"].shape[0], rt.capacity
    lo = hints.model_index() * E_loc * C
    hi = lo + E_loc * C
    slots = rt.tok_slots
    mine = torch.where((slots >= lo) & (slots < hi), slots - lo,
                       E_loc * C).sort(dim=1).values
    xg = _Dispatch.apply(hints.copy_to_model(x), rt.gather_idx[lo:hi], mine)
    y = moe_experts(xg.reshape(E_loc, C, D), p)
    w = hints.copy_to_model(rt.slot_w)[lo:hi]
    contrib = torch.cat([y.to(torch.float32) * w[:, None],
                         y.new_zeros(1, D, dtype=torch.float32)])
    partial = _combine(contrib, mine)
    if ep_exchange is None:
        out = hints.reduce_from_model(partial)
    else:
        if ep_exchange.group is not hints.model_group():
            raise ValueError("on the model axis the exchange runs over the "
                             "model group")
        out = hints.exchange_sum(partial, ep_exchange)
    return _moe_tail(out, x, p, m, rt)


def _moe_data_axis(x, p, m: MoEConfig, capacity_factor):
    """:func:`moe_ffn` under kimi-k2's profile: the routed experts split
    over the data ranks (``hints.expert_group()``, W of them) in
    contiguous groups of ``E_loc = E/W``, each expert's ``d_ff`` over
    the model ranks where a model axis is bound.

    The reference routes the whole (micro)batch: the capacity ``C =
    ceil(T·K·cf/E)`` is the global ``T``'s and the stable sort orders
    the slots over the global token order, so routing a data rank's own
    tokens at a local capacity would drop other tokens. So the layer's
    tokens are gathered over the data ranks (``hints.gather_rows``, in
    rank order: the global order; serving a batch that the data ranks
    all hold whole gathers nothing and sums the partial combines instead
    of reduce-scattering them), every rank routes them alike (the aux
    loss is the global one), runs its own experts' slots (``x`` through
    ``copy_to_model`` for the ``d_ff`` shards), sums the partial
    ``w_down`` products over the model axis, combines its slots in f32
    (every other slot to the trash row, as :func:`moe_partials`) and
    reduce-scatters the partial combine back to each rank's rows
    (``hints.scatter_rows``). The routing weights need no
    ``copy_to_model``: the expert outputs they scale are whole on every
    model rank. Backward, each data rank's experts see every rank's
    tokens' gradients: their gradient is that of the sum of the W ranks'
    losses (``train/step.py`` scales it by ``1/W``)."""
    X = hints.gather_rows(x)       # x itself where the rows are replicated
    D = x.shape[1]
    rt = moe_route(X, p, m, capacity_factor)
    E_loc, C = p["we_gate"].shape[0], rt.capacity
    lo = hints.expert_group().first_worker * E_loc * C
    hi = lo + E_loc * C
    slots = rt.tok_slots
    mine = torch.where((slots >= lo) & (slots < hi), slots - lo,
                       E_loc * C).sort(dim=1).values
    xg = _Dispatch.apply(hints.copy_to_model(X), rt.gather_idx[lo:hi], mine)
    y = hints.reduce_from_model(
        moe_experts(xg.reshape(E_loc, C, D), p).to(torch.float32))
    contrib = torch.cat([y * rt.slot_w[lo:hi, None], y.new_zeros(1, D)])
    partial = _combine(contrib, mine)
    if hints.row_group() is None:
        # the rows are every data rank's (serving a batch the data axis
        # does not split): the partial combines summed, no autograd
        out = hints.expert_group().sum([partial])
    else:
        out = hints.scatter_rows(partial)
    return _moe_tail(out, x, p, m, rt)
