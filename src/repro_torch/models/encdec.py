"""Whisper-style encoder-decoder (the encdec family), audio frontend
stubbed: the reference's ``models/encdec.py``, function for function.

The encoder takes precomputed frame embeddings ``frames`` (B, enc_seq,
D), adds a sinusoid and runs ``enc_layers`` pre-LayerNorm blocks of
non-causal self-attention and a GELU MLP; the decoder runs ``n_layers``
blocks of causal self-attention, cross-attention to the encoder's output
and a GELU MLP, with logits tied to the token embedding. As in the
reference, every self-attention takes RoPE (the encoder's too, beside
the sinusoid) and cross-attention none; the q/k/v projections carry no
bias.

The params are the reference's tree: ``embed``, ``enc_layers`` and
``dec_layers`` stacked on a leading layer axis, ``enc_ln_post`` and
``dec_ln``, so ``ParamTree``'s sorted flatten order, the bucket plan and
the gradient stream are the reference's. The decode cache is ``{"k",
"v"}`` of ``(n_layers, B, max_len, KV, hd)`` (the decoder's self K/V,
written in place by decode) and ``{"xk", "xv"}`` of ``(n_layers, B,
enc_seq, KV, hd)`` (the cross K/V, computed once by prefill).

Entry points:

  init_encdec(seed, cfg, device)                         -> ParamTree
  encode(tree, cfg, frames)                              -> (B, enc_seq, D)
  encdec_loss(tree, cfg, batch, remat, ep_exchange=None) -> (loss, metrics)
  encdec_prefill(tree, cfg, frames, tokens, max_len)     -> (logits, cache)
  init_encdec_cache(tree, cfg, batch, max_len)           -> cache
  encdec_decode(tree, cfg, token, cache, position)       -> (logits, cache)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt_lib

from .config import ModelConfig
from .params import ParamTree
from repro_torch.parallel import hints
from .transformer import (REMAT_POLICIES, _check_region, _layer, put_kv,
                          seq_block)
from . import layers as L

# the reference checkpoints the decoder's scan body under these policies
# and under no other: for encdec ``dots`` recomputes the whole block, and
# ``block_nocse`` runs as ``none``
_CHECKPOINTED = ("block", "dots")


def init_encdec(seed: int, cfg: ModelConfig, device="cuda") -> ParamTree:
    """Random params from ``seed`` (a torch.Generator on ``device``), the
    reference's tree; the numbers differ from its ``jax.random`` init
    (load those with :func:`repro_torch.convert.params_from_jax`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt, D, F = cfg.activation_dtype, cfg.d_model, cfg.d_ff
    enc, dec = (cfg.enc_layers,), (cfg.n_layers,)
    return ParamTree({
        "embed": L.dense_init(gen, (cfg.padded_vocab, D), D, dt),
        "enc_layers": {
            "ln1": L.init_layernorm(D, enc, device),
            "attn": L.init_attention(gen, cfg, enc),
            "ln2": L.init_layernorm(D, enc, device),
            "mlp": L.init_mlp(gen, D, F, dt, enc, gated=False)},
        "enc_ln_post": L.init_layernorm(D, device=device),
        "dec_layers": {
            "ln1": L.init_layernorm(D, dec, device),
            "attn": L.init_attention(gen, cfg, dec),
            "ln_x": L.init_layernorm(D, dec, device),
            "xattn": L.init_attention(gen, cfg, dec, cross=True),
            "ln2": L.init_layernorm(D, dec, device),
            "mlp": L.init_mlp(gen, D, F, dt, dec, gated=False)},
        "dec_ln": L.init_layernorm(D, device=device),
    })


def _sinusoid(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) f32: sin and cos of ``pos / 10000^(2i/d)``, concatenated
    (not interleaved)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(tree: Dict, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, enc_seq, D), the stub frontend's embeddings -> the
    encoder's states: cast to the activation dtype, the sinusoid added in
    that dtype, the blocks, the final LayerNorm."""
    x = frames.to(cfg.activation_dtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    eps = cfg.norm_eps
    for i in range(cfg.enc_layers):
        p = _layer(tree["enc_layers"], i)
        h = L.layernorm(x, p["ln1"], eps)
        o, _ = L.attention_train(h, p["attn"], cfg, causal=False)
        x = x + o
        x = x + L.mlp(L.layernorm(x, p["ln2"], eps), p["mlp"])
    return L.layernorm(x, tree["enc_ln_post"], eps)


def _dec_block(x, p, cfg: ModelConfig, enc_out, positions):
    """One decoder layer -> (x, (k, v), (xk, xv)): the self K (after
    RoPE) and V, and the cross K/V of the encoder's states."""
    eps = cfg.norm_eps
    h = L.layernorm(x, p["ln1"], eps)
    o, kv = L.attention_train(h, p["attn"], cfg, positions=positions)
    x = x + o
    h = L.layernorm(x, p["ln_x"], eps)
    o, xkv = L.attention_train(h, p["xattn"], cfg, causal=False,
                               kv_input=enc_out)
    x = x + o
    h = L.layernorm(x, p["ln2"], eps)
    return x + L.mlp(h, p["mlp"]), kv, xkv


def _logits(tree: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Tied logits ``x @ embed.T`` in the working dtype, then f32, the
    padded vocabulary masked; in a model region this rank's vocab
    columns (``embed``'s row shard, transposed)."""
    head = tree["embed"].T
    logits = (hints.copy_to_model(x) @ head).to(torch.float32)
    return L.mask_padded_vocab(logits, cfg, hints.model_index() * head.shape[-1])


def encdec_loss(tree: Dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                remat: str = "none", ep_exchange=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: frames (B, enc_seq, D), tokens (B, S), labels (B, S) -> the
    mean cross entropy, ``{"nll", "aux"}`` (aux 0: no z-loss, no MoE).

    ``remat``, as the reference's: under ``"block"`` and ``"dots"`` each
    decoder layer is a non-reentrant ``torch.utils.checkpoint`` (the
    whole block recomputed in the backward; the encoder is never
    checkpointed); ``"none"`` and ``"block_nocse"`` keep every
    intermediate. The values and gradients equal ``"none"``'s bit for bit.
    ``ep_exchange`` exists for the train step's call; the family has no
    MoE, so anything but None raises.

    In a model region (``parallel.hints.model_region``) the tree holds
    this rank's shards: the encoder's and decoder's self-attention, the
    cross-attention (its ``kv_input`` entering through
    ``copy_to_model``) and the GELU MLPs run tensor-parallel
    (``layers.attention_train``, ``layers.mlp``), the embedding is a
    lookup of this rank's vocab rows summed over the axis, and the tied
    head gives this rank's logit columns, whose ``logsumexp`` and label
    logit are taken over the vocab shards (``hints.vocab_parallel_lse``).
    The frames, the sinusoid and the LayerNorms are replicated."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; have {list(REMAT_POLICIES)}")
    _check_region(cfg)
    if ep_exchange is not None:
        raise ValueError("the encdec family has no MoE layer for an "
                         "expert-parallel exchange")
    enc_out = encode(tree, cfg, batch["frames"])
    tokens, labels = batch["tokens"], batch["labels"]
    x = hints.vocab_embed(tree["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x, p):
        return _dec_block(x, p, cfg, enc_out, positions)[0]

    for i in range(cfg.n_layers):
        p = _layer(tree["dec_layers"], i)
        if remat in _CHECKPOINTED:
            x = ckpt_lib.checkpoint(body, x, p, use_reentrant=False)
        else:
            x = body(x, p)
    x = L.layernorm(x, tree["dec_ln"], cfg.norm_eps)
    lse, ll = hints.vocab_parallel_lse(_logits(tree, cfg, x), labels)
    nll = (lse - ll).mean()
    return nll, {"nll": nll,
                 "aux": torch.zeros((), dtype=torch.float32, device=x.device)}


def init_encdec_cache(tree: Dict, cfg: ModelConfig, batch: int, max_len: int
                      ) -> Dict[str, Any]:
    """Zero decode cache on the params' device, in the activation dtype,
    of ``batch`` rows and ``max_len`` self positions as given (a rank's
    share on the grid)."""
    dt, dev = cfg.activation_dtype, tree["embed"].device
    KV, hd, Ld = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    self_shape, cross_shape = ((Ld, batch, max_len, KV, hd),
                               (Ld, batch, cfg.enc_seq, KV, hd))
    return {"k": torch.zeros(self_shape, dtype=dt, device=dev),
            "v": torch.zeros(self_shape, dtype=dt, device=dev),
            "xk": torch.zeros(cross_shape, dtype=dt, device=dev),
            "xv": torch.zeros(cross_shape, dtype=dt, device=dev)}


def encdec_prefill(tree: Dict, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, max_len: int
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The encoder over ``frames`` and the decoder over the prompt ->
    (last-position logits (B, V) f32, the cache): the self K (after
    RoPE) and V zero-padded to ``max_len`` positions, the cross K/V (no
    RoPE) of the encoder's states.

    In a model region (serving on the grid, ``serve/steps.py``) the
    encoder and the decoder run tensor-parallel, the cross K/V and the
    self K/V are gathered whole over the model axis (every KV head), the
    self cache keeps this rank's block of the ``max_len`` positions
    (``transformer.seq_block``), and the logits are this rank's vocab
    columns."""
    _check_region(cfg)
    enc_out = encode(tree, cfg, frames)
    x = hints.vocab_embed(tree["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    off, n = seq_block(max_len)
    cache = init_encdec_cache(tree, cfg, B, n)
    for i in range(cfg.n_layers):
        x, (k, v), (xk, xv) = _dec_block(x, _layer(tree["dec_layers"], i), cfg,
                                         enc_out, positions)
        k, v = L.kv_whole(k, v, cfg)
        put_kv(cache["k"][i], k, off)
        put_kv(cache["v"][i], v, off)
        cache["xk"][i], cache["xv"][i] = L.kv_whole(xk, xv, cfg)
    x = L.layernorm(x[:, -1:], tree["dec_ln"], cfg.norm_eps)
    return _logits(tree, cfg, x)[:, 0], cache


def encdec_decode(tree: Dict, cfg: ModelConfig, token: torch.Tensor,
                  cache: Dict[str, Any], position: int
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoder step. token: (B,) ids at ``position`` (an int) ->
    (logits (B, V) f32, cache): the self K/V written in place
    (``layers.attention_decode``: RoPE at ``position``, the write clamped
    at the cache's end), the cross K/V read as they are; in a model
    region on this rank's shards and cache block."""
    _check_region(cfg)
    eps = cfg.norm_eps
    x = hints.vocab_embed(tree["embed"], token[:, None])
    for i in range(cfg.n_layers):
        p = _layer(tree["dec_layers"], i)
        h = L.layernorm(x, p["ln1"], eps)
        o, _, _ = L.attention_decode(h, p["attn"], cfg, cache["k"][i],
                                     cache["v"][i], position)
        x = x + o
        h = L.layernorm(x, p["ln_x"], eps)
        x = x + L.attention_cross_decode(h, p["xattn"], cfg, cache["xk"][i],
                                         cache["xv"][i])
        x = x + L.mlp(L.layernorm(x, p["ln2"], eps), p["mlp"])
    x = L.layernorm(x, tree["dec_ln"], eps)
    return _logits(tree, cfg, x)[:, 0], cache
