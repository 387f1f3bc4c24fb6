"""Decoder-only LM, dense and moe families.

Layer parameters are stacked on a leading layer axis, as in the
reference, and the forward walks them with a Python loop. The FFN of
every layer is the SwiGLU MLP, or with ``cfg.moe`` set the MoE layer
(``layers.moe_ffn``), whose load-balance losses ``lm_hidden`` sums.
Entry points:

  init_lm(seed, cfg, device)                  -> ParamTree
  lm_hidden(tree, cfg, tokens, ...)           -> (x, aux)
  lm_loss(tree, cfg, batch, ...)              -> (loss, metrics)
  init_cache(tree, cfg, batch, max_len)       -> cache
  lm_prefill(tree, cfg, tokens, max_len)      -> (logits_last, cache)
  lm_decode(tree, cfg, token, cache, position) -> (logits, cache)

The serving functions run no autograd (call them under
``torch.inference_mode()``, as ``serve.engine`` does) and no remat;
``lm_decode`` updates the cache in place.

``ep_exchange`` (the expert-parallel combine wire, from
``core.aggregators.make_exchange``) reaches every MoE layer. ``remat``
takes the reference's policies (:data:`REMAT_POLICIES`, see
:func:`lm_hidden`); any other value raises.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt_lib

from .config import ModelConfig
from .params import ParamTree
from . import layers as L

PORTED_FAMILIES = ("dense", "moe")
REMAT_POLICIES = ("none", "block", "block_nocse", "dots")
# products with no batch dims: ``x @ W`` on a 2-D or 3-D ``x`` (folded to
# 2-D) dispatches to ``aten.mm`` (a forward of the smoke configs, under a
# dispatch mode: granite 15 ``mm`` and 4 ``bmm``, deepseek 17 and 10);
# ``aten.addmm`` is a product with its bias fused, which no layer here
# takes; batched products (attention scores and values, the experts'
# ``torch.bmm``) dispatch to ``aten.bmm``
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _require_ported(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port runs {list(PORTED_FAMILIES)} "
            "only (hybrid, ssm, encdec and vlm are not ported yet)")


def init_lm(seed: int, cfg: ModelConfig, device="cuda") -> ParamTree:
    """Random params from ``seed`` (a torch.Generator on ``device``).
    The numbers differ from the reference's ``jax.random`` init; load the
    reference's params with :func:`repro_torch.convert.params_from_jax`
    where the two must start equal."""
    _require_ported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt, D, Vp, lead = cfg.activation_dtype, cfg.d_model, cfg.padded_vocab, \
        (cfg.n_layers,)
    params: Dict[str, Any] = {
        "embed": L.dense_init(gen, (Vp, D), D, dt),
        "final_norm": L.init_rmsnorm(D, device=device),
        "layers": {
            "ln1": L.init_rmsnorm(D, lead, device),
            "attn": L.init_attention(gen, cfg, lead),
            "ln2": L.init_rmsnorm(D, lead, device),
        },
    }
    if cfg.moe is not None:
        params["layers"]["moe"] = L.init_moe(gen, cfg, lead)
    else:
        params["layers"]["ffn"] = L.init_mlp(gen, D, cfg.d_ff, dt, lead)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (D, Vp), D, dt)
    return ParamTree(params)


def _apply_ffn(x, p, cfg: ModelConfig, decode: bool = False,
               ep_exchange=None):
    """Post-attention FFN (dense or MoE). x: (B, S, D) -> (out, aux).
    ``decode``: the MoE layer routes at ``capacity_factor_decode`` with no
    exchange, as the reference's decode does."""
    B, S, D = x.shape
    if "moe" in p:
        cf = cfg.moe.capacity_factor_decode if decode else None
        out, aux = L.moe_ffn(x.reshape(B * S, D), p["moe"], cfg.moe,
                             capacity_factor=cf,
                             ep_exchange=None if decode else ep_exchange)
        return out.reshape(B, S, D), aux
    return L.mlp(x, p["ffn"]), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def _attn_block(x, p, cfg: ModelConfig, positions, ep_exchange=None):
    """One layer -> (x, aux, (k, v)): the layer's K (after RoPE) and V
    for prefill's cache."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, kv = L.attention_train(h, p["attn"], cfg, positions=positions)
    x = x + o
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    ff, aux = _apply_ffn(h, p, cfg, ep_exchange=ep_exchange)
    return x + ff, aux, kv


def _unembed(tree: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
    return L.mask_padded_vocab((x @ head).to(torch.float32), cfg)


def _layer(stacked: Dict, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _dots_policy(ctx, func, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of the
    products with no batch dims that take part in autograd, recompute
    everything else."""
    if func in _DOTS_SAVED and torch.is_grad_enabled():
        return ckpt_lib.CheckpointPolicy.MUST_SAVE
    return ckpt_lib.CheckpointPolicy.PREFER_RECOMPUTE


class _Remat:
    """One checkpointed block call: its ``context_fn`` and whether the
    backward's recompute is running (``recomputing``)."""

    def __init__(self, policy: str):
        self.policy, self.recomputing = policy, False

    @contextlib.contextmanager
    def _recompute(self, inner):
        self.recomputing = True
        try:
            with inner:
                yield
        finally:
            self.recomputing = False

    def context_fn(self):
        if self.policy == "dots":
            fwd, rec = ckpt_lib.create_selective_checkpoint_contexts(_dots_policy)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, self._recompute(rec)


def lm_hidden(tree: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              remat: str = "none", ep_exchange=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding through all blocks and the final norm -> (x, aux),
    ``aux`` the sum of the layers' MoE load-balance losses.

    ``remat`` is the reference's policy. Under ``"none"`` autograd keeps
    every block's intermediates. Under ``"block"`` and ``"block_nocse"``
    each block call is a non-reentrant
    ``torch.utils.checkpoint.checkpoint``: the forward keeps the block's
    inputs only and the backward runs the block again. The two are the
    same here: their difference in the reference is whether XLA may CSE
    the recompute with the forward, and eager PyTorch has no CSE.
    ``"dots"`` mirrors ``dots_with_no_batch_dims_saveable`` through
    ``create_selective_checkpoint_contexts``: the outputs of ``aten.mm``
    and ``aten.addmm`` (every ``x @ W``: the projections, the MLP and the
    router) are kept, and ``aten.bmm`` (attention scores and values, the
    routed experts) and the elementwise ops recomputed. Non-reentrant,
    since the step takes its gradients with ``torch.autograd.grad``,
    which reentrant checkpoints refuse. The values and gradients equal
    ``"none"``'s bit for bit.

    The recompute leaves out ``ep_exchange``: the wire's value is spliced
    in detached and the backward needs nothing from it (JAX's remat drops
    a ``stop_gradient`` value from its recompute the same way), so the
    exchange's kernels and collectives run once a step under every
    policy."""
    _require_ported(cfg)
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; have {list(REMAT_POLICIES)}")
    x = tree["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        p = _layer(tree["layers"], i)
        if remat == "none":
            x, a, _ = _attn_block(x, p, cfg, positions,
                                  ep_exchange=ep_exchange)
        else:
            rm = _Remat(remat)

            def block(x, p=p, rm=rm):
                ex = None if rm.recomputing else ep_exchange
                return _attn_block(x, p, cfg, positions, ep_exchange=ex)[:2]

            x, a = ckpt_lib.checkpoint(block, x, use_reentrant=False,
                                       context_fn=rm.context_fn)
        aux = aux + a
    return L.rmsnorm(x, tree["final_norm"], cfg.norm_eps), aux


def lm_loss(tree: Dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: str = "none", ep_exchange=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross entropy with the reference's z-loss and aux
    terms; ``ep_exchange`` as in :func:`lm_hidden`."""
    x, aux = lm_hidden(tree, cfg, batch["tokens"], remat=remat,
                       ep_exchange=ep_exchange)
    logits = _unembed(tree, cfg, x)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
    nll = (lse - ll).mean()
    zloss = 1e-4 * lse.square().mean()
    loss = nll + zloss + 0.01 * aux
    return loss, {"nll": nll, "aux": aux, "zloss": zloss}


# ----------------------------------------------------------------------
# Serving: prefill + decode with a KV cache
# ----------------------------------------------------------------------

def init_cache(tree: Dict, cfg: ModelConfig, batch: int, max_len: int
               ) -> Dict[str, torch.Tensor]:
    """The decode cache: ``{"k", "v"}`` of shape ``(L, B, max_len, KV,
    hd)``, zeros in ``cfg.activation_dtype`` on the params' device."""
    _require_ported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dt, dev = cfg.activation_dtype, tree["embed"].device
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def lm_prefill(tree: Dict, cfg: ModelConfig, tokens: torch.Tensor,
               max_len: int | None = None, vis_embed=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the whole prompt -> (logits of the last position ``(B, V)``
    f32, the cache). Each layer is the training block, whose K (after
    RoPE) and V go into a cache of ``max(max_len, S)`` positions, zero
    past the prompt, as the reference's padded scan output. Only the
    last position is unembedded."""
    _require_ported(cfg)
    if vis_embed is not None:
        raise NotImplementedError("vis_embed: the vlm family is not ported")
    B, S = tokens.shape
    cache = init_cache(tree, cfg, B, max(max_len or S, S))
    x = tree["embed"][tokens]
    positions = torch.arange(S, device=tokens.device)[None, :]
    for i in range(cfg.n_layers):
        x, _, (k, v) = _attn_block(x, _layer(tree["layers"], i), cfg,
                                   positions)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    x = L.rmsnorm(x[:, -1:], tree["final_norm"], cfg.norm_eps)
    return _unembed(tree, cfg, x)[:, 0], cache


def lm_decode(tree: Dict, cfg: ModelConfig, token: torch.Tensor,
              cache: Dict[str, torch.Tensor], position: int
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. token: (B,) ids; ``position`` (an int): tokens
    ``0..position-1`` are in the cache. Returns ``(logits (B, V) f32,
    cache)``, the cache updated in place (``layers.attention_decode``,
    whose write clamps at the cache's end). The MoE layers route at
    ``capacity_factor_decode``."""
    _require_ported(cfg)
    x = tree["embed"][token[:, None]]
    for i in range(cfg.n_layers):
        p = _layer(tree["layers"], i)
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        o, _, _ = L.attention_decode(h, p["attn"], cfg, cache["k"][i],
                                     cache["v"][i], position)
        x = x + o
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + _apply_ffn(h, p, cfg, decode=True)[0]
    x = L.rmsnorm(x, tree["final_norm"], cfg.norm_eps)
    return _unembed(tree, cfg, x)[:, 0], cache
