"""Decoder-only LM, dense and moe families.

Layer parameters are stacked on a leading layer axis, as in the
reference, and the forward walks them with a Python loop. The FFN of
every layer is the SwiGLU MLP, or with ``cfg.moe`` set the MoE layer
(``layers.moe_ffn``), whose load-balance losses ``lm_hidden`` sums.
Entry points:

  init_lm(seed, cfg, device)          -> ParamTree
  lm_hidden(tree, cfg, tokens, ...)   -> (x, aux)
  lm_loss(tree, cfg, batch, ...)      -> (loss, metrics)

``ep_exchange`` (the expert-parallel combine wire, from
``core.aggregators.make_exchange``) reaches every MoE layer. Only
``remat="none"`` runs in this port; other values raise.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .config import ModelConfig
from .params import ParamTree
from . import layers as L

PORTED_FAMILIES = ("dense", "moe")


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


def _apply_ffn(x, p, cfg: ModelConfig, ep_exchange=None):
    """Post-attention FFN (dense or MoE). x: (B, S, D) -> (out, aux)."""
    B, S, D = x.shape
    if "moe" in p:
        out, aux = L.moe_ffn(x.reshape(B * S, D), p["moe"], cfg.moe,
                             ep_exchange=ep_exchange)
        return out.reshape(B, S, D), aux
    return L.mlp(x, p["ffn"]), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def _attn_block(x, p, cfg: ModelConfig, positions, ep_exchange=None):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + L.attention_train(h, p["attn"], cfg, positions=positions)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    ff, aux = _apply_ffn(h, p, cfg, ep_exchange=ep_exchange)
    return x + ff, aux


def _layer(stacked: Dict, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def lm_hidden(tree: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              remat: str = "none", ep_exchange=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding through all blocks and the final norm -> (x, aux),
    ``aux`` the sum of the layers' MoE load-balance losses."""
    _require_ported(cfg)
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r}: only 'none' is supported in this port")
    x = tree["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = _attn_block(x, _layer(tree["layers"], i), cfg, positions,
                           ep_exchange=ep_exchange)
        aux = aux + a
    return L.rmsnorm(x, tree["final_norm"], cfg.norm_eps), aux


def lm_loss(tree: Dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: str = "none", ep_exchange=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross entropy with the reference's z-loss and aux
    terms; ``ep_exchange`` as in :func:`lm_hidden`."""
    x, aux = lm_hidden(tree, cfg, batch["tokens"], remat=remat,
                       ep_exchange=ep_exchange)
    head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
    logits = L.mask_padded_vocab((x @ head).to(torch.float32), cfg)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
    nll = (lse - ll).mean()
    zloss = 1e-4 * lse.square().mean()
    loss = nll + zloss + 0.01 * aux
    return loss, {"nll": nll, "aux": aux, "zloss": zloss}
