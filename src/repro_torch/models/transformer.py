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
            x, a = _attn_block(x, p, cfg, positions, ep_exchange=ep_exchange)
        else:
            rm = _Remat(remat)

            def block(x, p=p, rm=rm):
                ex = None if rm.recomputing else ep_exchange
                return _attn_block(x, p, cfg, positions, ep_exchange=ex)

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
    head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
    logits = L.mask_padded_vocab((x @ head).to(torch.float32), cfg)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
    nll = (lse - ll).mean()
    zloss = 1e-4 * lse.square().mean()
    loss = nll + zloss + 0.01 * aux
    return loss, {"nll": nll, "aux": aux, "zloss": zloss}
