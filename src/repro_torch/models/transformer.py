"""Decoder-only LM covering the dense / moe / ssm / hybrid / vlm families
(the encdec family is ``models/encdec.py``).

Layer parameters are stacked on a leading layer axis, as in the
reference, and the forward walks them with a Python loop:

- dense, moe and vlm: ``layers``, one attention block a layer; the FFN
  is the SwiGLU MLP, or with ``cfg.moe`` set the MoE layer
  (``layers.moe_ffn``), whose load-balance losses ``lm_hidden`` sums;
  vlm prepends ``vis_embed`` (the stub vision frontend's patch
  embeddings) to the token embeddings, and its loss reads the text
  positions only;
- ssm: ``layers``, one Mamba2 mixer a layer (``models/ssm.py``), no FFN;
- hybrid (jamba): ``superblocks`` of ``attn_period`` layers, keys
  ``pos0..``: attention at ``attn_offset``, Mamba2 elsewhere, an FFN on
  every position, MoE where ``pos % every_k_layers == every_k_layers -
  1``.

Entry points:

  init_lm(seed, cfg, device)                  -> ParamTree
  lm_hidden(tree, cfg, tokens, ...)           -> (x, aux)
  lm_loss(tree, cfg, batch, ...)              -> (loss, metrics)
  init_cache(tree, cfg, batch, max_len)       -> cache
  lm_prefill(tree, cfg, tokens, max_len)      -> (logits_last, cache)
  lm_decode(tree, cfg, token, cache, position) -> (logits, cache)

The serving functions run no autograd (call them under
``torch.inference_mode()``, as ``serve.engine`` does) and no remat;
``lm_decode`` updates the cache in place. The caches are the
reference's trees: ``{"k", "v"}`` of ``(L, B, max_len, KV, hd)`` for the
attention families, ``{"ssm": {"ssm", "conv"}}`` of ``(L, B, ...)`` for
ssm, and for hybrid ``{"mamba": {"ssm", "conv"}}`` of ``(n_super,
attn_period - 1, B, ...)`` beside ``{"kv": {"k", "v"}}`` of ``(n_super,
B, max_len, KV, hd)``.

``ep_exchange`` (the expert-parallel combine wire, from
``core.aggregators.make_exchange``) reaches every MoE layer.

Inside a model region (``parallel.hints.model_region``, bound by the
train step on a grid of MP > 1 model ranks) the tree holds this rank's
shards (``parallel.sharding.param_pspecs``): the layers run
tensor-parallel (``layers``), the embedding is a lookup of this rank's
vocab rows summed over the axis, and the head gives this rank's logit
columns, whose ``logsumexp`` and label logit are taken over the vocab
shards (``hints.vocab_parallel_lse``). Every family runs there
(:func:`check_model_axis`): the vlm's visual prefix is an input, the
same on every model rank; a Mamba layer runs on its head shard
(``models/ssm.py``), in the ssm family and at the hybrid superblock's
Mamba positions; encdec through ``models/encdec.py``. Prefill and decode
run there too, as ``serve/steps.py`` drives them on the grid: the
cache holds this rank's batch rows, its block of the sequence (split
over ``hints.seq_group()``, the reference's ``cache_pspecs``) with every
KV head, and for Mamba this rank's heads of the ``ssm`` state and the
whole ``conv`` state; :func:`init_cache` gives those local shapes,
:func:`lm_prefill` gathers each layer's K/V heads over the model axis
and keeps its sequence block, and decode combines the blocks
(``layers.attention_decode``). The logits are this rank's vocab columns
(the serve steps gather them). ``remat``
takes the reference's policies (:data:`REMAT_POLICIES`, see
:func:`lm_hidden`); any other value raises.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt_lib

from repro_torch.parallel import hints
from .config import ModelConfig
from .params import ParamTree
from . import layers as L
from . import ssm as S

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
REMAT_POLICIES = ("none", "block", "block_nocse", "dots")
# products with no batch dims: ``x @ W`` on a 2-D or 3-D ``x`` (folded to
# 2-D) dispatches to ``aten.mm`` (a forward of the smoke configs, under a
# dispatch mode: granite 15 ``mm`` and 4 ``bmm``, deepseek 17 and 10);
# ``aten.addmm`` is a product with its bias fused, which no layer here
# takes; batched products (attention scores and values, the experts'
# ``torch.bmm``, the SSD scan's einsums) dispatch to ``aten.bmm``
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _require_ported(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port runs {list(PORTED_FAMILIES)} "
            "only, the reference's six")


# the sharding layouts the model axis runs, (tp_axis, vocab_axis,
# ep_axes, ep_ff_axis, manual DP axes or not): the default profile's
# (tensor, vocab and expert dims on ``model``), and kimi-k2's (experts
# over ``data``, their d_ff over ``model``, no manual DP axes: the
# step's gradient is the whole batch's, ``train/step.py``)
MODEL_AXIS_LAYOUTS = {("model", "model", ("model",), None, True): "default",
                      ("model", "model", ("data",), "model", False): "kimi"}


def check_model_axis(cfg: ModelConfig, mp: int, prof=None) -> None:
    """Raise unless ``cfg`` can run on ``mp`` model ranks (under the
    sharding profile ``prof``, where given): a profile of
    :data:`MODEL_AXIS_LAYOUTS` (``NotImplementedError`` for any other),
    and every split dim divisible by ``mp`` (``ValueError``): the query
    columns ``n_heads·hd`` and the KV columns ``n_kv_heads·hd`` (a split
    may fall inside a head, the reference's uneven head split:
    ``layers.attention_train`` gathers such heads whole), the Mamba heads, the
    padded vocab, the dense FFN's ``d_ff``, and the routed experts (the
    default layout) or their ``d_ff`` (kimi's)."""
    if mp <= 1:
        return
    _require_ported(cfg)
    layout = "default" if prof is None else MODEL_AXIS_LAYOUTS.get(
        (prof.tp_axis, prof.vocab_axis, tuple(prof.ep_axes),
         prof.ep_ff_axis, bool(prof.dp_axes)))
    if layout is None:
        raise NotImplementedError(
            f"sharding profile {prof} under model_parallel={mp}: the model "
            f"axis runs the layouts {sorted(MODEL_AXIS_LAYOUTS.values())} "
            "only (the default profile's and kimi-k2's)")
    dims = {"padded_vocab": cfg.padded_vocab}
    if cfg.family != "ssm":
        dims.update({"n_heads * hd": cfg.n_heads * cfg.hd,
                     "n_kv_heads * hd": cfg.n_kv_heads * cfg.hd})
    if cfg.family in ("ssm", "hybrid"):
        dims["ssm n_heads"] = cfg.ssm.n_heads(cfg.d_model)
    if cfg.moe is not None:
        if layout == "default":
            dims["num_experts"] = cfg.moe.num_experts
        else:
            dims["expert_d_ff"] = cfg.moe.expert_d_ff
        dims["shared d_ff"] = cfg.moe.shared_experts * cfg.moe.expert_d_ff
    if cfg.family != "ssm" and (cfg.moe is None or cfg.family == "hybrid"):
        dims["d_ff"] = cfg.d_ff
    for name, n in dims.items():
        if n % mp:
            raise ValueError(f"{cfg.name}: {name} {n} does not split over "
                             f"model_parallel={mp}")


def _check_region(cfg: ModelConfig):
    """:func:`check_model_axis` on the bound model axis, if any."""
    if hints.model_group() is not None:
        check_model_axis(cfg, hints.model_group().workers)


def _require_decoder_lm(cfg: ModelConfig):
    """This module's functions build the decoder LMs; encdec has its own
    (``models/encdec.py``)."""
    _require_ported(cfg)
    if cfg.family == "encdec":
        raise ValueError("the encdec family is built by models/encdec.py")


def _attn_layer_params(gen: torch.Generator, cfg: ModelConfig, lead):
    """An attention layer's params: ``ln1``, ``attn``, ``ln2`` and the
    FFN (``moe`` with ``cfg.moe`` set, else ``ffn``)."""
    dev, D = gen.device, cfg.d_model
    p = {"ln1": L.init_rmsnorm(D, lead, dev),
         "attn": L.init_attention(gen, cfg, lead),
         "ln2": L.init_rmsnorm(D, lead, dev)}
    if cfg.moe is not None:
        p["moe"] = L.init_moe(gen, cfg, lead)
    else:
        p["ffn"] = L.init_mlp(gen, D, cfg.d_ff, cfg.activation_dtype, lead)
    return p


def _hybrid_superblock_params(gen: torch.Generator, cfg: ModelConfig, lead):
    """One jamba-style superblock of ``attn_period`` layers (stacked on
    ``lead``), the reference's ``_init_hybrid_superblock``: attention at
    ``attn_offset``, Mamba2 elsewhere; an FFN on every position, MoE
    where ``pos % every_k_layers == every_k_layers - 1`` (jamba's k = 2:
    the odd positions)."""
    dev, D = gen.device, cfg.d_model
    k_moe = cfg.moe.every_k_layers if cfg.moe is not None else 0
    p: Dict[str, Any] = {}
    for pos in range(cfg.attn_period):
        sub: Dict[str, Any] = {"ln1": L.init_rmsnorm(D, lead, dev)}
        if pos == cfg.attn_offset:
            sub["attn"] = L.init_attention(gen, cfg, lead)
        else:
            sub["mamba"] = S.init_mamba(gen, cfg, lead)
        sub["ln2"] = L.init_rmsnorm(D, lead, dev)
        if cfg.moe is not None and pos % k_moe == k_moe - 1:
            sub["moe"] = L.init_moe(gen, cfg, lead)
        else:
            sub["ffn"] = L.init_mlp(gen, D, cfg.d_ff, cfg.activation_dtype, lead)
        p[f"pos{pos}"] = sub
    return p


def init_lm(seed: int, cfg: ModelConfig, device="cuda") -> ParamTree:
    """Random params from ``seed`` (a torch.Generator on ``device``).
    The numbers differ from the reference's ``jax.random`` init; load the
    reference's params with :func:`repro_torch.convert.params_from_jax`
    where the two must start equal."""
    _require_decoder_lm(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt, D, Vp = cfg.activation_dtype, cfg.d_model, cfg.padded_vocab
    params: Dict[str, Any] = {
        "embed": L.dense_init(gen, (Vp, D), D, dt),
        "final_norm": L.init_rmsnorm(D, device=device),
    }
    if cfg.family == "hybrid":
        params["superblocks"] = _hybrid_superblock_params(
            gen, cfg, (cfg.n_layers // cfg.attn_period,))
    elif cfg.family == "ssm":
        lead = (cfg.n_layers,)
        params["layers"] = {"ln1": L.init_rmsnorm(D, lead, device),
                            "mamba": S.init_mamba(gen, cfg, lead)}
    else:
        params["layers"] = _attn_layer_params(gen, cfg, (cfg.n_layers,))
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (D, Vp), D, dt)
    return ParamTree(params)


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _apply_ffn(x, p, cfg: ModelConfig, decode: bool = False,
               ep_exchange=None):
    """Post-mixer FFN (dense or MoE). x: (B, S, D) -> (out, aux).
    ``decode``: the MoE layer routes at ``capacity_factor_decode`` with no
    exchange, as the reference's decode does."""
    B, S, D = x.shape
    if "moe" in p:
        cf = cfg.moe.capacity_factor_decode if decode else None
        out, aux = L.moe_ffn(x.reshape(B * S, D), p["moe"], cfg.moe,
                             capacity_factor=cf,
                             ep_exchange=None if decode else ep_exchange)
        return out.reshape(B, S, D), aux
    return L.mlp(x, p["ffn"]), _zero_aux(x)


def _attn_block(x, p, cfg: ModelConfig, positions, ep_exchange=None):
    """One layer -> (x, aux, (k, v)): the layer's K (after RoPE) and V
    for prefill's cache."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, kv = L.attention_train(h, p["attn"], cfg, positions=positions)
    x = x + o
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    ff, aux = _apply_ffn(h, p, cfg, ep_exchange=ep_exchange)
    return x + ff, aux, kv


def _ssm_block(x, p, cfg: ModelConfig, ep_exchange=None, state=False):
    """One Mamba2 layer -> (x, aux[, decode state]): the FFN after it
    where the layer has ``ln2`` (hybrid), else aux 0 (ssm)."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if state:
        o, st = S.mamba_forward(h, p["mamba"], cfg, return_state=True)
    else:
        o, st = S.mamba_forward(h, p["mamba"], cfg), None
    x = x + o
    aux = _zero_aux(x)
    if "ln2" in p:
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        ff, aux = _apply_ffn(h, p, cfg, ep_exchange=ep_exchange)
        x = x + ff
    return (x, aux, st) if state else (x, aux)


def _hybrid_superblock(x, p, cfg: ModelConfig, positions, ep_exchange=None,
                       caches=False):
    """One superblock of ``attn_period`` layers -> (x, aux), and with
    ``caches`` the Mamba states (one a Mamba position, in order) and the
    attention's (k, v)."""
    aux, states, kv = _zero_aux(x), [], None
    for pos in range(cfg.attn_period):
        sub = p[f"pos{pos}"]
        if pos == cfg.attn_offset:
            x, a, kv = _attn_block(x, sub, cfg, positions,
                                   ep_exchange=ep_exchange)
        elif caches:
            x, a, st = _ssm_block(x, sub, cfg, ep_exchange, state=True)
            states.append(st)
        else:
            x, a = _ssm_block(x, sub, cfg, ep_exchange)
        aux = aux + a
    return (x, aux, states, kv) if caches else (x, aux)


def _unembed(tree: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 logits, padding masked; in a model region this rank's vocab
    columns (``lm_head``'s column shard, or ``embed``'s row shard
    transposed where tied)."""
    head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
    logits = (hints.copy_to_model(x) @ head).to(torch.float32)
    return L.mask_padded_vocab(logits, cfg,
                               hints.model_index() * head.shape[-1])


def _layer(stacked: Dict, i) -> Dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _embed(tree: Dict, tokens: torch.Tensor, vis_embed=None) -> torch.Tensor:
    """Token embeddings, after ``vis_embed`` (B, V, D) in their dtype
    where given (the vlm family's visual prefix)."""
    x = hints.vocab_embed(tree["embed"], tokens)
    if vis_embed is not None:
        x = torch.cat([vis_embed.to(x.dtype), x], dim=1)
    return x


def _units(tree: Dict, cfg: ModelConfig, positions):
    """The reference's scan: (its stacked params, its length, its body
    ``(x, p, ep_exchange) -> (x, aux)``). The body is the unit a remat
    policy checkpoints: a layer, or for hybrid a whole superblock."""
    if cfg.family == "hybrid":
        return (tree["superblocks"], cfg.n_layers // cfg.attn_period,
                lambda x, p, ex: _hybrid_superblock(x, p, cfg, positions, ex))
    if cfg.family == "ssm":
        return tree["layers"], cfg.n_layers, \
            lambda x, p, ex: _ssm_block(x, p, cfg, ex)
    return tree["layers"], cfg.n_layers, \
        lambda x, p, ex: _attn_block(x, p, cfg, positions, ex)[:2]


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
              vis_embed=None, remat: str = "none", ep_exchange=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token (+ visual prefix) embedding through all blocks and the final
    norm -> (x, aux), ``aux`` the sum of the layers' MoE load-balance
    losses.

    ``remat`` is the reference's policy, applied to its scan body: a
    layer, or for hybrid a whole superblock of ``attn_period`` layers.
    Under ``"none"`` autograd keeps every unit's intermediates. Under
    ``"block"`` and ``"block_nocse"`` each unit call is a non-reentrant
    ``torch.utils.checkpoint.checkpoint``: the forward keeps the unit's
    inputs only and the backward runs the unit again. The two are the
    same here: their difference in the reference is whether XLA may CSE
    the recompute with the forward, and eager PyTorch has no CSE.
    ``"dots"`` mirrors ``dots_with_no_batch_dims_saveable`` through
    ``create_selective_checkpoint_contexts``: the outputs of ``aten.mm``
    and ``aten.addmm`` (every ``x @ W``: the projections, the MLP, the
    router and the Mamba projections) are kept, and ``aten.bmm``
    (attention scores and values, the routed experts, the SSD scan) and
    the elementwise ops recomputed. Non-reentrant, since the step takes
    its gradients with ``torch.autograd.grad``, which reentrant
    checkpoints refuse. The values and gradients equal ``"none"``'s bit
    for bit.

    The recompute leaves out ``ep_exchange``: the wire's value is spliced
    in detached and the backward needs nothing from it (JAX's remat drops
    a ``stop_gradient`` value from its recompute the same way), so the
    exchange's kernels and collectives run once a step under every
    policy."""
    _require_decoder_lm(cfg)
    _check_region(cfg)
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; have {list(REMAT_POLICIES)}")
    x = _embed(tree, tokens, vis_embed)
    positions = torch.arange(x.shape[1], device=tokens.device)[None, :]
    stacked, n, body = _units(tree, cfg, positions)
    aux = _zero_aux(x)
    for i in range(n):
        p = _layer(stacked, i)
        if remat == "none":
            x, a = body(x, p, ep_exchange)
        else:
            rm = _Remat(remat)

            def unit(x, p=p, rm=rm):
                return body(x, p, None if rm.recomputing else ep_exchange)

            x, a = ckpt_lib.checkpoint(unit, x, use_reentrant=False,
                                       context_fn=rm.context_fn)
        aux = aux + a
    return L.rmsnorm(x, tree["final_norm"], cfg.norm_eps), aux


def lm_loss(tree: Dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: str = "none", ep_exchange=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross entropy with the reference's z-loss and aux
    terms, over the token positions only (after a ``vis_embed`` prefix);
    ``ep_exchange`` as in :func:`lm_hidden`."""
    vis = batch.get("vis_embed")
    x, aux = lm_hidden(tree, cfg, batch["tokens"], vis, remat=remat,
                       ep_exchange=ep_exchange)
    if vis is not None:
        x = x[:, vis.shape[1]:]                       # text positions only
    logits = _unembed(tree, cfg, x)
    lse, ll = hints.vocab_parallel_lse(logits, batch["labels"])
    nll = (lse - ll).mean()
    zloss = 1e-4 * lse.square().mean()
    loss = nll + zloss + 0.01 * aux
    return loss, {"nll": nll, "aux": aux, "zloss": zloss}


# ----------------------------------------------------------------------
# Serving: prefill + decode with a cache
# ----------------------------------------------------------------------

def _stacked_states(batch: int, cfg: ModelConfig, lead, device):
    """Zero Mamba decode states (f32) stacked on ``lead``."""
    return {k: v.new_zeros(lead + tuple(v.shape)) for k, v in
            S.init_mamba_state(batch, cfg, device=device).items()}


def init_cache(tree: Dict, cfg: ModelConfig, batch: int, max_len: int
               ) -> Dict[str, Any]:
    """The decode cache of the family (see the module doc), zeros on the
    params' device: K/V in ``cfg.activation_dtype``, Mamba states in
    f32. The shapes are local: ``batch`` rows and ``max_len`` positions
    as given (a rank's share), and in a model region the Mamba ``ssm``
    state on this rank's heads."""
    _require_decoder_lm(cfg)
    dt, dev = cfg.activation_dtype, tree["embed"].device
    kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    if cfg.family == "ssm":
        return {"ssm": _stacked_states(batch, cfg, (cfg.n_layers,), dev)}
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_period
        shape = (n_super,) + kv_shape
        return {"mamba": _stacked_states(batch, cfg,
                                         (n_super, cfg.attn_period - 1), dev),
                "kv": {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}}
    shape = (cfg.n_layers,) + kv_shape
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _put_states(dst: Dict, states, at: Tuple = ()):
    """Write Mamba decode states into the stacked cache ``dst`` at
    index ``at`` (in place)."""
    for k in dst:
        dst[k][at] = states[k].to(dst[k].dtype)


def seq_block(length: int) -> Tuple[int, int]:
    """(offset, size) of this rank's block of a cache of ``length``
    positions split over ``hints.seq_group()`` (the whole cache outside
    one); raises ``ValueError`` where the length does not split."""
    seq = hints.seq_group()
    if seq is None:
        return 0, length
    if length % seq.workers:
        raise ValueError(f"the cache length {length} does not split over "
                         f"the {seq.workers} ranks of its sequence axes")
    n = length // seq.workers
    return seq.first_worker * n, n


def put_kv(dst: torch.Tensor, kv: torch.Tensor, offset: int) -> None:
    """Write ``kv`` ``(B, S, KV, hd)`` (positions ``0..S-1``) into
    ``dst``, this rank's block of the cache's positions from ``offset``:
    the positions the block holds, in place."""
    lo, hi = offset, min(offset + dst.shape[1], kv.shape[1])
    if hi > lo:
        dst[:, :hi - lo] = kv[:, lo:hi]


def lm_prefill(tree: Dict, cfg: ModelConfig, tokens: torch.Tensor,
               max_len: int | None = None, vis_embed=None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the whole prompt (after a ``vis_embed`` prefix, where given)
    -> (logits of the last position ``(B, V)`` f32, the cache). Each layer
    is the training block: an attention layer's K (after RoPE) and V go
    into a cache of ``max(max_len, S_full)`` positions, zero past the
    prompt, as the reference's padded scan output (``S_full`` counts
    the visual prefix); a Mamba layer's chunked scan gives its final
    state. Only the last position is unembedded.

    In a model region the K/V of every KV head (``layers.kv_whole``) go
    into this rank's block of those positions (:func:`seq_block`: a
    ``ValueError`` where the length does not split over the sequence's
    ranks), and the logits are this rank's vocab columns."""
    _require_decoder_lm(cfg)
    _check_region(cfg)
    B, S_tok = tokens.shape
    x = _embed(tree, tokens, vis_embed)
    S = x.shape[1]
    off, n = seq_block(max(max_len or S_tok, S))
    cache = init_cache(tree, cfg, B, n)
    positions = torch.arange(S, device=tokens.device)[None, :]
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, _, st = _ssm_block(x, _layer(tree["layers"], i), cfg, state=True)
            _put_states(cache["ssm"], st, (i,))
    elif cfg.family == "hybrid":
        for i in range(cfg.n_layers // cfg.attn_period):
            x, _, states, (k, v) = _hybrid_superblock(
                x, _layer(tree["superblocks"], i), cfg, positions, caches=True)
            for j, st in enumerate(states):
                _put_states(cache["mamba"], st, (i, j))
            k, v = L.kv_whole(k, v, cfg)
            put_kv(cache["kv"]["k"][i], k, off)
            put_kv(cache["kv"]["v"][i], v, off)
    else:
        for i in range(cfg.n_layers):
            x, _, (k, v) = _attn_block(x, _layer(tree["layers"], i), cfg,
                                       positions)
            k, v = L.kv_whole(k, v, cfg)
            put_kv(cache["k"][i], k, off)
            put_kv(cache["v"][i], v, off)
    x = L.rmsnorm(x[:, -1:], tree["final_norm"], cfg.norm_eps)
    return _unembed(tree, cfg, x)[:, 0], cache


def _mamba_decode_layer(x, p, cfg: ModelConfig, states: Dict, at: Tuple):
    """One Mamba layer's decode step on the cache's states at ``at``,
    written back in place -> the layer's output (before the residual)."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, st = S.mamba_decode(h, p["mamba"], cfg,
                           {k: v[at] for k, v in states.items()})
    _put_states(states, st, at)
    return o


def lm_decode(tree: Dict, cfg: ModelConfig, token: torch.Tensor,
              cache: Dict[str, Any], position: int
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token: (B,) ids; ``position`` (an int): tokens
    ``0..position-1`` are in the cache. Returns ``(logits (B, V) f32,
    cache)``, the cache updated in place (``layers.attention_decode``,
    whose write clamps at the cache's end; the Mamba states). The MoE
    layers route at ``capacity_factor_decode``. In a model region, on
    this rank's shards and cache block (see the module doc)."""
    _require_decoder_lm(cfg)
    _check_region(cfg)
    x = hints.vocab_embed(tree["embed"], token[:, None])
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = x + _mamba_decode_layer(x, _layer(tree["layers"], i), cfg,
                                        cache["ssm"], (i,))
    elif cfg.family == "hybrid":
        kv = cache["kv"]
        for i in range(cfg.n_layers // cfg.attn_period):
            p_sb, si = _layer(tree["superblocks"], i), 0
            for pos in range(cfg.attn_period):
                sub = p_sb[f"pos{pos}"]
                if pos == cfg.attn_offset:
                    h = L.rmsnorm(x, sub["ln1"], cfg.norm_eps)
                    o, _, _ = L.attention_decode(h, sub["attn"], cfg,
                                                 kv["k"][i], kv["v"][i],
                                                 position)
                else:
                    o = _mamba_decode_layer(x, sub, cfg, cache["mamba"],
                                            (i, si))
                    si += 1
                x = x + o
                h = L.rmsnorm(x, sub["ln2"], cfg.norm_eps)
                x = x + _apply_ffn(h, sub, cfg, decode=True)[0]
    else:
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
