"""Serving steps on the rank grid, the reference's ``serve/steps.py``.

The reference jits ``api.prefill`` / ``api.decode`` with GSPMD
shardings: the parameters as ``param_pspecs``, the batch as
``batch_pspec`` (its rows over the DP axes it can cover) and the decode
cache as ``cache_pspecs`` (the batch over those axes and the sequence
over ``model``; or, for a batch below the DP size, the sequence over
every axis), and its outputs replicated. The port writes that layout out
on a grid of ranks (``launch/mesh.RankMesh``, rank ``d·MP + t``):

- each rank holds its parameter shards (:func:`shard_params`: the
  ``shard_leaf`` of every leaf under ``param_pspecs``);
- each step takes the global batch (or token vector) and runs this
  rank's rows of it (``batch_pspec``), inside ``hints.model_region``
  with the model axis, the experts' data axis (kimi-k2's profile), the
  group whose rows a MoE layer routes as one batch (the reference routes
  a serve step's whole batch) and the group the cache's sequence is
  split over bound;
- the cache each rank keeps is its block of ``cache_pspecs``: its batch
  rows, its block of the sequence with every KV head, and for Mamba its
  heads of the ``ssm`` state and the whole ``conv`` state;
- the logits are the whole vocab's on every rank, ``(B_loc, V)`` f32:
  the vocab shards gathered over the model axis, the padding masked.

A mesh is a ``RankMesh``, or anything with its ``shape``, ``coords`` and
``group(axes)`` (the dry run's recording stand-ins, ``launch/dryrun.py``;
a ``MeshShape`` of one device). The reference also binds the profile's
logical-axis rules for its activation hints; the port's hints place
nothing (``hints.constrain`` is the identity), so there is nothing to
bind. The steps run under
``torch.inference_mode()``. A layout the grid cannot hold raises (a
profile outside ``transformer.MODEL_AXIS_LAYOUTS``, heads the model axis
does not divide, a cache length the sequence's ranks do not divide):
nothing falls back to the unsharded path.

  sh = serve_shardings(api, prof, mesh, global_batch, seq_len)
  params = shard_params(whole_tree, prof, mesh)
  prefill = build_prefill_step(api, prof, mesh, max_len)
  logits, cache = prefill(params, {"tokens": tokens, ...})
  decode = build_decode_step(api, prof, mesh)
  token = gather_batch(logits.argmax(-1), prof, mesh, B)
  logits, cache = decode(params, token, cache, position)
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.params import ParamTree, unflatten_tree
from repro_torch.models.registry import ModelAPI
from repro_torch.models.transformer import check_model_axis
from repro_torch.parallel import hints
from repro_torch.parallel import sharding as shd


def serve_batch_pspec(global_batch: int, mesh, prof: shd.ShardingProfile
                      ) -> shd.Spec:
    return shd.batch_pspec(global_batch, mesh.shape, prof)


def params_struct(api: ModelAPI) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    memory). ``api.init`` runs under ``FakeTensorMode``, where its
    seeded generator draws nothing, and every leaf becomes a ``meta``
    tensor of its shape: a ``torch.Generator`` cannot be made on
    ``meta``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = api.init(0, "cpu")
    return unflatten_tree([(path, torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"))
                           for path, t in zip(fake.paths, fake.leaves())])


def _broadcast(spec, struct):
    """The cache's spec tree, coarser than the cache (one spec for a
    group of Mamba states), broadcast over ``struct``'s leaves."""
    if isinstance(spec, tuple):
        return _map(lambda _: spec, struct)
    if isinstance(spec, dict):
        return {k: _broadcast(spec[k], struct[k]) for k in struct}
    raise TypeError(type(spec))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, specs, tree):
    if isinstance(tree, dict):
        return {k: _map2(fn, specs[k], v) for k, v in tree.items()}
    return fn(specs, tree)


def serve_shardings(api: ModelAPI, prof: shd.ShardingProfile, mesh,
                    global_batch: int, seq_len: int) -> Dict[str, Any]:
    """The layout of the serve steps' inputs: ``params_struct`` (the
    parameter tree on ``meta``), ``pspecs`` (its spec tree), ``params``
    (the local shape a rank holds of each leaf,
    ``sharding.param_shardings``), ``batch`` (the batch's spec),
    ``cache_struct`` (the whole cache of ``global_batch`` rows and
    ``seq_len`` positions on ``meta``) and ``cache`` (its spec tree,
    one spec a leaf)."""
    shape = mesh.shape
    pstruct = params_struct(api)
    cstruct = api.init_cache(pstruct, global_batch, seq_len)
    return {"params_struct": pstruct,
            "pspecs": shd.param_pspecs(pstruct, prof),
            "params": shd.param_shardings(pstruct, prof, shape),
            "batch": shd.batch_pspec(global_batch, shape, prof),
            "cache_struct": cstruct,
            "cache": _broadcast(shd.cache_pspecs(api.cfg, global_batch, shape,
                                                 prof), cstruct)}


def local_cache_shapes(sh: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The shape of each leaf of the cache a rank keeps, from
    :func:`serve_shardings`' ``cache_struct`` and ``cache``."""
    return _map2(lambda s, t: shd.local_shape(t.shape, s, mesh.shape),
                 sh["cache"], sh["cache_struct"])


def shard_params(tree: Dict[str, Any], prof: shd.ShardingProfile, mesh
                 ) -> Dict[str, Any]:
    """This rank's shard of every leaf of the whole ``tree`` (a dict tree
    or a ``ParamTree``), copies, so the whole tree can be freed."""
    if isinstance(tree, ParamTree):
        tree = tree.tree()
    specs = shd.param_pspecs(tree, prof)
    return _map2(lambda s, t: shd.shard_leaf(t.detach(), s, mesh.shape,
                                             mesh.coords).clone(), specs, tree)


def gather_batch(x: torch.Tensor, prof: shd.ShardingProfile, mesh,
                 global_batch: int) -> torch.Tensor:
    """The global batch's rows of ``x`` from every rank's own (dim 0):
    the inverse of the steps' row split, an all-gather over the ranks
    the batch is split over (``x`` itself where it is not). A greedy
    loop gathers its next tokens so, for the decode step."""
    bspec = shd.batch_pspec(global_batch, mesh.shape, prof)
    group = mesh.group(bspec[0]) if bspec else None
    return x if group is None else group.gather([x.contiguous()])


class _Layout:
    """Where a serve step of ``global_batch`` rows runs: the batch's axes,
    the cache sequence's, and the groups bound in its model region."""

    def __init__(self, api: ModelAPI, prof: shd.ShardingProfile, mesh,
                 global_batch: int):
        shape = mesh.shape
        self.bspec = shd.batch_pspec(global_batch, shape, prof)
        cspecs = shd.cache_pspecs(api.cfg, global_batch, shape, prof)
        kv = cspecs.get("k", cspecs.get("kv", {}).get("k"))
        seq_axes = shd._axes(kv[2]) if kv is not None else ()
        self.model = mesh.group((prof.tp_axis,)) if prof.tp_axis else None
        self.rows = mesh.group(self.bspec[0]) if self.bspec else None
        self.seq = mesh.group(seq_axes)
        self.experts = (mesh.group(prof.ep_axes)
                        if "model" not in prof.ep_axes else None)
        self.mesh = mesh

    def rows_of(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global ``x`` (dim 0)."""
        return shd.shard_leaf(x, self.bspec, self.mesh.shape, self.mesh.coords)

    def region(self):
        return hints.model_region(self.model, experts=self.experts,
                                  rows=self.rows, seq=self.seq)

    def whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """``(B_loc, V/MP)`` vocab columns -> ``(B_loc, V)`` on every
        model rank."""
        return shd.gather_leaf(logits, (None, "model"), self.model)


def build_prefill_step(api: ModelAPI, prof: shd.ShardingProfile, mesh,
                       max_len: int):
    """``fn(params, batch) -> (logits (B_loc, V) f32, cache)``: ``params``
    this rank's shards (:func:`shard_params`), ``batch`` the global
    batch (``tokens`` (B, S), and ``frames`` / ``vis_embed`` where the
    family takes them), of which the step runs this rank's rows; the
    cache is this rank's block of a cache of ``max(max_len, S_full)``
    positions."""
    check_model_axis(api.cfg, mesh.shape.get("model", 1), prof)

    def prefill_fn(params, batch):
        lay = _Layout(api, prof, mesh, batch["tokens"].shape[0])
        rows = {k: lay.rows_of(v) for k, v in batch.items()}
        with torch.inference_mode(), lay.region():
            logits, cache = api.prefill(params, rows, max_len)
            return lay.whole_vocab(logits), cache

    return prefill_fn


def build_decode_step(api: ModelAPI, prof: shd.ShardingProfile, mesh):
    """``fn(params, token, cache, position) -> (logits (B_loc, V) f32,
    cache)``: ``token`` the global (B,) ids, ``cache`` this rank's (from
    the prefill step), updated in place; ``position`` an int."""
    check_model_axis(api.cfg, mesh.shape.get("model", 1), prof)

    def decode_fn(params, token, cache, position):
        lay = _Layout(api, prof, mesh, token.shape[0])
        with torch.inference_mode(), lay.region():
            logits, cache = api.decode(params, lay.rows_of(token), cache,
                                       position)
            return lay.whole_vocab(logits), cache

    return decode_fn
