"""Train step: W data-parallel workers, one aggregation, one optimizer
update, replicated or sliced over the workers (ZeRO-1).

The step follows the reference's Algorithm 1 deployment:

  1. worker w computes local gradients on batch rows
     ``[w·B/W, (w+1)·B/W)`` (with optional microbatch accumulation);
  2. the gradients are aggregated across the workers by the strategy
     ``tc.aggregator`` (``"dense"``, ``"compressed"``,
     ``"compressed_rs"``, ``"compressed_innet"`` or ``"auto"``, which
     executes a per-bucket-group wire plan); as in the reference, a
     single worker always aggregates densely;
  3. the optimizer applies the mean gradient.

The workers are those of a group (``core/collectives``): by default all
W run in turn in this process on one device (``LocalWorkers``); with a
``ProcessGroupWorkers`` this process is one rank and runs its own worker
on its rows of the global batch.

The update is the reference's (``train/step.py:leaf_update``). With
``tc.zero1`` off it is replicated: every rank applies the same
aggregate to the whole of every leaf. With ``tc.zero1`` (and W > 1)
each leaf with a ZeRO-1 dim ``d = zero_slice_dim(shape, (), W)`` is
updated slice by slice: worker r updates ``p`` and ``g`` narrowed on
``d`` at ``r·shape[d]/W`` with its slice of the moments, and ``p`` gains
the all-gathered deltas ``(new_p_s − p_s)`` in ``p``'s dtype (not the
new slices copied in: in bf16 the two differ in the last bit); a leaf
with no such dim updates replicated. A rank keeps only its slice of the
moments of a sliced leaf; ``LocalWorkers`` keeps them whole and updates
the W slices in rank order. With ``compressed_rs`` and
``tc.rs_gather_skip`` the aggregator learns the slice dims, and where
its chunk grid aligns with them it skips the recovered-chunk gather:
each worker's gradient is then exact on its own coordinates only, and
the grad norm is ``sqrt`` of the sum over the workers of their squared
norms. Parameters, moments and error-feedback residuals are updated in
place.

With ``tc.ep_exchange`` set, a MoE model and ``tc.ep_workers > 1``, each
worker's forward runs the MoE combine through that exchange over a
``LocalWorkers(tc.ep_workers)`` of EP ranks, at the reference's
exchange codec: ``tc.compression`` at ratio 2.5 with top-k and error
feedback off, where a fully dense payload peels exactly.

On a grid of W x MP ranks (``launch/mesh.RankMesh``: ``group`` its
data-parallel group, ``model`` its model-axis group) each rank holds its
shards of the leaves (``parallel/sharding.param_pspecs`` of
``tc.sharding``: Megatron's column and row splits, the vocab, the
routed experts) and the model ranks of data index d take the same rows
``[d·B/W, (d+1)·B/W)``; the forward and backward run in a
``model_region`` (``parallel/hints``). Everything after the backward is
shard-local, the reference's nested branch: each rank's bucket plan,
top-k, error feedback and residual are over its local leaves, its
aggregator runs over its data-parallel group (the same block ids on
every model rank), a compressed aggregate of a replicated leaf is taken
from model rank 0 (:func:`sync_replicated`), ZeRO-1 slices each leaf on
``zero_slice_dim(shape, spec, W)``, never the model-sharded dim, and the
grad norm sums the sharded leaves' squares over the model axis and
counts a replicated leaf once. The EP ranks are the model ranks: with
``ep_exchange`` set the MoE partials are summed by the exchange over the
model group (``ep_workers`` 1 or MP). On ranks with one model rank,
``ep_workers > 1`` raises: the experts are not sharded there.

Under kimi-k2's profile (``tc.sharding.dp_axes == ()``, the routed
experts on the ``data`` axis) on W > 1 ranks the step is the
reference's pure auto-sharded one: its gradient is the whole global
batch's (each microbatch's rows split over the data ranks, microbatch
by microbatch), the aggregator is ``dense`` whatever ``tc.aggregator``
says, with no ZeRO-1 and no exchange. Each data rank holds its group of
``E/W`` experts (:func:`experts_group`; their ``d_ff`` over the model
axis), and the MoE layers gather the tokens over the data ranks and
route them as one batch (``layers._moe_data_axis``). The data ranks'
losses are per-rank means, so the non-expert gradients are averaged
over the data group, and an expert leaf's local gradient, which already
sums every rank's tokens, is divided by W instead of aggregated. The
grad norm sums an expert leaf's squares over both axes, and
:func:`state_view` gathers the expert shards over the data axis too.
On ``LocalWorkers`` the profile's data split does not apply.

:func:`state_view` gives the state without its layout (whole moments,
every worker's residual row), as a checkpoint holds it, and
:func:`load_state_view` puts such a state back into any layout.

The step's stages are :mod:`repro_torch.obs` spans: ``step/forward`` and
``step/backward`` (one worker's, the backward with the block
recompute), ``step/aggregate`` (the aggregator's call, whose own stages
nest under it) and ``step/optimizer`` (:func:`apply_update`, with
``optimizer/norm``, ``optimizer/clip`` (the plain path's; the hand AdamW
kernel folds the clip in), ``optimizer/update`` and, under it, each
ZeRO-1 ``optimizer/gather``); ``setup/init_state`` is
:func:`init_train_state`. The counter ``optimizer/plain_slices`` counts
the slices the plain update ran on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core import aggregators as agg_lib
from repro_torch.core.collectives import (AggregationState, LocalWorkers,
                                          dense_all_reduce)
from repro_torch.core.streams import zero_slice_dim
from repro_torch.kernels.adam_update import adam_update_cuda
from repro_torch.models.params import ParamTree, unflatten_tree
from repro_torch.models.registry import ModelAPI
from repro_torch.models.transformer import check_model_axis
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.hints import model_region
from .config import TrainConfig
from . import optimizer as opt_lib


@dataclasses.dataclass
class TrainState:
    params: ParamTree
    opt: Dict[str, List[torch.Tensor]]   # moments; a rank holds its slice of a ZeRO-1 leaf's
    residual: List[torch.Tensor]   # EF residuals (local workers, *shape), or (0,) stubs
    step: int


def _mp(model) -> int:
    return 1 if model is None else model.workers


def pure_auto(tc: TrainConfig, group) -> bool:
    """Whether the step is the reference's pure auto-sharded one: a
    profile with no manual DP axes (kimi-k2's) on ranks
    (``ProcessGroupWorkers``)."""
    return not tc.sharding.dp_axes and group is not None \
        and not isinstance(group, LocalWorkers)


def experts_group(tc: TrainConfig, group):
    """The data-parallel group the routed experts are split over: the
    rank's ``group`` of W > 1 ranks under a pure auto-sharded profile
    with the experts on ``data``, else None."""
    if pure_auto(tc, group) and group.workers > 1 \
            and "data" in tc.sharding.ep_axes:
        return group
    return None


def _on_data(spec) -> bool:
    return any("data" in shd._axes(a) for a in spec)


def leaf_specs(params: ParamTree, tc: TrainConfig, model=None,
               group=None) -> List[tuple]:
    """Each leaf's spec: ``tc.sharding``'s where the grid has MP > 1
    model ranks or the experts are split over ``group``'s data ranks
    (:func:`experts_group`), else ``()`` (nothing sharded)."""
    if _mp(model) == 1 and experts_group(tc, group) is None:
        return [()] * len(params.paths)
    return [shd.leaf_spec(p, t.ndim, tc.sharding)
            for p, t in zip(params.paths, params.leaves())]


def zero1_dims(leaves: Sequence[torch.Tensor], tc: TrainConfig,
               specs: Optional[Sequence[tuple]] = None, pure: bool = False
               ) -> List[Optional[int]]:
    """Each leaf's ZeRO-1 slice dim (None: updated replicated); all None
    unless ``tc.zero1`` and W > 1, and under a pure auto-sharded step
    (``pure``: no DP axis to slice over, as in the reference). ``specs``
    (:func:`leaf_specs`): the dims a spec shards are never sliced."""
    if pure or not (tc.zero1 and tc.workers > 1):
        return [None] * len(leaves)
    specs = specs or [()] * len(leaves)
    return [zero_slice_dim(tuple(p.shape), s, tc.workers)
            for p, s in zip(leaves, specs)]


def _model_shard(x: torch.Tensor, spec, model, data=None) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` (a view): its model
    index's, and its data index's on a dim split over ``data``."""
    mesh, coords = {"model": 1, "data": 1}, {"model": 0, "data": 0}
    for axis, g in (("model", model), ("data", data)):
        if g is not None:
            mesh[axis], coords[axis] = g.workers, g.first_worker
    return shd.shard_leaf(x, spec, mesh, coords)


def _gather(x: torch.Tensor, spec, model, data=None) -> torch.Tensor:
    """The inverse of :func:`_model_shard`: ``x`` whole, gathered over
    the model axis, then over ``data`` (every rank of both calls it)."""
    return shd.gather_leaf(shd.gather_leaf(x, spec, model), spec, data,
                           axis="data")


def shard_params(params: ParamTree, tc: TrainConfig, model=None,
                 group=None) -> ParamTree:
    """``params`` (whole) as this rank's shards, copies; ``params``
    itself where nothing is split (:func:`leaf_specs`)."""
    data = experts_group(tc, group)
    if _mp(model) == 1 and data is None:
        return params
    specs = leaf_specs(params, tc, model, group)
    return ParamTree(unflatten_tree([
        (path, _model_shard(p.detach(), s, model, data).clone())
        for path, p, s in zip(params.paths, params.leaves(), specs)]))


def init_train_state(api: ModelAPI, tc: TrainConfig, device="cuda",
                     params: ParamTree | None = None,
                     group=None, model=None) -> TrainState:
    """Fresh state; ``params`` (whole, e.g. from
    ``convert.params_from_jax``) replaces the random init from
    ``tc.seed``. With ``model`` (the model-axis group of MP > 1 ranks)
    the state holds this rank's shards of the whole tree. The
    error-feedback residuals have one row per local worker of ``group``
    (default: all ``tc.workers``); with ``tc.zero1``, a rank of W (a
    group with fewer local workers than W) holds only its slice of each
    sliced leaf's moments."""
    with obs.span("setup/init_state"):
        check_model_axis(api.cfg, _mp(model), tc.sharding)
        params = api.init(tc.seed, device) if params is None else params
        params = shard_params(params, tc, model, group)
        leaves = params.leaves()
        local = tc.workers if group is None else group.local_workers
        pure = pure_auto(tc, group)
        shapes = []
        for p, d in zip(leaves, zero1_dims(leaves, tc,
                                           leaf_specs(params, tc, model, group),
                                           pure)):
            shape = list(p.shape)
            if d is not None and local < tc.workers:
                shape[d] //= tc.workers
            shapes.append(shape)
        opt = opt_lib.init_opt_state(leaves, tc.optimizer, shapes)
        ccfg = tc.compression
        if tc.aggregator != "dense" and ccfg.topk_ratio is not None \
                and ccfg.error_feedback and not pure:
            residual = [torch.zeros((local,) + tuple(p.shape),
                                    dtype=torch.float32, device=p.device)
                        for p in leaves]
        else:
            residual = [torch.zeros((0,), dtype=torch.float32, device=p.device)
                        for p in leaves]
        return TrainState(params=params, opt=opt, residual=residual, step=0)


# ----------------------------------------------------------------------
# The reference's sharding trees of the state and the batch, as spec
# functions of a mesh shape (``launch/dryrun.py`` reads them)
# ----------------------------------------------------------------------

def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(getattr(mesh, "shape", mesh))


def effective_dp_axes(prof: shd.ShardingProfile, mesh) -> tuple:
    """The profile's DP axes the mesh has."""
    return tuple(a for a in prof.dp_axes if a in _mesh_shape(mesh))


def _one(axes: tuple):
    """A spec entry for ``axes``: the name alone, a tuple of several."""
    return axes if len(axes) > 1 else axes[0]


def state_specs(state: TrainState, tc: TrainConfig, mesh) -> Dict:
    """The reference's ``state_specs`` for a state of whole leaves (a
    ``LocalWorkers`` state, e.g. of ``meta`` tensors; its residual rows
    the leading DP dim): ``"full"``, each leaf's spec over the whole
    mesh, and ``"manual"``, its spec over the DP axes alone, as
    ``TrainState`` trees of spec lists in ``state.params.paths`` order, and
    ``"pspecs"``, the parameters' specs. A moment with a ZeRO-1 dim is
    sliced over the DP axes there (``streams.zero_slice_dim`` on the
    leaf's whole shape), a residual carries the DP axes first and the
    parameter's spec after."""
    shape = _mesh_shape(mesh)
    prof = tc.sharding
    dp_axes = effective_dp_axes(prof, shape)
    dp = 1
    for a in dp_axes:
        dp *= shape[a]
    leaves = state.params.leaves()
    pspecs = [shd.leaf_spec(p, t.ndim, prof)
              for p, t in zip(state.params.paths, leaves)]

    def opt(p, s):
        d = zero_slice_dim(tuple(p.shape), s, dp) if prof.zero1 and dp > 1 \
            else None
        if d is None:
            return (), s
        manual = [None] * p.ndim
        manual[d] = _one(dp_axes)
        full = list(s) + [None] * (p.ndim - len(s))
        full[d] = manual[d]
        return tuple(manual), tuple(full)

    def res(r, s, full):
        if r.ndim == 1 and r.shape[0] == 0:
            return ()
        return (_one(dp_axes),) + (tuple(s) if full else ())

    moms = {k: [opt(p, s) for p, s in zip(leaves, pspecs)] for k in state.opt}
    manual = TrainState(params=[()] * len(leaves),
                        opt={k: [m for m, _ in v] for k, v in moms.items()},
                        residual=[res(r, s, False)
                                  for r, s in zip(state.residual, pspecs)],
                        step=())
    full = TrainState(params=pspecs,
                      opt={k: [f for _, f in v] for k, v in moms.items()},
                      residual=[res(r, s, True)
                                for r, s in zip(state.residual, pspecs)],
                      step=())
    return {"manual": manual, "full": full, "pspecs": pspecs}


def batch_specs(batch_shapes: Dict[str, torch.Tensor], mesh,
                tc: TrainConfig):
    """The reference's ``batch_specs``: (the manual spec of each batch
    entry, over the DP axes only; its full spec, over those and the
    profile's batch axes that are not manual, e.g. kimi-k2's ``data``)."""
    shape = _mesh_shape(mesh)
    prof = tc.sharding
    dp_axes = effective_dp_axes(prof, shape)
    auto = tuple(a for a in prof.batch_auto_axes if a in shape)
    man = (_one(dp_axes),) if dp_axes else ()
    full = (_one(dp_axes + auto),) if dp_axes + auto else ()
    return ({k: man for k in batch_shapes}, {k: full for k in batch_shapes})


def state_view(state: TrainState, tc: TrainConfig, group=None,
               model=None) -> TrainState:
    """The state with no layout, as a checkpoint holds it: the
    reference's ``TrainState`` tree, every leaf whole.

    ``params`` and ``residual`` are nested dicts on the reference's
    paths and ``opt`` one such dict a moment, so the checkpoint's leaf
    paths are the reference's; ``step`` is an int32 scalar. A rank's
    ZeRO-1 moment slices and its local workers' residual rows are
    gathered over ``group`` (``group.gather``, as ``apply_update``
    gathers its deltas), and on a grid the model shards over ``model``
    (``sharding.gather_leaf``), the experts' shards over ``group`` under
    kimi-k2's profile: every rank of the grid must call this together.
    On ``LocalWorkers`` (``group`` None) the leaves are the live tensors
    themselves."""
    params = state.params
    leaves = params.leaves()
    whole = group is None or group.local_workers == group.workers
    specs = leaf_specs(params, tc, model, group)
    data = experts_group(tc, group)

    def tree(ts):
        return unflatten_tree(list(zip(params.paths, ts)))

    def moment(m, p, d, s):
        if not (whole or d is None or m.shape == p.shape):
            m = group.gather([m.movedim(d, 0).contiguous()]).movedim(0, d)
        return _gather(m, s, model, data)

    def rows(r, s):
        if r.numel() == 0:
            return r
        if not whole:
            r = group.gather([r])
        return _gather(r, (None,) + tuple(s), model, data)

    dims = zero1_dims(leaves, tc, specs, pure_auto(tc, group))
    opt = {k: tree([moment(m, p, d, sp) for m, p, d, sp
                    in zip(ms, leaves, dims, specs)])
           for k, ms in state.opt.items()}
    return TrainState(
        params=tree([_gather(p.detach(), sp, model, data)
                     for p, sp in zip(leaves, specs)]),
        opt=opt, residual=tree([rows(r, sp) for r, sp
                                in zip(state.residual, specs)]),
        step=torch.tensor(state.step, dtype=torch.int32))


def view_paths(state: TrainState) -> List[str]:
    """The leaf paths of :func:`state_view`'s tree, in flatten order."""
    names = [".".join(p) for p in state.params.paths]
    return ([f"params.{n}" for n in names]
            + [f"opt.{k}.{n}" for k in sorted(state.opt) for n in names]
            + [f"residual.{n}" for n in names] + ["step"])


def load_state_view(state: TrainState, leaves: Sequence[torch.Tensor],
                    tc: TrainConfig, group=None, model=None) -> None:
    """The inverse of :func:`state_view`: ``leaves`` (whole, on any
    device, in :func:`view_paths` order) narrowed to this rank's model
    shard (with ``model``; and its data index's expert shard under
    kimi-k2's profile), this group's ZeRO-1 slice of each moment and
    its local workers' residual rows, and copied into the live tensors in
    place (``build_train_step`` keeps references to them); ``state.step``
    set. A leaf of another shape or dtype raises."""
    params = state.params.leaves()
    moms = sorted(state.opt)
    want = (2 + len(moms)) * len(params) + 1
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} leaves for a state of {want}")
    first = 0 if group is None else group.first_worker
    specs = leaf_specs(state.params, tc, model, group)
    data = experts_group(tc, group)
    if _mp(model) > 1 or data is not None:
        lead = [(None,) + tuple(sp) for sp in specs]
        per = list(specs) * (1 + len(moms)) + lead + [()]
        leaves = [_model_shard(x, sp, model, data)   # not the (0,) stubs
                  if x.dim() == len(sp) else x
                  for x, sp in zip(leaves, per)]
    src = iter(leaves)

    def put(dst, x, what):
        if tuple(x.shape) != tuple(dst.shape) or x.dtype != dst.dtype:
            raise ValueError(f"{what}: {tuple(x.shape)} {x.dtype} for "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(x)

    with torch.no_grad():
        for p in params:
            put(p, next(src), "param")
        for k in moms:
            for i, (m, p, d) in enumerate(zip(
                    state.opt[k], params,
                    zero1_dims(params, tc, specs, pure_auto(tc, group)))):
                x = next(src)
                if d is not None and m.shape != p.shape:
                    blk = m.shape[d]
                    x = x.narrow(d, first * blk, blk)
                put(m, x, f"moment {k}[{i}]")
        for i, r in enumerate(state.residual):
            x = next(src)
            if r.numel():
                x = x.narrow(0, first, r.shape[0])
            put(r, x, f"residual[{i}]")
        state.step = int(next(src))


def model_axis_sq_norm(grads: Sequence[torch.Tensor], specs, model,
                       data=None) -> torch.Tensor:
    """The squared norm of the whole gradient from this rank's shards:
    the sharded leaves' squares summed over the model axis (one
    all-reduce), a replicated leaf's (the norms, the router) counted
    once; with ``data`` (kimi-k2's experts), an expert leaf's squares
    summed over the data ranks first (one more all-reduce)."""
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    sharded, replicated, experts = zero, zero, zero
    for g, sp in zip(grads, specs):
        sq = g.to(torch.float32).square().sum()
        if data is not None and _on_data(sp):
            experts = experts + sq
        elif any(a is not None for a in sp):
            sharded = sharded + sq
        else:
            replicated = replicated + sq
    if data is not None:
        sharded = sharded + data.sum([experts])
    return (sharded if model is None else model.sum([sharded])) + replicated


def sync_replicated(grads: List[torch.Tensor], specs, model
                    ) -> List[torch.Tensor]:
    """Model rank 0's aggregate of every replicated leaf, on every model
    rank. Each model rank's data group recovers its own shard-local
    stream, and a lossy codec's recovery of a replicated leaf's
    coordinates depends on the other coordinates of their blocks, which
    differ between the model ranks; the replicated leaves (the norm
    scales, the router) must stay one value."""
    return [model.gather([g[None].contiguous()])[0]
            if all(a is None for a in sp) else g
            for g, sp in zip(grads, specs)]


def expert_mean(grads: Sequence[torch.Tensor], specs, group
                ) -> List[torch.Tensor]:
    """A pure auto-sharded step's aggregate of this rank's gradients
    (kimi-k2's profile on ``group``'s W data ranks): every leaf not split
    over ``data`` averaged over the group (``dense_all_reduce``), and an
    expert leaf's own gradient divided by W. Each rank's loss is its
    rows' mean, and an expert's gradient already sums every rank's
    tokens' (the layer's reduce-scatter runs backward as an all-gather),
    so both come out as the gradient of the global batch's mean."""
    W = group.workers
    on = [_on_data(sp) for sp in specs]
    rest = iter(dense_all_reduce([[g for g, o in zip(grads, on) if not o]],
                                 group))
    return [(g.to(torch.float32) / W).to(g.dtype) if o else next(rest)
            for g, o in zip(grads, on)]


def apply_update(state: TrainState, grads, dims: Sequence[Optional[int]],
                 group, ocfg: opt_lib.OptimizerConfig,
                 skip: bool = False, specs=None, model=None,
                 data=None, use_pallas: str = "auto") -> torch.Tensor:
    """The optimizer update of one step, in place; returns the grad norm.

    ``grads`` is the aggregate (every local worker's), or with ``skip``
    (the gather-skip path) one aggregate a local worker, exact on its own
    coordinates. ``dims[i]`` is leaf i's ZeRO-1 dim: None updates the
    leaf replicated; otherwise each local worker updates its slice with
    its slice of the moments (a rank's moments are that slice; a
    ``LocalWorkers``' are whole) and the leaf gains the gathered deltas.
    With ``model`` (MP > 1) or ``data`` (the experts' data group) the
    leaves are shards as ``specs`` say, and the norm is the whole
    gradient's (:func:`model_axis_sq_norm`).

    AdamW on the card runs the hand kernel (``opt_lib.fused_adamw`` under
    the compression config's ``use_pallas``): one launch a leaf for all
    local workers' slices, the clip folded in, bit for bit the plain
    path's. Elsewhere each slice runs ``clip_grads`` and
    ``opt_leaf_update``; on a CUDA device each such slice counts to
    ``optimizer/plain_slices``.
    """
    W = group.workers
    leaves = state.params.leaves()
    dev = leaves[0].device
    fused = opt_lib.fused_adamw(ocfg, dev, use_pallas)
    plain_on_card = not fused and dev.type == "cuda"
    with obs.span("step/optimizer"):
        if not fused:
            lr = opt_lib.lr_schedule(state.step, ocfg, dev)
        with obs.span("optimizer/norm"):
            if _mp(model) > 1 or data is not None:
                if skip:
                    gnorm = torch.sqrt(group.sum([model_axis_sq_norm(g, specs, model)
                                                  for g in grads]))
                else:
                    gnorm = torch.sqrt(model_axis_sq_norm(grads, specs, model, data))
                    grads = [grads]
            elif skip:
                # each worker's aggregate is exact on its own coordinates and
                # zero elsewhere: every coordinate is counted once
                norms = [opt_lib.global_grad_norm(g) for g in grads]
                gnorm = torch.sqrt(group.sum([n * n for n in norms]))
            else:
                gnorm = opt_lib.global_grad_norm(grads)
                grads = [grads]
        if fused:
            scalars = opt_lib.step_scalars(state.step, gnorm, ocfg, dev)
        elif ocfg.grad_clip:
            with obs.span("optimizer/clip"):
                grads = [opt_lib.clip_grads(g, gnorm, ocfg.grad_clip) for g in grads]
        if not skip:
            grads = grads * group.local_workers         # one aggregate for all
        moms = list(state.opt)
        with obs.span("optimizer/update"):
            for i, (p, d) in enumerate(zip(leaves, dims)):
                if d is None:
                    if fused:
                        adam_update_cuda([p], [grads[0][i]], state.opt["m"][i:i + 1],
                                         state.opt["v"][i:i + 1], scalars, ocfg)
                        continue
                    st = {k: state.opt[k][i] for k in moms}
                    new_p, new_st = opt_lib.opt_leaf_update(p, grads[0][i], st, lr,
                                                            state.step, ocfg)
                    p.copy_(new_p)
                    for k in moms:
                        state.opt[k][i] = new_st[k]
                    if plain_on_card:
                        obs.count("optimizer/plain_slices")
                    continue
                blk = p.shape[d] // W
                starts = [(group.first_worker + w) * blk
                          for w in range(group.local_workers)]
                if fused:
                    m_s, v_s = ([state.opt[k][i].narrow(d, w * blk, blk)
                                 for w in range(group.local_workers)] for k in ("m", "v"))
                    deltas = adam_update_cuda(
                        [p.narrow(d, s, blk) for s in starts],
                        [grads[w][i].narrow(d, s, blk) for w, s in enumerate(starts)],
                        m_s, v_s, scalars, ocfg, dim=d)
                else:
                    deltas = []
                    for w, start in enumerate(starts):
                        p_s = p.narrow(d, start, blk)
                        st = {k: state.opt[k][i].narrow(d, w * blk, blk) for k in moms}
                        new_p_s, new_st = opt_lib.opt_leaf_update(
                            p_s, grads[w][i].narrow(d, start, blk), st, lr,
                            state.step, ocfg)
                        for k in moms:
                            st[k].copy_(new_st[k])
                        deltas.append((new_p_s - p_s).to(p.dtype).movedim(d, 0)
                                      .contiguous())
                    if plain_on_card:
                        obs.count("optimizer/plain_slices", len(starts))
                with obs.span("optimizer/gather"):
                    p.add_(group.gather(deltas).movedim(0, d))
    return gnorm


def build_train_step(api: ModelAPI, tc: TrainConfig, group=None,
                     wire_plan=None, model=None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; ``batch``
    holds the global batch's tensors on the params' device, and the step
    runs the rows of ``group``'s local workers (default: a
    ``LocalWorkers`` of ``tc.workers`` on ``tc.dp_levels``).

    ``wire_plan``: a :class:`~repro_torch.core.wireplan.WirePlan` applied
    to the aggregator, how the ``auto`` controller swaps plans in (build
    the step anew for each plan); ignored where the effective strategy is
    dense (one worker, or ``tc.aggregator="dense"``). With
    ``tc.aggregator="auto"`` and no plan the step executes the analytic
    plan, and the metrics carry the per-bucket ``bucket_occupancy``
    (a vector) for the controller.

    ``model``: this rank's model-axis group on a grid of MP > 1 model
    ranks (``launch/mesh.RankMesh.model``; ``group`` is then its
    data-parallel group), for a state from ``init_train_state(...,
    model=model)``."""
    W, mp = tc.workers, _mp(model)
    check_model_axis(api.cfg, mp, tc.sharding)
    if group is None:
        group = LocalWorkers(W, tc.dp_levels)
    if group.workers != W or tuple(group.levels) != (tc.dp_levels or (W,)):
        raise ValueError(f"group of {group.workers} workers on levels "
                         f"{tuple(group.levels)} for a config of {W} on "
                         f"{tc.dp_levels or (W,)}")
    ocfg = tc.optimizer
    built = {}
    ep_exchange = None
    pure, data = pure_auto(tc, group), experts_group(tc, group)
    if not isinstance(group, LocalWorkers) and tc.ep_workers not in (1, mp):
        raise NotImplementedError(
            f"ep_workers={tc.ep_workers} on ranks with {mp} model rank(s): "
            "the dp x ep process layout shards the experts over the model "
            "axis (ep_workers 1 or model_parallel); emulate other EP "
            "ranks with LocalWorkers instead")
    ex_cfg = dataclasses.replace(tc.compression, ratio=2.5,
                                 topk_ratio=None, error_feedback=False)
    # a pure auto-sharded step has no exchange (the reference builds one
    # only where the EP axes are manual in the step's region)
    if tc.ep_exchange != "none" and api.cfg.moe is not None and not pure:
        if mp > 1:
            ep_exchange = agg_lib.make_exchange(tc.ep_exchange, ex_cfg, model)
        elif tc.ep_workers > 1:
            ep_exchange = agg_lib.make_exchange(tc.ep_exchange, ex_cfg,
                                                LocalWorkers(tc.ep_workers))

    def aggregator_for(params):
        """The step's aggregator, the leaves' ZeRO-1 dims and specs, and
        whether the aggregator skips its gather (static per shapes:
        built once)."""
        leaves = params.leaves()
        if not built:
            specs = leaf_specs(params, tc, model, group)
            dims = zero1_dims(leaves, tc, specs, pure)
            agg = agg_lib.make_aggregator(
                tc.aggregator if W > 1 and not pure else "dense",
                tc.compression, group)
            if wire_plan is not None and \
                    not isinstance(agg, agg_lib.DenseAggregator):
                agg = dataclasses.replace(agg, wire_plan=wire_plan)
            skip = False
            if isinstance(agg, agg_lib.CompressedReduceScatterAggregator) \
                    and tc.zero1 and tc.rs_gather_skip:
                agg = dataclasses.replace(agg, zero1_dims=dims)
                skip = agg.gather_skip_active(leaves)
            built.update(agg=agg, dims=dims, skip=skip, specs=specs)
        return built["agg"], built["dims"], built["skip"], built["specs"]

    def local_grads(params: ParamTree, batch):
        """One worker's (loss, metrics, grads)."""
        leaves = params.leaves()

        def loss_grads(b):
            # the backward too: a checkpointed block's recompute runs
            # the model axis's collectives again
            with model_region(model, experts=data):
                with obs.span("step/forward"):
                    loss, metrics = api.loss(params.tree(), b, remat=tc.remat,
                                             ep_exchange=ep_exchange)
                with obs.span("step/backward"):
                    grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

        if tc.accum_steps <= 1:
            return loss_grads(batch)
        n = batch["tokens"].shape[0]
        if n % tc.accum_steps:
            raise ValueError(f"{n} rows per worker do not split into "
                             f"{tc.accum_steps} microbatches")
        mb = n // tc.accum_steps
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for a in range(tc.accum_steps):
            loss, metrics, grads = loss_grads(
                {k: v[a * mb:(a + 1) * mb] for k, v in batch.items()})
            acc = [x + g for x, g in zip(acc, grads)]
            loss_sum = loss_sum + loss
        inv = 1.0 / tc.accum_steps
        return loss_sum * inv, metrics, [g * inv for g in acc]


    def rows(batch, w, B):
        """Worker w's rows of the global batch: ``[w·B/W, (w+1)·B/W)``;
        under a pure auto-sharded step with microbatches, its share of
        each microbatch (the reference's microbatch a is the global rows
        ``[a·B/A, (a+1)·B/A)``, split over the data ranks), in
        microbatch order."""
        A = tc.accum_steps
        if not pure or A <= 1:
            per = B // W
            return {k: v[w * per:(w + 1) * per] for k, v in batch.items()}
        if B % (A * W):
            raise ValueError(f"global batch {B} does not split into {A} "
                             f"microbatches over {W} workers")
        idx = torch.arange(B).reshape(A, W, B // (A * W))[:, w].reshape(-1)
        return {k: v[idx.to(v.device)] for k, v in batch.items()}

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        B = batch["tokens"].shape[0]
        if B % W:
            raise ValueError(f"global batch {B} does not split over {W} workers")
        losses, metrics_w, grads_w = [], [], []
        for w in range(group.first_worker,
                       group.first_worker + group.local_workers):
            loss, metrics, grads = local_grads(state.params, rows(batch, w, B))
            losses.append(loss)
            metrics_w.append(metrics)
            grads_w.append(grads)
        aggregator, dims, skip, specs = aggregator_for(state.params)
        with torch.no_grad():
            with obs.span("step/aggregate"):
                if data is not None:
                    grads = expert_mean(grads_w[0], specs, group)
                    agg_state = AggregationState(residual=state.residual)
                else:
                    grads, agg_state = aggregator(
                        grads_w, AggregationState(residual=state.residual))
            del grads_w
            if mp > 1 and not isinstance(aggregator, agg_lib.DenseAggregator):
                grads = ([sync_replicated(g, specs, model) for g in grads]
                         if skip else sync_replicated(grads, specs, model))
            gnorm = apply_update(state, grads, dims, group, ocfg, skip,
                                 specs=specs, model=model, data=data,
                                 use_pallas=tc.compression.use_pallas)
        stats = agg_state.stats
        names = list(metrics_w[0])    # one reduction for the loss and metrics
        mean = group.sum([torch.stack([l, *(m[k] for k in names)])
                          for l, m in zip(losses, metrics_w)]) / W
        out = dict(zip(names, mean[1:]))
        out["grad_norm"] = gnorm
        out["loss"] = mean[0]
        if stats is not None:
            out.update(recovery_nnz=stats.nnz, recovery_peeled=stats.peeled,
                       recovery_residual=stats.residual)
        if agg_state.telemetry is not None:
            # equal on every rank: computed from the aggregated stream
            out["bucket_occupancy"] = agg_state.telemetry["bucket_occupancy"]
        state.step += 1
        return state, out

    return step_fn
