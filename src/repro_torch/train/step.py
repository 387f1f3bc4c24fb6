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
feedback off, where a fully dense payload peels exactly. On ranks
(``ProcessGroupWorkers``) ``ep_workers > 1`` raises: it needs a ``dp x
ep`` process layout the launcher does not build yet.

:func:`state_view` gives the state without its layout (whole moments,
every worker's residual row), as a checkpoint holds it, and
:func:`load_state_view` puts such a state back into any layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import aggregators as agg_lib
from repro_torch.core.collectives import AggregationState, LocalWorkers
from repro_torch.core.streams import zero_slice_dim
from repro_torch.models.params import ParamTree, unflatten_tree
from repro_torch.models.registry import ModelAPI
from .config import TrainConfig
from . import optimizer as opt_lib


@dataclasses.dataclass
class TrainState:
    params: ParamTree
    opt: Dict[str, List[torch.Tensor]]   # moments; a rank holds its slice of a ZeRO-1 leaf's
    residual: List[torch.Tensor]   # EF residuals (local workers, *shape), or (0,) stubs
    step: int


def zero1_dims(leaves: Sequence[torch.Tensor],
               tc: TrainConfig) -> List[Optional[int]]:
    """Each leaf's ZeRO-1 slice dim (None: updated replicated); all None
    unless ``tc.zero1`` and W > 1."""
    if not (tc.zero1 and tc.workers > 1):
        return [None] * len(leaves)
    return [zero_slice_dim(tuple(p.shape), (), tc.workers) for p in leaves]


def init_train_state(api: ModelAPI, tc: TrainConfig, device="cuda",
                     params: ParamTree | None = None,
                     group=None) -> TrainState:
    """Fresh state; ``params`` (e.g. from ``convert.params_from_jax``)
    replaces the random init from ``tc.seed``. The error-feedback
    residuals have one row per local worker of ``group`` (default: all
    ``tc.workers``); with ``tc.zero1``, a rank of W (a group with fewer
    local workers than W) holds only its slice of each sliced leaf's
    moments."""
    params = api.init(tc.seed, device) if params is None else params
    leaves = params.leaves()
    local = tc.workers if group is None else group.local_workers
    shapes = []
    for p, d in zip(leaves, zero1_dims(leaves, tc)):
        shape = list(p.shape)
        if d is not None and local < tc.workers:
            shape[d] //= tc.workers
        shapes.append(shape)
    opt = opt_lib.init_opt_state(leaves, tc.optimizer, shapes)
    ccfg = tc.compression
    if tc.aggregator != "dense" and ccfg.topk_ratio is not None \
            and ccfg.error_feedback:
        residual = [torch.zeros((local,) + tuple(p.shape),
                                dtype=torch.float32, device=p.device)
                    for p in leaves]
    else:
        residual = [torch.zeros((0,), dtype=torch.float32, device=p.device)
                    for p in leaves]
    return TrainState(params=params, opt=opt, residual=residual, step=0)


def state_view(state: TrainState, tc: TrainConfig, group=None) -> TrainState:
    """The state with no layout, as a checkpoint holds it: the
    reference's ``TrainState`` tree, every leaf whole.

    ``params`` and ``residual`` are nested dicts on the reference's
    paths and ``opt`` one such dict a moment, so the checkpoint's leaf
    paths are the reference's; ``step`` is an int32 scalar. A rank's
    ZeRO-1 moment slices and its local workers' residual rows are
    gathered over ``group`` (``group.gather``, as ``apply_update``
    gathers its deltas): every rank of a group must call this together.
    On ``LocalWorkers`` (``group`` None) the leaves are the live tensors
    themselves."""
    params = state.params
    leaves = params.leaves()
    whole = group is None or group.local_workers == group.workers

    def tree(ts):
        return unflatten_tree(list(zip(params.paths, ts)))

    def moment(m, p, d):
        if whole or d is None or m.shape == p.shape:
            return m
        return group.gather([m.movedim(d, 0).contiguous()]).movedim(0, d)

    def rows(r):
        return r if whole or r.numel() == 0 else group.gather([r])

    dims = zero1_dims(leaves, tc)
    opt = {k: tree([moment(m, p, d) for m, p, d in zip(ms, leaves, dims)])
           for k, ms in state.opt.items()}
    return TrainState(params=tree(leaves), opt=opt,
                      residual=tree([rows(r) for r in state.residual]),
                      step=torch.tensor(state.step, dtype=torch.int32))


def view_paths(state: TrainState) -> List[str]:
    """The leaf paths of :func:`state_view`'s tree, in flatten order."""
    names = [".".join(p) for p in state.params.paths]
    return ([f"params.{n}" for n in names]
            + [f"opt.{k}.{n}" for k in sorted(state.opt) for n in names]
            + [f"residual.{n}" for n in names] + ["step"])


def load_state_view(state: TrainState, leaves: Sequence[torch.Tensor],
                    tc: TrainConfig, group=None) -> None:
    """The inverse of :func:`state_view`: ``leaves`` (whole, on any
    device, in :func:`view_paths` order) narrowed to this group's
    ZeRO-1 slice of each moment and its local workers' residual rows,
    and copied into the live tensors in place (``build_train_step`` keeps
    references to them); ``state.step`` set. A leaf of another shape or
    dtype raises."""
    params = state.params.leaves()
    moms = sorted(state.opt)
    want = (2 + len(moms)) * len(params) + 1
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} leaves for a state of {want}")
    src = iter(leaves)
    first = 0 if group is None else group.first_worker

    def put(dst, x, what):
        if tuple(x.shape) != tuple(dst.shape) or x.dtype != dst.dtype:
            raise ValueError(f"{what}: {tuple(x.shape)} {x.dtype} for "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(x)

    with torch.no_grad():
        for p in params:
            put(p, next(src), "param")
        for k in moms:
            for i, (m, p, d) in enumerate(zip(state.opt[k], params,
                                              zero1_dims(params, tc))):
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


def apply_update(state: TrainState, grads, dims: Sequence[Optional[int]],
                 group, ocfg: opt_lib.OptimizerConfig,
                 skip: bool = False) -> torch.Tensor:
    """The optimizer update of one step, in place; returns the grad norm.

    ``grads`` is the aggregate (every local worker's), or with ``skip``
    (the gather-skip path) one aggregate a local worker, exact on its own
    coordinates. ``dims[i]`` is leaf i's ZeRO-1 dim: None updates the
    leaf replicated; otherwise each local worker updates its slice with
    its slice of the moments (a rank's moments are that slice; a
    ``LocalWorkers``' are whole) and the leaf gains the gathered deltas.
    """
    W = group.workers
    leaves = state.params.leaves()
    lr = opt_lib.lr_schedule(state.step, ocfg, leaves[0].device)
    if skip:
        # each worker's aggregate is exact on its own coordinates and
        # zero elsewhere: every coordinate is counted once
        norms = [opt_lib.global_grad_norm(g) for g in grads]
        gnorm = torch.sqrt(group.sum([n * n for n in norms]))
    else:
        gnorm = opt_lib.global_grad_norm(grads)
        grads = [grads]
    if ocfg.grad_clip:
        grads = [opt_lib.clip_grads(g, gnorm, ocfg.grad_clip) for g in grads]
    if not skip:
        grads = grads * group.local_workers         # one aggregate for all
    moms = list(state.opt)
    for i, (p, d) in enumerate(zip(leaves, dims)):
        if d is None:
            st = {k: state.opt[k][i] for k in moms}
            new_p, new_st = opt_lib.opt_leaf_update(p, grads[0][i], st, lr,
                                                    state.step, ocfg)
            p.copy_(new_p)
            for k in moms:
                state.opt[k][i] = new_st[k]
            continue
        blk = p.shape[d] // W
        deltas = []
        for w in range(group.local_workers):
            start = (group.first_worker + w) * blk
            p_s = p.narrow(d, start, blk)
            st = {k: state.opt[k][i].narrow(d, w * blk, blk) for k in moms}
            new_p_s, new_st = opt_lib.opt_leaf_update(
                p_s, grads[w][i].narrow(d, start, blk), st, lr, state.step, ocfg)
            for k in moms:
                st[k].copy_(new_st[k])
            deltas.append((new_p_s - p_s).to(p.dtype).movedim(d, 0).contiguous())
        p.add_(group.gather(deltas).movedim(0, d))
    return gnorm


def build_train_step(api: ModelAPI, tc: TrainConfig, group=None,
                     wire_plan=None):
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
    (a vector) for the controller."""
    W = tc.workers
    if group is None:
        group = LocalWorkers(W, tc.dp_levels)
    if group.workers != W or tuple(group.levels) != (tc.dp_levels or (W,)):
        raise ValueError(f"group of {group.workers} workers on levels "
                         f"{tuple(group.levels)} for a config of {W} on "
                         f"{tc.dp_levels or (W,)}")
    ocfg = tc.optimizer
    built = {}
    ep_exchange = None
    if tc.ep_workers > 1 and not isinstance(group, LocalWorkers):
        raise NotImplementedError(
            f"ep_workers={tc.ep_workers} on ranks needs a dp x ep process "
            "layout (launch/ranks.py), which a later slice of the port "
            "adds; emulate the EP ranks with LocalWorkers instead")
    if tc.ep_exchange != "none" and api.cfg.moe is not None \
            and tc.ep_workers > 1:
        ex_cfg = dataclasses.replace(tc.compression, ratio=2.5,
                                     topk_ratio=None, error_feedback=False)
        ep_exchange = agg_lib.make_exchange(tc.ep_exchange, ex_cfg,
                                            LocalWorkers(tc.ep_workers))

    def aggregator_for(leaves):
        """The step's aggregator, the leaves' ZeRO-1 dims and whether the
        aggregator skips its gather (static per shapes: built once)."""
        if not built:
            dims = zero1_dims(leaves, tc)
            agg = agg_lib.make_aggregator(
                tc.aggregator if W > 1 else "dense", tc.compression, group)
            if wire_plan is not None and \
                    not isinstance(agg, agg_lib.DenseAggregator):
                agg = dataclasses.replace(agg, wire_plan=wire_plan)
            skip = False
            if isinstance(agg, agg_lib.CompressedReduceScatterAggregator) \
                    and tc.zero1 and tc.rs_gather_skip:
                agg = dataclasses.replace(agg, zero1_dims=dims)
                skip = agg.gather_skip_active(leaves)
            built.update(agg=agg, dims=dims, skip=skip)
        return built["agg"], built["dims"], built["skip"]

    def local_grads(params: ParamTree, batch):
        """One worker's (loss, metrics, grads)."""
        leaves = params.leaves()

        def loss_grads(b):
            loss, metrics = api.loss(params.tree(), b, remat=tc.remat,
                                     ep_exchange=ep_exchange)
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


    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        B = batch["tokens"].shape[0]
        if B % W:
            raise ValueError(f"global batch {B} does not split over {W} workers")
        per = B // W
        losses, metrics_w, grads_w = [], [], []
        for w in range(group.first_worker,
                       group.first_worker + group.local_workers):
            loss, metrics, grads = local_grads(
                state.params, {k: v[w * per:(w + 1) * per] for k, v in batch.items()})
            losses.append(loss)
            metrics_w.append(metrics)
            grads_w.append(grads)
        aggregator, dims, skip = aggregator_for(state.params.leaves())
        with torch.no_grad():
            grads, agg_state = aggregator(
                grads_w, AggregationState(residual=state.residual))
            del grads_w
            gnorm = apply_update(state, grads, dims, group, ocfg, skip)
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
