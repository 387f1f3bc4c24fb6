"""Train step: W data-parallel workers, one aggregation, one replicated
optimizer update.

The step follows the reference's Algorithm 1 deployment:

  1. worker w computes local gradients on batch rows
     ``[w·B/W, (w+1)·B/W)`` (with optional microbatch accumulation);
  2. the gradients are aggregated across the workers by the strategy
     ``tc.aggregator`` (``"dense"``, ``"compressed"`` or
     ``"compressed_innet"``); as in the reference, a single worker always
     aggregates densely;
  3. the optimizer applies the mean gradient, replicated.

The workers are those of a group (``core/collectives``): by default all
W run in turn in this process on one device (``LocalWorkers``); with a
``ProcessGroupWorkers`` this process is one rank and runs its own worker
on its rows of the global batch. Every rank applies the same aggregate,
so the parameters stay replicated. The update is the replicated
``new_p`` of the reference's ``zero1=False`` path; ZeRO-1 comes with the
reduce-scatter slice. Parameters, moments and error-feedback residuals
are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.core import aggregators as agg_lib
from repro_torch.core.collectives import AggregationState, LocalWorkers
from repro_torch.models.params import ParamTree
from repro_torch.models.registry import ModelAPI
from .config import TrainConfig
from . import optimizer as opt_lib


@dataclasses.dataclass
class TrainState:
    params: ParamTree
    opt: Dict[str, List[torch.Tensor]]
    residual: List[torch.Tensor]   # EF residuals (local workers, *shape), or (0,) stubs
    step: int


def init_train_state(api: ModelAPI, tc: TrainConfig, device="cuda",
                     params: ParamTree | None = None,
                     group=None) -> TrainState:
    """Fresh state; ``params`` (e.g. from ``convert.params_from_jax``)
    replaces the random init from ``tc.seed``. The error-feedback
    residuals have one row per local worker of ``group`` (default: all
    ``tc.workers``)."""
    params = api.init(tc.seed, device) if params is None else params
    leaves = params.leaves()
    opt = opt_lib.init_opt_state(leaves, tc.optimizer)
    ccfg = tc.compression
    if tc.aggregator != "dense" and ccfg.topk_ratio is not None \
            and ccfg.error_feedback:
        local = tc.workers if group is None else group.local_workers
        residual = [torch.zeros((local,) + tuple(p.shape),
                                dtype=torch.float32, device=p.device)
                    for p in leaves]
    else:
        residual = [torch.zeros((0,), dtype=torch.float32, device=p.device)
                    for p in leaves]
    return TrainState(params=params, opt=opt, residual=residual, step=0)


def build_train_step(api: ModelAPI, tc: TrainConfig, group=None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; ``batch``
    holds the global batch's tensors on the params' device, and the step
    runs the rows of ``group``'s local workers (default: a
    ``LocalWorkers`` of ``tc.workers`` on ``tc.dp_levels``)."""
    W = tc.workers
    if group is None:
        group = LocalWorkers(W, tc.dp_levels)
    if group.workers != W or tuple(group.levels) != (tc.dp_levels or (W,)):
        raise ValueError(f"group of {group.workers} workers on levels "
                         f"{tuple(group.levels)} for a config of {W} on "
                         f"{tc.dp_levels or (W,)}")
    ocfg = tc.optimizer
    aggregator = agg_lib.make_aggregator(
        tc.aggregator if W > 1 else "dense", tc.compression, group)

    def local_grads(params: ParamTree, batch):
        """One worker's (loss, metrics, grads)."""
        leaves = params.leaves()

        def loss_grads(b):
            loss, metrics = api.loss(params.tree(), b, remat=tc.remat)
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

    def apply_updates(state: TrainState, grads):
        leaves = state.params.leaves()
        lr = opt_lib.lr_schedule(state.step, ocfg, leaves[0].device)
        gnorm = opt_lib.global_grad_norm(grads)
        if ocfg.grad_clip:
            grads = opt_lib.clip_grads(grads, gnorm, ocfg.grad_clip)
        moms = list(state.opt)
        for i, (p, g) in enumerate(zip(leaves, grads)):
            st = {k: state.opt[k][i] for k in moms}
            new_p, new_st = opt_lib.opt_leaf_update(p, g, st, lr, state.step, ocfg)
            p.copy_(new_p)
            for k in moms:
                state.opt[k][i] = new_st[k]
        return gnorm

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
        with torch.no_grad():
            grads, agg_state = aggregator(
                grads_w, AggregationState(residual=state.residual))
            del grads_w
            gnorm = apply_updates(state, grads)
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
        state.step += 1
        return state, out

    return step_fn
