"""Training loop: step dispatch + checkpointing + failure recovery +
straggler accounting, the reference's ``train/loop.py``.

Control flow on failure (injected by a ``FailureSimulator``): detect ->
restore the last checkpoint into the live state -> replay the
deterministic data stream from the restored step -> continue.
``run_training`` survives any number of injected failures up to
``RecoveryPolicy.max_restarts``.

A checkpoint holds the layout-free view of the state
(``step.state_view``): whole parameters and moments and all W residual
rows, so a run on W ranks and a run on ``LocalWorkers`` of W read each
other's checkpoints. On ranks every rank enters the save's gathers and
rank 0 alone writes; the step to restore is rank 0's ``latest_step``,
agreed over the group after rank 0's writes have finished. On a grid of
W x MP ranks (``model``: the rank's model-axis group) the view gathers
the model shards too, global rank 0 alone writes, and the agreement
runs over the data group, then the model group.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import Prefetcher, batch_fn, host_tensors
from repro_torch.ft.failures import (FailureSimulator, InjectedFailure,
                                     RecoveryPolicy, StragglerMonitor)
from repro_torch.models.params import ParamTree
from repro_torch.models.registry import ModelAPI
from .config import TrainConfig
from .step import (TrainState, build_train_step, init_train_state,
                   load_state_view, shard_params, state_view, view_paths)


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    metrics: List[Dict[str, Any]]
    restarts: int
    straggler_events: List[dict]
    step_seconds: List[float]      # host clock, each ending in a sync
    final_step: int
    state: Any
    ckpt_events: List[dict] = dataclasses.field(default_factory=list)
    # one a checkpoint's layout-free view ("view": step, ms; the gathers
    # on ranks), a save ("save": step, bytes, copy_ms, write_ms; rank
    # 0's) and a restore ("restore": step, ms)


def device_batch(host: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: integer arrays as int64,
    float arrays (``frames``, ``vis_embed``) in their own dtype."""
    return {k: v.to(device) for k, v in host_tensors(host).items()}


def _agreed_latest(ckpt_dir: str, group, writer: bool, device,
                   model=None) -> Optional[int]:
    """Rank 0's ``latest_step`` (None: no checkpoint), the same on every
    rank of ``group`` and of ``model`` (a max over each, which every rank
    enters)."""
    last = ckpt.latest_step(ckpt_dir) if writer else None
    if group is None:
        return last
    t = torch.tensor([-1 if last is None else last], dtype=torch.int64,
                     device=device)
    t = group.max([t] * group.local_workers)
    if model is not None:
        t = model.max([t])
    got = int(t.item())
    return None if got < 0 else got


def _restore(state: TrainState, ckpt_dir: str, step: int, tc: TrainConfig,
             group, model=None) -> Dict[str, float]:
    t0 = time.perf_counter()
    manifest, leaves = ckpt.restore(ckpt_dir, step)
    paths = [e["path"] for e in manifest["leaves"]]
    if paths != view_paths(state):
        raise ValueError(f"checkpoint step {step} under {ckpt_dir} holds "
                         "another model's state")
    load_state_view(state, leaves, tc, group, model)
    return {"kind": "restore", "step": step,
            "ms": (time.perf_counter() - t0) * 1e3}


def _reset(state: TrainState, api: ModelAPI, tc: TrainConfig,
           initial: Optional[List[torch.Tensor]], model=None, group=None):
    """Back to the run's initial state in place: its initial parameters
    (``initial``, or the init from ``tc.seed``), zero moments and
    residuals, step 0, as ``init_train_state`` made them."""
    leaves = state.params.leaves()
    if initial is None:
        initial = shard_params(api.init(tc.seed, leaves[0].device), tc,
                               model, group).leaves()
    with torch.no_grad():
        for p, x in zip(leaves, initial):
            p.copy_(x)
        for ms in state.opt.values():
            for m in ms:
                m.zero_()
        for r in state.residual:
            r.zero_()
    state.step = 0


def run_training(api: ModelAPI, tc: TrainConfig, *, global_batch: int,
                 seq_len: int, steps: int, device="cuda",
                 params: Optional[ParamTree] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 failure_sim: Optional[FailureSimulator] = None,
                 recovery: RecoveryPolicy = RecoveryPolicy(),
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print,
                 group=None, wire_plan=None, model=None) -> TrainResult:
    """Train up to step ``steps`` (``params`` replaces the random init);
    batch ``s`` is the pipeline's batch of step ``s``, prefetched on a
    background thread. ``group`` picks the workers this process runs
    (default: all ``tc.workers`` emulated here), ``model`` its
    model-axis group on a grid (``launch/mesh.RankMesh``) and
    ``wire_plan`` the aggregator's wire plan (see ``build_train_step``).

    With ``ckpt_dir``: resume from its latest checkpoint, save every
    ``ckpt_every`` steps (``metadata={"loss": ...}``, the host copy
    blocking, the write in the background), and on an
    ``InjectedFailure`` from ``failure_sim`` restore the latest
    checkpoint (or go back to the run's initial state where there is
    none yet) and replay; past ``recovery.max_restarts``, or without a
    ``ckpt_dir``, the failure propagates. Vector metrics (the ``auto``
    strategy's ``bucket_occupancy``) are kept as lists, scalars as
    floats."""
    device = torch.device(device)
    make_batch = batch_fn(api.cfg, global_batch, seq_len, seed=tc.seed)
    monitor = StragglerMonitor()
    saver = ckpt.AsyncCheckpointer()
    writer = (group is None or group.first_worker == 0) and \
        (model is None or model.first_worker == 0)
    state = init_train_state(api, tc, device, params=params, group=group,
                             model=model)
    # a restart with no checkpoint yet goes back to the caller's params
    initial = ([p.detach().cpu().clone() for p in state.params.leaves()]
               if params is not None and ckpt_dir else None)
    step_fn = build_train_step(api, tc, group=group, wire_plan=wire_plan,
                               model=model)
    events: List[dict] = []

    if ckpt_dir and (last := _agreed_latest(ckpt_dir, group, writer,
                                            device, model)) is not None:
        events.append(_restore(state, ckpt_dir, last, tc, group, model))
        log_fn(f"[loop] resumed from checkpoint step {last}")

    losses, all_metrics, secs = [], [], []
    restarts = 0
    step = state.step
    batches = Prefetcher(make_batch, device=device, start_step=step)
    try:
        while step < steps:
            try:
                t0 = time.perf_counter()
                if failure_sim is not None:
                    failure_sim.check(step)
                got, batch = next(batches)
                if got != step:
                    raise RuntimeError(f"prefetched step {got} for step {step}")
                state, metrics = step_fn(state, batch)
                host = {k: float(v) if v.dim() == 0 else v.tolist()  # syncs
                        for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                monitor.observe(step, dt)
                secs.append(dt)
                losses.append(host["loss"])
                all_metrics.append(host)
                if log_every and step % log_every == 0:
                    log_fn(f"[loop] step {step} loss {host['loss']:.4f} "
                           f"({dt * 1e3:.0f} ms)")
                step += 1
                if ckpt_dir and step % ckpt_every == 0:
                    t1 = time.perf_counter()
                    view = state_view(state, tc, group, model)
                    events.append({"kind": "view", "step": step, "ms":
                                   (time.perf_counter() - t1) * 1e3})
                    if writer:
                        saver.save(ckpt_dir, step, view,
                                   metadata={"loss": host["loss"]})
                    del view
            except InjectedFailure as e:
                restarts += 1
                log_fn(f"[loop] FAILURE detected: {e}; restart {restarts}")
                if restarts > recovery.max_restarts or ckpt_dir is None:
                    raise
                saver.wait()
                batches.close()
                last = _agreed_latest(ckpt_dir, group, writer, device, model)
                if last is None:
                    _reset(state, api, tc, initial, model, group)
                else:
                    events.append(_restore(state, ckpt_dir, last, tc, group,
                                           model))
                step = state.step
                batches = Prefetcher(make_batch, device=device,
                                     start_step=step)
                log_fn(f"[loop] recovered at step {step}")
    finally:
        batches.close()
        saver.close()
    events += [{"kind": "save", **r} for r in saver.records]
    return TrainResult(losses=losses, metrics=all_metrics, restarts=restarts,
                       straggler_events=monitor.events, step_seconds=secs,
                       final_step=step, state=state, ckpt_events=events)
