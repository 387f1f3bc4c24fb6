"""Training loop: batches from the deterministic pipeline, one step each.

Checkpointing and failure injection come with the checkpoint and
fault-tolerance slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.data.pipeline import batch_fn
from repro_torch.models.params import ParamTree
from repro_torch.models.registry import ModelAPI
from .config import TrainConfig
from .step import build_train_step, init_train_state


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    metrics: List[Dict[str, Any]]
    step_seconds: List[float]      # host clock, each ending in a sync
    final_step: int
    state: Any


def device_batch(host: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy int32 batch -> int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in host.items()}


def run_training(api: ModelAPI, tc: TrainConfig, *, global_batch: int,
                 seq_len: int, steps: int, device="cuda",
                 params: Optional[ParamTree] = None, log_every: int = 10,
                 log_fn: Callable[[str], None] = print,
                 group=None, wire_plan=None) -> TrainResult:
    """Train ``steps`` steps from a fresh state (``params`` replaces the
    random init); batch ``s`` is the pipeline's batch of step ``s``, and
    ``group`` picks the workers this process runs (default: all
    ``tc.workers`` emulated here) and ``wire_plan`` the aggregator's wire
    plan (see ``build_train_step``). Vector metrics (the ``auto``
    strategy's ``bucket_occupancy``) are kept as lists, scalars as
    floats."""
    device = torch.device(device)
    make_batch = batch_fn(api.cfg, global_batch, seq_len, seed=tc.seed)
    state = init_train_state(api, tc, device, params=params, group=group)
    step_fn = build_train_step(api, tc, group=group, wire_plan=wire_plan)
    losses, all_metrics, secs = [], [], []
    for step in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, device_batch(make_batch(step), device))
        host = {k: float(v) if v.dim() == 0 else v.tolist()   # syncs the device
                for k, v in metrics.items()}
        secs.append(time.perf_counter() - t0)
        losses.append(host["loss"])
        all_metrics.append(host)
        if log_every and step % log_every == 0:
            log_fn(f"[loop] step {step} loss {host['loss']:.4f} "
                   f"({secs[-1] * 1e3:.0f} ms)")
    return TrainResult(losses=losses, metrics=all_metrics, step_seconds=secs,
                       final_step=steps, state=state)
