"""Aggregator strategies over the workers of a :class:`LocalWorkers` group.

- :class:`DenseAggregator` — plain f32 sum of the raw gradients (the
  NCCL all-reduce baseline arm).
- :class:`CompressedAggregator` — the paper's pipeline over one fused
  bucket stream: per worker, per-leaf sparsify + error feedback, bucket
  pack and ONE producer launch; then the sketch SUM and word OR over the
  workers; then ONE consumer launch on the aggregate and ``unpack(rec /
  W)``. This is the reference's unstreamed path on a pure data-parallel
  mesh with the trivial wire plan; streaming, wire plans, telemetry and
  the other strategies come with later slices.

An aggregator is called as ``agg(grads_w, state)``, where ``grads_w[w]``
is worker w's gradient leaves in the reference's flatten order and
``state.residual`` holds one ``(W, *shape)`` error-feedback tensor per
leaf. It returns the aggregated (mean) leaves and the new state. The
compressed strategy writes the new residuals into ``state.residual`` in
place (it is the only holder of that memory; at full width it is W f32
copies of the model).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from .config import CompressionConfig
from .compressor import CompressedLeaf, HomomorphicCompressor
from .bucketing import make_bucket_plan
from .collectives import AggregationState, LocalWorkers, dense_all_reduce
from . import topk as topk_lib


def sparsify_leaf(flat: torch.Tensor, res: torch.Tensor,
                  cfg: CompressionConfig):
    """Per-leaf phase 0: top-k budget + error feedback on one flat f32
    leaf; k is proportional to this leaf's element count."""
    new_res = res
    if cfg.topk_ratio is not None:
        k = max(1, int(flat.shape[0] * cfg.topk_ratio))
        if cfg.error_feedback:
            flat, new_res = topk_lib.apply_error_feedback(
                flat, res.reshape(-1), k, exact=cfg.topk_exact)
        elif cfg.topk_exact:
            flat = topk_lib.sparsify_topk(flat, k)
        else:
            flat = topk_lib.sparsify_threshold(flat, k)
    return flat, new_res


@dataclasses.dataclass(frozen=True)
class DenseAggregator:
    wire = "dense"

    group: LocalWorkers
    cfg: Any = None      # constructor uniformity only

    def __call__(self, grads_w: Sequence[Sequence[torch.Tensor]],
                 state: AggregationState):
        return dense_all_reduce(grads_w, self.group), state


@dataclasses.dataclass(frozen=True)
class CompressedAggregator:
    """pack -> per-leaf sparsify/EF -> encode -> sketch SUM + word OR ->
    peel -> unpack, over one fused bucket stream."""

    wire = "compressed"

    cfg: CompressionConfig
    group: LocalWorkers

    def __call__(self, grads_w: Sequence[Sequence[torch.Tensor]],
                 state: AggregationState):
        cfg, W = self.cfg, self.group.workers
        ef_on = cfg.topk_ratio is not None and cfg.error_feedback
        comp = HomomorphicCompressor(cfg)
        plan = make_bucket_plan(grads_w[0], cfg)
        sketches, words = [], []
        for w, leaves in enumerate(grads_w):
            flats = []
            for g, r in zip(leaves, state.residual):
                flat, nr = sparsify_leaf(g.reshape(-1).to(torch.float32),
                                         r[w] if ef_on else r, cfg)
                flats.append(flat)
                if ef_on:
                    r[w].copy_(nr.reshape(r.shape[1:]))
            c = comp.compress(plan.pack_flat(flats).reshape(-1))
            sketches.append(c.sketch)
            words.append(c.index_words)
        agg = CompressedLeaf(sketch=self.group.sum(sketches),
                             index_words=self.group.bor(words))
        rec, stats = comp.recover(agg, plan.padded, with_stats=True)
        out = plan.unpack(rec.reshape(plan.n_buckets, plan.bucket_elems) / W)
        return out, AggregationState(residual=state.residual, stats=stats)


AGGREGATORS = {"dense": DenseAggregator, "compressed": CompressedAggregator}


def make_aggregator(name: str, cfg: CompressionConfig, group: LocalWorkers):
    if name not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {name!r}; this slice has "
                         f"{sorted(AGGREGATORS)}")
    return AGGREGATORS[name](cfg=cfg, group=group)
