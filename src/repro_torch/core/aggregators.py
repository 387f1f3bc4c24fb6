"""Aggregator strategies over the workers of a group: W workers emulated
on one device (:class:`LocalWorkers`), or this process as one of W ranks
(:class:`ProcessGroupWorkers`).

- :class:`DenseAggregator` — plain f32 sum of the raw gradients (the
  NCCL all-reduce baseline arm).
- :class:`CompressedAggregator` — the paper's pipeline over one fused
  bucket stream: per local worker, per-leaf sparsify + error feedback,
  bucket pack and ONE producer launch; then the sketch SUM and word OR
  over the workers; then ONE consumer launch on the aggregate and
  ``unpack(rec / W)``. This is the reference's unstreamed path on a pure data-parallel
  mesh with the trivial wire plan. With the Bloom index (or an unaligned
  bitmap) the producer and consumer are the compressor's composed passes
  around the standalone encode and peel kernels.
- :class:`CompressedInNetworkAggregator` — the same stream through the
  emulated in-network tier: on the fxp32 wire the sketch is quantized to
  shared-exponent int32 and summed, with the words ORed, by a windowed
  switch tree; the consumer dequantizes in its one launch.

Streaming, wire plans, telemetry and the other strategies come with
later slices.

An aggregator is called as ``agg(grads_w, state)``, where ``grads_w[w]``
is local worker w's gradient leaves in the reference's flatten order
(``group.local_workers`` of them: W emulated, one a rank) and
``state.residual`` holds one ``(local_workers, *shape)`` error-feedback
tensor per leaf. It returns the aggregated (mean over all W) leaves and
the new state, the same on every rank. The compressed strategy writes the
new residuals into ``state.residual`` in place (it is the only holder of
that memory; at full width it is one f32 copy of the model a worker).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.net.fixedpoint import FixedPointWire
from repro_torch.net.topology import make_topology, tree_all_reduce
from .config import CompressionConfig
from .compressor import CompressedLeaf, HomomorphicCompressor
from .bucketing import BucketPlan, make_bucket_plan
from .collectives import AggregationState, dense_all_reduce
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

    group: Any           # LocalWorkers or ProcessGroupWorkers
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
    group: Any           # LocalWorkers or ProcessGroupWorkers

    def _produce(self, grads_w: Sequence[Sequence[torch.Tensor]],
                 state: AggregationState, comp: HomomorphicCompressor,
                 plan: BucketPlan):
        """Phase I per local worker: sparsify + EF (residual row w
        updated in place), pack, one producer launch. Returns each local
        worker's ``(CompressedLeaf, per-block maxabs)``."""
        cfg = self.cfg
        if len(grads_w) != self.group.local_workers:
            raise ValueError(f"{len(grads_w)} gradient sets for "
                             f"{self.group.local_workers} local workers")
        ef_on = cfg.topk_ratio is not None and cfg.error_feedback
        out = []
        for w, leaves in enumerate(grads_w):
            flats = []
            for g, r in zip(leaves, state.residual):
                flat, nr = sparsify_leaf(g.reshape(-1).to(torch.float32),
                                         r[w] if ef_on else r, cfg)
                flats.append(flat)
                if ef_on:
                    r[w].copy_(nr.reshape(r.shape[1:]))
            out.append(comp.compress_wire(plan.pack_flat(flats).reshape(-1)))
        return out

    def _finish(self, rec: torch.Tensor, stats, plan: BucketPlan,
                state: AggregationState):
        out = plan.unpack(rec.reshape(plan.n_buckets, plan.bucket_elems)
                          / self.group.workers)
        return out, AggregationState(residual=state.residual, stats=stats)

    def __call__(self, grads_w: Sequence[Sequence[torch.Tensor]],
                 state: AggregationState):
        comp = HomomorphicCompressor(self.cfg)
        plan = make_bucket_plan(grads_w[0], self.cfg)
        cs = [c for c, _ in self._produce(grads_w, state, comp, plan)]
        agg = CompressedLeaf(sketch=self.group.sum([c.sketch for c in cs]),
                             index_words=self.group.bor(
                                 [c.index_words for c in cs]))
        rec, stats = comp.recover(agg, plan.padded, with_stats=True)
        return self._finish(rec, stats, plan, state)


@dataclasses.dataclass(frozen=True)
class CompressedInNetworkAggregator(CompressedAggregator):
    """Compressed aggregation through the emulated in-network tier, the
    paper's "aggregate inside the switch" deployment (the reference's
    unstreamed ``CompressedInNetworkAggregator``).

    Phase I is :class:`CompressedAggregator`'s. Phase II depends on
    ``cfg.wire_dtype``:

    - ``"fxp32"``, the switch's wire: per bucket, each worker's exponent
      comes from the producer's per-block ``maxabs`` (the max of the
      block maxima is the bucket max, exactly), the workers agree on the
      max (the reference's ``pmax``) before any of them quantizes, each
      quantizes its sketch to int32
      (:class:`repro_torch.net.fixedpoint.FixedPointWire`, overflow-free
      for W workers), and the int32 sketches and the words go through
      :func:`repro_torch.net.topology.tree_all_reduce` (integer add and
      OR over ``cfg.topology`` on the group's levels) in windows of
      ``cfg.switch_slots`` buckets. One consumer launch dequantizes the
      aggregate with the exponents expanded per block and peels it. The
      result is the documented codec roundtrip bit for bit, whatever the
      tree's order.
    - ``"f32"``, an idealized float-capable tier: the topology is
      validated and the step is :class:`CompressedAggregator`'s, bit for
      bit (a tree of float adds would be order-sensitive).

    ``cfg.overlap`` and ``cfg.stream_chunks`` (the streamed schedule)
    come with the stream-scheduler slice and raise until then. The fxp32
    wire needs ``index="bitmap"``: the tree ORs the words bucket by
    bucket, and a Bloom filter has no per-bucket words (the reference
    fails reshaping them); a bitmap geometry with ``block_elems % 32 !=
    0`` works, since buckets hold whole words.
    """

    wire = "compressed_innet"

    def __post_init__(self):
        if self.cfg.overlap or self.cfg.stream_chunks is not None:
            raise NotImplementedError(
                "compressed_innet: overlap/stream_chunks need the stream "
                "scheduler, which is not ported yet")
        if self.cfg.wire_dtype == "fxp32" and self.cfg.index != "bitmap":
            raise ValueError(
                f"compressed_innet with wire_dtype='fxp32' needs "
                f"index='bitmap', got index={self.cfg.index!r}: the switch "
                "tree ORs the index words per bucket, and a Bloom filter "
                "hashes the whole stream's coordinates into words that "
                "belong to no bucket")

    def __call__(self, grads_w: Sequence[Sequence[torch.Tensor]],
                 state: AggregationState):
        cfg, group = self.cfg, self.group
        topo = make_topology(cfg.topology, group)
        if cfg.wire_dtype == "f32":
            return super().__call__(grads_w, state)
        comp = HomomorphicCompressor(cfg)
        plan = make_bucket_plan(grads_w[0], cfg)
        wire = FixedPointWire(workers=group.workers)
        nbk, nbpb = plan.n_buckets, plan.bucket_elems // cfg.block_elems
        cs, maxabs = zip(*self._produce(grads_w, state, comp, plan))
        exp = group.max([wire.exponents_from_maxabs(
            mx.reshape(nbk, nbpb).amax(dim=1)) for mx in maxabs])
        q = tree_all_reduce(
            [wire.encode(c.sketch.reshape(nbk, -1), exp) for c in cs],
            topo, "add", window_slots=cfg.switch_slots, group=group)[0]
        words = tree_all_reduce(
            [c.index_words.reshape(nbk, -1) for c in cs],
            topo, "or", window_slots=cfg.switch_slots, group=group)[0]
        rec, stats = comp.recover(
            CompressedLeaf(sketch=q.reshape(cs[0].sketch.shape),
                           index_words=words.reshape(-1)),
            plan.padded, with_stats=True,
            dequant=(exp.repeat_interleave(nbpb), wire.mantissa_bits))
        return self._finish(rec, stats, plan, state)


AGGREGATORS = {"dense": DenseAggregator, "compressed": CompressedAggregator,
               "compressed_innet": CompressedInNetworkAggregator}


def make_aggregator(name: str, cfg: CompressionConfig, group):
    if name not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {name!r}; this slice has "
                         f"{sorted(AGGREGATORS)}")
    return AGGREGATORS[name](cfg=cfg, group=group)
