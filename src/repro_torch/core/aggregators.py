"""Aggregator strategies over the workers of a group: W workers emulated
on one device (:class:`LocalWorkers`), or this process as one of W ranks
(:class:`ProcessGroupWorkers`).

- :class:`DenseAggregator` — plain f32 sum of the raw gradients (the
  NCCL all-reduce baseline arm).
- :class:`CompressedAggregator` — the paper's pipeline over one fused
  bucket stream: per local worker, per-leaf sparsify + error feedback,
  bucket pack and ONE producer launch; then the sketch SUM and word OR
  over the workers; then ONE consumer launch on the aggregate and
  ``unpack(rec / W)``. With the Bloom index (or an unaligned bitmap) the
  producer and consumer are the compressor's composed passes around the
  standalone encode and peel kernels. With ``cfg.overlap`` /
  ``cfg.stream_chunks`` the wire is cut into whole-bucket chunks
  (:func:`repro_torch.core.streams.make_stream_plan`): one producer
  launch a chunk a local worker at the chunk's block offset, each
  chunk's sum and OR issued through
  :func:`~repro_torch.core.streams.stream_schedule` while the next
  chunk encodes, and one consumer launch on the reassembled stream.
- :class:`CompressedReduceScatterAggregator` — the reduce-scatter wire:
  the sketch and the words are reduce-scattered, so each rank receives
  and peels only its own 1/W of the buckets (one consumer launch a rank,
  or one a received chunk slice when streamed, at the slice's block
  offset), and the recovered slices are all-gathered; when the chunk
  grid aligns with the ZeRO-1 optimizer slices (``zero1_dims``), the
  gather is skipped.
- :class:`CompressedInNetworkAggregator` — the same stream through the
  emulated in-network tier: on the fxp32 wire the sketch is quantized to
  shared-exponent int32 and summed, with the words ORed, by a windowed
  switch tree, a chunk of whole switch windows at a time when streamed;
  the consumer dequantizes in its one launch.

- :class:`WirePlannedAggregator` — ``auto``: executes a
  :class:`~repro_torch.core.wireplan.WirePlan` (by default the analytic
  plan of :mod:`repro_torch.core.costmodel`) and reports each bucket's
  occupancy for the controller.

Plan and execute: every compressed strategy executes a wire plan. A
fixed strategy with no plan (or its own trivial one) runs the path
above unchanged. Otherwise each local worker's stream is packed first
(sparsify and error feedback run once, before any group), and each group
of the plan runs on its wire over its rows of every packed stream: a
``dense`` group as the group's sum of the packed f32 rows, a compressed
group through its wire's strategy (a delegate) on the group's
``BucketPlan.group_view`` at the group's global block offset
(``base_block``), so each group equals the fixed strategy on those
buckets bit for bit.

The expert-parallel all-to-all exchanges (:data:`EXCHANGES`, built by
:func:`make_exchange`) are no gradient aggregators: the MoE layer calls
one inside its forward, each local worker an EP rank with a ``(W,
...)`` payload, lane d for rank d, and each receives its lane merged
over the sources. :class:`DenseAllToAllExchange` ships the packed f32
lanes; :class:`CompressedAllToAllExchange` their sketches and words,
merged by the lane sum and OR, peeled at the receiving rank.

An aggregator is called as ``agg(grads_w, state)``, where ``grads_w[w]``
is local worker w's gradient leaves in the reference's flatten order
(``group.local_workers`` of them: W emulated, one a rank) and
``state.residual`` holds one ``(local_workers, *shape)`` error-feedback
tensor per leaf. It returns the aggregated (mean over all W, or the sum
with ``mean=False``) leaves and the new state, the same on every rank;
on the gather-skip path (:meth:`CompressedReduceScatterAggregator.
gather_skip_active`) it returns one list of leaves a local worker
instead, each exact inside that worker's owned coordinates and zero
outside. The compressed strategies write the new residuals into
``state.residual`` in place (the only holder of that memory; at full
width it is one f32 copy of the model a worker).

Each stage of a compressed strategy is a :mod:`repro_torch.obs` span
(subclasses inherit them): ``aggregate/sparsify`` (one local worker's
f32 cast, error feedback, top-k, residual write and pack),
``aggregate/encode`` (each producer call), ``aggregate/wire`` (each
reduction of the payloads: sum and OR, their scatters, or the switch
tree), ``aggregate/peel`` (the consumer of a wire group) and
``aggregate/unpack`` (unpack and mean). Where the streamed paths run a
chunk's reduction on a communication thread, that span times the
thread's side stream.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Sequence

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.net.fixedpoint import FixedPointWire
from repro_torch.net.topology import make_topology, tree_all_reduce
from .config import CompressionConfig
from .compressor import CompressedLeaf, HomomorphicCompressor, RecoveryStats
from .bucketing import BucketPlan, make_bucket_plan, make_dest_bucket_plans
from .collectives import (AggregationState, alltoall_lane_sum,
                          dense_all_reduce, gather_chunk_slices,
                          sketch_all_to_all)
from .streams import (StreamPlan, make_alltoall_stream_plan, make_stream_plan,
                      stream_schedule, zero1_gather_skip)
from .wireplan import WIRES, WirePlan, pattern_wires, uniform_plan
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
    """Same constructor surface as the compressed strategies; ``cfg`` and
    ``zero1_dims`` are unused, and a ``wire_plan`` is refused (the dense
    groups of a plan run inside the compressed strategies)."""

    wire = "dense"

    group: Any           # LocalWorkers or ProcessGroupWorkers
    cfg: Any = None
    mean: bool = True
    zero1_dims: Any = None
    wire_plan: Any = None

    def __call__(self, grads_w: Sequence[Sequence[torch.Tensor]],
                 state: AggregationState):
        if self.wire_plan is not None:
            raise ValueError(
                "DenseAggregator does not execute wire plans; use the "
                "'auto' strategy (or a compressed strategy with "
                "wire_plan=...) for per-bucket-group wires")
        return dense_all_reduce(grads_w, self.group, mean=self.mean), state


def _add_stats(stats: Sequence[RecoveryStats]) -> RecoveryStats:
    """The recovery stats of several groups' consumer launches, added."""
    return RecoveryStats(nnz=sum(s.nnz for s in stats),
                         peeled=sum(s.peeled for s in stats),
                         residual=sum(s.residual for s in stats),
                         rounds=stats[0].rounds)


def _sum_stats(stats: Sequence[RecoveryStats], group) -> RecoveryStats:
    """Recovery stats summed over consumer launches (``stats[w]`` lists
    local worker w's) and then over the workers, so a wire that peels in
    slices reports the counts of one peel over the whole stream."""
    per_worker = [torch.stack([sum(s.nnz for s in sw), sum(s.peeled for s in sw),
                               sum(s.residual for s in sw)]) for sw in stats]
    nnz, peeled, residual = group.sum(per_worker)
    return RecoveryStats(nnz=nnz, peeled=peeled, residual=residual,
                         rounds=stats[0][0].rounds)


@dataclasses.dataclass(frozen=True)
class CompressedAggregator:
    """pack -> per-leaf sparsify/EF -> encode -> sketch SUM + word OR ->
    peel -> unpack, over one fused bucket stream.

    The encode paths take the local workers' streams as ``streams``, one
    zero-argument callable a worker returning its packed ``(n_buckets,
    E)`` f32 stream: the one-shot producer packs and encodes one worker
    at a time, so one stream is held at a time."""

    wire = "compressed"
    collect_telemetry = False    # WirePlannedAggregator sets it

    cfg: CompressionConfig
    group: Any           # LocalWorkers or ProcessGroupWorkers
    mean: bool = True    # False: the sum over the workers, undivided
    # Per-leaf ZeRO-1 slice dims (streams.zero_slice_dim; None: unsliced
    # leaf). Only the reduce-scatter wire reads them (the gather skip).
    zero1_dims: Any = None
    # The per-bucket-group wire plan (None: the uniform plan on this
    # strategy's own wire, the path above unchanged).
    wire_plan: Any = None
    # Global block id of this executor's first bucket: nonzero only on a
    # group's delegate, whose encode and peel then hash as that slice of
    # the whole stream's.
    base_block: int = 0

    # ---- phase I -------------------------------------------------------

    def _pack(self, w: int, grads: Sequence[torch.Tensor],
              state: AggregationState, plan: BucketPlan) -> torch.Tensor:
        """Local worker w's sparsify + EF (residual row w updated in
        place) and pack: its ``(n_buckets, E)`` f32 stream."""
        cfg = self.cfg
        ef_on = cfg.topk_ratio is not None and cfg.error_feedback
        with obs.span("aggregate/sparsify"):
            flats = []
            for g, r in zip(grads, state.residual):
                flat, nr = sparsify_leaf(g.reshape(-1).to(torch.float32),
                                         r[w] if ef_on else r, cfg)
                flats.append(flat)
                if ef_on:
                    r[w].copy_(nr.reshape(r.shape[1:]))
            return plan.pack_flat(flats)

    def _produce(self, streams, comp):
        """One-shot phase I: each local worker's stream packed and
        compressed in turn (one stream held at a time) at
        ``base_block``: ``(CompressedLeaf, maxabs)`` a worker."""
        out = []
        for s in streams:
            x = s().reshape(-1)
            with obs.span("aggregate/encode"):
                out.append(comp.compress_wire(x, block_offset=self.base_block))
            del x       # before the next worker's stream is packed
        return out

    def _stream_plan(self, plan: BucketPlan) -> StreamPlan:
        """The wire-chunk grid (subclasses align it to their wire)."""
        return make_stream_plan(plan, self.cfg, base_block=self.base_block)

    def _reduce_allreduce(self, payload_w):
        """The all-reduce wire for one chunk: the local workers'
        ``(sketch, words)`` -> (sketch SUM, word OR)."""
        with obs.span("aggregate/wire"):
            return (self.group.sum([p[0] for p in payload_w]),
                    self.group.bor([p[1] for p in payload_w]))

    def _encode_streamed(self, streams, comp, splan, reduce_fn,
                         with_maxabs=False):
        """Per-chunk producer launches and wire through the scheduler.

        Every local worker's stream is packed first; then chunk i makes
        one producer launch a local worker, at the chunk's global block
        offset, and hands the workers' payloads (``(sketch, words)``, or
        with ``with_maxabs`` also the per-block max) to ``reduce_fn``.
        Returns the reduced payloads stacked on a leading ``n_chunks``
        dim."""
        views = [splan.chunk_view(s()) for s in streams]

        def enc(i, chunks):
            out = []
            for chunk in chunks:
                with obs.span("aggregate/encode"):
                    leaf, mx = comp.compress_wire(
                        chunk.reshape(-1), block_offset=splan.chunk_start_block(i))
                out.append((leaf.sketch, leaf.index_words, mx) if with_maxabs
                           else (leaf.sketch, leaf.index_words))
            return out

        return stream_schedule(list(zip(*views)), enc, reduce_fn,
                               group=self.group)

    def _trim_fused(self, stacked_sk, stacked_words, plan: BucketPlan,
                    splan: StreamPlan):
        """Stacked per-chunk (sketch, words) -> the stream's fused views,
        padding buckets dropped."""
        cfg = self.cfg
        sk = stacked_sk.reshape((-1, cfg.rows, cfg.lanes))
        words = stacked_words.reshape(-1)
        return (sk[:plan.n_buckets * splan.blocks_per_bucket],
                words[:plan.n_buckets * splan.words_per_bucket])

    def _encode(self, streams, plan, comp):
        """Phase I and the wire: the aggregated ``(sketch, words)``."""
        splan = self._stream_plan(plan)
        if not splan.streamed:
            cs = [c for c, _ in self._produce(streams, comp)]
            return self._reduce_allreduce([(c.sketch, c.index_words)
                                           for c in cs])
        sks, ws = self._encode_streamed(streams, comp, splan,
                                        self._reduce_allreduce)
        return self._trim_fused(sks, ws, plan, splan)

    # ---- phase II ------------------------------------------------------

    def _recover(self, payload, plan: BucketPlan, comp: HomomorphicCompressor):
        """The aggregated payload -> ``(n_buckets, E)`` recovered stream
        and its stats, in one consumer launch."""
        sk, words = payload
        rec, stats = comp.recover(CompressedLeaf(sketch=sk, index_words=words),
                                  plan.padded, with_stats=True,
                                  block_offset=self.base_block)
        return rec.reshape(plan.n_buckets, plan.bucket_elems), stats

    # ---- plan / execute ------------------------------------------------

    def _wire_plan(self, plan: BucketPlan, device) -> WirePlan:
        """The plan this pass executes: the explicit one, else the uniform
        plan on this strategy's own wire."""
        if self.wire_plan is not None:
            if self.wire_plan.n_buckets != plan.n_buckets:
                raise ValueError(
                    f"wire_plan covers {self.wire_plan.n_buckets} "
                    f"buckets, stream has {plan.n_buckets}")
            return self.wire_plan
        return uniform_plan(plan.n_buckets, self.wire)

    def _own_path(self, wplan: WirePlan) -> bool:
        """Whether ``wplan`` is this strategy's own whole-stream path."""
        return wplan.is_trivial and wplan.groups[0].wire == self.wire

    def _group_delegate(self, wgroup, base_block: int):
        """The strategy that runs one wire group: the group wire's
        registry class at the group's global block offset, with the
        group's chunk grid. A delegate never skips the gather
        (``zero1_dims=None``): the ZeRO-1 alignment is defined on the
        whole stream."""
        cfg = self.cfg if wgroup.stream_chunks is None else \
            dataclasses.replace(self.cfg, stream_chunks=wgroup.stream_chunks)
        return AGGREGATORS[wgroup.wire](
            cfg=cfg, group=self.group, mean=self.mean, zero1_dims=None,
            base_block=base_block)

    def _run_group(self, streams, plan: BucketPlan, comp):
        """Encode, wire and recover on this strategy's own wire: the
        ``(n_buckets, E)`` aggregate and its recovery stats."""
        payload = self._encode(streams, plan, comp)
        with obs.span("aggregate/peel"):
            return self._recover(payload, plan, comp)

    def _execute_plan(self, streams, plan: BucketPlan, comp, device):
        """The local workers' streams -> the aggregated ``(n_buckets, E)``
        stream (summed over the workers) and its recovery stats (None
        where no group peeled).

        This strategy's own trivial plan takes the whole-stream path
        (one stream packed at a time, the gather skip intact). Otherwise
        every worker's stream is packed first and each group runs on its
        rows: a dense group is the group's sum of the packed f32 rows
        (the mean lands at unpack with every other group's), a compressed
        group runs through its wire's delegate on the group view at block
        ``start · blocks_per_bucket``."""
        wplan = self._wire_plan(plan, device)
        if self._own_path(wplan):
            return self._run_group(streams, plan, comp)
        packed = [s() for s in streams]
        nbpb = plan.blocks_per_bucket(self.cfg)
        parts, stats = [], []
        for g in wplan.groups:
            rows = [functools.partial(torch.narrow, p, 0, g.start, g.n_buckets)
                    for p in packed]
            if g.wire == "dense":
                parts.append(self.group.sum([r() for r in rows]))
                continue
            delegate = self._group_delegate(g, base_block=g.start * nbpb)
            rec, st = delegate._run_group(
                rows, plan.group_view(g.start, g.n_buckets),
                HomomorphicCompressor(delegate.cfg))
            parts.append(rec)
            stats.append(st)
        del packed, rows        # the streams, before the concatenation
        return torch.cat(parts), (_add_stats(stats) if stats else None)

    def _finish(self, rec, stats, plan: BucketPlan, state: AggregationState):
        """Unpack (and mean) the recovered stream, or each local worker's
        on the gather-skip path (``rec`` a list); with
        ``collect_telemetry`` each bucket's non-zero share of the
        aggregate."""
        W = self.group.workers if self.mean else 1
        telemetry = None
        if self.collect_telemetry:
            # the count times 1/E in f32: the reference's mean, rounded
            # as XLA rounds it
            inv = torch.tensor(1.0 / rec.shape[1], dtype=torch.float32,
                               device=rec.device)
            telemetry = {"bucket_occupancy":
                         (rec != 0).sum(1, dtype=torch.float32) * inv}

        def unpack(r):
            return plan.unpack(r / W if W > 1 else r)

        with obs.span("aggregate/unpack"):
            out = [unpack(r) for r in rec] if isinstance(rec, list) else unpack(rec)
        return out, AggregationState(residual=state.residual, stats=stats,
                                     telemetry=telemetry)

    def __call__(self, grads_w: Sequence[Sequence[torch.Tensor]],
                 state: AggregationState):
        if len(grads_w) != self.group.local_workers:
            raise ValueError(f"{len(grads_w)} gradient sets for "
                             f"{self.group.local_workers} local workers")
        comp = HomomorphicCompressor(self.cfg)
        plan = make_bucket_plan(grads_w[0], self.cfg)
        streams = [functools.partial(self._pack, w, g, state, plan)
                   for w, g in enumerate(grads_w)]
        rec, stats = self._execute_plan(streams, plan, comp,
                                        grads_w[0][0].device)
        return self._finish(rec, stats, plan, state)


@dataclasses.dataclass(frozen=True)
class CompressedReduceScatterAggregator(CompressedAggregator):
    """Compressed aggregation over a reduce-scattered wire (the
    reference's ``CompressedReduceScatterAggregator``).

    Phase I is :class:`CompressedAggregator`'s. Phase II takes one of two
    wires, by ``cfg.rs_wire``:

    - **native** (``"native"``, and ``"auto"``: the port has no
      partial-auto regions that would force the emulation): the sketch
      and the words, zero-padded to ``nb_p = ceil(nb/W)·W`` buckets, are
      sum- and OR-reduce-scattered, so each rank receives only its own
      ``nb_p/W`` buckets, peels them in one consumer launch at the
      block offset ``rank·(nb_p/W)·blocks_per_bucket``, and the
      recovered slices are all-gathered. With ``cfg.overlap`` /
      ``cfg.stream_chunks`` the grid's chunks hold ``k·W`` whole buckets
      (``make_stream_plan(..., scatter=True)``): each chunk is
      reduce-scattered while the next one encodes, each received slice
      is peeled at :meth:`StreamPlan.rank_slice_start_block`, and
      :func:`gather_chunk_slices` restores the stream, unless the grid
      aligns with the ZeRO-1 slices (``zero1_dims``,
      :func:`zero1_gather_skip`): then each local worker keeps its
      recovered values in place in a zero stream (exact inside its owned
      coordinates, zero outside) and the gather is skipped.
    - **emulated** (``"emulate"``): the all-reduce wire (streamed as
      :class:`CompressedAggregator`'s), then each rank peels its own
      slice and the slices are gathered: the all-reduce's bytes, 1/W of
      the peel.

    On :class:`LocalWorkers` worker w plays rank w: W consumer launches
    (W a chunk when streamed), each on its slice. Every path equals
    :class:`CompressedAggregator` bit for bit, apart from the gather-skip
    contract above; the recovery stats are summed over the slices and
    the ranks.
    """

    wire = "compressed_rs"

    def _native_wire(self) -> bool:
        return self.cfg.rs_wire != "emulate"

    def _check_bitmap(self):
        if self.cfg.index != "bitmap":
            raise ValueError(
                "compressed_rs requires index='bitmap' (a Bloom filter "
                "hashes global coordinates and cannot be sliced per-rank)")

    def _rs_geometry(self, plan: BucketPlan):
        """(W, blocks a bucket, words a bucket, n_buckets padded to W)."""
        W = self.group.workers
        nb_p = -(-plan.n_buckets // W) * W
        return W, plan.blocks_per_bucket(self.cfg), plan.words_per_bucket, nb_p

    def _stream_plan(self, plan: BucketPlan) -> StreamPlan:
        """The per-rank-aligned scatter grid on the native wire; the
        all-reduce grid elsewhere (the emulated wire ships the whole
        stream, and one rank has nothing to scatter)."""
        if self._native_wire() and self.group.workers > 1:
            return make_stream_plan(plan, self.cfg, workers=self.group.workers,
                                    scatter=True, base_block=self.base_block)
        return super()._stream_plan(plan)

    def _gather_skip(self, plan: BucketPlan, splan: StreamPlan) -> bool:
        if self.zero1_dims is None:
            return False
        return zero1_gather_skip(splan, plan, tuple(self.zero1_dims))

    def gather_skip_active(self, leaves: Sequence[torch.Tensor]) -> bool:
        """Whether aggregating gradients shaped like ``leaves`` skips the
        recovered-chunk gather (and returns one list of leaves a local
        worker); the train step then sums the squared grad norm over the
        ranks."""
        if not (self._native_wire() and self.group.workers > 1):
            return False
        plan = make_bucket_plan(leaves, self.cfg)
        if self.wire_plan is not None and not self._own_path(self.wire_plan):
            return False
        splan = self._stream_plan(plan)
        return splan.streamed and self._gather_skip(plan, splan)

    def _reduce_scatter(self, payload_w):
        """The native wire for one chunk: each local worker's slice of the
        sketch SUM and of the word OR, stacked ``(local_workers, ...)``."""
        with obs.span("aggregate/wire"):
            return (torch.stack(self.group.sum_scatter([p[0] for p in payload_w])),
                    torch.stack(self.group.bor_scatter([p[1] for p in payload_w])))

    def _encode(self, streams, plan, comp):
        self._check_bitmap()
        if not self._native_wire() or self.group.workers == 1:
            return super()._encode(streams, plan, comp)
        splan = self._stream_plan(plan)
        if splan.streamed:
            return self._encode_streamed(streams, comp, splan,
                                         self._reduce_scatter)
        # one-shot: one reduce-scatter of the whole stream, padded to
        # whole per-rank runs of buckets
        W, nbpb, wpb, nb_p = self._rs_geometry(plan)
        pad_b = nb_p - plan.n_buckets
        payload_w = []
        for c, _ in self._produce(streams, comp):
            sk, words = c.sketch, c.index_words
            if pad_b:    # zero blocks and words peel to exact zeros
                sk = F.pad(sk, (0, 0, 0, 0, 0, pad_b * nbpb))
                words = F.pad(words, (0, pad_b * wpb))
            payload_w.append((sk, words))
        return self._reduce_scatter(payload_w)

    def _recover(self, payload, plan: BucketPlan, comp: HomomorphicCompressor):
        self._check_bitmap()
        group = self.group
        if group.workers == 1:
            return super()._recover(payload, plan, comp)
        W, nbpb, wpb, nb_p = self._rs_geometry(plan)
        chunk_b = nb_p // W                      # buckets a rank
        chunk_elems = chunk_b * plan.bucket_elems
        sk, words = payload
        if self._native_wire():
            splan = self._stream_plan(plan)
            if splan.streamed:
                return self._recover_streamed(sk, words, plan, splan, comp)
            # (sk, words): each local worker's reduced slice, stacked
            slices = [(sk[w], words[w]) for w in range(group.local_workers)]
        else:
            pad_b = nb_p - plan.n_buckets
            if pad_b:
                sk = F.pad(sk, (0, 0, 0, 0, 0, pad_b * nbpb))
                words = F.pad(words, (0, pad_b * wpb))
            slices = []
            for w in range(group.local_workers):
                r = group.first_worker + w
                slices.append((sk[r * chunk_b * nbpb:(r + 1) * chunk_b * nbpb],
                               words[r * chunk_b * wpb:(r + 1) * chunk_b * wpb]))
        recs, stats = [], []
        for w, (sk_w, words_w) in enumerate(slices):
            r = group.first_worker + w
            rec, st = comp.recover(
                CompressedLeaf(sketch=sk_w, index_words=words_w), chunk_elems,
                with_stats=True,
                block_offset=self.base_block + r * chunk_b * nbpb)
            recs.append(rec)
            stats.append([st])
        full = group.gather(recs)[:plan.padded]
        return (full.reshape(plan.n_buckets, plan.bucket_elems),
                _sum_stats(stats, group))

    def _recover_streamed(self, sk, words, plan: BucketPlan, splan: StreamPlan,
                          comp: HomomorphicCompressor):
        """Streamed native wire: ``sk`` / ``words`` are each local
        worker's reduced slice of every chunk, ``(n_chunks,
        local_workers, ...)``; peel each at its global block offset, then
        gather the slices (or, on the gather-skip path, place each local
        worker's in a zero stream)."""
        group = self.group
        slice_elems = splan.rank_chunk_buckets * plan.bucket_elems
        recs, stats = [], []
        for w in range(group.local_workers):
            r = group.first_worker + w
            rec_w, st_w = [], []
            for j in range(splan.n_chunks):
                rec, st = comp.recover(
                    CompressedLeaf(sketch=sk[j, w], index_words=words[j, w]),
                    slice_elems, with_stats=True,
                    block_offset=splan.rank_slice_start_block(j, r))
                rec_w.append(rec)
                st_w.append(st)
            recs.append(torch.stack(rec_w))      # (n_chunks, slice_elems)
            stats.append(st_w)
        stats = _sum_stats(stats, group)
        if self._gather_skip(plan, splan):
            out = []
            for w, rec in enumerate(recs):
                r = group.first_worker + w
                full = torch.zeros((splan.n_chunks, splan.chunk_elems),
                                   dtype=rec.dtype, device=rec.device)
                full[:, r * slice_elems:(r + 1) * slice_elems] = rec
                out.append(full.reshape(-1)[:plan.padded]
                           .reshape(plan.n_buckets, plan.bucket_elems))
            return out, stats
        full = gather_chunk_slices(recs, group)
        stream = full.reshape(-1)[:plan.padded]
        return stream.reshape(plan.n_buckets, plan.bucket_elems), stats


@dataclasses.dataclass(frozen=True)
class CompressedInNetworkAggregator(CompressedAggregator):
    """Compressed aggregation through the emulated in-network tier, the
    paper's "aggregate inside the switch" deployment (the reference's
    ``CompressedInNetworkAggregator``).

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

    With ``cfg.overlap`` / ``cfg.stream_chunks`` the chunks span whole
    switch windows (``make_stream_plan(..., window_buckets=
    cfg.switch_slots)``, a ``ValueError`` where a forced count cannot):
    on fxp32 each chunk agrees its exponents from its own blocks' maxima,
    quantizes and goes up the tree while the next chunk encodes; the
    chunks' exponents are concatenated and cut to the real buckets, and
    one dequant consumer launch follows. The fxp32 wire needs
    ``index="bitmap"``: the tree ORs the words bucket by bucket, and a
    Bloom filter has no per-bucket words (the reference fails reshaping
    them); a bitmap geometry with ``block_elems % 32 != 0`` works, since
    buckets hold whole words.
    """

    wire = "compressed_innet"

    def __post_init__(self):
        if self.cfg.wire_dtype == "fxp32" and self.cfg.index != "bitmap":
            raise ValueError(
                f"compressed_innet with wire_dtype='fxp32' needs "
                f"index='bitmap', got index={self.cfg.index!r}: the switch "
                "tree ORs the index words per bucket, and a Bloom filter "
                "hashes the whole stream's coordinates into words that "
                "belong to no bucket")

    def _stream_plan(self, plan: BucketPlan) -> StreamPlan:
        """Chunks span whole ``switch_slots`` bucket windows."""
        return make_stream_plan(plan, self.cfg,
                                window_buckets=self.cfg.switch_slots,
                                base_block=self.base_block)

    def _encode(self, streams, plan, comp):
        cfg, group = self.cfg, self.group
        topo = make_topology(cfg.topology, group)       # validates it
        if cfg.wire_dtype == "f32":
            return super()._encode(streams, plan, comp)
        wire = FixedPointWire(workers=group.workers)
        splan = self._stream_plan(plan)
        nbpb = splan.blocks_per_bucket

        def tree_window(payload_w, n_b):
            """One run of ``n_b`` whole buckets over the fxp32 tree: the
            exponents agreed from the producers' per-block maxima, the
            quantized sketches added and the words ORed, window by
            window. Returns (int32 sum, words, exponents)."""
            with obs.span("aggregate/wire"):
                sks, words, maxabs = zip(*payload_w)
                exp = group.max([wire.exponents_from_maxabs(
                    mx.reshape(n_b, nbpb).amax(dim=1)) for mx in maxabs])
                q = tree_all_reduce(
                    [wire.encode(sk.reshape(n_b, -1), exp) for sk in sks],
                    topo, "add", window_slots=cfg.switch_slots, group=group)[0]
                w = tree_all_reduce(
                    [wd.reshape(n_b, -1) for wd in words],
                    topo, "or", window_slots=cfg.switch_slots, group=group)[0]
                return (q.reshape(sks[0].shape), w.reshape(words[0].shape), exp)

        if not splan.streamed:
            produced = self._produce(streams, comp)
            return tree_window([(c.sketch, c.index_words, mx)
                                for c, mx in produced], plan.n_buckets)
        qs, ws, exps = self._encode_streamed(
            streams, comp, splan,
            lambda p: tree_window(p, splan.chunk_buckets), with_maxabs=True)
        q, w = self._trim_fused(qs, ws, plan, splan)
        return q, w, exps.reshape(-1)[:plan.n_buckets]

    def _recover(self, payload, plan: BucketPlan, comp: HomomorphicCompressor):
        """fxp32 payloads carry ``(q int32, words, exponents)``, dequantized
        inside the one consumer launch; f32 payloads are the base
        class's ``(sketch, words)``."""
        if len(payload) == 2:
            return super()._recover(payload, plan, comp)
        q, words, exp = payload
        wire = FixedPointWire(workers=self.group.workers)
        nbpb = plan.blocks_per_bucket(self.cfg)
        rec, stats = comp.recover(
            CompressedLeaf(sketch=q, index_words=words), plan.padded,
            with_stats=True, block_offset=self.base_block,
            dequant=(exp.repeat_interleave(nbpb), wire.mantissa_bits))
        return rec.reshape(plan.n_buckets, plan.bucket_elems), stats


@dataclasses.dataclass(frozen=True)
class WirePlannedAggregator(CompressedAggregator):
    """``auto``: per-bucket-group wire selection (the reference's
    ``WirePlannedAggregator``). Executes the
    :class:`~repro_torch.core.wireplan.WirePlan` it is handed
    (``wire_plan=...``, from the
    :class:`~repro_torch.core.costmodel.AutoWireController` between
    steps), or without one the controller's analytic plan (the wire
    accounting and the ``auto_*`` priors, no telemetry) for the device
    the gradients lie on. Reports each bucket's occupancy of the
    aggregate in ``AggregationState.telemetry`` for the controller's
    feasibility test."""

    wire = "auto"
    collect_telemetry = True

    def _wire_plan(self, plan: BucketPlan, device) -> WirePlan:
        if self.wire_plan is not None:
            return super()._wire_plan(plan, device)
        from .costmodel import analytic_plan  # late: costmodel imports us
        return analytic_plan(plan, self.cfg, workers=self.group.workers,
                             device=device)


AGGREGATORS = {"dense": DenseAggregator, "compressed": CompressedAggregator,
               "compressed_rs": CompressedReduceScatterAggregator,
               "compressed_innet": CompressedInNetworkAggregator,
               "auto": WirePlannedAggregator}

# The controller's search space and the fixed strategies are one set.
assert set(WIRES) == set(AGGREGATORS) - {"auto"}, (
    f"wireplan.WIRES {WIRES} out of sync with AGGREGATORS "
    f"{sorted(AGGREGATORS)}")


def make_aggregator(name: str, cfg: CompressionConfig, group,
                    mean: bool = True, zero1_dims=None, wire_plan=None):
    """Build the named strategy (see :data:`AGGREGATORS`) over ``group``;
    ``zero1_dims``: per-leaf ZeRO-1 slice dims, for the reduce-scatter
    wire's gather skip; ``wire_plan``: a per-bucket-group wire
    assignment (normally set on ``auto`` by its controller)."""
    if name not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {name!r}; have "
                         f"{sorted(AGGREGATORS)}")
    return AGGREGATORS[name](
        cfg=cfg, group=group, mean=mean,
        zero1_dims=None if zero1_dims is None else tuple(zero1_dims),
        wire_plan=wire_plan)


# ----------------------------------------------------------------------
# Expert-parallel all-to-all exchanges (the permute pattern)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseAllToAllExchange:
    """Plain expert-parallel all-to-all over the shared bucket grid, the
    parity baseline of the compressed exchange (the reference's).

    Called as ``ex(payloads)``: ``payloads[w]`` is local worker w's leaf
    list (an EP rank's payload), each leaf ``(W, ...)`` with lane d for
    EP rank d (rank-major). Returns one leaf list a local worker, the
    leaves without the lane axis: worker r's is ``sum_s payload_s[r]``.
    Every lane packs into one per-destination :class:`BucketPlan` (the
    compressed wire's padding, so the two compare bit for bit) and the
    packed f32 stacks merge by :func:`alltoall_lane_sum`. ``group`` stands
    in for the reference's mesh and ``ep_axes``: its W workers are the EP
    ranks.
    """

    wire = "dense"          # the pattern_wires("alltoall") entry executed
    pattern = "alltoall"

    cfg: CompressionConfig
    group: Any           # LocalWorkers or ProcessGroupWorkers

    @property
    def workers(self) -> int:
        return self.group.workers

    def _plan(self, payloads) -> BucketPlan:
        if len(payloads) != self.group.local_workers:
            raise ValueError(f"{len(payloads)} payloads for "
                             f"{self.group.local_workers} local workers")
        return make_dest_bucket_plans(payloads[0], self.cfg,
                                      n_dests=self.workers)[0]

    def _pack(self, payload, plan: BucketPlan) -> torch.Tensor:
        """A lane leaf list -> its ``(W, n_buckets, E)`` packed f32 stack."""
        return torch.stack([plan.pack_flat([l[d].reshape(-1) for l in payload])
                            for d in range(self.workers)])

    def __call__(self, payloads):
        plan = self._plan(payloads)
        merged = alltoall_lane_sum([self._pack(p, plan) for p in payloads],
                                   self.group, "add")
        return [plan.unpack(m) for m in merged]


@dataclasses.dataclass(frozen=True)
class CompressedAllToAllExchange(DenseAllToAllExchange):
    """Compressed expert-parallel all-to-all (the reference's): each chunk
    of the per-destination grid (:func:`make_alltoall_stream_plan`)
    encodes in ONE producer pass a source
    (:meth:`HomomorphicCompressor.exchange_wire`, every lane at once,
    chunk-major block ids from ``chunk_start_block``), the sketch and word
    lanes merge by :func:`sketch_all_to_all` (sum and OR: what arrives is
    the compressed form of ``sum_s payload_s[r]``), and each receiving
    rank peels its merged lane in ONE consumer pass a chunk at
    ``lane_start_block(chunk, rank)``. ``cfg.overlap`` /
    ``cfg.stream_chunks`` drive the chunks through
    :func:`stream_schedule`, each chunk's merge issued while the next
    encodes. Equal to :class:`DenseAllToAllExchange` bit for bit where
    the peel is exact (ratio 2.5 covers a fully occupied block; dyadic
    payloads make every sum exact)."""

    wire = "compressed"

    def __call__(self, payloads):
        cfg, group = self.cfg, self.group
        if cfg.index != "bitmap":
            raise ValueError(
                "the all-to-all exchange requires index='bitmap' (a "
                "Bloom filter hashes global coordinates and cannot be "
                "sliced per destination lane)")
        comp = HomomorphicCompressor(cfg)
        plan = self._plan(payloads)
        splan = make_alltoall_stream_plan(plan, cfg, lanes=self.workers)
        views = [splan.chunk_view(self._pack(p, plan)) for p in payloads]

        def enc(i, slabs):                  # one (W, cb, E) slab a source
            leaves = [comp.exchange_wire(slab, splan.chunk_start_block(i))[0]
                      for slab in slabs]
            return [(l.sketch, l.index_words) for l in leaves]

        def red(payload_w):
            sks, wds = sketch_all_to_all([p[0] for p in payload_w],
                                         [p[1] for p in payload_w], group)
            return torch.stack(sks), torch.stack(wds)

        # (n_chunks, local_workers, ...): each local worker's merged lane
        sks, wds = stream_schedule(list(zip(*views)), enc, red, group=group)
        out = []
        for w in range(group.local_workers):
            r = group.first_worker + w
            rec = torch.stack([comp.recover(
                CompressedLeaf(sketch=sks[j, w], index_words=wds[j, w]),
                splan.chunk_elems, block_offset=splan.lane_start_block(j, r))
                for j in range(splan.n_chunks)])
            out.append(plan.unpack(rec.reshape(plan.n_buckets,
                                               plan.bucket_elems)))
        return out


class _ExchangeFn(torch.autograd.Function):
    """An exchange as a differentiable function of its payloads (the
    reference's ``_exchange_vjp``). The exchange is linear, ``out_r =
    sum_s payload_s[r]``, but the peel is not differentiable, so the
    backward is the exact linear transpose and runs no exchange: the
    output cotangents of every EP rank gathered back onto the lane axis,
    ``d payload_s[d] = d out_d`` for every source s."""

    @staticmethod
    def forward(ctx, exchange, n_leaves, *flat):
        ctx.exchange, ctx.n_leaves = exchange, n_leaves
        payloads = [list(flat[i:i + n_leaves])
                    for i in range(0, len(flat), n_leaves)]
        return tuple(t for leaves in exchange(payloads) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        group, n = ctx.exchange.group, ctx.n_leaves
        local = group.local_workers
        lanes = [group.gather([grads[w * n + i][None] for w in range(local)])
                 for i in range(n)]
        return (None, None) + tuple(lanes) * local


@dataclasses.dataclass(frozen=True)
class _GradExchange:
    """What :func:`make_exchange` hands the model: the executor behind
    :class:`_ExchangeFn`, its surface passed through."""

    exchange: Any

    @property
    def workers(self) -> int:
        return self.exchange.workers

    @property
    def group(self):
        return self.exchange.group

    @property
    def wire(self) -> str:
        return self.exchange.wire

    def __call__(self, payloads):
        n = len(payloads[0])
        flat = _ExchangeFn.apply(self.exchange, n,
                                 *[t for p in payloads for t in p])
        return [list(flat[i:i + n]) for i in range(0, len(flat), n)]


# The permute-pattern executors, keyed by the wire names the plan layer
# validates for pattern="alltoall"; a registry apart from AGGREGATORS.
EXCHANGES = {"dense": DenseAllToAllExchange,
             "compressed": CompressedAllToAllExchange}

assert set(EXCHANGES) == set(pattern_wires("alltoall")), (
    f"wireplan alltoall wires {pattern_wires('alltoall')} out of sync "
    f"with EXCHANGES {sorted(EXCHANGES)}")


def make_exchange(name: str, cfg: CompressionConfig, group):
    """Build the named all-to-all exchange (see :data:`EXCHANGES`) over
    ``group``'s workers as EP ranks: a differentiable callable from one
    lane leaf list a local worker to one merged leaf list a local worker,
    with ``workers``, ``group`` and ``wire`` exposed."""
    if name not in EXCHANGES:
        raise ValueError(f"unknown exchange {name!r}; have {sorted(EXCHANGES)}")
    return _GradExchange(exchange=EXCHANGES[name](cfg=cfg, group=group))
