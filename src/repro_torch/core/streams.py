"""Wire-chunk scheduling: one overlap engine for every compressed strategy.

The reference's ``repro.core.streams``, in eager PyTorch:

- :class:`StreamPlan` / :func:`make_stream_plan` — the static chunk grid.
  The fused sketch + bitmap payload of a
  :class:`~repro_torch.core.bucketing.BucketPlan` is cut into
  ``n_chunks`` wire chunks of ``chunk_buckets`` whole buckets each,
  zero-padded past the real bucket count (zero buckets encode to zero
  sketch blocks and zero words, reduce to zeros and peel to zeros, so
  chunking is bit-invisible). The grid aligns to whole buckets always;
  to per-rank reduce-scatter boundaries (``scatter=True``: each chunk
  holds ``k * W`` buckets, so a chunk's scatter lands whole buckets on
  their peeling rank); or to ``switch_slots`` windows of the in-network
  tier (``window_buckets``). A forced ``cfg.stream_chunks`` that would
  split a boundary raises ``ValueError`` naming the constraint.
- :func:`stream_schedule` — the pipeline driver. Chunk i's producer is
  enqueued, then its reduce is issued through the group's issuer and the
  loop goes on to chunk i+1's producer: on a group of ranks the reduce
  runs on a communication thread (:class:`CommThread`) while the main
  thread enqueues, and the card runs, the next producer. There is no
  data dependence between the two, and the result is ``reduce(encode(i))``
  chunk by chunk, bit for bit.
- :func:`zero_slice_dim` and :func:`zero1_gather_skip` — the dim ZeRO-1
  slices a leaf on, and the static test for when each rank's recovered
  chunks already hold every value its optimizer slice reads, so the
  reduce-scatter wire may skip the recovered-chunk gather.

- :class:`AllToAllStreamPlan` / :func:`make_alltoall_stream_plan` — the
  all-to-all exchange's chunk grid: every chunk carries the same run of
  buckets of every destination lane, block ids chunk-major.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .bucketing import BucketPlan
from .config import CompressionConfig


# ----------------------------------------------------------------------
# The static chunk grid
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Static partition of a bucket stream into wire chunks.

    ``workers > 1`` marks a reduce-scatter grid: every chunk's
    ``chunk_buckets`` divide by ``workers``, and each per-chunk scatter
    hands rank r the chunk's r-th run of :attr:`rank_chunk_buckets`
    whole buckets.
    """

    n_buckets: int        # real buckets in the BucketPlan
    bucket_elems: int     # E, f32 elements a bucket
    blocks_per_bucket: int
    words_per_bucket: int
    workers: int          # W the chunks scatter across (1: all-reduce wire)
    n_chunks: int
    chunk_buckets: int    # whole buckets a wire chunk
    base_block: int = 0   # global block id of the stream's first bucket

    def __post_init__(self):
        if self.chunk_buckets % max(self.workers, 1):
            raise ValueError(
                f"chunk_buckets={self.chunk_buckets} not divisible by "
                f"workers={self.workers}")
        if self.padded_buckets < self.n_buckets:
            raise ValueError(
                f"chunk grid covers {self.padded_buckets} buckets, "
                f"stream has {self.n_buckets}")

    @property
    def padded_buckets(self) -> int:
        return self.n_chunks * self.chunk_buckets

    @property
    def pad_buckets(self) -> int:
        """Zero buckets appended so the grid tiles the stream exactly."""
        return self.padded_buckets - self.n_buckets

    @property
    def chunk_elems(self) -> int:
        return self.chunk_buckets * self.bucket_elems

    @property
    def rank_chunk_buckets(self) -> int:
        """Whole buckets each rank receives from one chunk's scatter."""
        return self.chunk_buckets // self.workers

    @property
    def streamed(self) -> bool:
        return self.n_chunks > 1

    def chunk_start_block(self, chunk: int) -> int:
        """Global block id of chunk ``chunk``'s first block."""
        return self.base_block + \
            chunk * (self.chunk_buckets * self.blocks_per_bucket)

    def rank_slice_start_block(self, chunk: int, rank: int) -> int:
        """Global block id of the slice rank ``rank`` receives from
        chunk ``chunk``'s scatter."""
        return self.chunk_start_block(chunk) + \
            rank * (self.rank_chunk_buckets * self.blocks_per_bucket)

    def rank_intervals(self, rank: int) -> Tuple[Tuple[int, int], ...]:
        """Flat-stream element intervals rank ``rank`` owns after the
        per-chunk scatters."""
        cbw = self.rank_chunk_buckets * self.bucket_elems
        out = []
        for j in range(self.n_chunks):
            lo = j * self.chunk_elems + rank * cbw
            out.append((lo, lo + cbw))
        return tuple(out)

    def chunk_view(self, buckets: torch.Tensor) -> torch.Tensor:
        """``(n_buckets, E) -> (n_chunks, chunk_buckets, E)``, zero-padding
        the tail chunk (a view where there is no padding)."""
        if tuple(buckets.shape) != (self.n_buckets, self.bucket_elems):
            raise ValueError(
                f"buckets shape {tuple(buckets.shape)} != "
                f"({self.n_buckets}, {self.bucket_elems})")
        if self.pad_buckets:
            buckets = F.pad(buckets, (0, 0, 0, self.pad_buckets))
        return buckets.reshape(
            self.n_chunks, self.chunk_buckets, self.bucket_elems)


def make_stream_plan(plan: BucketPlan, cfg: CompressionConfig, *,
                     workers: int = 1, scatter: bool = False,
                     window_buckets: Optional[int] = None,
                     base_block: int = 0) -> StreamPlan:
    """Resolve the chunk grid for one aggregation pass (the reference's
    rules, and its errors).

    ``scatter=True`` builds a reduce-scatter grid over ``workers`` ranks:
    the chunk count must divide the per-rank bucket count
    ``ceil(n_buckets / workers)``. ``window_buckets`` aligns chunks to
    in-network switch windows instead. With neither, any count in
    ``[1, n_buckets]`` is valid (non-divisible counts zero-pad).

    The count is ``cfg.stream_chunks`` where set; otherwise
    ``cfg.overlap`` picks the finest aligned grid (a bucket, a per-rank
    run, a switch window a chunk) and no overlap one fused chunk. A grid
    whose tail chunks would be all padding shrinks to the largest count
    that still covers the stream.
    """
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    nb = plan.n_buckets
    nbpb = plan.blocks_per_bucket(cfg)
    wpb = plan.words_per_bucket
    streaming = cfg.overlap or cfg.stream_chunks is not None

    def drop_empty(n_chunks: int, cb: int) -> int:
        """Largest chunk count (<= n_chunks) with no all-padding chunk."""
        return min(n_chunks, max(1, -(-nb // cb)))

    def grid(n_chunks: int, cb: int, w: int) -> StreamPlan:
        return StreamPlan(
            n_buckets=nb, bucket_elems=plan.bucket_elems,
            blocks_per_bucket=nbpb, words_per_bucket=wpb, workers=w,
            n_chunks=drop_empty(n_chunks, cb), chunk_buckets=cb,
            base_block=base_block)

    if scatter and workers > 1:
        per_rank = -(-nb // workers)           # ceil(n_buckets / W)
        req = cfg.stream_chunks if cfg.stream_chunks is not None \
            else (per_rank if streaming else 1)
        if req < 1 or per_rank % req:
            raise ValueError(
                f"stream_chunks={req} splits a per-rank reduce-scatter "
                f"boundary: the native RS wire scatters whole buckets to "
                f"their peeling rank, so the chunk count must divide the "
                f"per-rank bucket count ceil(n_buckets/W) = "
                f"ceil({nb}/{workers}) = {per_rank} "
                f"(valid counts: divisors of {per_rank})")
        return grid(req, (per_rank // req) * workers, workers)

    if window_buckets is not None:
        if window_buckets < 1:
            raise ValueError(
                f"window_buckets must be >= 1, got {window_buckets}")
        windows = -(-nb // window_buckets)
        if cfg.stream_chunks is not None:
            n_chunks = cfg.stream_chunks
            if n_chunks < 1 or n_chunks > windows:
                raise ValueError(
                    f"stream_chunks={n_chunks} misaligns the switch "
                    f"windows: in-network chunks span whole switch_slots="
                    f"{window_buckets} bucket windows and the stream has "
                    f"ceil(n_buckets/switch_slots) = ceil({nb}/"
                    f"{window_buckets}) = {windows} window(s); use "
                    f"stream_chunks <= {windows}")
        else:
            n_chunks = windows if streaming else 1
        # one fused chunk covers the raw stream; streamed chunks span
        # whole switch windows (zero-padded past the real bucket count)
        cb = nb if n_chunks == 1 else \
            -(-windows // n_chunks) * window_buckets
        return grid(n_chunks, cb, 1)

    req = cfg.stream_chunks if cfg.stream_chunks is not None \
        else (nb if streaming else 1)
    if req < 1:
        raise ValueError(f"stream_chunks must be >= 1, got {req}")
    n_chunks = min(req, nb)
    return grid(n_chunks, -(-nb // n_chunks), 1)


# ----------------------------------------------------------------------
# The all-to-all chunk grid
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AllToAllStreamPlan:
    """Static chunk grid of the all-to-all exchange (the reference's).

    The payload is ``lanes`` per-destination runs of ``n_buckets``
    buckets each, on one shared :class:`BucketPlan`. A chunk carries
    ``chunk_buckets`` buckets of every lane, and its producer encodes the
    stacked ``(lanes, chunk_buckets, E)`` slab in one pass. Block ids are
    chunk-major: bucket ``j`` of lane ``d`` in chunk ``c`` encodes at
    global bucket ``(c * lanes + d) * chunk_buckets + j``, so each
    chunk's producer covers one contiguous block range and every lane a
    fixed offset inside it; one chunk is plain lane-major offsets
    ``d * n_buckets``.
    """

    lanes: int            # W destination ranks
    n_buckets: int        # buckets a destination
    bucket_elems: int
    blocks_per_bucket: int
    words_per_bucket: int
    n_chunks: int
    chunk_buckets: int
    base_block: int = 0

    def __post_init__(self):
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {self.lanes}")
        if self.n_chunks * self.chunk_buckets != self.n_buckets:
            raise ValueError(
                f"chunk grid {self.n_chunks} x {self.chunk_buckets} does "
                f"not tile the per-destination bucket run "
                f"({self.n_buckets} buckets)")

    @property
    def chunk_elems(self) -> int:
        return self.chunk_buckets * self.bucket_elems

    @property
    def streamed(self) -> bool:
        return self.n_chunks > 1

    def chunk_start_block(self, chunk: int) -> int:
        """Global block id of chunk ``chunk``'s first block (lane 0): the
        producer's ``block_offset`` for the stacked slab."""
        return self.base_block + chunk * (
            self.lanes * self.chunk_buckets * self.blocks_per_bucket)

    def lane_start_block(self, chunk: int, lane: int) -> int:
        """Global block id of lane ``lane``'s first block inside chunk
        ``chunk``: the consumer's offset at the receiving rank."""
        return self.chunk_start_block(chunk) + \
            lane * (self.chunk_buckets * self.blocks_per_bucket)

    def chunk_view(self, lane_buckets: torch.Tensor) -> torch.Tensor:
        """``(lanes, n_buckets, E) -> (n_chunks, lanes, chunk_buckets,
        E)``: the per-chunk stacked slabs."""
        if tuple(lane_buckets.shape) != (self.lanes, self.n_buckets,
                                         self.bucket_elems):
            raise ValueError(
                f"lane buckets shape {tuple(lane_buckets.shape)} != "
                f"({self.lanes}, {self.n_buckets}, {self.bucket_elems})")
        return lane_buckets.reshape(
            self.lanes, self.n_chunks, self.chunk_buckets,
            self.bucket_elems).transpose(0, 1)


def make_alltoall_stream_plan(plan: BucketPlan, cfg: CompressionConfig, *,
                              lanes: int,
                              base_block: int = 0) -> AllToAllStreamPlan:
    """Resolve the chunk grid of one all-to-all exchange (the
    reference's rules and errors). ``plan`` is the per-destination plan
    every lane shares. The count is ``cfg.stream_chunks`` where set, else
    ``cfg.overlap`` picks a bucket a chunk and no overlap one fused
    chunk; it must divide the per-destination bucket run, since the
    lanes interleave chunk-major and a ragged tail chunk would shift
    every later lane's block ids."""
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    nb = plan.n_buckets
    streaming = cfg.overlap or cfg.stream_chunks is not None
    req = cfg.stream_chunks if cfg.stream_chunks is not None \
        else (nb if streaming else 1)
    if req < 1:
        raise ValueError(f"stream_chunks must be >= 1, got {req}")
    req = min(req, nb)
    if nb % req:
        raise ValueError(
            f"stream_chunks={req} misaligns the all-to-all lane grid: "
            f"the permute wire interleaves all {lanes} destination lanes "
            f"chunk-major, so the chunk count must divide the "
            f"per-destination bucket count n_buckets = {nb} "
            f"(valid counts: divisors of {nb})")
    return AllToAllStreamPlan(
        lanes=lanes, n_buckets=nb, bucket_elems=plan.bucket_elems,
        blocks_per_bucket=plan.blocks_per_bucket(cfg),
        words_per_bucket=plan.words_per_bucket,
        n_chunks=req, chunk_buckets=nb // req, base_block=base_block)


# ----------------------------------------------------------------------
# Issuing a chunk's reduce
# ----------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a payload (tensors in nested lists and tuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


class InlineIssue:
    """Runs each reduce where it is issued, on the calling thread (a
    group whose reduce is local: :class:`LocalWorkers`)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn: Callable, payload) -> concurrent.futures.Future:
        fut = concurrent.futures.Future()
        fut.set_result(fn(payload))
        return fut


class CommThread:
    """Runs the reduces of one stream on one communication thread, in the
    order they are issued, so every rank issues its collectives in the
    same order and the main thread never waits on one.

    For a payload on the card, the issuing thread records a CUDA event on
    its current stream right after the chunk's producer was enqueued;
    the communication thread makes a side stream wait on that event
    before it touches the payload, runs the reduce with the side stream
    current (gloo's host staging copies and NCCL's collectives order
    against it), and synchronises the side stream before it hands the
    result back. The payload stays referenced until then; the result's
    tensors are marked as used on the issuing stream
    (``record_stream``), so the allocator does not hand their memory to
    the side stream while the main stream still reads it.
    """

    def __init__(self):
        self._pool = None
        self._side = {}

    def __enter__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="comm")
        return self

    def __exit__(self, exc_type, *exc):
        # on an error, queued reduces are dropped: their collectives
        # would wait on peers the caller is abandoning
        self._pool.shutdown(wait=True, cancel_futures=exc_type is not None)
        self._pool = None
        return False

    def __call__(self, fn: Callable, payload) -> concurrent.futures.Future:
        dev = next((t.device for t in _tensors(payload)
                    if t.device.type == "cuda"), None)
        if dev is None:
            return self._pool.submit(fn, payload)
        main = torch.cuda.current_stream(dev)
        ready = torch.cuda.Event()
        ready.record(main)
        if dev not in self._side:
            self._side[dev] = torch.cuda.Stream(dev)
        return self._pool.submit(self._run, fn, payload, dev, main, ready,
                                 self._side[dev])

    @staticmethod
    def _run(fn, payload, dev, main, ready, side):
        with torch.cuda.device(dev), torch.cuda.stream(side):
            side.wait_event(ready)
            out = fn(payload)
        side.synchronize()
        for t in _tensors(out):
            if t.device.type == "cuda":
                t.record_stream(main)
        return out


# ----------------------------------------------------------------------
# The pipeline driver
# ----------------------------------------------------------------------

def stream_schedule(xs: Sequence[Any], encode: Callable, reduce: Callable,
                    group=None):
    """Drive per-chunk (encode -> reduce) through the group's issuer.

    ``xs[i]`` is chunk i's input (a tensor with a leading ``n_chunks``
    dim, or a list); ``encode(i, xs[i])`` enqueues chunk i's producer and
    returns its payload; ``reduce(payload)`` runs the chunk's collectives
    and returns a tuple of tensors of the same shapes for every chunk.
    Chunk i's reduce is issued as soon as its producer is enqueued, and
    runs (on a group of ranks, on the communication thread) while chunk
    i+1's producer is enqueued and runs. ``group`` supplies the issuer
    (``group.issuer()``); none runs every reduce inline.

    Returns each position of the reduced payloads stacked on a leading
    ``n_chunks`` dim; bit for bit ``reduce(encode(i, xs[i]))`` chunk by
    chunk.
    """
    n = len(xs)
    if n == 0:
        raise ValueError("stream_schedule needs at least one chunk")
    issue = group.issuer() if group is not None else InlineIssue()
    with issue:
        futures = [issue(reduce, encode(i, xs[i])) for i in range(n)]
        outs = [f.result() for f in futures]
    return tuple(torch.stack(parts) for parts in zip(*outs))


# ----------------------------------------------------------------------
# ZeRO-1 alignment (the gather-skip path)
# ----------------------------------------------------------------------

def zero_slice_dim(shape: Sequence[int], spec, dp: int) -> Optional[int]:
    """The dim ZeRO-1 slices a leaf on: the largest dim not taken by
    ``spec`` (the port has no tensor parallelism: pass ``()``) whose size
    divides by ``dp``, the larger index on a tie. The one definition the
    train step and the gather-skip test share."""
    cands = []
    for i, size in enumerate(shape):
        taken = spec[i] if i < len(spec) else None
        if taken is None and size % dp == 0 and size >= dp:
            cands.append((size, i))
    if not cands:
        return None
    return max(cands)[1]


def zero1_gather_skip(splan: StreamPlan, plan: BucketPlan,
                      zero1_dims: Optional[Sequence[Optional[int]]]) -> bool:
    """True when the chunk grid aligns with the ZeRO-1 optimizer slices:
    for every leaf, the per-rank slice is flat-contiguous (dim ``d`` with
    only size-1 dims before it) and rank r's slice lies inside one of
    rank r's recovered chunk slices (:meth:`StreamPlan.rank_intervals`).
    Then each rank already holds every gradient value its optimizer
    slice reads, and the recovered-chunk gather can be skipped."""
    W = splan.workers
    if W == 1 or zero1_dims is None:
        return False
    dims = tuple(zero1_dims)
    if len(dims) != len(plan.sizes):
        return False
    E = splan.bucket_elems
    cb, cbw = splan.chunk_buckets, splan.rank_chunk_buckets
    for off, n, d, shape in zip(plan.offsets, plan.sizes, dims, plan.shapes):
        if d is None or n == 0:
            return False
        if any(s != 1 for s in shape[:d]):
            return False                 # the slice on d is not flat-contiguous
        if shape[d] % W or n % W:
            return False
        per = n // W
        for r in range(W):
            start = off + r * per
            j = start // (cb * E)
            lo = (j * cb + r * cbw) * E
            if not (lo <= start and start + per <= lo + cbw * E):
                return False
    return True
