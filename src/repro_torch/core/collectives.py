"""Data-parallel aggregation over W workers: emulated on one device, or
as the ranks of a ``torch.distributed`` process group.

The reference runs its data-parallel workers as devices of a mesh and
aggregates with ``psum`` (sketches, dense gradients), an OR all-reduce
built from ``ppermute`` (bitmap words) and a ``pmax`` (fxp32
exponents). The port has two groups with one surface: ``workers`` (W),
``levels``, ``local_workers`` (the workers this process runs),
``first_worker`` (the global index of its first), ``sum``, ``bor`` and
``max``, each taking the payloads of the local workers and returning
the aggregate over all W; the reduce-scatters ``sum_scatter`` and
``bor_scatter``, each returning one slice a local worker (worker w's
the w-th of W equal slices of the aggregate, rank-major, the
reference's ``psum_scatter`` tiling); ``gather``, the all-gather of one
equal slice a worker; and ``issuer``, which says how a streamed
aggregation issues a chunk's collectives (:mod:`repro_torch.core.streams`):

- :class:`LocalWorkers` emulates all W workers in one process on one
  device, folding over the worker axis;
- :class:`ProcessGroupWorkers` is one rank of W processes: ``sum`` and
  ``max`` are ``all_reduce``, ``bor`` is the reference's hierarchical
  OR all-reduce on point-to-point sends, since no collective library
  reduces with a bitwise OR, the two reduce-scatters are the
  reference's ring reduce-scatter on the same sends (with ``+`` or
  ``|``), on every backend, and ``gather`` is ``all_gather`` of the
  slices' bytes.

The OR all-reduce primitives are the reference's
(``src/repro/core/collectives.py``) on ``torch.distributed`` P2P:

- :func:`or_allreduce_ring`: reduce-scatter then all-gather around a
  ring with an OR combiner, 2·(W−1)/W · |B| a link;
- :func:`or_allreduce_doubling`: recursive doubling, log2 W full-size
  exchanges, powers of two only;
- :func:`or_allreduce`: over several levels, innermost first, each by
  the ring for payloads of ``ring_threshold`` bytes or more and for
  sizes that are not a power of two, else by doubling;
- :func:`or_reduce_scatter_ring` / :func:`or_reduce_scatter`: the
  ring's first phase alone, shifted so rank i ends on its own chunk i,
  over the levels outermost first (the rank-major assignment);
  :func:`reduce_scatter` is the same with any in-place combiner;
- :func:`gather_chunk_slices`: the inverse of a per-chunk scatter;
- :func:`alltoall_lane_sum` / :func:`sketch_all_to_all`: the all-to-all
  lane merge of the expert-parallel exchange, rank r receiving the sum
  (or OR) over the sources of their lane r: on one level the
  reference's native leg, W − 1 P2P rounds; on several its emulated
  leg, the whole stack reduced and this rank's lane sliced.

Every exchange posts its send and its receive together
(``dist.batch_isend_irecv``), so no ring step waits on a blocking send.
While :mod:`repro_torch.obs` traces, each call of a group's collective
counts once under ``collective/calls/<op>`` and its first payload (one
worker's) under ``collective/bytes/<op>``.
The words are int32 tensors carrying uint32 bits; every path moves and
ORs them as bits, bit 31 included.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import obs
from .streams import CommThread, InlineIssue


def _note(op: str, parts: Sequence[torch.Tensor]):
    """One call of the collective ``op`` and one worker's payload bytes,
    on the tracer's counters while it is on."""
    if obs.enabled():
        x = parts[0]
        obs.count(f"collective/calls/{op}")
        obs.count(f"collective/bytes/{op}", x.numel() * x.element_size())


def linear_rank(indices: Sequence[int], levels: Sequence[int]) -> int:
    """A worker's linear index from its index on each level (both
    innermost first): ``w = i0 + s0 * (i1 + s1 * ...)``. This is the
    reference's rank-major ``linear_rank`` over its mesh axes listed
    outermost first, the order of :class:`LocalWorkers`."""
    if len(indices) != len(levels):
        raise ValueError(f"{len(indices)} indices for {len(levels)} levels")
    w = 0
    for i, s in zip(reversed(indices), reversed(levels)):
        if not 0 <= i < s:
            raise ValueError(f"index {i} out of a level of size {s}")
        w = w * s + i
    return w


def level_indices(w: int, levels: Sequence[int]) -> Tuple[int, ...]:
    """The inverse of :func:`linear_rank`: worker ``w``'s index on each
    level, innermost first."""
    out = []
    for s in levels:
        out.append(w % s)
        w //= s
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class LocalWorkers:
    """W data-parallel workers emulated on one device.

    ``levels`` stands in for the reference mesh's data-parallel axes: the
    size of each level, innermost (the workers under one top-of-rack
    switch) first, multiplying to ``workers``; by default one level of
    all W. Worker w's index on the levels is rank-major, as the
    reference's ``linear_rank``: ``w = i0 + s0 * (i1 + s1 * ...)``.
    """

    workers: int
    levels: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if not self.levels:
            object.__setattr__(self, "levels", (self.workers,))
        levels = tuple(int(s) for s in self.levels)
        if min(levels) < 1 or math.prod(levels) != self.workers:
            raise ValueError(f"levels {levels} do not multiply to "
                             f"{self.workers} workers")
        object.__setattr__(self, "levels", levels)

    @property
    def local_workers(self) -> int:
        return self.workers

    @property
    def first_worker(self) -> int:
        return 0

    def _check(self, parts: Sequence[torch.Tensor]):
        if len(parts) != self.workers:
            raise ValueError(f"{len(parts)} payloads for {self.workers} workers")

    def _fold(self, op: str, fn, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        self._check(parts)
        _note(op, parts)
        return functools.reduce(fn, parts)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over workers, folded in worker order ((w0 + w1) + w2) ..."""
        return self._fold("sum", torch.add, parts)

    def bor(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Bitwise OR over workers (int32 words carrying uint32 bits)."""
        return self._fold("bor", torch.bitwise_or, parts)

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise max over workers (the reference's ``pmax``)."""
        return self._fold("max", torch.maximum, parts)

    def _scatter(self, total: torch.Tensor) -> List[torch.Tensor]:
        if total.shape[0] % self.workers:
            raise ValueError(f"leading dim {total.shape[0]} not divisible "
                             f"by {self.workers} workers")
        return list(total.chunk(self.workers))

    def sum_scatter(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Reduce-scatter of the sum: worker w's slice is the w-th of W
        equal leading-dim slices of :meth:`sum`."""
        return self._scatter(self._fold("sum_scatter", torch.add, parts))

    def bor_scatter(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Reduce-scatter of the bitwise OR, sliced as :meth:`sum_scatter`."""
        return self._scatter(self._fold("bor_scatter", torch.bitwise_or, parts))

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """All-gather: the workers' equal slices concatenated in worker
        order on the leading dim."""
        self._check(parts)
        _note("gather", parts)
        return torch.cat(list(parts))

    def issuer(self) -> InlineIssue:
        """A streamed aggregation's reduces run inline: they are local."""
        return InlineIssue()

    def lane_sum(self, parts: Sequence[torch.Tensor], combine: str
                 ) -> List[torch.Tensor]:
        """The all-to-all lane merge: ``parts[s]`` is worker s's ``(W,
        ...)`` stack, lane d destined for worker d; worker r receives lane
        r summed (``"add"``) or ORed (``"or"``) over the sources in order
        s = 0..W-1, as :meth:`sum` folds."""
        fn = torch.add if combine == "add" else torch.bitwise_or
        return list(self._fold("lane_sum", fn, parts).unbind(0))


class DPLevel(NamedTuple):
    """One data-parallel level as a rank sees it: the process subgroup of
    the ranks that differ from it only in this level's index (``None``
    for a level of one), their global ranks in index order, and its own
    index among them (the reference's mesh axis and ``axis_index``)."""

    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def exchange(level: DPLevel, sends=(), recvs=()):
    """Post every ``(tensor, peer index)`` send and receive on the level
    at once and wait for all of them."""
    ops = [dist.P2POp(dist.isend, t, level.ranks[j], level.group)
           for t, j in sends]
    ops += [dist.P2POp(dist.irecv, t, level.ranks[j], level.group)
            for t, j in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def or_allreduce_ring(x: torch.Tensor, level: DPLevel) -> torch.Tensor:
    """Bitwise-OR all-reduce of integer words around the level's ring, on
    the reference's schedule: ``x`` (same shape on every rank) is padded
    to ``n`` chunks of its leading dim; after the reduce-scatter's n-1
    steps rank i holds the fully ORed chunk (i+1) mod n, and the
    all-gather's n-1 steps pass the reduced chunks around the same
    ring. A new tensor; ``x`` is not written."""
    n, idx = level.size, level.index
    if n == 1:
        return x
    size = x.shape[0]
    c = -(-size // n)
    chunks = torch.zeros((n, c) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device)
    chunks.view((n * c,) + tuple(x.shape[1:]))[:size] = x
    nxt, prv = (idx + 1) % n, (idx - 1) % n
    recv = torch.empty_like(chunks[0])
    for t in range(n - 1):
        exchange(level, sends=[(chunks[(idx - t) % n], nxt)],
                  recvs=[(recv, prv)])
        chunks[(idx - t - 1) % n] |= recv
    for t in range(n - 1):
        exchange(level, sends=[(chunks[(idx + 1 - t) % n], nxt)],
                  recvs=[(chunks[(idx - t) % n], prv)])
    return chunks.view((n * c,) + tuple(x.shape[1:]))[:size]


def or_allreduce_doubling(x: torch.Tensor, level: DPLevel) -> torch.Tensor:
    """Bitwise-OR all-reduce by recursive doubling: at distance d = 1, 2,
    4, ... each rank swaps its whole payload with rank ``index ^ d``.
    Needs a power-of-two level size. A new tensor unless n == 1."""
    n = level.size
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError(f"recursive doubling needs power-of-2 size, got {n}")
    recv = torch.empty_like(x)
    d = 1
    while d < n:
        peer = level.index ^ d
        exchange(level, sends=[(x.contiguous(), peer)], recvs=[(recv, peer)])
        x = x | recv
        d *= 2
    return x


def _use_ring(payload_bytes: int, axis_size: int, ring_threshold: int) -> bool:
    """Ring vs recursive doubling: ring for payloads of ``ring_threshold``
    bytes or more (bandwidth-bound regime), and always for axis sizes
    that are not a power of two (doubling requires 2^k participants)."""
    return payload_bytes >= ring_threshold or bool(axis_size & (axis_size - 1))


def or_allreduce(x: torch.Tensor, levels: Sequence[DPLevel],
                 ring_threshold: int = 65536) -> torch.Tensor:
    """Hierarchical bitwise-OR all-reduce over data-parallel levels,
    innermost first (the reference's ``or_allreduce``): after level l
    each rank holds the OR over the ranks that differ from it in levels
    0..l only. ``ring_threshold`` is the payload size in bytes from which
    a level takes the ring; smaller payloads on power-of-two levels take
    recursive doubling."""
    payload_bytes = x.numel() * x.element_size()
    for level in levels:
        if _use_ring(payload_bytes, level.size, ring_threshold):
            x = or_allreduce_ring(x, level)
        else:
            x = or_allreduce_doubling(x, level)
    return x


def reduce_scatter_ring(x: torch.Tensor, level: DPLevel,
                        combine_: Callable) -> torch.Tensor:
    """Reduce-scatter around the level's ring, the reference's
    ``or_reduce_scatter_ring`` schedule with the in-place combiner
    ``combine_`` (``torch.Tensor.bitwise_or_``, ``torch.Tensor.add_``):
    the leading dim of ``x`` (same shape on every rank, divisible by the
    level's size n) is cut into n chunks, and after n-1 steps rank i
    holds chunk i combined over the level. ``x`` is not written."""
    n, idx = level.size, level.index
    if x.shape[0] % n:
        raise ValueError(f"reduce-scatter: leading dim {x.shape[0]} not "
                         f"divisible by the level's size {n}")
    if n == 1:
        return x
    chunks = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])).clone()
    nxt, prv = (idx + 1) % n, (idx - 1) % n
    recv = torch.empty_like(chunks[0])
    for t in range(n - 1):
        exchange(level, sends=[(chunks[(idx - t - 1) % n], nxt)],
                 recvs=[(recv, prv)])
        combine_(chunks[(idx - t - 2) % n], recv)
    return chunks[idx]


def or_reduce_scatter_ring(x: torch.Tensor, level: DPLevel) -> torch.Tensor:
    """Bitwise-OR reduce-scatter of integer words around the level's
    ring: rank i receives its own fully ORed chunk i, (n-1)/n · |B| a
    link and no all-gather phase."""
    return reduce_scatter_ring(x, level, torch.Tensor.bitwise_or_)


def reduce_scatter(x: torch.Tensor, levels: Sequence[DPLevel],
                   combine_: Callable) -> torch.Tensor:
    """Hierarchical ring reduce-scatter over data-parallel levels: the
    leading dim of ``x`` must divide by W, and rank w receives the w-th
    of W equal chunks combined over all ranks. The levels are scattered
    outermost first (the outer level picks the coarse chunk, each inner
    one a sub-chunk of it), so the assignment is rank-major, as the
    reference's ``psum_scatter`` over its mesh axes."""
    W = math.prod(level.size for level in levels)
    if x.shape[0] % W:
        raise ValueError(f"reduce-scatter: leading dim {x.shape[0]} not "
                         f"divisible by the total size {W}")
    for level in reversed(levels):
        x = reduce_scatter_ring(x, level, combine_)
    return x


def or_reduce_scatter(x: torch.Tensor, levels: Sequence[DPLevel]) -> torch.Tensor:
    """Hierarchical bitwise-OR reduce-scatter (the reference's
    ``or_reduce_scatter``): see :func:`reduce_scatter`."""
    return reduce_scatter(x, levels, torch.Tensor.bitwise_or_)


def gather_chunk_slices(parts: Sequence[torch.Tensor], group) -> torch.Tensor:
    """Reassemble per-chunk reduce-scatter slices across the workers:
    ``parts[w]`` is local worker w's ``(n_chunks, S, ...)`` slices, one a
    wire chunk. Returns ``(n_chunks, W * S, ...)``: every chunk restored
    as the one-shot wire delivers it (the workers' slices rank-major),
    with one all-gather for all chunks. The reference's zero-pad + psum
    form serves its partial-auto regions; the port has none, so it
    gathers."""
    if group.workers == 1:
        return parts[0]
    n_chunks, s = parts[0].shape[0], parts[0].shape[1]
    rest = tuple(parts[0].shape[2:])
    full = group.gather(list(parts)).reshape((group.workers, n_chunks, s) + rest)
    return full.transpose(0, 1).reshape((n_chunks, group.workers * s) + rest)


class ProcessGroupWorkers:
    """This process as one of W data-parallel ranks, one worker a rank:
    by default the ranks of the default ``torch.distributed`` process
    group; with ``partition`` the ranks of this process's part.

    ``partition``: the world's ranks cut into equal parts, each a
    sequence of global ranks in worker order (the grid's data-parallel
    groups, one a model index; or its model-axis groups, one a data
    index: :func:`repro_torch.launch.mesh.make_host_mesh`). W is the
    size of a part, and this process's group is the part that holds its
    rank. Every rank must pass the same partition: every part's process
    group, and every part's level subgroups, are created by every rank
    in the same order, as ``dist.new_group`` requires.

    ``levels`` are the data-parallel level sizes, innermost first,
    multiplying to W (default: one level of all W); worker w's index on
    them is rank-major, as in :class:`LocalWorkers`. Each level becomes
    a subgroup (``dist.new_group``) of the ranks that differ only in that
    level's index.

    ``staging``: gloo moves host memory (its point-to-point ops take
    host tensors only), so on a gloo group every collective copies a CUDA
    payload to pinned host memory, reduces it there and copies the
    result back (``"host"``); on NCCL, one card a rank, payloads stay on
    the device (``"device"``). Chosen from the backend, never by trying.
    """

    local_workers = 1

    def __init__(self, levels: Sequence[int] = (), partition=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupWorkers needs an initialized "
                               "default process group")
        world, me = dist.get_world_size(), dist.get_rank()
        parts = ([tuple(range(world))] if partition is None
                 else [tuple(int(r) for r in p) for p in partition])
        if sorted(r for p in parts for r in p) != list(range(world)) or \
                len({len(p) for p in parts}) != 1:
            raise ValueError(f"partition {parts} does not cut the {world} "
                             "ranks into equal parts")
        self.workers = len(parts[0])
        levels = tuple(int(s) for s in levels) or (self.workers,)
        if min(levels) < 1 or math.prod(levels) != self.workers:
            raise ValueError(f"levels {levels} do not multiply to "
                             f"{self.workers} workers")
        self.levels = levels
        self.backend = dist.get_backend()
        self.staging = "host" if self.backend == "gloo" else "device"
        for part in parts:
            pg = None if len(part) == world else dist.new_group(list(part))
            dp_levels = self._level_groups(part, levels)
            if me in part:
                self.ranks, self.pg, self.dp_levels = part, pg, dp_levels
                self.rank = part.index(me)

    @staticmethod
    def _level_groups(part, levels) -> List[DPLevel]:
        """Each level's subgroup of ``part`` as its member ranks see it
        (None for the others); created by every rank."""
        me, W = dist.get_rank(), len(part)
        out: List[DPLevel] = []
        for l, size in enumerate(levels):
            mine = None
            for w in range(W):
                idx = level_indices(w, levels)
                if idx[l]:
                    continue       # each subgroup once, from its index-0 rank
                ranks = tuple(part[linear_rank(idx[:l] + (j,) + idx[l + 1:],
                                               levels)] for j in range(size))
                sub = dist.new_group(list(ranks)) if size > 1 else None
                if me in ranks:
                    mine = DPLevel(sub, ranks, ranks.index(me))
            out.append(mine)
        return out

    @property
    def first_worker(self) -> int:
        return self.rank

    def _one(self, parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
        if len(parts) != 1:
            raise ValueError(f"{len(parts)} payloads for the one worker "
                             "of a rank")
        _note(op, parts)
        return parts[0]

    def to_wire(self, x: torch.Tensor) -> torch.Tensor:
        """A copy of ``x`` in the memory the backend moves: pinned host
        memory for a CUDA tensor on a gloo group, else ``x``'s device."""
        if x.device.type == "cuda" and self.staging == "host":
            return torch.empty(x.shape, dtype=x.dtype,
                               pin_memory=True).copy_(x)
        return x.clone()

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        buf = self.to_wire(x)
        dist.all_reduce(buf, op=op, group=self.pg)
        return buf.to(x.device)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over the W ranks (``all_reduce(SUM)``); every rank receives
        the same bits."""
        return self._all_reduce(self._one(parts, "sum"), dist.ReduceOp.SUM)

    def bor(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Bitwise OR over the W ranks (int32 words carrying uint32 bits),
        by :func:`or_allreduce` over the levels' subgroups."""
        x = self._one(parts, "bor")
        return or_allreduce(self.to_wire(x), self.dp_levels).to(x.device)

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise max over the W ranks (``all_reduce(MAX)``)."""
        return self._all_reduce(self._one(parts, "max"), dist.ReduceOp.MAX)

    def sum_scatter(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's slice of the sum over the W ranks, by the ring
        reduce-scatter over the levels (:func:`reduce_scatter`)."""
        x = self._one(parts, "sum_scatter")
        return [reduce_scatter(self.to_wire(x), self.dp_levels,
                               torch.Tensor.add_).to(x.device)]

    def bor_scatter(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's slice of the bitwise OR over the W ranks
        (:func:`or_reduce_scatter`)."""
        x = self._one(parts, "bor_scatter")
        return [or_reduce_scatter(self.to_wire(x), self.dp_levels).to(x.device)]

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """All-gather of this rank's slice: the W ranks' equal slices
        concatenated in rank order on the leading dim. The slices move as
        bytes (``all_gather`` on their ``uint8`` view), whatever their
        dtype."""
        x = self._one(parts, "gather").contiguous()
        wire = self.to_wire(x)
        if x.dim() == 0:
            raise ValueError("gather needs a slice with a leading dim")
        # flat first: a contiguous tensor may carry any stride on a dim
        # of size 1, which a byte view refuses
        raw = wire.reshape(-1).view(torch.uint8)
        out = torch.empty((self.workers,) + tuple(raw.shape), dtype=torch.uint8,
                          device=raw.device, pin_memory=raw.is_pinned())
        dist.all_gather(list(out.unbind(0)), raw, group=self.pg)
        out = out.view(x.dtype).reshape((self.workers * x.shape[0],)
                                        + tuple(x.shape[1:]))
        return out.to(x.device)

    def lane_sum(self, parts: Sequence[torch.Tensor], combine: str
                 ) -> List[torch.Tensor]:
        """The all-to-all lane merge of this rank's ``(W, ...)`` stack:
        lane r summed (``"add"``) or ORed (``"or"``) over the ranks lands
        at rank r. On one level, the reference's native leg: own lane
        first, then at offset k = 1..W-1 this rank sends lane ``(i+k) % W``
        to rank ``(i+k) % W`` and combines what rank ``(i-k) % W`` sends,
        in that order. On several levels, its emulated leg: the whole
        stack summed (``all_reduce``) or ORed (:func:`or_allreduce`),
        then this rank's lane."""
        x = self._one(parts, "lane_sum")
        if len(self.levels) > 1:
            full = (self._all_reduce(x, dist.ReduceOp.SUM) if combine == "add"
                    else or_allreduce(self.to_wire(x), self.dp_levels).to(x.device))
            return [full[self.rank]]
        level = self.dp_levels[0]
        W, i = level.size, level.index
        wire = self.to_wire(x)
        out = wire[i].clone()
        recv = torch.empty_like(out)
        for k in range(1, W):
            exchange(level, sends=[(wire[(i + k) % W], (i + k) % W)],
                     recvs=[(recv, (i - k) % W)])
            if combine == "or":
                out |= recv
            else:
                out += recv
        return [out.to(x.device)]

    def issuer(self) -> CommThread:
        """A streamed aggregation's reduces run on one communication
        thread, in chunk order (:class:`repro_torch.core.streams.CommThread`)."""
        return CommThread()


def alltoall_lane_sum(parts: Sequence[torch.Tensor], group,
                      combine: str = "add") -> List[torch.Tensor]:
    """Merge stacked all-to-all lanes (the reference's
    ``alltoall_lane_sum``): ``parts[w]`` is local worker w's ``(W, ...)``
    stack, lane d its payload for worker d (rank-major); returns one
    merged lane a local worker, worker r's being ``combine_s x_s[r]``
    over every source s: the sum of the sketches (``"add"``) or the OR of
    the words (``"or"``). See ``LocalWorkers.lane_sum`` and
    ``ProcessGroupWorkers.lane_sum`` for the order of the combines."""
    if combine not in ("add", "or"):
        raise ValueError(f"combine must be 'add' or 'or', got {combine!r}")
    W = group.workers
    for x in parts:
        if x.shape[0] != W:
            raise ValueError(f"all-to-all payload has {x.shape[0]} lanes but "
                             f"the group has {W} ranks")
    if len(parts) != group.local_workers:
        raise ValueError(f"{len(parts)} payloads for {group.local_workers} "
                         "local workers")
    if W == 1:
        return [parts[0][0]]
    return group.lane_sum(parts, combine)


def sketch_all_to_all(sketches: Sequence[torch.Tensor],
                      words: Sequence[torch.Tensor], group):
    """The compressed all-to-all (the reference's ``sketch_all_to_all``):
    ``sketches[w]`` ``(W, *sketch_shape)`` and ``words[w]`` ``(W,
    n_words)`` are local worker w's lanes; returns (merged sketches,
    merged words), one a local worker: the sum of every source's sketch
    of that worker's lane and the OR of their words, the compressed form
    of ``sum_s payload_s[r]``."""
    return (alltoall_lane_sum(sketches, group, "add"),
            alltoall_lane_sum(words, group, "or"))


def dense_all_reduce(grads_w: Sequence[Sequence[torch.Tensor]],
                     group, mean: bool = True) -> List[torch.Tensor]:
    """Mean (or with ``mean=False`` the sum) of every leaf over the
    workers, summed in f32 and cast back to the leaf's dtype.
    ``grads_w[w]`` is local worker w's leaves."""
    div = group.workers if mean else 1
    return [(group.sum([g.to(torch.float32) for g in parts]) / div
             ).to(parts[0].dtype) for parts in zip(*grads_w)]


@dataclasses.dataclass(frozen=True)
class AggregationState:
    """Per-leaf error-feedback residuals, each stacked
    ``(local_workers, *shape)``
    (or ``(0,)`` stubs when error feedback is off), plus the recovery
    stats of the last compressed aggregation (``None`` for dense) and
    the ``auto`` strategy's ``telemetry`` (a dict with
    ``bucket_occupancy``, each bucket's non-zero share of the aggregated
    stream, equal on every rank; ``None`` for the fixed strategies)."""

    residual: Any
    stats: Any = None
    telemetry: Any = None


def init_aggregation_state(params, cfg, group) -> AggregationState:
    """Zero error-feedback residuals for ``params`` (its leaves, or a
    sequence of tensors), one f32 row a local worker of ``group``:
    ``(local_workers, *shape)`` on the leaf's device where ``cfg`` keeps
    top-k with error feedback, else ``(0,)`` stubs; the train step's own
    residuals (``train.step.init_train_state``).

    The reference's ``init_aggregation_state(params, cfg)`` keeps one
    residual of the parameter's shape and sharding: a device's view of
    it is its worker's row. ``group`` stands in for the mesh that places
    those views, and gives their number here."""
    leaves = params.leaves() if hasattr(params, "leaves") else list(params)
    if cfg.topk_ratio is not None and cfg.error_feedback:
        res = [torch.zeros((group.local_workers,) + tuple(p.shape),
                           dtype=torch.float32, device=p.device) for p in leaves]
    else:
        res = [torch.zeros((0,), dtype=torch.float32, device=p.device)
               for p in leaves]
    return AggregationState(residual=res)


def compressed_all_reduce(grads_w, agg_state: AggregationState, group, cfg,
                          mean: bool = True, reduce_scatter: bool = False):
    """Aggregate the local workers' gradients (``grads_w[w]``: local
    worker w's leaves) with the paper's compressed pipeline: a thin
    wrapper over :func:`~repro_torch.core.aggregators.make_aggregator`'s
    ``"compressed"`` strategy, or ``"compressed_rs"`` with
    ``reduce_scatter``, kept as the reference keeps its own for API
    compatibility. Returns ``(aggregated leaves, new AggregationState)``.

    The reference's ``param_specs``, ``mesh``, ``dp_axes``, ``tp_axes``
    and ``outer_manual`` have no counterpart: they place a ``shard_map``
    region on a device mesh, and the port's workers are ``group`` (a
    ``LocalWorkers`` or ``ProcessGroupWorkers``), whose W is the
    data-parallel size; on a grid with a model axis, pass the rank's
    data-parallel group and its shard-local leaves
    (``launch/mesh.RankMesh.data``)."""
    # late: aggregators imports this module's primitives
    from .aggregators import make_aggregator
    name = "compressed_rs" if reduce_scatter else "compressed"
    return make_aggregator(name, cfg, group, mean=mean)(grads_w, agg_state)
