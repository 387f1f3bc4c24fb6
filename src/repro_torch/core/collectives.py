"""Data-parallel aggregation over W workers: emulated on one device, or
as the ranks of a ``torch.distributed`` process group.

The reference runs its data-parallel workers as devices of a mesh and
aggregates with ``psum`` (sketches, dense gradients), an OR all-reduce
built from ``ppermute`` (bitmap words) and a ``pmax`` (fxp32
exponents). The port has two groups with one surface: ``workers`` (W),
``levels``, ``local_workers`` (the workers this process runs),
``first_worker`` (the global index of its first) and ``sum``, ``bor``
and ``max``, each taking the payloads of the local workers and
returning the aggregate over all W:

- :class:`LocalWorkers` emulates all W workers in one process on one
  device, folding over the worker axis;
- :class:`ProcessGroupWorkers` is one rank of W processes: ``sum`` and
  ``max`` are ``all_reduce``, and ``bor`` is the reference's
  hierarchical OR all-reduce on point-to-point sends, since no
  collective library reduces with a bitwise OR.

The OR all-reduce primitives are the reference's
(``src/repro/core/collectives.py``) on ``torch.distributed`` P2P:

- :func:`or_allreduce_ring`: reduce-scatter then all-gather around a
  ring with an OR combiner, 2·(W−1)/W · |B| a link;
- :func:`or_allreduce_doubling`: recursive doubling, log2 W full-size
  exchanges, powers of two only;
- :func:`or_allreduce`: over several levels, innermost first, each by
  the ring for payloads of ``ring_threshold`` bytes or more and for
  sizes that are not a power of two, else by doubling.

Every exchange posts its send and its receive together
(``dist.batch_isend_irecv``), so no ring step waits on a blocking send.
The words are int32 tensors carrying uint32 bits; every path moves and
ORs them as bits, bit 31 included.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist


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

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over workers, folded in worker order ((w0 + w1) + w2) ..."""
        self._check(parts)
        return functools.reduce(torch.add, parts)

    def bor(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Bitwise OR over workers (int32 words carrying uint32 bits)."""
        self._check(parts)
        return functools.reduce(torch.bitwise_or, parts)

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise max over workers (the reference's ``pmax``)."""
        self._check(parts)
        return functools.reduce(torch.maximum, parts)


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


class ProcessGroupWorkers:
    """This process as one of W data-parallel ranks of the default
    ``torch.distributed`` process group, one worker a rank.

    ``levels`` are the data-parallel level sizes, innermost first,
    multiplying to W (default: one level of all W); rank w's index on
    them is rank-major, as in :class:`LocalWorkers`. Each level becomes
    a subgroup (``dist.new_group``) of the ranks that differ only in that
    level's index; every rank creates every subgroup, in the same order,
    as ``new_group`` requires.

    ``staging``: gloo moves host memory (its point-to-point ops take
    host tensors only), so on a gloo group every collective copies a CUDA
    payload to pinned host memory, reduces it there and copies the
    result back (``"host"``); on NCCL, one card a rank, payloads stay on
    the device (``"device"``). Chosen from the backend, never by trying.
    """

    local_workers = 1

    def __init__(self, levels: Sequence[int] = ()):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupWorkers needs an initialized "
                               "default process group")
        self.workers = dist.get_world_size()
        self.rank = dist.get_rank()
        levels = tuple(int(s) for s in levels) or (self.workers,)
        if min(levels) < 1 or math.prod(levels) != self.workers:
            raise ValueError(f"levels {levels} do not multiply to "
                             f"{self.workers} workers")
        self.levels = levels
        self.backend = dist.get_backend()
        self.staging = "host" if self.backend == "gloo" else "device"
        self.dp_levels: List[DPLevel] = []
        for l, size in enumerate(levels):
            mine = None
            for w in range(self.workers):
                idx = level_indices(w, levels)
                if idx[l]:
                    continue       # each subgroup once, from its index-0 rank
                ranks = tuple(linear_rank(idx[:l] + (j,) + idx[l + 1:], levels)
                              for j in range(size))
                sub = dist.new_group(list(ranks)) if size > 1 else None
                if self.rank in ranks:
                    mine = DPLevel(sub, ranks, ranks.index(self.rank))
            self.dp_levels.append(mine)

    @property
    def first_worker(self) -> int:
        return self.rank

    def _one(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(parts) != 1:
            raise ValueError(f"{len(parts)} payloads for the one worker "
                             "of a rank")
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
        dist.all_reduce(buf, op=op)
        return buf.to(x.device)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over the W ranks (``all_reduce(SUM)``); every rank receives
        the same bits."""
        return self._all_reduce(self._one(parts), dist.ReduceOp.SUM)

    def bor(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Bitwise OR over the W ranks (int32 words carrying uint32 bits),
        by :func:`or_allreduce` over the levels' subgroups."""
        x = self._one(parts)
        return or_allreduce(self.to_wire(x), self.dp_levels).to(x.device)

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise max over the W ranks (``all_reduce(MAX)``)."""
        return self._all_reduce(self._one(parts), dist.ReduceOp.MAX)


def dense_all_reduce(grads_w: Sequence[Sequence[torch.Tensor]],
                     group) -> List[torch.Tensor]:
    """Mean of every leaf over the workers, summed in f32 and cast back to
    the leaf's dtype. ``grads_w[w]`` is local worker w's leaves."""
    return [(group.sum([g.to(torch.float32) for g in parts]) / group.workers
             ).to(parts[0].dtype) for parts in zip(*grads_w)]


@dataclasses.dataclass(frozen=True)
class AggregationState:
    """Per-leaf error-feedback residuals, each stacked
    ``(local_workers, *shape)``
    (or ``(0,)`` stubs when error feedback is off), plus the recovery
    stats of the last compressed aggregation (``None`` for dense)."""

    residual: Any
    stats: Any = None
