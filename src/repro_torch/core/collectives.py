"""Data-parallel aggregation primitives for workers on one device.

The reference runs its data-parallel workers as devices of a mesh and
aggregates with ``psum`` (sketches, dense gradients), an OR all-reduce
(bitmap words) and a ``pmax`` (fxp32 exponents). The port emulates W
workers in one process on one device: each worker's payload is computed
in turn and :class:`LocalWorkers` reduces over the worker axis, with a
sum for the sketch, a bitwise OR for the words and a max for the
exponents. The ``torch.distributed``
wire (NCCL, plus a P2P OR ring since NCCL has no bitwise-OR reduction)
comes with the multi-card slice.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, Sequence, Tuple

import torch


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


def dense_all_reduce(grads_w: Sequence[Sequence[torch.Tensor]],
                     group: LocalWorkers) -> List[torch.Tensor]:
    """Mean of every leaf over the workers, summed in f32 and cast back to
    the leaf's dtype. ``grads_w[w]`` is worker w's leaves."""
    return [(group.sum([g.to(torch.float32) for g in parts]) / group.workers
             ).to(parts[0].dtype) for parts in zip(*grads_w)]


@dataclasses.dataclass(frozen=True)
class AggregationState:
    """Per-leaf error-feedback residuals, each stacked ``(W, *shape)``
    (or ``(0,)`` stubs when error feedback is off), plus the recovery
    stats of the last compressed aggregation (``None`` for dense)."""

    residual: Any
    stats: Any = None
