"""Data-parallel aggregation primitives for workers on one device.

The reference runs its data-parallel workers as devices of a mesh and
aggregates with ``psum`` (sketches, dense gradients) and an OR
all-reduce (bitmap words). This slice emulates W workers in one process
on one device: each worker's payload is computed in turn and
:class:`LocalWorkers` reduces over the stacked worker axis, with a sum
for the sketch and a bitwise OR for the words. The ``torch.distributed``
wire (NCCL, plus a P2P OR ring since NCCL has no bitwise-OR reduction)
comes with the multi-card slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class LocalWorkers:
    """W data-parallel workers emulated on one device."""

    workers: int

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")

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
