"""Reduction trees for the in-network aggregation tier.

Workers send their sketch and bitmap up a worker -> ToR -> spine tree
once, switches combine (integer add, OR) as the stream passes, and the
root broadcasts the aggregate back down. :class:`Topology` maps that tree
onto the data-parallel levels of a group
(:class:`repro_torch.core.collectives.LocalWorkers` or
``ProcessGroupWorkers``: the reference's mesh axes) and accounts its
links; :func:`tree_all_reduce` is the schedule: a binary reduce-to-root
per level, innermost first, then the broadcast back down.

As in the reference, the tree combines with integer add or bitwise OR
only and rejects float operands: the float sketch goes through the
fixed-point wire first (:mod:`repro_torch.net.fixedpoint`). Both
combiners are exact, so the tree's result equals the flat sum and OR of
the same payloads bit for bit. Over ``LocalWorkers`` the W workers are
emulated on one device, so the broadcast hands every worker the root's
tensor; over a process group each step is a point-to-point send
between the ranks of one level's subgroup (:func:`reduce_to_root`,
:func:`broadcast_from_root`), with the reference's pairs.

Wire model per direction (``P`` = payload bytes): every worker sends
``P`` once up its link and receives ``P`` once back; a level-i switch
ingests ``fanout_i * P`` but forwards only the aggregated ``P``, so the
root link carries ``P`` however many workers hang below it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.collectives import DPLevel, exchange
from .fixedpoint import ceil_log2

TOPOLOGIES = ("flat", "tor_spine")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A reduction tree over data-parallel levels.

    ``sizes`` are the level sizes, innermost first. The reduction
    schedule is the same for every kind; the kind changes how the
    physical tree is accounted: ``flat`` is one switch with ``workers``
    ports, ``tor_spine`` one switch tier per level.
    """

    kind: str
    sizes: Tuple[int, ...]

    @property
    def workers(self) -> int:
        return math.prod(self.sizes)

    @property
    def fanouts(self) -> Tuple[int, ...]:
        """Children per switch, leaf tier first."""
        if self.kind == "flat":
            return (self.workers,)
        return self.sizes

    @property
    def depth(self) -> int:
        return len(self.fanouts)

    def switches_per_level(self) -> Tuple[int, ...]:
        """How many switches each tier has (leaf tier first)."""
        out, below = [], 1
        for f in self.fanouts:
            below *= f
            out.append(self.workers // below)
        return tuple(out)

    def link_profile(self, payload_bytes: int) -> Dict[str, object]:
        """Per-direction byte loads of one aggregation round;
        ``switch_ingress_bytes`` is per switch, per tier."""
        if self.workers == 1:
            return {"worker_link_bytes": 0, "root_link_bytes": 0,
                    "switch_ingress_bytes": (0,) * self.depth}
        return {
            "worker_link_bytes": payload_bytes,
            "root_link_bytes": payload_bytes,
            "switch_ingress_bytes": tuple(
                f * payload_bytes for f in self.fanouts),
        }

    def window_profile(self, chunk_bytes: int, n_chunks: int,
                       slots: int) -> Dict[str, object]:
        """Per-window wire accounting of the windowed tree: windows of at
        most ``slots`` chunks, as :func:`tree_all_reduce` with
        ``window_slots=slots`` reduces them and as
        :class:`repro_torch.net.switch.SwitchModel` streams its slot pool
        (its ``report()`` agrees window for window). ``chunk_bytes``: wire
        bytes of one chunk (int32 sketch + bitmap words of one bucket)."""
        if chunk_bytes < 0 or n_chunks < 0:
            raise ValueError("chunk_bytes/n_chunks must be >= 0")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        window_chunks = tuple(min(slots, n_chunks - w0)
                              for w0 in range(0, n_chunks, slots))
        return {
            "windows": len(window_chunks),
            "occupancy_peak": max(window_chunks, default=0),
            "window_chunks": window_chunks,
            "window_root_bytes": tuple(c * chunk_bytes
                                       for c in window_chunks),
            "root_link_bytes": n_chunks * chunk_bytes,
        }


def make_topology(kind: str, group) -> Topology:
    """Map ``kind`` onto ``group.levels`` (a ``LocalWorkers`` or a
    ``ProcessGroupWorkers``). ``flat``:
    one switch tier with all W workers as ports. ``tor_spine``: one tier
    per level, so it needs two levels or more (a ToR tier and a spine)."""
    if kind not in TOPOLOGIES:
        raise ValueError(f"unknown topology {kind!r}; have {TOPOLOGIES}")
    levels = tuple(group.levels)
    if kind == "tor_spine" and len(levels) < 2:
        raise ValueError(
            "topology='tor_spine' needs >= 2 data-parallel levels (one for "
            f"the ToR tier, one for the spine), got {levels}; use 'flat' "
            "for a single level")
    return Topology(kind=kind, sizes=levels)


def _combine_fn(combine: str, dtype: torch.dtype):
    """The switch's combiner for ``dtype``. Floats are rejected for both:
    a switch has integer registers only. ``"or"`` takes int32 as well as
    unsigned words, because the port carries the bitmap's uint32 bits in
    int32 tensors."""
    integer = not (dtype.is_floating_point or dtype.is_complex
                   or dtype == torch.bool)
    if combine == "add":
        if not integer:
            raise TypeError(
                "tree_all_reduce combines with integer adds only (switch "
                f"register semantics); got {dtype}. Quantize the sketch "
                "through repro_torch.net.fixedpoint.FixedPointWire first.")
        return torch.add
    if combine == "or":
        if not integer:
            raise TypeError(
                f"tree_all_reduce 'or' needs integer words, got {dtype}")
        return torch.bitwise_or
    raise ValueError(f"combine must be 'add' or 'or', got {combine!r}")


def _reduce_steps(n: int):
    """The reduce-to-root schedule on a level of ``n``: per step, the
    (child, parent) pairs, child ``r + d`` sending its subtotal to ``r``
    for d = 1, 2, 4, ..."""
    d = 1
    while d < n:
        yield [(i, i - d) for i in range(d, n, 2 * d)]
        d *= 2


def _broadcast_steps(n: int):
    """The inverse tree: per step, the (parent, child) pairs that carry
    rank 0's value down, the widest distance first."""
    if n == 1:
        return
    d = 1 << (ceil_log2(n) - 1)
    while d >= 1:
        yield [(i - d, i) for i in range(d, n, 2 * d)]
        d //= 2


def reduce_to_root(x: torch.Tensor, level: DPLevel, combine: str
                   ) -> torch.Tensor:
    """Binary-tree reduction of this rank's payload to rank 0 of the
    level in ceil(log2 n) point-to-point steps. Ranks other than 0 end
    with stale partials (the broadcast overwrites them)."""
    comb = _combine_fn(combine, x.dtype)
    for pairs in _reduce_steps(level.size):
        for child, parent in pairs:
            if child == level.index:
                exchange(level, sends=[(x, parent)])
            elif parent == level.index:
                recv = torch.empty_like(x)
                exchange(level, recvs=[(recv, child)])
                x = comb(x, recv)
    return x


def broadcast_from_root(x: torch.Tensor, level: DPLevel) -> torch.Tensor:
    """Rank 0's value of the level reaches every rank of it in
    ceil(log2 n) point-to-point steps."""
    for pairs in _broadcast_steps(level.size):
        for parent, child in pairs:
            if parent == level.index:
                exchange(level, sends=[(x, child)])
            elif child == level.index:
                x = torch.empty_like(x)
                exchange(level, recvs=[(x, parent)])
    return x


def _reduce_levels(parts: List[torch.Tensor], topo: Topology,
                   combine: str) -> torch.Tensor:
    """Emulated on one device: reduce level by level, innermost first; at
    level l the ranks are the roots of level l-1 (workers at a stride of
    the sizes below)."""
    comb = _combine_fn(combine, parts[0].dtype)
    stride = 1
    for size in topo.sizes:
        span = stride * size
        for base in range(0, topo.workers, span):
            for pairs in _reduce_steps(size):
                for child, parent in pairs:
                    p, c = base + parent * stride, base + child * stride
                    parts[p] = comb(parts[p], parts[c])
        stride = span
    return parts[0]


def _tree_p2p(x: torch.Tensor, levels: Sequence[DPLevel],
              combine: str) -> torch.Tensor:
    for level in levels:
        x = reduce_to_root(x, level, combine)
    for level in reversed(levels):
        x = broadcast_from_root(x, level)
    return x


def tree_all_reduce(parts: Sequence[torch.Tensor], topo: Topology,
                    combine: str, window_slots: Optional[int] = None,
                    group=None) -> List[torch.Tensor]:
    """Reduce-to-root over the topology's levels, then broadcast: the
    aggregate each local worker holds. ``parts`` are the payloads of the
    local workers of ``group`` (default: all ``topo.workers``, emulated
    on one device); ``combine`` is ``"add"`` (integer) or ``"or"``, and
    float payloads raise. Over a ``ProcessGroupWorkers`` the steps are
    sends between the ranks of each level's subgroup, staged as the
    group's other collectives.

    ``window_slots``: the leading dim of each payload is a stream of
    chunks (buckets), reduced at most ``window_slots`` at a time, window
    by window, as a switch streams its bounded slot pool. The result is
    the one-shot reduction's bit for bit; windowing only splits the
    schedule.
    """
    parts = list(parts)
    local = topo.workers if group is None else group.local_workers
    if len(parts) != local:
        raise ValueError(f"{len(parts)} payloads for {local} local workers "
                         f"of a tree of {topo.workers}")
    _combine_fn(combine, parts[0].dtype)
    if window_slots is not None and window_slots < 1:
        raise ValueError(f"window_slots must be >= 1, got {window_slots}")
    n = parts[0].shape[0]
    windows = ([(0, n)] if window_slots is None or n <= window_slots else
               [(w0, w0 + window_slots) for w0 in range(0, n, window_slots)])
    if local == topo.workers:
        if len(windows) == 1:
            root = _reduce_levels(parts, topo, combine)
        else:
            root = torch.cat([_reduce_levels([p[a:b] for p in parts], topo,
                                             combine) for a, b in windows])
        return [root] * topo.workers
    if tuple(group.levels) != topo.sizes:
        raise ValueError(f"topology levels {topo.sizes} are not the "
                         f"group's {tuple(group.levels)}")
    wire = group.to_wire(parts[0])
    out = torch.cat([_tree_p2p(wire[a:b], group.dp_levels, combine)
                     for a, b in windows])
    return [out.to(parts[0].device)]
