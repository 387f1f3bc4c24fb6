"""Per-bucket wire planning: the *plan* half of the plan/execute split
(the reference's ``repro.core.wireplan``).

A :class:`WirePlan` partitions the buckets of a
:class:`~repro_torch.core.bucketing.BucketPlan` into contiguous groups,
each assigned one of the four fixed wires. The aggregators of
:mod:`repro_torch.core.aggregators` execute whatever plan they are
handed, group by group; :mod:`repro_torch.core.costmodel` produces plans
for the ``auto`` strategy.

Mixed plans are exact because per-leaf sparsify and error feedback run
before packing and the plan never moves them, buckets are the codec's
unit, and every group encodes at its global block offsets
(``StreamPlan.base_block``): a group's sketch and bitmap are bit for bit
the corresponding slice of the whole stream's. So any plan equals the
fixed strategies it assigns, on the buckets it assigns them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# The four fixed wires a group may be assigned: the controller's search
# space. ``core/aggregators.py`` asserts at import time that it equals
# the fixed strategies of its registry.
WIRES = ("dense", "compressed", "compressed_rs", "compressed_innet")

# Collective patterns a group may run its wire over: ``allreduce``, the
# gradient aggregation every wire supports, and ``alltoall``, the
# expert-parallel permute, carried by the dense and compressed wires only.
PATTERNS = ("allreduce", "alltoall")

_PATTERN_WIRES = {
    "allreduce": WIRES,
    "alltoall": ("dense", "compressed"),
}


def pattern_wires(pattern: str) -> Tuple[str, ...]:
    """The wires able to execute ``pattern``."""
    if pattern not in PATTERNS:
        raise ValueError(
            f"unknown pattern {pattern!r}; valid patterns: {PATTERNS}")
    return _PATTERN_WIRES[pattern]


@dataclasses.dataclass(frozen=True)
class WireGroup:
    """One contiguous run of buckets shipped over one wire."""

    start: int             # first bucket index (into the BucketPlan)
    n_buckets: int         # whole buckets in this group
    wire: str              # one of WIRES
    stream_chunks: Optional[int] = None   # the group's chunk grid (None:
                                          # the config's)
    pattern: str = "allreduce"            # one of PATTERNS

    def __post_init__(self):
        if self.wire not in WIRES:
            raise ValueError(
                f"unknown wire {self.wire!r}; valid wires: {WIRES}")
        if self.pattern not in PATTERNS:
            raise ValueError(
                f"unknown pattern {self.pattern!r}; valid patterns: "
                f"{PATTERNS}")
        if self.wire not in _PATTERN_WIRES[self.pattern]:
            raise ValueError(
                f"wire {self.wire!r} cannot run the {self.pattern!r} "
                f"pattern; {self.pattern!r} wires: "
                f"{_PATTERN_WIRES[self.pattern]}")
        if self.start < 0:
            raise ValueError(f"start must be >= 0, got {self.start}")
        if self.n_buckets < 1:
            raise ValueError(
                f"n_buckets must be >= 1, got {self.n_buckets}")
        if self.stream_chunks is not None and self.stream_chunks < 1:
            raise ValueError(
                f"stream_chunks must be >= 1, got {self.stream_chunks}")
        if self.wire == "dense" and self.stream_chunks is not None:
            raise ValueError(
                "dense groups have no wire-chunk grid (they psum the "
                "packed buckets in one shot); stream_chunks must be None")

    @property
    def stop(self) -> int:
        return self.start + self.n_buckets


@dataclasses.dataclass(frozen=True)
class WirePlan:
    """Static partition of ``n_buckets`` buckets into wire groups, which
    tile the bucket range exactly (contiguous, in order, full coverage).
    Hashable; the ``auto`` controller re-plans only every
    ``cfg.replan_every`` steps."""

    n_buckets: int
    groups: Tuple[WireGroup, ...]

    def __post_init__(self):
        if self.n_buckets < 1:
            raise ValueError(
                f"n_buckets must be >= 1, got {self.n_buckets}")
        if not self.groups:
            raise ValueError("a WirePlan needs at least one group")
        object.__setattr__(self, "groups", tuple(self.groups))
        pos = 0
        for g in self.groups:
            if g.start != pos:
                raise ValueError(
                    f"groups must tile buckets contiguously: group at "
                    f"bucket {g.start} but previous group ends at {pos}")
            pos = g.stop
        if pos != self.n_buckets:
            raise ValueError(
                f"groups cover {pos} buckets, plan has {self.n_buckets}")
        patterns = {g.pattern for g in self.groups}
        if len(patterns) > 1:
            raise ValueError(
                "a WirePlan must be single-pattern: all groups must share "
                "one collective pattern (a bucket stream is packed for "
                "either the allreduce or the alltoall shape, never both); "
                f"got {sorted(patterns)}")

    @property
    def pattern(self) -> str:
        """The plan's (single, validated) collective pattern."""
        return self.groups[0].pattern

    @property
    def uniform_wire(self) -> Optional[str]:
        """The single wire when every group shares it, else None."""
        wires = {g.wire for g in self.groups}
        return next(iter(wires)) if len(wires) == 1 else None

    @property
    def is_trivial(self) -> bool:
        """One group, one wire, no chunk override: exactly a fixed
        strategy over the whole stream."""
        return (len(self.groups) == 1
                and self.groups[0].stream_chunks is None)

    def wire_of(self, bucket: int) -> str:
        """The wire assigned to one bucket."""
        if not 0 <= bucket < self.n_buckets:
            raise ValueError(
                f"bucket {bucket} out of range [0, {self.n_buckets})")
        for g in self.groups:
            if g.start <= bucket < g.stop:
                return g.wire
        raise AssertionError("unreachable: plan validated as covering")

    def describe(self) -> str:
        pat = "" if self.pattern == "allreduce" else f" @{self.pattern}"
        return " | ".join(
            f"[{g.start}:{g.stop}]={g.wire}"
            + (f"/c{g.stream_chunks}" if g.stream_chunks else "")
            for g in self.groups) + pat


def uniform_plan(n_buckets: int, wire: str,
                 stream_chunks: Optional[int] = None,
                 pattern: str = "allreduce") -> WirePlan:
    """Every bucket on one wire (the fixed strategies are these plans)."""
    return WirePlan(n_buckets=n_buckets, groups=(
        WireGroup(start=0, n_buckets=n_buckets, wire=wire,
                  stream_chunks=stream_chunks, pattern=pattern),))


def plan_from_assignments(wires: Sequence[str]) -> WirePlan:
    """Coalesce a per-bucket wire assignment into a plan, merging
    adjacent buckets on the same wire into one group."""
    if not wires:
        raise ValueError("need at least one bucket assignment")
    groups = []
    start = 0
    for i in range(1, len(wires) + 1):
        if i == len(wires) or wires[i] != wires[start]:
            groups.append(WireGroup(
                start=start, n_buckets=i - start, wire=wires[start]))
            start = i
    return WirePlan(n_buckets=len(wires), groups=tuple(groups))
