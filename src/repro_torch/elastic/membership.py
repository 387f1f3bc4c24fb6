"""Round membership and the versioned wire contract.

The elastic tier aggregates payloads from an open population of clients,
joining and leaving between rounds, instead of a fixed group of W
workers. That breaks what every fixed-group wire fixes once: the fxp32
mantissa budget depends on W (``FixedPointWire.mantissa_bits = 30 -
ceil_log2(W)``), so a payload quantized for a 4-client round is wrong in
a 5-client round (its decode scale is off by a power of two, and the
int32 overflow bound no longer holds).

:class:`RoundContract` is the versioned handshake: one frozen record a
round carrying the cohort, the bucket geometry, the wire dtype and the
fxp32 mantissa budget. Every payload quotes the ``contract_id`` it was
encoded under, and the fold refuses (:class:`StaleContractError`)
anything quoting another contract: stale payloads are rejected or
re-encoded, never silently folded.

:class:`Membership` owns the roster and renegotiates the contract at
every round open, through :meth:`FixedPointWire.with_workers`, so the
mantissa budget tracks the live cohort size.

Payloads hold tensors on the aggregation point's device: the sketch
(f32, or int32 on fxp32), the bitmap words as int32 carrying the uint32
bits (the port's convention, :mod:`repro_torch.net.switch`) and the
fxp32 exponents as int32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.core.bucketing import BucketPlan
from repro_torch.core.config import CompressionConfig
from repro_torch.net.fixedpoint import FixedPointWire


class StaleContractError(RuntimeError):
    """A payload (or proposal) quotes a contract other than the open
    round's: the sender must re-encode under the current contract."""


@dataclasses.dataclass(frozen=True)
class RoundContract:
    """The per-round wire handshake (frozen, hashable).

    ``mantissa_bits`` is derived state: it must equal the
    ``FixedPointWire`` budget for ``len(cohort)`` workers (checked at
    construction). It is carried explicitly so that the contract id,
    which every payload quotes, changes whenever a membership change
    crosses a power of two and re-prices the wire.
    """

    round_id: int
    cohort: Tuple[int, ...]          # sorted, unique client ids
    n_buckets: int
    bucket_elems: int
    total_elems: int                 # true stream elems (pre-padding)
    wire_dtype: str                  # "f32" | "fxp32"
    mantissa_bits: Optional[int]     # fxp32 only; None on f32

    def __post_init__(self):
        if not self.cohort:
            raise ValueError("a round needs a non-empty cohort")
        if tuple(sorted(set(self.cohort))) != self.cohort:
            raise ValueError(
                f"cohort must be sorted and unique, got {self.cohort}")
        if self.wire_dtype not in ("f32", "fxp32"):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}")
        if self.wire_dtype == "fxp32":
            want = FixedPointWire(workers=len(self.cohort)).mantissa_bits
            if self.mantissa_bits != want:
                raise ValueError(
                    f"mantissa_bits={self.mantissa_bits} does not match "
                    f"the FixedPointWire budget for W={len(self.cohort)} "
                    f"({want}) — renegotiate via negotiate_contract()")
        elif self.mantissa_bits is not None:
            raise ValueError("f32 wire carries no mantissa budget")

    @property
    def workers(self) -> int:
        return len(self.cohort)

    @property
    def wire(self) -> FixedPointWire:
        """The fxp32 codec this round's payloads quantize through."""
        if self.wire_dtype != "fxp32":
            raise ValueError("the f32 wire has no fixed-point codec")
        return FixedPointWire(workers=self.workers)

    @property
    def contract_id(self) -> str:
        """Stable fingerprint every payload quotes (no salted ``hash()``):
        round id, cohort size, wire pricing and bucket geometry."""
        m = "-" if self.mantissa_bits is None else str(self.mantissa_bits)
        return (f"r{self.round_id}:W{self.workers}:{self.wire_dtype}:"
                f"m{m}:{self.n_buckets}x{self.bucket_elems}"
                f"/{self.total_elems}")


def negotiate_contract(round_id: int, cohort, plan: BucketPlan,
                       cfg: CompressionConfig) -> RoundContract:
    """The round contract for the live cohort. The fxp32 budget is
    renegotiated through ``with_workers``, the one renegotiation seam."""
    cohort = tuple(sorted(set(int(c) for c in cohort)))
    mant = None
    if cfg.wire_dtype == "fxp32":
        mant = FixedPointWire(workers=1).with_workers(
            len(cohort)).mantissa_bits
    return RoundContract(
        round_id=int(round_id), cohort=cohort, n_buckets=plan.n_buckets,
        bucket_elems=plan.bucket_elems, total_elems=plan.total,
        wire_dtype=cfg.wire_dtype, mantissa_bits=mant)


@dataclasses.dataclass(frozen=True)
class ExponentProposal:
    """Phase A of an fxp32 round: one client's per-bucket exponents (from
    its sketch maxima). Max-folds, so the server may fold proposals in
    any arrival order."""

    client: int
    contract_id: str
    exponents: torch.Tensor          # (n_buckets,) int32


@dataclasses.dataclass(frozen=True)
class ClientPayload:
    """One client's wire payload for one round.

    ``exponents`` (fxp32 only) are the sealed shared exponents the sketch
    was quantized against; the fold checks them against the round's
    sealed vector before summing integers.
    """

    client: int
    contract_id: str
    sketch: torch.Tensor             # (n_blocks, rows, lanes) f32|int32
    index_words: torch.Tensor        # (padded // 32,) int32 (uint32 bits)
    exponents: Optional[torch.Tensor] = None   # (n_buckets,) int32

    @property
    def nbytes(self) -> int:
        n = _nbytes(self.sketch) + _nbytes(self.index_words)
        if self.exponents is not None:
            n += _nbytes(self.exponents)
        return n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Membership:
    """Explicit client roster with per-round contract renegotiation.

    Joins and leaves take effect at the next :meth:`contract` call (round
    open): mid-round membership is frozen by the contract. ``max_cohort``
    bounds the roster; surplus joiners queue in arrival order and are
    admitted as roster slots free up.
    """

    def __init__(self, max_cohort: Optional[int] = None):
        if max_cohort is not None and max_cohort < 1:
            raise ValueError(f"max_cohort must be >= 1, got {max_cohort}")
        self.max_cohort = max_cohort
        self._roster: set = set()
        self._queue: List[int] = []

    # ---- roster ------------------------------------------------------

    @property
    def roster(self) -> Tuple[int, ...]:
        return tuple(sorted(self._roster))

    @property
    def queued(self) -> Tuple[int, ...]:
        return tuple(self._queue)

    def join(self, client: int) -> str:
        """Returns ``"admitted"`` or ``"queued"`` (roster full)."""
        client = int(client)
        if client in self._roster or client in self._queue:
            raise ValueError(f"client {client} already joined")
        if self.max_cohort is not None and \
                len(self._roster) >= self.max_cohort:
            self._queue.append(client)
            return "queued"
        self._roster.add(client)
        return "admitted"

    def leave(self, client: int) -> None:
        client = int(client)
        if client in self._roster:
            self._roster.discard(client)
        elif client in self._queue:
            self._queue.remove(client)
        else:
            raise KeyError(f"client {client} is not a member")

    def admit_queued(self) -> Tuple[int, ...]:
        """Fill freed roster slots from the queue (called at round open);
        returns the newly admitted clients."""
        admitted = []
        while self._queue and (self.max_cohort is None or
                               len(self._roster) < self.max_cohort):
            c = self._queue.pop(0)
            self._roster.add(c)
            admitted.append(c)
        return tuple(admitted)

    # ---- per-round renegotiation ------------------------------------

    def contract(self, round_id: int, plan: BucketPlan,
                 cfg: CompressionConfig) -> RoundContract:
        if not self._roster:
            raise ValueError("cannot open a round with an empty roster")
        return negotiate_contract(round_id, self._roster, plan, cfg)

    # ---- device-side sizing hook ------------------------------------

    def local_mesh(self, model_parallel: int = 1,
                   axis_names=("data", "model"), devices=None):
        """A local mesh's shape sized for this cohort
        (:func:`repro_torch.ft.failures.elastic_mesh`): the data axis
        fits both the device pool and the cohort. ``devices``: the pool
        as a count (default ``torch.cuda.device_count()``)."""
        import torch
        from repro_torch.ft.failures import elastic_mesh
        if not self._roster:
            raise ValueError("cannot size a mesh for an empty roster")
        pool = torch.cuda.device_count() if devices is None else int(devices)
        return elastic_mesh(min(pool, len(self._roster) * model_parallel),
                            model_parallel, axis_names)
