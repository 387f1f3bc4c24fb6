"""Elastic aggregation server: round orchestration over the async fold.

The reference's service loop, applied to gradient payloads:

- **Admission**: a bounded roster (:class:`AdmissionPolicy.max_cohort`)
  with a join queue drained at round open.
- **Round open**: membership changes take effect here; the contract is
  renegotiated (new cohort, new fxp32 mantissa budget) and published.
- **Submit**: payloads fold as they arrive (:class:`FoldEngine`, or the
  :class:`ShardedFoldService` when ``n_shards`` or ``batch_size`` is
  above 1), with straggler timeout/retransmit accounting through
  :class:`repro_torch.ft.failures.SwitchRetransmitPolicy` and arrival
  outliers flagged by :class:`repro_torch.ft.failures.StragglerMonitor`.
- **Close-out**: at full attendance, or at the deadline with quorum, or
  at quorum once every member is folded or deferred. Late payloads (past
  the deadline or the retransmit budget) are deferred, not dropped: each
  is decoded on its own under its still-current contract and carried
  into the next round's output as a server-side residual, so the
  accounting stays loss-free across membership changes.

Times are caller-supplied simulated seconds from the round open: the
server is deterministic and event-driven, so arrival schedules replay
exactly. The fold state, the recovered stream and the residual are
tensors on the server's ``device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core.bucketing import BucketPlan, make_bucket_plan
from repro_torch.core.config import CompressionConfig
from repro_torch.ft.failures import (StragglerMonitor, SwitchRetransmitPolicy,
                                     SwitchStragglerTimeout)

from .client import tree_leaves
from .fold import FoldEngine
from .membership import (ClientPayload, ExponentProposal, Membership,
                         RoundContract, StaleContractError)
from .shard import ShardedFoldService


class QuorumNotReached(RuntimeError):
    """close_round() before quorum folded (and no deadline override)."""


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Roster bound and close-out rule."""

    max_cohort: int = 1024
    quorum: float = 0.5              # fraction of the cohort that must
                                     # fold before a deadline close
    deadline_s: float = 1.0          # close-out deadline (seconds from
                                     # round open)

    def __post_init__(self):
        if self.max_cohort < 1:
            raise ValueError(f"max_cohort must be >= 1, got "
                             f"{self.max_cohort}")
        if not (0.0 < self.quorum <= 1.0):
            raise ValueError(f"quorum must be in (0, 1], got "
                             f"{self.quorum}")
        if self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got "
                             f"{self.deadline_s}")

    def quorum_count(self, workers: int) -> int:
        return max(1, int(math.ceil(self.quorum * workers)))


@dataclasses.dataclass
class RoundReport:
    """Per-round close-out accounting."""

    round_id: int
    contract_id: str
    workers: int
    folded: int
    deferred: int
    rejected_stale: int
    retransmits: int
    close_reason: str                # complete | deadline | quorum
    rx_bytes_total: int
    residual_carried_in: bool        # earlier rounds' late payloads were
                                     # added to this output
    windows: int
    occupancy_peak: int
    straggler_events: int


class ElasticServer:
    """Round-orchestrating aggregation service over the async fold.

    ``template`` is a nested dict of arrays or tensors with the gradient
    shapes (a model's parameter tree); only its shapes are read.
    """

    def __init__(self, template: Any, cfg: CompressionConfig,
                 policy: Optional[AdmissionPolicy] = None,
                 retransmit: Optional[SwitchRetransmitPolicy] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 window_slots: Optional[int] = None,
                 n_shards: int = 1, batch_size: int = 1, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.plan: BucketPlan = make_bucket_plan(tree_leaves(template)[1], cfg)
        self.policy = policy or AdmissionPolicy()
        self.retransmit = retransmit
        self.monitor = monitor
        self.window_slots = window_slots
        # with either knob above 1 every round runs through the
        # ShardedFoldService (the same fold surface and close-out)
        if n_shards < 1 or batch_size < 1:
            raise ValueError(
                f"n_shards/batch_size must be >= 1, got "
                f"{n_shards}/{batch_size}")
        self.n_shards = int(n_shards)
        self.batch_size = int(batch_size)
        self.membership = Membership(max_cohort=self.policy.max_cohort)
        self.reports: List[RoundReport] = []
        self._round_id = 0
        self._contract: Optional[RoundContract] = None
        self._engine = None
        self._state = None
        self._deferred: List[ClientPayload] = []
        self._rejected_stale = 0
        # the server-side residual: deferred late payloads land here and
        # ride the NEXT round's output (never dropped)
        self._residual = torch.zeros(
            (self.plan.n_buckets, self.plan.bucket_elems),
            dtype=torch.float32, device=self.device)
        self._residual_pending = False

    # ---- membership ---------------------------------------------------

    def join(self, client: int) -> str:
        return self.membership.join(client)

    def leave(self, client: int) -> None:
        self.membership.leave(client)

    # ---- round lifecycle ---------------------------------------------

    @property
    def contract(self) -> Optional[RoundContract]:
        return self._contract

    def open_round(self) -> RoundContract:
        if self._contract is not None:
            raise RuntimeError(
                f"round {self._contract.round_id} is still open")
        self.membership.admit_queued()
        self._contract = self.membership.contract(
            self._round_id, self.plan, self.cfg)
        if self.n_shards > 1 or self.batch_size > 1:
            self._engine = ShardedFoldService(
                self._contract, self.cfg, n_shards=self.n_shards,
                batch_size=self.batch_size,
                window_slots=self.window_slots, plan=self.plan,
                device=self.device)
        else:
            self._engine = FoldEngine(self._contract, self.cfg,
                                      window_slots=self.window_slots,
                                      device=self.device)
        self._state = self._engine.init_state()
        self._deferred = []
        self._rejected_stale = 0
        return self._contract

    def _require_open(self) -> None:
        if self._contract is None:
            raise RuntimeError("no round is open")

    def submit_exponents(self, proposal: ExponentProposal) -> None:
        """Phase A (fxp32): max-fold one exponent proposal."""
        self._require_open()
        self._engine.propose_exponents(
            self._state, proposal.client, proposal.exponents,
            contract_id=proposal.contract_id)

    def seal_exponents(self) -> torch.Tensor:
        """Freeze and publish the shared exponents for this round."""
        self._require_open()
        return self._engine.seal_exponents(self._state)

    def submit(self, payload: ClientPayload,
               arrival_s: float = 0.0) -> str:
        """Fold one arriving payload; returns ``"folded"`` or
        ``"deferred"`` (past the deadline or the retransmit budget:
        carried into the next round's residual).

        A payload quoting a stale contract raises
        :class:`StaleContractError`: the client must ``reencode()`` and
        resubmit. It is never silently folded or deferred (it cannot even
        be decoded under this round's budget).
        """
        self._require_open()
        if payload.contract_id != self._contract.contract_id:
            self._rejected_stale += 1
            raise StaleContractError(
                f"payload quotes {payload.contract_id}, round is "
                f"{self._contract.contract_id} — re-encode under the "
                "current contract")
        if self.monitor is not None:
            self.monitor.observe(self._round_id, float(arrival_s))
        if arrival_s > self.policy.deadline_s:
            self._deferred.append(payload)
            return "deferred"
        try:
            self._engine.fold(self._state, payload,
                              arrival_s=float(arrival_s),
                              policy=self.retransmit)
        except SwitchStragglerTimeout:
            self._deferred.append(payload)
            return "deferred"
        return "folded"

    def close_round(self, now_s: Optional[float] = None
                    ) -> Tuple[torch.Tensor, RoundReport]:
        """Close the round; returns ``(sum_stream, report)``:
        ``sum_stream`` is the recovered ``(n_buckets, bucket_elems)`` f32
        sum over the contributions (callers divide by
        ``contract.workers`` for the mean), with any residual carried
        from earlier rounds' deferred payloads.

        Close is allowed at full attendance, or once ``now_s`` reaches
        the deadline with quorum folded, or at quorum once every member
        is folded or deferred; otherwise :class:`QuorumNotReached`.
        """
        self._require_open()
        c, st = self._contract, self._state
        folded = st.contributions
        quorum = self.policy.quorum_count(c.workers)
        if folded == c.workers:
            reason = "complete"
        elif folded >= quorum and now_s is not None and \
                now_s >= self.policy.deadline_s:
            reason = "deadline"
        elif folded >= quorum and folded + len(self._deferred) == \
                c.workers:
            # every cohort member is accounted for (folded or deferred):
            # nothing left to wait on, close without burning the deadline
            reason = "quorum"
        else:
            raise QuorumNotReached(
                f"round {c.round_id}: {folded}/{c.workers} folded, "
                f"quorum is {quorum} (pass now_s >= deadline_s to close "
                "at quorum)")

        out = self._engine.finalize(st)
        carried = self._residual_pending
        if carried:
            out = out + self._residual
        # this round's late payloads become the NEXT round's residual
        self._residual.zero_()
        self._residual_pending = bool(self._deferred)
        for p in self._deferred:
            self._residual += self._engine.decode_payload(p)

        report = RoundReport(
            round_id=c.round_id, contract_id=c.contract_id,
            workers=c.workers, folded=folded,
            deferred=len(self._deferred),
            rejected_stale=self._rejected_stale,
            retransmits=st.retransmits, close_reason=reason,
            rx_bytes_total=sum(st.rx_bytes.values()),
            residual_carried_in=carried, windows=st.windows,
            occupancy_peak=st.occupancy_peak,
            straggler_events=(len(self.monitor.events)
                              if self.monitor is not None else 0))
        self.reports.append(report)
        self._round_id += 1
        self._contract = None
        self._engine = None
        self._state = None
        self._deferred = []
        return out, report

    def pending_state(self):
        """The open round's fold engine and folded state, the sharded
        service's queued microbatches flushed into it (as the close would
        flush them), for a caller to check what the close will recover;
        the caller must not modify them."""
        self._require_open()
        if isinstance(self._engine, ShardedFoldService):
            self._engine.flush(self._state)
        return self._engine, self._state

    @property
    def pending_residual(self) -> torch.Tensor:
        """The deferred-contribution stream that will ride the next
        round's output (zeros when nothing is pending), so that loss-free
        accounting can be asserted from outside."""
        return self._residual.clone()
