"""Sharded, batched fold: the elastic service's scale-out path.

:class:`~repro_torch.elastic.fold.FoldEngine` folds one payload at a time
over the whole bucket stream. This module splits the round, as the
reference's ``repro.elastic.shard`` does:

- **Shard.** :class:`ShardedFoldService` tiles the round's bucket range
  into ``n_shards`` contiguous ranges (balanced, as
  ``BucketPlan.group_view`` cuts groups), one ``FoldEngine`` and one
  ``SwitchModel`` slot pool a shard, each with its shard-view
  :class:`~repro_torch.elastic.membership.RoundContract`. A payload is
  striped across the shards as zero-copy views of its sketch blocks,
  bitmap words and exponents, and the shards share no state.
- **Batch.** Arrivals queue per shard and fold as microbatches of
  ``batch_size`` payloads through three combines on the device
  (:func:`_fxp_batch_fold`, :func:`_or_batch_fold`,
  :func:`_f32_sorted_chain`) instead of one walk a payload. An fxp32
  microbatch's running partials (accumulator, then each payload) are
  checked in true int64 (:func:`_fxp_partial_extrema`) against the
  register width through
  :meth:`~repro_torch.net.switch.SwitchModel.check_batched_partial`
  before the int32 sum is committed.
- **Canonical order.** f32 adds do not associate, so the f32 payloads
  are held a cohort slot each and reduced at finalize in client-id
  order from zero: ``((0 + p_c0) + p_c1) + ...``. An f32 round's bits
  are a function of the contribution set, equal to the sequential
  engine's fed client-sorted arrivals, for any arrival order and any
  microbatch partition.
- **Telemetry.** Each shard's windows, occupancy, RX bytes and
  retransmits live in its :class:`~repro_torch.elastic.fold.FoldState`
  and roll up through :class:`ShardedFoldState`, so the server's
  close-out reads the fields it reads from a sequential round.

Straggler pricing walks the sequential engine's full-range window grid
(per-client retransmits and RX bytes are the sequential fold's), each
window booked on the shard owning its first bucket through
:meth:`repro_torch.ft.failures.SwitchRetransmitPolicy.shard_view`.

Each shard recovers at its global block offset: one consumer launch a
shard at finalize, and one a shard for each deferred payload.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.bucketing import BucketPlan
from repro_torch.core.config import CompressionConfig
from repro_torch.ft.failures import SwitchRetransmitPolicy
from repro_torch.net.switch import SwitchModel

from .fold import (FoldEngine, FoldError, FoldState, check_payload,
                   check_proposal)
from .membership import ClientPayload, RoundContract


# ----------------------------------------------------------------------
# Shard tiling
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardRange:
    """One shard's contiguous bucket range."""

    index: int
    start: int                       # first bucket
    count: int                       # buckets in this shard

    @property
    def stop(self) -> int:
        return self.start + self.count


def shard_ranges(n_buckets: int, n_shards: int) -> Tuple[ShardRange, ...]:
    """Balanced contiguous tiling of ``n_buckets`` into ``n_shards``
    ranges: the first ``n_buckets % n_shards`` shards take one extra
    bucket, and the ranges tile ``[0, n_buckets)`` exactly."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > n_buckets:
        raise ValueError(
            f"cannot split {n_buckets} buckets into {n_shards} shards "
            "(a shard needs at least one bucket)")
    base, extra = divmod(n_buckets, n_shards)
    ranges, start = [], 0
    for s in range(n_shards):
        count = base + (1 if s < extra else 0)
        ranges.append(ShardRange(index=s, start=start, count=count))
        start += count
    assert start == n_buckets
    return tuple(ranges)


def shard_contract(contract: RoundContract, rng: ShardRange,
                   plan: Optional[BucketPlan] = None) -> RoundContract:
    """The shard-view round contract: the same cohort and wire pricing,
    the shard's bucket count, and ``total_elems`` cut at the stream's
    true length (the ``BucketPlan.group_view`` rule, through it where
    the server's plan is at hand)."""
    if plan is not None:
        total = plan.group_view(rng.start, rng.count).total
    else:
        total = min(rng.count * contract.bucket_elems,
                    contract.total_elems - rng.start * contract.bucket_elems)
    return dataclasses.replace(contract, n_buckets=rng.count,
                               total_elems=total)


# ----------------------------------------------------------------------
# Payload striping
# ----------------------------------------------------------------------

def stripe_payload(payload: ClientPayload, contract: RoundContract,
                   ranges: Tuple[ShardRange, ...], blocks_per_bucket: int,
                   words_per_bucket: int) -> List[ClientPayload]:
    """One full-range payload as per-shard sub-payloads: zero-copy views
    of the sketch blocks, bitmap words and exponents of each shard's
    bucket range. Buckets hold whole sketch blocks and whole words, so
    the stripes are exact and their byte counts sum to
    ``payload.nbytes``."""
    wd = payload.index_words.reshape(contract.n_buckets, words_per_bucket)
    exps = payload.exponents
    out = []
    for r in ranges:
        b0, b1 = r.start * blocks_per_bucket, r.stop * blocks_per_bucket
        out.append(ClientPayload(
            client=payload.client, contract_id=payload.contract_id,
            sketch=payload.sketch[b0:b1],
            index_words=wd[r.start:r.stop].reshape(-1),
            exponents=None if exps is None else exps[r.start:r.stop]))
    return out


# ----------------------------------------------------------------------
# The combines: one pass a microbatch on the device
# ----------------------------------------------------------------------

def _fxp_batch_fold(acc_sk: torch.Tensor,
                    stack_sk: Sequence[torch.Tensor]) -> torch.Tensor:
    """The integer fold of ``k`` int32 payload sketches into the resident
    accumulator, in operand order. Integer adds are exact in any order
    once :func:`_fxp_partial_extrema` has shown every running partial
    inside int32."""
    out = acc_sk.clone()
    for s in stack_sk:
        out += s
    return out


def _fxp_partial_extrema(acc_sk: torch.Tensor,
                         stack_sk: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """True int64 running-partial extrema of ``[accumulator; payload 1;
    ...; payload k]``, the batched fold's operand order, for
    :meth:`repro_torch.net.switch.SwitchModel.check_batched_partial`:
    one int64 partial on the device, one host read."""
    part = acc_sk.to(torch.int64)
    ext = [torch.stack(torch.aminmax(part))]
    for s in stack_sk:
        part += s
        ext.append(torch.stack(torch.aminmax(part)))
    mins, maxs = torch.stack(ext).unbind(1)
    return int(maxs.max()), int(mins.min())


def _or_batch_fold(acc_wd: torch.Tensor,
                   stack_wd: Sequence[torch.Tensor]) -> torch.Tensor:
    """The bitmap fold: OR over the client axis (exact and commutative,
    so it folds eagerly on both wires)."""
    out = acc_wd.clone()
    for w in stack_wd:
        out |= w
    return out


def _f32_sorted_chain(stack: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
    """The canonical f32 reduction: a left fold of ``stack[idx[0]],
    stack[idx[1]], ...`` from a zero accumulator, ``idx`` the
    contributing cohort slots in ascending client-id order, so the
    association and operand order are the sequential engine's fed
    client-sorted arrivals."""
    acc = torch.zeros(stack.shape[1:], dtype=torch.float32, device=stack.device)
    for i in idx:
        acc += stack[i]
    return acc


# ----------------------------------------------------------------------
# State
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ShardedFoldState:
    """One sharded round's state: a :class:`FoldState` a shard plus the
    service-level roster and telemetry the server's close-out reads; the
    rollup properties expose a sequential :class:`FoldState`'s fields."""

    contract: RoundContract
    shard_states: List[FoldState]
    # staged (cohort_slot, sketch view, words view) a shard, drained by
    # each microbatch flush
    queues: List[list]
    # f32 only: a shard's cohort-slotted payload stack (slot = cohort
    # position, ascending client id), reduced at finalize in canonical
    # order; None on the fxp32 wire, which folds eagerly
    stacks: Optional[List[torch.Tensor]]
    exponents: Optional[torch.Tensor] = None   # sealed full-range vector
    exp_acc: Optional[torch.Tensor] = None     # running max during phase A
    exp_clients: Set[int] = dataclasses.field(default_factory=set)
    contributions: int = 0
    clients: Set[int] = dataclasses.field(default_factory=set)
    slots: List[int] = dataclasses.field(default_factory=list)
    rx_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    retransmits: int = 0
    priced_windows: int = 0          # straggler-pricing walk cursor
    flushes: int = 0
    fold_s: List[float] = dataclasses.field(default_factory=list)
    finalize_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def windows(self) -> int:
        return sum(st.windows for st in self.shard_states)

    @property
    def occupancy_peak(self) -> int:
        return max((st.occupancy_peak for st in self.shard_states),
                   default=0)


# ----------------------------------------------------------------------
# The service
# ----------------------------------------------------------------------

class ShardedFoldService:
    """Scale-out fold over one round: S shard engines and microbatched
    ingest, on ``device``. Drop-in for :class:`FoldEngine` (the same
    ``init_state`` / ``propose_exponents`` / ``seal_exponents`` / ``fold``
    / ``finalize`` / ``decode_payload`` surface), with its validation
    and straggler accounting, and through the canonical f32 order its
    folded bits for any arrival order and microbatch partition."""

    def __init__(self, contract: RoundContract, cfg: CompressionConfig,
                 n_shards: int = 1, batch_size: int = 8,
                 window_slots: Optional[int] = None,
                 plan: Optional[BucketPlan] = None, device="cuda"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.contract = contract
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = int(batch_size)
        self.ranges = shard_ranges(contract.n_buckets, n_shards)
        self.n_shards = len(self.ranges)
        # an engine a shard range, each with its own slot pool and
        # shard-view contract; equal-sized shards share one cached
        # recover pass, each at its global block offset
        self.engines = [
            FoldEngine(shard_contract(contract, r, plan), cfg,
                       window_slots=window_slots,
                       block_offset=r.start
                       * (contract.bucket_elems // cfg.block_elems),
                       device=self.device)
            for r in self.ranges]
        e0 = self.engines[0]
        self.window_slots = e0.window_slots
        self.fxp32 = e0.fxp32
        self.blocks_per_bucket = e0.blocks_per_bucket
        self.words_per_bucket = e0.words_per_bucket
        # the full-range geometry payloads arrive in
        self.n_blocks = contract.n_buckets * self.blocks_per_bucket
        self.sketch_shape = (self.n_blocks, cfg.rows, cfg.lanes)
        self.n_words = contract.n_buckets * self.words_per_bucket
        # a shard's batched slot pool: port 0 the resident accumulator,
        # port 1 the (batched) ingest stream
        self._pools = [SwitchModel(ports=2, slots=self.window_slots)
                       for _ in self.ranges] if self.fxp32 else None

    # ------------------------------------------------------------------

    def init_state(self) -> ShardedFoldState:
        shard_states = [eng.init_state() for eng in self.engines]
        stacks = None
        if not self.fxp32:
            W = self.contract.workers
            stacks = [torch.zeros((W,) + tuple(st.sketch.shape),
                                  dtype=torch.float32, device=self.device)
                      for st in shard_states]
        return ShardedFoldState(
            contract=self.contract, shard_states=shard_states,
            queues=[[] for _ in self.ranges], stacks=stacks,
            fold_s=[0.0] * self.n_shards,
            finalize_s=[0.0] * self.n_shards)

    # ---- phase A (fxp32): exponent negotiation -----------------------

    def propose_exponents(self, state: ShardedFoldState, client: int,
                          exponents: torch.Tensor,
                          contract_id: Optional[str] = None) -> None:
        """Max-fold one full-range exponent proposal (the sequential
        engine's semantics); the sealed vector is striped to the shards
        at :meth:`seal_exponents`."""
        if not self.fxp32:
            raise FoldError("the f32 wire negotiates no exponents")
        e = check_proposal(self.contract, state.exp_clients, state.exponents,
                           int(client), exponents, contract_id)
        e = e.to(self.device)
        state.exp_acc = e.clone() if state.exp_acc is None \
            else torch.maximum(state.exp_acc, e)
        state.exp_clients.add(int(client))

    def seal_exponents(self, state: ShardedFoldState) -> torch.Tensor:
        if not self.fxp32:
            raise FoldError("the f32 wire negotiates no exponents")
        if state.exp_acc is None:
            raise FoldError("no exponent proposals to seal")
        if state.exponents is None:
            state.exponents = state.exp_acc.clone()
            for r, st in zip(self.ranges, state.shard_states):
                st.exponents = state.exponents[r.start:r.stop].clone()
        return state.exponents

    # ---- phase B: batched ingest -------------------------------------

    def fold(self, state: ShardedFoldState, payload: ClientPayload,
             arrival_s: float = 0.0,
             policy: Optional[SwitchRetransmitPolicy] = None) -> int:
        """Ingest one payload: validate as the sequential engine does,
        price straggler retransmits over the full-range window walk, then
        stage the striped views on each shard's queue; a queue that
        reaches ``batch_size`` flushes through the combines. Returns the
        retransmit count; raises what :meth:`FoldEngine.fold` raises,
        with the state untouched on a straggler timeout."""
        client = check_payload(self.contract, state, payload,
                               self.sketch_shape, self.n_words, self.fxp32)
        nb = self.contract.n_buckets
        sk = payload.sketch.to(self.device)
        wd_b = payload.index_words.to(self.device).reshape(
            nb, self.words_per_bucket)
        row_bytes = (self.blocks_per_bucket * sk[0].numel() * sk.element_size()
                     + self.words_per_bucket * 4)
        # straggler pricing first (state untouched when the arrival blows
        # the budget): the sequential engine's full-range window walk,
        # each window booked on the shard owning its first bucket
        retries = 0
        rx = payload.nbytes
        if policy is not None and arrival_s > 0:
            cohort_port = self.contract.cohort.index(client)
            views = [policy.shard_view(r.index) for r in self.ranges]
            owner = np.searchsorted(
                [r.stop for r in self.ranges],
                np.arange(0, nb, self.window_slots), side="right")
            for w, w0 in enumerate(range(0, nb, self.window_slots)):
                w1 = min(w0 + self.window_slots, nb)
                r = views[int(owner[w])].on_window(
                    state.priced_windows + w, cohort_port,
                    float(arrival_s), (w1 - w0) * row_bytes)
                retries += r
                rx += r * (w1 - w0) * row_bytes
            state.priced_windows += w + 1

        # stage: zero-copy stripes on each shard's microbatch queue
        slot = self.contract.cohort.index(client)
        for r, st, q in zip(self.ranges, state.shard_states, state.queues):
            b0 = r.start * self.blocks_per_bucket
            b1 = r.stop * self.blocks_per_bucket
            q.append((slot, sk[b0:b1], wd_b[r.start:r.stop]))
            st.contributions += 1
            st.clients.add(client)
            slice_bytes = r.count * row_bytes
            if payload.exponents is not None:
                slice_bytes += r.count * payload.exponents.element_size()
            st.rx_bytes[client] = st.rx_bytes.get(client, 0) + slice_bytes
        state.contributions += 1
        state.clients.add(client)
        state.slots.append(slot)
        state.rx_bytes[client] = state.rx_bytes.get(client, 0) + rx
        state.retransmits += retries

        for s in range(self.n_shards):
            if len(state.queues[s]) >= self.batch_size:
                self._flush_shard(state, s)
        return retries

    def flush(self, state: ShardedFoldState) -> None:
        """Drain every shard's queue through the combines (the service
        flushes by itself at ``batch_size`` and at :meth:`finalize`)."""
        for s in range(self.n_shards):
            self._flush_shard(state, s)

    def _flush_shard(self, state: ShardedFoldState, s: int) -> None:
        q = state.queues[s]
        if not q:
            return
        state.queues[s] = []
        st = state.shard_states[s]
        rng = self.ranges[s]
        k = len(q)
        t0 = time.perf_counter()
        stack_wd = [e[2] for e in q]
        if self.fxp32:
            stack_sk = [e[1] for e in q]
            # the register-width check before committing anything: the
            # switch is the authority on the int32 bound, restated for
            # the batched partial (accumulator + k payloads)
            pmax, pmin = _fxp_partial_extrema(st.sketch, stack_sk)
            pool = self._pools[s]
            pool.reset()
            pool.check_batched_partial(pmax, pmin, ports=k + 1,
                                       window=st.windows)
            st.sketch = _fxp_batch_fold(st.sketch, stack_sk)
            st.index_words = _or_batch_fold(st.index_words, stack_wd)
            chunk_bytes = (self.blocks_per_bucket * st.sketch[0].numel() * 4
                           + self.words_per_bucket * 4)
            pool.account_batched_fold(
                n_chunks=rng.count, k_ports=k,
                port_bytes=rng.count * chunk_bytes, chunk_bytes=chunk_bytes)
            rep = pool.report()
            st.windows += rep["windows"]
            st.occupancy_peak = max(st.occupancy_peak, rep["occupancy_peak"])
        else:
            # f32: the bitmap ORs eagerly (exact); the sketches are staged
            # a cohort slot each and reduced at finalize in canonical
            # client-sorted order
            for slot, view, _ in q:
                state.stacks[s][slot].copy_(view)
            st.index_words = _or_batch_fold(st.index_words, stack_wd)
            for w0 in range(0, rng.count, self.window_slots):
                w1 = min(w0 + self.window_slots, rng.count)
                st.windows += 1
                st.occupancy_peak = max(st.occupancy_peak, w1 - w0)
        state.flushes += 1
        state.fold_s[s] += time.perf_counter() - t0

    # ---- recovery ----------------------------------------------------

    def finalize(self, state: ShardedFoldState) -> torch.Tensor:
        """Flush the remaining microbatches, reduce the f32 stacks in
        canonical order, recover each shard at its global block offset
        (one consumer launch a shard) and reassemble the ``(n_buckets,
        bucket_elems)`` stream."""
        if state.contributions == 0:
            raise FoldError("nothing folded — cannot finalize")
        self.flush(state)
        if not self.fxp32:
            order = sorted(state.slots)
            for s, st in enumerate(state.shard_states):
                t0 = time.perf_counter()
                st.sketch = _f32_sorted_chain(state.stacks[s], order)
                state.fold_s[s] += time.perf_counter() - t0
        rows = []
        for s, (eng, st) in enumerate(zip(self.engines, state.shard_states)):
            t0 = time.perf_counter()
            rows.append(eng.finalize(st))
            state.finalize_s[s] += time.perf_counter() - t0
        return torch.cat(rows, dim=0)

    def decode_payload(self, payload: ClientPayload) -> torch.Tensor:
        """Recover ONE payload on its own (the deferred-residual path):
        striped, each stripe peeled at its shard's global block offset,
        equal to the sequential engine's full-range decode (blocks peel
        independently)."""
        subs = stripe_payload(payload, self.contract, self.ranges,
                              self.blocks_per_bucket, self.words_per_bucket)
        return torch.cat([eng.decode_payload(sub)
                          for eng, sub in zip(self.engines, subs)], dim=0)

    # ---- telemetry ---------------------------------------------------

    def per_shard_report(self, state: ShardedFoldState) -> List[dict]:
        """A row a shard: bucket range, windows, occupancy, contributions,
        RX bytes, staged fold and finalize seconds (host clock)."""
        out = []
        for r, st, fold_s, fin_s in zip(self.ranges, state.shard_states,
                                        state.fold_s, state.finalize_s):
            out.append({
                "shard": r.index, "bucket_start": r.start,
                "buckets": r.count, "windows": st.windows,
                "occupancy_peak": st.occupancy_peak,
                "contributions": st.contributions,
                "rx_bytes": sum(st.rx_bytes.values()),
                "fold_s": fold_s, "finalize_s": fin_s})
        return out
