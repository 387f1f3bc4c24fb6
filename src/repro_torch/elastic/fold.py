"""Asynchronous sketch-fold engine.

The paper's wire format is homomorphic (sketches merge by addition,
bitmaps by OR), so an aggregation point can fold payloads one at a time,
as they arrive, without waiting for the cohort and without decoding:

- :meth:`FoldEngine.fold` is incremental: sketch add, bitmap OR and a
  contribution counter. The aggregation state is O(1) in the cohort
  size: one payload-shaped accumulator a round (the per-client RX byte
  counters are telemetry, not aggregation state).
- The fold walks the bucket stream in windows of at most
  ``window_slots`` buckets, as a switch streams its bounded slot pool.
  On the f32 wire a window is one add and one OR on the device. On the
  fxp32 wire each window's running partial (accumulator + payload) is
  computed in int64 on the device, its extrema are checked against the
  32-bit register width through
  :meth:`repro_torch.net.switch.SwitchModel.check_batched_partial` (one
  host read a fold), and only then is the int32 sum committed; the
  slot pool's windows and occupancy are booked through
  :meth:`~repro_torch.net.switch.SwitchModel.account_batched_fold`.
  Both equal the reference's numpy walk through ``SwitchModel.aggregate``
  window for window, the ``OverflowError`` and its text included.
- :meth:`FoldEngine.finalize` recovers the folded stream through one
  consumer call (``HomomorphicCompressor.recover``), the fxp32 dequant
  folded into it (``dequant=(per-block exponents, mantissa_bits)``): row
  2 of the kernel table on the f32 wire, row 4 on fxp32.

Payloads and the fold state are tensors on the engine's device; only
telemetry scalars cross to the host.

fxp32 rounds take two phases, as the ``compressed_innet`` wire does:
clients first propose per-bucket exponents (max-folds, in any order), the
server seals the elementwise max, and only then do clients quantize and
ship int32 sketches, so the folded integers are the same for any arrival
order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Set

import torch

from repro_torch.core.blocks import make_plan
from repro_torch.core.compressor import CompressedLeaf, HomomorphicCompressor
from repro_torch.core.config import CompressionConfig
from repro_torch.ft.failures import SwitchRetransmitPolicy
from repro_torch.net.switch import SwitchModel

from .membership import ClientPayload, RoundContract, StaleContractError


class FoldError(RuntimeError):
    """A payload that can never be folded into this round (duplicate
    client, unknown client, oversubscribed cohort, wrong geometry)."""


@functools.lru_cache(maxsize=128)
def _recover_fn(cfg: CompressionConfig, padded: int, wire_dtype: str,
                mantissa_bits: Optional[int]):
    """The round's recover pass, cached by contract geometry: ``(padded =
    n_buckets * bucket_elems, wire dtype, fxp32 mantissa budget)`` plus the
    full compression config, as the reference caches its compiled pass.
    Consecutive same-geometry rounds, and every equal-sized shard of a
    sharded round, share one entry; a renegotiated geometry or a
    re-priced mantissa budget (which changes the dequant scale) gets its
    own. The closure takes the folded sketch and words, the global
    ``block_offset`` of its first block, and on fxp32 the per-block
    exponents of the dequant."""
    comp = HomomorphicCompressor(cfg)

    def rec(sketch: torch.Tensor, words: torch.Tensor, block_offset: int = 0,
            block_exponents: Optional[torch.Tensor] = None) -> torch.Tensor:
        dequant = None
        if wire_dtype == "fxp32":
            if block_exponents is None:
                raise FoldError("the fxp32 recover needs per-block exponents")
            dequant = (block_exponents, mantissa_bits)
        return comp.recover(CompressedLeaf(sketch=sketch, index_words=words),
                            padded, block_offset=block_offset, dequant=dequant)
    return rec


@dataclasses.dataclass
class FoldState:
    """One round's aggregation state.

    ``sketch`` / ``index_words`` / ``exponents`` are payload-shaped
    tensors on the engine's device, O(1) in the cohort size. ``clients``
    and ``rx_bytes`` are per-client telemetry (who contributed, what the
    wire carried), not inputs to the aggregate.
    """

    contract: RoundContract
    sketch: torch.Tensor               # (n_blocks, rows, lanes) f32|int32
    index_words: torch.Tensor          # (n_buckets, words_per_bucket) int32
    exponents: Optional[torch.Tensor]  # sealed shared exps (fxp32)
    exp_acc: Optional[torch.Tensor]    # running max during phase A
    exp_clients: Set[int] = dataclasses.field(default_factory=set)
    contributions: int = 0
    clients: Set[int] = dataclasses.field(default_factory=set)
    rx_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    retransmits: int = 0
    windows: int = 0
    occupancy_peak: int = 0


def check_proposal(contract: RoundContract, exp_clients: Set[int],
                   sealed, client: int, exponents: torch.Tensor,
                   contract_id: Optional[str]) -> torch.Tensor:
    """Phase A's checks, shared by the sequential and the sharded fold:
    returns the proposal as an int32 tensor, or raises."""
    if contract_id is not None and contract_id != contract.contract_id:
        raise StaleContractError(
            f"proposal quotes {contract_id}, round is {contract.contract_id}")
    if client not in contract.cohort:
        raise FoldError(f"client {client} is not in this round's cohort")
    if client in exp_clients:
        raise FoldError(f"client {client} already proposed exponents")
    if sealed is not None:
        raise FoldError("exponents already sealed for this round")
    e = torch.as_tensor(exponents)
    if tuple(e.shape) != (contract.n_buckets,) or e.dtype != torch.int32:
        raise FoldError(
            f"exponent proposal must be ({contract.n_buckets},) int32, got "
            f"{tuple(e.shape)} {e.dtype}")
    return e


def check_payload(contract: RoundContract, state, payload: ClientPayload,
                  sketch_shape, n_words: int, fxp32: bool) -> int:
    """The fold's checks on one payload, shared by the sequential and the
    sharded fold: returns the client id, or raises what the reference
    raises (stale contract, unknown or duplicate client, a cohort
    oversubscribed, a wrong geometry, unsealed or foreign exponents)."""
    if payload.contract_id != contract.contract_id:
        raise StaleContractError(
            f"payload quotes {payload.contract_id}, round is "
            f"{contract.contract_id} — re-encode under the current contract")
    client = int(payload.client)
    if client not in contract.cohort:
        raise FoldError(f"client {client} is not in this round's cohort")
    if client in state.clients:
        raise FoldError(f"client {client} already contributed this round")
    if state.contributions >= contract.workers:
        raise FoldError(
            f"{state.contributions} payloads already folded on a wire sized "
            f"for {contract.workers} workers (overflow bound would not hold)")
    sk, wd = payload.sketch, payload.index_words
    want_dt = torch.int32 if fxp32 else torch.float32
    if tuple(sk.shape) != tuple(sketch_shape) or sk.dtype != want_dt:
        raise FoldError(f"sketch must be {tuple(sketch_shape)} {want_dt}, got "
                        f"{tuple(sk.shape)} {sk.dtype}")
    if tuple(wd.shape) != (n_words,) or wd.dtype != torch.int32:
        raise FoldError(f"index_words must be ({n_words},) int32, got "
                        f"{tuple(wd.shape)} {wd.dtype}")
    if fxp32:
        if state.exponents is None:
            raise StaleContractError(
                "fxp32 payload before the shared exponents were sealed — "
                "nothing to verify the quantization against")
        if payload.exponents is None or not torch.equal(
                payload.exponents.to(state.exponents.device),
                state.exponents):
            raise StaleContractError(
                f"client {client}'s payload was quantized against exponents "
                "that are not this round's sealed vector — re-encode")
    return client


class FoldEngine:
    """Per-round async fold over one :class:`RoundContract`, on
    ``device``."""

    def __init__(self, contract: RoundContract, cfg: CompressionConfig,
                 window_slots: Optional[int] = None,
                 block_offset: int = 0, device="cuda"):
        if cfg.wire_dtype != contract.wire_dtype:
            raise ValueError(
                f"config wire_dtype {cfg.wire_dtype!r} != contract "
                f"{contract.wire_dtype!r}")
        if contract.bucket_elems % cfg.block_elems:
            raise ValueError(
                f"bucket_elems {contract.bucket_elems} is not a whole "
                f"number of sketch blocks ({cfg.block_elems})")
        self.contract = contract
        self.cfg = cfg
        self.device = torch.device(device)
        self.window_slots = int(window_slots or cfg.switch_slots)
        if self.window_slots < 1:
            raise ValueError(
                f"window_slots must be >= 1, got {self.window_slots}")
        self.padded = contract.n_buckets * contract.bucket_elems
        self.blocks_per_bucket = contract.bucket_elems // cfg.block_elems
        self.n_blocks = make_plan(self.padded, cfg).nb
        self.sketch_shape = (self.n_blocks, cfg.rows, cfg.lanes)
        self.words_per_bucket = contract.bucket_elems // 32
        self.n_words = self.padded // 32
        self.fxp32 = contract.wire_dtype == "fxp32"
        # the slot pool: port 0 the resident accumulator, port 1 the
        # arriving payload; its register check and window accounting
        # apply to every fxp32 fold
        self._switch = SwitchModel(ports=2, slots=self.window_slots) \
            if self.fxp32 else None
        # hash-plan id of this engine's first block: 0 for a full-range
        # engine, a shard's global block position in a sharded round
        self.block_offset = int(block_offset)
        self._recover = _recover_fn(
            cfg, self.padded, contract.wire_dtype, contract.mantissa_bits)

    # ------------------------------------------------------------------

    def init_state(self) -> FoldState:
        dt = torch.int32 if self.fxp32 else torch.float32
        return FoldState(
            contract=self.contract,
            sketch=torch.zeros(self.sketch_shape, dtype=dt,
                               device=self.device),
            index_words=torch.zeros(
                (self.contract.n_buckets, self.words_per_bucket),
                dtype=torch.int32, device=self.device),
            exponents=None, exp_acc=None)

    # ---- phase A (fxp32): exponent negotiation -----------------------

    def propose_exponents(self, state: FoldState, client: int,
                          exponents: torch.Tensor,
                          contract_id: Optional[str] = None) -> None:
        """Max-fold one client's per-bucket exponent proposal (max is
        associative and commutative: any arrival order)."""
        if not self.fxp32:
            raise FoldError("the f32 wire negotiates no exponents")
        e = check_proposal(self.contract, state.exp_clients, state.exponents,
                           int(client), exponents, contract_id)
        e = e.to(self.device)
        state.exp_acc = e.clone() if state.exp_acc is None \
            else torch.maximum(state.exp_acc, e)
        state.exp_clients.add(int(client))

    def seal_exponents(self, state: FoldState) -> torch.Tensor:
        """Freeze the shared exponents (elementwise max of proposals);
        every payload must be quantized against exactly this vector."""
        if not self.fxp32:
            raise FoldError("the f32 wire negotiates no exponents")
        if state.exp_acc is None:
            raise FoldError("no exponent proposals to seal")
        if state.exponents is None:
            state.exponents = state.exp_acc.clone()
        return state.exponents

    # ---- phase B: the fold -------------------------------------------

    def fold(self, state: FoldState, payload: ClientPayload,
             arrival_s: float = 0.0,
             policy: Optional[SwitchRetransmitPolicy] = None) -> int:
        """Fold one payload into the round: sketch add, bitmap OR and the
        contribution counter. Returns the retransmit count the arrival
        cost under ``policy`` (0 without one).

        Raises :class:`StaleContractError` for a payload quoting another
        contract (or, on fxp32, quantized against exponents other than
        the sealed ones), :class:`repro_torch.ft.failures.SwitchStragglerTimeout`
        when the arrival delay blows the retransmit budget and
        ``OverflowError`` when an fxp32 window's running sum leaves
        int32; the state is untouched in all three cases.
        """
        client = check_payload(self.contract, state, payload,
                               self.sketch_shape, self.n_words, self.fxp32)
        nb = self.contract.n_buckets
        sk_b = payload.sketch.to(self.device).reshape(nb, -1)
        wd_b = payload.index_words.to(self.device).reshape(
            nb, self.words_per_bucket)
        acc_sk = state.sketch.reshape(nb, -1)
        acc_wd = state.index_words
        row_bytes = (sk_b.shape[1] * sk_b.element_size()
                     + self.words_per_bucket * 4)

        # straggler accounting first: the client is uniformly late, so
        # every window of its payload pays the same delay
        retries = 0
        rx = payload.nbytes
        if policy is not None and arrival_s > 0:
            cohort_port = self.contract.cohort.index(client)
            for w, w0 in enumerate(range(0, nb, self.window_slots)):
                w1 = min(w0 + self.window_slots, nb)
                r = policy.on_window(state.windows + w, cohort_port,
                                     float(arrival_s), (w1 - w0) * row_bytes)
                retries += r
                rx += r * (w1 - w0) * row_bytes

        windows = range(0, nb, self.window_slots)
        if self.fxp32:
            sw = self._switch
            sw.reset()
            out = torch.empty_like(acc_sk)
            ext = []
            for w0 in windows:
                part = acc_sk[w0:w0 + self.window_slots].to(torch.int64) \
                    + sk_b[w0:w0 + self.window_slots]
                ext.append(torch.stack(torch.aminmax(part)))
                out[w0:w0 + self.window_slots] = part
                del part
            for w, (mn, mx) in enumerate(torch.stack(ext).tolist()):
                sw.check_batched_partial(mx, mn, window=w)
            sw.account_batched_fold(n_chunks=nb, k_ports=1,
                                    port_bytes=nb * row_bytes,
                                    chunk_bytes=row_bytes)
            state.sketch = out.reshape(self.sketch_shape)
            state.index_words = acc_wd | wd_b
            rep = sw.report()
            state.windows += rep["windows"]
            state.occupancy_peak = max(state.occupancy_peak,
                                       rep["occupancy_peak"])
        else:
            # the idealized float tier: the same windowed walk, f32 adds
            # (a real switch cannot: see net/fixedpoint.py)
            for w0 in windows:
                w1 = min(w0 + self.window_slots, nb)
                acc_sk[w0:w1] += sk_b[w0:w1]
                acc_wd[w0:w1] |= wd_b[w0:w1]
                state.windows += 1
                state.occupancy_peak = max(state.occupancy_peak, w1 - w0)

        state.contributions += 1
        state.clients.add(client)
        state.rx_bytes[client] = state.rx_bytes.get(client, 0) + rx
        state.retransmits += retries
        return retries

    # ---- recovery ----------------------------------------------------

    def _block_exponents(self, exponents) -> torch.Tensor:
        return exponents.to(self.device).repeat_interleave(
            self.blocks_per_bucket)

    def finalize(self, state: FoldState) -> torch.Tensor:
        """Recover the folded sum stream with one consumer call, the fxp32
        dequant folded in. Returns ``(n_buckets, bucket_elems)`` f32."""
        if state.contributions == 0:
            raise FoldError("nothing folded — cannot finalize")
        exps = None
        if self.fxp32:
            if state.exponents is None:
                raise FoldError("fxp32 round closed without sealed exponents")
            exps = self._block_exponents(state.exponents)
        rec = self._recover(state.sketch, state.index_words.reshape(-1),
                            self.block_offset, exps)
        return rec.reshape(self.contract.n_buckets, self.contract.bucket_elems)

    def decode_payload(self, payload: ClientPayload) -> torch.Tensor:
        """Recover ONE payload on its own (a late arrival that missed the
        round is decoded and carried into the next round's residual
        rather than dropped); its own sealed exponents make the
        single-payload dequant exact to the documented roundtrip."""
        exps = None
        if self.fxp32:
            if payload.exponents is None:
                raise FoldError("fxp32 payload without exponents")
            exps = self._block_exponents(payload.exponents)
        rec = self._recover(payload.sketch.to(self.device),
                            payload.index_words.to(self.device).reshape(-1),
                            self.block_offset, exps)
        return rec.reshape(self.contract.n_buckets, self.contract.bucket_elems)
