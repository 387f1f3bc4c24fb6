"""Cost model for the ``auto`` strategy: the *controller* half of the
plan/execute split (the reference's ``repro.core.costmodel``).

The controller decides, per bucket, which wire
(:data:`repro_torch.core.wireplan.WIRES`) ships it cheapest, from three
inputs:

1. **The analytic wire model**: :meth:`CompressionConfig.strategy_wire_bytes`
   turned into seconds with the ``auto_link_gbps`` / ``auto_codec_gbps``
   bandwidth priors, plus a codec term of as many stream passes as the
   codec makes on the device the step runs on
   (:func:`repro_torch.kernels.ops.wire_codec_passes`: one each way for
   the fused kernels on the card, two or three for the composed plain
   versions). It seeds the first plan (:func:`analytic_plan`). The
   config's priors are the reference's defaults; measured ones for the
   card come from :func:`priors_from_codec_report`.
2. **Measured step walls**, observed on the host while the controller
   probes each wire with a uniform plan; they override the priors as
   they arrive.
3. **Measured occupancy**: each bucket's non-zero share of the
   aggregated stream (``AggregationState.telemetry``). A bucket above
   ``auto_occupancy_margin`` of the peel capacity would recover lossily,
   so the compressed wires are infeasible for it and it is planned
   dense: what makes plans mixed.

Plans change only every ``cfg.replan_every`` steps, and walls fold in
through an EWMA. After the wire probes one chunk-grid probe runs on the
winning wire (its finest aligned ``stream_chunks`` against the config's
grid), then the decided plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.kernels.ops import wire_codec_passes
from .bucketing import BucketPlan
from .config import CompressionConfig
from .wireplan import WIRES, WirePlan, plan_from_assignments, uniform_plan

COMPRESSED_WIRES = tuple(w for w in WIRES if w != "dense")


def priors_from_codec_report(report: Dict[str, Any]) -> Dict[str, float]:
    """Turn a codec report into ``auto_*`` prior overrides
    (``dataclasses.replace(cfg, **priors)``), with the reference's keys:
    the codec prior is ``achieved_codec_bytes_per_s`` (the measured
    streaming rate of the producer and consumer), else
    ``hbm_bytes_per_s`` (the device memory bound); the link prior is
    ``ici_bytes_per_s`` (the rate of the link the wires cross). Where
    the reference falls back to a TPU constant, this raises a
    ``ValueError`` naming the missing key."""
    codec_bps = report.get("achieved_codec_bytes_per_s")
    if not codec_bps:
        if "hbm_bytes_per_s" not in report:
            raise ValueError(
                "codec report lacks 'achieved_codec_bytes_per_s' and "
                "'hbm_bytes_per_s': no codec rate to take")
        codec_bps = report["hbm_bytes_per_s"]
    if "ici_bytes_per_s" not in report:
        raise ValueError("codec report lacks 'ici_bytes_per_s': no link "
                         "rate to take")
    return {"auto_codec_gbps": float(codec_bps) * 8 / 1e9,
            "auto_link_gbps": float(report["ici_bytes_per_s"]) * 8 / 1e9}


def fixed_wires() -> Tuple[str, ...]:
    """The controller's search space: every fixed strategy in the
    aggregator registry (enumerated from it, and checked against
    :data:`WIRES`)."""
    from .aggregators import AGGREGATORS  # late: aggregators imports us
    wires = tuple(w for w in AGGREGATORS if w != "auto")
    if set(wires) != set(WIRES):
        raise AssertionError(
            f"registry {sorted(wires)} out of sync with WIRES {WIRES}")
    return wires


# ----------------------------------------------------------------------
# Analytic costs (the no-telemetry prior)
# ----------------------------------------------------------------------

def analytic_bucket_costs(plan: BucketPlan, cfg: CompressionConfig,
                          workers: int, grad_bytes_per_elem: int = 4,
                          device="cuda") -> Dict[str, float]:
    """Per-bucket cost estimate (seconds) of each wire: the whole
    bucket-padded stream's ``link_bytes`` spread evenly over its buckets
    over the link prior, plus the codec's passes over the bucket's f32
    bytes on ``device`` over the codec prior, the consumer's scaled by
    each wire's share (the reduce-scatter wire peels 1/W a rank). Wire
    and codec in series: what overlap wins, the probes measure."""
    n = plan.n_buckets * plan.bucket_elems
    acc = cfg.strategy_wire_bytes(n, workers,
                                  grad_bytes_per_elem=grad_bytes_per_elem)
    link_bw = cfg.auto_link_gbps * 1e9 / 8
    codec_bw = cfg.auto_codec_gbps * 1e9 / 8
    t_pass = plan.bucket_elems * 4 / codec_bw
    nb = plan.n_buckets
    p = wire_codec_passes(cfg, device=device)
    pq = wire_codec_passes(cfg, quantized=cfg.wire_dtype == "fxp32",
                           device=device)

    def link_t(entry) -> float:
        return entry["link_bytes"] / nb / link_bw

    rs = acc["compressed_rs_native"] or acc["compressed_rs_emulated"]
    return {
        "dense": link_t(acc["dense"]),
        "compressed": link_t(acc["compressed"])
        + (p["producer"] + p["consumer"]) * t_pass,
        "compressed_rs": link_t(rs)
        + (p["producer"] + p["consumer"] / workers) * t_pass,
        "compressed_innet": link_t(acc["compressed_innet"])
        + (pq["producer"] + pq["consumer"]) * t_pass,
    }


def analytic_alltoall_costs(n: int, cfg: CompressionConfig,
                            workers: int, grad_bytes_per_elem: int = 4,
                            device="cuda") -> Dict[str, float]:
    """Per-exchange cost (seconds) of the permute-pattern wires, the
    all-to-all analogue of :func:`analytic_bucket_costs`: ``n`` is a
    rank's stacked W-lane payload, the link ships ``(W-1)/W x`` of it,
    and the codec encodes the whole lane stack but peels only the rank's
    merged 1/W lane; the dense exchange has no codec term."""
    acc = cfg.strategy_wire_bytes(n, workers,
                                  grad_bytes_per_elem=grad_bytes_per_elem)
    link_bw = cfg.auto_link_gbps * 1e9 / 8
    codec_bw = cfg.auto_codec_gbps * 1e9 / 8
    p = wire_codec_passes(cfg, device=device)
    comp = acc["compressed_alltoall"]
    stack_elems = comp["n_lane_buckets"] * workers * \
        cfg.bucket_elems_for(-(-n // workers))
    t_pass = stack_elems * 4 / codec_bw
    return {
        "dense": acc["dense_alltoall"]["link_bytes"] / link_bw,
        "compressed": comp["link_bytes"] / link_bw
        + (p["producer"] + p["consumer"] / workers) * t_pass,
    }


def analytic_plan(plan: BucketPlan, cfg: CompressionConfig,
                  workers: int, grad_bytes_per_elem: int = 4,
                  device="cuda") -> WirePlan:
    """The plan ``auto`` executes before its controller has observed
    anything: the cheapest wire of the analytic model, uniform (its costs
    are the same for every bucket)."""
    costs = analytic_bucket_costs(plan, cfg, workers,
                                  grad_bytes_per_elem=grad_bytes_per_elem,
                                  device=device)
    wire = min(fixed_wires(), key=lambda w: costs[w])
    return uniform_plan(plan.n_buckets, wire)


def occupancy_feasible(occ: float, cfg: CompressionConfig) -> bool:
    """Can a bucket with non-zero share ``occ`` still peel exactly? The
    capacity is ``peel_capacity`` a block, kept under by
    ``auto_occupancy_margin``."""
    cap_frac = cfg.peel_capacity / cfg.block_elems
    return occ <= cfg.auto_occupancy_margin * cap_frac


# ----------------------------------------------------------------------
# The online controller
# ----------------------------------------------------------------------

def _finest_chunks(wire: str, n_buckets: int, workers: int,
                   cfg: CompressionConfig) -> Optional[int]:
    """Finest valid ``stream_chunks`` for a uniform plan on ``wire``
    (None: the wire has no chunk grid to tune)."""
    if wire == "dense" or cfg.index != "bitmap":
        return None
    if wire == "compressed_rs" and workers > 1:
        return -(-n_buckets // workers)   # a chunk a per-rank bucket run
    if wire == "compressed_innet":
        return -(-n_buckets // cfg.switch_slots)
    return n_buckets


@dataclasses.dataclass
class AutoWireController:
    """Host-side wire planner for the ``auto`` strategy. Drive it from
    the training loop::

        ctl = AutoWireController(plan, cfg, workers=W, device="cuda")
        for step in range(...):
            wplan = ctl.plan(step)          # static in a replan window
            agg = dataclasses.replace(agg, wire_plan=wplan)
            ... run the step, time it ...
            ctl.observe(wall_s, telemetry)  # wall + bucket occupancy

    Probe schedule: one replan window a fixed wire (uniform plans,
    cheapest first), then one window on the winner's finest chunk grid,
    then the decided (possibly mixed) plan, refreshed every
    ``replan_every`` steps from the latest EWMAs. ``device`` is where
    the step runs (the codec term's pass counts)."""

    bucket_plan: BucketPlan
    cfg: CompressionConfig
    workers: int
    grad_bytes_per_elem: int = 4
    ewma: float = 0.5           # weight of the newest wall observation
    warmup_steps: int = 1       # a window's first steps left out of the
                                # EWMA (the first pays the warm-up)
    device: Any = "cuda"

    def __post_init__(self):
        self.wires = fixed_wires()
        self.analytic = analytic_bucket_costs(
            self.bucket_plan, self.cfg, self.workers,
            grad_bytes_per_elem=self.grad_bytes_per_elem, device=self.device)
        self._probe_queue: List[Tuple[str, Optional[int]]] = [
            (w, None) for w in sorted(self.wires,
                                      key=lambda w: self.analytic[w])]
        self._walls: Dict[Tuple[str, Optional[int]], float] = {}
        self._occupancy: Optional[List[float]] = None
        self._chunk_probed = False
        self._current: WirePlan = self._start_window(*self._probe_queue[0])
        self._window_steps = 0

    # -- observation ---------------------------------------------------

    def observe(self, wall_s: float, telemetry: Any = None) -> None:
        """Fold one step's wall (seconds) and telemetry (the
        ``AggregationState.telemetry`` dict, tensors or lists) in."""
        self._window_steps += 1
        if self._window_steps > self.warmup_steps:
            key = self._plan_key(self._current)
            if key is not None:
                prev = self._walls.get(key)
                self._walls[key] = wall_s if prev is None else \
                    (1 - self.ewma) * prev + self.ewma * wall_s
        if telemetry is not None and "bucket_occupancy" in telemetry:
            occ = [float(v) for v in telemetry["bucket_occupancy"]]
            if self._occupancy is None:
                self._occupancy = occ
            else:
                self._occupancy = [
                    (1 - self.ewma) * o + self.ewma * n
                    for o, n in zip(self._occupancy, occ)]

    def _plan_key(self, plan: WirePlan) -> Optional[Tuple[str, Optional[int]]]:
        """A plan's wall is attributable to one wire only when the plan
        is uniform; a mixed plan's trains nothing."""
        w = plan.uniform_wire
        if w is None:
            return None
        return (w, plan.groups[0].stream_chunks)

    # -- planning ------------------------------------------------------

    def plan(self, step: int) -> WirePlan:
        """The plan to execute at ``step``: it changes only on
        ``cfg.replan_every`` boundaries; step 0 runs the first probe."""
        if step == 0 or step % self.cfg.replan_every:
            return self._current
        nxt = self._next_window()
        if nxt != self._current:
            self._current = nxt
            self._window_steps = 0
        return self._current

    def _start_window(self, wire: str, chunks: Optional[int]) -> WirePlan:
        return uniform_plan(self.bucket_plan.n_buckets, wire,
                            stream_chunks=chunks)

    def _next_window(self) -> WirePlan:
        key = self._plan_key(self._current)
        if self._probe_queue and key == self._probe_queue[0]:
            self._probe_queue.pop(0)
        if self._probe_queue:
            return self._start_window(*self._probe_queue[0])
        # the wires probed: one chunk-grid probe on the measured winner
        if not self._chunk_probed:
            self._chunk_probed = True
            w = min(self.wires, key=lambda w: self._wire_wall(w))
            fine = _finest_chunks(w, self.bucket_plan.n_buckets,
                                  self.workers, self.cfg)
            if fine is not None and fine > 1 \
                    and (w, fine) not in self._walls:
                self._probe_queue.append((w, fine))
                return self._start_window(w, fine)
        return self._decide()

    def _wire_wall(self, wire: str) -> float:
        """The best measured wall of a wire (on any probed grid), else
        its analytic whole-stream estimate."""
        walls = [v for (w, _), v in self._walls.items() if w == wire]
        if walls:
            return min(walls)
        return self.analytic[wire] * self.bucket_plan.n_buckets

    def _bucket_cost(self, wire: str, bucket: int) -> float:
        if wire in COMPRESSED_WIRES and self._occupancy is not None \
                and not occupancy_feasible(self._occupancy[bucket],
                                           self.cfg):
            return math.inf
        return self._wire_wall(wire) / self.bucket_plan.n_buckets

    def _best_chunks(self, wire: str) -> Optional[int]:
        cands = [(v, c) for (w, c), v in self._walls.items() if w == wire]
        if not cands:
            return None
        return min(cands)[1]

    def _decide(self) -> WirePlan:
        nb = self.bucket_plan.n_buckets
        assign = [min(self.wires,
                      key=lambda w: (self._bucket_cost(w, b),
                                     self.wires.index(w)))
                  for b in range(nb)]
        decided = plan_from_assignments(assign)
        # a single-wire plan takes the measured best chunk grid; a mixed
        # plan's groups keep the config's (per-group grids were never
        # probed)
        w = decided.uniform_wire
        if w is not None:
            return uniform_plan(nb, w, stream_chunks=self._best_chunks(w))
        return decided

    # -- reporting -----------------------------------------------------

    def decision_trace(self) -> Dict[str, Any]:
        """The controller's state: the current plan's groups and the cost
        inputs behind them (JSON-serialisable)."""
        occ = self._occupancy
        return {
            "plan": [{
                "start": g.start,
                "n_buckets": g.n_buckets,
                "wire": g.wire,
                "stream_chunks": g.stream_chunks,
            } for g in self._current.groups],
            "probing": bool(self._probe_queue),
            "measured_wall_s": {
                f"{w}" + (f"/c{c}" if c is not None else ""):
                    round(v, 6)
                for (w, c), v in sorted(
                    self._walls.items(),
                    key=lambda kv: (kv[0][0], kv[0][1] or 0))},
            "analytic_bucket_cost_s": {
                w: round(v, 9) for w, v in self.analytic.items()},
            "codec_passes": wire_codec_passes(
                self.cfg, quantized=self.cfg.wire_dtype == "fxp32",
                device=self.device),
            "occupancy": None if occ is None else {
                "min": round(min(occ), 4),
                "max": round(max(occ), 4),
                "capacity_frac": round(
                    self.cfg.peel_capacity / self.cfg.block_elems, 4),
                "margin": self.cfg.auto_occupancy_margin,
            },
        }
