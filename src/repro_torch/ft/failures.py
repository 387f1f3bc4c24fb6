"""Fault tolerance: failure injection and detection, straggler
mitigation, the switch's retransmit policy and elastic sizing.

The reference's ``repro.ft.failures`` ported as it is (pure Python and
numpy, no tensors):

- :class:`FailureSimulator` injects seeded per-step failures
  (:class:`InjectedFailure`) and the elastic tier's deterministic client
  arrival delays (:meth:`FailureSimulator.client_delay`), with the
  reference's draws (``np.random.SeedSequence([seed, step, 0xFA11])``);
- :class:`RecoveryPolicy` and :class:`StragglerMonitor` (a per-step
  wall-time EMA that flags outliers);
- :class:`SwitchRetransmitPolicy` is what
  :class:`repro_torch.net.switch.SwitchModel` applies per aggregation
  window, :class:`SwitchStragglerTimeout` what it raises past the
  retransmit budget, and :meth:`SwitchRetransmitPolicy.shard_view` the
  per-shard view the elastic service's sharded fold prices through;
- :func:`elastic_data_parallel` is the sizing rule of the data axis for
  a surviving device count, and :func:`elastic_mesh` the ``(data,
  model)`` mesh shape it gives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np


# ----------------------------------------------------------------------
# Failure injection + recovery policy
# ----------------------------------------------------------------------

class InjectedFailure(RuntimeError):
    def __init__(self, step: int, node: int):
        super().__init__(f"injected node failure at step {step} (node {node})")
        self.step = step
        self.node = node


@dataclasses.dataclass
class FailureSimulator:
    """Bernoulli per-step failure with a deterministic seed.

    Also injects deterministic arrival delays for the elastic tier:
    ``straggle_s`` marks clients late by a fixed amount every round,
    ``straggle_at`` one (round, client) arrival; :meth:`client_delay` is
    what the elastic launcher adds to each payload's simulated
    arrival time to exercise the quorum/deadline and deferred-residual
    paths.
    """
    p_fail: float = 0.0
    n_nodes: int = 1
    seed: int = 0
    fail_at_steps: Tuple[int, ...] = ()   # deterministic injections
    straggle_s: Tuple[Tuple[int, float], ...] = ()
                                          # (client, delay_s) every round
    straggle_at: Tuple[Tuple[int, int, float], ...] = ()
                                          # (round, client, delay_s) once
    _fired: set = dataclasses.field(default_factory=set, init=False)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)      # a crashed node stays replaced
            raise InjectedFailure(step, node=step % max(self.n_nodes, 1))
        if self.p_fail > 0:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 0xFA11]))
            if rng.random() < self.p_fail:
                raise InjectedFailure(step, node=int(rng.integers(self.n_nodes)))

    def client_delay(self, round_id: int, client: int) -> float:
        """Injected extra arrival delay for one client in one round
        (seconds; 0.0 when the client is healthy)."""
        delay = 0.0
        for c, d in self.straggle_s:
            if c == client:
                delay += d
        for r, c, d in self.straggle_at:
            if r == round_id and c == client:
                delay += d
        return delay


@dataclasses.dataclass
class RecoveryPolicy:
    """What to do when a failure is detected."""
    max_restarts: int = 3
    # elastic: continue with fewer devices (shrink the data axis) instead
    # of waiting for the node to come back
    elastic: bool = True


# ----------------------------------------------------------------------
# Straggler mitigation
# ----------------------------------------------------------------------

@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-time EMA; flags outliers (detects and accounts; the
    re-dispatch to a spare is a deployment's decision)."""
    ema_decay: float = 0.9
    threshold: float = 2.5           # x EMA counts as straggling
    warmup: int = 3

    _ema: float = dataclasses.field(default=0.0, init=False)
    _n: int = dataclasses.field(default=0, init=False)
    events: List[dict] = dataclasses.field(default_factory=list, init=False)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._ema = dt if self._ema == 0 else \
                (self.ema_decay * self._ema + (1 - self.ema_decay) * dt)
            return False
        is_straggler = dt > self.threshold * self._ema
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ema": self._ema,
                                "action": "flag+rebalance"})
        else:
            self._ema = self.ema_decay * self._ema + (1 - self.ema_decay) * dt
        return is_straggler


# ----------------------------------------------------------------------
# The in-network tier: straggler handling at the switch
# ----------------------------------------------------------------------

class SwitchStragglerTimeout(RuntimeError):
    """A child port kept missing the switch's aggregation window past the
    retransmit budget: the coordinator-level analogue of a dropped
    worker (the caller escalates to its recovery policy)."""

    def __init__(self, port: int, window: int, delay_s: float,
                 max_retries: int):
        super().__init__(
            f"switch port {port} missed aggregation window {window} "
            f"({delay_s:.3f}s late) beyond {max_retries} retransmits")
        self.port = port
        self.window = window
        self.delay_s = delay_s


@dataclasses.dataclass
class SwitchRetransmitPolicy:
    """Timeout/retransmit policy a switch applies per aggregation window.

    Each streaming window holds its slot pool open until every child
    port's chunk arrives, so a straggling worker stalls the window; after
    each ``timeout_s`` the switch re-requests the chunk. A chunk arriving
    ``delay_s`` late costs ``ceil(delay_s / timeout_s) - 1`` retransmits,
    and a port later than ``max_retries + 1`` timeout periods within one
    window is declared failed (:class:`SwitchStragglerTimeout`). A port
    that is late but inside the budget keeps paying retransmits every
    window; the events recorded here are what a coordinator would read.
    """

    timeout_s: float = 0.05
    max_retries: int = 2
    events: List[dict] = dataclasses.field(default_factory=list, init=False)

    def __post_init__(self):
        if self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")

    def retries_for(self, delay_s: float) -> int:
        """Retransmits a chunk arriving ``delay_s`` after the window
        opens would cost (0 when it makes the first timeout)."""
        if delay_s <= self.timeout_s:
            return 0
        return math.ceil(delay_s / self.timeout_s) - 1

    def on_window(self, window: int, port: int, delay_s: float,
                  chunk_bytes: int, shard: Optional[int] = None) -> int:
        """Account one (port, window) arrival; returns the retransmit
        count, raising :class:`SwitchStragglerTimeout` past the budget.
        ``shard``: optional shard tag recorded on the event (set by
        :class:`ShardRetransmitView`)."""
        retries = self.retries_for(delay_s)
        if retries > self.max_retries:
            raise SwitchStragglerTimeout(port, window, delay_s,
                                         self.max_retries)
        if retries:
            ev = {
                "window": window, "port": port, "delay_s": delay_s,
                "retries": retries, "retransmit_bytes": retries * chunk_bytes,
                "action": "timeout+retransmit"}
            if shard is not None:
                ev["shard"] = shard
            self.events.append(ev)
        return retries

    def shard_view(self, shard: int,
                   port_stride: int = 1 << 16) -> "ShardRetransmitView":
        """A per-shard view of this (shared) policy for the sharded fold:
        shard ``s``'s port ``p`` books as ``s * port_stride + p``, so the
        shards' slot pools never collide in the shared event log, and
        events carry a ``shard`` tag. The retry budget and timeout stay
        global: a client that is late is late on every shard's port."""
        return ShardRetransmitView(policy=self, shard=int(shard),
                                   port_stride=int(port_stride))


@dataclasses.dataclass(frozen=True)
class ShardRetransmitView:
    """Shard-scoped facade over a shared :class:`SwitchRetransmitPolicy`
    (see :meth:`SwitchRetransmitPolicy.shard_view`)."""

    policy: SwitchRetransmitPolicy
    shard: int
    port_stride: int = 1 << 16

    @property
    def timeout_s(self) -> float:
        return self.policy.timeout_s

    @property
    def max_retries(self) -> int:
        return self.policy.max_retries

    def retries_for(self, delay_s: float) -> int:
        return self.policy.retries_for(delay_s)

    def on_window(self, window: int, port: int, delay_s: float,
                  chunk_bytes: int) -> int:
        return self.policy.on_window(
            window, self.shard * self.port_stride + port, delay_s,
            chunk_bytes, shard=self.shard)


# ----------------------------------------------------------------------
# Elastic re-meshing
# ----------------------------------------------------------------------

def elastic_data_parallel(available_devices: int,
                          model_parallel: int) -> int:
    """The data-axis size for a surviving device count: the model axis
    stays whole (parameter shards must stay complete) and the data axis
    shrinks to the largest power of two that fits, which keeps
    collectives regular."""
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel}")
    if available_devices < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{available_devices} devices")
    data = available_devices // model_parallel
    while data & (data - 1):
        data -= 1
    return data


def elastic_mesh(available_devices: int, model_parallel: int,
                 axis_names=("data", "model")):
    """The largest ``(data, model)`` mesh fitting the surviving devices,
    sized by :func:`elastic_data_parallel`, as its shape
    (:class:`repro_torch.launch.mesh.MeshShape`): the port places ranks,
    not devices, so the grid a restart spawns is this shape's
    (``make_host_mesh(model_parallel)`` over ``size`` ranks), and the
    layout-free checkpoint restores onto it."""
    from repro_torch.launch.mesh import MeshShape
    data = elastic_data_parallel(available_devices, model_parallel)
    return MeshShape(dict(zip(axis_names, (data, model_parallel))))
