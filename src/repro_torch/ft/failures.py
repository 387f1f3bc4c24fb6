"""Straggler handling at the in-network aggregation switch.

The reference's ``repro.ft.failures`` switch policy, ported as it is
(pure Python): :class:`SwitchRetransmitPolicy` is what
:class:`repro_torch.net.switch.SwitchModel` applies per aggregation
window, and :class:`SwitchStragglerTimeout` what it raises past the
retransmit budget. The per-shard view of the policy belongs to the
elastic service's sharded fold and comes with that slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List


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
                  chunk_bytes: int) -> int:
        """Account one (port, window) arrival; returns the retransmit
        count, raising :class:`SwitchStragglerTimeout` past the budget."""
        retries = self.retries_for(delay_s)
        if retries > self.max_retries:
            raise SwitchStragglerTimeout(port, window, delay_s,
                                         self.max_retries)
        if retries:
            self.events.append({
                "window": window, "port": port, "delay_s": delay_s,
                "retries": retries, "retransmit_bytes": retries * chunk_bytes,
                "action": "timeout+retransmit"})
        return retries
