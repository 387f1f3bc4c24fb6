"""Emulated programmable aggregation switch (numpy, host side).

:class:`SwitchModel` is the device model of the in-network tier, the
reference's ``repro.net.switch`` ported as it is: one switch with
``ports`` children, a bounded pool of ``slots`` SRAM aggregation slots,
and the two operations a programmable data plane offers, 32-bit integer
add and 32-bit OR.

- **Bounded SRAM, streaming windows.** The sketch stream arrives as
  per-bucket chunks; the switch opens a window of at most ``slots``
  chunks, sums every port's contribution into the resident slots, emits
  the reduced chunks upstream and recycles the slots for the next window.
  :func:`repro_torch.net.topology.tree_all_reduce` with ``window_slots``
  reduces the same windows on the device, and
  :meth:`repro_torch.net.topology.Topology.window_profile` accounts them.
- **Integer semantics only.** int32 sketch chunks, uint32 bitmap chunks;
  float chunks raise ``TypeError``, and a window whose running sum leaves
  int32 raises ``OverflowError`` (unreachable for a stream quantized by
  :class:`repro_torch.net.fixedpoint.FixedPointWire` for this port
  count). The port's tensors carry the bitmap's uint32 bits in int32
  words: view them as ``np.uint32`` before handing them over.
- **Per-port counters.** RX bytes and chunks per child port, TX bytes of
  the broadcast back down, and the root link's bytes.
- **Straggler timeout/retransmit.** Per-chunk arrival delays are checked
  against a :class:`repro_torch.ft.failures.SwitchRetransmitPolicy`.

Port p is the worker of rank-major index p over the levels, as in the
tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.ft.failures import SwitchRetransmitPolicy

_INT32_MAX = np.int64(2**31 - 1)
_INT32_MIN = np.int64(-(2**31))


@dataclasses.dataclass
class PortCounters:
    """Per-child-port byte/chunk accounting (one aggregation run)."""
    rx_bytes: int = 0
    tx_bytes: int = 0
    rx_chunks: int = 0
    retransmits: int = 0


@dataclasses.dataclass
class SwitchModel:
    """One emulated aggregation switch (see module docstring)."""

    ports: int
    slots: int
    policy: Optional[SwitchRetransmitPolicy] = None

    def __post_init__(self):
        if self.ports < 1:
            raise ValueError(f"ports must be >= 1, got {self.ports}")
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        self.reset()

    def reset(self) -> None:
        self.port_counters: List[PortCounters] = [
            PortCounters() for _ in range(self.ports)]
        self.root_tx_bytes = 0      # aggregated stream up the root link
        self.root_rx_bytes = 0      # broadcast coming back down it
        self.windows = 0
        self.occupancy_peak = 0
        # per window, in stream order: resident chunks and root-link bytes
        self.window_chunks: List[int] = []
        self.window_root_bytes: List[int] = []
        if self.policy is not None:
            self.policy.events.clear()  # counters and events are per run

    @staticmethod
    def _check_chunks(name: str, a: np.ndarray, dtype, ports: int):
        if a.dtype != dtype:
            raise TypeError(
                f"{name} chunks must be {np.dtype(dtype).name} (a "
                f"programmable switch has 32-bit integer registers "
                f"only), got {a.dtype}; quantize the sketch through "
                "repro_torch.net.fixedpoint.FixedPointWire")
        if a.ndim < 2 or a.shape[0] != ports:
            raise ValueError(
                f"{name} chunks must be (ports={ports}, n_chunks, ...), "
                f"got shape {a.shape}")

    def aggregate(self, sketch_chunks, bitmap_chunks, arrival_s=None,
                  metadata_bytes: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Stream ``(ports, n_chunks, ...)`` chunk arrays through the
        slot pool; returns the (int-summed sketch, OR'd bitmap) chunks.

        ``arrival_s``: optional per-port arrival delays in seconds,
        ``(ports,)`` or ``(ports, n_chunks)``, from each window's open,
        fed to the straggler policy when one is set.
        ``metadata_bytes``: per-stream metadata riding the same links once
        per direction, such as the fxp32 exponents (4 bytes a bucket),
        counted on every port and on the root link.
        """
        sk = np.asarray(sketch_chunks)
        bm = np.asarray(bitmap_chunks)
        self._check_chunks("sketch", sk, np.int32, self.ports)
        self._check_chunks("bitmap", bm, np.uint32, self.ports)
        if sk.shape[1] != bm.shape[1]:
            raise ValueError(
                f"sketch has {sk.shape[1]} chunks, bitmap {bm.shape[1]}")
        n_chunks = sk.shape[1]
        if arrival_s is not None:
            arrival_s = np.broadcast_to(
                np.asarray(arrival_s, np.float64).reshape(self.ports, -1),
                (self.ports, n_chunks))

        if metadata_bytes < 0:
            raise ValueError(
                f"metadata_bytes must be >= 0, got {metadata_bytes}")
        if metadata_bytes:
            for pc in self.port_counters:
                pc.rx_bytes += metadata_bytes
                pc.tx_bytes += metadata_bytes
            self.root_tx_bytes += metadata_bytes
            self.root_rx_bytes += metadata_bytes

        out_sk = np.zeros(sk.shape[1:], np.int32)
        out_bm = np.zeros(bm.shape[1:], np.uint32)
        for w0 in range(0, n_chunks, self.slots):
            w1 = min(w0 + self.slots, n_chunks)
            window = self.windows
            self.windows += 1
            self.occupancy_peak = max(self.occupancy_peak, w1 - w0)
            up_bytes = out_sk[w0:w1].nbytes + out_bm[w0:w1].nbytes
            self.window_chunks.append(w1 - w0)
            self.window_root_bytes.append(up_bytes)
            for p in range(self.ports):
                pc = self.port_counters[p]
                chunk_bytes = sk[p, w0:w1].nbytes + bm[p, w0:w1].nbytes
                retries = 0
                if self.policy is not None and arrival_s is not None:
                    retries = self.policy.on_window(
                        window, p, float(arrival_s[p, w0:w1].max()),
                        chunk_bytes)
                pc.rx_bytes += chunk_bytes * (1 + retries)
                pc.rx_chunks += w1 - w0
                pc.retransmits += retries
                pc.tx_bytes += up_bytes       # broadcast back down
            # The switch accumulates port by port, so every running
            # partial sum must fit the 32-bit register, not only the last.
            partials = np.cumsum(sk[:, w0:w1].astype(np.int64), axis=0)
            if partials.size and (partials.max(initial=0) > _INT32_MAX
                                  or partials.min(initial=0) < _INT32_MIN):
                raise OverflowError(
                    f"window {window}: a running {self.ports}-port sum "
                    "overflows a 32-bit switch register — the stream was "
                    "not sized by FixedPointWire for this port count")
            out_sk[w0:w1] = partials[-1].astype(np.int32)
            out_bm[w0:w1] = np.bitwise_or.reduce(bm[:, w0:w1], axis=0)
            self.root_tx_bytes += up_bytes
            self.root_rx_bytes += up_bytes
        return out_sk, out_bm

    def check_batched_partial(self, partial_max: int, partial_min: int,
                              ports: Optional[int] = None,
                              window: int = 0) -> None:
        """Register-width check for a batched fold whose arithmetic ran
        outside the switch: given the int64 extrema of its running
        partial sums, raise the :class:`OverflowError` :meth:`aggregate`
        raises when a port-by-port sum leaves int32."""
        ports = self.ports if ports is None else int(ports)
        if int(partial_max) > int(_INT32_MAX) or \
                int(partial_min) < int(_INT32_MIN):
            raise OverflowError(
                f"window {window}: a running {ports}-port sum "
                "overflows a 32-bit switch register — the stream was "
                "not sized by FixedPointWire for this port count")

    def account_batched_fold(self, n_chunks: int, k_ports: int,
                             port_bytes: int, chunk_bytes: int) -> None:
        """Slot-pool accounting for one batched fold pass: ``k_ports``
        payload streams of ``n_chunks`` chunks folded into the resident
        accumulator through the pool's windows once for the whole batch;
        the last port books the arriving bytes and the reduced stream's
        TX."""
        if n_chunks < 1 or k_ports < 1:
            raise ValueError(
                f"need n_chunks >= 1 and k_ports >= 1, got "
                f"{n_chunks}/{k_ports}")
        up_total = 0
        for w0 in range(0, n_chunks, self.slots):
            w1 = min(w0 + self.slots, n_chunks)
            self.windows += 1
            self.occupancy_peak = max(self.occupancy_peak, w1 - w0)
            up = (w1 - w0) * chunk_bytes
            self.window_chunks.append(w1 - w0)
            self.window_root_bytes.append(up)
            up_total += up
        ingest = self.port_counters[-1]
        ingest.rx_bytes += k_ports * port_bytes
        ingest.rx_chunks += k_ports * n_chunks
        ingest.tx_bytes += up_total
        self.root_tx_bytes += up_total
        self.root_rx_bytes += up_total

    def report(self) -> Dict[str, object]:
        return {
            "ports": self.ports,
            "slots": self.slots,
            "windows": self.windows,
            "occupancy_peak": self.occupancy_peak,
            "window_chunks": tuple(self.window_chunks),
            "window_root_bytes": tuple(self.window_root_bytes),
            "root_link_tx_bytes": self.root_tx_bytes,
            "root_link_rx_bytes": self.root_rx_bytes,
            "per_port": [dataclasses.asdict(pc) for pc in self.port_counters],
            "retransmit_events": (list(self.policy.events)
                                  if self.policy is not None else []),
        }
