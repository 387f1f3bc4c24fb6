"""Configuration for the lossless homomorphic compressor.

Field for field the reference's ``CompressionConfig`` (same names, same
defaults, same validation), so one config converts to the other with
``dataclasses.asdict``. Only the derived geometry the port's slice needs
is carried here; wire-byte accounting comes with the wire-planning slice.

Fields the port reads differently:

- ``use_pallas`` selects the hand CUDA kernels: ``"never"`` the plain
  PyTorch version on any device, ``"always"`` the kernel, ``"auto"``
  whichever the tensor's device takes (see :mod:`repro_torch.kernels.ops`).
- ``encode_block_tile`` / ``peel_block_tile`` are kept so the configs
  stay equal; the first kernels run one sketch block per CUDA block.
- ``chunk_blocks`` is kept as a field only: the port launches each codec
  kernel over all blocks at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static plan for the homomorphic compressor (hashable)."""

    ratio: float = 0.10          # sketch elements / original elements
    lanes: int = 512             # batch width c
    rows: int = 6                # sketch rows per block; divisible by 3
    rounds: int = 10             # peeling rounds
    index: str = "bitmap"        # "bitmap" | "bloom"
    bloom_hashes: int = 3
    bloom_bits_ratio: float = 0.125
    topk_ratio: Optional[float] = None   # optional sparsity budget
    topk_exact: bool = False     # exact top-k vs sampled-quantile threshold
    error_feedback: bool = True  # accumulate unsent residual (DGC-style)
    seed: int = 0x5EED
    chunk_blocks: int = 512      # kept for config parity (see module doc)
    use_pallas: str = "auto"     # "never" | "always" | "auto" (hand kernels)
    encode_block_tile: int = 8   # kept for config parity (see module doc)
    peel_block_tile: int = 4     # kept for config parity (see module doc)
    bucket_bytes: int = 4 << 20  # target f32 bytes per aggregation bucket
    overlap: bool = False
    stream_chunks: Optional[int] = None
    rs_wire: str = "auto"
    wire_dtype: str = "f32"
    switch_slots: int = 8
    topology: str = "flat"
    sketch_dtype: str = "float32"
    replan_every: int = 16
    auto_link_gbps: float = 400.0
    auto_codec_gbps: float = 6552.0
    auto_occupancy_margin: float = 0.9

    def __post_init__(self):
        if self.rows % 3 != 0 or self.rows < 3:
            raise ValueError(f"rows must be a positive multiple of 3, got {self.rows}")
        if not 0.0 < self.ratio:
            raise ValueError(f"ratio must be positive, got {self.ratio}")
        if self.lanes < 8:
            raise ValueError(f"lanes must be >= 8, got {self.lanes}")
        if self.index not in ("bitmap", "bloom"):
            raise ValueError(f"index must be 'bitmap' or 'bloom', got {self.index}")
        if self.use_pallas not in ("never", "always", "auto"):
            raise ValueError(
                f"use_pallas must be 'never', 'always' or 'auto', got "
                f"{self.use_pallas!r}")
        if self.encode_block_tile < 1:
            raise ValueError(
                f"encode_block_tile must be >= 1, got {self.encode_block_tile}")
        if self.peel_block_tile < 1:
            raise ValueError(
                f"peel_block_tile must be >= 1, got {self.peel_block_tile}")
        if self.bucket_bytes < 4:
            raise ValueError(
                f"bucket_bytes must be >= 4, got {self.bucket_bytes}")
        if (self.overlap or self.stream_chunks is not None) \
                and self.index != "bitmap":
            raise ValueError("overlap/stream_chunks require index='bitmap'")
        if self.stream_chunks is not None and self.stream_chunks < 1:
            raise ValueError(
                f"stream_chunks must be >= 1, got {self.stream_chunks}")
        if self.rs_wire not in ("auto", "native", "emulate"):
            raise ValueError(
                f"rs_wire must be 'auto', 'native' or 'emulate', "
                f"got {self.rs_wire!r}")
        if self.wire_dtype not in ("f32", "fxp32"):
            raise ValueError(
                f"wire_dtype must be 'f32' or 'fxp32', got {self.wire_dtype!r}")
        if self.switch_slots < 1:
            raise ValueError(
                f"switch_slots must be >= 1, got {self.switch_slots}")
        if self.topology not in ("flat", "tor_spine"):
            raise ValueError(
                f"topology must be 'flat' or 'tor_spine', got {self.topology!r}")
        if self.replan_every < 1:
            raise ValueError(
                f"replan_every must be >= 1, got {self.replan_every}")
        if self.auto_link_gbps <= 0 or self.auto_codec_gbps <= 0:
            raise ValueError(
                f"auto_link_gbps/auto_codec_gbps must be positive, got "
                f"{self.auto_link_gbps}/{self.auto_codec_gbps}")
        if not 0.0 < self.auto_occupancy_margin <= 1.0:
            raise ValueError(
                f"auto_occupancy_margin must be in (0, 1], got "
                f"{self.auto_occupancy_margin}")

    # ---- derived static geometry -------------------------------------

    @property
    def group(self) -> int:
        """G — gradient batches per sketch block (rows / ratio)."""
        return max(1, round(self.rows / self.ratio))

    @property
    def block_elems(self) -> int:
        """Original elements covered by one block."""
        return self.group * self.lanes

    def num_blocks(self, n: int) -> int:
        """Blocks needed to cover ``n`` elements."""
        return -(-n // self.block_elems)

    # ---- bucket geometry ---------------------------------------------

    @property
    def bucket_quantum(self) -> int:
        """Alignment unit for bucket sizes: whole sketch blocks and whole
        packed-bitmap words."""
        return math.lcm(self.block_elems, 32)

    def bucket_elems_for(self, total_elems: int) -> int:
        """f32 elements per bucket for a stream of ``total_elems``:
        ``bucket_bytes`` rounded up to the quantum, capped at the
        (quantum-rounded) stream itself."""
        if total_elems < 1:
            raise ValueError(f"total_elems must be >= 1, got {total_elems}")
        q = self.bucket_quantum
        want = max(1, self.bucket_bytes // 4)
        elems = -(-want // q) * q
        cap = -(-total_elems // q) * q
        return min(elems, cap)

    def num_buckets(self, total_elems: int) -> int:
        return -(-total_elems // self.bucket_elems_for(total_elems))
