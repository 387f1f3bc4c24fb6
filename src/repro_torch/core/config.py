"""Configuration for the lossless homomorphic compressor.

Field for field the reference's ``CompressionConfig`` (same names, same
defaults, same validation), so one config converts to the other with
``dataclasses.asdict``, with the reference's derived geometry and its
wire-byte accounting (:meth:`CompressionConfig.wire_bytes`,
:meth:`CompressionConfig.strategy_wire_bytes`: pure integer arithmetic,
equal to the reference's key for key).

Fields the port reads differently:

- ``use_pallas`` selects the hand CUDA kernels: ``"never"`` the plain
  PyTorch version on any device, ``"always"`` the kernel, ``"auto"``
  whichever the tensor's device takes (see :mod:`repro_torch.kernels.ops`).
- ``encode_block_tile`` / ``peel_block_tile`` are kept so the configs
  stay equal; the first kernels run one sketch block per CUDA block.
- ``chunk_blocks`` is kept as a field only: the port launches each codec
  kernel over all blocks at once.
- ``auto_link_gbps`` / ``auto_codec_gbps`` keep the reference's default
  values, for config parity only; they are the ``auto`` cost model's
  bandwidth priors, and a run on the card takes measured ones from
  :func:`repro_torch.core.costmodel.priors_from_codec_report`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

GAMMA = 1.23  # 3-ary peeling threshold from the paper (section 3.2)


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
    replan_every: int = 16       # steps between `auto` wire-plan refreshes
    auto_link_gbps: float = 400.0    # the reference's default, kept for
                                     # config parity (see module doc)
    auto_codec_gbps: float = 6552.0  # likewise: the codec prior, Gb/s of
                                     # bucket stream a pass
    auto_occupancy_margin: float = 0.9   # compressed wires are ruled out
                                     # for a bucket whose non-zero share
                                     # exceeds this fraction of the peel
                                     # capacity; it is planned dense

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

    @property
    def sketch_elems(self) -> int:
        """Sketch cells per block."""
        return self.rows * self.lanes

    @property
    def peel_capacity(self) -> int:
        """Max non-zeros per block recoverable w.h.p. (|Y| / gamma)."""
        return int(self.sketch_elems / GAMMA)

    def num_blocks(self, n: int) -> int:
        """Blocks needed to cover ``n`` elements."""
        return -(-n // self.block_elems)

    def padded_size(self, n: int) -> int:
        return self.num_blocks(n) * self.block_elems

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

    # ---- wire accounting ---------------------------------------------

    def _payload_bytes(self, elems: int):
        """(sketch, index) bytes of a stream of ``elems`` whole-block
        elements."""
        sketch = (elems // self.block_elems) * self.sketch_elems * 4
        if self.index == "bitmap":
            return sketch, (elems // 32) * 4
        return sketch, int(elems * self.bloom_bits_ratio / 32 + 1) * 4

    def wire_bytes(self, n: int, grad_bytes_per_elem: int = 2) -> dict:
        """Strategy-agnostic payload sizes for ``n`` elements (the
        reference's): the f32 sketch, the packed index (1 bit an element,
        or the Bloom filter) and the dense gradient, and the per-bucket
        totals of the bucketed stream (``n`` split into ``n_buckets``
        buckets of ``bucket_elems``, the last one padded). What a rank
        ships per strategy is :meth:`strategy_wire_bytes`."""
        nb = self.num_blocks(n)
        sketch = nb * self.sketch_elems * 4
        if self.index == "bitmap":
            idx = -(-self.padded_size(n) // 32) * 4
        else:
            idx = int(n * self.bloom_bits_ratio / 32 + 1) * 4
        dense = n * grad_bytes_per_elem
        be = self.bucket_elems_for(n)
        n_buckets = self.num_buckets(n)
        b_sketch, b_idx = self._payload_bytes(be)
        return {
            "sketch_bytes": sketch,
            "index_bytes": idx,
            "total_bytes": sketch + idx,
            "dense_bytes": dense,
            "wire_fraction": (sketch + idx) / max(dense, 1),
            "n_buckets": n_buckets,
            "bucket_elems": be,
            "bucket_sketch_bytes": b_sketch,
            "bucket_index_bytes": b_idx,
            "bucket_total_bytes": b_sketch + b_idx,
            "bucketed_total_bytes": n_buckets * (b_sketch + b_idx),
        }

    def strategy_wire_bytes(self, n: int, workers: int,
                            grad_bytes_per_elem: int = 2,
                            zero1_aligned: bool = False) -> dict:
        """Per-rank wire accounting of each aggregation strategy for a
        stream of ``n`` elements over ``workers`` (W) ranks, the
        reference's numbers key for key:

        - ``rank_payload_bytes``: the reduced payload that lands on a
          rank (the whole dense gradient or sketch + index on the
          all-reduce wires; the 1/W slice, padded to whole per-rank runs
          of buckets, on the native reduce-scatter wire);
        - ``link_bytes``: bytes a rank sends under the bandwidth-optimal
          algorithms: ring all-reduce ``2(W-1)/W x`` the payload,
          reduce-scatter ``(W-1)/W x``, the in-network tree ``1 x`` (the
          switches combine in flight); ``root_link_bytes`` what the
          tree's root link carries, and on fxp32 ``exponent_bytes``, one
          int32 exponent a bucket;
        - ``compressed_rs_native`` (None with the Bloom index, which
          cannot be sliced): the recovered-chunk gather apart
          (``rs_gather_link_bytes``), with ``link_bytes`` counting it
          unless ``zero1_aligned`` (the gather-skip grid);
        - the permute pattern's ``dense_alltoall`` and
          ``compressed_alltoall``, where ``n`` is a rank's stacked W-lane
          payload and each rank sends ``(W-1)/W x`` of it
          (``link_bytes_emulated``: the whole stack at ring volume).

        The compressed payloads are those of the bucket-padded stream,
        what the aggregators encode and ship.
        """
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        W = workers
        base = self.wire_bytes(n, grad_bytes_per_elem)
        dense = base["dense_bytes"]
        nb = base["n_buckets"]
        be = base["bucket_elems"]
        full = sum(self._payload_bytes(nb * be))
        nb_p = -(-nb // W) * W          # whole per-rank runs of buckets
        ring = 2 * (W - 1) / W
        rs = (W - 1) / W
        out = {
            "workers": W,
            "elems": n,
            "or_emulated_factor": 32,
            "dense": {"rank_payload_bytes": dense,
                      "link_bytes": int(dense * ring)},
            "compressed": {"rank_payload_bytes": full,
                           "link_bytes": int(full * ring)},
            # the emulated RS reduces the whole stream (all-reduce wire)
            "compressed_rs_emulated": {"rank_payload_bytes": full,
                                       "link_bytes": int(full * ring)},
        }
        if self.index == "bitmap":
            sketch_p, idx_p = self._payload_bytes(nb_p * be)
            rs_link = int((sketch_p + idx_p) * rs)
            gather = int(nb_p * be * 4 * rs)
            out["compressed_rs_native"] = {
                "rank_payload_bytes": (sketch_p + idx_p) // W,
                "rs_gather_link_bytes": gather,
                "link_bytes_with_gather": rs_link + gather,
                "link_bytes_no_gather": rs_link,
                "zero1_aligned": zero1_aligned,
                "link_bytes": rs_link + (0 if zero1_aligned else gather),
            }
        else:
            out["compressed_rs_native"] = None
        exp_bytes = nb * 4 if self.wire_dtype == "fxp32" else 0
        innet = full + exp_bytes
        out["compressed_innet"] = {
            "rank_payload_bytes": innet,
            "link_bytes": innet if W > 1 else 0,
            "root_link_bytes": innet if W > 1 else 0,
            "exponent_bytes": exp_bytes,
        }
        for entry in out.values():
            if isinstance(entry, dict):
                entry["pattern"] = "allreduce"
        # the permute pattern: a lane of ceil(n/W) elements a destination,
        # each on its own bucket run; a rank keeps its own lane
        n_d = -(-n // W)
        nb_d = self.num_buckets(n_d)
        lane_bytes = sum(self._payload_bytes(nb_d * self.bucket_elems_for(n_d)))
        comp_stack = W * lane_bytes
        out["dense_alltoall"] = {
            "pattern": "alltoall",
            "payload_bytes": dense,
            "rank_payload_bytes": int(dense * rs),
            "link_bytes": int(dense * rs),
        }
        out["compressed_alltoall"] = {
            "pattern": "alltoall",
            "n_lane_buckets": nb_d,
            "lane_payload_bytes": lane_bytes,
            "payload_bytes": comp_stack,
            "rank_payload_bytes": int(comp_stack * rs),
            "link_bytes": int(comp_stack * rs),
            "link_bytes_emulated": int(comp_stack * ring),
        }
        return out
