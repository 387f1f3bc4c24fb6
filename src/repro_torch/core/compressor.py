"""Top-level homomorphic compressor (paper Algorithm 1).

``HomomorphicCompressor`` turns a flat gradient stream into the wire
format ``CompressedLeaf(sketch, index_words)`` and back:

    compress:  X -> S(X) = [Y, B]          (phase I)
    recover :  S(sum X) -> sum X           (phase II, peeling + estimate)

Aggregation happens between the two calls and is someone else's job: a
sum for the sketch, an OR for the index words. All codec compute goes
through :mod:`repro_torch.kernels.ops`, one launch over all blocks at
once in each direction (the reference's ``chunk_blocks`` chunking is
kept only as a config field). ``block_offset`` lets a caller encode or
recover a sub-range of a larger stream under the stream's hash plan
(bitmap index only: a Bloom filter hashes the global coordinates of the
stream it was built over).

Fused geometries (bitmap index, ``block_elems % 32 == 0``) take one
fused producer and one fused consumer launch. The others (the Bloom
index, unaligned bitmaps) take the reference's composed path: the
standalone encode kernel, the index built apart (``pack_bits`` of the
bitmap, or ``bloom_build``) and the max as a separate ``amax``; on
recovery the bits unpacked or queried from the filter, the fxp32
aggregate dequantized by a power-of-two scale, and the standalone peel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.net.fixedpoint import pow2
from .config import CompressionConfig
from .blocks import make_plan, to_blocks, from_blocks
from . import index as index_lib


class CompressedLeaf(NamedTuple):
    """Wire format for one stream. Sketch aggregates by +, words by |."""
    sketch: torch.Tensor       # (nb, rows, lanes) f32, or int32 on fxp32
    index_words: torch.Tensor  # (w,) int32 carrying uint32 bits


class RecoveryStats(NamedTuple):
    nnz: torch.Tensor          # indexed coordinates (candidates)
    peeled: torch.Tensor       # exactly recovered
    residual: torch.Tensor     # fell back to the median estimate
    rounds: int                # peeling rounds run


@dataclasses.dataclass(frozen=True)
class HomomorphicCompressor:
    cfg: CompressionConfig

    def _ids(self, nb: int, block_offset: int, device) -> torch.Tensor:
        return torch.arange(nb, dtype=torch.int32, device=device) + int(block_offset)

    # ---- Phase I — compression -----------------------------------------

    def compress_wire(self, x: torch.Tensor, block_offset: int = 0
                      ) -> Tuple[CompressedLeaf, torch.Tensor]:
        """One producer pass on fused geometries, the composed passes
        otherwise: ``(CompressedLeaf, per-block maxabs)``."""
        cfg = self.cfg
        plan = make_plan(x.numel(), cfg)
        xb = to_blocks(x.to(torch.float32), plan)
        ids = self._ids(plan.nb, block_offset, x.device)
        if ops.fused_wire_supported(cfg):
            sketch, words2d, maxabs = ops.encode_pack_quantize(xb, ids, cfg)
            return (CompressedLeaf(sketch=sketch,
                                   index_words=words2d.reshape(-1)), maxabs)
        sketch = ops.sketch_encode(xb, ids, cfg)
        if cfg.index == "bitmap":
            words = index_lib.pack_bits(index_lib.bitmap_build(xb))
        else:
            words = index_lib.bloom_build(xb, cfg)
        maxabs = sketch.abs().amax(dim=(1, 2))
        return CompressedLeaf(sketch=sketch, index_words=words), maxabs

    def compress(self, x: torch.Tensor, block_offset: int = 0) -> CompressedLeaf:
        """Wire payload only — see :meth:`compress_wire`."""
        return self.compress_wire(x, block_offset=block_offset)[0]

    def exchange_wire(self, lane_buckets: torch.Tensor, block_offset: int = 0
                      ) -> Tuple[CompressedLeaf, torch.Tensor]:
        """One producer pass over one chunk of the all-to-all payload,
        ``(lanes, chunk_buckets, bucket_elems)`` laid out chunk-major, so
        the whole stack is one contiguous block range from
        ``block_offset``. Every lane encodes in one :meth:`compress_wire`
        pass and the lanes are reshaped views of it: sketch ``(lanes,
        lane_blocks, rows, lanes_c)``, words ``(lanes, lane_words)``,
        maxabs ``(lanes, lane_blocks)``. Lane ``d`` equals compressing
        lane ``d`` alone at ``block_offset + d * lane_blocks``, so every
        source's sketch of a destination's slab adds homomorphically."""
        lanes, nb_c, elems = lane_buckets.shape
        if elems % self.cfg.block_elems:
            raise ValueError(
                f"bucket_elems {elems} is not a whole number of sketch "
                f"blocks ({self.cfg.block_elems})")
        comp, maxabs = self.compress_wire(lane_buckets.reshape(-1),
                                          block_offset=block_offset)
        lane_blocks = (nb_c * elems) // self.cfg.block_elems
        sk = comp.sketch.reshape((lanes, lane_blocks) + tuple(comp.sketch.shape[1:]))
        wd = comp.index_words.reshape(lanes, -1)
        return (CompressedLeaf(sketch=sk, index_words=wd),
                maxabs.reshape(lanes, lane_blocks))

    # ---- Phase II — recovery -------------------------------------------

    def recover(self, comp: CompressedLeaf, n: int, shape=None,
                with_stats: bool = False, block_offset: int = 0,
                dequant=None):
        """One consumer pass over the aggregated payload on fused
        geometries, whose recovery stats come from a popcount of the
        packed words; otherwise the index is unpacked (bitmap) or queried
        (Bloom) into one bit a coordinate, and ``nnz`` counts those
        candidates, Bloom false positives included.

        ``dequant``: ``(per_block_exponents (nb,) int32, mantissa_bits)``
        for an int32 fxp32 aggregate, which the fused consumer pass then
        dequantizes (``exponents`` of :mod:`repro_torch.kernels.ops`)
        instead of a separate stream-sized decode before peeling; the
        composed path scales the sketch by ``2^(e - M)`` first."""
        cfg = self.cfg
        plan = make_plan(n, cfg)
        ids = self._ids(plan.nb, block_offset, comp.sketch.device)
        exps, mbits = dequant if dequant is not None else (None, None)
        if ops.fused_wire_supported(cfg):
            words2d = comp.index_words.reshape(plan.nb, cfg.block_elems // 32)
            values, residual = ops.dequant_peel_unpack(
                comp.sketch, words2d, ids, cfg, exponents=exps,
                mantissa_bits=mbits)
            bits = None
        else:
            bshape = (plan.nb, plan.group, plan.lanes)
            if cfg.index == "bitmap":
                bits = index_lib.unpack_bits(comp.index_words, bshape)
            else:
                bits = index_lib.bloom_query(bshape, cfg, comp.index_words)
            sketch = comp.sketch
            if dequant is not None:
                scale = pow2(torch.as_tensor(exps, dtype=torch.int32,
                                             device=sketch.device) - int(mbits))
                sketch = sketch.to(torch.float32) * scale[:, None, None]
            values, residual = ops.sketch_peel(sketch, bits, ids, cfg)
        x = from_blocks(values, plan, shape)
        if not with_stats:
            return x
        nnz = (index_lib.popcount(comp.index_words) if bits is None
               else bits.sum(dtype=torch.int64))
        n_residual = residual.sum(dtype=torch.int64)
        return x, RecoveryStats(nnz=nnz, peeled=nnz - n_residual,
                                residual=n_residual, rounds=self.cfg.rounds)

    # ---- Lossy sketch-only decode (Sketched-SGD style) for ablations ---

    def estimate(self, comp: CompressedLeaf, n: int, shape=None,
                 block_offset: int = 0) -> torch.Tensor:
        """Median-of-3 estimate of every coordinate, zeroed off the bitmap
        (the Bloom filter's candidates are not an exact mask, so with
        ``index="bloom"`` every coordinate keeps its estimate, as in the
        reference)."""
        plan = make_plan(n, self.cfg)
        ids = self._ids(plan.nb, block_offset, comp.sketch.device)
        values = ops.sketch_estimate(comp.sketch, ids, self.cfg)
        if self.cfg.index == "bitmap":
            bits = index_lib.unpack_bits(
                comp.index_words, (plan.nb, plan.group, plan.lanes))
            values = torch.where(bits, values, torch.zeros((), device=values.device))
        return from_blocks(values, plan, shape)

    # ---- Wire accounting -------------------------------------------------

    def wire_bytes(self, n: int, grad_bytes_per_elem: int = 2) -> dict:
        return self.cfg.wire_bytes(n, grad_bytes_per_elem)
