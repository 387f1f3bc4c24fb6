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
recover a sub-range of a larger stream under the stream's hash plan.

This slice covers the fused geometries (bitmap index, ``block_elems %
32 == 0``); Bloom and unaligned geometries need the standalone encode
and peel kernels of a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
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

    def _require_fused(self):
        if not ops.fused_wire_supported(self.cfg):
            raise NotImplementedError(
                f"index={self.cfg.index!r}, block_elems={self.cfg.block_elems}: "
                "only the fused bitmap wire is ported; the standalone "
                "encode/peel kernels for other geometries come later")

    def _ids(self, nb: int, block_offset: int, device) -> torch.Tensor:
        return torch.arange(nb, dtype=torch.int32, device=device) + int(block_offset)

    # ---- Phase I — compression -----------------------------------------

    def compress_wire(self, x: torch.Tensor, block_offset: int = 0
                      ) -> Tuple[CompressedLeaf, torch.Tensor]:
        """One producer pass: ``(CompressedLeaf, per-block maxabs)``."""
        self._require_fused()
        plan = make_plan(x.numel(), self.cfg)
        xb = to_blocks(x.to(torch.float32), plan)
        ids = self._ids(plan.nb, block_offset, x.device)
        sketch, words2d, maxabs = ops.encode_pack_quantize(xb, ids, self.cfg)
        return (CompressedLeaf(sketch=sketch, index_words=words2d.reshape(-1)),
                maxabs)

    def compress(self, x: torch.Tensor, block_offset: int = 0) -> CompressedLeaf:
        """Wire payload only — see :meth:`compress_wire`."""
        return self.compress_wire(x, block_offset=block_offset)[0]

    # ---- Phase II — recovery -------------------------------------------

    def recover(self, comp: CompressedLeaf, n: int, shape=None,
                with_stats: bool = False, block_offset: int = 0,
                dequant=None):
        """One consumer pass over the aggregated payload; recovery stats
        come from a popcount of the packed words.

        ``dequant``: ``(per_block_exponents (nb,) int32, mantissa_bits)``
        for an int32 fxp32 aggregate, which the same consumer pass then
        dequantizes (``exponents`` of :mod:`repro_torch.kernels.ops`)
        instead of a separate stream-sized decode before peeling."""
        self._require_fused()
        plan = make_plan(n, self.cfg)
        ids = self._ids(plan.nb, block_offset, comp.sketch.device)
        words2d = comp.index_words.reshape(plan.nb, self.cfg.block_elems // 32)
        exps, mbits = dequant if dequant is not None else (None, None)
        values, residual = ops.dequant_peel_unpack(
            comp.sketch, words2d, ids, self.cfg, exponents=exps,
            mantissa_bits=mbits)
        x = from_blocks(values, plan, shape)
        if not with_stats:
            return x
        nnz = index_lib.popcount(comp.index_words)
        n_residual = residual.sum(dtype=torch.int64)
        return x, RecoveryStats(nnz=nnz, peeled=nnz - n_residual,
                                residual=n_residual, rounds=self.cfg.rounds)
