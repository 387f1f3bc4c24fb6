"""Dispatch between the hand-written CUDA kernels and the plain versions.

The single compute backend of the compression pipeline:
``HomomorphicCompressor`` (and through it the aggregators and training)
calls the ops here and never reaches into ``core.sketch`` or
``core.peeling`` directly.

Dispatch follows the tensor's device, under the ``use_pallas`` policy of
the config (the reference's name, kept so the configs stay equal):

- ``"never"`` takes the plain version (``kernels/ref.py``) on any
  device, as the reference's ``"never"`` takes its jnp version on any
  backend;
- otherwise a tensor on the CPU takes the plain version, and
  ``"always"`` raises there, since the kernels exist only on the card;
- otherwise a CUDA tensor takes the hand kernel, or the call raises
  where the kernel cannot build, launch or fit (the peel kernels refuse
  a block whose bits exceed shared memory, e.g. ``ratio=0.001``). The
  plain version never stands in silently: it runs on the card only when
  the caller asks for ``"never"``.

The fused wire kernels have both legs of the reference: with
``exponents`` and ``mantissa_bits`` the producer quantizes to the fxp32
int32 sketch and the consumer dequantizes it, on the card as in the
plain versions. The standalone ``sketch_encode`` and ``sketch_peel``
serve the geometries the fused kernels do not cover (the Bloom index,
``block_elems % 32 != 0``).
"""

from __future__ import annotations

import torch

from repro_torch.core.config import CompressionConfig
from . import ref as ref_ops
from .cuda_common import LAUNCHES
from .sketch_encode import codec_threads, encode_occupancy, sketch_encode_cuda
from .sketch_peel import peel_occupancy, sketch_peel_cuda
from .sketch_wire import (dequant_peel_unpack_cuda, encode_pack_quantize_cuda,
                          wire_occupancy, wire_threads)

__all__ = ["LAUNCHES", "sketch_encode", "sketch_peel", "encode_pack_quantize",
           "dequant_peel_unpack", "fused_wire_supported", "wire_codec_passes",
           "sketch_estimate", "kernel_occupancy", "kernel_threads"]


def _use_kernel(cfg: CompressionConfig, device: torch.device) -> bool:
    """Whether a call on ``device`` under ``cfg.use_pallas`` launches the
    hand kernel (True) or runs the plain version (False); raises where
    the policy cannot be met there."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if cfg.use_pallas == "never":
        return False
    if device.type == "cuda":
        return True
    if cfg.use_pallas == "always":
        raise ValueError(
            "use_pallas='always' needs a CUDA tensor: the hand kernels "
            "exist only on the card")
    return False


def sketch_encode(xb: torch.Tensor, block_ids: torch.Tensor,
                  cfg: CompressionConfig) -> torch.Tensor:
    """(nb, G, c) values (f32, f16 or bf16) + (nb,) int32 ids ->
    (nb, rows, c) f32 sketch."""
    if _use_kernel(cfg, xb.device):
        return sketch_encode_cuda(xb, block_ids, cfg)
    return ref_ops.sketch_encode_ref(xb, block_ids, cfg)


def sketch_peel(sketch: torch.Tensor, bits: torch.Tensor,
                block_ids: torch.Tensor, cfg: CompressionConfig):
    """(nb, rows, c) sketch + (nb, G, c) bits -> (values f32, residual
    int8), both (nb, G, c)."""
    if _use_kernel(cfg, sketch.device):
        return sketch_peel_cuda(sketch, bits, block_ids, cfg)
    return ref_ops.sketch_peel_ref(sketch, bits, block_ids, cfg)


def fused_wire_supported(cfg: CompressionConfig) -> bool:
    """Whether the fused wire-codec ops cover this geometry: the bitmap
    is packed per block, so word boundaries must coincide with block
    boundaries (``block_elems % 32 == 0``), and only the exact bitmap
    index packs per block."""
    return cfg.index == "bitmap" and cfg.block_elems % 32 == 0


def _check_fused(cfg, exponents, mantissa_bits):
    if (exponents is None) != (mantissa_bits is None):
        raise ValueError("exponents and mantissa_bits must be given together")
    if not fused_wire_supported(cfg):
        raise ValueError(
            f"fused wire codec unsupported for index={cfg.index!r}, "
            f"block_elems={cfg.block_elems} (need bitmap and %32==0)")


def encode_pack_quantize(xb: torch.Tensor, block_ids: torch.Tensor,
                         cfg: CompressionConfig,
                         exponents: torch.Tensor | None = None,
                         mantissa_bits: int | None = None):
    """Fused wire producer: (nb, G, c) values + (nb,) int32 ids ->
    (sketch (nb, rows, c) f32|int32, words (nb, wpb) int32,
    maxabs (nb,) f32), in one pass over the gradient stream; the sketch
    is the fxp32 int32 one when (nb,) int32 per-block ``exponents`` and
    ``mantissa_bits`` are given."""
    _check_fused(cfg, exponents, mantissa_bits)
    if _use_kernel(cfg, xb.device):
        return encode_pack_quantize_cuda(xb, block_ids, cfg, exponents=exponents,
                                         mantissa_bits=mantissa_bits)
    return ref_ops.encode_pack_quantize_ref(
        xb, block_ids, cfg, exponents=exponents, mantissa_bits=mantissa_bits)


def dequant_peel_unpack(sketch: torch.Tensor, words: torch.Tensor,
                        block_ids: torch.Tensor, cfg: CompressionConfig,
                        exponents: torch.Tensor | None = None,
                        mantissa_bits: int | None = None):
    """Fused wire consumer: (nb, rows, c) sketch + (nb, wpb) words + (nb,)
    ids -> (values f32, residual int8), both (nb, G, c), in one pass over
    the aggregated wire payload; an int32 fxp32 sketch is dequantized in
    the same pass with (nb,) int32 per-block ``exponents`` and
    ``mantissa_bits``."""
    _check_fused(cfg, exponents, mantissa_bits)
    if _use_kernel(cfg, sketch.device):
        return dequant_peel_unpack_cuda(sketch, words, block_ids, cfg,
                                        exponents=exponents,
                                        mantissa_bits=mantissa_bits)
    return ref_ops.dequant_peel_unpack_ref(
        sketch, words, block_ids, cfg, exponents=exponents,
        mantissa_bits=mantissa_bits)


def wire_codec_passes(cfg: CompressionConfig, quantized: bool = False,
                      device: str | torch.device = "cuda"):
    """Analytic pass counts over the bucket stream per wire direction on
    ``device``, as the dispatch runs them there: the fused kernels make 1
    each way; the composed plain versions encode + pack (+ quantize) and
    unpack + peel (+ dequant). Raises where the dispatch raises for the
    policy on that device."""
    if fused_wire_supported(cfg) and _use_kernel(cfg, torch.device(device)):
        return {"producer": 1, "consumer": 1}
    extra = 1 if quantized else 0
    return {"producer": 2 + extra, "consumer": 2 + extra}


def sketch_estimate(sketch: torch.Tensor, block_ids: torch.Tensor,
                    cfg: CompressionConfig) -> torch.Tensor:
    """Median-of-3 estimate for every coordinate, (nb, rows, c) ->
    (nb, G, c). Plain on every device, as in the reference: it is off the
    training path, and the peel kernel computes the same median in-kernel
    for its residue."""
    return ref_ops.sketch_estimate_ref(sketch, block_ids, cfg)


def kernel_occupancy(name: str, cfg: CompressionConfig,
                     device: str | torch.device = "cuda"):
    """(blocks one SM holds at once, dynamic shared memory bytes) of the
    CUDA kernel behind launch counter ``name`` at ``cfg``'s geometry on
    ``device``: the variant (state in shared or device memory) that the
    wrappers launch there."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if name == "sketch_encode":
        return encode_occupancy(cfg, device)
    if name == "sketch_peel":
        return peel_occupancy(cfg, device)
    return wire_occupancy(name, cfg, device)


def kernel_threads(name: str, cfg: CompressionConfig) -> int:
    """Threads of a block of the CUDA kernel behind launch counter
    ``name`` at ``cfg``'s geometry."""
    if name.startswith("sketch_"):
        return codec_threads(int(name == "sketch_peel"), cfg)
    return wire_threads(name, cfg)
