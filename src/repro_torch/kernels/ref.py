"""Plain PyTorch versions of the codec kernels.

As the reference's ``kernels/ref.py``: the standalone encode and peel
are :mod:`repro_torch.core.sketch`'s and :mod:`repro_torch.core.peeling`'s
block-layout functions in the kernels' calling convention; the fused
wire kernels are composed from them, encode + pack (+ quantize) on the
producer side, unpack (+ dequant) + peel on the consumer side.
:mod:`repro_torch.kernels.ops` takes these for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.config import CompressionConfig
from repro_torch.core.sketch import encode_blocks, estimate_blocks
from repro_torch.core.peeling import peel_blocks
from repro_torch.core import index as index_lib
from repro_torch.net.fixedpoint import pow2


def sketch_encode_ref(xb: torch.Tensor, block_ids: torch.Tensor,
                      cfg: CompressionConfig) -> torch.Tensor:
    """(nb, G, c) values (any float type) -> (nb, rows, c) f32 sketch."""
    return encode_blocks(xb, block_ids, cfg)


def sketch_peel_ref(sketch: torch.Tensor, bits: torch.Tensor,
                    block_ids: torch.Tensor, cfg: CompressionConfig):
    """(nb, rows, c) sketch + (nb, G, c) bits (non-zero = set) ->
    (values (nb, G, c) f32, residual (nb, G, c) int8). The plain peel
    stops at the whole batch's fixpoint, the kernel at each block's:
    rounds after a fixpoint peel nothing."""
    r = peel_blocks(sketch, bits != 0, block_ids, cfg)
    return r.values, r.residual.to(torch.int8)


def sketch_estimate_ref(sketch: torch.Tensor, block_ids: torch.Tensor,
                        cfg: CompressionConfig) -> torch.Tensor:
    """(nb, rows, c) -> (nb, G, c) median-of-3 estimate for every coord."""
    return estimate_blocks(sketch, block_ids, cfg)


def encode_pack_quantize_ref(xb: torch.Tensor, block_ids: torch.Tensor,
                             cfg: CompressionConfig,
                             exponents: torch.Tensor | None = None,
                             mantissa_bits: int | None = None):
    """Composed producer: (nb, G, c) values + (nb,) ids ->
    (sketch (nb, rows, c) f32|int32, words (nb, wpb) int32,
    maxabs (nb,) f32). Requires ``cfg.block_elems % 32 == 0``."""
    nb = xb.shape[0]
    wpb = cfg.block_elems // 32
    sketch = encode_blocks(xb, block_ids, cfg)                # pass 1: encode
    words = index_lib.pack_bits(
        index_lib.bitmap_build(xb)).reshape(nb, wpb)          # pass 2: pack
    maxabs = sketch.abs().amax(dim=(1, 2))
    if exponents is not None:                                 # pass 3: quantize
        scale = pow2(int(mantissa_bits)
                     - torch.as_tensor(exponents, dtype=torch.int32,
                                       device=xb.device))
        sketch = torch.round(sketch * scale[:, None, None]).to(torch.int32)
    return sketch, words, maxabs


def dequant_peel_unpack_ref(sketch: torch.Tensor, words: torch.Tensor,
                            block_ids: torch.Tensor, cfg: CompressionConfig,
                            exponents: torch.Tensor | None = None,
                            mantissa_bits: int | None = None):
    """Composed consumer: (nb, rows, c) sketch + (nb, wpb) words + (nb,)
    ids -> (values (nb, G, c) f32, residual (nb, G, c) int8)."""
    nb = sketch.shape[0]
    bits = index_lib.unpack_bits(
        words.reshape(-1), (nb, cfg.group, cfg.lanes))        # pass 1: unpack
    if exponents is not None:                                 # pass 2: dequant
        scale = pow2(torch.as_tensor(exponents, dtype=torch.int32,
                                     device=sketch.device)
                     - int(mantissa_bits))
        sketch = sketch.to(torch.float32) * scale[:, None, None]
    r = peel_blocks(sketch, bits, block_ids, cfg)             # pass 3: peel
    return r.values, r.residual.to(torch.int8)
