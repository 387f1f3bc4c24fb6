"""PyTorch wrapper of the standalone peel CUDA kernel.

The kernel (``csrc/sketch_codec.cu:sketch_peel_kernel``) replaces the
reference's Pallas ``sketch_peel_pallas``: (nb, rows, c) f32 sketch +
(nb, G, c) index bits (one byte a coordinate: bool, uint8 or int8,
non-zero = set) + (nb,) int32 block ids -> (values (nb, G, c) f32,
residual (nb, G, c) int8). It runs the fused consumer's rounds and
median, so on an aligned geometry it equals that kernel on the
``pack_bits`` of the same bits, bit for bit; it serves the Bloom index's
candidates and ``block_elems % 32 != 0``.

The wrapper hands the bits' bytes to the kernel as they lie (no
conversion copy), allocates the outputs (and, where the peel state does
not fit shared memory, its device-memory scratch) with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch reports an
error, and adds one to ``LAUNCHES["sketch_peel"]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.config import CompressionConfig
from repro_torch.core import hashing
from . import build
from .cuda_common import (I, LAUNCHES, P, check, occupancy, out_ptr,
                          peel_scratch, resident, stream, tables)

BIT_DTYPES = (torch.bool, torch.uint8, torch.int8)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("sketch_codec")
    lib.sketch_codec_peel.argtypes = [P] * 11 + [I] * 6 + [ctypes.c_uint, P]
    lib.sketch_codec_peel.restype = I
    lib.sketch_codec_peel_smem.argtypes = [I, I, I, I]
    lib.sketch_codec_peel_smem.restype = ctypes.c_size_t
    lib.sketch_codec_max_smem.argtypes = [I]
    lib.sketch_codec_max_smem.restype = I
    lib.sketch_codec_occupancy.argtypes = [I] * 6
    lib.sketch_codec_occupancy.restype = I
    return lib


def peel_occupancy(cfg: CompressionConfig, device: torch.device):
    """(blocks one SM holds at once, dynamic shared memory bytes) of the
    peel kernel at ``cfg``'s geometry."""
    lib, G, c, R = _lib(), cfg.group, cfg.lanes, cfg.rows
    return occupancy(lib.sketch_codec_occupancy, 1, cfg,
                     lambda r: lib.sketch_codec_peel_smem(G, c, R, r),
                     lib.sketch_codec_max_smem, device)


def sketch_peel_cuda(sketch: torch.Tensor, bits: torch.Tensor,
                     block_ids: torch.Tensor, cfg: CompressionConfig,
                     block_rounds: torch.Tensor | None = None):
    """(nb, rows, c) f32 sketch + (nb, G, c) one-byte bits + (nb,) int32
    ids on a CUDA device -> (values (nb, G, c) f32, residual (nb, G, c)
    int8). ``block_rounds``, a (nb,) int32 tensor where given, takes each
    block's rounds run (the training path passes none)."""
    dev = sketch.device
    nb, G, c, R = sketch.shape[0], cfg.group, cfg.lanes, cfg.rows
    check(sketch, "sketch", torch.float32, (nb, R, c), dev)
    check(bits, "bits", BIT_DTYPES, (nb, G, c), dev)
    check(block_ids, "block_ids", torch.int32, (nb,), dev)
    lib = _lib()
    res = resident(cfg, lambda r: lib.sketch_codec_peel_smem(G, c, R, r),
                   lib.sketch_codec_max_smem, dev)
    row_ptr, ent, hrow, sign = tables(cfg, dev)
    values = torch.empty((nb, G, c), dtype=torch.float32, device=dev)
    residual = torch.empty((nb, G, c), dtype=torch.int8, device=dev)
    state = peel_scratch(cfg, nb, res, dev)
    err = lib.sketch_codec_peel(
        sketch.data_ptr(), bits.data_ptr(), block_ids.data_ptr(),
        row_ptr.data_ptr(), ent.data_ptr(), hrow.data_ptr(), sign.data_ptr(),
        values.data_ptr(), residual.data_ptr(),
        out_ptr(block_rounds, "block_rounds", torch.int32, (nb,), dev),
        state.data_ptr(), nb, G, c, R,
        cfg.rounds, int(res), hashing.rotation_salt(cfg.seed), stream(dev))
    if err:
        raise RuntimeError(f"sketch_codec_peel launch failed: cudaError {err}")
    LAUNCHES["sketch_peel"] += 1
    return values, residual
