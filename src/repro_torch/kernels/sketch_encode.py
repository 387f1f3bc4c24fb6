"""PyTorch wrapper of the standalone Count-Sketch encode CUDA kernel.

The kernel (``csrc/sketch_codec.cu:sketch_encode_kernel``) replaces the
reference's Pallas ``sketch_encode_pallas``: (nb, G, c) values + (nb,)
int32 block ids -> (nb, rows, c) f32 sketch, the fused producer's sketch
without its words and max, bit for bit. It serves the geometries the
fused kernels do not (the Bloom index, ``block_elems % 32 != 0``).

It runs the fused producer's streamed owner-sum
(``csrc/sketch_tile.cuh:encode_block``): the block's batch rows pass
through a ring of shared-memory chunks while the owner threads sum the
chunks before. Any contiguous input is taken: 16-byte copies where the
data pointer and the lanes allow, 4-byte copies otherwise.

The wrapper checks its inputs, casts f16/bf16 values to f32 (the kernel
reads f32, as the reference's kernel casts its tile), allocates the
sketch with ``torch.empty``, launches on PyTorch's current stream, raises
if the launch reports an error, and adds one to
``LAUNCHES["sketch_encode"]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.config import CompressionConfig
from repro_torch.core import hashing
from . import build
from .cuda_common import (I, LAUNCHES, P, check, chunk_rows, encode_tables,
                          occupancy, out_ptr, plane_scratch, resident, stream)

VALUE_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("sketch_codec")
    lib.sketch_codec_encode.argtypes = [P] * 8 + [I] * 5 + [ctypes.c_uint, P]
    lib.sketch_codec_encode.restype = I
    lib.sketch_codec_encode_smem.argtypes = [I] * 5
    lib.sketch_codec_encode_smem.restype = ctypes.c_size_t
    lib.sketch_codec_max_smem.argtypes = [I]
    lib.sketch_codec_max_smem.restype = I
    lib.sketch_codec_occupancy.argtypes = [I] * 6
    lib.sketch_codec_occupancy.restype = I
    lib.sketch_codec_threads.argtypes = [I, I]
    lib.sketch_codec_threads.restype = I
    return lib


def encode_occupancy(cfg: CompressionConfig, device: torch.device):
    """(blocks one SM holds at once, dynamic shared memory bytes) of the
    encode kernel at ``cfg``'s geometry."""
    lib, G, c, R, K = _lib(), cfg.group, cfg.lanes, cfg.rows, chunk_rows(cfg)
    return occupancy(lib.sketch_codec_occupancy, 0, cfg,
                     lambda r: lib.sketch_codec_encode_smem(G, c, R, K, r),
                     lib.sketch_codec_max_smem, device)


def codec_threads(kind: int, cfg: CompressionConfig) -> int:
    """Threads of a block of the codec library's kernel ``kind`` (0 the
    encode, 1 the peel) at ``cfg``'s geometry."""
    return _lib().sketch_codec_threads(kind, cfg.lanes)


def sketch_encode_cuda(xb: torch.Tensor, block_ids: torch.Tensor,
                       cfg: CompressionConfig,
                       phase_cycles: torch.Tensor | None = None) -> torch.Tensor:
    """(nb, G, c) f32/f16/bf16 + (nb,) int32 ids on a CUDA device ->
    (nb, rows, c) f32 sketch. ``phase_cycles``, a (nb, 3) int64 tensor
    where given, takes each block's ``clock64`` cycles waiting on its
    loads, summing, and in all (the training path passes none)."""
    dev = xb.device
    nb, G, c, R = xb.shape[0], cfg.group, cfg.lanes, cfg.rows
    check(xb, "xb", VALUE_DTYPES, (nb, G, c), dev)
    check(block_ids, "block_ids", torch.int32, (nb,), dev)
    xb = xb.to(torch.float32)
    lib, K = _lib(), chunk_rows(cfg)
    res = resident(cfg, lambda r: lib.sketch_codec_encode_smem(G, c, R, K, r),
                   lib.sketch_codec_max_smem, dev)
    cptr, ent, ent_sign = encode_tables(cfg, dev)
    plane, plane_p = plane_scratch(cfg, nb, res, dev)   # held through the launch
    sketch = torch.empty((nb, R, c), dtype=torch.float32, device=dev)
    err = lib.sketch_codec_encode(
        xb.data_ptr(), block_ids.data_ptr(), cptr.data_ptr(), ent.data_ptr(),
        ent_sign.data_ptr(), sketch.data_ptr(),
        out_ptr(phase_cycles, "phase_cycles", torch.int64, (nb, 3), dev),
        plane_p, nb, G, c, R, K, hashing.rotation_salt(cfg.seed), stream(dev))
    if err:
        raise RuntimeError(f"sketch_codec_encode launch failed: cudaError {err}")
    LAUNCHES["sketch_encode"] += 1
    return sketch
