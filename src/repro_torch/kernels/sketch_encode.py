"""PyTorch wrapper of the standalone Count-Sketch encode CUDA kernel.

The kernel (``csrc/sketch_codec.cu:sketch_encode_kernel``) replaces the
reference's Pallas ``sketch_encode_pallas``: (nb, G, c) values + (nb,)
int32 block ids -> (nb, rows, c) f32 sketch, the fused producer's sketch
without its words and max, bit for bit. It serves the geometries the
fused kernels do not (the Bloom index, ``block_elems % 32 != 0``).

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
from .cuda_common import (I, LAUNCHES, P, check, occupancy, resident, stream,
                          tables)

VALUE_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("sketch_codec")
    lib.sketch_codec_encode.argtypes = [P] * 6 + [I] * 5 + [ctypes.c_uint, P]
    lib.sketch_codec_encode.restype = I
    lib.sketch_codec_encode_smem.argtypes = [I, I, I]
    lib.sketch_codec_encode_smem.restype = ctypes.c_size_t
    lib.sketch_codec_max_smem.argtypes = [I]
    lib.sketch_codec_max_smem.restype = I
    lib.sketch_codec_occupancy.argtypes = [I] * 5
    lib.sketch_codec_occupancy.restype = I
    return lib


def encode_occupancy(cfg: CompressionConfig, device: torch.device):
    """(blocks one SM holds at once, dynamic shared memory bytes) of the
    encode kernel at ``cfg``'s geometry."""
    lib, G, c = _lib(), cfg.group, cfg.lanes
    return occupancy(lib.sketch_codec_occupancy, 0, cfg,
                     lambda r: lib.sketch_codec_encode_smem(G, c, r),
                     lib.sketch_codec_max_smem, device)


def sketch_encode_cuda(xb: torch.Tensor, block_ids: torch.Tensor,
                       cfg: CompressionConfig) -> torch.Tensor:
    """(nb, G, c) f32/f16/bf16 + (nb,) int32 ids on a CUDA device ->
    (nb, rows, c) f32 sketch."""
    dev = xb.device
    nb, G, c, R = xb.shape[0], cfg.group, cfg.lanes, cfg.rows
    check(xb, "xb", VALUE_DTYPES, (nb, G, c), dev)
    check(block_ids, "block_ids", torch.int32, (nb,), dev)
    xb = xb.to(torch.float32)
    lib = _lib()
    res = resident(cfg, lambda r: lib.sketch_codec_encode_smem(G, c, r),
                   lib.sketch_codec_max_smem, dev)
    row_ptr, ent, ent_sign, _, _ = tables(cfg, dev)
    sketch = torch.empty((nb, R, c), dtype=torch.float32, device=dev)
    err = lib.sketch_codec_encode(
        xb.data_ptr(), block_ids.data_ptr(), row_ptr.data_ptr(),
        ent.data_ptr(), ent_sign.data_ptr(), sketch.data_ptr(), nb, G, c, R,
        int(res), hashing.rotation_salt(cfg.seed), stream(dev))
    if err:
        raise RuntimeError(f"sketch_codec_encode launch failed: cudaError {err}")
    LAUNCHES["sketch_encode"] += 1
    return sketch
