"""PyTorch wrappers of the fused wire-codec CUDA kernels.

The kernels (``csrc/sketch_wire.cu``) replace the reference's Pallas
``encode_pack_quantize_pallas`` and ``dequant_peel_unpack_pallas``, each
in both of its legs: the f32 wire, and with ``exponents`` and
``mantissa_bits`` the fxp32 wire's quantize leg (the producer stores the
int32 sketch ``rint(acc * 2^(M - e))``) and dequant leg (the consumer
peels the int32 aggregate as ``float(q) * 2^(e - M)``). Each wrapper
checks its inputs, allocates the outputs with ``torch.empty``, launches
on PyTorch's current stream, raises if the launch reports an error, and
adds one to its leg's count in :data:`LAUNCHES`.

The producer streams each block's batch rows through a ring of
shared-memory chunks (:func:`cuda_common.chunk_rows` rows each) and keeps
its sketch cells in registers, or for many rows (the lossless profile
``ratio=2.0, rows=60``) in a plane of shared memory, or of device memory
where that does not fit. The consumer keeps its per-block state in shared
memory where it fits (every config with ``rows * lanes`` and
``block_elems`` near the defaults) and in device memory otherwise, and
runs each block's peel rounds until that block's fixpoint, at most
``cfg.rounds``: rounds after it peel nothing, so the result is that of
all ``cfg.rounds`` rounds.

The hash tables, input checks and launch counters are
:mod:`repro_torch.kernels.cuda_common`'s.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.config import CompressionConfig
from repro_torch.core import hashing
from . import build
from .cuda_common import (I, LAUNCHES, P, check, chunk_rows, encode_tables,
                          occupancy, out_ptr, peel_scratch, plane_scratch,
                          resident, stream, tables)

# the occupancy export's kernel numbers, by launch counter
_KINDS = {"encode_pack_quantize": 0, "encode_pack_quantize_q": 1,
          "dequant_peel_unpack": 2, "dequant_peel_unpack_dq": 3}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("sketch_wire")
    lib.sketch_wire_encode.argtypes = [P] * 11 + [I] * 6 + [ctypes.c_uint, P]
    lib.sketch_wire_encode.restype = I
    lib.sketch_wire_peel.argtypes = [P] * 12 + [I] * 7 + [ctypes.c_uint, P]
    lib.sketch_wire_peel.restype = I
    lib.sketch_wire_encode_smem.argtypes = [I] * 5
    lib.sketch_wire_encode_smem.restype = ctypes.c_size_t
    lib.sketch_wire_peel_smem.argtypes = [I, I, I, I]
    lib.sketch_wire_peel_smem.restype = ctypes.c_size_t
    lib.sketch_wire_max_smem.argtypes = [I]
    lib.sketch_wire_max_smem.restype = I
    lib.sketch_wire_occupancy.argtypes = [I] * 6
    lib.sketch_wire_occupancy.restype = I
    lib.sketch_wire_threads.argtypes = [I, I]
    lib.sketch_wire_threads.restype = I
    return lib


def _resident(cfg: CompressionConfig, smem_of, device: torch.device) -> bool:
    if cfg.block_elems % 32:
        raise ValueError(f"block_elems={cfg.block_elems} is not a multiple of 32")
    return resident(cfg, smem_of, _lib().sketch_wire_max_smem, device)


def wire_occupancy(name: str, cfg: CompressionConfig, device: torch.device):
    """(blocks one SM holds at once, dynamic shared memory bytes) of the
    kernel behind launch counter ``name`` at ``cfg``'s geometry."""
    lib, G, c, R = _lib(), cfg.group, cfg.lanes, cfg.rows
    kind = _KINDS[name]
    if kind < 2:
        K = chunk_rows(cfg)
        smem_of = lambda r: lib.sketch_wire_encode_smem(G, c, R, K, r)
    else:
        smem_of = lambda r: lib.sketch_wire_peel_smem(G, c, R, r)
    return occupancy(lib.sketch_wire_occupancy, kind, cfg, smem_of,
                     lib.sketch_wire_max_smem, device)


def wire_threads(name: str, cfg: CompressionConfig) -> int:
    """Threads of a block of the kernel behind launch counter ``name`` at
    ``cfg``'s geometry."""
    return _lib().sketch_wire_threads(_KINDS[name], cfg.lanes)


def _quant_leg(exponents, mantissa_bits, nb: int, device):
    """The fxp32 leg's (exponents pointer, M), or (None, 0) for the f32
    wire: (nb,) int32 exponents, one per block, and 2 <= M <= 30 (the
    :class:`repro_torch.net.fixedpoint.FixedPointWire` budgets)."""
    if (exponents is None) != (mantissa_bits is None):
        raise ValueError("exponents and mantissa_bits must be given together")
    if exponents is None:
        return None, 0
    check(exponents, "exponents", torch.int32, (nb,), device)
    if not 2 <= int(mantissa_bits) <= 30:
        raise ValueError(f"mantissa_bits={mantissa_bits} outside [2, 30]")
    return exponents.data_ptr(), int(mantissa_bits)


def encode_pack_quantize_cuda(xb: torch.Tensor, block_ids: torch.Tensor,
                              cfg: CompressionConfig,
                              exponents: torch.Tensor | None = None,
                              mantissa_bits: int | None = None,
                              phase_cycles: torch.Tensor | None = None):
    """(nb, G, c) f32 + (nb,) int32 ids on a CUDA device -> (sketch (nb,
    rows, c), words (nb, G*c/32) int32, maxabs (nb,) f32). The sketch is
    f32, or with ``exponents`` ((nb,) int32) and ``mantissa_bits`` the
    fxp32 int32 sketch of the quantize leg; maxabs is the f32 max|sketch|
    either way. ``phase_cycles``, a (nb, 3) int64 tensor where given,
    takes each block's ``clock64`` cycles waiting on its loads, summing,
    and in all (the training path passes none)."""
    dev = xb.device
    nb, G, c, R = xb.shape[0], cfg.group, cfg.lanes, cfg.rows
    check(xb, "xb", torch.float32, (nb, G, c), dev)
    check(block_ids, "block_ids", torch.int32, (nb,), dev)
    exps, mbits = _quant_leg(exponents, mantissa_bits, nb, dev)
    lib, K = _lib(), chunk_rows(cfg)
    res = _resident(cfg, lambda r: lib.sketch_wire_encode_smem(G, c, R, K, r),
                    dev)
    cptr, ent, ent_sign = encode_tables(cfg, dev)
    plane, plane_p = plane_scratch(cfg, nb, res, dev)   # held through the launch
    sketch = torch.empty((nb, R, c), device=dev,
                         dtype=torch.float32 if exps is None else torch.int32)
    words = torch.empty((nb, G * c // 32), dtype=torch.int32, device=dev)
    maxabs = torch.empty((nb,), dtype=torch.float32, device=dev)
    err = lib.sketch_wire_encode(
        xb.data_ptr(), block_ids.data_ptr(), cptr.data_ptr(), ent.data_ptr(),
        ent_sign.data_ptr(), sketch.data_ptr(), words.data_ptr(),
        maxabs.data_ptr(), exps,
        out_ptr(phase_cycles, "phase_cycles", torch.int64, (nb, 3), dev),
        plane_p, nb, G, c, R, K, mbits, hashing.rotation_salt(cfg.seed),
        stream(dev))
    if err:
        raise RuntimeError(f"sketch_wire_encode launch failed: cudaError {err}")
    LAUNCHES["encode_pack_quantize" if exps is None
             else "encode_pack_quantize_q"] += 1
    return sketch, words, maxabs


def dequant_peel_unpack_cuda(sketch: torch.Tensor, words: torch.Tensor,
                             block_ids: torch.Tensor, cfg: CompressionConfig,
                             exponents: torch.Tensor | None = None,
                             mantissa_bits: int | None = None,
                             block_rounds: torch.Tensor | None = None):
    """(nb, rows, c) sketch + (nb, G*c/32) int32 words + (nb,) int32 ids
    on a CUDA device -> (values (nb, G, c) f32, residual (nb, G, c)
    int8). The sketch is the f32 aggregate, or with ``exponents`` ((nb,)
    int32) and ``mantissa_bits`` the fxp32 int32 aggregate, dequantized
    where the kernel loads it. ``block_rounds``, a (nb,) int32 tensor
    where given, takes each block's rounds run (the training path passes
    none)."""
    dev = sketch.device
    nb, G, c, R = sketch.shape[0], cfg.group, cfg.lanes, cfg.rows
    exps, mbits = _quant_leg(exponents, mantissa_bits, nb, dev)
    check(sketch, "sketch", torch.float32 if exps is None else torch.int32,
          (nb, R, c), dev)
    check(words, "words", torch.int32, (nb, G * c // 32), dev)
    check(block_ids, "block_ids", torch.int32, (nb,), dev)
    lib = _lib()
    res = _resident(cfg, lambda r: lib.sketch_wire_peel_smem(G, c, R, r), dev)
    row_ptr, ent, hrow, sign = tables(cfg, dev)
    values = torch.empty((nb, G, c), dtype=torch.float32, device=dev)
    residual = torch.empty((nb, G, c), dtype=torch.int8, device=dev)
    state = peel_scratch(cfg, nb, res, dev)
    err = lib.sketch_wire_peel(
        sketch.data_ptr(), words.data_ptr(), block_ids.data_ptr(),
        row_ptr.data_ptr(), ent.data_ptr(), hrow.data_ptr(), sign.data_ptr(),
        exps, values.data_ptr(), residual.data_ptr(),
        out_ptr(block_rounds, "block_rounds", torch.int32, (nb,), dev),
        state.data_ptr(), nb, G, c, R,
        cfg.rounds, mbits, int(res), hashing.rotation_salt(cfg.seed),
        stream(dev))
    if err:
        raise RuntimeError(f"sketch_wire_peel launch failed: cudaError {err}")
    LAUNCHES["dequant_peel_unpack" if exps is None
             else "dequant_peel_unpack_dq"] += 1
    return values, residual
