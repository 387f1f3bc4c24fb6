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

A geometry whose per-block state fits the card's shared memory keeps it
there (every config with ``rows * lanes`` and ``block_elems`` near the
defaults); a larger one, such as the lossless profile ``ratio=2.0,
rows=60``, runs the same kernels with that state in device memory.

The hash tables reach the kernels as small device arrays, cached per
config and device: for every sketch row ``r`` the list of ``(i, j)``
pairs with ``h_j(i) == r`` in ``(i, j)`` order (``row_ptr``/``ent``, with
their signs), plus ``h_j(i)`` and ``g_j(i)`` flat by ``3i + j``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.config import CompressionConfig
from repro_torch.core import hashing
from . import build

# Kernel launches by leg: each wrapper adds one to its leg's count where
# it launches (``_q``/``_dq``: the fxp32 quantize and dequant legs).
LAUNCHES = {"encode_pack_quantize": 0, "dequant_peel_unpack": 0,
            "encode_pack_quantize_q": 0, "dequant_peel_unpack_dq": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("sketch_wire")
    lib.sketch_wire_encode.argtypes = [_P] * 9 + [_I] * 6 + [ctypes.c_uint, _P]
    lib.sketch_wire_encode.restype = _I
    lib.sketch_wire_peel.argtypes = [_P] * 13 + [_I] * 7 + [ctypes.c_uint, _P]
    lib.sketch_wire_peel.restype = _I
    lib.sketch_wire_encode_smem.argtypes = [_I, _I, _I]
    lib.sketch_wire_encode_smem.restype = ctypes.c_size_t
    lib.sketch_wire_peel_smem.argtypes = [_I, _I, _I, _I]
    lib.sketch_wire_peel_smem.restype = ctypes.c_size_t
    lib.sketch_wire_max_smem.argtypes = [_I]
    lib.sketch_wire_max_smem.restype = _I
    return lib


def row_lists(cfg: CompressionConfig):
    """(row_ptr (rows+1,), ent (3G,), ent_sign (3G,)): for each sketch
    row the flat indices ``3i + j`` hashing to it, in ``(i, j)`` order."""
    rows_tbl = hashing.batch_rows(cfg.group, cfg.rows, cfg.seed).reshape(-1)
    signs = hashing.batch_signs(cfg.group, cfg.seed).reshape(-1)
    ent = np.argsort(rows_tbl, kind="stable").astype(np.int32)
    counts = np.bincount(rows_tbl, minlength=cfg.rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return row_ptr, ent, signs[ent].astype(np.float32)


@functools.lru_cache(maxsize=64)
def _tables(cfg: CompressionConfig, device: torch.device):
    row_ptr, ent, ent_sign = row_lists(cfg)
    hrow = hashing.batch_rows(cfg.group, cfg.rows, cfg.seed).reshape(-1)
    sign = hashing.batch_signs(cfg.group, cfg.seed).reshape(-1)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (row_ptr, ent, ent_sign, hrow, sign))


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def resident(cfg: CompressionConfig, smem_of, device: torch.device) -> bool:
    """Whether a kernel keeps its per-block state in shared memory:
    ``smem_of(1)`` bytes fit the card's opt-in limit. Raises if even the
    device-memory variant's ``smem_of(0)`` bytes do not."""
    if cfg.block_elems % 32:
        raise ValueError(f"block_elems={cfg.block_elems} is not a multiple of 32")
    limit = _lib().sketch_wire_max_smem(device.index)
    if limit < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: cudaError {-limit}")
    if smem_of(0) > limit:
        raise ValueError(
            f"geometry group={cfg.group} lanes={cfg.lanes} rows={cfg.rows} "
            f"needs {smem_of(0)} B of shared memory per block, the card "
            f"allows {limit}")
    return smem_of(1) <= limit


def _stream(device: torch.device):
    return _P(torch.cuda.current_stream(device).cuda_stream)


def _quant_leg(exponents, mantissa_bits, nb: int, device):
    """The fxp32 leg's (exponents pointer, M), or (None, 0) for the f32
    wire: (nb,) int32 exponents, one per block, and 2 <= M <= 30 (the
    :class:`repro_torch.net.fixedpoint.FixedPointWire` budgets)."""
    if (exponents is None) != (mantissa_bits is None):
        raise ValueError("exponents and mantissa_bits must be given together")
    if exponents is None:
        return None, 0
    _check(exponents, "exponents", torch.int32, (nb,), device)
    if not 2 <= int(mantissa_bits) <= 30:
        raise ValueError(f"mantissa_bits={mantissa_bits} outside [2, 30]")
    return exponents.data_ptr(), int(mantissa_bits)


def encode_pack_quantize_cuda(xb: torch.Tensor, block_ids: torch.Tensor,
                              cfg: CompressionConfig,
                              exponents: torch.Tensor | None = None,
                              mantissa_bits: int | None = None):
    """(nb, G, c) f32 + (nb,) int32 ids on a CUDA device -> (sketch (nb,
    rows, c), words (nb, G*c/32) int32, maxabs (nb,) f32). The sketch is
    f32, or with ``exponents`` ((nb,) int32) and ``mantissa_bits`` the
    fxp32 int32 sketch of the quantize leg; maxabs is the f32 max|sketch|
    either way."""
    dev = xb.device
    nb, G, c, R = xb.shape[0], cfg.group, cfg.lanes, cfg.rows
    _check(xb, "xb", torch.float32, (nb, G, c), dev)
    _check(block_ids, "block_ids", torch.int32, (nb,), dev)
    exps, mbits = _quant_leg(exponents, mantissa_bits, nb, dev)
    lib = _lib()
    res = resident(cfg, lambda r: lib.sketch_wire_encode_smem(G, c, r), dev)
    row_ptr, ent, ent_sign, _, _ = _tables(cfg, dev)
    sketch = torch.empty((nb, R, c), device=dev,
                         dtype=torch.float32 if exps is None else torch.int32)
    words = torch.empty((nb, G * c // 32), dtype=torch.int32, device=dev)
    maxabs = torch.empty((nb,), dtype=torch.float32, device=dev)
    err = lib.sketch_wire_encode(
        xb.data_ptr(), block_ids.data_ptr(), row_ptr.data_ptr(),
        ent.data_ptr(), ent_sign.data_ptr(), sketch.data_ptr(),
        words.data_ptr(), maxabs.data_ptr(), exps, nb, G, c, R, mbits,
        int(res), hashing.rotation_salt(cfg.seed), _stream(dev))
    if err:
        raise RuntimeError(f"sketch_wire_encode launch failed: cudaError {err}")
    LAUNCHES["encode_pack_quantize" if exps is None
             else "encode_pack_quantize_q"] += 1
    return sketch, words, maxabs


def dequant_peel_unpack_cuda(sketch: torch.Tensor, words: torch.Tensor,
                             block_ids: torch.Tensor, cfg: CompressionConfig,
                             exponents: torch.Tensor | None = None,
                             mantissa_bits: int | None = None):
    """(nb, rows, c) sketch + (nb, G*c/32) int32 words + (nb,) int32 ids
    on a CUDA device -> (values (nb, G, c) f32, residual (nb, G, c)
    int8). The sketch is the f32 aggregate, or with ``exponents`` ((nb,)
    int32) and ``mantissa_bits`` the fxp32 int32 aggregate, dequantized
    where the kernel loads it."""
    dev = sketch.device
    nb, G, c, R = sketch.shape[0], cfg.group, cfg.lanes, cfg.rows
    exps, mbits = _quant_leg(exponents, mantissa_bits, nb, dev)
    _check(sketch, "sketch", torch.float32 if exps is None else torch.int32,
           (nb, R, c), dev)
    _check(words, "words", torch.int32, (nb, G * c // 32), dev)
    _check(block_ids, "block_ids", torch.int32, (nb,), dev)
    lib = _lib()
    res = resident(cfg, lambda r: lib.sketch_wire_peel_smem(G, c, R, r), dev)
    row_ptr, ent, ent_sign, hrow, sign = _tables(cfg, dev)
    values = torch.empty((nb, G, c), dtype=torch.float32, device=dev)
    residual = torch.empty((nb, G, c), dtype=torch.int8, device=dev)
    # y and the degrees, where they do not fit shared memory
    y_dev = torch.empty((0 if res else nb, R, c), dtype=torch.float32, device=dev)
    d_dev = torch.empty((0 if res else nb, R, c), dtype=torch.int32, device=dev)
    err = lib.sketch_wire_peel(
        sketch.data_ptr(), words.data_ptr(), block_ids.data_ptr(),
        row_ptr.data_ptr(), ent.data_ptr(), ent_sign.data_ptr(),
        hrow.data_ptr(), sign.data_ptr(), exps, values.data_ptr(),
        residual.data_ptr(), y_dev.data_ptr(), d_dev.data_ptr(), nb, G, c, R,
        cfg.rounds, mbits, int(res), hashing.rotation_salt(cfg.seed),
        _stream(dev))
    if err:
        raise RuntimeError(f"sketch_wire_peel launch failed: cudaError {err}")
    LAUNCHES["dequant_peel_unpack" if exps is None
             else "dequant_peel_unpack_dq"] += 1
    return values, residual
