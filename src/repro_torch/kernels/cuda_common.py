"""What every CUDA kernel wrapper of this package shares: the launch
counters, the hash tables the kernels read, the input checks, the choice
between a kernel's shared-memory and device-memory variants, the peel
kernels' scratch, the occupancy query, and the stream.

The hash tables reach the kernels as small device arrays, cached per
config and device. The peel kernels read, for every sketch row ``r``, the
list of ``(i, j)`` pairs with ``h_j(i) == r`` in ``(i, j)`` order
(``row_ptr``/``ent``), plus ``h_j(i)`` and ``g_j(i)`` flat by ``3i + j``.
The encode kernels stream a block in chunks of :func:`chunk_rows` batch
rows and read the same lists cut per (chunk, row) (:func:`chunk_lists`),
with their signs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.config import CompressionConfig
from repro_torch.core import hashing

# Kernel launches by wrapper (and by leg of the fused kernels: ``_q``/
# ``_dq`` are the fxp32 quantize and dequant legs; ``adam_update`` is the
# optimizer's, the others the codec's). Each wrapper adds one to its count
# where it launches, and nowhere else.
CODEC_KERNELS = ("encode_pack_quantize", "dequant_peel_unpack",
                 "encode_pack_quantize_q", "dequant_peel_unpack_dq",
                 "sketch_encode", "sketch_peel")
LAUNCHES = {**dict.fromkeys(CODEC_KERNELS, 0), "adam_update": 0}

P = ctypes.c_void_p
I = ctypes.c_int


def row_lists(cfg: CompressionConfig):
    """(row_ptr (rows+1,), ent (3G,), ent_sign (3G,)): for each sketch
    row the flat indices ``3i + j`` hashing to it, in ``(i, j)`` order."""
    rows_tbl = hashing.batch_rows(cfg.group, cfg.rows, cfg.seed).reshape(-1)
    signs = hashing.batch_signs(cfg.group, cfg.seed).reshape(-1)
    ent = np.argsort(rows_tbl, kind="stable").astype(np.int32)
    counts = np.bincount(rows_tbl, minlength=cfg.rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return row_ptr, ent, signs[ent].astype(np.float32)


# Bytes of x an encode block stages a chunk: 16 KiB, 8 batch rows at c=512.
CHUNK_BYTES = 16384


def chunk_rows(cfg: CompressionConfig) -> int:
    """Batch rows a chunk of the encode kernels' ring holds: about
    ``CHUNK_BYTES`` of f32, at least 1 and at most G."""
    return max(1, min(cfg.group, CHUNK_BYTES // (4 * cfg.lanes)))


def chunk_lists(cfg: CompressionConfig, k: int):
    """(chunk_ptr (nchunks * rows + 1,), ent (3G,), ent_sign (3G,)): for
    each chunk of ``k`` batch rows (chunk ``i // k``) and each sketch row
    ``r``, the flat indices ``3i + j`` of that chunk hashing to ``r``, in
    ``(i, j)`` order, at ``ent[chunk_ptr[chunk * rows + r] ..
    chunk_ptr[chunk * rows + r + 1])``. A row's lists over the chunks in
    order are its :func:`row_lists` list."""
    rows_tbl = hashing.batch_rows(cfg.group, cfg.rows, cfg.seed).reshape(-1)
    signs = hashing.batch_signs(cfg.group, cfg.seed).reshape(-1)
    nchunks = -(-cfg.group // k)
    key = (np.arange(3 * cfg.group) // 3) // k * cfg.rows + rows_tbl
    ent = np.argsort(key, kind="stable").astype(np.int32)
    counts = np.bincount(key, minlength=nchunks * cfg.rows)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return ptr, ent, signs[ent].astype(np.float32)


def _on(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


@functools.lru_cache(maxsize=64)
def tables(cfg: CompressionConfig, device: torch.device):
    """The peel kernels' (row_ptr, ent, hrow, sign) on ``device``."""
    row_ptr, ent, _ = row_lists(cfg)
    hrow = hashing.batch_rows(cfg.group, cfg.rows, cfg.seed).reshape(-1)
    sign = hashing.batch_signs(cfg.group, cfg.seed).reshape(-1)
    return _on(device, row_ptr, ent, hrow, sign)


@functools.lru_cache(maxsize=64)
def encode_tables(cfg: CompressionConfig, device: torch.device):
    """The encode kernels' (chunk_ptr, ent, ent_sign) on ``device``, for
    chunks of :func:`chunk_rows` batch rows."""
    return _on(device, *chunk_lists(cfg, chunk_rows(cfg)))


def plane_scratch(cfg: CompressionConfig, nb: int, res: bool,
                  device: torch.device):
    """Where an encode kernel's plane variant keeps its accumulators when
    they do not fit shared memory (``res`` False): (nb, rows, lanes) f32
    of device memory, passed as its pointer; None (NULL) otherwise."""
    if res:
        return None, None
    t = torch.empty((nb, cfg.rows, cfg.lanes), dtype=torch.float32,
                    device=device)
    return t, t.data_ptr()


def check(t: torch.Tensor, name: str, dtype, shape, device):
    """Raise unless ``t`` lies on ``device`` with ``dtype`` (one dtype or
    a tuple of them) and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes "
                        f"{' or '.join(map(str, dtypes))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def resident(cfg: CompressionConfig, smem_of, max_smem,
             device: torch.device) -> bool:
    """Whether a kernel keeps its per-block state in shared memory (a
    peel's per-cell planes; an encode's accumulator plane, where its
    geometry takes the plane instance): ``smem_of(1)`` bytes fit the
    card's opt-in limit, which the library function
    ``max_smem(device_index)`` reports. Raises if even the device-memory
    variant's ``smem_of(0)`` bytes do not fit."""
    limit = max_smem(device.index)
    if limit < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: cudaError {-limit}")
    if smem_of(0) > limit:
        raise ValueError(
            f"geometry group={cfg.group} lanes={cfg.lanes} rows={cfg.rows} "
            f"needs {smem_of(0)} B of shared memory per block, the card "
            f"allows {limit}")
    return smem_of(1) <= limit


def peel_scratch(cfg: CompressionConfig, nb: int, res: bool,
                 device: torch.device) -> torch.Tensor:
    """The device-memory scratch a peel kernel keeps its per-cell state
    in (y, the degrees and the round's contributions: 4 planes of (rows,
    lanes) a block) where it does not fit shared memory (``res`` False);
    empty otherwise."""
    return torch.empty((0 if res else nb, 4, cfg.rows, cfg.lanes),
                       dtype=torch.float32, device=device)


def out_ptr(t, name: str, dtype, shape, device: torch.device):
    """The pointer a kernel writes an optional per-block record to (a
    peel's ``block_rounds``, an encode's ``phase_cycles``): NULL (None)
    without ``t``, else its data, checked against ``dtype`` and
    ``shape``. The training path passes none."""
    if t is None:
        return None
    check(t, name, dtype, shape, device)
    return t.data_ptr()


def occupancy(query, kind: int, cfg: CompressionConfig, smem_of, max_smem,
              device: torch.device):
    """(blocks of kernel ``kind`` one SM of ``device`` holds at once, its
    dynamic shared memory bytes) at ``cfg``'s geometry, in the variant the
    wrappers launch there; ``query`` is the library's occupancy export."""
    res = int(resident(cfg, smem_of, max_smem, device))
    with torch.cuda.device(device):
        blocks = query(kind, cfg.group, cfg.lanes, cfg.rows, chunk_rows(cfg),
                       res)
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed: cudaError {-blocks}")
    return blocks, int(smem_of(res))


def stream(device: torch.device):
    """PyTorch's current stream on ``device``, for a ctypes call."""
    return P(torch.cuda.current_stream(device).cuda_stream)
