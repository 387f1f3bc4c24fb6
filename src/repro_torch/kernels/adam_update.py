"""PyTorch wrapper of the AdamW update CUDA kernel.

The kernel (``csrc/adam_update.cu``) replaces no TPU kernel: it runs
``train/optimizer.py``'s ``clip_grads`` and ``opt_leaf_update`` (AdamW)
over a leaf, or over the local workers' ZeRO-1 slices of a leaf, in one
pass, equal to them on the card bit for bit. The step scalars (lr,
``1 - b1^t``, ``1 - b2^t``, the clip scale) reach it as a (4,) f32 device
tensor (``optimizer.step_scalars``), so nothing is copied from the host.

:func:`adam_update_cuda` takes each slice's parameter, aggregate and two
moments as views of one shape. With ``dim`` None each is a whole leaf and
the parameter is updated in place; otherwise each is a slice on dim
``dim`` of its leaf and the call returns each slice's delta
``dtype(f32(new_p) - f32(p))``, contiguous in the ``movedim(dim, 0)``
layout that ``group.gather`` takes. The moments are updated in place in
both. Every view must hold its dims from ``dim`` on contiguously and its
dims before ``dim`` at one stride (a narrow of a contiguous leaf does):
:func:`layout` raises for anything else, as for a dtype the kernel does
not take. The wrapper launches on PyTorch's current stream, once a
``MAX_SLICES`` slices, raises if a launch reports an error, and adds one
to ``LAUNCHES["adam_update"]`` a launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import build
from .cuda_common import I, LAUNCHES, P, stream

PARAM_DTYPES = (torch.float32, torch.bfloat16)
GRAD_DTYPES = (torch.float32, torch.bfloat16)
MOMENT_DTYPES = (torch.float32, torch.bfloat16)
MAX_SLICES = 8      # csrc/adam_update.cu:kMaxSlices
VEC = 8             # elements a thread moves a step (16 B of bf16)
LL = ctypes.c_longlong
F = ctypes.c_float


class _Slice(ctypes.Structure):
    """``csrc/adam_update.cu:AdamSlice``."""
    _fields_ = [("p", P), ("g", P), ("m", P), ("v", P), ("delta", P),
                ("so_p", LL), ("so_g", LL), ("so_m", LL), ("so_v", LL)]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("adam_update")
    lib.adam_update.argtypes = ([ctypes.POINTER(_Slice), I, LL, LL, LL, P]
                                + [F] * 6 + [I] * 6 + [P])
    lib.adam_update.restype = I
    lib.adam_update_max_slices.restype = I
    lib.adam_update_occupancy.argtypes = [I] * 4
    lib.adam_update_occupancy.restype = I
    if lib.adam_update_max_slices() != MAX_SLICES:
        raise RuntimeError("adam_update.cu's kMaxSlices differs from MAX_SLICES")
    return lib


class Layout(NamedTuple):
    """The geometry every view of a call shares, as the kernel walks it:
    ``outer`` (the dims before the slice dim) x ``rows`` (the slice dim)
    x ``run`` (the dims after it; ``outer == 1`` folds the slice into one
    run), and whether it takes the transposing tile kernel (``run == 1 <
    outer``)."""
    outer: int
    rows: int
    run: int

    @property
    def tile(self) -> bool:
        return self.run == 1 and self.outer > 1


def _outer_stride(shape, strides, d: int, name: str) -> int:
    """The stride of a view's dims before ``d`` taken as one dim, where
    its dims from ``d`` on lie contiguous; raises otherwise."""
    inner = 1
    for k in range(len(shape) - 1, d - 1, -1):
        if shape[k] != 1 and strides[k] != inner:
            raise ValueError(f"{name}: strides {strides} of shape {shape} are "
                             f"not contiguous from dim {d} on, which the "
                             "kernel takes")
        inner *= shape[k]
    so, nxt = 0, None
    for k in range(d - 1, -1, -1):
        if shape[k] == 1:
            continue
        if nxt is not None and strides[k] != nxt:
            raise ValueError(f"{name}: strides {strides} of shape {shape} do "
                             f"not fold the dims before {d} into one, which "
                             "the kernel takes")
        if nxt is None:
            so = strides[k]
        nxt = strides[k] * shape[k]
    return so


NAMES = ("param", "grad", "m", "v")
DTYPES = (PARAM_DTYPES, GRAD_DTYPES, MOMENT_DTYPES, MOMENT_DTYPES)


@functools.lru_cache(maxsize=4096)
def _layout(specs, dim: Optional[int]):
    """:func:`layout` of the slices' ``(dtype, shape, strides)`` specs,
    one 4-tuple (param, grad, m, v) a slice; cached, as a step repeats
    its leaves' layouts."""
    if not specs:
        raise ValueError("no slice to update")
    shape = specs[0][0][1]
    for slc in specs:
        for (dtype, sh, _), name, dtypes in zip(slc, NAMES, DTYPES):
            if dtype not in dtypes:
                raise TypeError(f"{name} has dtype {dtype}, the kernel takes "
                                f"{' or '.join(map(str, dtypes))}")
            if sh != shape:
                raise ValueError(f"{name} has shape {sh}, the slices' is {shape}")
        if tuple(x[0] for x in slc[:3]) != tuple(x[0] for x in specs[0][:3]) \
                or slc[3][0] != slc[2][0]:
            raise TypeError("the slices' params, grads and moments must each "
                            "share one dtype, and m and v theirs")
    d = 0 if dim is None else dim
    if not (0 <= d < max(len(shape), 1)):
        raise ValueError(f"dim {dim} of a slice of shape {shape}")
    outer = int(np.prod(shape[:d], dtype=np.int64))
    rows = shape[d] if shape else 1
    run = int(np.prod(shape[d + 1:], dtype=np.int64))
    strides = tuple(tuple(_outer_stride(sh, st, d, name)
                          for (_, sh, st), name in zip(slc, NAMES))
                    for slc in specs)
    geo = Layout(1, 1, rows * run) if outer == 1 else Layout(outer, rows, run)
    if geo.outer * geo.rows * -(-geo.run // VEC) >= 2 ** 32:
        raise ValueError(f"a slice of shape {shape} is too large for the "
                         "kernel's 32-bit item count")
    return geo, strides


def layout(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
           dim: Optional[int]):
    """(:class:`Layout`, each slice's outer strides ``(p, g, m, v)``) of
    one call; raises for what the kernel does not take (dtypes, shapes,
    strides), on any device."""
    n = len(params)
    if not (len(grads) == len(m) == len(v) == n):
        raise ValueError(f"{n} params, {len(grads)} grads, {len(m)} and "
                         f"{len(v)} moments: one of each a slice")
    return _layout(tuple(tuple((t.dtype, tuple(t.shape), t.stride())
                               for t in slc) for slc in zip(params, grads, m, v)),
                   dim)


def _aligned(geo: Layout, ptrs: Sequence[int], strides) -> bool:
    """Whether every operand's runs start on 16 bytes: 16-byte loads and
    stores of 8 elements."""
    if any(p % 16 for p in ptrs):
        return False
    if geo.outer == 1:
        return True
    return (geo.tile or geo.run % VEC == 0) and \
        all(s % VEC == 0 for so in strides for s in so)


@functools.lru_cache(maxsize=64)
def _constants(cfg):
    """The kernel's f32 constants of ``cfg``, as PyTorch's kernels take
    the Python scalars (b1, 1 - b1, b2, 1 - b2, eps, weight decay), and
    whether it clips."""
    f32 = lambda x: float(np.float32(x))
    return (f32(cfg.b1), f32(1 - cfg.b1), f32(cfg.b2), f32(1 - cfg.b2),
            f32(cfg.eps), f32(cfg.weight_decay), int(bool(cfg.grad_clip)))


def adam_update_cuda(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
                     scalars: torch.Tensor, cfg, dim: Optional[int] = None
                     ) -> Optional[List[torch.Tensor]]:
    """The AdamW update of each slice ``(params[w], grads[w], m[w],
    v[w])`` under ``cfg`` (an ``OptimizerConfig`` of kind ``adamw``;
    ``cfg.grad_clip`` applies ``scalars[3]``) with the step scalars
    ``scalars`` ((4,) f32: lr, ``1 - b1^t``, ``1 - b2^t``, the clip
    scale), on a CUDA device. ``dim`` None: whole leaves, the params
    updated in place, returns None. Else: returns each slice's delta in
    the params' dtype, shaped ``slice.movedim(dim, 0)``, contiguous."""
    if cfg.kind != "adamw":
        raise ValueError(f"the kernel runs AdamW, not {cfg.kind!r}")
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"params on {dev}: the kernel runs on a CUDA device")
    for t in (*params, *grads, *m, *v, scalars):
        if t.device != dev:
            raise ValueError(f"a tensor on {t.device}, expected {dev}")
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (4,) \
            or not scalars.is_contiguous():
        raise ValueError("scalars must be a contiguous (4,) float32 tensor")
    geo, strides = layout(params, grads, m, v, dim)
    deltas = None
    if dim is not None:
        sh = tuple(params[0].shape)
        dshape = (sh[dim],) + sh[:dim] + sh[dim + 1:]
        deltas = [torch.empty(dshape, dtype=params[0].dtype, device=dev)
                  for _ in params]
    if params[0].numel() == 0:
        return deltas
    slices = (_Slice * len(params))()
    ptrs = []
    for w in range(len(params)):
        ops = (params[w].data_ptr(), grads[w].data_ptr(), m[w].data_ptr(),
               v[w].data_ptr())
        ptrs += ops
        slices[w] = _Slice(*ops, None if deltas is None else deltas[w].data_ptr(),
                           *strides[w])
    vec = _aligned(geo, ptrs + [t.data_ptr() for t in deltas or ()], strides)
    vec_out = deltas is not None and geo.outer % VEC == 0 and \
        all(t.data_ptr() % 16 == 0 for t in deltas)
    bf = torch.bfloat16
    lib = _lib()
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = lib.adam_update(
            slices, len(params), geo.outer, geo.rows, geo.run, scalars.data_ptr(),
            *_constants(cfg), int(params[0].dtype == bf), int(grads[0].dtype == bf),
            int(m[0].dtype == bf), int(vec), int(vec_out), stream(dev))
    if err:
        raise RuntimeError(f"adam_update launch failed: cudaError {err}")
    LAUNCHES["adam_update"] += -(-len(params) // MAX_SLICES)
    return deltas


def adam_occupancy(tile: bool, p_dtype, g_dtype, m_dtype,
                   device: torch.device) -> int:
    """Blocks of the tile or rows kernel one SM of ``device`` holds at
    once for these dtypes."""
    bf = torch.bfloat16
    with torch.cuda.device(device):
        blocks = _lib().adam_update_occupancy(int(tile), int(p_dtype == bf),
                                              int(g_dtype == bf), int(m_dtype == bf))
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed: cudaError {-blocks}")
    return blocks


def adam_bytes(p_dtype, g_dtype, m_dtype, n: int) -> int:
    """Bytes one pass over ``n`` parameters moves at the least: the
    parameter and aggregate read, both moments read and written, the
    delta (or the parameter) written."""
    return n * (2 * p_dtype.itemsize + g_dtype.itemsize + 4 * m_dtype.itemsize)
