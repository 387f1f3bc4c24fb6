"""The order the encode kernels sum in, pinned on the CPU.

The CUDA encode (``csrc/sketch_tile.cuh:encode_block``, behind the fused
producer and the standalone encode) streams a block through a ring of
chunks of ``cuda_common.chunk_rows(cfg)`` batch rows and walks each
chunk's pairs row by row from the per-(chunk, row) lists of
``cuda_common.chunk_lists``, summing every sketch cell from +0.0 in its
owner thread. That keeps every output bit of the one-pass owner-sum only
if a row's lists over the chunks in order are its whole ``(i, j)`` list
(``row_lists``), for any chunk size, dividing G or not.

Here a plain PyTorch emulation of that schedule equals
``core/sketch.encode_blocks`` bit for bit (whose CPU ``index_add_`` adds
a row's terms in index order, the reference's (i, j) order) on dyadic and
Gaussian inputs holding empty rows, all-zero blocks and -0.0, and equals
the reference's ``sketch_encode_pallas`` in interpret mode on dyadic
inputs from the same numpy seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import CompressionConfig as JaxConfig
from repro.kernels import sketch_encode_pallas
from repro_torch.core import hashing
from repro_torch.core.config import CompressionConfig
from repro_torch.core.sketch import encode_blocks
from repro_torch.kernels.cuda_common import (CHUNK_BYTES, chunk_lists,
                                             chunk_rows, row_lists)
from test_torch_ops import STD_CFGS, STD_IDS

# chunk sizes that divide G and that do not, besides the kernels' own
CHUNKS = [1, 3, 7, 40]
# per-block densities: an all-zero block, the Bloom path's 0.1% (most
# batch rows empty), the bitmap path's 4%, and 40%
DENSITIES = (0.0, 0.001, 0.04, 0.4)


def inputs(cfg, kind, seed):
    """One block per density, with -0.0 at 1% of the zeros."""
    r = np.random.default_rng(seed)
    shape = (len(DENSITIES), cfg.group, cfg.lanes)
    if kind == "dyadic":
        vals = r.choice([-1.0, 1.0], size=shape) * np.exp2(r.integers(-2, 3, size=shape))
    else:
        vals = r.normal(size=shape)
    mask = r.random(shape) < np.asarray(DENSITIES)[:, None, None]
    x = np.where(mask, vals, 0.0).astype(np.float32)
    x[(~mask) & (r.random(shape) < 0.01)] = -0.0
    return x, np.arange(len(DENSITIES), dtype=np.int32) + 7000


def schedule_encode(xb, ids, cfg, k):
    """The encode kernels' schedule in plain PyTorch: chunks of ``k``
    batch rows in increasing i; in a chunk, the sketch rows in order and
    each row's pairs in (i, j) order; every cell summed from +0.0 by
    separate f32 adds of ``g * x`` (exact products: g is +-1)."""
    nb, G, c, R = xb.shape[0], cfg.group, cfg.lanes, cfg.rows
    ptr, ent, sign = chunk_lists(cfg, k)
    rot = hashing.block_rotations(ids, G, c, cfg.seed).reshape(nb, 3 * G).long()
    m = torch.arange(c)
    acc = torch.zeros((nb, R, c), dtype=torch.float32)
    for ch in range(-(-G // k)):
        for r in range(R):
            for q in range(ptr[ch * R + r], ptr[ch * R + r + 1]):
                t = int(ent[q])
                v = torch.gather(xb[:, t // 3], 1, (m[None] - rot[:, t, None]) % c)
                acc[:, r] = acc[:, r] + float(sign[q]) * v
    return acc


@pytest.mark.parametrize("cfg", STD_CFGS, ids=STD_IDS)
@pytest.mark.parametrize("k", CHUNKS + ["kernel"])
def test_chunk_lists_concatenate_to_row_lists(cfg, k):
    k = chunk_rows(cfg) if k == "kernel" else min(k, cfg.group)
    ptr, ent, sign = chunk_lists(cfg, k)
    row_ptr, row_ent, row_sign = row_lists(cfg)
    nch, R = -(-cfg.group // k), cfg.rows
    assert ptr.shape == (nch * R + 1,) and ptr[0] == 0 and ptr[-1] == 3 * cfg.group
    assert sorted(ent.tolist()) == list(range(3 * cfg.group))
    for r in range(R):
        q = np.concatenate([np.arange(ptr[ch * R + r], ptr[ch * R + r + 1])
                            for ch in range(nch)]).astype(np.int64)
        np.testing.assert_array_equal(ent[q], row_ent[row_ptr[r]:row_ptr[r + 1]])
        np.testing.assert_array_equal(sign[q], row_sign[row_ptr[r]:row_ptr[r + 1]])
    for ch in range(nch):      # a chunk's lists hold its own batch rows only
        i = ent[ptr[ch * R]:ptr[(ch + 1) * R]] // 3
        assert ((i >= ch * k) & (i < (ch + 1) * k)).all()


@pytest.mark.parametrize("cfg", STD_CFGS, ids=STD_IDS)
def test_chunk_rows_fit_the_ring(cfg):
    """A chunk holds at most ``CHUNK_BYTES`` of f32 (one batch row where a
    row is larger) and 1..G rows: 8 at the default c = 512."""
    k = chunk_rows(cfg)
    assert 1 <= k <= cfg.group
    assert k == 1 or 4 * k * cfg.lanes <= CHUNK_BYTES
    if cfg.lanes == 512 and cfg.group >= 8:
        assert k == 8


@pytest.mark.parametrize("cfg", STD_CFGS, ids=STD_IDS)
@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
@pytest.mark.parametrize("k", [7, "kernel"])
def test_schedule_equals_encode_blocks(cfg, kind, k):
    """Bit for bit on any input, in chunks of 7 rows (dividing G or not)
    and of the kernels' own size: the chunked order is the one-pass
    order, and a cell that starts at +0.0 is never -0.0."""
    xb, ids = inputs(cfg, kind, 11)
    xb, ids = torch.from_numpy(xb), torch.from_numpy(ids)
    want = encode_blocks(xb, ids, cfg)
    k = chunk_rows(cfg) if k == "kernel" else min(k, cfg.group)
    got = schedule_encode(xb, ids, cfg, k)
    assert torch.equal(got, want)
    assert not bool(torch.signbit(got[got == 0]).any())    # never -0.0
    assert not bool(got[0].any())                          # the all-zero block


@pytest.mark.parametrize("cfg", STD_CFGS, ids=STD_IDS)
def test_schedule_equals_the_pallas_kernel(cfg):
    """Dyadic inputs (every sum exact): the emulated schedule equals the
    reference's ``sketch_encode_pallas`` in interpret mode."""
    xb, ids = inputs(cfg, "dyadic", 12)
    want = np.asarray(sketch_encode_pallas(
        jnp.asarray(xb), jnp.asarray(ids),
        JaxConfig(**dataclasses.asdict(cfg)), interpret=True))
    got = schedule_encode(torch.from_numpy(xb), torch.from_numpy(ids), cfg,
                          chunk_rows(cfg))
    np.testing.assert_array_equal(got.numpy(), want)
