"""PyTorch port vs the JAX reference: hash tables, rotations, block layout
and bitmap packing. Everything here is integer-valued, so every
comparison is exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import CompressionConfig as JaxConfig
from repro.core import blocks as jblocks
from repro.core import hashing as jhash
from repro.core import index as jindex
from repro_torch.core import blocks as tblocks
from repro_torch.core import hashing as thash
from repro_torch.core import index as tindex
from repro_torch.core.config import CompressionConfig


def test_config_converts_field_for_field():
    jc = JaxConfig(ratio=0.1, topk_ratio=0.04)
    tc = CompressionConfig(**dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(CompressionConfig()) == dataclasses.asdict(JaxConfig())
    for n in (1, 30720, 445_138_944):
        assert tc.bucket_elems_for(n) == jc.bucket_elems_for(n)
        assert tc.num_buckets(n) == jc.num_buckets(n)
    assert (tc.group, tc.block_elems, tc.bucket_quantum) == \
        (jc.group, jc.block_elems, jc.bucket_quantum)


def test_mix32_matches_reference():
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    x = np.concatenate([x, [0, 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    want = np.asarray(jhash.mix32(jnp.asarray(x)))
    got = thash.mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    # the numpy mixer updates its argument in place, as the reference does
    np.testing.assert_array_equal(thash.mix32_np(x.copy()), jhash.mix32_np(x.copy()))


@pytest.mark.parametrize("group,rows,seed", [(60, 6, 0x5EED), (30, 60, 0x5EED),
                                             (7, 3, 1), (120, 12, 12345)])
def test_batch_tables_match_reference(group, rows, seed):
    np.testing.assert_array_equal(thash.batch_rows(group, rows, seed),
                                  jhash.batch_rows(group, rows, seed))
    np.testing.assert_array_equal(thash.batch_signs(group, seed),
                                  jhash.batch_signs(group, seed))


@pytest.mark.parametrize("lanes", [512, 128, 100, 129, 8])
@pytest.mark.parametrize("offset", [0, 37, 7000, 2**31 - 5])
def test_block_rotations_match_reference(lanes, offset):
    """Offset block ids (mid-stream buckets, up to the int32 edge) and odd
    lane counts."""
    ids = (np.arange(6, dtype=np.int64) + offset).astype(np.int32)
    want = np.asarray(jhash.block_rotations(jnp.asarray(ids), 60, lanes, 0x5EED))
    got = thash.block_rotations(torch.from_numpy(ids), 60, lanes, 0x5EED)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_words", [1, 3, 960])
@pytest.mark.parametrize("density", [0.0, 0.04, 0.5, 1.0])
def test_pack_unpack_match_reference(n_words, density):
    bits = np.random.default_rng(n_words).random(n_words * 32) < density
    want = np.asarray(jindex.pack_bits(jnp.asarray(bits))).view(np.int32)
    got = tindex.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tindex.unpack_bits(got, (n_words, 32)).numpy().reshape(-1)
    np.testing.assert_array_equal(back, bits)
    assert int(tindex.popcount(got)) == int(bits.sum())


def test_pack_rejects_ragged():
    with pytest.raises(ValueError):
        tindex.pack_bits(torch.zeros(33, dtype=torch.bool))


@pytest.mark.parametrize("n", [1, 767, 768, 769, 5000])
def test_block_layout_matches_reference(n):
    cfg = CompressionConfig(ratio=0.5, lanes=128, rows=3)
    jcfg = JaxConfig(ratio=0.5, lanes=128, rows=3)
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    plan = tblocks.make_plan(n, cfg)
    assert dataclasses.astuple(plan) == dataclasses.astuple(jblocks.make_plan(n, jcfg))
    xb = tblocks.to_blocks(torch.from_numpy(x), plan)
    np.testing.assert_array_equal(
        xb.numpy(), np.asarray(jblocks.to_blocks(jnp.asarray(x),
                                                 jblocks.make_plan(n, jcfg))))
    np.testing.assert_array_equal(tblocks.from_blocks(xb, plan).numpy(), x)
