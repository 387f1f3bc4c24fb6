"""The expert-parallel all-to-all exchange of the PyTorch port against the
JAX reference and numpy: the per-destination bucket plans, the
chunk-major lane grid, the one-pass producer over a chunk's lanes, the
lane merge on ``LocalWorkers``, the dense and compressed exchanges and
their linear backward.

All exact: every payload is dyadic (every float sum exact in any order),
the words and block ids are integers, and the exchange codec runs at
ratio 2.5, whose sketch covers a fully occupied block, so the peel is
exact. For W > 1 the oracle is numpy's ``merged_r = sum_s payload_s[r]``
(the reference's own, ``tests/drivers/collectives_driver.py``); at W = 1
the reference's exchange runs in process, as ``tests/test_dispatch.py``
builds it (``use_pallas="never"``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.core import CompressionConfig as JaxCompression
from repro.core import HomomorphicCompressor as JaxCompressor
from repro.core.aggregators import make_exchange as j_make_exchange
from repro.core.bucketing import make_dest_bucket_plans as j_dest_plans
from repro.core.streams import make_alltoall_stream_plan as j_a2a_plan
from repro_torch.core.aggregators import EXCHANGES, make_exchange
from repro_torch.core.bucketing import make_dest_bucket_plans
from repro_torch.core.collectives import (LocalWorkers, alltoall_lane_sum,
                                          sketch_all_to_all)
from repro_torch.core.compressor import HomomorphicCompressor
from repro_torch.core.config import CompressionConfig
from repro_torch.core.streams import make_alltoall_stream_plan
from repro_torch.core.wireplan import pattern_wires
from test_dispatch import A2A_BASE, _a2a_payload, _run_exchange

# the reference driver's exchange config: ratio 2.5 -> G 2, 256-element
# blocks, 6 blocks a bucket, 2 buckets a destination
DRIVER = dict(ratio=2.5, lanes=128, rows=6, rounds=10, chunk_blocks=8,
              topk_ratio=None, error_feedback=False, bucket_bytes=2 * 768 * 4)
N_DEST = 2 * 1536


def _port(jcfg, **fields):
    return dataclasses.replace(CompressionConfig(**dataclasses.asdict(jcfg)),
                               **fields)


def dyadic_payload(seed, w):
    """One source's ``(w, N_DEST)`` lanes, 90% dyadic non-zeros a lane
    (the reference driver's construction)."""
    r = np.random.default_rng(seed)
    out = np.zeros((w, N_DEST), np.float32)
    for d in range(w):
        n_nz = int(N_DEST * 0.9)
        idx = r.choice(N_DEST, size=n_nz, replace=False)
        out[d, idx] = (r.choice([-1.0, 1.0], size=n_nz)
                       * np.exp2(r.integers(-2, 3, size=n_nz)))
    return out


def _words(shape, seed):
    r = np.random.default_rng(seed)
    return r.integers(0, 2**32, size=shape, dtype=np.uint32).view(np.int32)


# ----------------------------------------------------------------------
# plans and grids
# ----------------------------------------------------------------------

def _fields(plan):
    return (tuple(plan.shapes), plan.sizes, plan.offsets, plan.total,
            plan.bucket_elems, plan.n_buckets)


@pytest.mark.parametrize("w", [1, 2, 4])
def test_dest_bucket_plans_match_reference(w):
    jcfg = JaxCompression(**DRIVER)
    shapes = [(w, 3, 700), (w, 11), (w, 2, 5, 9)]
    arrays = [np.zeros(s, np.float32) for s in shapes]
    want = j_dest_plans({f"l{i}": a for i, a in enumerate(arrays)}, jcfg,
                        n_dests=w)
    got = make_dest_bucket_plans([torch.from_numpy(a) for a in arrays],
                                 _port(jcfg), n_dests=w)
    assert len(got) == len(want) == w
    assert len(set(map(id, got))) == 1            # one plan, every lane
    for g, j in zip(got, want):
        assert _fields(g) == _fields(j)


def test_dest_bucket_plans_errors_match_reference():
    jcfg = JaxCompression(**DRIVER)
    cases = [([], {}), ([(2, 5), (3, 5)], {}), ([(2, 5)], dict(n_dests=3))]
    for shapes, kw in cases:
        arrays = [np.zeros(s, np.float32) for s in shapes]
        with pytest.raises(ValueError) as want:
            j_dest_plans({f"l{i}": a for i, a in enumerate(arrays)}, jcfg, **kw)
        with pytest.raises(ValueError) as got:
            make_dest_bucket_plans([torch.from_numpy(a) for a in arrays],
                                   _port(jcfg), **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("chunks", [None, 1, 2, 4])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("lanes", [1, 3])
def test_alltoall_stream_plan_matches_reference(chunks, overlap, lanes):
    jcfg = JaxCompression(**{**DRIVER, "stream_chunks": chunks,
                             "overlap": overlap})
    arr = np.zeros((lanes, 4 * 1536), np.float32)       # 4 buckets a lane
    jplan = j_dest_plans({"g": arr}, jcfg)[0]
    plan = make_dest_bucket_plans([torch.from_numpy(arr)], _port(jcfg))[0]
    want = j_a2a_plan(jplan, jcfg, lanes=lanes, base_block=5)
    got = make_alltoall_stream_plan(plan, _port(jcfg), lanes=lanes,
                                    base_block=5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.chunk_elems, got.streamed) == (want.chunk_elems, want.streamed)
    for c in range(got.n_chunks):
        assert got.chunk_start_block(c) == int(want.chunk_start_block(c))
        for d in range(lanes):
            assert got.lane_start_block(c, d) == int(want.lane_start_block(c, d))
    stack = np.arange(lanes * 4 * 1536, dtype=np.float32).reshape(lanes, 4, 1536)
    np.testing.assert_array_equal(
        got.chunk_view(torch.from_numpy(stack)).numpy(),
        np.asarray(want.chunk_view(jnp.asarray(stack))))


def test_alltoall_stream_plan_errors_match_reference():
    arr = np.zeros((2, 3 * 1536), np.float32)           # 3 buckets a lane
    for fields, lanes in [(dict(stream_chunks=2), 2), ({}, 0)]:
        jcfg = JaxCompression(**{**DRIVER, **fields})
        jplan = j_dest_plans({"g": arr}, jcfg)[0]
        plan = make_dest_bucket_plans([torch.from_numpy(arr)], _port(jcfg))[0]
        with pytest.raises(ValueError) as want:
            j_a2a_plan(jplan, jcfg, lanes=lanes)
        with pytest.raises(ValueError) as got:
            make_alltoall_stream_plan(plan, _port(jcfg), lanes=lanes)
        assert str(got.value) == str(want.value)
    plan = make_dest_bucket_plans([torch.from_numpy(arr)],
                                  CompressionConfig(**DRIVER))[0]
    splan = make_alltoall_stream_plan(plan, CompressionConfig(**DRIVER), lanes=2)
    with pytest.raises(ValueError, match="lane buckets shape"):
        splan.chunk_view(torch.zeros(2, 3, 7))


# ----------------------------------------------------------------------
# the producer over a chunk's lanes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 37])
def test_exchange_wire_matches_reference(offset):
    jcfg = JaxCompression(**DRIVER)
    lanes, nb_c, E = 3, 2, 1536
    slab = np.stack([dyadic_payload(50 + d, 1)[0, :nb_c * E]
                     for d in range(lanes)]).reshape(lanes, nb_c, E)
    jl, jmx = JaxCompressor(jcfg).exchange_wire(jnp.asarray(slab),
                                                block_offset=offset)
    comp = HomomorphicCompressor(_port(jcfg))
    leaf, mx = comp.exchange_wire(torch.from_numpy(slab), block_offset=offset)
    np.testing.assert_array_equal(leaf.sketch.numpy(), np.asarray(jl.sketch))
    np.testing.assert_array_equal(leaf.index_words.numpy(),
                                  np.asarray(jl.index_words).view(np.int32))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
    lane_blocks = nb_c * E // comp.cfg.block_elems
    assert leaf.sketch.shape[:2] == (lanes, lane_blocks)
    for d in range(lanes):
        lone, lone_mx = comp.compress_wire(
            torch.from_numpy(slab[d].reshape(-1)),
            block_offset=offset + d * lane_blocks)
        assert torch.equal(leaf.sketch[d], lone.sketch)
        assert torch.equal(leaf.index_words[d], lone.index_words)
        assert torch.equal(mx[d], lone_mx)
    with pytest.raises(ValueError, match="whole number of sketch blocks"):
        comp.exchange_wire(torch.zeros(2, 1, 100))


# ----------------------------------------------------------------------
# the lane merge
# ----------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_lane_sum_on_local_workers_matches_numpy(w):
    group = LocalWorkers(w)
    floats = np.stack([dyadic_payload(10 + s, w) for s in range(w)])
    words = _words((w, w, 77), 11)
    got_f = alltoall_lane_sum([torch.from_numpy(x) for x in floats], group, "add")
    got_w = alltoall_lane_sum([torch.from_numpy(x) for x in words], group, "or")
    for r in range(w):
        np.testing.assert_array_equal(got_f[r].numpy(), floats[:, r].sum(0))
        np.testing.assert_array_equal(got_w[r].numpy(),
                                      np.bitwise_or.reduce(words[:, r], axis=0))
    sk = torch.from_numpy(floats.reshape(w, w, -1, 8))
    msk, mwd = sketch_all_to_all(list(sk), [torch.from_numpy(x) for x in words],
                                 group)
    for r in range(w):
        assert torch.equal(msk[r], got_f[r].reshape(-1, 8))
        assert torch.equal(mwd[r], got_w[r])


def test_lane_sum_errors():
    group = LocalWorkers(2)
    x = [torch.zeros(2, 3), torch.zeros(2, 3)]
    with pytest.raises(ValueError, match="combine must be 'add' or 'or'"):
        alltoall_lane_sum(x, group, "max")
    with pytest.raises(ValueError, match="has 3 lanes but the group has 2"):
        alltoall_lane_sum([torch.zeros(3, 3)] * 2, group)
    with pytest.raises(ValueError, match="1 payloads for 2 local workers"):
        alltoall_lane_sum(x[:1], group)


# ----------------------------------------------------------------------
# the exchanges
# ----------------------------------------------------------------------

def test_exchanges_registry_matches_pattern_wires():
    assert set(EXCHANGES) == set(pattern_wires("alltoall")) == {"dense",
                                                                 "compressed"}


@pytest.mark.parametrize("chunks", [None, 2], ids=["fused", "chunked"])
@pytest.mark.parametrize("name", ["dense", "compressed"])
def test_w1_exchange_matches_reference(name, chunks):
    jcfg = dataclasses.replace(A2A_BASE, use_pallas="never",
                               stream_chunks=chunks)
    want = _run_exchange(jcfg, name)
    ex = make_exchange(name, _port(jcfg), LocalWorkers(1))
    for step in range(3):
        payload = _a2a_payload(seed=step)
        got = ex([[torch.from_numpy(payload[k]) for k in sorted(payload)]])[0]
        for k, g in zip(sorted(payload), got):
            np.testing.assert_array_equal(g.numpy(), want[step][k])
            np.testing.assert_array_equal(g.numpy(), payload[k][0])


@pytest.mark.parametrize("chunks", [None, 2], ids=["fused", "chunked"])
@pytest.mark.parametrize("w", [2, 4])
def test_exchanges_match_numpy(w, chunks):
    cfg = CompressionConfig(**{**DRIVER, "stream_chunks": chunks})
    group = LocalWorkers(w)
    for step in range(3):
        pay = np.stack([dyadic_payload(1000 + 10 * step + s, w)
                        for s in range(w)])
        outs = {}
        for name in ("dense", "compressed"):
            got = make_exchange(name, cfg, group)(
                [[torch.from_numpy(pay[s])] for s in range(w)])
            outs[name] = np.stack([g[0].numpy() for g in got])
        want = pay.sum(axis=0)
        np.testing.assert_array_equal(outs["dense"], want)
        np.testing.assert_array_equal(outs["compressed"], want)


def test_exchange_rejects_bloom_and_unknown_names():
    cfg = CompressionConfig(**{**DRIVER, "index": "bloom"})
    ex = make_exchange("compressed", cfg, LocalWorkers(1))
    jex = j_make_exchange("compressed", JaxCompression(**{**DRIVER,
                                                          "index": "bloom"}),
                          make_mesh((1,), ("data",)), ("data",))
    with pytest.raises(ValueError) as want:
        jex.exchange({"g": jnp.zeros((1, N_DEST))})
    with pytest.raises(ValueError) as got:
        ex([[torch.zeros(1, N_DEST)]])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"unknown exchange 'bogus'; have "
                       r"\['compressed', 'dense'\]"):
        make_exchange("bogus", cfg, LocalWorkers(1))
    ex = make_exchange("dense", CompressionConfig(**DRIVER), LocalWorkers(2))
    assert (ex.workers, ex.wire) == (2, "dense")


def _jax_w1_grad(name, payload, ct):
    """jax.grad of sum(exchange(p) * ct) through the reference's W = 1
    exchange, in its shard_map region."""
    mesh = make_mesh((1,), ("data",))
    ex = j_make_exchange(name, JaxCompression(**DRIVER), mesh, ("data",),
                         outer_manual=("data",))

    def loss(p):
        return jnp.sum(ex({"g": p})["g"] * ct)

    fn = jax.jit(shard_map(jax.grad(loss), mesh=mesh, in_specs=(P(),),
                           out_specs=P(), axis_names={"data"},
                           check_vma=False))
    return np.asarray(fn(jnp.asarray(payload)))


@pytest.mark.parametrize("name", ["dense", "compressed"])
@pytest.mark.parametrize("w", [1, 2])
def test_exchange_backward_gathers_the_cotangent(name, w):
    cfg = CompressionConfig(**DRIVER)
    pay = np.stack([dyadic_payload(70 + s, w) for s in range(w)])
    ct = np.random.default_rng(71).normal(size=(w, N_DEST)).astype(np.float32)
    ps = [torch.from_numpy(pay[s]).requires_grad_() for s in range(w)]
    out = make_exchange(name, cfg, LocalWorkers(w))([[p] for p in ps])
    loss = sum((o[0] * torch.from_numpy(ct[r])).sum() for r, o in enumerate(out))
    grads = torch.autograd.grad(loss, ps)
    for g in grads:                    # d payload_s[d] = d out_d, every s
        np.testing.assert_array_equal(g.numpy(), ct)
    if w == 1:
        np.testing.assert_array_equal(grads[0].numpy(),
                                      _jax_w1_grad(name, pay[0], ct[0]))

