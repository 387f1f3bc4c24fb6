"""PyTorch port vs the JAX reference: the in-network aggregation tier.

``repro_torch.net`` (fixed-point wire, topology, switch), the switch's
retransmit policy and the ``compressed_innet`` aggregator, held against
in-process calls to ``repro.net``, ``repro.ft.failures`` and the JAX
codec on the same numpy inputs:

- the fixed-point wire, topologies, the switch model and its policy are
  integer or exact-scaling arithmetic: equal exactly on every input;
- the W=2 (flat) and W=4 (``tor_spine``, levels (2, 2)) aggregates are
  held against the reference's fxp32 path composed from its own
  functions (per worker ``compress_wire``; ``exponents_from_maxabs`` of
  the per-bucket max of the block maxima, the max over workers,
  ``encode``; integer sum and OR; ``recover(dequant=...)``): dyadic
  gradients bit for bit, Gaussian ones within ``atol=1e-6``, the
  tolerance ``test_torch_aggregate.py`` uses (the two frameworks sum a
  sketch cell's contributions in their own orders, which can move an
  int32 cell by one step of 2^(e-M), and the peel's subtractions round);
- at W=1 the aggregator equals the reference's single-rank run of
  ``tests/test_net.py`` bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import CompressionConfig as JaxConfig
from repro.core.aggregators import sparsify_leaf as j_sparsify_leaf
from repro.core.bucketing import make_bucket_plan as j_make_bucket_plan
from repro.core.compressor import (CompressedLeaf as JLeaf,
                                   HomomorphicCompressor as JComp)
from repro.ft.failures import (SwitchRetransmitPolicy as JPolicy,
                               SwitchStragglerTimeout as JTimeout)
from repro.net import FixedPointWire as JWire
from repro.net import SwitchModel as JSwitch
from repro.net import Topology as JTopology
from repro.net import ceil_log2 as j_ceil_log2
from repro_torch.core.aggregators import make_aggregator
from repro_torch.core.collectives import AggregationState, LocalWorkers
from repro_torch.core.config import CompressionConfig
from repro_torch.ft.failures import (SwitchRetransmitPolicy,
                                     SwitchStragglerTimeout)
from repro_torch.net.fixedpoint import FixedPointWire, ceil_log2, pow2
from repro_torch.net.switch import SwitchModel
from repro_torch.net.topology import (Topology, make_topology,
                                      tree_all_reduce)
from test_net import _CFG as J_NET_CFG, _run_innet, _sparse_tree
from test_torch_aggregate import SHAPES, dyadic, tcfg

JCFG = JaxConfig(ratio=0.4, lanes=128, rows=6, topk_ratio=0.05,
                 bucket_bytes=4 * 1920 * 2, switch_slots=2,
                 wire_dtype="fxp32")          # 2 blocks a bucket, 2-bucket windows


# ----------------------------------------------------------------------
# fixed-point wire
# ----------------------------------------------------------------------

def test_ceil_log2_and_pow2_match_reference():
    assert [ceil_log2(n) for n in range(1, 70)] == \
        [j_ceil_log2(n) for n in range(1, 70)]
    with pytest.raises(ValueError):
        ceil_log2(0)
    ks = np.arange(-126, 128, dtype=np.int32)
    np.testing.assert_array_equal(pow2(torch.from_numpy(ks)).numpy(),
                                  np.exp2(ks.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("workers", range(1, 10))
def test_wire_budget_matches_reference(workers):
    got, want = FixedPointWire(workers), JWire(workers)
    assert (got.mantissa_bits, got.headroom_bits, got.min_exponent) == \
        (want.mantissa_bits, want.headroom_bits, want.min_exponent)
    assert got.with_workers(workers + 3).mantissa_bits == \
        want.with_workers(workers + 3).mantissa_bits


def test_wire_validation():
    with pytest.raises(ValueError, match="workers"):
        FixedPointWire(workers=0)
    with pytest.raises(ValueError, match="mantissa"):
        FixedPointWire(workers=1 << 29)
    with pytest.raises(ValueError, match="overflow"):
        FixedPointWire(2).roundtrip_reference([torch.ones(1, 8)] * 3)


@pytest.mark.parametrize("workers", [1, 2, 5])
def test_exponents_from_maxabs_match_reference(workers):
    """Zero, subnormal, tiny, ordinary and huge maxima: the clamp at
    M - 126 hides that the two frameworks' frexp report subnormals
    differently."""
    m = np.array([0.0, 1e-45, 1e-40, 1.1e-38, 1e-35, 2.0**-11, 0.75, 1.0,
                  3.0, 1e20, 3.4e38], np.float32)
    got = FixedPointWire(workers).exponents_from_maxabs(torch.from_numpy(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JWire(workers).exponents_from_maxabs(jnp.asarray(m))))


def _buckets(kind, seed):
    r = np.random.default_rng(seed)
    if kind == "dyadic":
        return [dyadic((5, 96), r, 0.6) for _ in range(3)]
    scale = {"gauss": 1.0, "huge": 1e30, "tiny": 1e-30}[kind]
    out = [(r.normal(size=(5, 96)) * scale).astype(np.float32) for _ in range(3)]
    out[1][2] = 0.0                     # one worker's slice of a bucket all zero
    return out


@pytest.mark.parametrize("kind", ["dyadic", "gauss", "huge", "tiny"])
def test_encode_decode_roundtrip_match_reference(kind):
    bs = _buckets(kind, 3)
    got_w, want_w = FixedPointWire(3), JWire(3)
    e = got_w.shared_exponents([torch.from_numpy(b) for b in bs], LocalWorkers(3))
    je = jnp.maximum(jnp.maximum(want_w.bucket_exponents(jnp.asarray(bs[0])),
                                 want_w.bucket_exponents(jnp.asarray(bs[1]))),
                     want_w.bucket_exponents(jnp.asarray(bs[2])))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    for b in bs:
        q = got_w.encode(torch.from_numpy(b), e)
        jq = want_w.encode(jnp.asarray(b), je)
        assert q.dtype == torch.int32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert int(q.abs().max()) <= 2 ** got_w.mantissa_bits
        np.testing.assert_array_equal(got_w.decode(q, e).numpy(),
                                      np.asarray(want_w.decode(jq, je)))
    got = got_w.roundtrip_reference([torch.from_numpy(b) for b in bs])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want_w.roundtrip_reference([jnp.asarray(b) for b in bs])))
    if kind == "dyadic":
        np.testing.assert_array_equal(got.numpy(), bs[0] + bs[1] + bs[2])


def test_rint_is_half_to_even():
    w = FixedPointWire(1)
    e = torch.tensor([w.mantissa_bits], dtype=torch.int32)   # scale 1
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5]])
    np.testing.assert_array_equal(w.encode(x, e).numpy(), [[0, 2, 2, 0, -2, -2]])


# ----------------------------------------------------------------------
# topology and the tree
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind,sizes", [("flat", (1,)), ("flat", (5,)),
                                        ("flat", (4, 3)), ("tor_spine", (4, 3)),
                                        ("tor_spine", (2, 2, 2))])
def test_topology_matches_reference(kind, sizes):
    got = Topology(kind=kind, sizes=sizes)
    want = JTopology(kind=kind, levels=tuple(f"a{i}" for i in range(len(sizes))),
                     sizes=sizes)
    assert (got.workers, got.fanouts, got.depth, got.switches_per_level()) == \
        (want.workers, want.fanouts, want.depth, want.switches_per_level())
    assert got.link_profile(1000) == want.link_profile(1000)
    for n_chunks, slots in [(7, 2), (4, 4), (5, 8), (1, 1), (0, 3)]:
        assert got.window_profile(36, n_chunks, slots) == \
            want.window_profile(36, n_chunks, slots)
    with pytest.raises(ValueError, match="slots"):
        got.window_profile(36, 3, 0)


def test_make_topology_reads_the_group_levels():
    assert make_topology("flat", LocalWorkers(6, (3, 2))).fanouts == (6,)
    assert make_topology("tor_spine", LocalWorkers(6, (3, 2))).fanouts == (3, 2)
    assert make_topology("flat", LocalWorkers(4)).sizes == (4,)
    with pytest.raises(ValueError, match="tor_spine"):
        make_topology("tor_spine", LocalWorkers(4))
    with pytest.raises(ValueError, match="unknown topology"):
        make_topology("clos", LocalWorkers(4))
    with pytest.raises(ValueError, match="multiply"):
        LocalWorkers(4, (3, 2))


def _payloads(workers, n_chunks=7, seed=0):
    r = np.random.default_rng(seed)
    ints = [torch.from_numpy(r.integers(-2**26, 2**26, size=(n_chunks, 12),
                                        dtype=np.int32)) for _ in range(workers)]
    words = [torch.from_numpy(r.integers(0, 2**32, size=(n_chunks, 4), dtype=np.uint32)
                              .view(np.int32)) for _ in range(workers)]
    return ints, words


@pytest.mark.parametrize("workers,levels,kind", [
    (1, (), "flat"), (2, (), "flat"), (3, (), "flat"), (4, (2, 2), "tor_spine"),
    (5, (), "flat"), (6, (3, 2), "tor_spine")])
@pytest.mark.parametrize("window_slots", [None, 3])
def test_tree_all_reduce_equals_flat_sum_and_or(workers, levels, kind, window_slots):
    topo = make_topology(kind, LocalWorkers(workers, levels))
    ints, words = _payloads(workers, seed=workers)
    add = tree_all_reduce(ints, topo, "add", window_slots=window_slots)
    orr = tree_all_reduce(words, topo, "or", window_slots=window_slots)
    assert len(add) == len(orr) == workers
    want_add = np.sum([t.numpy() for t in ints], axis=0, dtype=np.int32)
    want_or = np.bitwise_or.reduce([t.numpy() for t in words], axis=0)
    for a, o in zip(add, orr):
        np.testing.assert_array_equal(a.numpy(), want_add)
        np.testing.assert_array_equal(o.numpy(), want_or)


def test_tree_all_reduce_rejects_floats_and_bad_input():
    topo = make_topology("flat", LocalWorkers(2))
    f = [torch.zeros(4), torch.zeros(4)]
    with pytest.raises(TypeError, match="integer adds only"):
        tree_all_reduce(f, topo, "add")
    with pytest.raises(TypeError, match="integer words"):
        tree_all_reduce(f, topo, "or")
    ints = [torch.zeros(4, dtype=torch.int32)] * 2
    with pytest.raises(ValueError, match="combine"):
        tree_all_reduce(ints, topo, "xor")
    with pytest.raises(ValueError, match="payloads"):
        tree_all_reduce(ints[:1], topo, "add")
    with pytest.raises(ValueError, match="window_slots"):
        tree_all_reduce(ints, topo, "add", window_slots=0)


# ----------------------------------------------------------------------
# switch model and its retransmit policy
# ----------------------------------------------------------------------

def _chunks(ports=3, n_chunks=7, k=16, seed=0):
    r = np.random.default_rng(seed)
    sk = r.integers(-2**20, 2**20, size=(ports, n_chunks, k), dtype=np.int32)
    bm = r.integers(0, 2**32, size=(ports, n_chunks, k // 2), dtype=np.uint32)
    return sk, bm


@pytest.mark.parametrize("ports,slots,late", [(3, 2, None), (2, 4, 0.25),
                                              (4, 3, 0.12)])
def test_switch_matches_reference(ports, slots, late):
    sk, bm = _chunks(ports=ports)
    arrivals = None
    if late is not None:
        arrivals = np.zeros((ports, sk.shape[1]))
        arrivals[-1] = late
    got_sw = SwitchModel(ports=ports, slots=slots,
                         policy=SwitchRetransmitPolicy(timeout_s=0.1, max_retries=3))
    want_sw = JSwitch(ports=ports, slots=slots,
                      policy=JPolicy(timeout_s=0.1, max_retries=3))
    got = got_sw.aggregate(sk, bm, arrival_s=arrivals, metadata_bytes=20)
    want = want_sw.aggregate(sk, bm, arrival_s=arrivals, metadata_bytes=20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], sk.sum(0, dtype=np.int32))
    assert got_sw.report() == want_sw.report()
    got_sw.account_batched_fold(5, 2, 100, 30)
    want_sw.account_batched_fold(5, 2, 100, 30)
    assert got_sw.report() == want_sw.report()
    got_sw.reset()
    want_sw.reset()
    assert got_sw.report() == want_sw.report()


def test_switch_errors_match_reference():
    sk, bm = _chunks(ports=2)
    for cls in (SwitchModel, JSwitch):
        sw = cls(ports=2, slots=2)
        with pytest.raises(TypeError, match="int32"):
            sw.aggregate(sk.astype(np.float32), bm)
        with pytest.raises(TypeError, match="uint32"):
            sw.aggregate(sk, bm.view(np.int32))
        with pytest.raises(ValueError, match="ports"):
            sw.aggregate(sk[:1], bm[:1])
        with pytest.raises(ValueError, match="metadata_bytes"):
            sw.aggregate(sk, bm, metadata_bytes=-1)
        over = np.array([2**30, 2**30, -(2**30)], np.int32).reshape(3, 1, 1)
        with pytest.raises(OverflowError, match="running"):
            cls(ports=3, slots=1).aggregate(over, np.zeros((3, 1, 1), np.uint32))
        with pytest.raises(OverflowError, match="32-bit"):
            sw.check_batched_partial(2**31, 0, ports=3, window=4)
        sw.check_batched_partial(2**31 - 1, -(2**31))
        with pytest.raises(ValueError, match="n_chunks"):
            sw.account_batched_fold(0, 1, 10, 10)
        with pytest.raises(ValueError, match="slots"):
            cls(ports=2, slots=0)


def test_retransmit_policy_matches_reference():
    for timeout, retries in [(0.1, 5), (0.05, 2), (0.3, 0)]:
        got, want = SwitchRetransmitPolicy(timeout, retries), JPolicy(timeout, retries)
        for d in (0.0, 0.05, 0.1, 0.11, 0.35, 0.6):
            assert got.retries_for(d) == want.retries_for(d)
    for cls in (SwitchRetransmitPolicy, JPolicy):
        with pytest.raises(ValueError, match="timeout_s"):
            cls(timeout_s=0.0)
        with pytest.raises(ValueError, match="max_retries"):
            cls(max_retries=-1)
    sk, bm = _chunks(ports=2, n_chunks=2)
    late = np.array([[0.0, 0.0], [0.45, 0.45]])        # 4 periods late
    with pytest.raises(SwitchStragglerTimeout, match="port 1") as got:
        SwitchModel(2, 4, policy=SwitchRetransmitPolicy(0.1, 1)).aggregate(
            sk, bm, arrival_s=late)
    with pytest.raises(JTimeout) as want:
        JSwitch(2, 4, policy=JPolicy(0.1, 1)).aggregate(sk, bm, arrival_s=late)
    assert str(got.value) == str(want.value)
    assert (got.value.port, got.value.window) == (want.value.port, want.value.window)


# ----------------------------------------------------------------------
# the compressed_innet aggregator
# ----------------------------------------------------------------------

def test_innet_fxp32_single_worker_matches_reference_run():
    """W=1 still quantizes: the port's aggregate equals the reference's
    single-rank ``compressed_innet`` run (``tests/test_net.py``) bit for
    bit."""
    jc = dataclasses.replace(J_NET_CFG, wire_dtype="fxp32")
    grads = _sparse_tree()
    want = _run_innet(jc, grads)
    out, st = make_aggregator("compressed_innet", tcfg(jc), LocalWorkers(1))(
        [[torch.from_numpy(grads[k]) for k in sorted(grads)]],
        AggregationState(residual=[torch.zeros(0) for _ in grads]))
    for k, o in zip(sorted(grads), out):
        np.testing.assert_array_equal(o.numpy(), want[k])
    assert not np.array_equal(out[0].numpy(), grads["a"])   # it did quantize


def jax_innet_aggregate(grads_w, res_w, jc):
    """The reference's unstreamed fxp32 ``compressed_innet`` path on a
    pure data-parallel mesh, composed from its own functions."""
    W = len(grads_w)
    plan = j_make_bucket_plan([jnp.asarray(g) for g in grads_w[0]], jc)
    comp = JComp(jc)
    wire = JWire(workers=W)
    nbpb = plan.blocks_per_bucket(jc)
    cs, exps, new_res = [], [], []
    for grads, res in zip(grads_w, res_w):
        flats, nrs = [], []
        for g, r in zip(grads, res):
            flat, nr = j_sparsify_leaf(jnp.asarray(g).reshape(-1), jnp.asarray(r), jc)
            flats.append(flat)
            nrs.append(np.asarray(nr).reshape(np.shape(g)))
        c, mx = comp.compress_wire(plan.pack_flat(flats).reshape(-1))
        cs.append(c)
        exps.append(wire.exponents_from_maxabs(mx.reshape(plan.n_buckets, nbpb).max(1)))
        new_res.append(nrs)
    exp = exps[0]
    for e in exps[1:]:
        exp = jnp.maximum(exp, e)
    q = sum(np.asarray(wire.encode(c.sketch.reshape(plan.n_buckets, -1), exp))
            for c in cs)
    words = np.bitwise_or.reduce(np.stack([np.asarray(c.index_words) for c in cs]))
    rec, stats = comp.recover(
        JLeaf(sketch=jnp.asarray(q.astype(np.int32)).reshape(cs[0].sketch.shape),
              index_words=jnp.asarray(words)),
        plan.padded, with_stats=True,
        dequant=(jnp.repeat(exp, nbpb), wire.mantissa_bits))
    out = plan.unpack(rec.reshape(plan.n_buckets, plan.bucket_elems) / W)
    return [np.asarray(o) for o in out], new_res, stats


@pytest.mark.parametrize("workers,levels,kind", [(2, (), "flat"),
                                                 (4, (2, 2), "tor_spine")])
@pytest.mark.parametrize("values", ["dyadic", "gauss"])
def test_innet_fxp32_matches_composed_reference_over_3_steps(workers, levels,
                                                             kind, values):
    rng = np.random.default_rng(workers)
    jc = dataclasses.replace(JCFG, topology=kind)
    agg = make_aggregator("compressed_innet", tcfg(jc), LocalWorkers(workers, levels))
    res_t = [torch.zeros((workers,) + s) for s in SHAPES]
    res_j = [[np.zeros(s, np.float32) for s in SHAPES] for _ in range(workers)]
    for _ in range(3):
        if values == "dyadic":
            grads = [[dyadic(s, rng, 0.3) for s in SHAPES] for _ in range(workers)]
        else:
            grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
                     for _ in range(workers)]
        want, res_j, jstats = jax_innet_aggregate(grads, res_j, jc)
        got, st = agg([[torch.from_numpy(g) for g in gw] for gw in grads],
                      AggregationState(residual=res_t))
        for a, b in zip(got, want):
            if values == "dyadic":
                np.testing.assert_array_equal(a.numpy(), b)
            else:
                np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
        for li in range(len(SHAPES)):
            for w in range(workers):
                np.testing.assert_array_equal(st.residual[li][w].numpy(), res_j[w][li])
        assert (int(st.stats.nnz), int(st.stats.residual)) == \
            (int(jstats.nnz), int(jstats.residual))


def test_innet_f32_wire_is_compressed_bit_for_bit():
    rng = np.random.default_rng(11)
    cfg = dataclasses.replace(tcfg(JCFG), wire_dtype="f32", topology="tor_spine")
    group = LocalWorkers(4, (2, 2))
    grads = [[torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in SHAPES]
             for _ in range(4)]
    outs = []
    for name in ("compressed_innet", "compressed"):
        res = [torch.zeros((4,) + s) for s in SHAPES]
        out, st = make_aggregator(name, cfg, group)(grads, AggregationState(residual=res))
        outs.append((out, res, int(st.stats.residual)))
    (a, ra, na), (b, rb, nb) = outs
    assert na == nb
    for x, y in zip(a + ra, b + rb):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="tor_spine"):
        make_aggregator("compressed_innet", cfg, LocalWorkers(4))(
            grads, AggregationState(residual=[torch.zeros((4,) + s) for s in SHAPES]))


def test_innet_lossless_smoke_train_tracks_dense():
    """The lossless profile (ratio 2, rows 60) at the smoke config: three
    steps of the fxp32 in-network step against the dense step, losses
    within 1e-4 (the bound of ``tests/drivers/train_step_driver.py``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api
    from repro_torch.train.config import TrainConfig
    from repro_torch.train.loop import run_training
    from repro_torch.train.optimizer import OptimizerConfig

    arch = get_arch("granite-3-2b")

    def run(aggregator):
        tc = TrainConfig(
            aggregator=aggregator, workers=4, dp_levels=(2, 2),
            compression=CompressionConfig(ratio=2.0, rows=60, wire_dtype="fxp32",
                                          topology="tor_spine"),
            optimizer=OptimizerConfig(kind="momentum", lr=1e-2, warmup_steps=0,
                                      total_steps=100, grad_clip=0.0))
        return run_training(model_api(arch.smoke), tc, global_batch=4, seq_len=16,
                            steps=3, device="cpu", log_every=0)

    dense, innet = run("dense"), run("compressed_innet")
    assert all(abs(a - b) < 1e-4 for a, b in zip(dense.losses, innet.losses)), \
        (dense.losses, innet.losses)
    assert all(m["recovery_residual"] == 0 for m in innet.metrics)
    assert innet.losses[-1] < innet.losses[0]


def test_train_config_and_launcher_take_innet():
    from repro_torch.launch.train import main
    from repro_torch.train.config import TrainConfig
    assert TrainConfig(aggregator="compressed_innet").aggregator == "compressed_innet"
    with pytest.raises(ValueError, match="dp_levels"):
        TrainConfig(workers=4, dp_levels=(3, 2))
    out = main(["--arch", "granite-3-2b", "--smoke", "--workers", "2",
                "--steps", "2", "--global-batch", "4", "--seq-len", "16",
                "--aggregator", "compressed_innet", "--wire", "fxp32",
                "--device", "cpu"])
    assert (out["aggregator"], out["wire"]) == ("compressed_innet", "fxp32")
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
