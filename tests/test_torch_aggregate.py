"""PyTorch port vs the JAX reference: sparsification, error feedback,
buckets and the compressed aggregation at W=2.

The W=2 JAX reference is composed in-process from the reference
aggregator's own functions (per worker ``sparsify_leaf`` ->
``make_bucket_plan(...).pack_flat`` -> ``HomomorphicCompressor.compress``,
then a numpy sum and OR, then ``recover`` -> ``unpack(/W)``): the path
``CompressedAggregator.__call__`` takes on a pure data-parallel mesh.
Dyadic gradients make every float sum exact, so the port must match it
bit for bit, outputs and error-feedback residuals alike.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import CompressionConfig as JaxConfig
from repro.core import topk as jtopk
from repro.core.aggregators import sparsify_leaf as j_sparsify_leaf
from repro.core.bucketing import make_bucket_plan as j_make_bucket_plan
from repro.core.compressor import (CompressedLeaf as JLeaf,
                                   HomomorphicCompressor as JComp)
from repro_torch.core import topk as ttopk
from repro_torch.core.aggregators import make_aggregator
from repro_torch.core.bucketing import make_bucket_plan
from repro_torch.core.collectives import AggregationState, LocalWorkers
from repro_torch.core.config import CompressionConfig

SHAPES = [(40, 30), (7,), (3, 50, 20), (600,), (2, 128)]
JCFG = JaxConfig(ratio=0.4, lanes=128, rows=6, topk_ratio=0.05,
                 bucket_bytes=4 * 1920 * 2)          # 2 blocks per bucket


def tcfg(jc):
    return CompressionConfig(**dataclasses.asdict(jc))


def dyadic(shape, rng, density=1.0):
    x = rng.choice([-1.0, 1.0], size=shape) * np.exp2(rng.integers(-2, 3, size=shape))
    return np.where(rng.random(shape) < density, x, 0.0).astype(np.float32)


# ----------------------------------------------------------------------
# sparsification + error feedback
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [17, 1000, 4096, 50_003, 200_000])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.96, 0.999, 1.0])
def test_quantile_matches_jnp_quantile(n, q):
    sample = np.abs(np.random.default_rng(n).normal(size=n)).astype(np.float32)
    want = np.asarray(jnp.quantile(jnp.asarray(sample), q))
    got = ttopk.quantile_linear(torch.from_numpy(sample), q).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k", [(10_000, 400), (300_001, 12_000), (5, 7),
                                 (50_000, 1)])
def test_sparsify_threshold_matches_reference(n, k):
    x = np.random.default_rng(k).normal(size=n).astype(np.float32)
    want = np.asarray(jtopk.sparsify_threshold(jnp.asarray(x), k))
    got = ttopk.sparsify_threshold(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exact", [False, True])
def test_error_feedback_matches_reference_over_3_steps(exact):
    """Gaussian gradients: the sent part and the EF residual are
    elementwise selections and one subtraction, so they match exactly."""
    rng = np.random.default_rng(5)
    n, k = 20_000, 800
    r_j = jnp.zeros(n, jnp.float32)
    r_t = torch.zeros(n)
    for _ in range(3):
        g = rng.normal(size=n).astype(np.float32)
        s_j, r_j = jtopk.apply_error_feedback(jnp.asarray(g), r_j, k, exact=exact)
        s_t, r_t = ttopk.apply_error_feedback(torch.from_numpy(g), r_t, k,
                                              exact=exact)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))


# ----------------------------------------------------------------------
# buckets
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bucket_bytes", [4 << 20, 4 * 1920, 4 * 1920 * 3])
def test_bucket_plan_matches_reference_and_roundtrips(bucket_bytes):
    jc = dataclasses.replace(JCFG, bucket_bytes=bucket_bytes)
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    jplan = j_make_bucket_plan([jnp.asarray(x) for x in leaves], jc)
    tleaves = [torch.from_numpy(x) for x in leaves]
    plan = make_bucket_plan(tleaves, tcfg(jc))
    assert (plan.n_buckets, plan.bucket_elems, plan.offsets, plan.sizes) == \
        (jplan.n_buckets, jplan.bucket_elems, jplan.offsets, jplan.sizes)
    packed = plan.pack_flat([t.reshape(-1) for t in tleaves])
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jplan.pack([jnp.asarray(x) for x in leaves])))
    for a, b in zip(plan.unpack(packed), tleaves):
        assert a.shape == b.shape and torch.equal(a, b)
    with pytest.raises(ValueError):
        plan.pack_flat([t.reshape(-1) for t in tleaves[:-1]])


# ----------------------------------------------------------------------
# compressed aggregation at W=2 against the composed reference
# ----------------------------------------------------------------------

def jax_compressed_aggregate(grads_w, res_w, jc, with_stats=False):
    """The reference aggregator's unstreamed pure-DP path, composed
    (and its ``RecoveryStats`` with ``with_stats``)."""
    W = len(grads_w)
    plan = j_make_bucket_plan([jnp.asarray(g) for g in grads_w[0]], jc)
    comp = JComp(jc)
    sks, words, new_res = [], [], []
    for grads, res in zip(grads_w, res_w):
        flats, nrs = [], []
        for g, r in zip(grads, res):
            flat, nr = j_sparsify_leaf(jnp.asarray(g).reshape(-1).astype(jnp.float32),
                                       jnp.asarray(r), jc)
            flats.append(flat)
            nr = np.asarray(nr)     # a (0,) stub when error feedback is off
            nrs.append(nr.reshape(np.shape(g)) if nr.size else nr)
        c = comp.compress(plan.pack_flat(flats).reshape(-1))
        sks.append(np.asarray(c.sketch))
        words.append(np.asarray(c.index_words))
        new_res.append(nrs)
    sk = sks[0]
    for s in sks[1:]:
        sk = sk + s
    wd = np.bitwise_or.reduce(np.stack(words), axis=0)
    rec = comp.recover(JLeaf(sketch=jnp.asarray(sk), index_words=jnp.asarray(wd)),
                       plan.padded, with_stats=with_stats)
    if with_stats:
        rec, stats = rec
    out = plan.unpack(rec.reshape(plan.n_buckets, plan.bucket_elems) / W)
    out = [np.asarray(o) for o in out]
    return (out, new_res, stats) if with_stats else (out, new_res)


@pytest.mark.parametrize("density", [1.0, 0.1])
def test_compressed_aggregate_matches_reference_over_3_steps(density):
    rng = np.random.default_rng(int(density * 10))
    W = 2
    group = LocalWorkers(W)
    agg = make_aggregator("compressed", tcfg(JCFG), group)
    res_t = [torch.zeros((W,) + s) for s in SHAPES]
    res_j = [[np.zeros(s, np.float32) for s in SHAPES] for _ in range(W)]
    for _ in range(3):
        grads = [[dyadic(s, rng, density) for s in SHAPES] for _ in range(W)]
        want, res_j = jax_compressed_aggregate(grads, res_j, JCFG)
        got, st = agg([[torch.from_numpy(g) for g in gw] for gw in grads],
                      AggregationState(residual=res_t))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
        for li in range(len(SHAPES)):
            for w in range(W):
                np.testing.assert_array_equal(st.residual[li][w].numpy(),
                                              res_j[w][li])
        assert int(st.stats.nnz) == int(st.stats.peeled) + int(st.stats.residual)


LOSSLESS = CompressionConfig(ratio=2.0, lanes=512, rows=60, chunk_blocks=64)


@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
def test_lossless_profile_compressed_equals_dense(kind):
    """ratio=2.0, rows=60 (the lossless profile of
    ``tests/drivers/train_step_driver.py``): the sketch holds more cells
    than a block has elements, so fully dense gradients peel completely.
    Dyadic values make the aggregate equal the dense mean bit for bit;
    Gaussian values are recovered up to the float rounding of the peel's
    subtractions (abs 1e-6 at unit scale)."""
    rng = np.random.default_rng(3)
    W = 2
    group = LocalWorkers(W)
    if kind == "dyadic":
        grads = [[torch.from_numpy(dyadic(s, rng)) for s in SHAPES] for _ in range(W)]
    else:
        grads = [[torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in SHAPES] for _ in range(W)]
    stubs = [torch.zeros(0) for _ in SHAPES]
    comp, st = make_aggregator("compressed", LOSSLESS, group)(
        grads, AggregationState(residual=stubs))
    dense, _ = make_aggregator("dense", LOSSLESS, group)(
        grads, AggregationState(residual=stubs))
    assert int(st.stats.residual) == 0
    for a, b in zip(comp, dense):
        if kind == "dyadic":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("reduce_scatter", [False, True])
def test_compressed_all_reduce_is_its_aggregator(reduce_scatter):
    """The thin wrappers (the reference's ``init_aggregation_state`` and
    ``compressed_all_reduce``) equal the aggregator they wrap on
    ``LocalWorkers``, outputs, residuals and stats bit for bit, over 3
    steps of Gaussian gradients; without error feedback the residuals
    are ``(0,)`` stubs."""
    from repro_torch.core.collectives import (compressed_all_reduce,
                                              init_aggregation_state)
    rng = np.random.default_rng(7)
    W, cfg = 2, tcfg(JCFG)
    group = LocalWorkers(W)
    params = [torch.zeros(s) for s in SHAPES]
    st = init_aggregation_state(params, cfg, group)
    assert [tuple(r.shape) for r in st.residual] == [(W,) + s for s in SHAPES]
    assert all(r.dtype == torch.float32 and not r.any() for r in st.residual)
    stubs = init_aggregation_state(
        params, dataclasses.replace(cfg, error_feedback=False), group)
    assert all(tuple(r.shape) == (0,) for r in stubs.residual)
    ref_st = AggregationState(residual=[r.clone() for r in st.residual])
    agg = make_aggregator("compressed_rs" if reduce_scatter else "compressed",
                          cfg, group)
    for _ in range(3):
        grads = [[torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in SHAPES] for _ in range(W)]
        got, st = compressed_all_reduce(grads, st, group, cfg,
                                        reduce_scatter=reduce_scatter)
        want, ref_st = agg(grads, ref_st)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(st.residual, ref_st.residual))
        assert (int(st.stats.nnz), int(st.stats.peeled)) == \
            (int(ref_st.stats.nnz), int(ref_st.stats.peeled))
