"""PyTorch port vs the JAX reference: the Bloom-filter index, the
standalone encode and peel, and the composed (non-fused) codec path.

On the same numpy inputs:

- ``bloom_positions``, ``bloom_size_words``, ``bloom_build`` and
  ``bloom_query`` are integer functions: equal exactly, and chunked equal
  to unchunked;
- ``ops.sketch_encode`` / ``ops.sketch_peel`` on CPU tensors (their plain
  versions) against the reference's Pallas kernels run in interpret mode,
  including unaligned geometries (``block_elems % 32 != 0``): dyadic
  inputs bit for bit, Gaussian ones within the reference's ``atol=1e-6``
  (the two frameworks sum a cell's contributions in their own orders);
- the compressor, the W=2 ``compressed`` aggregate and the
  ``compressed_innet`` aggregate on the Bloom and unaligned-bitmap
  geometries against the reference composed in-process: words exact,
  ``RecoveryStats`` equal, values bit for bit on dyadic inputs;
- a smoke-size W=2 lossless train with the Bloom index tracks the dense
  train and the reference within the bounds of ``test_torch_train.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import CompressionConfig as JaxConfig
from repro.core import hashing as jhash
from repro.core import index as jindex
from repro.core.compressor import HomomorphicCompressor as JComp
from repro.kernels import sketch_encode_pallas, sketch_peel_pallas
from repro.models.transformer import init_lm as j_init_lm
from repro_torch.convert import params_from_jax
from repro_torch.core import hashing as thash
from repro_torch.core import index as tindex
from repro_torch.core.aggregators import make_aggregator
from repro_torch.core.collectives import AggregationState, LocalWorkers
from repro_torch.core.compressor import HomomorphicCompressor
from repro_torch.kernels import ops
from repro_torch.models.registry import model_api
from repro_torch.train.config import TrainConfig
from repro_torch.train.loop import run_training
from repro_torch.train.optimizer import OptimizerConfig
from test_net import _CFG as J_NET_CFG, _run_innet, _sparse_tree
from test_torch_aggregate import SHAPES, dyadic, jax_compressed_aggregate, tcfg
from test_torch_innet import jax_innet_aggregate
from test_torch_train import (CFG as SMOKE, JCFG as J_SMOKE, LOSSLESS,
                              MOMENTUM, B, S, jax_w2_compressed_losses)

GEOMS = [
    JaxConfig(ratio=0.2, lanes=128, rows=6, rounds=8),   # G=30, n=3840
    JaxConfig(ratio=0.2, lanes=100, rows=6, rounds=8),   # G=30, n=3000: n%32=24
    JaxConfig(ratio=0.1, lanes=500, rows=6, rounds=8),   # G=60, n=30000: n%32=16
]
GEOM_IDS = [f"l{c.lanes}g{c.group}" for c in GEOMS]
NB = 3
GAUSS_ATOL = 1e-6     # the reference's own encode tolerance (test_kernels.py)


def blocks(cfg, nb, frac, seed, kind="dyadic"):
    r = np.random.default_rng(seed)
    n = nb * cfg.block_elems
    x = np.zeros(n, np.float32)
    k = max(1, int(n * frac))
    idx = r.choice(n, size=k, replace=False)
    if kind == "dyadic":
        x[idx] = r.choice([-1.0, 1.0], size=k) * np.exp2(r.integers(-2, 3, size=k))
    else:
        x[idx] = r.normal(size=k)
    return x.reshape(nb, cfg.group, cfg.lanes)


def _ids(nb, offset=37):
    return np.arange(nb, dtype=np.int32) + offset


def _words(jwords):
    """Reference uint32 words as the port's int32 carrier."""
    return np.asarray(jwords).view(np.int32)


# ----------------------------------------------------------------------
# the Bloom filter
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("m_bits", [64, 1000, 12_345, 1 << 20, 55_641_344])
def test_bloom_positions_match_reference(k, m_bits):
    """Ids up to 2^32 - 1 (past the int32 edge) and moduli that are not
    powers of two."""
    r = np.random.default_rng(m_bits + k)
    ids = np.concatenate([np.arange(500), r.integers(0, 2**32, 500),
                          [2**31 - 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    for seed in (0x5EED, 0, 12345):
        want = np.asarray(jhash.bloom_positions(jnp.asarray(ids), k, m_bits, seed))
        got = thash.bloom_positions(torch.from_numpy(ids.astype(np.int64)), k,
                                    m_bits, seed)
        assert got.shape == (ids.size, k)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ratio", [0.125, 0.05, 1.0])
def test_bloom_size_words_matches_reference(ratio):
    jc = JaxConfig(bloom_bits_ratio=ratio)
    for n in (1, 100, 511, 512, 30720, 445_138_944):
        assert tindex.bloom_size_words(n, tcfg(jc)) == jindex.bloom_size_words(n, jc)


@pytest.mark.parametrize("density,hashes", [(0.0, 3), (0.01, 3), (0.6, 3),
                                            (0.05, 2)])
def test_bloom_build_and_query_match_reference(density, hashes, monkeypatch):
    jc = dataclasses.replace(GEOMS[0], index="bloom", bloom_hashes=hashes)
    cfg = tcfg(jc)
    xb = blocks(jc, 4, density, seed=int(density * 1000) + hashes) \
        if density else np.zeros((4, jc.group, jc.lanes), np.float32)
    want = _words(jindex.bloom_build(jnp.asarray(xb), jc))
    got = tindex.bloom_build(torch.from_numpy(xb), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    q_want = np.asarray(jindex.bloom_query(xb.shape, jc,
                                           jnp.asarray(want.view(np.uint32))))
    q = tindex.bloom_query(xb.shape, cfg, got)
    np.testing.assert_array_equal(q.numpy(), q_want)
    assert bool(q[torch.from_numpy(xb != 0)].all())      # never misses a non-zero
    # OR and "all k bits set" do not depend on order: any chunking agrees
    for chunk in (97, 4096):
        monkeypatch.setattr(tindex, "BLOOM_CHUNK", chunk)
        np.testing.assert_array_equal(
            tindex.bloom_build(torch.from_numpy(xb), cfg).numpy(), want)
        assert torch.equal(tindex.bloom_query(xb.shape, cfg, got), q)


# ----------------------------------------------------------------------
# the standalone encode and peel against the Pallas kernels (interpret)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
def test_sketch_encode_matches_pallas(cfg, kind):
    xb, ids = blocks(cfg, NB, 0.05, 3, kind), _ids(NB)
    want = np.asarray(sketch_encode_pallas(jnp.asarray(xb), jnp.asarray(ids), cfg,
                                           interpret=True))
    got = ops.sketch_encode(torch.from_numpy(xb), torch.from_numpy(ids), tcfg(cfg))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if kind == "dyadic":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GAUSS_ATOL)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_sketch_encode_takes_half_precision(dtype):
    """f16/bf16 values encode as their f32 values (dyadic values are exact
    in both)."""
    cfg = GEOMS[1]
    xb, ids = blocks(cfg, 2, 0.05, 4), torch.from_numpy(_ids(2))
    got = ops.sketch_encode(torch.from_numpy(xb).to(dtype), ids, tcfg(cfg))
    want = ops.sketch_encode(torch.from_numpy(xb), ids, tcfg(cfg))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    if dtype == torch.float16:
        jwant = sketch_encode_pallas(jnp.asarray(xb.astype(np.float16)),
                                     jnp.asarray(_ids(2)), cfg, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("cfg", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("kind,frac", [("dyadic", 0.02), ("dyadic", 0.15),
                                       ("gauss", 0.05)])
def test_sketch_peel_matches_pallas(cfg, kind, frac):
    """Bits of the non-zeros plus false-positive-like extra candidates
    (as a Bloom query yields): values and residual against the kernel."""
    xb, ids = blocks(cfg, NB, frac, 5, kind), _ids(NB)
    extra = np.random.default_rng(6).random(xb.shape) < 0.01
    bits = (xb != 0) | extra
    y = sketch_encode_pallas(jnp.asarray(xb), jnp.asarray(ids), cfg, interpret=True)
    v_want, r_want = sketch_peel_pallas(y, jnp.asarray(bits), jnp.asarray(ids),
                                        cfg, interpret=True)
    tc = tcfg(cfg)
    for b in (torch.from_numpy(bits), torch.from_numpy(bits.astype(np.uint8))):
        v, r = ops.sketch_peel(torch.from_numpy(np.array(y)), b,
                               torch.from_numpy(ids), tc)
        assert v.dtype == torch.float32 and r.dtype == torch.int8
        np.testing.assert_array_equal(r.numpy(), np.asarray(r_want))
        if kind == "dyadic":
            np.testing.assert_array_equal(v.numpy(), np.asarray(v_want))
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(v_want), rtol=0,
                                       atol=GAUSS_ATOL)


def test_standalone_ops_count_no_launch_on_cpu():
    cfg = tcfg(GEOMS[1])
    xb, ids = torch.from_numpy(blocks(cfg, 2, 0.05, 7)), torch.from_numpy(_ids(2))
    before = dict(ops.LAUNCHES)
    y = ops.sketch_encode(xb, ids, cfg)
    ops.sketch_peel(y, xb != 0, ids, cfg)
    assert ops.LAUNCHES == before


# ----------------------------------------------------------------------
# compressor on the composed path
# ----------------------------------------------------------------------

COMP_GEOMS = [dataclasses.replace(GEOMS[0], index="bloom"), GEOMS[1],
              dataclasses.replace(GEOMS[1], index="bloom")]
COMP_IDS = ["bloom-l128", "bitmap-l100", "bloom-l100"]


@pytest.mark.parametrize("jc", COMP_GEOMS, ids=COMP_IDS)
@pytest.mark.parametrize("density", [0.01, 0.1])
def test_compressor_matches_reference(jc, density):
    nb = 4
    n = nb * jc.block_elems - 7
    x = blocks(jc, nb, density, 8).reshape(-1)[:n]
    offset = 0 if jc.index == "bloom" else 11
    jcomp, comp = JComp(jc), HomomorphicCompressor(tcfg(jc))
    jc_leaf, jmx = jcomp.compress_wire(jnp.asarray(x), block_offset=offset)
    leaf, mx = comp.compress_wire(torch.from_numpy(x), block_offset=offset)
    np.testing.assert_array_equal(leaf.index_words.numpy(),
                                  _words(jc_leaf.index_words))
    np.testing.assert_array_equal(leaf.sketch.numpy(), np.asarray(jc_leaf.sketch))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
    jrec, jst = jcomp.recover(jc_leaf, n, with_stats=True, block_offset=offset)
    rec, st = comp.recover(leaf, n, with_stats=True, block_offset=offset)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    assert (int(st.nnz), int(st.peeled), int(st.residual), st.rounds) == \
        (int(jst.nnz), int(jst.peeled), int(jst.residual), int(jst.rounds))
    if jc.index == "bloom":
        assert int(st.nnz) >= int((x != 0).sum())      # candidates cover the non-zeros


@pytest.mark.parametrize("jc", [GEOMS[0], GEOMS[1],
                                dataclasses.replace(GEOMS[0], index="bloom")],
                         ids=["bitmap-l128", "bitmap-l100", "bloom-l128"])
def test_estimate_matches_reference(jc):
    """The sketch-only decode: masked by the bitmap, unmasked with Bloom."""
    n = 4 * jc.block_elems
    x = blocks(jc, 4, 0.05, 9, kind="gauss").reshape(-1)
    jleaf = JComp(jc).compress(jnp.asarray(x), block_offset=3)
    want = np.asarray(JComp(jc).estimate(jleaf, n, block_offset=3))
    comp = HomomorphicCompressor(tcfg(jc))
    got = comp.estimate(comp.compress(torch.from_numpy(x), block_offset=3), n,
                        block_offset=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if jc.index == "bitmap":
        np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    else:
        assert int((got != 0).sum()) > int((x != 0).sum())


# ----------------------------------------------------------------------
# aggregators on the Bloom and unaligned-bitmap geometries
# ----------------------------------------------------------------------

AGG = {  # 2-block buckets of the aggregate tests, and the unaligned bitmap
    "bloom": JaxConfig(ratio=0.4, lanes=128, rows=6, topk_ratio=0.05,
                       bucket_bytes=4 * 1920 * 2, index="bloom"),
    "unaligned": JaxConfig(ratio=0.2, lanes=100, rows=6, topk_ratio=0.05),
}


@pytest.mark.parametrize("geom", sorted(AGG))
def test_compressed_aggregate_matches_reference_over_2_steps(geom):
    jc = AGG[geom]
    rng = np.random.default_rng(13)
    W = 2
    agg = make_aggregator("compressed", tcfg(jc), LocalWorkers(W))
    res_t = [torch.zeros((W,) + s) for s in SHAPES]
    res_j = [[np.zeros(s, np.float32) for s in SHAPES] for _ in range(W)]
    for _ in range(2):
        grads = [[dyadic(s, rng, 0.2) for s in SHAPES] for _ in range(W)]
        want, res_j, jst = jax_compressed_aggregate(grads, res_j, jc, with_stats=True)
        got, st = agg([[torch.from_numpy(g) for g in gw] for gw in grads],
                      AggregationState(residual=res_t))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
        for li in range(len(SHAPES)):
            for w in range(W):
                np.testing.assert_array_equal(st.residual[li][w].numpy(),
                                              res_j[w][li])
        assert (int(st.stats.nnz), int(st.stats.residual)) == \
            (int(jst.nnz), int(jst.residual))


def test_innet_f32_bloom_is_compressed_bit_for_bit():
    rng = np.random.default_rng(17)
    cfg = tcfg(AGG["bloom"])
    grads = [[torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in SHAPES]
             for _ in range(2)]
    outs = []
    for name in ("compressed_innet", "compressed"):
        res = [torch.zeros((2,) + s) for s in SHAPES]
        out, st = make_aggregator(name, cfg, LocalWorkers(2))(
            grads, AggregationState(residual=res))
        outs.append((out + res, int(st.stats.nnz), int(st.stats.residual)))
    (a, na, ra), (b, nb, rb) = outs
    assert (na, ra) == (nb, rb)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_innet_fxp32_unaligned_bitmap_matches_reference():
    """fxp32 on block_elems % 32 != 0: buckets hold whole words (the
    bucket quantum is lcm(block_elems, 32)), so the tree ORs them per
    bucket; the composed path dequantizes before the standalone peel."""
    jc = dataclasses.replace(AGG["unaligned"], wire_dtype="fxp32",
                             bucket_bytes=4 * 12000 * 1, switch_slots=1)
    rng = np.random.default_rng(19)
    W = 2
    agg = make_aggregator("compressed_innet", tcfg(jc), LocalWorkers(W))
    res_t = [torch.zeros((W,) + s) for s in SHAPES]
    res_j = [[np.zeros(s, np.float32) for s in SHAPES] for _ in range(W)]
    for _ in range(2):
        grads = [[dyadic(s, rng, 0.3) for s in SHAPES] for _ in range(W)]
        want, res_j, jst = jax_innet_aggregate(grads, res_j, jc)
        got, st = agg([[torch.from_numpy(g) for g in gw] for gw in grads],
                      AggregationState(residual=res_t))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
        assert (int(st.stats.nnz), int(st.stats.residual)) == \
            (int(jst.nnz), int(jst.residual))


def test_innet_fxp32_bloom_raises_like_the_reference():
    """The reference fails reshaping a Bloom filter into per-bucket words;
    the port refuses the config before any work, naming the index."""
    jc = dataclasses.replace(J_NET_CFG, wire_dtype="fxp32", index="bloom")
    with pytest.raises((TypeError, ValueError)):
        _run_innet(jc, _sparse_tree())
    with pytest.raises(ValueError, match="bloom"):
        make_aggregator("compressed_innet", tcfg(jc), LocalWorkers(2))
    make_aggregator("compressed_innet", tcfg(dataclasses.replace(jc, wire_dtype="f32")),
                    LocalWorkers(2))


# ----------------------------------------------------------------------
# a lossless train with the Bloom index
# ----------------------------------------------------------------------

def test_w2_lossless_bloom_tracks_dense_and_reference():
    """The lossless profile (ratio 2, rows 60) with ``index="bloom"``: the
    smoke model's dense gradients fill the filter, every coordinate is a
    candidate and peels, so the W=2 train tracks the dense one within
    1e-4 and the reference's losses to rtol=1e-5."""
    jparams = jax.tree.map(np.asarray, j_init_lm(jax.random.PRNGKey(0), J_SMOKE))
    lossless = dict(LOSSLESS, index="bloom")

    def port(aggregator):
        tc = TrainConfig(aggregator=aggregator,
                         compression=tcfg(JaxConfig(**lossless)),
                         optimizer=OptimizerConfig(**MOMENTUM), workers=2, seed=0,
                         zero1=False)
        return run_training(model_api(SMOKE), tc, global_batch=B, seq_len=S,
                            steps=6, device="cpu",
                            params=params_from_jax(jparams, "cpu"), log_every=0)

    dense, comp = port("dense"), port("compressed")
    assert all(abs(a - b) < 1e-4 for a, b in zip(dense.losses, comp.losses)), \
        (dense.losses, comp.losses)
    assert all(m["recovery_residual"] == 0 for m in comp.metrics)
    assert comp.losses[-1] < comp.losses[0]
    want = jax_w2_compressed_losses(jparams, 6, compression=lossless)
    np.testing.assert_allclose(comp.losses, want, rtol=1e-5)
