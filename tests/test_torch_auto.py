"""Wire plans executed on ``LocalWorkers`` and the ``auto`` strategy, on
the CPU, against the JAX reference.

The geometry and the gradients are ``tests/test_dispatch.py``'s: dyadic
leaves (every float sum exact in any order) of four shapes and two
dtypes, ratio 1.0 (peeling recovers every indexed value), exact top-k
with error feedback, two blocks a bucket, a six-bucket stream. Pins:

- at W = 1, each of ``test_dispatch.MIXED_PLANS`` and ``auto`` with and
  without a plan equal the
  reference's aggregator (``test_dispatch._run_aggregator``, a one-device
  mesh) over 3 error-feedback steps, outputs and residuals bit for bit,
  and ``auto``'s ``bucket_occupancy`` equals the reference's telemetry;
- ``DenseAggregator`` refuses a plan, as the reference's does;
- at W = 2 (emulated), mixed plans whose groups start off multiples of
  W and of ``switch_slots``, over every wire (one-shot with the fxp32
  tree, streamed, the emulated reduce-scatter with 3 switch slots), equal
  group by group the reference's
  codec called in process on the same packed rows at the group's block
  offset (``repro.core.aggregators.sparsify_leaf``,
  ``repro.core.bucketing.BucketPlan.pack_flat``,
  ``repro.core.compressor.HomomorphicCompressor.compress_wire`` and
  ``.recover``, ``repro.net.fixedpoint.FixedPointWire``; a dense
  group's rows are the sum of the packed rows), and the port's fixed
  strategy of each group's wire on the whole stream, over 2 steps;
- training with ``aggregator="auto"``: at W = 1 the losses equal
  ``dense``'s (the step aggregates one worker densely, as the
  reference's ``test_auto_single_worker_matches_dense``); at W = 2 the
  analytic plan trains bit for bit as ``compressed`` and the metrics
  carry the occupancy vector; the launcher runs ``--aggregator auto``.
"""
import dataclasses
import functools
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_dispatch import AGG_BASE, MIXED_PLANS, _agg_tree, _run_aggregator
from repro_torch.core import wireplan as wp
from repro_torch.core.aggregators import make_aggregator
from repro_torch.core.bucketing import make_bucket_plan
from repro_torch.core.collectives import AggregationState, LocalWorkers
from repro_torch.core.config import CompressionConfig

KEYS = ("big", "half", "mat", "tiny")          # the reference's flatten order
BASE = CompressionConfig(**dataclasses.asdict(AGG_BASE))
NEVER = dataclasses.replace(AGG_BASE, use_pallas="never")


def _port_plan(plan):
    """A reference ``WirePlan`` as the port's."""
    return wp.WirePlan(plan.n_buckets, tuple(
        wp.WireGroup(*dataclasses.astuple(g)) for g in plan.groups))


def _grads(workers, step):
    return [[_agg_tree(seed=step + 100 * w)[k] for k in KEYS]
            for w in range(workers)]


def _run(cfg, name, workers, steps, wire_plan=None):
    """``steps`` aggregations from zero residuals: each step's output
    leaves and occupancy (numpy) and the final residuals."""
    agg = make_aggregator(name, cfg, LocalWorkers(workers), wire_plan=wire_plan)
    res = [torch.zeros((workers,) + v.shape) for v in _grads(1, 0)[0]]
    outs, occ = [], []
    for s in range(steps):
        gw = [[torch.from_numpy(g) for g in w] for w in _grads(workers, s)]
        out, st = agg(gw, AggregationState(residual=res))
        outs.append([o.numpy() for o in out])
        occ.append(None if st.telemetry is None
                   else st.telemetry["bucket_occupancy"].numpy())
    return outs, occ, [r.numpy() for r in res]


@functools.lru_cache(maxsize=None)
def _reference(name, plan_name):
    plan = None if plan_name is None else MIXED_PLANS[plan_name]
    return _run_aggregator(NEVER, name, steps=3, wire_plan=plan)


def _assert_equal_to_reference(got, want):
    outs, _, res = got
    want_outs, want_res = want
    for step, (o, w) in enumerate(zip(outs, want_outs)):
        for k, x in zip(KEYS, o):
            assert x.dtype == w[k].dtype, (step, k)
            np.testing.assert_array_equal(x, w[k], err_msg=f"{step} {k}")
    for k, r in zip(KEYS, res):
        np.testing.assert_array_equal(r[0], want_res[k], err_msg=k)


@pytest.mark.parametrize("plan_name", sorted(MIXED_PLANS))
def test_w1_mixed_plan_matches_reference_bitwise(plan_name):
    cfg = dataclasses.replace(BASE, use_pallas="never")
    got = _run(cfg, "compressed", 1, 3, _port_plan(MIXED_PLANS[plan_name]))
    _assert_equal_to_reference(got, _reference("compressed", plan_name))
    # and the fixed strategy: the plan only moves buckets between
    # lossless wires
    _assert_equal_to_reference(got, _reference("compressed", None))


def _reference_occupancy(wire_plan, steps=3):
    """The reference ``auto`` aggregator's ``bucket_occupancy`` a step,
    on ``_run_aggregator``'s one-device mesh and inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.core.aggregators import make_aggregator as j_make
    from repro.core.collectives import (AggregationState as JState,
                                        init_aggregation_state)
    mesh = make_mesh((1,), ("data",))
    tree = jax.tree.map(jnp.asarray, _agg_tree())
    specs = jax.tree.map(lambda _: P(), tree)
    agg = j_make("auto", NEVER, mesh, ("data",), ("model",),
                 outer_manual=("data",), wire_plan=wire_plan)

    def fn(g, r):
        _, st = agg(g, JState(residual=r), specs)
        return st.residual, st.telemetry["bucket_occupancy"]

    jfn = jax.jit(shard_map(fn, mesh=mesh, in_specs=(specs, specs),
                            out_specs=(specs, P()), axis_names={"data"},
                            check_vma=False))
    res = init_aggregation_state(tree, NEVER).residual
    occ = []
    for s in range(steps):
        res, o = jfn(jax.tree.map(jnp.asarray, _agg_tree(seed=s)), res)
        occ.append(np.asarray(o))
    return occ


@pytest.mark.parametrize("plan_name", [None, "dense+comp+rs"])
def test_auto_matches_reference_bitwise(plan_name):
    cfg = dataclasses.replace(BASE, use_pallas="never")
    plan = None if plan_name is None else MIXED_PLANS[plan_name]
    got = _run(cfg, "auto", 1, 3, None if plan is None else _port_plan(plan))
    _assert_equal_to_reference(got, _reference("auto", plan_name))
    _assert_equal_to_reference(got, _reference("compressed", None))
    want = _reference_occupancy(plan)
    for o, w in zip(got[1], want):
        assert o.shape == (6,) and o.dtype == np.float32
        np.testing.assert_array_equal(o, w)
    assert 0 < float(got[1][0].max()) < 1


def test_dense_aggregator_rejects_wire_plan():
    agg = make_aggregator("dense", BASE, LocalWorkers(1),
                          wire_plan=_port_plan(MIXED_PLANS["dense+comp+rs"]))
    grads = [[torch.from_numpy(g) for g in _grads(1, 0)[0]]]
    with pytest.raises(ValueError, match="does not execute wire plans"):
        agg(grads, AggregationState(residual=[]))


def test_wire_plan_must_cover_the_stream():
    agg = make_aggregator("compressed", BASE, LocalWorkers(1),
                          wire_plan=wp.uniform_plan(5, "dense"))
    grads = [[torch.from_numpy(g) for g in _grads(1, 0)[0]]]
    with pytest.raises(ValueError, match="covers 5 buckets, stream has 6"):
        agg(grads, AggregationState(
            residual=[torch.zeros((1,) + g.shape) for g in grads[0]]))


# ----------------------------------------------------------------------
# W = 2, emulated
# ----------------------------------------------------------------------

W2_PLANS = {
    # every wire; starts 0, 1, 3, 4: off multiples of W and switch_slots
    "four_wires": (("dense", 1), ("compressed_rs", 2), ("compressed", 1),
                   ("compressed_innet", 2)),
    # a reduce-scatter group of 3 buckets (padded to 4 over W = 2)
    "odd_rs": (("compressed", 1), ("compressed_rs", 3), ("dense", 1),
               ("compressed_innet", 1)),
}
W2_FIELDS = {"fxp32": dict(wire_dtype="fxp32"),
             "overlap": dict(overlap=True),
             "rs_emulate_slots3": dict(rs_wire="emulate", switch_slots=3)}


def _w2_plan(name):
    groups, start = [], 0
    for wire, n in W2_PLANS[name]:
        groups.append(wp.WireGroup(start, n, wire))
        start += n
    return wp.WirePlan(start, tuple(groups))


def _reference_w2(fields, plan, steps):
    """The W = 2 aggregates from the reference's functions called in
    process (jitted): each worker's leaves sparsified with error feedback
    (``sparsify_leaf``) and packed (``BucketPlan.pack_flat``); each
    compressed group's rows encoded per worker at the group's block
    offset (``compress_wire``), summed (sketch; fxp32: quantized by
    ``FixedPointWire`` at the workers' max exponent a bucket) and ORed
    (words), and recovered (``recover``, dequantizing on fxp32); a dense
    group's rows summed. Per step the mean leaves, and the residuals."""
    import jax
    import jax.numpy as jnp
    from repro.core import CompressedLeaf as JLeaf
    from repro.core import HomomorphicCompressor as JComp
    from repro.core.aggregators import sparsify_leaf
    from repro.core.bucketing import make_bucket_plan as j_make_plan
    from repro.net.fixedpoint import FixedPointWire

    jcfg = dataclasses.replace(NEVER, **fields)
    jplan = j_make_plan(_agg_tree(), jcfg)
    comp = JComp(jcfg)
    nbpb = jplan.bucket_elems // jcfg.block_elems
    fxp = FixedPointWire(workers=2)
    sparsify = jax.jit(lambda g, r: sparsify_leaf(g, r, jcfg))
    encode = jax.jit(lambda x, off: comp.compress_wire(x, block_offset=off))

    @functools.partial(jax.jit, static_argnums=(0, 1))
    def codec(n_b, fxp32, rows, off):
        enc = [encode(r.reshape(-1), off) for r in rows]
        words = enc[0][0].index_words | enc[1][0].index_words
        dequant = None
        if fxp32:
            exp = jnp.maximum(*[fxp.exponents_from_maxabs(
                mx.reshape(n_b, nbpb).max(axis=1)) for _, mx in enc])
            sk = sum(fxp.encode(c.sketch.reshape(n_b, -1), exp)
                     for c, _ in enc).reshape(enc[0][0].sketch.shape)
            dequant = (jnp.repeat(exp, nbpb), fxp.mantissa_bits)
        else:
            sk = enc[0][0].sketch + enc[1][0].sketch
        rec = comp.recover(JLeaf(sketch=sk, index_words=words),
                           n_b * jplan.bucket_elems, block_offset=off,
                           dequant=dequant)
        return rec.reshape(n_b, -1)

    res = [[jnp.zeros(_agg_tree()[k].size, jnp.float32) for k in KEYS]
           for _ in range(2)]
    outs = []
    for s in range(steps):
        packed = []
        for w, leaves in enumerate(_grads(2, s)):
            flats = []
            for i, g in enumerate(leaves):
                flat, res[w][i] = sparsify(
                    jnp.asarray(g.reshape(-1), jnp.float32), res[w][i])
                flats.append(flat)
            packed.append(jplan.pack_flat(flats))
        parts = []
        for g in plan.groups:
            rows = [p[g.start:g.stop] for p in packed]
            if g.wire == "dense":
                parts.append(rows[0] + rows[1])
                continue
            fxp32 = g.wire == "compressed_innet" and jcfg.wire_dtype == "fxp32"
            parts.append(codec(g.n_buckets, fxp32, rows,
                               jnp.int32(g.start * nbpb)))
        out = jplan.unpack(jnp.concatenate(parts) / 2)
        outs.append([np.asarray(out[k]) for k in KEYS])
    return outs, [[np.asarray(r).reshape(_agg_tree()[k].shape)
                   for k, r in zip(KEYS, rw)] for rw in res]


def _rows(leaves, cfg):
    """Mean output leaves -> the packed (n_buckets, E) stream."""
    shaped = [torch.from_numpy(np.array(x)) for x in leaves]
    return make_bucket_plan(shaped, cfg).pack_flat(
        [x.reshape(-1).float() for x in shaped])


@pytest.mark.parametrize("fields", sorted(W2_FIELDS))
@pytest.mark.parametrize("plan_name", sorted(W2_PLANS))
def test_w2_mixed_plan_equals_reference_and_fixed_group_by_group(
        plan_name, fields):
    cfg = dataclasses.replace(BASE, use_pallas="never", **W2_FIELDS[fields])
    plan = _w2_plan(plan_name)
    outs, _, res = _run(cfg, "compressed", 2, 2, plan)
    want_outs, want_res = _reference_w2(W2_FIELDS[fields], plan, 2)
    fixed = {w: _run(cfg, w, 2, 2) for w in wp.WIRES if w != "dense"}
    for step in range(2):
        got = _rows(outs[step], cfg)
        want = _rows(want_outs[step], cfg)
        for g in plan.groups:
            sl = slice(g.start, g.stop)
            assert torch.equal(got[sl], want[sl]), (step, g)
            # a dense group sums the packed (sparsified) rows: in this
            # lossless regime, the compressed strategy's rows
            wire = "compressed" if g.wire == "dense" else g.wire
            assert torch.equal(got[sl], _rows(fixed[wire][0][step], cfg)[sl]), \
                (step, g, "fixed")
        for k, x, y in zip(KEYS, outs[step], want_outs[step]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (step, k)
    for w in range(2):
        for k, r, want in zip(KEYS, res, want_res[w]):
            np.testing.assert_array_equal(r[w], want, err_msg=f"{w} {k}")
    assert any(bool((o != 0).any()) for o in outs[-1])


def test_w2_auto_occupancy_is_the_aggregate_s():
    cfg = dataclasses.replace(BASE, use_pallas="never")
    plan = _w2_plan("four_wires")
    outs, occ, _ = _run(cfg, "auto", 2, 2, plan)
    for o, step_outs in zip(occ, outs):
        rows = _rows(step_outs, cfg)
        np.testing.assert_allclose(o, (rows != 0).float().mean(1).numpy(),
                                   rtol=2e-7, atol=0)


# ----------------------------------------------------------------------
# training and the launcher
# ----------------------------------------------------------------------

def _train(tc, steps=3, wire_plan=None):
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training
    res = run_training(model_api(get_arch("granite-3-2b").smoke), tc,
                       global_batch=4, seq_len=32, steps=steps, device="cpu",
                       log_every=0, wire_plan=wire_plan)
    h = hashlib.sha256()
    for t in res.state.params.leaves():
        h.update(t.detach().contiguous().view(torch.uint8).numpy())
    return res, h.hexdigest()


LOSSLESS = dict(ratio=2.0, lanes=512, rows=60, chunk_blocks=16)
# ratio 0.1, top-k 4%: the wire the analytic plan picks at W = 2 on the
# CPU is ``compressed``; one-block buckets make the smoke stream 14
SPARSE = dict(ratio=0.1, topk_ratio=0.04, bucket_bytes=4 * 30720)


def _tc(aggregator, workers, comp):
    from repro_torch.train.config import TrainConfig
    from repro_torch.train.optimizer import OptimizerConfig
    return TrainConfig(aggregator=aggregator, workers=workers,
                       compression=CompressionConfig(**comp),
                       optimizer=OptimizerConfig(kind="adamw", lr=1e-3,
                                                 warmup_steps=0))


def test_auto_single_worker_matches_dense():
    dense, _ = _train(_tc("dense", 1, LOSSLESS))
    auto, _ = _train(_tc("auto", 1, LOSSLESS))
    np.testing.assert_array_equal(dense.losses, auto.losses)
    assert "bucket_occupancy" not in auto.metrics[0]


def test_w2_auto_trains_as_compressed_with_occupancy():
    from repro_torch.core.costmodel import analytic_plan
    comp, comp_digest = _train(_tc("compressed", 2, SPARSE))
    auto, auto_digest = _train(_tc("auto", 2, SPARSE))
    occ = auto.metrics[-1]["bucket_occupancy"]
    assert isinstance(occ, list) and len(occ) > 1
    plan = make_bucket_plan(comp.state.params.leaves(),
                            CompressionConfig(**SPARSE))
    assert analytic_plan(plan, CompressionConfig(**SPARSE), 2,
                         device="cpu").describe() == \
        f"[0:{plan.n_buckets}]=compressed" and len(occ) == plan.n_buckets
    assert comp.losses == auto.losses and comp_digest == auto_digest
    assert all(0.0 <= v <= 1.0 for v in occ) and max(occ) > 0
    # a plan mixing the compressed wires trains bit for bit as well (a
    # dense group would sum Gaussian values in another order than the
    # peel)
    nb = len(occ)
    plan = wp.WirePlan(nb, (wp.WireGroup(0, 1, "compressed_innet"),
                            wp.WireGroup(1, nb - 2, "compressed_rs"),
                            wp.WireGroup(nb - 1, 1, "compressed")))
    mixed, mixed_digest = _train(_tc("auto", 2, SPARSE), wire_plan=plan)
    assert mixed.losses == comp.losses and mixed_digest == comp_digest


def test_launcher_runs_auto():
    from repro_torch.launch.train import main
    out = main(["--arch", "granite-3-2b", "--smoke", "--workers", "2",
                "--steps", "2", "--global-batch", "4", "--seq-len", "32",
                "--device", "cpu", "--aggregator", "auto", "--no-zero1"])
    assert out["aggregator"] == "auto" and out["zero1"] is False
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
