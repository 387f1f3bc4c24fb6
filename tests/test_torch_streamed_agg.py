"""The streamed wire and the reduce-scatter wire on ``LocalWorkers``:
chunking is bit-invisible, ``compressed_rs`` is ``compressed``, and at
W = 1 every strategy equals the JAX reference's aggregator.

The geometry and the gradients are ``tests/test_dispatch.py``'s: dyadic
leaves (every float sum exact in any order) of four shapes and two
dtypes, ratio 1.0 (peeling recovers every indexed value), exact top-k
with error feedback, two blocks a bucket, a six-bucket stream. Pins, all
bit for bit, outputs and error-feedback residuals over three steps:

- at W = 1, 2, 3 and 4 (levels (2, 2), the ``tor_spine`` tree),
  ``stream_chunks=4`` (zero-padded) with ``switch_slots=1`` equals the
  unchunked run for ``compressed``, ``compressed_innet`` on the f32 and
  fxp32 wires, and ``compressed_rs`` emulated; on the native
  reduce-scatter wire at W > 1 a chunk count must divide the per-rank
  bucket count ``ceil(6/W)``, so 4 raises and ``overlap`` (a per-rank
  run of buckets a chunk) is held to the one-shot run instead;
- ``compressed_rs`` (native one-shot and streamed, emulated) equals
  ``compressed``, recovery stats included;
- at W = 1, each strategy with ``overlap`` off and on equals the
  reference aggregator on a one-device mesh, run as
  ``tests/test_dispatch.py`` runs it (``use_pallas="never"``);
- the gather-skip contract on an aligned two-leaf tree: worker r's
  aggregate is exact on its owned coordinates (each leaf's ZeRO-1 slice
  r) and zero elsewhere, and the residuals are the full gather's; the
  ZeRO-1 update from those views (the grad norm summed over the
  workers' squares) equals the update from the full gather.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_dispatch import AGG_BASE, _agg_tree, _run_aggregator, dyadic_sparse
from repro_torch.core.aggregators import make_aggregator
from repro_torch.core.collectives import AggregationState, LocalWorkers
from repro_torch.core.config import CompressionConfig

KEYS = ("big", "half", "mat", "tiny")          # the reference's flatten order
BASE = CompressionConfig(**dataclasses.asdict(AGG_BASE))
LEVELS = {1: (1,), 2: (2,), 3: (3,), 4: (2, 2)}
# name -> (aggregator, config fields)
STRATEGIES = {
    "compressed": ("compressed", {}),
    "innet_f32": ("compressed_innet", {}),
    "innet_fxp32": ("compressed_innet", dict(wire_dtype="fxp32")),
    "rs_native": ("compressed_rs", dict(rs_wire="native")),
    "rs_emulate": ("compressed_rs", dict(rs_wire="emulate")),
}


def _grads(workers, step):
    """Every worker's leaves (numpy) at ``step``."""
    return [[_agg_tree(seed=step + 100 * w)[k] for k in KEYS]
            for w in range(workers)]


def _run(cfg, name, workers, steps=3, zero1_dims=None):
    """``steps`` aggregations from zero residuals: each step's output
    (numpy; one list a worker on the gather-skip path) and stats, and the
    final residuals."""
    group = LocalWorkers(workers, LEVELS[workers])
    agg = make_aggregator(name, cfg, group, zero1_dims=zero1_dims)
    shapes = [v.shape for v in _grads(1, 0)[0]]
    res = [torch.zeros((workers,) + sh) for sh in shapes]
    outs, stats = [], []
    for s in range(steps):
        gw = [[torch.from_numpy(g) for g in w] for w in _grads(workers, s)]
        out, st = agg(gw, AggregationState(residual=res))
        to_np = lambda leaves: [o.numpy() for o in leaves]
        outs.append([to_np(o) for o in out] if isinstance(out[0], list)
                    else to_np(out))
        stats.append(tuple(int(x) for x in st.stats[:3]))
    return outs, stats, [r.numpy() for r in res]


def _cfg(workers, fields):
    c = dataclasses.replace(BASE, **fields)
    return dataclasses.replace(c, topology="tor_spine") if workers == 4 else c


def _assert_same(a, b, what):
    outs_a, stats_a, res_a = a
    outs_b, stats_b, res_b = b
    assert stats_a == stats_b, what
    for step, (oa, ob) in enumerate(zip(outs_a, outs_b)):
        for x, y in zip(oa, ob):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (what, step)
    for x, y in zip(res_a, res_b):
        assert x.tobytes() == y.tobytes(), what


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_chunked_equals_unchunked_bitwise(strategy, workers):
    name, fields = STRATEGIES[strategy]
    base = _cfg(workers, fields)
    want = _run(base, name, workers)
    chunked = dataclasses.replace(base, stream_chunks=4, switch_slots=1)
    if strategy == "rs_native" and workers > 1:
        with pytest.raises(ValueError, match="per-rank reduce-scatter"):
            _run(chunked, name, workers, steps=1)
        chunked = dataclasses.replace(base, overlap=True)
    _assert_same(_run(chunked, name, workers), want, strategy)


@pytest.mark.parametrize("workers", [2, 3, 4])
@pytest.mark.parametrize("fields", [dict(rs_wire="native"),
                                    dict(rs_wire="auto", overlap=True),
                                    dict(rs_wire="emulate"),
                                    dict(rs_wire="emulate", stream_chunks=4)],
                         ids=str)
def test_rs_equals_compressed_bitwise(workers, fields):
    want = _run(_cfg(workers, {}), "compressed", workers)
    _assert_same(_run(_cfg(workers, fields), "compressed_rs", workers), want,
                 fields)


@pytest.mark.parametrize("name,fields", [
    ("compressed", {}), ("compressed_rs", {}), ("compressed_innet", {}),
    ("compressed_innet", dict(wire_dtype="fxp32"))], ids=str)
@pytest.mark.parametrize("overlap", [False, True], ids=["fused", "overlap"])
def test_w1_matches_reference_aggregator(name, fields, overlap):
    jc = dataclasses.replace(AGG_BASE, use_pallas="never", overlap=overlap,
                             **fields)
    want_outs, want_res = _run_aggregator(jc, name, steps=2)
    outs, _, res = _run(CompressionConfig(**dataclasses.asdict(jc)), name, 1,
                        steps=2)
    for got, want in zip(outs, want_outs):
        for k, o in zip(KEYS, got):
            assert o.dtype == want[k].dtype
            np.testing.assert_array_equal(o, want[k], err_msg=k)
    for k, r in zip(KEYS, res):
        np.testing.assert_array_equal(r[0], want_res[k], err_msg=k)


SKIP_LEAF = 4 * (BASE.bucket_bytes // 4)        # 4 buckets a leaf


def _skip_run(workers, chunks, zero1_dims):
    """Aggregations of two 4-bucket dyadic leaves (8 buckets)."""
    group = LocalWorkers(workers, LEVELS[workers])
    cfg = dataclasses.replace(_cfg(workers, {}), stream_chunks=chunks)
    agg = make_aggregator("compressed_rs" if zero1_dims else "compressed",
                          cfg, group, zero1_dims=zero1_dims)
    leaves = [torch.zeros(SKIP_LEAF), torch.zeros(SKIP_LEAF)]
    active = zero1_dims is not None and agg.gather_skip_active(leaves)
    res = [torch.zeros((workers, SKIP_LEAF)) for _ in range(2)]
    outs = []
    for s in range(3):
        gw = [[torch.from_numpy(dyadic_sparse(SKIP_LEAF, 0.3, 7 * s + w + 50 * k))
               for k in range(2)] for w in range(workers)]
        out, _ = agg(gw, AggregationState(residual=res))
        outs.append(out)
    return active, outs, res


@pytest.mark.parametrize("workers", [2, 4])
def test_gather_skip_output_contract(workers):
    active, outs, res = _skip_run(workers, 2, (0, 0))
    assert active
    _, full, full_res = _skip_run(workers, 2, None)
    per = SKIP_LEAF // workers
    for step, (got, want) in enumerate(zip(outs, full)):
        assert len(got) == workers
        for r, leaves in enumerate(got):
            for g, w in zip(leaves, want):
                own = slice(r * per, (r + 1) * per)
                assert torch.equal(g[own], w[own]), (step, r)
                rest = torch.ones(SKIP_LEAF, dtype=torch.bool)
                rest[own] = False
                assert not g[rest].any(), (step, r)
    for a, b in zip(res, full_res):
        assert torch.equal(a, b)
    assert any(bool((w != 0).any()) for w in full[0])
    # one chunk a rank run: the slices land on the wrong ranks, no skip
    active, outs, _ = _skip_run(workers, 1, (0, 0))
    assert not active and not isinstance(outs[0][0], list)
    for got, want in zip(outs, full):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("workers", [2, 4])
def test_gather_skip_update_equals_full_gather_update(workers):
    """``apply_update`` on the gather-skip views equals it on the full
    aggregate: each worker's slice reads only its own coordinates, and
    the norm of dyadic values sums exactly in any order."""
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import TrainState, apply_update

    _, views, _ = _skip_run(workers, 2, (0, 0))
    _, full, _ = _skip_run(workers, 2, None)
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=0, grad_clip=1.0)
    group = LocalWorkers(workers, LEVELS[workers])
    got = []
    for grads, skip in ((views[-1], True), (full[-1], False)):
        leaves = [torch.linspace(-1.0, 1.0, SKIP_LEAF) for _ in range(2)]
        params = type("Params", (), {"leaves": lambda self: leaves})()
        state = TrainState(params=params, opt=init_opt_state(leaves, ocfg),
                           residual=[], step=0)
        gnorm = apply_update(state, grads, (0, 0), group, ocfg, skip=skip)
        got.append((gnorm, leaves, state.opt))
    (n_skip, p_skip, o_skip), (n_full, p_full, o_full) = got
    assert float(n_full) > 1.0                # the clip is active
    assert torch.equal(n_skip, n_full)
    for a, b in zip(p_skip, p_full):
        assert torch.equal(a, b)
    for k in o_full:
        for a, b in zip(o_skip[k], o_full[k]):
            assert torch.equal(a, b)
