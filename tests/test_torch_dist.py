"""W data-parallel ranks as ``torch.distributed`` processes (gloo, CPU)
against the one-process emulation (``LocalWorkers``), numpy and the JAX
reference.

One spawn a world size (W = 2; W = 3, whose ring is the only OR; W = 4
on levels (2, 2)), module-scoped and started together: every rank runs
all of its checks in :func:`_rank` on one CPU thread and sends numpy
results back, and the tests below compare them with references computed
here meanwhile. Ranks rendezvous through a ``file://`` under
``tmp_path``; a rank that raises or hangs fails the spawn
(``launch/ranks.py``). The ranks import this module, so it imports JAX
only inside the tests that need it (each rank would pay seconds for it).

Pins, all exact unless stated:

- the OR ring, doubling and hierarchical ``or_allreduce`` (and
  ``ProcessGroupWorkers.bor``) equal ``LocalWorkers.bor`` and a numpy OR
  reduce on lengths not divisible by W, words with bit 31 set, and
  payloads either side of the 65,536-byte ring threshold;
- ``sum`` equals ``LocalWorkers.sum`` bit for bit on dyadic inputs (every
  order exact), and at W = 2 on Gaussian ones (``a + b == b + a`` in
  f32); ``max`` is exact; every rank receives the same bits;
- the P2P ``tree_all_reduce`` equals the flat integer sum and OR, flat
  and ``tor_spine``, windowed and not;
- one ``compressed`` and one ``compressed_innet`` (f32 wire, flat or
  ``tor_spine``) aggregation of dyadic gradients gives every rank the
  emulation's mean and its own worker's residual row;
- at smoke size, 3 steps at W = 2 for ``dense``, ``compressed`` (bitmap
  and Bloom) and ``compressed_innet`` fxp32, with the ZeRO-1 update (the
  default; the lossless profile takes the replicated one, as the
  reference it tracks): losses and final parameters
  (sha256 of their bytes) bit for bit with the ``LocalWorkers`` run on
  one thread here; the lossless profile's losses within rtol 1e-5 of the
  JAX reference
  (``test_torch_train.jax_w2_compressed_losses``, the tolerance of
  ``test_w2_lossless_compressed_tracks_dense_and_reference``);
- at W = 4 on levels (2, 2): parameters identical on every rank, and
  lossless compressed losses within 1e-4 of dense, the bound of
  ``tests/drivers/train_step_driver.py``;
- the sum and OR reduce-scatters (``ProcessGroupWorkers.sum_scatter``
  and ``bor_scatter``, the ring ``or_reduce_scatter_ring`` on one level
  and the hierarchical ``or_reduce_scatter``) equal numpy's sum and OR
  followed by the rank-major slice, outermost level first;
  ``ProcessGroupWorkers.gather`` is the concatenation in rank order of
  any dtype's bytes; ``gather_chunk_slices`` inverts a per-chunk scatter;
- ``compressed_rs`` (one-shot and streamed) and the streamed
  ``compressed`` aggregate give each rank the emulation's mean and
  residual row; on an aligned two-leaf tree the gather-skip path gives
  each rank the emulation's view of its own worker;
- 3 steps at W = 2 of ``compressed_rs`` with ZeRO-1 (one-shot, and
  streamed with ``overlap``) and of the streamed ``compressed``: losses
  and parameter digests bit for bit with the emulation; at W = 4 the
  ZeRO-1 parameters identical on every rank;
- a mixed wire plan (every wire, groups starting off multiples of W and
  of ``switch_slots``; the f32 wire one-shot, and the fxp32 tree
  streamed) executed by ``auto`` gives each rank the emulation's mean
  and residual row, equal to ``compressed``'s; 3 steps at W = 2 of
  ``auto`` with its analytic plan and with a mixed plan: losses and
  parameter digests bit for bit with the emulation, and the analytic
  plan's with ``compressed``'s;
- the dense and compressed all-to-all exchanges, fused and in 2 chunks,
  on dyadic payloads over 2 steps: every rank's merged lane equal to
  numpy's ``sum_s payload_s[r]`` and to ``LocalWorkers``' bit for bit,
  at W = 2 and 3 on one level (the P2P leg) and W = 4 on levels (2, 2)
  (the emulated leg); the backward gathers every rank's cotangent onto
  the lane axis; a train step with ``ep_workers > 1`` on ranks raises
  ``NotImplementedError``.
"""
import concurrent.futures
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.collectives import (LocalWorkers, ProcessGroupWorkers,
                                          _use_ring, gather_chunk_slices,
                                          level_indices, linear_rank,
                                          or_allreduce, or_allreduce_doubling,
                                          or_allreduce_ring, or_reduce_scatter,
                                          or_reduce_scatter_ring)
from repro_torch.core.config import CompressionConfig
from repro_torch.core.wireplan import WireGroup, WirePlan
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.net.topology import make_topology, tree_all_reduce
from repro_torch.train.optimizer import OptimizerConfig

LEVELS = {2: (2,), 3: (3,), 4: (2, 2)}
# int32 words: below the threshold (doubling on power-of-two levels) and
# above it (ring); lengths that no W of these divides; one 2-D stream
OR_SHAPES = [(7,), (16_381,), (16_385,), (7, 2_340), (7, 2_341)]
B, S, STEPS = 4, 32, 3
LOSSLESS = dict(ratio=2.0, lanes=512, rows=60, chunk_blocks=64)
AGG_SHAPES = [(40, 30), (7,), (3, 50, 20), (600,), (2, 128)]
AGG_CFG = dict(ratio=0.4, lanes=128, rows=6, topk_ratio=0.05,
               bucket_bytes=4 * 1920 * 2)          # 2 blocks a bucket
MOMENTUM = dict(kind="momentum", lr=1e-2, warmup_steps=0, total_steps=100,
                grad_clip=0.0)


def _words(world, shape, seed):
    """Every rank's int32 words (uniform uint32 bits: bit 31 set in half)."""
    r = np.random.default_rng(seed)
    return r.integers(0, 2**32, size=(world,) + shape,
                      dtype=np.uint32).view(np.int32)


def _dyadic(world, n, seed):
    r = np.random.default_rng(seed)
    v = r.choice([-1.0, 1.0], size=(world, n)) * np.exp2(r.integers(-4, 5, (world, n)))
    return (v * (r.random((world, n)) < 0.7)).astype(np.float32)


def _agg_grads(world, seed=12):
    """Every worker's dyadic gradient leaves (every sum exact)."""
    r = np.random.default_rng(seed)
    return [[torch.from_numpy(_dyadic(1, int(np.prod(sh)), r.integers(1 << 30))
                              .reshape(sh)) for sh in AGG_SHAPES]
            for _ in range(world)]


# aggregations on every rank: name -> (aggregator, config fields)
AGGREGATES = {"compressed": ("compressed", {}),
              "compressed_innet": ("compressed_innet", {}),
              "compressed_overlap": ("compressed", dict(overlap=True)),
              "compressed_rs": ("compressed_rs", {}),
              "compressed_rs_overlap": ("compressed_rs", dict(overlap=True)),
              "auto_mixed": ("auto", dict(lanes=32, bucket_bytes=4 * 480)),
              "auto_mixed_fxp32_overlap": ("auto", dict(
                  lanes=32, bucket_bytes=4 * 480, wire_dtype="fxp32",
                  overlap=True, switch_slots=2))}
# lanes 32: one 480-element block a bucket, an 11-bucket stream under a
# plan of every wire whose groups start off multiples of W and slots
AGG_PLAN = WirePlan(11, (WireGroup(0, 1, "dense"),
                         WireGroup(1, 3, "compressed_rs"),
                         WireGroup(4, 1, "compressed"),
                         WireGroup(5, 3, "compressed_innet"),
                         WireGroup(8, 3, "compressed_rs")))


def _aggregate(name, world, group, grads_w, fields=None, shapes=AGG_SHAPES,
               zero1_dims=None):
    """One aggregation of ``grads_w`` (the group's local workers') with
    error feedback from zero residuals: the mean leaves (one list a local
    worker on the gather-skip path) and residuals; ``auto`` executes
    ``AGG_PLAN``."""
    from repro_torch.core.aggregators import make_aggregator
    from repro_torch.core.collectives import AggregationState
    cfg = CompressionConfig(**{**AGG_CFG, "topology": "tor_spine" if world == 4
                               else "flat", **(fields or {})})
    res = [torch.zeros((len(grads_w),) + sh) for sh in shapes]
    out, st = make_aggregator(
        name, cfg, group, zero1_dims=zero1_dims,
        wire_plan=AGG_PLAN if name == "auto" else None)(
        grads_w, AggregationState(residual=res))
    to_np = lambda leaves: [o.numpy() for o in leaves]
    out = [to_np(o) for o in out] if isinstance(out[0], list) else to_np(out)
    return out, [r.numpy() for r in st.residual]


SKIP_SHAPES = [(4 * 3840,), (4 * 3840,)]      # 4 buckets a leaf


def _skip_grads(world):
    """Every worker's leaves of the aligned two-leaf tree (dyadic)."""
    return [[torch.from_numpy(_dyadic(1, sh[0], 30 + 2 * w + k)[0])
             for k, sh in enumerate(SKIP_SHAPES)] for w in range(world)]


def _skip_aggregate(world, group, grads_w):
    """The gather-skip aggregation of the aligned tree: 2 chunks, each
    leaf's ZeRO-1 slice on dim 0 inside its rank's run of buckets."""
    return _aggregate("compressed_rs", world, group, grads_w,
                      dict(stream_chunks=2), SKIP_SHAPES, zero1_dims=(0, 0))


def _rs_payloads(world, r):
    """Rank r's inputs to the reduce-scatters: int words (bit 31 set in
    half) and dyadic floats, leading dims divisible by W."""
    return (torch.from_numpy(_words(world, (world * 5, 3), 21)[r]),
            torch.from_numpy(_dyadic(world, world * 7 * 4, 22)[r]
                             .reshape(world * 7, 4)))


# the exchange codec of the reference driver's all-to-all check: ratio
# 2.5 (G 2, 256-element blocks), 2 buckets a destination
A2A_CFG = dict(ratio=2.5, lanes=128, rows=6, rounds=10, chunk_blocks=8,
               topk_ratio=None, error_feedback=False, bucket_bytes=2 * 768 * 4)
A2A_N = 2 * 1536


def _a2a_payloads(world, step):
    """Every source's ``(W, A2A_N)`` lanes: 90% dyadic non-zeros a lane."""
    r = np.random.default_rng(500 + step)
    out = np.zeros((world, world, A2A_N), np.float32)
    for s in range(world):
        for d in range(world):
            idx = r.choice(A2A_N, size=int(A2A_N * 0.9), replace=False)
            out[s, d, idx] = (r.choice([-1.0, 1.0], size=idx.size)
                              * np.exp2(r.integers(-2, 3, size=idx.size)))
    return out


def _exchanges(world, group):
    """(name, chunks) -> each step's merged lanes of the group's local
    workers, stacked."""
    from repro_torch.core.aggregators import make_exchange
    out = {}
    for chunks in (None, 2):
        cfg = CompressionConfig(**A2A_CFG, stream_chunks=chunks)
        for name in ("dense", "compressed"):
            ex = make_exchange(name, cfg, group)
            steps = []
            for step in range(2):
                pay = _a2a_payloads(world, step)
                got = ex([[torch.from_numpy(pay[s])] for s in range(
                    group.first_worker, group.first_worker + group.local_workers)])
                steps.append(np.stack([g[0].numpy() for g in got]))
            out[name, chunks] = steps
    return out


def _digest(params):
    h = hashlib.sha256()
    for t in params.leaves():
        h.update(t.detach().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def _train_paths(world):
    """name -> TrainConfig of the runs at ``world`` ranks."""
    from repro_torch.configs import get_arch
    if world == 3:
        return {}
    base = dataclasses.replace(get_arch("granite-3-2b").train, workers=world,
                               accum_steps=1, dp_levels=LEVELS[world])
    comp = base.compression
    # the replicated update, as the JAX reference's losses it tracks
    lossless = dataclasses.replace(
        base, aggregator="compressed",
        compression=CompressionConfig(**LOSSLESS),
        optimizer=OptimizerConfig(**MOMENTUM), zero1=False)
    rs_zero1 = dataclasses.replace(base, aggregator="compressed_rs", zero1=True)
    # one-block buckets: the smoke model's 14 buckets stream in 14 chunks
    # (7 on the reduce-scatter grid), where 4 MiB buckets would make one
    streamed = dataclasses.replace(comp, overlap=True,
                                   bucket_bytes=4 * comp.block_elems)
    if world == 4:
        return {"dense": dataclasses.replace(base, aggregator="dense"),
                "lossless": lossless,
                "lossless_dense": dataclasses.replace(lossless,
                                                      aggregator="dense"),
                "rs_zero1": rs_zero1}
    return {
        "dense": dataclasses.replace(base, aggregator="dense"),
        "bitmap": dataclasses.replace(base, aggregator="compressed"),
        "bloom": dataclasses.replace(
            base, aggregator="compressed", compression=dataclasses.replace(
                comp, index="bloom", topk_ratio=0.01)),
        "innet_fxp32": dataclasses.replace(
            base, aggregator="compressed_innet", compression=dataclasses.replace(
                comp, wire_dtype="fxp32")),
        "lossless": lossless,
        "overlap": dataclasses.replace(
            base, aggregator="compressed", compression=streamed),
        "rs_zero1": rs_zero1,
        "rs_zero1_overlap": dataclasses.replace(rs_zero1, compression=streamed),
        "auto": dataclasses.replace(base, aggregator="auto"),
        "auto_mixed": dataclasses.replace(
            base, aggregator="auto", compression=dataclasses.replace(
                streamed, overlap=False)),
    }


EMULATED = ("dense", "bitmap", "bloom", "innet_fxp32", "overlap", "rs_zero1",
            "rs_zero1_overlap", "auto", "auto_mixed")
# the 14 one-block buckets of the smoke stream under every wire
TRAIN_PLANS = {"auto_mixed": WirePlan(14, (WireGroup(0, 2, "dense"),
                                           WireGroup(2, 3, "compressed_rs"),
                                           WireGroup(5, 4, "compressed_innet"),
                                           WireGroup(9, 5, "compressed")))}


def _smoke_api():
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api
    return model_api(get_arch("granite-3-2b").smoke)


def _train(tc, group, dev="cpu", wire_plan=None):
    """3 steps from the smoke model's seed-0 init: losses, the sha256 of
    the final parameters, and the error-feedback residuals' rows."""
    from repro_torch.train.loop import run_training
    res = run_training(_smoke_api(), tc, global_batch=B * tc.workers // 2,
                       seq_len=S, steps=STEPS, device=dev, log_every=0,
                       group=group, wire_plan=wire_plan)
    return {"losses": res.losses, "digest": _digest(res.state.params),
            "residual_rows": [int(t.shape[0]) for t in res.state.residual]}


def _rank(group, dev, world):
    """Every check of one rank: its results, as numpy and digests."""
    r = group.rank
    flat = group if len(group.levels) == 1 else ProcessGroupWorkers()
    out = {"levels": group.levels, "first_worker": group.first_worker,
           "local_workers": group.local_workers, "or": {}}
    for i, shape in enumerate(OR_SHAPES):
        x = torch.from_numpy(_words(world, shape, i)[r])
        res = {"ring": or_allreduce_ring(x, flat.dp_levels[0]).numpy(),
               "hier": or_allreduce(x, group.dp_levels).numpy(),
               "hier_ring": or_allreduce(x, group.dp_levels,
                                         ring_threshold=0).numpy(),
               "bor": group.bor([x]).numpy()}
        try:
            res["doubling"] = or_allreduce_doubling(x, flat.dp_levels[0]).numpy()
        except ValueError as e:
            res["doubling"] = str(e)
        assert torch.equal(x, torch.from_numpy(_words(world, shape, i)[r]))
        out["or"][shape] = res
    dy = torch.from_numpy(_dyadic(world, 1001, 7)[r])
    gauss = torch.from_numpy(np.random.default_rng(8).normal(
        size=(world, 1001)).astype(np.float32)[r])
    ints = torch.from_numpy(np.random.default_rng(9).integers(
        -2**31, 2**31 - 1, size=(world, 333), dtype=np.int32)[r])
    out["sum_dyadic"] = group.sum([dy]).numpy()
    out["sum_gauss"] = group.sum([gauss]).numpy()
    out["max"] = group.max([ints]).numpy()
    out["tree"] = {}
    for kind in ("flat", "tor_spine") if world == 4 else ("flat",):
        topo = make_topology(kind, group)
        for slots in (None, 3):
            add = torch.from_numpy(np.random.default_rng(10).integers(
                -2**26, 2**26, size=(world, 7, 12), dtype=np.int32)[r])
            words = torch.from_numpy(_words(world, (7, 4), 11)[r])
            got = (tree_all_reduce([add], topo, "add", window_slots=slots,
                                   group=group),
                   tree_all_reduce([words], topo, "or", window_slots=slots,
                                   group=group))
            assert all(len(g) == 1 for g in got)
            out["tree"][kind, slots] = (got[0][0].numpy(), got[1][0].numpy())
    words, floats = _rs_payloads(world, r)
    out["scatter"] = {"bor": group.bor_scatter([words])[0].numpy(),
                      "sum": group.sum_scatter([floats])[0].numpy(),
                      "or_hier": or_reduce_scatter(words, group.dp_levels).numpy(),
                      "or_ring": or_reduce_scatter_ring(words, flat.dp_levels[0])
                      .numpy()}
    out["gather"] = {str(t.dtype): group.gather([t]).numpy() if t.dtype !=
                     torch.bfloat16 else group.gather([t]).view(torch.int16).numpy()
                     for t in (words, floats, floats.to(torch.bfloat16))}
    chunks = torch.from_numpy(_dyadic(world, 3 * world * 5, 23)[r]).reshape(
        3, world * 5)
    local = torch.stack([group.sum_scatter([c])[0] for c in chunks])
    out["chunk_slices"] = gather_chunk_slices([local], group).numpy()
    grads = _agg_grads(world)[r]
    out["aggregate"] = {name: _aggregate(agg, world, group, [grads], fields)
                        for name, (agg, fields) in AGGREGATES.items()}
    if world in (2, 4):
        out["gather_skip"] = _skip_aggregate(world, group,
                                             [_skip_grads(world)[r]])
    out["train"] = {name: _train(tc, group, dev, TRAIN_PLANS.get(name))
                    for name, tc in _train_paths(world).items()}
    out["a2a"] = _exchanges(world, group)
    from repro_torch.core.aggregators import make_exchange
    pay = torch.from_numpy(_a2a_payloads(world, 0)[r]).requires_grad_()
    ct = torch.from_numpy(_dyadic(world, A2A_N, 24)[r])
    merged = make_exchange("compressed", CompressionConfig(**A2A_CFG),
                           group)([[pay]])[0][0]
    out["a2a_grad"] = torch.autograd.grad((merged * ct).sum(), pay)[0].numpy()
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api
    from repro_torch.train.step import build_train_step
    moe = get_arch("deepseek-moe-16b")
    try:
        build_train_step(model_api(moe.smoke), dataclasses.replace(
            moe.train, workers=world, dp_levels=LEVELS[world], ep_workers=2,
            ep_exchange="compressed"), group=group)
        out["ep_on_ranks"] = None
    except NotImplementedError as e:
        out["ep_on_ranks"] = str(e)
    return out


def _emulate():
    """The ``LocalWorkers`` W = 2 runs, on one thread as the ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: _train(_train_paths(2)[name], None,
                             wire_plan=TRAIN_PLANS.get(name))
                for name in EMULATED}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World size -> every rank's results, and ``"emulated"`` -> the
    emulation's. The three spawns and the emulation start together and
    run while the tests compute the JAX reference."""
    pool = concurrent.futures.ThreadPoolExecutor(len(LEVELS) + 1)
    futures = {w: pool.submit(spawn_ranks, _rank, w, (w,), device="cpu",
                              levels=LEVELS[w], timeout=300, threads=1,
                              init_dir=tmp_path_factory.mktemp(f"w{w}"))
               for w in LEVELS}
    futures["emulated"] = pool.submit(_emulate)
    yield lambda key: futures[key].result()
    pool.shutdown(wait=True)


# ----------------------------------------------------------------------
# training on ranks
# ----------------------------------------------------------------------

def test_w2_ranks_lossless_track_jax_reference(runs):
    from repro_torch.convert import params_to_numpy
    from test_torch_train import jax_w2_compressed_losses
    want = jax_w2_compressed_losses(
        params_to_numpy(_smoke_api().init(0, "cpu")), STEPS)
    for out in runs(2):
        np.testing.assert_allclose(out["train"]["lossless"]["losses"], want,
                                   rtol=1e-5)


@pytest.mark.parametrize("path", EMULATED)
def test_w2_ranks_train_bit_for_bit_with_emulation(runs, path):
    want = runs("emulated")[path]
    assert all(np.isfinite(want["losses"]))
    ef = _train_paths(2)[path].aggregator != "dense"   # top-k with EF
    for out in runs(2):
        got = out["train"][path]
        assert got["losses"] == want["losses"]
        assert got["digest"] == want["digest"]
        assert set(got["residual_rows"]) == {1 if ef else 0}   # a worker a rank
    assert set(want["residual_rows"]) == {2 if ef else 0}


def test_w4_levels_stay_replicated_and_lossless(runs):
    outs = runs(4)
    for path in ("dense", "lossless", "lossless_dense"):
        assert len({out["train"][path]["digest"] for out in outs}) == 1, \
            f"{path}: ranks drifted apart"
        assert all(out["train"][path]["losses"] == outs[0]["train"][path]["losses"]
                   for out in outs)
    comp = outs[0]["train"]["lossless"]["losses"]
    dense = outs[0]["train"]["lossless_dense"]["losses"]
    assert all(abs(a - b) < 1e-4 for a, b in zip(comp, dense)), (comp, dense)
    assert comp[-1] < comp[0]


# ----------------------------------------------------------------------
# without ranks
# ----------------------------------------------------------------------

def test_use_ring_matches_reference():
    from repro.core.collectives import _use_ring as j_use_ring
    for size in range(1, 17):
        for nbytes in (0, 1, 4, 65_532, 65_535, 65_536, 65_540, 1 << 20):
            for thr in (0, 65_536, 1 << 21):
                assert _use_ring(nbytes, size, thr) == j_use_ring(nbytes, size, thr)


@pytest.mark.parametrize("levels", [(4,), (2, 2), (3, 2), (2, 3, 2)])
def test_linear_rank_is_rank_major(levels):
    """Worker w of ``levels`` (innermost first) is the reference's
    ``linear_rank`` over the axes outermost first."""
    W = int(np.prod(levels))
    for w in range(W):
        idx = level_indices(w, levels)
        assert linear_rank(idx, levels) == w
        want = 0
        for i, s in zip(reversed(idx), reversed(levels)):   # outermost first
            want = want * s + i
        assert want == w
    with pytest.raises(ValueError):
        linear_rank((levels[0],) + (0,) * (len(levels) - 1), levels)


def test_local_workers_surface():
    g = LocalWorkers(6, (3, 2))
    assert (g.local_workers, g.first_worker) == (6, 0)


# ----------------------------------------------------------------------
# collectives on ranks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3, 4])
def test_group_surface(runs, world):
    for r, out in enumerate(runs(world)):
        assert out["levels"] == LEVELS[world]
        assert (out["first_worker"], out["local_workers"]) == (r, 1)


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("shape", OR_SHAPES, ids=str)
def test_or_allreduce_matches_local_workers_and_numpy(runs, world, shape):
    words = _words(world, shape, OR_SHAPES.index(shape))
    want = np.bitwise_or.reduce(words, axis=0)
    local = LocalWorkers(world, LEVELS[world]).bor(
        [torch.from_numpy(w) for w in words]).numpy()
    np.testing.assert_array_equal(local, want)
    assert (want < 0).any(), "bit 31 must be set somewhere"
    doubling_ok = (world & (world - 1)) == 0
    for out in runs(world):
        res = out["or"][shape]
        for name in ("ring", "hier", "hier_ring", "bor"):
            np.testing.assert_array_equal(res[name], want, err_msg=name)
        if doubling_ok:
            np.testing.assert_array_equal(res["doubling"], want)
        else:
            assert "power-of-2" in res["doubling"]


@pytest.mark.parametrize("world", [2, 3, 4])
def test_sum_and_max_match_local_workers(runs, world):
    group = LocalWorkers(world)
    dy = torch.from_numpy(_dyadic(world, 1001, 7))
    want_dy = group.sum(list(dy)).numpy()
    ints = torch.from_numpy(np.random.default_rng(9).integers(
        -2**31, 2**31 - 1, size=(world, 333), dtype=np.int32))
    want_max = group.max(list(ints)).numpy()
    gauss = [out["sum_gauss"] for out in runs(world)]
    for out in runs(world):
        assert out["sum_dyadic"].tobytes() == want_dy.tobytes()
        np.testing.assert_array_equal(out["max"], want_max)
        assert out["sum_gauss"].tobytes() == gauss[0].tobytes(), \
            "every rank must receive the same bits"
    if world == 2:
        g = torch.from_numpy(np.random.default_rng(8).normal(
            size=(2, 1001)).astype(np.float32))
        assert gauss[0].tobytes() == group.sum(list(g)).numpy().tobytes()


@pytest.mark.parametrize("world", [2, 3, 4])
def test_compressed_and_innet_f32_aggregate_equal_emulation(runs, world):
    """``compressed`` and ``compressed_innet`` on the f32 wire (flat, or
    tor_spine on levels (2, 2)) over ranks give each rank the emulation's
    mean and its own worker's error-feedback residual row, bit for bit."""
    grads = _agg_grads(world)
    want, want_res = _aggregate("compressed", world,
                                LocalWorkers(world, LEVELS[world]), grads)
    for r, out in enumerate(runs(world)):
        for name in ("compressed", "compressed_innet"):
            got, res = out["aggregate"][name]
            for a, b in zip(got, want):
                assert a.tobytes() == b.tobytes(), name
            for a, b in zip(res, want_res):
                np.testing.assert_array_equal(a[0], b[r])


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("slots", [None, 3])
def test_p2p_tree_equals_flat_sum_and_or(runs, world, slots):
    add = np.random.default_rng(10).integers(-2**26, 2**26, size=(world, 7, 12),
                                             dtype=np.int32)
    words = _words(world, (7, 4), 11)
    want = (add.sum(axis=0, dtype=np.int32), np.bitwise_or.reduce(words, axis=0))
    kinds = ("flat", "tor_spine") if world == 4 else ("flat",)
    for out in runs(world):
        for kind in kinds:
            got = out["tree"][kind, slots]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


# ----------------------------------------------------------------------
# the reduce-scatter wire and ZeRO-1 on ranks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3, 4])
def test_reduce_scatters_and_gather_match_numpy(runs, world):
    words, floats = zip(*(_rs_payloads(world, r) for r in range(world)))
    or_all = np.bitwise_or.reduce(np.stack([w.numpy() for w in words]), axis=0)
    sum_all = LocalWorkers(world).sum(list(floats)).numpy()
    for r, out in enumerate(runs(world)):
        rows = slice(r * 5, (r + 1) * 5)
        for name in ("bor", "or_hier", "or_ring"):
            np.testing.assert_array_equal(out["scatter"][name], or_all[rows],
                                          err_msg=name)
        frows = slice(r * 7, (r + 1) * 7)
        assert out["scatter"]["sum"].tobytes() == sum_all[frows].tobytes()
        got = out["gather"]
        np.testing.assert_array_equal(got["torch.int32"],
                                      np.concatenate([w.numpy() for w in words]))
        np.testing.assert_array_equal(got["torch.float32"],
                                      np.concatenate([f.numpy() for f in floats]))
        np.testing.assert_array_equal(
            got["torch.bfloat16"],
            np.concatenate([f.to(torch.bfloat16).view(torch.int16).numpy()
                            for f in floats]))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_gather_chunk_slices_inverts_a_per_chunk_scatter(runs, world):
    parts = _dyadic(world, 3 * world * 5, 23).reshape(world, 3, world * 5)
    want = LocalWorkers(world).sum([torch.from_numpy(p) for p in parts]).numpy()
    for out in runs(world):
        assert out["chunk_slices"].tobytes() == want.tobytes()


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("name", ["compressed_overlap", "compressed_rs",
                                  "compressed_rs_overlap"])
def test_rs_and_streamed_aggregates_equal_emulation(runs, world, name):
    agg, fields = AGGREGATES[name]
    grads = _agg_grads(world)
    want, want_res = _aggregate(agg, world, LocalWorkers(world, LEVELS[world]),
                                grads, fields)
    plain, _ = _aggregate("compressed", world,
                          LocalWorkers(world, LEVELS[world]), grads)
    for a, b in zip(want, plain):
        assert a.tobytes() == b.tobytes()
    for r, out in enumerate(runs(world)):
        got, res = out["aggregate"][name]
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes(), name
        for a, b in zip(res, want_res):
            np.testing.assert_array_equal(a[0], b[r])


@pytest.mark.parametrize("world", [2, 4])
def test_gather_skip_on_ranks_equals_emulation(runs, world):
    want, want_res = _skip_aggregate(world, LocalWorkers(world, LEVELS[world]),
                                     _skip_grads(world))
    assert len(want) == world
    for r, out in enumerate(runs(world)):
        got, res = out["gather_skip"]
        assert len(got) == 1
        for a, b in zip(got[0], want[r]):
            assert a.tobytes() == b.tobytes()
        for a, b in zip(res, want_res):
            np.testing.assert_array_equal(a[0], b[r])


def test_streamed_training_equals_unstreamed(runs):
    """Chunking is bit-invisible through training too: the streamed runs
    (one-block buckets) equal the unstreamed ones (4 MiB buckets)."""
    emu = runs("emulated")
    for streamed, plain in (("overlap", "bitmap"),
                            ("rs_zero1_overlap", "rs_zero1")):
        assert emu[streamed]["digest"] == emu[plain]["digest"]
        assert emu[streamed]["losses"] == emu[plain]["losses"]


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("name", ["auto_mixed", "auto_mixed_fxp32_overlap"])
def test_mixed_plan_aggregate_equals_emulation(runs, world, name):
    """``AGG_PLAN`` over ranks gives each rank the emulation's mean and
    its own worker's residual row, and the emulation equals the fixed
    ``compressed`` strategy (dyadic values: every wire is exact)."""
    agg, fields = AGGREGATES[name]
    grads = _agg_grads(world)
    local = LocalWorkers(world, LEVELS[world])
    want, want_res = _aggregate(agg, world, local, grads, fields)
    plain, plain_res = _aggregate("compressed", world, local, grads,
                                  dict(lanes=32, bucket_bytes=4 * 480))
    for a, b in zip(want, plain):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(want_res, plain_res):
        assert a.tobytes() == b.tobytes()
    for r, out in enumerate(runs(world)):
        got, res = out["aggregate"][name]
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes(), name
        for a, b in zip(res, want_res):
            np.testing.assert_array_equal(a[0], b[r])


def test_auto_training_equals_compressed(runs):
    """``auto``'s analytic plan at the smoke stream (one 4 MiB bucket) is
    ``compressed`` on the plan path: bit for bit the fixed strategy."""
    emu = runs("emulated")
    assert emu["auto"]["digest"] == emu["bitmap"]["digest"]
    assert emu["auto"]["losses"] == emu["bitmap"]["losses"]
    assert emu["auto_mixed"]["digest"] != emu["auto"]["digest"]


def test_w4_zero1_stays_replicated(runs):
    outs = runs(4)
    assert len({out["train"]["rs_zero1"]["digest"] for out in outs}) == 1
    assert all(np.isfinite(outs[0]["train"]["rs_zero1"]["losses"]))


# ----------------------------------------------------------------------
# the all-to-all exchange on ranks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3, 4])
def test_exchanges_on_ranks_equal_numpy_and_emulation(runs, world):
    local = _exchanges(world, LocalWorkers(world, LEVELS[world]))
    outs = runs(world)
    for key, steps in local.items():
        for step, emulated in enumerate(steps):
            want = _a2a_payloads(world, step).sum(axis=0)
            np.testing.assert_array_equal(emulated, want)
            for r, o in enumerate(outs):
                np.testing.assert_array_equal(o["a2a"][key][step][0], want[r],
                                              err_msg=str((key, step, r)))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_exchange_backward_and_ep_refusal_on_ranks(runs, world):
    ct = _dyadic(world, A2A_N, 24)
    for o in runs(world):
        np.testing.assert_array_equal(o["a2a_grad"], ct)
        assert o["ep_on_ranks"] is not None
        assert "dp x ep process layout" in o["ep_on_ranks"]
