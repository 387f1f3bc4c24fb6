"""PyTorch port vs the JAX reference: the stream scheduler and the
per-bucket views (``repro_torch.core.streams``, ``core.bucketing``).

Everything here is integer geometry or a reordering, so the port must
equal the reference exactly, errors included (the same message, naming
the same constraint):

- ``make_stream_plan`` field for field and in every derived property,
  on every grid: the all-reduce grid with ``overlap``, forced,
  non-divisible, clamped and empty-chunk counts; the ``scatter`` grid at
  W = 2, 3, 4 (and 8); the switch-window grid;
- ``stream_schedule`` equal to the direct loop, on one chunk and on
  many, with the reduces inline and on a communication thread;
- ``zero_slice_dim`` (ties included) and ``zero1_gather_skip`` on
  aligned and misaligned trees, and on the full-width granite-3-2b
  shapes at 4 layers and W = 2, where no grid aligns: its stacked layer
  leaves slice on dims 1 and 2, which are not flat-contiguous;
- ``bucket_segments``, ``group_view`` and ``residual_slices``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.core import CompressionConfig as JaxConfig
from repro.core.bucketing import make_bucket_plan as j_make_bucket_plan
from repro.core.streams import StreamPlan as JStreamPlan
from repro.core.streams import make_stream_plan as j_make_stream_plan
from repro.core.streams import stream_schedule as j_stream_schedule
from repro.core.streams import zero1_gather_skip as j_zero1_gather_skip
from repro.core.streams import zero_slice_dim as j_zero_slice_dim
from repro_torch.core.bucketing import make_bucket_plan
from repro_torch.core.config import CompressionConfig
from repro_torch.core.streams import (CommThread, InlineIssue, StreamPlan,
                                      make_stream_plan, stream_schedule,
                                      zero1_gather_skip, zero_slice_dim)

# block_elems = 768; one bucket = one block
JCFG = JaxConfig(ratio=1.0, lanes=128, rows=6, bucket_bytes=768 * 4)
E = 768


def _plans(shapes, jc=JCFG):
    """The port's and the reference's plan over zero leaves of
    ``shapes`` (leaf i keyed ``l{i:02d}``, so both flatten in order)."""
    leaves = [np.zeros(sh, np.float32) for sh in shapes]
    jplan = j_make_bucket_plan({f"l{i:02d}": x for i, x in enumerate(leaves)},
                               jc)
    plan = make_bucket_plan([torch.from_numpy(x) for x in leaves],
                            CompressionConfig(**dataclasses.asdict(jc)))
    return plan, jplan


def _same_plan(got: StreamPlan, want: JStreamPlan):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("padded_buckets", "pad_buckets", "chunk_elems",
                 "rank_chunk_buckets", "streamed"):
        assert getattr(got, prop) == getattr(want, prop), prop
    for i in range(got.n_chunks):
        assert got.chunk_start_block(i) == want.chunk_start_block(i)
        for r in range(got.workers):
            assert got.rank_slice_start_block(i, r) == \
                want.rank_slice_start_block(i, r)
    for r in range(got.workers):
        assert got.rank_intervals(r) == want.rank_intervals(r)


# (n_buckets, config fields, make_stream_plan keywords)
GRIDS = [
    (5, {}, {}),                                           # one fused chunk
    (5, dict(overlap=True), {}),                           # a bucket a chunk
    (5, dict(stream_chunks=3), {}),                        # non-divisible
    (5, dict(stream_chunks=99), {}),                       # clamped
    (5, dict(stream_chunks=4), {}),                        # empty tail: shrinks
    (6, dict(stream_chunks=4), dict(base_block=7)),
    (5, dict(overlap=True), dict(workers=2, scatter=True)),
    (7, dict(overlap=True), dict(workers=3, scatter=True)),
    (5, dict(overlap=True), dict(workers=4, scatter=True)),
    (8, dict(stream_chunks=2), dict(workers=4, scatter=True)),
    (9, dict(stream_chunks=2), dict(workers=8, scatter=True)),
    (415, dict(overlap=True), dict(workers=2, scatter=True)),
    (415, dict(stream_chunks=13), dict(workers=2, scatter=True)),
    (5, {}, dict(workers=2, scatter=True)),                # one-shot RS grid
    (5, dict(overlap=True), dict(workers=3)),              # workers, no scatter
    (5, dict(overlap=True, switch_slots=2), dict(window_buckets=2)),
    (5, dict(stream_chunks=2), dict(window_buckets=2)),
    (7, dict(stream_chunks=3), dict(window_buckets=2)),    # empty tail: shrinks
    (5, dict(overlap=True), dict(window_buckets=8)),
    (415, dict(overlap=True), dict(window_buckets=8)),
    (6, dict(stream_chunks=4), dict(window_buckets=1)),
]


@pytest.mark.parametrize("nb,fields,kw", GRIDS, ids=str)
def test_stream_plan_matches_reference(nb, fields, kw):
    jc = dataclasses.replace(JCFG, **fields)
    plan, jplan = _plans([(E * nb,)], jc)
    got = make_stream_plan(plan, CompressionConfig(**dataclasses.asdict(jc)), **kw)
    _same_plan(got, j_make_stream_plan(jplan, jc, **kw))


# (n_buckets, config fields, make_stream_plan keywords) that raise
BAD_GRIDS = [
    (5, dict(stream_chunks=3), dict(workers=4, scatter=True)),
    (6, dict(stream_chunks=4), dict(workers=2, scatter=True)),
    (5, dict(stream_chunks=4), dict(window_buckets=8)),
    (5, dict(stream_chunks=7), dict(window_buckets=2)),
    (2, {}, dict(workers=0)),
    (2, {}, dict(window_buckets=0)),
]


@pytest.mark.parametrize("nb,fields,kw", BAD_GRIDS, ids=str)
def test_stream_plan_errors_match_reference(nb, fields, kw):
    jc = dataclasses.replace(JCFG, **fields)
    plan, jplan = _plans([(E * nb,)], jc)
    with pytest.raises(ValueError) as want:
        j_make_stream_plan(jplan, jc, **kw)
    with pytest.raises(ValueError) as got:
        make_stream_plan(plan, CompressionConfig(**dataclasses.asdict(jc)), **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fields", [
    dict(workers=3, n_chunks=1, chunk_buckets=4),      # not divisible by W
    dict(workers=1, n_chunks=1, chunk_buckets=2),      # does not cover
])
def test_stream_plan_validation_matches_reference(fields):
    base = dict(n_buckets=4, bucket_elems=E, blocks_per_bucket=1,
                words_per_bucket=24)
    with pytest.raises(ValueError) as want:
        JStreamPlan(**base, **fields)
    with pytest.raises(ValueError) as got:
        StreamPlan(**base, **fields)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("chunks", [1, 3, 5])
def test_chunk_view_matches_reference(chunks):
    jc = dataclasses.replace(JCFG, stream_chunks=chunks)
    plan, jplan = _plans([(E * 5,)], jc)
    x = np.random.default_rng(chunks).normal(size=(5, E)).astype(np.float32)
    got = make_stream_plan(plan, CompressionConfig(**dataclasses.asdict(jc)))
    want = j_make_stream_plan(jplan, jc).chunk_view(jnp.asarray(x))
    np.testing.assert_array_equal(got.chunk_view(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="buckets shape"):
        got.chunk_view(torch.zeros(4, E))


# ----------------------------------------------------------------------
# the pipeline driver
# ----------------------------------------------------------------------

class _ThreadGroup:
    """A group whose streamed reduces run on the communication thread."""

    issuer = CommThread


@pytest.mark.parametrize("issuer", [None, InlineIssue, CommThread])
@pytest.mark.parametrize("n", [1, 6])
def test_stream_schedule_matches_direct_loop_and_reference(issuer, n):
    xs = np.random.default_rng(n).standard_normal((n, 32)).astype(np.float32)
    order = []

    def encode(i, x):
        return x * 2.0 + float(i), x - 1.0

    def reduce(payload):
        a, b = payload
        order.append(float(a[0]))
        return a + b, a * b

    group = None if issuer is None else types.SimpleNamespace(issuer=issuer)
    got = stream_schedule(torch.from_numpy(xs), encode, reduce, group=group)
    want = [reduce(encode(i, torch.from_numpy(xs[i]))) for i in range(n)]
    for j in range(2):
        assert got[j].shape == (n, 32)
        np.testing.assert_array_equal(
            got[j].numpy(), torch.stack([w[j] for w in want]).numpy())
    # the reduces ran in chunk order
    assert order[:n] == [float(xs[i][0] * 2.0 + i) for i in range(n)]
    jgot = j_stream_schedule(
        jnp.asarray(xs), lambda i, x: (x * 2.0 + i.astype(jnp.float32), x - 1.0),
        lambda p: (p[0] + p[1], p[0] * p[1]))
    for j in range(2):
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(jgot[j]))


def test_stream_schedule_raises_a_reduce_error_and_stops():
    def reduce(payload):
        if float(payload) == 2.0:
            raise RuntimeError("chunk 2 failed")
        return (payload,)

    for group in (None, _ThreadGroup()):
        with pytest.raises(RuntimeError, match="chunk 2"):
            stream_schedule(torch.arange(5.0), lambda i, x: x, reduce,
                            group=group)
    with pytest.raises(ValueError, match="at least one"):
        stream_schedule([], lambda i, x: x, lambda p: p)


def test_comm_thread_keeps_chunk_order_under_thread_switching():
    """300 chunks through the communication thread with the interpreter
    switching threads every microsecond: the reduces run in chunk order
    (what keeps every rank's collectives in one order), one at a time,
    and the results are the direct loop's."""
    import sys
    import threading
    import time

    seen, busy = [], []
    lock = threading.Lock()

    def encode(i, x):
        return x + float(i), torch.full((4,), float(i))

    def reduce(payload):
        with lock:
            busy.append(1)
            assert len(busy) == 1, "two reduces at once"
        seen.append(int(payload[1][0]))
        out = (payload[0] * 2.0, payload[1] + 1.0)
        with lock:
            busy.pop()
        return out

    xs = torch.arange(300 * 8, dtype=torch.float32).reshape(300, 8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        got = stream_schedule(xs, encode, reduce, group=_ThreadGroup())
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert seen == list(range(300))
    want = [reduce(encode(i, xs[i])) for i in range(300)]
    for j in range(2):
        assert torch.equal(got[j], torch.stack([w[j] for w in want]))


@pytest.mark.cuda
def test_comm_thread_on_the_card_equals_direct_loop():
    """On CUDA payloads the thread waits on each producer's event on a side
    stream, runs the reduce there and hands back tensors the main stream
    may use and free: the result equals the direct loop, and a later
    allocation on the main stream does not disturb it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side-stream path runs only on the card")
    dev = torch.device("cuda", 0)
    xs = torch.randn((12, 1 << 20), generator=torch.Generator().manual_seed(3)).to(dev)

    def encode(i, x):
        y = x
        for _ in range(20):          # keep the card busy past the issue
            y = torch.sin(y) + float(i)
        return y, x

    def reduce(payload):
        a, b = payload
        return a * 2.0 + b, (a - b).abs().sum(dim=0, keepdim=True)

    got = stream_schedule(xs, encode, reduce, group=_ThreadGroup())
    noise = [torch.full((1 << 20,), 7.0, device=dev) for _ in range(8)]
    want = [reduce(encode(i, xs[i])) for i in range(12)]
    for j in range(2):
        assert torch.equal(got[j], torch.stack([w[j] for w in want]))
    del noise


# ----------------------------------------------------------------------
# ZeRO-1 alignment
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
def test_zero_slice_dim_matches_reference(dp):
    rng = np.random.default_rng(dp)
    shapes = [(8,), (2, 8), (8, 8), (3, 5), (4, 4, 2), (1, 4096), (6, 6, 6),
              (16, 2048, 8192), ()]
    shapes += [tuple(int(s) for s in rng.integers(1, 13, size=rng.integers(1, 4)))
               for _ in range(40)]
    for sh in shapes:
        assert zero_slice_dim(sh, (), dp) == j_zero_slice_dim(sh, P(), dp), sh
    # ties take the larger index
    assert zero_slice_dim((8, 8), (), 4) == 1
    # a dim taken by the spec is skipped, as in the reference
    assert zero_slice_dim((8, 8), (None, "model"), 4) == \
        j_zero_slice_dim((8, 8), P(None, "model"), 4) == 0


SKIP_CASES = [
    ([(4 * E,), (4 * E,)], (0, 0), 2, 4, True),
    ([(1, 4 * E), (4 * E,)], (1, 0), 2, 4, True),
    ([(4 * E,), (4 * E,)], (0, 0), 2, 2, True),
    ([(4 * E,), (4 * E,)], (0, 0), 1, 2, False),
    ([(4 * E,), (4 * E,)], (0, 0), 1, 4, False),
    ([(4 * E,), (4 * E,)], (0, None), 2, 4, False),
    ([(2, 2 * E), (4 * E,)], (1, 0), 2, 4, False),
    ([(4 * E + 4,), (4 * E - 4,)], (0, 0), 2, 4, False),
    ([(4 * E,)], (0,), 1, 1, False),
    ([(4 * E,), (4 * E,)], None, 2, 4, False),
    ([(4 * E,), (4 * E,)], (0,), 2, 4, False),
]


@pytest.mark.parametrize("shapes,dims,n_chunks,workers,want", SKIP_CASES, ids=str)
def test_zero1_gather_skip_matches_reference(shapes, dims, n_chunks, workers, want):
    jc = dataclasses.replace(JCFG, stream_chunks=n_chunks)
    plan, jplan = _plans(shapes, jc)
    splan = make_stream_plan(plan, CompressionConfig(**dataclasses.asdict(jc)),
                             workers=workers, scatter=True)
    jsplan = j_make_stream_plan(jplan, jc, workers=workers, scatter=True)
    assert zero1_gather_skip(splan, plan, dims) == \
        j_zero1_gather_skip(jsplan, jplan, dims) == want


def _granite_shapes(layers=4):
    from repro.configs.granite_3_2b import ARCH
    from repro.models.transformer import init_lm
    cfg = dataclasses.replace(ARCH.model, n_layers=layers)
    tree = jax.eval_shape(lambda: init_lm(jax.random.PRNGKey(0), cfg))
    return [tuple(x.shape) for x in jax.tree.leaves(tree)]


def test_full_width_granite_never_skips_the_gather():
    """granite-3-2b at full width, 4 layers, W = 2, the chip's geometry:
    ZeRO-1 slices the stacked layer leaves on dims 1 and 2, which are
    not flat-contiguous, so no chunk grid aligns (pure Python)."""
    shapes = _granite_shapes()
    assert len(shapes) == 12
    assert sum(int(np.prod(s)) for s in shapes) == 445_138_944
    dims = [zero_slice_dim(s, (), 2) for s in shapes]
    assert dims == [j_zero_slice_dim(s, P(), 2) for s in shapes] == \
        [0, 0, 1, 2, 2, 1, 1, 2, 2, 1, 1, 1]
    cfg = CompressionConfig(ratio=0.1, topk_ratio=0.04)
    leaves = [types.SimpleNamespace(shape=s, dtype=torch.bfloat16)
              for s in shapes]
    plan = make_bucket_plan(leaves, cfg)
    assert (plan.n_buckets, plan.bucket_elems) == (415, 1_075_200)
    grids = [dataclasses.replace(cfg, overlap=True)]
    grids += [dataclasses.replace(cfg, stream_chunks=k)
              for k in range(1, 209) if 208 % k == 0]
    for c in grids:
        splan = make_stream_plan(plan, c, workers=2, scatter=True)
        assert not zero1_gather_skip(splan, plan, dims), c.stream_chunks
    over = make_stream_plan(plan, grids[0], workers=2, scatter=True)
    assert (over.n_chunks, over.chunk_buckets) == (208, 2)


# ----------------------------------------------------------------------
# per-bucket views
# ----------------------------------------------------------------------

VIEW_SHAPES = [(3 * E + 101,), (40, 64), (900,), (9,)]


def test_bucket_segments_match_reference():
    jc = dataclasses.replace(JCFG, bucket_bytes=2 * E * 4)
    plan, jplan = _plans(VIEW_SHAPES, jc)
    assert (plan.blocks_per_bucket(CompressionConfig(**dataclasses.asdict(jc))),
            plan.words_per_bucket) == (jplan.blocks_per_bucket(jc),
                                       jplan.words_per_bucket)
    got = [[dataclasses.astuple(s) for s in b] for b in plan.bucket_segments]
    want = [[dataclasses.astuple(s) for s in b] for b in jplan.bucket_segments]
    assert got == want
    assert sum(s.length for b in plan.bucket_segments for s in b) == plan.total


@pytest.mark.parametrize("start,count", [(0, 1), (1, 2), (2, 2), (0, 4), (3, 1)])
def test_group_view_matches_reference(start, count):
    jc = dataclasses.replace(JCFG, bucket_bytes=2 * E * 4)
    plan, jplan = _plans(VIEW_SHAPES, jc)
    got, want = plan.group_view(start, count), jplan.group_view(start, count)
    assert (got.shapes, got.sizes, got.offsets, got.total, got.bucket_elems,
            got.n_buckets) == (want.shapes, want.sizes, want.offsets,
                               want.total, want.bucket_elems, want.n_buckets)
    assert got.dtypes == (torch.float32,)


@pytest.mark.parametrize("start,count", [(3, 2), (0, 0), (-1, 2), (4, 1)])
def test_group_view_errors_match_reference(start, count):
    jc = dataclasses.replace(JCFG, bucket_bytes=2 * E * 4)
    plan, jplan = _plans(VIEW_SHAPES, jc)
    with pytest.raises(ValueError) as want:
        jplan.group_view(start, count)
    with pytest.raises(ValueError) as got:
        plan.group_view(start, count)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("worker", [0, 2])
def test_residual_slices_match_reference(worker):
    jc = dataclasses.replace(JCFG, bucket_bytes=2 * E * 4)
    plan, jplan = _plans(VIEW_SHAPES, jc)
    rng = np.random.default_rng(worker)
    rows = [rng.normal(size=(3,) + sh).astype(np.float32) for sh in VIEW_SHAPES]
    got = plan.residual_slices([torch.from_numpy(r) for r in rows], worker)
    want = jplan.residual_slices(
        {f"l{i:02d}": jnp.asarray(r[worker]) for i, r in enumerate(rows)})
    assert len(got) == len(want) == plan.n_buckets
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
