"""The port's tracer (``repro_torch.obs``) in the train step, on the CPU:
the smoke granite model in f32, W 2 emulated workers, the compressed
aggregator at exact top-k 1% with error feedback, AdamW with ZeRO-1.

- Off (the default) it records nothing and creates no CUDA event and no
  ``record_function``, with a profiler running or not.
- On or off, three steps give the same losses, parameters, moments and
  residuals bit for bit.
- On, every span fires its expected number of times a step, no span's
  self time is negative and no child outlasts its parent; the
  collective counters count one call a sum, OR and ZeRO-1 gather, and
  the bytes of one worker's payloads, as a counting group sees them;
  ``reset`` clears spans and counters; under a profiler each span is a
  ``repro_torch:`` range.
- A rank (``ProcessGroupWorkers``, one gloo rank) counts its calls as
  the emulation does.
"""

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.core.collectives import LocalWorkers
from repro_torch.core.config import CompressionConfig
from repro_torch.data.pipeline import batch_fn, host_tensors
from repro_torch.models.registry import model_api
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import build_train_step, init_train_state, zero1_dims

W, B, S, STEPS = 2, 4, 32, 3
CFG = get_arch("granite-3-2b").smoke
TC = TrainConfig(aggregator="compressed",
                 compression=CompressionConfig(topk_ratio=0.01, topk_exact=True,
                                               error_feedback=True),
                 optimizer=OptimizerConfig(warmup_steps=1), remat="block",
                 accum_steps=1, workers=W, zero1=True, seed=0)

# calls a step: one worker's spans twice, the aggregate's and the
# optimizer's once, one gather a ZeRO-1-sliced leaf
PER_WORKER = ("step/forward", "step/backward", "aggregate/sparsify",
              "aggregate/encode")
ONCE = ("step/aggregate", "aggregate/wire", "aggregate/peel", "aggregate/unpack",
        "step/optimizer", "optimizer/norm", "optimizer/clip", "optimizer/update")
CHILDREN = {"step/aggregate": ("aggregate/sparsify", "aggregate/encode",
                               "aggregate/wire", "aggregate/peel",
                               "aggregate/unpack"),
            "step/optimizer": ("optimizer/norm", "optimizer/clip",
                               "optimizer/update"),
            "optimizer/update": ("optimizer/gather",)}


class CountingWorkers(LocalWorkers):
    """A group that counts one worker's payload bytes of every reduction,
    as the benchmark's wrapped group counts ``wire``."""

    def __init__(self, workers):
        super().__init__(workers)
        object.__setattr__(self, "wire", [0])

    def sum(self, parts):
        self.wire[0] += parts[0].numel() * parts[0].element_size()
        return super().sum(parts)

    def bor(self, parts):
        self.wire[0] += parts[0].numel() * parts[0].element_size()
        return super().bor(parts)


@pytest.fixture(autouse=True)
def tracer_off():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _run(steps=STEPS, group=None, each=None):
    """``steps`` steps from the seed's state; ``each(k)`` after step k.
    Returns (losses, state)."""
    api = model_api(CFG)
    group = group or LocalWorkers(W)
    state = init_train_state(api, TC, "cpu", group=group)
    step_fn = build_train_step(api, TC, group=group)
    make = batch_fn(CFG, B, S, seed=5)
    losses = []
    for k in range(steps):
        state, metrics = step_fn(state, host_tensors(make(k)))
        losses.append(metrics["loss"])
        if each is not None:
            each(k)
    return losses, state


def _sliced():
    leaves = model_api(CFG).init(0, "cpu").leaves()
    return sum(d is not None for d in zero1_dims(leaves, TC))


def _flat_state(state):
    return ([p.detach() for p in state.params.leaves()]
            + [m for k in sorted(state.opt) for m in state.opt[k]]
            + list(state.residual))


def test_off_records_nothing_and_creates_no_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("created while tracing is off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _run(steps=1)
    _run(steps=1)
    assert obs.snapshot() == {"spans": {}, "counters": {}}
    assert obs.span("step/forward") is obs.span("aggregate/peel")


def test_on_and_off_give_the_same_bits():
    off_losses, off = _run()
    obs.enable("cpu")
    on_losses, on = _run()
    assert obs.snapshot()["spans"]["step/forward"]["calls"] == W * STEPS
    assert [float(x) for x in on_losses] == [float(x) for x in off_losses]
    for a, b in zip(_flat_state(on), _flat_state(off)):
        assert torch.equal(a, b)


def test_spans_and_counters_a_step():
    obs.enable("cpu")
    snaps, group = [], CountingWorkers(W)

    def each(k):
        snaps.append((obs.snapshot(), group.wire[0],
                      [r for r in obs.TRACER.records]))
        obs.reset()
        group.wire[0] = 0
    _run(group=group, each=each)
    sliced = _sliced()
    assert sliced > 0
    for k, (snap, wire, records) in enumerate(snaps):
        spans, counters = snap["spans"], snap["counters"]
        for name in PER_WORKER:
            assert spans[name]["calls"] == W, name
        for name in ONCE:
            assert spans[name]["calls"] == 1, name
        assert spans["optimizer/gather"]["calls"] == sliced
        assert ("setup/init_state" in spans) == (k == 0)
        for s in spans.values():
            assert s["self_device_ms"] >= 0
            assert s["device_ms"] == s["host_ms"]      # the CPU's clock
        for r in records:
            if r.parent is not None:
                assert r.t0 >= r.parent.t0 and r.t1 <= r.parent.t1, r.name
        for parent, kids in CHILDREN.items():
            assert sum(spans[k]["device_ms"] for k in kids) <= spans[parent]["device_ms"]
        # the sketch SUM, the word OR, the loss mean, one gather a sliced leaf
        calls = {k.split("/")[-1]: n for k, n in counters.items()
                 if k.startswith("collective/calls/")}
        assert calls == {"sum": 2, "bor": 1, "gather": sliced}
        assert sum(calls.values()) == 3 + sliced
        assert counters["collective/bytes/sum"] + counters["collective/bytes/bor"] == wire
        assert not [k for k in counters if k.startswith("kernels/")]   # plain codec


def test_setup_span_and_reset():
    obs.enable("cpu")
    _run(steps=1)
    snap = obs.snapshot()
    assert snap["spans"]["setup/init_state"]["calls"] == 1
    assert snap["counters"]["collective/calls/sum"] == 2
    obs.reset()
    assert obs.snapshot() == {"spans": {}, "counters": {}}


def test_spans_are_profiler_ranges_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    obs.enable("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(steps=1)
    names = {e.name for e in prof.events() if e.name.startswith(obs.PREFIX)}
    assert {obs.PREFIX + n for n in PER_WORKER + ONCE} <= names


def test_launches_are_counted_while_on(monkeypatch):
    from repro_torch.kernels.cuda_common import LAUNCHES
    monkeypatch.setitem(LAUNCHES, "sketch_peel", LAUNCHES["sketch_peel"])
    LAUNCHES["sketch_peel"] += 5            # before: not counted
    obs.enable("cpu")
    LAUNCHES["sketch_peel"] += 2
    assert obs.snapshot()["counters"] == {"kernels/launches/sketch_peel": 2}
    obs.disable()
    LAUNCHES["sketch_peel"] += 3            # off: not counted
    assert obs.snapshot()["counters"] == {"kernels/launches/sketch_peel": 2}


def _rank_counts(group, device):
    """One gloo rank's counters over each of its collectives."""
    obs.enable("cpu")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    words = torch.tensor([3, -1], dtype=torch.int32)
    group.sum([x])
    group.bor([words])
    group.max([x])
    group.gather([x])
    group.sum_scatter([x])
    group.bor_scatter([words])
    group.lane_sum([x[None]], "add")
    return obs.snapshot()["counters"]


def test_a_rank_counts_as_the_emulation():
    from repro_torch.launch.ranks import spawn_ranks
    (counts,) = spawn_ranks(_rank_counts, 1, (), device="cpu", timeout=120,
                            threads=1)
    ops = ("sum", "bor", "max", "gather", "sum_scatter", "bor_scatter", "lane_sum")
    assert {k for k in counts if k.startswith("collective/calls/")} == \
        {f"collective/calls/{op}" for op in ops}
    assert all(counts[f"collective/calls/{op}"] == 1 for op in ops)
    assert counts["collective/bytes/sum"] == 24
    assert counts["collective/bytes/bor"] == counts["collective/bytes/bor_scatter"] == 8
    assert counts["collective/bytes/lane_sum"] == 24

    obs.enable("cpu")
    local = LocalWorkers(1)
    _rank_counts(local, "cpu")
    assert obs.snapshot()["counters"] == counts
