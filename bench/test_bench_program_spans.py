"""The benchmark's side of the program's tracer (``program_spans``): on
synthetic profiler events, the program's ``repro_torch:`` ranges, which
the profiler mirrors on the device, leave the busy time, the window and
the idle gaps as they read without them, and ``idle_by_span`` puts each
gap down to the innermost program range that covers most of it; each
reader of the tracer reads None without its snapshot or span, and the
span a step of the tracer's own stretch with it; and on the CPU at a
small size a traced run takes the tracer's snapshot over a stretch of
its own, leaves it off in the window, and its collective bytes a step
equal the harness's own ``wire`` count."""

import pathlib
import sys
import types

import pytest
import torch
from torch.autograd import DeviceType

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import devtrace  # noqa: E402
import harness  # noqa: E402
import program_spans as ps  # noqa: E402
from test_bench_reference import small  # noqa: E402

READERS = {"backward_ms": "step/backward", "aggregate_ms": "step/aggregate",
           "sparsify_ms": "aggregate/sparsify", "optimizer_ms": "step/optimizer"}


def ev(name, a, b, kind=DeviceType.CUDA):
    return types.SimpleNamespace(name=name, device_type=kind,
                                 time_range=types.SimpleNamespace(start=a, end=b))


def cpu(name, a, b):
    return ev(name, a, b, DeviceType.CPU)


# kernels at [0, 10], [30, 40], [70, 100] us; the host runs the forward
# over [0, 45] and the aggregate over [45, 100], with the sparsify inside
# it over [60, 80]; the gap [10, 30] lies in the forward, [40, 70]
# mostly (25 of 30 us) in the aggregate and a third (10) in the sparsify
KERNELS = [ev("gemm", 0, 10), ev("add", 30, 40), ev("topk", 70, 100)]
HOST = [cpu("aten::mm", 0, 9), cpu("aten::add", 29, 39), cpu("aten::topk", 69, 99)]
PROGRAM = [cpu("repro_torch:step/forward", 0, 45),
           cpu("repro_torch:step/aggregate", 45, 100),
           cpu("repro_torch:aggregate/sparsify", 60, 80)]
MIRROR = [ev("repro_torch:step/forward", 0, 45), ev("repro_torch:step/aggregate", 45, 100),
          ev("repro_torch:aggregate/sparsify", 60, 80)]


def test_program_ranges_leave_busy_and_idle_time_unchanged():
    plain = KERNELS + HOST
    traced = KERNELS + HOST + PROGRAM + MIRROR
    want = devtrace.device_stretch(plain)
    got = devtrace.device_stretch(traced)
    assert (got["busy_s"], got["window_s"]) == (want["busy_s"], want["window_s"])
    assert got["device_ops"] == want["device_ops"] and got["kernels"] == want["kernels"]
    assert devtrace.idle_gaps(traced, 0, 100) == devtrace.idle_gaps(plain, 0, 100)
    # the mirrored ranges alone, counted, would read busy the whole stretch
    assert devtrace._intervals(MIRROR, DeviceType.CUDA) == []
    assert devtrace._intervals(PROGRAM, DeviceType.CPU) == []
    assert want["busy_s"] == pytest.approx(50e-6)


def test_idle_by_span_names_the_innermost_covering_range():
    events = KERNELS + HOST + PROGRAM + MIRROR
    got = dict(ps.idle_by_span(events, 0, 100))
    # [10, 30] in the forward; [40, 70]: the sparsify covers 10 of 30 us
    # (under half), its parent the aggregate 25: the aggregate
    assert got == pytest.approx({"step/forward": 20e-6, "step/aggregate": 30e-6})
    # gaps past the program's ranges are outside it, up to the stretch's end
    late = events + [ev("copy", 130, 140)]
    got = dict(ps.idle_by_span(late, 0, 150))
    assert got[ps.OUTSIDE] == pytest.approx(40e-6)
    assert sum(got.values()) == pytest.approx(90e-6)
    # where the sparsify covers most of a gap it takes it
    inner = KERNELS + PROGRAM[:2] + [cpu("repro_torch:aggregate/sparsify", 46, 80)]
    assert dict(ps.idle_by_span(inner, 0, 100))["aggregate/sparsify"] == \
        pytest.approx(30e-6)


@pytest.mark.parametrize("name", sorted(READERS) + ["collective_calls"])
def test_readers_read_the_program_a_step(name):
    """A step of the tracer's own stretch (its snapshot's ``steps``), not
    of the window (the run's ``steps``)."""
    reader = harness.load_reader(HERE / "metrics" / f"{name}.py")
    assert reader.read({"steps": 40, "program": None}) is None
    assert reader.read({"steps": 40}) is None
    assert reader.read({"steps": 40, "program": {"spans": {}, "counters": {},
                                                 "steps": 4}}) is None
    program = {"spans": {span: {"calls": 8, "device_ms": 10.0 + i, "host_ms": 1.0,
                                "self_device_ms": 1.0}
                         for i, span in enumerate(sorted(READERS.values()))},
               "counters": {"collective/calls/sum": 8, "collective/calls/bor": 4,
                            "collective/calls/gather": 48, "collective/bytes/sum": 99},
               "steps": 4}
    value = reader.read({"steps": 40, "program": program})
    if name == "collective_calls":
        assert value == 15.0
    else:
        assert value == program["spans"][READERS[name]]["device_ms"] / 4


def test_tracer_bytes_equal_the_harness_wire_a_step():
    """A traced run turns the program's tracer on for the first checked
    step and for a stretch of ``trace_steps`` steps after the window, and
    leaves it off in the window and after the run. Every step sends the
    same bytes, so the tracer's a step of its stretch equal the
    harness's a step of the window."""
    from repro_torch import obs
    files = small("train.granite-3-2b.d4.w2")
    part = harness.run_cell(files["config"], files["mix"], files["limits"],
                            2**31 + 9, 0.3, True, "cpu")
    assert not obs.enabled()
    snap = part["program"]
    n = files["mix"]["trace_steps"]
    assert snap["steps"] == n and part["steps"] > 0
    assert snap["spans"]["step/aggregate"]["calls"] == n
    assert snap["spans"]["step/forward"]["calls"] == 2 * n
    assert "setup/init_state" not in snap["spans"]
    c = snap["counters"]
    assert (c["collective/bytes/sum"] + c["collective/bytes/bor"]) * part["steps"] == \
        part["wire_bytes"] * n
    first = part["first_step_spans_s"]
    assert first["setup/init_state"] > 0 and first["step/forward"] > 0
    assert set(first) >= {"step/backward", "step/aggregate", "step/optimizer"}


def test_untraced_run_leaves_the_tracer_alone():
    files = small("train.granite-3-2b.d4.w2")
    part = harness.run_cell(files["config"], files["mix"], files["limits"],
                            2**31 + 10, 0.1, False, "cpu")
    assert "program" not in part and "first_step_spans_s" not in part
