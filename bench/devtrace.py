"""The profiled stretch of a traced run and its reduction: when the card
was busy, what ran on it, and what the host did while it sat idle.

``torch.profiler`` records the card's kernels, copies and sets, and (in
a second, shorter stretch) the host's operators on the same clock. The
busy time is the union of the card's intervals; each of the longest
idle gaps is named after the innermost host operator that covers most
of it. The program's own ranges (``repro_torch:<span>``, which the
profiler records on the host and mirrors on the device while the
program's tracer is on) are neither device work nor host operators
here: only ``program_spans.idle_by_span`` reads them, from the events
that :func:`label_steps` returns.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

WINDOW = "bench_trace_window"
PROGRAM_PREFIX = "repro_torch:"
LABELLED = 500          # the longest idle gaps named by their host operator
LABEL_STEPS = 2         # steps traced on the host too, for those names


def _intervals(events, kind) -> List[Tuple[float, float, str]]:
    """``(start, end, name)`` of the events on ``kind``, the stretch's own
    annotation and the program's ranges (which the profiler mirrors on
    the device) left out."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == kind and e.name != WINDOW
            and not e.name.startswith(PROGRAM_PREFIX)]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_during(host, a: float, b: float) -> str:
    """The innermost host operator that covers most of ``[a, b]``, else
    the one that overlaps it longest. ``host``: (starts, ends, names)."""
    starts, ends, names = host
    over = np.minimum(ends, b) - np.maximum(starts, a)
    idx = np.flatnonzero(over > 0)
    if not idx.size:
        return "(no host operator)"
    most = idx[over[idx] >= 0.5 * (b - a)]
    pick = most[np.argmax(starts[most])] if most.size else idx[np.argmax(over[idx])]
    return names[pick]


def device_stretch(events) -> Dict[str, object]:
    """Busy and window seconds (the window from the first device
    operation to the last), seconds by device operation, and each
    kernel's launch times, from the profiler's events (microseconds)."""
    from torch.autograd import DeviceType
    dev = _intervals(events, DeviceType.CUDA)
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    busy = _union([(a, b) for a, b, _ in dev])
    by_op: Dict[str, float] = {}
    kernels: Dict[str, List[float]] = {}
    for a, b, n in dev:
        by_op[n] = by_op.get(n, 0.0) + (b - a) * 1e-6
        kernels.setdefault(n, []).append((b - a) * 1e-6)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (busy[-1][1] - busy[0][0]) * 1e-6,
            "device_ops": [[n[:160], s] for n, s in top], "kernels": kernels}


def idle_gaps(events, lo: float, hi: float) -> List[list]:
    """Idle seconds on the device within ``[lo, hi]`` by the host operator
    running meanwhile: the longest gaps each named, the rest lumped."""
    from torch.autograd import DeviceType
    busy = _union([(max(a, lo), min(b, hi)) for a, b, _ in
                   _intervals(events, DeviceType.CUDA) if b > lo and a < hi])
    cpu = [(a, b, n) for a, b, n in _intervals(events, DeviceType.CPU)
           if b > lo and a < hi]
    host = (np.array([c[0] for c in cpu], dtype=np.float64),
            np.array([c[1] for c in cpu], dtype=np.float64), [c[2] for c in cpu])
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    idle = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  reverse=True)
    gaps: Dict[str, float] = {}
    for i, (d, a, b) in enumerate(idle):
        name = _host_during(host, a, b) if i < LABELLED else "(shorter gaps)"
        gaps[name] = gaps.get(name, 0.0) + d * 1e-6
    return [[n[:160], s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]


def device_steps(step: Callable[[int], tuple], n: int, device,
                 read: Callable[[dict], object]) -> Dict[str, object]:
    """Steps ``0..n-1`` (``step(j)`` returns ``(state, metrics)``; ``read``
    copies the metrics to the host) under the device's tracing alone:
    the busy and idle time, the device operations and the kernels' times
    (:func:`device_stretch`; ``steps``: ``n``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for j in range(n):
            read(step(j)[1])
        torch.cuda.synchronize(device)
    out = device_stretch(prof.events())
    out["steps"] = n
    return out


def label_steps(step: Callable[[int], tuple], device,
                 read: Callable[[dict], object]) -> Dict[str, object]:
    """Under the host's tracing too, step 0 to let it settle, then steps
    ``1..LABEL_STEPS`` in :data:`WINDOW`: the idle gaps named by their
    host operator (``idle_gaps``), and the stretch's ``events`` and its
    ``window`` ``(lo, hi)`` (microseconds) for a reduction of the
    caller's (``program_spans.idle_by_span``). The host's tracing slows
    the host by tens of percent, so it measures no share."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        read(step(0)[1])
        torch.cuda.synchronize(device)
        with record_function(WINDOW):
            for j in range(1, 1 + LABEL_STEPS):
                read(step(j)[1])
            torch.cuda.synchronize(device)
    events = prof.events()
    win = [e for e in events if e.name == WINDOW and e.device_type.name == "CPU"]
    if not win:
        raise RuntimeError("the profiler recorded no window")
    lo, hi = win[0].time_range.start, win[0].time_range.end
    return {"idle_gaps": idle_gaps(events, lo, hi), "events": events, "window": (lo, hi)}
