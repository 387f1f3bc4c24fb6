"""Spans and counters inside the port's train step, kept in memory and
read out by whoever turned them on: a benchmark's traced run, a test,
an operator. The JAX package has no counterpart (its step is one jitted
program; this module times the port's eager stages).

- ``span(name)``: a context manager around one stage of the step. It
  records its name, its start and end, and its parent, the innermost
  span open on the same thread when it started.
- ``count(name, n)``: adds ``n`` to a counter.
- ``enable(device)``, ``disable()``, ``reset()``: tracing is off until a
  caller enables it. No environment variable or config field turns it
  on. ``reset`` drops every span and counter recorded so far.
- ``snapshot()``: ``{"spans": {name: {"calls", "device_ms", "host_ms",
  "self_device_ms"}}, "counters": {name: n}}`` over everything recorded
  since the last ``reset``, closed spans only.

Off, ``span`` returns one shared no-op context: no CUDA event, no
``record_function``, no synchronisation. On, a span on a CUDA device
records a pair of ``torch.cuda.Event(enable_timing=True)`` on the
current stream beside the host clock (``time.perf_counter_ns``); on
the CPU the host clock alone, which then stands for the device time
too.
Nothing is resolved until ``snapshot``, which synchronises once. Where
a ``torch.profiler`` is active, each span also enters
``record_function("repro_torch:" + name)``, so the profiler's timeline
carries the program's stage names.

A span's self time is its device time minus its child spans' device
time. A span opened on another thread (a ``CommThread`` of the streamed
paths on ranks) has no parent and times that thread's current stream,
the side stream, only.

The counters hold what the program counts where the work happens
(``core/collectives.py``: ``collective/calls/<op>`` and
``collective/bytes/<op>``, one worker's payload) and the kernel
launches made while tracing was on (``kernels/launches/<name>``, read
from ``kernels.cuda_common.LAUNCHES`` when tracing is turned off and at
``snapshot``; the wrappers count as before).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

PREFIX = "repro_torch:"

_OFF = contextlib.nullcontext()


class _Span:
    """One span's record, and the context that fills it in."""

    __slots__ = ("tracer", "name", "parent", "t0", "t1", "ev0", "ev1",
                 "prof", "child")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name
        self.t1 = self.ev0 = self.ev1 = self.prof = None

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if torch._C._autograd._profiler_enabled():
            self.prof = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.prof.__enter__()
        if self.tracer.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        self.tracer._stack().pop()
        self.tracer.records.append(self)
        return False


class Tracer:
    """The spans and counters of one process (see the module's doc)."""

    def __init__(self):
        self.on = False
        self.cuda = False
        self._local = threading.local()
        self._lock = threading.Lock()
        self.records: List[_Span] = []
        self.counters: Dict[str, int] = {}
        self._launch_base: Dict[str, int] = {}

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _launches(self) -> Dict[str, int]:
        """Kernel launches since tracing was last turned on or reset."""
        from repro_torch.kernels.cuda_common import LAUNCHES
        return {f"kernels/launches/{k}": n - self._launch_base.get(k, 0)
                for k, n in LAUNCHES.items() if n > self._launch_base.get(k, 0)}

    def _mark_launches(self):
        from repro_torch.kernels.cuda_common import LAUNCHES
        self._launch_base = dict(LAUNCHES)

    def enable(self, device=None):
        """Record from now on, on ``device``'s clock (default: CUDA where
        it is available, else the host's)."""
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.cuda = torch.device(device).type == "cuda"
        if not self.on:
            self._mark_launches()
        self.on = True

    def disable(self):
        if self.on:
            for k, n in self._launches().items():
                self.count(k, n)
        self.on = False

    def reset(self):
        self.records = []
        with self._lock:
            self.counters = {}
        self._mark_launches()

    def span(self, name: str):
        return _Span(self, name) if self.on else _OFF

    def count(self, name: str, n: int = 1):
        if self.on:
            with self._lock:
                self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> Dict[str, Dict]:
        done = [r for r in self.records if r.t1 is not None]
        if any(r.ev1 is not None for r in done):
            torch.cuda.synchronize()
        # device time in ns: the events' (ms) or, on the CPU, the host
        # clock's integers, so a child's never exceeds its parent's there
        dev = {}
        for r in done:
            dev[r] = (r.ev0.elapsed_time(r.ev1) * 1e6 if r.ev1 is not None
                      else r.t1 - r.t0)
            r.child = 0
        for r in done:
            if r.parent in dev:
                r.parent.child += dev[r]
        spans: Dict[str, Dict] = {}
        for r in done:
            s = spans.setdefault(r.name, {"calls": 0, "device_ms": 0.0,
                                          "host_ms": 0.0, "self_device_ms": 0.0})
            s["calls"] += 1
            s["device_ms"] += dev[r] * 1e-6
            s["host_ms"] += (r.t1 - r.t0) * 1e-6
            s["self_device_ms"] += (dev[r] - r.child) * 1e-6
        with self._lock:
            counters = dict(self.counters)
        if self.on:
            for k, n in self._launches().items():
                counters[k] = counters.get(k, 0) + n
        return {"spans": spans, "counters": counters}


TRACER = Tracer()


def span(name: str):
    """A context manager timing one stage as ``name`` (see the module's
    doc); the shared no-op context while tracing is off."""
    return TRACER.span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while tracing is on."""
    TRACER.count(name, n)


def enabled() -> bool:
    return TRACER.on


def enable(device: Optional[object] = None):
    TRACER.enable(device)


def disable():
    TRACER.disable()


def reset():
    TRACER.reset()


def snapshot() -> Dict[str, Dict]:
    return TRACER.snapshot()
