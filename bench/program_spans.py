"""The program's own spans and counters (``repro_torch.obs``) as the
benchmark reads them, and a run of one cell with them on.

Library, for the per-layer readers and for a traced run:

- :func:`span_ms` / :func:`counter_per_step`: a span's device ms, or a
  counter family's total, a step of the stretch the tracer was on for,
  from its snapshot in ``run["program"]`` (``steps``: that stretch's
  steps); None where the run has none (a program without the tracer, an
  untraced run) or the span never fired.
- :func:`idle_by_span`: the idle seconds of a host-traced stretch, each
  gap put down to the innermost program range that covers most of it,
  else to ``(outside the program)``. The device's intervals leave the
  program's ranges out (``devtrace._intervals``).

Command, on one CUDA device (a cell whose mix runs one process):

    python3 bench/program_spans.py --workload <name> --seed <n> \\
        [--seconds 15] [--arms 4] [--out chiprun_out/spans.json]

Set-up as the benchmark's (``harness``), with the tracer on from
``init_train_state``: the first checked step's host split. Then
``--arms`` windows of ``--seconds`` with the tracer off and on in turns
(off, on, on, off, ...): tokens/s of each, the tracer's cost; each
span's device ms and each counter a step of the on-arms, and what every
per-layer reader of ``bench/metrics`` reads from them. Then the
benchmark's profiled stretches with the tracer on: the device alone for
the busy and idle time, then the host too for ``idle_by_span``. One
JSON line on standard output (and in ``--out``). (The benchmark's own
traced run keeps the tracer off in its window and its device-only
stretch; this command measures what the tracer costs there.)
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time
from typing import Dict, List

import numpy as np

import devtrace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
PREFIX = devtrace.PROGRAM_PREFIX
OUTSIDE = "(outside the program)"


# ----------------------------------------------------------------------
# Reading the tracer's snapshot and the profiler's events
# ----------------------------------------------------------------------

def span_ms(run: Dict, name: str):
    """Span ``name``'s device ms a step of the tracer's stretch (every
    call in the step summed), or None."""
    program = run.get("program") or {}
    s = (program.get("spans") or {}).get(name)
    return s["device_ms"] / program["steps"] if s else None


def counter_per_step(run: Dict, prefix: str):
    """The counters whose names start with ``prefix``, summed, a step of
    the tracer's stretch, or None where there is none."""
    program = run.get("program") or {}
    vals = [n for k, n in (program.get("counters") or {}).items() if k.startswith(prefix)]
    return sum(vals) / program["steps"] if vals else None


def idle_by_span(events, lo: float, hi: float) -> List[list]:
    """Idle seconds on the device within ``[lo, hi]`` (microseconds) by
    the program stage running meanwhile: each gap put down to the
    innermost ``repro_torch:`` host range that covers at least half of
    it, else to :data:`OUTSIDE`. Every gap is counted."""
    from torch.autograd import DeviceType
    busy = devtrace._union([(max(a, lo), min(b, hi)) for a, b, _ in
                            devtrace._intervals(events, DeviceType.CUDA)
                            if b > lo and a < hi])
    prog = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
            for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith(PREFIX)
            and e.time_range.end > lo and e.time_range.start < hi]
    starts = np.array([p[0] for p in prog], dtype=np.float64)
    ends = np.array([p[1] for p in prog], dtype=np.float64)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    out: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        over = np.minimum(ends, b) - np.maximum(starts, a)
        most = np.flatnonzero(over >= 0.5 * (b - a))
        name = prog[most[np.argmax(starts[most])]][2] if most.size else OUTSIDE
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return [[n, s] for n, s in sorted(out.items(), key=lambda kv: -kv[1])]


# ----------------------------------------------------------------------
# One cell with the tracer on
# ----------------------------------------------------------------------

def _batches(ref_lib, cfg, mix, seed, idx, dev):
    return [{k: v.to(dev) for k, v in b.items()}
            for b in ref_lib.make_batches(cfg, mix["global_batch"], mix["seq_len"],
                                          seed, idx)]


def measure(files: Dict, seed: int, seconds: float, arms: int, device="cuda") -> Dict:
    """The cell with the tracer on (see the module's doc)."""
    import torch
    import harness
    import reference as ref_lib
    from repro_torch import obs
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.kernels import build
    from repro_torch.models.params import ParamTree, unflatten_tree
    from repro_torch.models.registry import model_api
    from repro_torch.train.step import build_train_step, init_train_state

    cfg, mix = files["config"], files["mix"]
    if mix["ranks"] != 1:
        raise ValueError("the mix runs ranks: this command emulates the workers")
    dev = torch.device(device)
    build.load_all()
    mcfg, tc = harness.program_configs(cfg, mix, seed)
    api = model_api(mcfg)
    group = LocalWorkers(tc.workers)
    params = ref_lib.make_params(cfg, seed, dev)
    tree = ParamTree(unflatten_tree([(tuple(p.split("/")), t) for p, t in params.items()]))
    del params
    obs.enable(dev)
    obs.reset()
    state = init_train_state(api, tc, dev, params=tree, group=group)
    step_fn = build_train_step(api, tc, group=group)
    n_check = mix["check_steps"]
    batches = _batches(ref_lib, cfg, mix, seed, range(n_check), dev)
    check_s = []
    for k in range(n_check):
        t = time.perf_counter()
        state, metrics = step_fn(state, batches[k])
        harness._scalars(metrics)
        check_s.append(time.perf_counter() - t)
        if k == 0:
            first = obs.snapshot()
    first_step = {"wall_s": check_s[0],
                  "spans_s": {n: s["host_ms"] * 1e-3 for n, s in first["spans"].items()}}
    i = n_check
    B, S = mix["global_batch"], mix["seq_len"]

    # the arms: the tracer off and on in turns, each its own batches
    obs.disable()
    obs.reset()
    arm_out, on_steps, on_s = [], 0, 0.0
    per_arm = int(math.ceil(seconds / min(check_s) * harness.WINDOW_MARGIN)) + 2
    for a in range(arms):
        on = a % 4 in (1, 2)
        feed = _batches(ref_lib, cfg, mix, seed, range(i, i + per_arm), dev)
        harness._sync(dev)
        if on:
            obs.enable(dev)
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            state, metrics = step_fn(state, feed[n])
            harness._scalars(metrics)
            n += 1
        window = time.perf_counter() - t0
        obs.disable()
        i += per_arm
        del feed
        arm_out.append({"tracer": "on" if on else "off", "steps": n, "window_s": window,
                        "tokens_per_s": n * B * S / window})
        if on:
            on_steps, on_s = on_steps + n, on_s + window
    program = dict(obs.snapshot(), steps=on_steps)

    n = mix["trace_steps"]
    feed = _batches(ref_lib, cfg, mix, seed, range(i, i + n + 1 + devtrace.LABEL_STEPS), dev)

    def step(j):
        return step_fn(state, feed[j])
    obs.enable(dev)
    profile = devtrace.device_steps(step, n, dev, harness._scalars)
    lab = devtrace.label_steps(lambda j: step(n + j), dev, harness._scalars)
    profile.update(idle_gaps=lab["idle_gaps"],
                   idle_by_span=idle_by_span(lab["events"], *lab["window"]))
    obs.disable()

    run = {"cfg": cfg, "mix": mix, "chips": 1, "steps": on_steps, "window_s": on_s,
           "tokens_per_step": B * S, "forward_ms": 0.0, "collective_ms": 0.0,
           "wire_bytes": 0, "profile": profile, "program": program}
    metrics = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        value = harness.load_reader(path).read(run)
        if value is not None:
            metrics[path.stem] = value
    split = {n: s["device_ms"] / on_steps for n, s in program["spans"].items()}
    top = ("step/forward", "step/backward", "step/aggregate", "step/optimizer")
    labelled = sum(s for _, s in profile["idle_by_span"])
    outside = dict(profile["idle_by_span"]).get(OUTSIDE, 0.0)
    return {
        "device": torch.cuda.get_device_name(dev),
        "first_step_spans_s": first_step, "arms": arm_out,
        "split_ms": split,
        "self_ms": {n: s["self_device_ms"] / on_steps for n, s in program["spans"].items()},
        "calls": {n: s["calls"] / on_steps for n, s in program["spans"].items()},
        "counters": {k: v / on_steps for k, v in program["counters"].items()},
        "coverage": sum(split.get(n, 0.0) for n in top) / (on_s / on_steps * 1e3),
        "metrics": metrics,
        "profile": {k: profile[k] for k in ("busy_s", "window_s", "steps")},
        "breakdown": {"device_ops": profile["device_ops"],
                      "idle_gaps": profile["idle_gaps"]},
        "idle_by_span": profile["idle_by_span"],
        "labelled_idle_s": labelled,
        "program_share_of_idle": 1.0 - outside / labelled if labelled else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--arms", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import run as bench_run
    bench_run.cache_env(ROOT)
    import torch
    import harness
    torch.set_num_threads(4)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to measure", file=sys.stderr)
        return 2
    files = harness.cell_files(json.loads((ROOT / "BENCHMARK.json").read_text()),
                               args.workload)
    out = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds}
    out.update(measure(files, args.seed, args.seconds, args.arms))
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
