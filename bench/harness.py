"""One run of one cell: set-up, the measured window, the traced stretch
and the check against the plain reference.

The cell's configuration, its reference model, traffic mix, limits and
per-layer readers are files found by name (``bench/configs``,
``bench/refmodels``, ``bench/mixes``, ``bench/limits``,
``bench/metrics``). The program under test is ``repro_torch``; the
benchmark hands it the parameters and batches it makes from the seed,
and its own ``ModelAPI`` and worker group, which in a traced run time
the calls into the model and the collectives. A traced run also turns
the program's own tracer (``repro_torch.obs``) on, but never in the
window or the device-only profiled stretch.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time
import typing
from typing import Dict, List, Optional

import torch

import devtrace
import program_spans
import reference as ref_lib
import refmodels
import yardstick as ys

ROOT = pathlib.Path(__file__).resolve().parents[1]
WINDOW_MARGIN = 1.5     # window batches made ahead: seconds / fastest checked step, x this
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class ForbiddenModules(RuntimeError):
    """A measuring process loaded JAX or the JAX package."""


def loaded_forbidden() -> list:
    """The forbidden top-level names in this process's ``sys.modules``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(manifest: dict, workload: str, root=ROOT) -> Dict[str, object]:
    """The workload's entry and its configuration, mix, limits and
    per-layer readers, each found by name; the reference module that
    the configuration names is imported here, so a missing one fails
    before the run."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(root / conf["file"])
    refmodels.for_config(config)
    readers = {m["name"]: root / "bench" / "metrics" / f"{m['name']}.py"
               for m in manifest["per_layer"]}
    return {"cell": cell,
            "config": config,
            "mix": load_json(root / "bench" / "mixes" / f"{cell['traffic']}.json"),
            "limits": load_json(root / "bench" / "limits" / f"{workload}.json"),
            "readers": readers}


def load_reader(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"bench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# Spans: device time inside the calls the benchmark hands the program
# ----------------------------------------------------------------------

class Spans:
    """Pairs of CUDA events (host clock on the CPU) a span name, summed
    once the device is done; and counts a name."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.open: Dict[str, list] = {}
        self.counts: Dict[str, int] = {}
        self.on = False

    def count(self, name, n):
        self.counts[name] = self.counts.get(name, 0) + n

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, name, start):
        end = self.start()
        self.open.setdefault(name, []).append((start, end))

    def total_ms(self, name) -> float:
        pairs = self.open.get(name, [])
        if self.cuda:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in pairs)
        return sum(b - a for a, b in pairs) * 1e3


COLLECTIVES = ("sum", "bor", "max", "gather", "sum_scatter", "bor_scatter", "lane_sum")
REDUCTIONS = ("sum", "bor", "sum_scatter", "bor_scatter", "lane_sum")


def _timed(method):
    def call(self, *args, **kwargs):
        spans = self._bench_spans
        if not spans.on:
            return getattr(super(type(self), self), method)(*args, **kwargs)
        if method in REDUCTIONS:
            first = (args[0] if args else kwargs["parts"])[0]
            spans.count("wire", first.numel() * first.element_size())
        t = spans.start()
        out = getattr(super(type(self), self), method)(*args, **kwargs)
        spans.stop("collective", t)
        return out
    call.__name__ = method
    return call


def timed_group(group, spans: Spans):
    """``group`` as an instance of a subclass of its class whose
    collectives add to ``spans``' ``collective`` span, and whose
    reductions count one worker's payload bytes under ``wire``."""
    cls = type(group)
    sub = type(f"Timed{cls.__name__}", (cls,), {m: _timed(m) for m in COLLECTIVES
                                                  if hasattr(cls, m)})
    if dataclasses.is_dataclass(group):
        new = sub(**{f.name: getattr(group, f.name) for f in dataclasses.fields(group)})
    else:
        new = group
        new.__class__ = sub
    object.__setattr__(new, "_bench_spans", spans)
    return new


def timed_api(api, spans: Spans):
    """``api`` with its ``loss`` (one worker's forward) in ``spans``'
    ``forward`` span."""
    loss = api.loss

    def timed_loss(*args, **kwargs):
        if not spans.on:
            return loss(*args, **kwargs)
        t = spans.start()
        out = loss(*args, **kwargs)
        spans.stop("forward", t)
        return out
    return dataclasses.replace(api, loss=timed_loss)


# ----------------------------------------------------------------------
# The program's objects, from the configuration and the mix
# ----------------------------------------------------------------------

def _dataclass_of(hint):
    """The dataclass that a field's type hint names (``X`` or
    ``Optional[X]``), or None."""
    for t in (hint, *typing.get_args(hint)):
        if dataclasses.is_dataclass(t):
            return t
    return None


def program_configs(cfg: dict, mix: dict, seed: int):
    """(ModelConfig, TrainConfig) of the program for ``cfg`` and ``mix``:
    the file's keys that ``ModelConfig`` has, each dict-valued one built
    as the dataclass its field is typed with (``moe``, ``ssm``, ...)."""
    from repro_torch.core.config import CompressionConfig
    from repro_torch.models.config import ModelConfig
    from repro_torch.train.config import TrainConfig
    from repro_torch.train.optimizer import OptimizerConfig
    hints = typing.get_type_hints(ModelConfig)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    fields = {k: v for k, v in cfg.items() if k in names}
    fields["name"] = cfg["arch"]
    for k, v in fields.items():
        sub = _dataclass_of(hints[k]) if isinstance(v, dict) else None
        if sub is not None:
            fields[k] = sub(**v)
    mcfg = ModelConfig(**fields)
    tc = TrainConfig(aggregator=mix["aggregator"],
                     compression=CompressionConfig(**mix["compression"]),
                     optimizer=OptimizerConfig(**mix["optimizer"]),
                     remat=mix["remat"], accum_steps=mix["accum_steps"],
                     workers=mix["workers"], zero1=mix["zero1"],
                     ep_exchange=mix["ep_exchange"], seed=int(seed) % 2**31)
    return mcfg, tc


def _scalars(metrics: dict) -> List[float]:
    """Every scalar metric of a step on the host, in one copy."""
    vals = [v.to(torch.float64) for v in metrics.values() if v.dim() == 0]
    return torch.stack(vals).tolist()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _program_grad_norms(state, group, b1: float) -> List[float]:
    """Each leaf's norm of the first step's gradient as the optimizer got
    it: its first moment over ``1 - b1``; a rank's ZeRO-1 slice's squares
    summed over the ranks."""
    out = []
    for m, p in zip(state.opt["m"], state.params.leaves()):
        sq = m.to(torch.float32).square().sum()
        if m.shape != p.shape:
            sq = group.sum([sq])
        out.append(float(sq.sqrt()) / (1 - b1))
    return out


# ----------------------------------------------------------------------
# One run
# ----------------------------------------------------------------------

def _program_tracer():
    """The program's tracer (``repro_torch.obs``), or None on a tree
    without it."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


def _first_step_spans(obs) -> Dict[str, float]:
    """Each span's host seconds so far; the tracer then reset and off."""
    spans = {n: s["host_ms"] * 1e-3 for n, s in obs.snapshot()["spans"].items()}
    obs.reset()
    obs.disable()
    return spans


def run_cell(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
             trace: bool, device, group=None, t0: Optional[float] = None) -> dict:
    """Set-up (kernels, parameters, state, the checked first steps), the
    window of ``seconds``, with ``trace`` the traced stretches after it,
    then the check. ``group``: this process's rank (``ProcessGroupWorkers``),
    or None for the mix's workers emulated here. Returns this process's
    part of the result; rank 0's (or the only one) carries the check.

    With ``trace`` the program's tracer is on from ``init_train_state``
    to the end of the first checked step (``first_step_spans_s``), then
    off through the window and the ``trace_steps`` steps the profiler
    reads on the device alone; then on over ``trace_steps`` steps of its
    own (``program``: its snapshot, with those ``steps``) and through
    the host-traced steps that name the idle gaps (``idle_by_span``)."""
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.models.params import ParamTree, unflatten_tree
    from repro_torch.models.registry import model_api
    from repro_torch.train.step import build_train_step, init_train_state

    if mix["kind"] != "train" or mix["tokens"] != "uniform":
        raise ValueError(f"a {mix['kind']} mix of {mix['tokens']} ids: the harness "
                         "generates uniform ids for training mixes only")
    t0 = time.time() if t0 is None else t0
    phases = {"imports": time.time() - t0}
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.load_all()
        torch.cuda.reset_peak_memory_stats(dev)
    phases["kernels"] = time.time() - t0
    rank0 = group is None or group.first_worker == 0
    obs = _program_tracer() if trace else None
    spans = Spans(dev)
    mcfg, tc = program_configs(cfg, mix, seed)
    api = timed_api(model_api(mcfg), spans)
    group = timed_group(group if group is not None else LocalWorkers(tc.workers), spans)
    params = ref_lib.make_params(cfg, seed, dev)
    tree = ParamTree(unflatten_tree([(tuple(p.split("/")), t) for p, t in params.items()]))
    del params
    if obs:
        obs.enable(dev)
        obs.reset()
    state = init_train_state(api, tc, dev, params=tree, group=group)
    step_fn = build_train_step(api, tc, group=group)
    B, S = mix["global_batch"], mix["seq_len"]
    n_check, n_traced = mix["check_steps"], mix["trace_steps"]
    # the profiled stretches' batches, made in every run; the tracer's
    # stretch's only in a traced run, so an untraced run holds no more
    n_trace = n_traced + 1 + devtrace.LABEL_STEPS + (n_traced if obs else 0)
    host = ref_lib.make_batches(cfg, B, S, seed, range(n_check))
    batches = [{k: v.to(dev) for k, v in b.items()} for b in host]
    _sync(dev)
    phases["state_and_batches"] = time.time() - t0

    # the checked first steps: the window's own call and feed
    losses, recovery, check_s = [], [], []
    for k in range(n_check):
        t = time.perf_counter()
        state, metrics = step_fn(state, batches[k])
        losses.append(_scalars({"loss": metrics["loss"]})[0])
        check_s.append(time.perf_counter() - t)
        recovery.append({n: int(metrics[f"recovery_{n}"])
                         for n in ("nnz", "peeled", "residual")
                         if f"recovery_{n}" in metrics})
        if k == 0:
            grad = _program_grad_norms(state, group, tc.optimizer.b1)
            phases["first_step"] = time.time() - t0
            first_spans = _first_step_spans(obs) if obs else None
    start = ref_lib.make_params(cfg, seed, dev)
    change = [float((p.detach().to(torch.float32) - s.to(torch.float32)).norm())
              for p, s in zip(state.params.leaves(), start.values())]
    del start
    prog = {"losses": losses, "grad": grad, "change": change}

    # the window's and the traced stretch's batches, as many as the
    # fastest checked step says the window takes, with a margin
    ranks = not isinstance(group, LocalWorkers)
    n_window = int(math.ceil(seconds / min(check_s) * WINDOW_MARGIN)) + 2
    if ranks:
        n_window = int(group.max([torch.tensor(float(n_window), device=dev)]))
    more = ref_lib.make_batches(cfg, B, S, seed,
                                range(n_check, n_check + n_window + n_trace))
    batches += [{k: v.to(dev) for k, v in b.items()} for b in more]
    del more

    def align():
        """Every rank past this point together (the device idle)."""
        _sync(dev)
        if ranks:
            group.sum([torch.zeros((), device=dev)])
            _sync(dev)

    # the window
    align()
    spans.on = trace
    step_s, i = [], n_check
    t_start = time.perf_counter()
    setup_s = time.time() - t0
    phases["checked_steps"] = setup_s
    while True:
        t = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        _scalars(metrics)
        now = time.perf_counter()
        step_s.append(now - t)
        i += 1
        done = now - t_start >= seconds
        if ranks:
            done = bool(group.max([torch.tensor(float(done), device=dev)]))
        if done:
            break
        if i >= n_check + n_window:
            raise RuntimeError(f"the window outran its {n_window} batches")
    window_s = time.perf_counter() - t_start
    spans.on = False
    out = {"rank0": rank0, "setup_s": setup_s, "setup_phases": phases,
           "step_s": step_s, "window_s": window_s,
           "steps": len(step_s), "tokens_per_step": B * S, "recovery": recovery,
           "forward_ms": spans.total_ms("forward"),
           "collective_ms": spans.total_ms("collective"),
           "wire_bytes": spans.counts.get("wire", 0)}

    if trace:
        out.update(_traced(step_fn, state, batches[i:], n_traced, dev, obs, align))
        if first_spans is not None:
            out["first_step_spans_s"] = first_spans
    _sync(dev)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del state, step_fn, batches, metrics, tree
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank0:
        ref = ref_lib.train_readings(cfg, mix, seed, host, dev)
        out["readings"] = ref_lib.compare(prog, ref)
        out["readings"]["residual_share"] = {"value": residual_share(recovery)}
    out["loaded"] = loaded_forbidden()
    return out


def _traced(step_fn, state, batches, n: int, dev, obs, align) -> dict:
    """The stretches after the window (``run_cell``'s doc), over
    ``batches`` in turn: ``profile`` on a CUDA device, ``program`` where
    the tracer is there. The tracer's stretch starts with the ranks
    aligned (``align``), so that no span holds a rank's wait for a peer
    still closing its profiler."""
    def step(j):
        return step_fn(state, batches[j])
    out, i = {}, 0
    if dev.type == "cuda":
        out["profile"] = devtrace.device_steps(step, n, dev, _scalars)
        i = n
    if obs:
        align()
        obs.enable(dev)
        obs.reset()
        for j in range(i, i + n):
            _scalars(step(j)[1])
        out["program"] = dict(obs.snapshot(), steps=n)
        i += n
    if dev.type == "cuda":
        lab = devtrace.label_steps(lambda j: step(i + j), dev, _scalars)
        out["profile"].update(idle_gaps=lab["idle_gaps"],
                              idle_by_span=program_spans.idle_by_span(lab["events"],
                                                                      *lab["window"]))
    if obs:
        obs.disable()
        obs.reset()
    return out


def residual_share(recovery: List[dict]) -> float:
    """The share of the checked steps' set coordinates that the peel left
    to the estimate; 0 for a lossless aggregate (or no peel)."""
    nnz = sum(r.get("nnz", 0) for r in recovery)
    return sum(r.get("residual", 0) for r in recovery) / nnz if nnz else 0.0


def rank_main(group, device, files, seed, seconds, trace, t0):
    """One rank of a cell whose mix runs ranks (``spawn_ranks``' function):
    its part of the run."""
    return run_cell(files["config"], files["mix"], files["limits"], seed, seconds,
                    trace, device, group=group, t0=t0)


def judge(readings: dict, limits: dict) -> dict:
    """Each number compared beside its limit (and the leaves a number
    leaves out); ``correct`` where every number is within its limit."""
    check = {}
    for name, r in readings.items():
        check[name] = {"value": r["value"], "limit": limits[name]["limit"]}
        if r.get("left_out"):
            check[name]["left_out"] = r["left_out"]
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())
    return {"correct": ok, "check": check}


def result_line(parts: List[dict], files: dict, trace: bool, chips: int,
                device) -> dict:
    """The run's last line from every rank's part (rank 0's first).
    Raises :class:`ForbiddenModules` where a part's process loaded JAX
    or the JAX package."""
    loaded = sorted({m for p in parts for m in p["loaded"]})
    if loaded:
        raise ForbiddenModules(f"loaded in a measuring process: {loaded}")
    cfg, mix = files["config"], files["mix"]
    lead = parts[0]
    verdict = judge(lead["readings"], files["limits"])
    steps, window = lead["steps"], lead["window_s"]
    run = {"cfg": cfg, "mix": mix, "chips": chips, "steps": steps,
           "window_s": window, "tokens_per_step": lead["tokens_per_step"],
           "forward_ms": lead["forward_ms"], "collective_ms": lead["collective_ms"],
           "wire_bytes": lead["wire_bytes"], "profile": lead.get("profile"),
           "program": lead.get("program")}
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": chips,
                   "memory_peak_bytes": max(p["peak_bytes"] for p in parts)}
    line = {"correct": verdict["correct"], "attempted": steps, "failed": 0}
    if trace:
        metrics = {}
        for name, path in files["readers"].items():
            mod = load_reader(path)
            value = mod.read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        line["metrics"] = metrics
        prof = lead.get("profile")
        if prof is not None:
            device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            line["breakdown"] = {"device_ops": prof["device_ops"],
                                 "idle_gaps": prof["idle_gaps"]}
            line["idle_by_span"] = prof["idle_by_span"]
        if lead.get("first_step_spans_s") is not None:
            line["first_step_spans_s"] = lead["first_step_spans_s"]
    else:
        step_ms = [s * 1e3 for s in lead["step_s"]]
        e2e = {"tokens_per_s": (steps * lead["tokens_per_step"] / window, "tokens/s"),
               "step_ms_p90": (ys.percentile(step_ms, 90), "ms"),
               "peak_mem_gib": (device_info["memory_peak_bytes"] / 2**30, "GiB"),
               "setup_s": (lead["setup_s"], "s")}
        line["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in e2e.items()}
    line["device"] = device_info
    line["setup_phases_s"] = lead["setup_phases"]
    line["check"] = verdict["check"]
    return line
