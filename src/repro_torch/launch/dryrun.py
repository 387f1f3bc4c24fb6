"""Dry run of every (arch x shape x mesh) cell: one rank's step traced on
the ``meta`` device, allocating nothing; the torch counterpart of the
reference's ``launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

One JSON a cell, ``<out>/<mesh>/<arch>__<shape>.json`` (``--out``
defaults to ``build/dryrun`` in the repo); a rerun keeps a finished
cell (``ok`` or ``skip``) unless ``--force``. The cells are the
reference's: ``configs.list_archs()`` x ``configs.SHAPES`` x
``make_production_mesh`` (16 x 16, and 2 pods of it), each record with
the reference's keys (``arch``, ``shape``, ``mesh``, ``kind``,
``seq_len``, ``global_batch``, ``params_total``, ``params_active``,
``aggregator``, ``status``; ``reason`` for a ``skip``) and:

- ``memory``: ``argument_bytes``, the bytes of this rank's share of the
  arguments the step reads (a leaf no op touches is left out, as XLA's
  count drops it: the encoder's leaves in a whisper decode; the decode
  position, an int32 scalar, counts where an attention layer reads it);
  ``output_bytes``, the tensors the step returns, ``alias_bytes`` those
  of them that are arguments updated in place (the decode cache);
  ``temp_bytes``, an estimate: for a serve cell the peak of the live
  storages the step's ops create, less its new outputs; for a train cell
  the bytes saved for the backward under the cell's remat policy
  (``torch.autograd.graph.saved_tensors_hooks``, plus the inputs a
  checkpointed unit keeps for its recompute); ``peak_per_device_gib``,
  argument + temp + output - alias;
- ``cost``: ``flops`` from ``torch.utils.flop_counter.FlopCounterMode``
  (its products and convolutions; elementwise ops count nothing), and
  ``bytes_accessed``, the sum of the operand and result bytes of every
  aten op the step dispatches (views included), an upper bound on the
  traffic;
- ``collectives``: ``{op: {count, bytes, group_sizes}}`` in the
  reference's ``parse_collectives`` schema, one record a call of the
  port's process-group interface (``ProcessGroupWorkers``), its bytes
  this rank's operand: ``sum`` and ``max`` as ``all-reduce``, ``gather``
  as ``all-gather`` (the rank's slice), ``sum_scatter`` as
  ``reduce-scatter``, ``bor`` / ``bor_scatter`` (the OR all-reduce and
  reduce-scatter, rings or doublings of point-to-point exchanges) as
  ``collective-permute`` and ``lane_sum`` as ``all-to-all``;
- ``trace_s``, the trace's wall seconds, in place of the reference's
  ``lower_s`` / ``compile_s``.

How: the rank at the mesh's first coordinates runs the step whole, its
process groups replaced by stand-ins (:class:`MetaGroup`) of the mesh's
group sizes that return ``meta`` results of the right shapes, each
wrapped in a :class:`RecordingGroup`. A serve cell runs the port's
grid steps (``serve/steps.py``) on ``meta`` parameter shards, batch and
cache. A train cell runs ``train/step.py``'s step on a ``meta`` state:
the forward, the backward, the DP aggregation and the update. On a
multi-pod mesh the data-parallel group is the pod x data ranks (its
levels the data axis, then the pods). The aggregator's data-dependent
steps cannot run on ``meta``: the top-k threshold's quantile, and the
codec's encode and recovery, are replaced by stand-ins that give the
threshold, the wire's sketch and words, and the recovered stream, at
their real shapes (the sketch and word sizes of one block on the CPU,
times the blocks), so the bucket plan on the local shapes, the wire's
calls and ZeRO-1's gathers are the real step's. The MoE routing's shapes
are static too (the capacity comes from the token count).

:func:`trace_serve` and :func:`trace_train` take any config and mesh
shape: ``tests/test_torch_dryrun.py`` holds their collectives and FLOPs
to a real 2 x 2 grid's, recorded by the same :class:`RecordingGroup`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from collections import Counter
from typing import Any, Dict, Optional, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as ckpt_lib
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_arch, list_archs, make_batch_struct
from repro_torch.core.blocks import make_plan
from repro_torch.core.compressor import (CompressedLeaf, HomomorphicCompressor,
                                         RecoveryStats)
from repro_torch.core import topk as topk_lib
from repro_torch.core.streams import InlineIssue
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.params import ParamTree, flatten_tree, unflatten_tree
from repro_torch.models.registry import model_api
from repro_torch.parallel import sharding as shd
from repro_torch.serve import steps as serve_steps
from repro_torch.train import step as train_step

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")
OPS = {"sum": "all-reduce", "max": "all-reduce", "gather": "all-gather",
       "sum_scatter": "reduce-scatter", "bor": "collective-permute",
       "bor_scatter": "collective-permute", "lane_sum": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ----------------------------------------------------------------------
# Recorded and stand-in process groups
# ----------------------------------------------------------------------

class Recorder:
    """The collectives of a run: ``{op: {count, bytes, group_sizes}}``."""

    def __init__(self):
        self.ops: Dict[str, Dict[str, Any]] = {}

    def add(self, op: str, nbytes: int, size: int):
        d = self.ops.setdefault(op, {"count": 0, "bytes": 0,
                                     "group_sizes": Counter()})
        d["count"] += 1
        d["bytes"] += nbytes
        d["group_sizes"][size] += 1

    def summary(self) -> Dict[str, Any]:
        return {op: {"count": d["count"], "bytes": d["bytes"],
                     "group_sizes": dict(d["group_sizes"])}
                for op, d in sorted(self.ops.items())}


class RecordingGroup:
    """``group`` with every collective of its interface recorded (see
    :data:`OPS`); every other attribute is the group's."""

    def __init__(self, group, recorder: Recorder):
        self._group, self._recorder = group, recorder

    def __getattr__(self, name):
        attr = getattr(self._group, name)
        if name not in OPS:
            return attr

        def call(parts, *args, **kwargs):
            self._recorder.add(OPS[name], sum(_nbytes(p) for p in parts),
                               self._group.workers)
            return attr(parts, *args, **kwargs)
        return call


class MetaGroup:
    """A stand-in for one rank's ``ProcessGroupWorkers`` of ``workers``
    ranks (this rank's index ``index``, data-parallel ``levels``): every
    collective returns a ``meta`` tensor of its result's shape."""

    local_workers = 1

    def __init__(self, workers: int, index: int = 0,
                 levels: Sequence[int] = ()):
        self.workers, self.rank = workers, index
        self.levels = tuple(levels) or (workers,)

    @property
    def first_worker(self) -> int:
        return self.rank

    @staticmethod
    def _like(x):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")

    def sum(self, parts):
        return self._like(parts[0])

    max = bor = sum

    def gather(self, parts):
        x = parts[0]
        return torch.empty((self.workers * x.shape[0],) + tuple(x.shape[1:]),
                           dtype=x.dtype, device="meta")

    def sum_scatter(self, parts):
        x = parts[0]
        return [torch.empty((x.shape[0] // self.workers,) + tuple(x.shape[1:]),
                            dtype=x.dtype, device="meta")]

    bor_scatter = sum_scatter

    def lane_sum(self, parts, combine):
        return [self._like(parts[0][0])]

    def issuer(self):
        return InlineIssue()


class RecordingMesh:
    """A mesh whose groups are recorded into one :class:`Recorder`: a
    ``RankMesh``'s (``mesh``: a real grid), or :class:`MetaGroup`\\ s of
    the mesh shape ``shape`` at ``coords`` (default: the first device's).
    ``data`` is the data-parallel group (every axis but ``model``),
    ``model`` the model axis's (None for one model rank)."""

    def __init__(self, shape: Dict[str, int], coords=None, mesh=None):
        self.shape = dict(shape)
        self.coords = dict(coords or getattr(mesh, "coords", None)
                           or {a: 0 for a in shape})
        self.mesh, self.recorder, self._groups = mesh, Recorder(), {}
        self.dp_axes = tuple(a for a in self.shape if a != "model")

    def _make(self, axes):
        if self.mesh is not None:
            if axes == self.dp_axes:
                return self.mesh.data
            return self.mesh.group(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        levels = ([self.shape[a] for a in reversed(axes)]
                  if len(axes) > 1 else ())
        return MetaGroup(math.prod(self.shape[a] for a in axes), idx, levels)

    def group(self, axes):
        axes = tuple(a for a in axes if a in self.shape)
        if axes != self.dp_axes:
            axes = tuple(a for a in axes if self.shape[a] > 1)
            if not axes:
                return None
        if axes not in self._groups:
            g = self._make(axes)
            self._groups[axes] = (None if g is None
                                  else RecordingGroup(g, self.recorder))
        return self._groups[axes]

    @property
    def data(self):
        return self.group(self.dp_axes)

    @property
    def model(self):
        return self.group(("model",))


# ----------------------------------------------------------------------
# The trace
# ----------------------------------------------------------------------

class _Tally(TorchDispatchMode):
    """Over every aten op the step dispatches: the operand and result
    bytes, which arguments (by tensor identity) are read, and the live
    bytes of the storages the results create, with their peak. A view of
    an argument (a layer's slice of a stacked leaf) stands for it: the
    argument is read where an op that is not a view reads the view."""

    def __init__(self, args: Dict[int, int]):
        super().__init__()
        self.args, self.read = args, set()
        self.views: Dict[int, int] = {}     # view's id -> its argument's
        self.keep = []                      # the views, so ids stay unique
        self.bytes_accessed = 0
        self.live = self.peak = 0
        self.known = set()

    def know(self, tensors):
        for t in tensors:
            self.known.add(t.untyped_storage()._cdata)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        roots = [self.views.get(id(t), id(t)) for t in ins]
        roots = [r for r in roots if r in self.args]
        if func.is_view and roots:
            for t in outs:
                self.views[id(t)] = roots[0]
                self.keep.append(t)
        else:
            self.read.update(roots)
        self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            s = t.untyped_storage()
            if s._cdata in self.known:
                continue
            self.known.add(s._cdata)
            self.live += s.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, s.nbytes())
        return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _record(mesh: RecordingMesh, tally: _Tally, flops: int, outs,
            args: Dict[int, int], extra_arg_bytes: int, temp: int,
            t0: float) -> Dict[str, Any]:
    out_ts = [t for t in pytree.tree_leaves(outs) if isinstance(t, torch.Tensor)]
    arg_ids = {id(t) for t in out_ts} & set(args)
    argument = sum(args[i] for i in tally.read) + extra_arg_bytes
    output = sum(_nbytes(t) for t in out_ts)
    alias = sum(_nbytes(t) for t in out_ts if id(t) in arg_ids)
    return {"memory": {"argument_bytes": argument, "output_bytes": output,
                       "temp_bytes": temp, "alias_bytes": alias,
                       "peak_per_device_gib": round(
                           (argument + temp + output - alias) / 2**30, 3)},
            "cost": {"flops": float(flops),
                     "bytes_accessed": float(tally.bytes_accessed)},
            "collectives": mesh.recorder.summary(),
            "trace_s": round(time.time() - t0, 2)}


def trace_serve(api, prof: shd.ShardingProfile, mesh: RecordingMesh,
                kind: str, global_batch: int, seq_len: int) -> Dict[str, Any]:
    """One rank's serve step of a ``prefill`` cell (prompts of
    ``seq_len``, ``max_len`` the same) or a ``decode`` cell (a cache of
    ``seq_len`` positions, the token at its last) on ``meta`` inputs:
    the record's ``memory``, ``cost``, ``collectives`` and ``trace_s``."""
    t0 = time.time()
    cfg = api.cfg
    sh = serve_steps.serve_shardings(api, prof, mesh, global_batch, seq_len)
    params = unflatten_tree([
        (p, _meta(shape, t.dtype)) for (p, t), (_, shape) in zip(
            flatten_tree(sh["params_struct"]), flatten_tree(sh["params"]))])
    args = {id(t): _nbytes(t) for _, t in flatten_tree(params)}
    rows = math.prod(mesh.shape[a] for a in shd._axes(sh["batch"][0])) \
        if sh["batch"] else 1
    extra = 0
    if kind == "prefill":
        batch = {k: v for k, v in make_batch_struct(cfg, global_batch,
                                                    seq_len).items()
                 if k != "labels"}
        args.update({id(t): _nbytes(t) // rows for t in batch.values()})
        fn = serve_steps.build_prefill_step(api, prof, mesh, seq_len)

        def call():
            return fn(params, batch)
    else:
        token = _meta((global_batch,), torch.int32)
        local = serve_steps.local_cache_shapes(sh, mesh)
        cache = unflatten_tree([
            (p, _meta(local_shape, t.dtype)) for (p, t), (_, local_shape) in
            zip(flatten_tree(sh["cache_struct"]), flatten_tree(local))])
        args[id(token)] = _nbytes(token) // rows
        args.update({id(t): _nbytes(t) for _, t in flatten_tree(cache)})
        extra = 4 if cfg.family != "ssm" else 0   # the int32 position
        fn = serve_steps.build_decode_step(api, prof, mesh)

        def call():
            return fn(params, token, cache, seq_len - 1)
    tally = _Tally(args)
    tally.know([t for _, t in flatten_tree(params)])
    with FlopCounterMode(display=False) as fc, tally:
        outs = call()
    new_out = sum(_nbytes(t) for t in pytree.tree_leaves(outs)
                  if isinstance(t, torch.Tensor) and id(t) not in args)
    return _record(mesh, tally, fc.get_total_flops(), outs, args, extra,
                   max(0, tally.peak - new_out), t0)


@contextlib.contextmanager
def _shape_only_codec():
    """The codec's encode and recovery, and the top-k threshold's
    quantile, on ``meta`` payloads, as stand-ins of the real ones'
    shapes and dtypes (the sketch and words of one block encoded on the
    CPU, times the blocks); real payloads run the real functions."""
    real_c, real_r = HomomorphicCompressor.compress_wire, HomomorphicCompressor.recover
    real_q = topk_lib.quantile_linear

    def quantile_linear(sample, q):
        if sample.device.type != "meta":
            return real_q(sample, q)
        return _meta((), torch.float32)

    def compress_wire(self, x, block_offset=0):
        if x.device.type != "meta":
            return real_c(self, x, block_offset)
        one, mx = real_c(self, torch.zeros(self.cfg.block_elems), 0)
        nb = make_plan(x.numel(), self.cfg).nb
        return (CompressedLeaf(
            sketch=_meta((nb,) + tuple(one.sketch.shape[1:]), one.sketch.dtype),
            index_words=_meta((nb * one.index_words.numel(),),
                              one.index_words.dtype)),
                _meta((nb,), mx.dtype))

    def recover(self, comp, n, shape=None, with_stats=False, block_offset=0,
                dequant=None):
        if comp.sketch.device.type != "meta":
            return real_r(self, comp, n, shape, with_stats, block_offset, dequant)
        x = _meta(shape if shape is not None else (n,), torch.float32)
        if not with_stats:
            return x
        z = _meta((), torch.int64)
        return x, RecoveryStats(nnz=z, peeled=z, residual=z,
                                rounds=self.cfg.rounds)

    HomomorphicCompressor.compress_wire = compress_wire
    HomomorphicCompressor.recover = recover
    topk_lib.quantile_linear = quantile_linear
    try:
        yield
    finally:
        HomomorphicCompressor.compress_wire = real_c
        HomomorphicCompressor.recover = real_r
        topk_lib.quantile_linear = real_q


@contextlib.contextmanager
def _saved_bytes(known):
    """Counts (into the yielded one-entry list) the bytes of the
    storages autograd saves for the backward and of the tensor inputs a
    checkpointed unit keeps for its recompute, each storage once and
    none of ``known`` (the arguments)."""
    seen, total = set(known), [0]

    def count(t):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            if s._cdata not in seen:
                seen.add(s._cdata)
                total[0] += s.nbytes()
        return t

    real = ckpt_lib.checkpoint

    def checkpoint(fn, *args, **kwargs):
        for a in args:
            count(a)
        return real(fn, *args, **kwargs)

    ckpt_lib.checkpoint = checkpoint
    try:
        with torch.autograd.graph.saved_tensors_hooks(count, lambda t: t):
            yield total
    finally:
        ckpt_lib.checkpoint = real


def trace_train(api, tc, mesh: RecordingMesh, global_batch: int,
                seq_len: int) -> Dict[str, Any]:
    """One rank's train step (``tc`` with its workers set to the data
    group's) on a ``meta`` state and batch: the record's parts."""
    t0 = time.time()
    cfg = api.cfg
    group, model = mesh.data, mesh.model
    tc = dataclasses.replace(
        tc, workers=group.workers,
        dp_levels=tuple(group.levels) if len(group.levels) > 1 else ())
    whole = ParamTree(serve_steps.params_struct(api))
    state = train_step.init_train_state(api, tc, "meta", params=whole,
                                        group=group, model=model)
    step = train_step.build_train_step(api, tc, group=group, model=model)
    batch = make_batch_struct(cfg, global_batch, seq_len)
    leaves = (state.params.leaves() + [t for v in state.opt.values() for t in v]
              + [t for t in state.residual])
    args = {id(t): _nbytes(t) for t in leaves}
    args.update({id(t): _nbytes(t) // group.workers for t in batch.values()})
    tally = _Tally(args)
    tally.know(leaves)
    with _shape_only_codec(), _saved_bytes(set(tally.known)) as saved, \
            FlopCounterMode(display=False) as fc, tally:
        state, metrics = step(state, batch)
    outs = (state.params.leaves(), metrics)
    return _record(mesh, tally, fc.get_total_flops(), outs, args, 0,
                   saved[0], t0)


# ----------------------------------------------------------------------
# Cells
# ----------------------------------------------------------------------

def trace_cell(arch_name: str, shape_name: str, mesh_name: str
               ) -> Dict[str, Any]:
    """The traced parts of one cell's record at the mesh's first rank."""
    arch, shape = get_arch(arch_name), SHAPES[shape_name]
    api = model_api(arch.model)
    mesh = RecordingMesh(make_production_mesh(
        multi_pod=(mesh_name == "multi")).shape)
    if shape.kind == "train":
        return trace_train(api, arch.train, mesh, shape.global_batch,
                           shape.seq_len)
    return trace_serve(api, arch.profile, mesh, shape.kind,
                       shape.global_batch, shape.seq_len)


def run_cell(arch_name: str, shape_name: str, mesh_name: str,
             out_dir: str = ARTIFACT_DIR, force: bool = False
             ) -> Dict[str, Any]:
    mesh_dir = os.path.join(out_dir, mesh_name)
    os.makedirs(mesh_dir, exist_ok=True)
    out_path = os.path.join(mesh_dir, f"{arch_name}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            prev = json.load(f)
        if prev.get("status") in ("ok", "skip"):
            return prev           # errored cells are always retried
    arch, shape = get_arch(arch_name), SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params_total": arch.model.param_count(),
        "params_active": arch.model.active_param_count(),
        "aggregator": arch.train.aggregator,
    }
    ok, why = arch.shape_supported(shape)
    if not ok:
        rec.update(status="skip", reason=why)
    else:
        try:
            rec.update(trace_cell(arch_name, shape_name, mesh_name))
            rec["status"] = "ok"
        except Exception as e:                          # noqa: BLE001
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _run_one(job):
    arch, shape, mesh_name, out, force = job
    t0 = time.time()
    return run_cell(arch, shape, mesh_name, out, force), time.time() - t0


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR,
                    help="the records' directory (default: build/dryrun)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced side by side, one process each (a "
                         "32k prefill dispatches about a million ops on "
                         "meta: minutes a cell)")
    args = ap.parse_args(argv)
    if not args.all and not args.arch and not args.shape:
        ap.error("pass --arch/--shape or --all")
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    jobs = [(arch, shape, mesh_name, args.out, args.force)
            for mesh_name in meshes for arch in archs for shape in shapes]
    if args.jobs > 1:
        import multiprocessing as mp
        pool = mp.get_context("spawn").Pool(args.jobs)
        results = pool.imap(_run_one, jobs)
    else:
        pool, results = None, map(_run_one, jobs)
    try:
        for rec, secs in results:
            status = rec["status"]
            extra = ""
            if status == "ok":
                extra = (f"trace {rec['trace_s']}s "
                         f"mem {rec['memory']['peak_per_device_gib']}GiB "
                         f"flops {rec['cost']['flops']:.2e}")
            elif status == "error":
                extra = rec["error"][:120]
            print(f"[{rec['mesh']}] {rec['arch']:18s} {rec['shape']:12s} "
                  f"{status:5s} ({secs:.1f}s) {extra}", flush=True)
    finally:
        if pool is not None:
            pool.close()
            pool.join()


if __name__ == "__main__":
    main()
