"""W data-parallel ranks as spawned processes.

    results = spawn_ranks(fn, world, args, device="cuda", timeout=600)

starts ``world`` processes with the ``spawn`` method (never ``fork``: the
caller may have CUDA up), joins them in one ``torch.distributed`` process
group through a ``file://`` rendezvous in a temporary directory, and
returns each rank's ``fn(group, device, *args)`` in rank order, where
``group`` is the rank's :class:`ProcessGroupWorkers` on ``levels``; with
``model_parallel=MP`` it is the rank's
:class:`~repro_torch.launch.mesh.RankMesh` on a grid of ``world / MP``
data-parallel indices times MP model ones (its ``data`` group on
``levels``).
``fn`` must be a module-level function and its result picklable (send
numbers or numpy arrays back, not tensors).

Placement (:func:`placement`): on the CPU, gloo; with CUDA, NCCL and each
rank on its own ``cuda:r`` where there are as many cards, else gloo with
every rank on ``cuda:0`` (NCCL refuses two ranks on one device).

No failure hangs: a rank that raises sends its traceback to the parent,
which ends every rank and raises; so does a rank that dies without a
word, and a run past ``timeout`` seconds, which is also each rank's
collective timeout.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist


def placement(world: int, device) -> Tuple[str, List[str]]:
    """(backend, each rank's device) for ``world`` ranks on ``device``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo", ["cpu"] * world
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if torch.cuda.device_count() >= world:
        return "nccl", [f"cuda:{r}" for r in range(world)]
    return "gloo", ["cuda:0"] * world


def _rank_main(rank, world, init_file, backend, device, levels,
               model_parallel, timeout, threads, fn, args, results):
    from repro_torch.core.collectives import ProcessGroupWorkers
    from repro_torch.launch.mesh import make_host_mesh
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        group = (ProcessGroupWorkers(levels) if model_parallel is None
                 else make_host_mesh(model_parallel, levels))
        out = fn(group, dev, *args)
        dist.barrier()       # no rank leaves while a peer still sends
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _collect(procs, results, world, deadline):
    got = {}
    while len(got) < world:
        try:
            rank, err, out = results.get(timeout=1.0)
        except queue_lib.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in got]
            if dead:
                try:        # its traceback may still be on its way
                    rank, err, out = results.get(timeout=5.0)
                except queue_lib.Empty:
                    raise RuntimeError(
                        f"rank {dead[0][0]} exited with code {dead[0][1]} "
                        "and sent no result") from None
            elif time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(got))} sent no "
                    "result within the timeout")
            else:
                continue
        if err is not None:
            raise RuntimeError(f"rank {rank} failed:\n{err}")
        got[rank] = out
    return [got[r] for r in range(world)]


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), *,
                device="cuda", levels: Sequence[int] = (),
                model_parallel: int | None = None,
                timeout: float = 600.0, init_dir=None,
                threads: int | None = None,
                backend: str | None = None) -> list:
    """Run ``fn(group, device, *args)`` on ``world`` spawned ranks and
    return their results in rank order; raises if any rank raises, dies
    or outlasts ``timeout``. ``model_parallel``: hand ``fn`` the rank's
    ``RankMesh`` on that many model ranks instead of its group.
    ``device``: the card by default (see
    :func:`placement`), ``"cpu"`` for gloo ranks on the CPU. ``init_dir``: where the rendezvous file's
    temporary directory goes (default: the system's). ``threads``: each
    rank's intra-op CPU threads (default: this process's cores shared
    out over the ranks; W ranks each spinning on all cores run an order
    of magnitude slower). ``backend`` replaces the placement's backend
    on the same devices (to probe what a backend refuses)."""
    placed, devices = placement(world, device)
    backend = backend or placed
    if threads is None:
        threads = max(1, len(os.sched_getaffinity(0)) // world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(dir=init_dir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main, name=f"rank{r}",
            args=(r, world, init_file, backend, devices[r], tuple(levels),
                  model_parallel, timeout, threads, fn, tuple(args),
                  results))
            for r in range(world)]
        try:
            for p in procs:
                p.start()
            out = _collect(procs, results, world, deadline)
            for r, p in enumerate(procs):
                p.join(max(1.0, deadline - time.monotonic()))
                if p.is_alive() or p.exitcode != 0:
                    raise RuntimeError(f"rank {r} did not exit cleanly "
                                       f"(exit code {p.exitcode})")
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                if p.pid is None:
                    continue            # never started
                p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
