"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --layers 4 --workers 2 --steps 4 --global-batch 8 --seq-len 1024 \
        --aggregator compressed_innet --wire fxp32

Trains the named architecture at its published widths (``--layers`` cuts
the depth; ``--smoke`` takes the reduced same-family config instead) with
``--workers`` data-parallel workers emulated on one device (or run as
``--procs`` processes, below), and prints a
JSON summary. ``--aggregator`` picks the strategy and ``--wire`` the
in-network tier's wire (``f32``, or ``fxp32``: the sketch quantized to
shared-exponent int32 for the switch). ``--index bloom`` swaps the
bitmap for the Bloom-filter index (the standalone encode and peel
kernels), best with a small ``--topk-ratio`` such as 0.001, the extreme
sparsity the filter is sized for. ``--accum-steps`` defaults to 1:
the config's microbatch count is sized for the reference's pod-scale
global batch, and a small batch split over the workers cannot take it.
``--overlap`` streams the compressed wire bucket by bucket (the
reference's finest aligned grid), ``--stream-chunks N`` cuts it into N
chunks; ``--aggregator compressed_rs`` takes the reduce-scatter wire
(``--rs-wire`` native or emulated), and ``--aggregator auto`` executes
the cost model's analytic wire plan (a pure function of the config and
the shapes, so every rank of ``--procs`` computes the same one). The
optimizer update is sliced over the workers (ZeRO-1, the default) unless
``--no-zero1``. ``--bucket-bytes`` sets the bucket size (a
smoke model's stream is one bucket at the default 4 MiB). ``--device cpu`` runs the plain PyTorch
versions of the codec kernels.

As the reference's launcher: ``--steps`` defaults to 100,
``--compression-ratio`` sets the sketch's ratio, and ``--ckpt-dir``
checkpoints every ``--ckpt-every`` steps (default 50) and resumes from
the latest checkpoint there (with ``--procs`` too: the checkpoint is the
same whatever the layout). ``--smoke`` also turns remat off (the
config's default is ``block``).

``--arch deepseek-moe-16b`` trains the MoE family; ``--ep-exchange
{none,dense,compressed}`` picks the wire of its expert-parallel combine
and ``--ep-workers N`` the EP ranks each worker's forward emulates
(on ranks the EP ranks are the model ranks of ``--model-parallel``,
below; ``--procs`` with another ``--ep-workers`` above 1 raises).

``--procs W`` runs the W workers as W spawned processes, one rank each
(:mod:`repro_torch.launch.ranks`): gloo where the ranks share a device
(the CPU, or one card), NCCL with rank r on ``cuda:r`` where there are W
cards. The summary printed is rank 0's; a rank that fails, or a run
past ``--timeout`` seconds, ends the launch with an error.

``--procs P --model-parallel N`` runs a grid of ``W = P/N``
data-parallel workers times N model ranks (``launch/mesh.py``), for
every arch: the dense, attention, Mamba-head and vocab dims and the
routed experts split over the model axis as the arch's sharding profile
says, each model rank aggregating its own shard-local gradients over its
W data-parallel peers; a MoE's ``--ep-exchange`` then runs over the
model ranks. kimi-k2's profile (no DP axes) runs the reference's pure
auto-sharded step instead: the routed experts split over the W data
ranks, their ``d_ff`` over the model ranks, the gradient the whole
global batch's, dense whatever ``--aggregator`` says. One process
cannot hold a model axis: ``--model-parallel`` above 1 needs
``--procs``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def _train(mesh, device, args):
    """Train as ``args`` say on ``device``: every worker here (``mesh``
    None), or this rank's of the grid ``mesh`` (a ``RankMesh``). Returns
    the summary."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.model
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tc = dataclasses.replace(arch.train, workers=args.workers)
    if args.aggregator:
        tc = dataclasses.replace(tc, aggregator=args.aggregator)
    fields = {k: v for k, v in (("wire_dtype", args.wire),
                                ("index", args.index),
                                ("topk_ratio", args.topk_ratio),
                                ("overlap", args.overlap),
                                ("stream_chunks", args.stream_chunks),
                                ("rs_wire", args.rs_wire),
                                ("bucket_bytes", args.bucket_bytes),
                                ("ratio", args.compression_ratio)) if v}
    tc = dataclasses.replace(tc, compression=dataclasses.replace(
        tc.compression, **fields))
    tc = dataclasses.replace(tc, accum_steps=args.accum_steps,
                             ep_exchange=args.ep_exchange,
                             ep_workers=args.ep_workers)
    if args.smoke:
        tc = dataclasses.replace(tc, remat="none")
    if args.zero1 is not None:
        tc = dataclasses.replace(tc, zero1=args.zero1)
    if args.lr:
        tc = dataclasses.replace(tc, optimizer=dataclasses.replace(
            tc.optimizer, lr=args.lr, total_steps=args.steps))
    quiet = mesh is not None and mesh.rank != 0
    res = run_training(model_api(cfg), tc, global_batch=args.global_batch,
                       seq_len=args.seq_len, steps=args.steps,
                       device=device,
                       group=None if mesh is None else mesh.data,
                       model=None if mesh is None else mesh.model,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       log_every=0 if quiet else 10,
                       log_fn=(lambda _: None) if quiet else print)
    return {
        "arch": args.arch, "layers": cfg.n_layers, "workers": tc.workers,
        "procs": args.procs or 1, "model_parallel": args.model_parallel,
        "aggregator": tc.aggregator, "wire": tc.compression.wire_dtype,
        "index": tc.compression.index,
        "topk_ratio": tc.compression.topk_ratio,
        "overlap": tc.compression.overlap,
        "stream_chunks": tc.compression.stream_chunks,
        "rs_wire": tc.compression.rs_wire, "zero1": tc.zero1,
        "ep_exchange": tc.ep_exchange, "ep_workers": tc.ep_workers,
        "ratio": tc.compression.ratio, "remat": tc.remat,
        "device": args.device, "ckpt_dir": args.ckpt_dir,
        "first_loss": res.losses[0] if res.losses else None,
        "last_loss": res.losses[-1] if res.losses else None,
        "losses": res.losses, "restarts": res.restarts,
        "final_step": res.final_step, "steps": res.final_step,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut n_layers to this depth")
    ap.add_argument("--workers", type=int, default=None,
                    help="data-parallel workers W (default 2, or --procs)")
    ap.add_argument("--procs", type=int, default=None,
                    help="run the W workers as this many processes")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model ranks a data-parallel worker (needs "
                    "--procs; W = procs / this)")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds the spawned ranks may take in all")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--aggregator",
                    choices=["dense", "compressed", "compressed_rs",
                             "compressed_innet", "auto"],
                    default=None)
    ap.add_argument("--compression-ratio", type=float, default=None,
                    help="sketch size over the stream's size")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here, and resume from the latest")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--wire", choices=["f32", "fxp32"], default=None,
                    help="the in-network tier's sketch wire")
    ap.add_argument("--index", choices=["bitmap", "bloom"], default=None,
                    help="the non-zero index of the compressed wire")
    ap.add_argument("--topk-ratio", type=float, default=None,
                    help="share of each leaf a worker sends")
    ap.add_argument("--overlap", action="store_true",
                    help="stream the compressed wire chunk by chunk")
    ap.add_argument("--stream-chunks", type=int, default=None,
                    help="cut the compressed wire into this many chunks")
    ap.add_argument("--rs-wire", choices=["auto", "native", "emulate"],
                    default=None, help="compressed_rs: the wire it takes")
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="f32 bytes a bucket (the unit a chunk holds whole)")
    ap.add_argument("--zero1", action=argparse.BooleanOptionalAction,
                    default=None, help="slice the optimizer update over "
                    "the workers (default: the train config's)")
    ap.add_argument("--ep-exchange", choices=["none", "dense", "compressed"],
                    default="none", help="wire of the MoE expert-parallel "
                    "combine")
    ap.add_argument("--ep-workers", type=int, default=1,
                    help="EP ranks each data-parallel worker emulates")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    mp = args.model_parallel
    if mp < 1:
        ap.error(f"--model-parallel {mp}: must be >= 1")
    if args.procs is not None:
        if args.procs % mp:
            ap.error(f"--procs {args.procs} does not split into "
                     f"--model-parallel {mp}")
        if args.workers not in (None, args.procs // mp):
            ap.error(f"--workers {args.workers} with --procs {args.procs} "
                     f"--model-parallel {mp}: one worker a data index")
        args.workers = args.procs // mp
    elif mp > 1:
        ap.error(f"--model-parallel {mp} needs --procs: one process cannot "
                 "hold a model axis")
    elif args.workers is None:
        args.workers = 2

    if args.procs:
        from repro_torch.launch.ranks import spawn_ranks
        summary = spawn_ranks(_train, args.procs, (args,),
                              device=args.device, timeout=args.timeout,
                              model_parallel=mp)[0]
    else:
        summary = _train(None, args.device, args)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
