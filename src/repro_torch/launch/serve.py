"""Serving launcher: batched greedy generation, the continuous batcher,
and the elastic aggregation service driven against the same model.

    # batch generate (greedy), then the continuous batcher over
    # 2 x batch requests
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --batch 8 --prompt-len 512 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --batch 8 --prompt-len 512 --max-new 64 --continuous

    # elastic: async sketch-fold rounds over an intermittent cohort, the
    # arch's parameter tree as the gradient template
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --layers 4 --elastic --cohort 4 --rounds 3 --wire fxp32 --straggle

``--smoke`` takes the arch's reduced config and ``--layers`` cuts the
depth, as in the train launcher. ``--shards`` folds through the
sharded service, each shard folding that many payloads a microbatch.
Everything runs on the card unless ``--device cpu``, where the codec
takes its kernels' plain PyTorch versions (serving runs no kernel).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def _clock(dev: torch.device) -> float:
    """Host seconds after the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


class RoundHooks:
    """A caller's view into :func:`run_elastic`'s rounds; each method
    does nothing here, and a subclass overrides what it checks."""

    def grads(self, rnd, client, shapes):
        """The gradient tree ``client`` contributes in round ``rnd``, or
        None for the Gaussian one; ``shapes`` is the template's ``(path,
        shape)`` list."""
        return None

    def before_close(self, rnd, server, contract, payloads):
        """Called once every payload of the round is submitted."""

    def after_close(self, rnd, server, stream, report):
        """Called with the round's recovered stream and report."""


def run_elastic(args, cfg, params, hooks=None):
    """Round-driven elastic aggregation over the arch's gradient tree.

    Each round opens a contract for the live cohort, has every client
    contribute a synthetic gradient of the model's own parameter shapes
    (Gaussian, from a ``torch.Generator`` on the run's device seeded with
    0), folds the payloads in client order (with an injected
    past-deadline straggler under ``args.straggle``) and closes at
    quorum or deadline. A client joins at round ``rounds // 2``, so the
    fxp32 wire re-prices its mantissa budget.

    ``hooks``, a :class:`RoundHooks`, is a caller's way to feed its own
    gradients and to check a round's folded state and recovered stream.
    Returns the server and a record a round
    (the report's counts, each client's propose ms, the fold and close ms,
    one payload's bytes, max |stream|).
    """
    from repro_torch.core.config import CompressionConfig
    from repro_torch.elastic import (AdmissionPolicy, ElasticClient,
                                     ElasticServer)
    from repro_torch.ft.failures import (FailureSimulator,
                                         SwitchRetransmitPolicy)
    from repro_torch.models.params import flatten_tree, unflatten_tree

    hooks = hooks or RoundHooks()
    dev = torch.device(args.device)
    template = params.tree()
    shapes = [(p, tuple(v.shape)) for p, v in flatten_tree(template)]
    ccfg = CompressionConfig(ratio=1.0, lanes=128, rows=6, rounds=10,
                             chunk_blocks=8, topk_ratio=0.1,
                             topk_exact=True, error_feedback=True,
                             wire_dtype=args.wire)
    policy = AdmissionPolicy(max_cohort=max(args.cohort + 1, 4),
                             quorum=0.5, deadline_s=args.deadline)
    sim = FailureSimulator(
        straggle_at=(((1, 0, args.deadline * 5),) if args.straggle else ()))
    srv = ElasticServer(template, ccfg, policy=policy,
                        retransmit=SwitchRetransmitPolicy(),
                        n_shards=args.shards, batch_size=args.shards,
                        device=dev)
    del template
    clients = {}

    def admit(c):
        srv.join(c)
        clients[c] = ElasticClient(c, ccfg, device=dev)

    for c in range(args.cohort):
        admit(c)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def grads(rnd, c):
        g = hooks.grads(rnd, c, shapes)
        return g if g is not None else unflatten_tree([
            (p, torch.randn(sh, generator=gen, device=dev)) for p, sh in shapes])

    fxp32 = ccfg.wire_dtype == "fxp32"
    records = []
    for rnd in range(args.rounds):
        if rnd == args.rounds // 2:    # membership churn mid-run
            admit(args.cohort)
        contract = srv.open_round()
        roster = contract.cohort
        propose_ms, payloads = [], {}
        for c in roster:
            g = grads(rnd, c)
            t = _clock(dev)
            if fxp32:
                prop = clients[c].propose(contract, g)
            else:
                payloads[c] = clients[c].contribute(contract, g)
            propose_ms.append((_clock(dev) - t) * 1e3)
            del g
            if fxp32:
                srv.submit_exponents(prop)
        if fxp32:
            shared = srv.seal_exponents()
            payloads = {c: clients[c].payload(contract, shared)
                        for c in roster}
        t0 = _clock(dev)
        for c in roster:
            arrival = 0.001 * (c + 1) + sim.client_delay(rnd, c)
            srv.submit(payloads[c], arrival_s=arrival)
        fold_ms = (_clock(dev) - t0) * 1e3
        hooks.before_close(rnd, srv, contract, payloads)
        t1 = _clock(dev)
        stream, rep = srv.close_round(now_s=args.deadline)
        close_ms = (_clock(dev) - t1) * 1e3
        hooks.after_close(rnd, srv, stream, rep)
        out_max = float(stream.abs().max())
        m = contract.mantissa_bits
        print(f"round {rep.round_id}: W={rep.workers} "
              f"wire={contract.wire_dtype}"
              f"{'' if m is None else f'/M={m}'} "
              f"folded={rep.folded} deferred={rep.deferred} "
              f"retransmits={rep.retransmits} close={rep.close_reason} "
              f"fold={fold_ms + close_ms:.1f}ms |out|={out_max:.3g}",
              flush=True)
        records.append({
            "round": rep.round_id, "workers": rep.workers,
            "wire": contract.wire_dtype, "mantissa_bits": m,
            "folded": rep.folded, "deferred": rep.deferred,
            "rejected_stale": rep.rejected_stale,
            "retransmits": rep.retransmits, "close": rep.close_reason,
            "residual_carried_in": rep.residual_carried_in,
            "windows": rep.windows, "occupancy_peak": rep.occupancy_peak,
            "propose_ms": propose_ms, "fold_ms": fold_ms,
            "close_ms": close_ms,
            "payload_bytes": next(iter(payloads.values())).nbytes,
            "out_absmax": out_max})
        del payloads, stream
    total = sum(r.folded + r.deferred for r in srv.reports)
    print(f"elastic: {len(srv.reports)} rounds, {total} payloads "
          f"accounted (0 lost)", flush=True)
    return srv, records


def run_serving(args, cfg, params):
    """The reference's batch and ``--continuous`` modes: ``args.batch``
    prompts of ``args.prompt_len`` tokens from ``default_rng(0)`` (for
    the encdec family then ``frames`` from the same generator, passed to
    ``generate``; the batcher passes none, and fails as the reference's
    does); batch
    generation of ``args.max_new`` tokens, or ``2 x batch`` requests
    (prompt ``u % batch``) through the continuous batcher for
    ``3 x max_new`` decode steps. ``max_len`` defaults to ``prompt_len +
    max_new + 8``. Prints the reference's lines, the clock read after a
    device synchronise. Returns the tokens, or the completions."""
    from repro_torch.models.registry import model_api
    from repro_torch.serve import ContinuousBatcher, Request, ServeEngine

    dev = torch.device(args.device)
    max_len = args.max_len or (args.prompt_len + args.max_new + 8)
    eng = ServeEngine(model_api(cfg), params, max_len=max_len,
                      batch=args.batch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            0, 1, (args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)

    if args.continuous:
        cb = ContinuousBatcher(eng)
        for u in range(args.batch * 2):
            cb.submit(Request(uid=u, prompt=prompts[u % args.batch],
                              max_new_tokens=args.max_new))
        t0 = _clock(dev)
        done = cb.run(decode_steps=args.max_new * 3)
        dt = _clock(dev) - t0
        toks = sum(len(c.tokens) for c in done)
        print(f"continuous: {len(done)} requests, {toks} tokens "
              f"in {dt:.2f}s ({toks/dt:.1f} tok/s)", flush=True)
        return done

    t0 = _clock(dev)
    out = eng.generate(prompts, max_new=args.max_new, extra=extra or None)
    dt = _clock(dev) - t0
    toks = out.size
    print(f"batch generate: {out.shape} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s)")
    print("first row:", out[0][:16].tolist(), flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut n_layers to this depth")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="drive the continuous batcher instead")
    ap.add_argument("--elastic", action="store_true",
                    help="run elastic aggregation rounds over the "
                         "arch's gradient tree instead of serving")
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--wire", choices=["f32", "fxp32"], default="f32")
    ap.add_argument("--deadline", type=float, default=1.0)
    ap.add_argument("--straggle", action="store_true",
                    help="inject one past-deadline straggler (deferred "
                         "into the next round's residual)")
    ap.add_argument("--shards", type=int, default=1,
                    help="fold through this many shard ranges, each "
                         "folding this many payloads a microbatch")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.model
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = model_api(cfg).init(0, args.device)
    if args.elastic:
        return run_elastic(args, cfg, params)
    return run_serving(args, cfg, params)


if __name__ == "__main__":
    main()
