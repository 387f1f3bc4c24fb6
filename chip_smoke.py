#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure ends the run non-zero):

1. device  — the card's name and power limit (nvidia-smi); TF32 off.
2. build   — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card,
   on 2048 blocks of the main path's geometry at offset block ids:
   dyadic inputs at 4% and 40% density bit for bit, Gaussian inputs to
   rtol=1e-5, atol=1e-6 (the plain version's ``index_add_`` sums in
   atomic order on the card), words and residual exactly; two runs of
   each kernel bit-identical. Then, dyadic and bit for bit, the lossless
   profile (rows 60, ratio 2) and G=120, whose state the kernels keep in
   device memory.
4. train   — granite-3-2b at full width, depth cut 40 -> 4, bf16, W=2
   data-parallel workers emulated on the card, global batch 8 x 1024
   tokens, aggregator ``compressed`` (ratio 0.1, top-k 4%), AdamW, one
   warm-up step and three timed steps. The launch counters are zeroed
   just before and read just after: the producer must have run W times
   per step and the consumer once.
5. breakdown — CUDA-event time of each stage of the step (forward and
   backward, sparsify + pack, producer, sum/OR, consumer, unpack,
   optimizer) at the step's shapes, beside the measured step time.
6. main stream — both kernels against their plain versions at the main
   path's shapes: one worker's whole 14,525-block stream into the
   producer, the sum/OR of two workers' payloads at 4% each into the
   consumer (Gaussian to rtol=1e-5, dyadic bit for bit); the kernel and
   plain times of the kernels line are taken here.
7. lossless — the compressed aggregate of dyadic gradients of the same
   model, through the kernels, equals the dense mean bit for bit at
   every coordinate the peel recovers.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a
CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
CHECK_BLOCKS = 2048
BIG_BLOCKS = 256               # blocks of each geometry with state in device memory
CHECK_OFFSET = 7000            # a block range inside the main path's stream
WORKERS, LAYERS, BATCH, SEQ, STEPS = 2, 4, 8, 1024, 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_blocks(cfg, nb, frac, kind, gen):
    import torch
    shape = (nb, cfg.group, cfg.lanes)
    dev = gen.device
    mask = torch.rand(shape, generator=gen, device=dev) < frac
    if kind == "dyadic":
        sign = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5,
                           -1.0, 1.0)
        e = torch.randint(-2, 3, shape, generator=gen, device=dev)
        vals = sign * torch.exp2(e.to(torch.float32))
    else:
        vals = torch.randn(shape, generator=gen, device=dev)
    return torch.where(mask, vals, torch.zeros((), device=dev))


class Checker:
    """Holds a kernel's outputs against its plain version's and keeps the
    largest absolute difference seen per kernel."""

    def __init__(self):
        self.err = {"encode_pack_quantize": 0.0, "dequant_peel_unpack": 0.0}

    def __call__(self, name, got, want, exact):
        import torch
        if exact:
            ok = torch.equal(got, want)
        else:
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
        if got.dtype.is_floating_point:
            self.err[name] = max(self.err[name], float((got - want).abs().max()))
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({'exact' if exact else 'rtol=1e-5'})")

    def producer(self, xb, ids, cfg, exact):
        """Producer kernel vs plain on ``xb``; returns the plain outputs."""
        from repro_torch.kernels import ops, ref
        want = ref.encode_pack_quantize_ref(xb, ids, cfg)
        got = ops.encode_pack_quantize(xb, ids, cfg)
        for g, w, ex in zip(got, want, (exact, True, exact)):
            self("encode_pack_quantize", g, w, ex)
        return want

    def consumer(self, sk, w, ids, cfg, exact):
        """Consumer kernel vs plain on one payload; returns the plain
        outputs."""
        from repro_torch.kernels import ops, ref
        want = ref.dequant_peel_unpack_ref(sk, w, ids, cfg)
        got = ops.dequant_peel_unpack(sk, w, ids, cfg)
        self("dequant_peel_unpack", got[0], want[0], exact)
        self("dequant_peel_unpack", got[1], want[1], True)
        return want


def phase_kernels(cfg, dev, check):
    """Kernel vs plain version on the card on 2048 blocks at offset ids,
    three input kinds, plus run-to-run repeatability; then the two
    geometries whose state outgrows shared memory."""
    import dataclasses as dc
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    nb = CHECK_BLOCKS
    ids = torch.arange(nb, dtype=torch.int32, device=dev) + CHECK_OFFSET
    for kind, frac in [("dyadic", 0.04), ("dyadic", 0.40), ("gauss", 0.04)]:
        xb = make_blocks(cfg, nb, frac, kind, gen)
        exact = kind == "dyadic"
        sk, w, _ = check.producer(xb, ids, cfg, exact)
        _, res = check.consumer(sk, w, ids, cfg, exact)
        if kind == "gauss":   # no atomics: a second run repeats bit for bit
            runs = [ops.encode_pack_quantize(xb, ids, cfg) for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError("producer is not run-to-run deterministic")
            runs = [ops.dequant_peel_unpack(sk, w, ids, cfg) for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError("consumer is not run-to-run deterministic")
        emit({"phase": "kernels", "case": f"{kind}@{frac}", "blocks": nb,
              "agree": True, "nnz": int(index_lib.popcount(w)),
              "residual": int(res.sum())})
    # State in device memory: the lossless profile (consumer) and G=120
    # (both kernels), dyadic, bit for bit.
    for big in (dc.replace(cfg, ratio=2.0, rows=60), dc.replace(cfg, ratio=0.05)):
        nbb = BIG_BLOCKS
        xb = make_blocks(big, nbb, 0.04, "dyadic", gen)
        idb = ids[:nbb]
        sk, w, _ = check.producer(xb, idb, big, True)
        _, res = check.consumer(sk, w, idb, big, True)
        emit({"phase": "kernels", "case": f"dyadic@0.04 rows={big.rows} "
              f"G={big.group}", "blocks": nbb, "agree": True,
              "nnz": int(index_lib.popcount(w)), "residual": int(res.sum())})


def phase_main_stream(cfg, dev, n_blocks, check):
    """Both kernels against their plain versions at the main path's shapes:
    one worker's whole granite-3-2b stream (``n_blocks`` blocks) into the
    producer, and the sum/OR of two workers' payloads into the consumer.
    Gaussian inputs at 4% (one worker, both kernels) to rtol=1e-5; dyadic
    inputs at 4% per worker bit for bit, for the producer per worker and
    for the consumer on the aggregate. Kernel and plain times are taken on
    the dyadic inputs; returns the per-kernel records."""
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.core.peeling import peel_blocks
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    nb = n_blocks
    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    xb = make_blocks(cfg, nb, 0.04, "gauss", gen)
    sk, w, _ = check.producer(xb, ids, cfg, False)
    check.consumer(sk, w, ids, cfg, False)
    del xb, sk, w
    torch.cuda.empty_cache()

    group = LocalWorkers(WORKERS)
    xs = [make_blocks(cfg, nb, 0.04, "dyadic", gen) for _ in range(WORKERS)]
    enc = [check.producer(x, ids, cfg, True) for x in xs]
    sk = group.sum([e[0] for e in enc])
    w = group.bor([e[1] for e in enc])
    del enc
    _, res = check.consumer(sk, w, ids, cfg, True)
    x0 = xs[0]
    del xs
    torch.cuda.empty_cache()

    G, c, R = cfg.group, cfg.lanes, cfg.rows
    n_el = nb * G * c
    nnz0 = int((x0 != 0).sum())
    nnz = int(index_lib.popcount(w))
    n_res = int(res.sum())
    rounds = peel_blocks(sk, index_lib.unpack_bits(w.reshape(-1), (nb, G, c)),
                         ids, cfg).rounds_used
    emit({"phase": "main_stream", "blocks": nb, "workers": WORKERS,
          "agree": True, "worker0_nnz": nnz0, "aggregate_nnz": nnz,
          "aggregate_density": nnz / n_el, "peeled": nnz - n_res,
          "estimated": n_res, "plain_rounds_to_fixpoint": rounds})
    enc_bytes = n_el * 4 + nb * 4 + nb * R * c * 4 + n_el // 8 + nb * 4
    dec_bytes = nb * R * c * 4 + n_el // 8 + nb * 4 + n_el * 4 + n_el
    # data-dependent work: sign x value + add per (non-zero, hash), the
    # max over the sketch and the non-zero test for the bitmap; the peel's
    # initial degrees, one degree test per (set bit, hash, round) until the
    # fixpoint, 9 ops per peeled element (3 sign products, 3 subtractions,
    # 3 decrements) and 10 per median estimate
    enc_ops = 6 * nnz0 + nb * R * c + n_el
    dec_ops = 3 * nnz + 3 * nnz * rounds + 9 * (nnz - n_res) + 10 * n_res

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    recs = []
    for name, kfn, pfn, nbytes, nops, replaces in [
        ("encode_pack_quantize",
         lambda: ops.encode_pack_quantize(x0, ids, cfg),
         lambda: ref.encode_pack_quantize_ref(x0, ids, cfg), enc_bytes, enc_ops,
         "src/repro/kernels/sketch_wire.py:188"),
        ("dequant_peel_unpack",
         lambda: ops.dequant_peel_unpack(sk, w, ids, cfg),
         lambda: ref.dequant_peel_unpack_ref(sk, w, ids, cfg), dec_bytes, dec_ops,
         "src/repro/kernels/sketch_wire.py:251"),
    ]:
        b_ms, b_by = bound(nbytes, nops)
        recs.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/sketch_wire.cu",
                     "replaces": replaces, "launches": None,
                     "max_abs_err": check.err[name], "ms": cuda_ms(kfn, 10),
                     "plain_ms": cuda_ms(pfn, 5, warmup=1), "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "blocks": nb,
                     "bytes": nbytes, "ops": nops})
    del x0, sk, w
    torch.cuda.empty_cache()
    return recs


def phase_train(dev):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training

    arch = get_arch("granite-3-2b")
    mcfg = dataclasses.replace(arch.model, n_layers=LAYERS)
    tc = dataclasses.replace(arch.train, workers=WORKERS, accum_steps=1,
                             remat="none")
    api = model_api(mcfg)
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    res = run_training(api, tc, global_batch=BATCH, seq_len=SEQ, steps=STEPS,
                       device=dev, log_every=0)
    launches = dict(ops.LAUNCHES)
    want = {"encode_pack_quantize": WORKERS * STEPS, "dequant_peel_unpack": STEPS}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not all(torch.isfinite(torch.tensor(res.losses))):
        raise AssertionError(f"non-finite loss: {res.losses}")
    last = res.metrics[-1]
    if last["recovery_nnz"] != last["recovery_peeled"] + last["recovery_residual"]:
        raise AssertionError("recovery stats do not add up")
    n_params = sum(p.numel() for p in res.state.params.leaves())
    out = {"phase": "train", "arch": "granite-3-2b", "dtype": mcfg.dtype,
           "params": n_params,
           "reduced": {"n_layers": f"{arch.model.n_layers} -> {LAYERS}"},
           "workers": WORKERS, "global_batch": BATCH, "seq_len": SEQ,
           "aggregator": tc.aggregator, "steps": STEPS, "warmup_steps": 1,
           "step_ms": [s * 1e3 for s in res.step_seconds[1:]],
           "warmup_ms": res.step_seconds[0] * 1e3,
           "losses": res.losses, "launches": launches,
           "recovery": [{k[len("recovery_"):]: int(m[k]) for k in m
                         if k.startswith("recovery_")} for m in res.metrics],
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    return out, launches, api, tc, res.state


def phase_breakdown(api, tc, state, step_ms, dev):
    """CUDA-event time of each stage of the train step, run one at a time
    on the trained state at the step's shapes (median of 5), so the
    stages can be set against the measured step time."""
    import torch
    from repro_torch.core.aggregators import sparsify_leaf
    from repro_torch.core.bucketing import make_bucket_plan
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.core.compressor import CompressedLeaf, HomomorphicCompressor
    from repro_torch.data.pipeline import batch_fn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import device_batch

    cfg, W = tc.compression, tc.workers
    params = state.params
    leaves = params.leaves()
    host = batch_fn(api.cfg, BATCH, SEQ, seed=tc.seed)(0)
    batch = device_batch(host, dev)
    per = BATCH // W

    def fwd_bwd(w=0):
        rows = {k: v[w * per: (w + 1) * per] for k, v in batch.items()}
        loss, _ = api.loss(params.tree(), rows)
        return torch.autograd.grad(loss, leaves)

    grads_w = [fwd_bwd(w) for w in range(W)]
    grads = grads_w[0]
    plan = make_bucket_plan(grads, cfg)
    comp = HomomorphicCompressor(cfg)
    group = LocalWorkers(W)
    with torch.no_grad():
        def sparsify_pack(w=0):
            return plan.pack_flat([
                sparsify_leaf(g.reshape(-1).float(), r[w], cfg)[0]
                for g, r in zip(grads_w[w], state.residual)]).reshape(-1)
        streams = [sparsify_pack(w) for w in range(W)]
        stream = streams[0]
        cs = [comp.compress(s) for s in streams]
        c = cs[0]
        sk = group.sum([x.sketch for x in cs])
        wd = group.bor([x.index_words for x in cs])
        agg = CompressedLeaf(sketch=sk, index_words=wd)
        rec = comp.recover(agg, plan.padded)
        agg_leaves = plan.unpack(rec.reshape(plan.n_buckets, plan.bucket_elems) / W)
        lr = opt_lib.lr_schedule(state.step, tc.optimizer, dev)

        def optimizer():
            for i, (p, g) in enumerate(zip(leaves, agg_leaves)):
                st = {k: state.opt[k][i] for k in state.opt}
                opt_lib.opt_leaf_update(p, g, st, lr, state.step, tc.optimizer)

        stages = {
            "sparsify_pack": (W, cuda_ms(sparsify_pack, 5, 1)),
            "producer": (W, cuda_ms(lambda: comp.compress(stream), 5, 1)),
            "sum_or": (1, cuda_ms(lambda: (group.sum([x.sketch for x in cs]),
                                           group.bor([x.index_words for x in cs])),
                                  5, 1)),
            "consumer": (1, cuda_ms(lambda: comp.recover(agg, plan.padded), 5, 1)),
            "unpack": (1, cuda_ms(lambda: plan.unpack(
                rec.reshape(plan.n_buckets, plan.bucket_elems) / W), 5, 1)),
            "optimizer": (1, cuda_ms(optimizer, 5, 1)),
        }
        # what worker 0 sends of each leaf: explains the sketch's load
        sent = {"/".join(path): float((sparsify_leaf(
                    g.reshape(-1).float(), r[0], cfg)[0] != 0).float().mean())
                for path, g, r in zip(params.paths, grads, state.residual)}
    stages = {"forward_backward": (W, cuda_ms(fwd_bwd, 5, 1)), **stages}
    total = sum(n * ms for n, ms in stages.values())
    out = {"phase": "breakdown", "step_ms_median": statistics.median(step_ms),
           "stages_ms": {k: {"per_call": ms, "calls": n, "per_step": n * ms}
                         for k, (n, ms) in stages.items()},
           "sum_of_stages_ms": total, "worker0_sent_fraction": sent}
    emit(out)
    return out


def phase_lossless(mcfg, tc, dev):
    """Dyadic per-worker gradients at 1.5% density: every coordinate the
    kernels' peel recovers equals the dense mean bit for bit. Peeling is
    exact only with high probability: at ~0.3 non-zeros per sketch cell a
    few pairs of coordinates still share all three cells somewhere among
    the 14,525 blocks, and those fall back to the median estimate. So the
    coordinates that differ must be no more than the estimate's count,
    and that count a ten-thousandth of the non-zeros at most."""
    import torch
    from repro_torch.core.aggregators import make_aggregator
    from repro_torch.core.collectives import AggregationState, LocalWorkers
    from repro_torch.models.registry import model_api

    params = model_api(mcfg).init(0, dev)
    shapes = [tuple(p.shape) for p in params.leaves()]
    del params
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    group = LocalWorkers(WORKERS)
    grads_w = []
    for _ in range(WORKERS):
        leaves = []
        for sh in shapes:
            mask = torch.rand(sh, generator=gen, device=dev) < 0.015
            e = torch.randint(-2, 3, sh, generator=gen, device=dev)
            sign = torch.where(torch.rand(sh, generator=gen, device=dev) < 0.5,
                               -1.0, 1.0)
            leaves.append(torch.where(mask, sign * torch.exp2(e.float()),
                                      torch.zeros((), device=dev)))
        grads_w.append(leaves)
    residual = [torch.zeros((WORKERS,) + sh, device=dev) for sh in shapes]
    agg = make_aggregator("compressed", tc.compression, group)
    out, st = agg(grads_w, AggregationState(residual=residual))
    dense = make_aggregator("dense", tc.compression, group)(
        grads_w, AggregationState(residual=None))[0]
    differ = sum(int((a != b).sum()) for a, b in zip(out, dense))
    nnz, n_est = int(st.stats.nnz), int(st.stats.residual)
    if differ > n_est or n_est * 10_000 > nnz:
        raise AssertionError(
            f"{differ} coordinates differ from the dense mean, {n_est} of "
            f"{nnz} fell back to the estimate")
    emit({"phase": "lossless", "nnz": nnz, "peeled": int(st.stats.peeled),
          "estimated": n_est, "differ_from_dense": differ,
          "peeled_equal_bit_for_bit": True})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.config import CompressionConfig
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    t0 = time.perf_counter()
    for name in build.SOURCES:
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: v["ptxas"] for k, v in build.BUILD_LOG.items()}})

    cfg = CompressionConfig(ratio=0.1, topk_ratio=0.04)
    check = Checker()
    phase_kernels(cfg, dev, check)
    torch.cuda.empty_cache()

    train, launches, api, tc, state = phase_train(dev)
    phase_breakdown(api, tc, state, train["step_ms"], dev)
    del state
    torch.cuda.empty_cache()
    n = train["params"]
    n_blocks = cfg.num_buckets(n) * cfg.bucket_elems_for(n) // cfg.block_elems
    recs = phase_main_stream(cfg, dev, n_blocks, check)
    for r in recs:
        r["launches"] = launches[r["name"]]
    phase_lossless(api.cfg, tc, dev)

    emit({"kernels": recs})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
