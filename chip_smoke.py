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

The in-network slice (``aggregator="compressed_innet"``, fxp32 wire):

8. kernels_q — the quantize producer and dequant consumer legs against
   their plain versions on 2048 blocks at offset ids, with W=2 exponents
   from the f32 producer's real maxabs: dyadic inputs at 4% and 40%
   bit for bit; Gaussian inputs with q within one step of the plain q
   plus phase 3's f32 tolerance at the block's scale, values to
   rtol=1e-5, atol=1e-6; words and residual exactly; on every input
   each leg equals its f32 kernel composed with ``FixedPointWire``'s
   ``encode``/``decode`` bit for bit. Then dyadic, bit for bit, in the
   two geometries whose state lives in device memory.
9. innet_train — the train of phase 4 through ``compressed_innet`` with
   ``wire_dtype="fxp32"`` (flat tree, 8 switch slots): per step W f32
   producer launches, one dequant consumer launch, no plain consumer and
   no quantize-leg launch; then its stage breakdown, with "exponents +
   quantize" and the windowed tree in place of the sum/OR.
10. innet_stream — at the full stream: two workers' 4% dyadic payloads,
    per-bucket exponents agreed over both, each quantized through the
    quantize leg (bit for bit with its plain version), the windowed tree
    (equal to the flat sum/OR), the dequant consumer on the aggregate
    (bit for bit); the kernel and plain times of both legs.
11. switch — the same two int32 sketches and word streams through the
    numpy ``SwitchModel`` (ports W, 8 slots): its sums equal the on-card
    tree bit for bit and its window report equals
    ``Topology.window_profile``.
12. innet_lossless — dyadic dense gradients of the same model in the
    lossless profile (rows 60, ratio 2): the fxp32 in-network aggregate
    equals the ``compressed`` aggregate bit for bit everywhere and the
    dense mean at every coordinate the peel recovers.

Then the ``{"kernels": [...]}`` line (all four kernel legs), the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. There is no
CPU fallback: without a CUDA device the script exits non-zero before
printing a result.
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
        self.err = {"encode_pack_quantize": 0.0, "dequant_peel_unpack": 0.0,
                    "encode_pack_quantize_q": 0.0, "dequant_peel_unpack_dq": 0.0}
        self.q_steps = 0       # largest |q_kernel - q_plain| of a case (Gaussian)

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

    def producer_q(self, xb, ids, cfg, f32, wire, e, exact):
        """Quantize leg vs plain on ``xb``, and vs the f32 kernel's outputs
        ``f32`` composed with ``wire.encode`` (bit for bit on any input).
        On Gaussian inputs the plain version's f32 sketch (summed in
        atomic order) differs from the kernel's within phase 3's rtol=1e-5,
        atol=1e-6, and an ulp of a cell near the block's max is 2^(M-24)
        steps of q: q must lie within one step of the plain q plus that
        tolerance at the block's scale. Returns the kernel's outputs."""
        import torch
        from repro_torch.kernels import ops, ref
        from repro_torch.net.fixedpoint import pow2
        name, M, nb = "encode_pack_quantize_q", wire.mantissa_bits, xb.shape[0]
        got = ops.encode_pack_quantize(xb, ids, cfg, exponents=e, mantissa_bits=M)
        sk, w, mx = f32
        self(name, got[0].reshape(nb, -1), wire.encode(sk.reshape(nb, -1), e), True)
        self(name, got[1], w, True)
        self(name, got[2], mx, True)
        want = ref.encode_pack_quantize_ref(xb, ids, cfg, exponents=e,
                                            mantissa_bits=M)
        self(name, got[1], want[1], True)
        self(name, got[2], want[2], exact)
        if exact:
            self(name, got[0], want[0], True)
        else:
            dq = (got[0] - want[0]).abs()
            steps = ((1e-5 * sk.abs() + 1e-6).reshape(nb, -1)
                     * pow2(M - e)[:, None]).reshape(dq.shape)
            if not bool((dq <= steps + 1).all()):
                raise AssertionError(f"{name}: q off the plain q by more than "
                                     "one step plus the f32 tolerance")
            self.q_steps = max(self.q_steps, int(dq.max()))
            dec = lambda q: wire.decode(q.reshape(nb, -1), e)
            self.err[name] = max(self.err[name],
                                 float((dec(got[0]) - dec(want[0])).abs().max()))
        return got

    def consumer_dq(self, q, w, ids, cfg, wire, e, exact):
        """Dequant leg vs plain on one int32 aggregate, and vs
        ``wire.decode`` composed with the f32 kernel (bit for bit on any
        input)."""
        from repro_torch.kernels import ops, ref
        name, M, nb = "dequant_peel_unpack_dq", wire.mantissa_bits, q.shape[0]
        got = ops.dequant_peel_unpack(q, w, ids, cfg, exponents=e, mantissa_bits=M)
        y = wire.decode(q.reshape(nb, -1), e).reshape(q.shape)
        composed = ops.dequant_peel_unpack(y, w, ids, cfg)
        self(name, got[0], composed[0], True)
        self(name, got[1], composed[1], True)
        want = ref.dequant_peel_unpack_ref(q, w, ids, cfg, exponents=e,
                                           mantissa_bits=M)
        self(name, got[0], want[0], exact)
        self(name, got[1], want[1], True)
        return got


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


def phase_kernels_q(cfg, dev, check):
    """The fxp32 legs against their plain versions on 2048 blocks at
    offset ids, with the W=2 exponents the in-network aggregator would
    agree on from the f32 producer's maxabs; then the two geometries
    whose state outgrows shared memory, dyadic, bit for bit."""
    import dataclasses as dc
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.kernels import ops
    from repro_torch.net.fixedpoint import FixedPointWire

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    group, wire = LocalWorkers(WORKERS), FixedPointWire(WORKERS)
    ids = torch.arange(CHECK_BLOCKS, dtype=torch.int32, device=dev) + CHECK_OFFSET
    cases = [(cfg, CHECK_BLOCKS, kind, frac) for kind, frac in
             [("dyadic", 0.04), ("dyadic", 0.40), ("gauss", 0.04)]]
    cases += [(big, BIG_BLOCKS, "dyadic", 0.04) for big in
              (dc.replace(cfg, ratio=2.0, rows=60), dc.replace(cfg, ratio=0.05))]
    for c, nb, kind, frac in cases:
        exact = kind == "dyadic"
        check.q_steps = 0
        xs = [make_blocks(c, nb, frac, kind, gen) for _ in range(WORKERS)]
        f32 = [ops.encode_pack_quantize(x, ids[:nb], c) for x in xs]
        e = wire.exponents_from_maxabs(group.max([f[2] for f in f32]))
        qs = [check.producer_q(x, ids[:nb], c, f, wire, e, exact)
              for x, f in zip(xs, f32)]
        q = group.sum([g[0] for g in qs])
        w = group.bor([g[1] for g in qs])
        _, res = check.consumer_dq(q, w, ids[:nb], c, wire, e, exact)
        emit({"phase": "kernels_q", "case": f"{kind}@{frac} rows={c.rows} "
              f"G={c.group}", "blocks": nb, "workers": WORKERS,
              "mantissa_bits": wire.mantissa_bits, "agree": True,
              "exponent_range": [int(e.min()), int(e.max())],
              "max_q_steps_vs_plain": check.q_steps,
              "nnz": int(index_lib.popcount(w)), "residual": int(res.sum())})


def bound(nbytes, nops):
    """(ms, what bounds it): bytes over the HBM rate, operations over the
    float32 rate, the larger of the two."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


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


def phase_train(dev, phase="train", wire="f32"):
    """The main path: ``compressed`` (``wire="f32"``) or, with
    ``wire="fxp32"``, ``compressed_innet`` on the fxp32 wire. The launch
    counters are zeroed just before the run and read just after."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training

    arch = get_arch("granite-3-2b")
    mcfg = dataclasses.replace(arch.model, n_layers=LAYERS)
    innet = wire == "fxp32"
    tc = dataclasses.replace(
        arch.train, workers=WORKERS, accum_steps=1, remat="none",
        aggregator="compressed_innet" if innet else "compressed",
        compression=dataclasses.replace(arch.train.compression, wire_dtype=wire))
    api = model_api(mcfg)
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    res = run_training(api, tc, global_batch=BATCH, seq_len=SEQ, steps=STEPS,
                       device=dev, log_every=0)
    launches = dict(ops.LAUNCHES)
    # per step: W f32 producer launches, then one consumer launch (the
    # dequant leg on the fxp32 wire); the quantize leg is off the path
    want = {"encode_pack_quantize": WORKERS * STEPS,
            "dequant_peel_unpack": 0 if innet else STEPS,
            "encode_pack_quantize_q": 0,
            "dequant_peel_unpack_dq": STEPS if innet else 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not all(torch.isfinite(torch.tensor(res.losses))):
        raise AssertionError(f"non-finite loss: {res.losses}")
    last = res.metrics[-1]
    if last["recovery_nnz"] != last["recovery_peeled"] + last["recovery_residual"]:
        raise AssertionError("recovery stats do not add up")
    n_params = sum(p.numel() for p in res.state.params.leaves())
    out = {"phase": phase, "arch": "granite-3-2b", "dtype": mcfg.dtype,
           "params": n_params,
           "reduced": {"n_layers": f"{arch.model.n_layers} -> {LAYERS}"},
           "workers": WORKERS, "global_batch": BATCH, "seq_len": SEQ,
           "aggregator": tc.aggregator, "wire": wire,
           "topology": tc.compression.topology,
           "switch_slots": tc.compression.switch_slots,
           "steps": STEPS, "warmup_steps": 1,
           "step_ms": [s * 1e3 for s in res.step_seconds[1:]],
           "warmup_ms": res.step_seconds[0] * 1e3,
           "losses": res.losses, "launches": launches,
           "recovery": [{k[len("recovery_"):]: int(m[k]) for k in m
                         if k.startswith("recovery_")} for m in res.metrics],
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    return out, launches, api, tc, res.state


def phase_breakdown(api, tc, state, step_ms, dev, phase="breakdown"):
    """CUDA-event time of each stage of the train step, run one at a time
    on the trained state at the step's shapes (median of 5), so the
    stages can be set against the measured step time. On the fxp32
    in-network wire the sum/OR and the consumer give way to the exponent
    agreement and quantization, the windowed switch tree and the dequant
    consumer."""
    import torch
    from repro_torch.core.aggregators import sparsify_leaf
    from repro_torch.core.bucketing import make_bucket_plan
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.core.compressor import CompressedLeaf, HomomorphicCompressor
    from repro_torch.data.pipeline import batch_fn
    from repro_torch.net.fixedpoint import FixedPointWire
    from repro_torch.net.topology import make_topology, tree_all_reduce
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
        produced = [comp.compress_wire(s) for s in streams]
        del streams
        cs = [c for c, _ in produced]
        stages = {
            "sparsify_pack": (W, cuda_ms(sparsify_pack, 5, 1)),
            "producer": (W, cuda_ms(lambda: comp.compress(stream), 5, 1)),
        }
        if tc.aggregator == "compressed_innet" and cfg.wire_dtype == "fxp32":
            wire = FixedPointWire(W)
            topo = make_topology(cfg.topology, group)
            nbk, nbpb = plan.n_buckets, plan.bucket_elems // cfg.block_elems

            def exponents_quantize():
                """The aggregator's agreement on per-bucket exponents (max
                over the workers) and the W quantizations to int32."""
                e = group.max([wire.exponents_from_maxabs(
                    mx.reshape(nbk, nbpb).amax(dim=1)) for _, mx in produced])
                return e, [wire.encode(c.sketch.reshape(nbk, -1), e) for c in cs]

            def tree():
                return (tree_all_reduce(q_w, topo, "add",
                                        window_slots=cfg.switch_slots)[0],
                        tree_all_reduce([c.index_words.reshape(nbk, -1) for c in cs],
                                        topo, "or", window_slots=cfg.switch_slots)[0])

            e, q_w = exponents_quantize()
            q, wd = tree()
            agg = CompressedLeaf(sketch=q.reshape(cs[0].sketch.shape),
                                 index_words=wd.reshape(-1))
            dequant = (e.repeat_interleave(nbpb), wire.mantissa_bits)
            consumer = lambda: comp.recover(agg, plan.padded, dequant=dequant)
            n_windows = -(-nbk // cfg.switch_slots)
            stages["exponents_quantize"] = (1, cuda_ms(exponents_quantize, 5, 1))
            stages[f"tree_add_or_{n_windows}_windows"] = (1, cuda_ms(tree, 5, 1))
            stages["consumer_dequant"] = (1, cuda_ms(consumer, 5, 1))
        else:
            agg = CompressedLeaf(sketch=group.sum([c.sketch for c in cs]),
                                 index_words=group.bor([c.index_words for c in cs]))
            consumer = lambda: comp.recover(agg, plan.padded)
            stages["sum_or"] = (1, cuda_ms(
                lambda: (group.sum([x.sketch for x in cs]),
                         group.bor([x.index_words for x in cs])), 5, 1))
            stages["consumer"] = (1, cuda_ms(consumer, 5, 1))
        rec = consumer()
        agg_leaves = plan.unpack(rec.reshape(plan.n_buckets, plan.bucket_elems) / W)
        lr = opt_lib.lr_schedule(state.step, tc.optimizer, dev)

        def optimizer():
            for i, (p, g) in enumerate(zip(leaves, agg_leaves)):
                st = {k: state.opt[k][i] for k in state.opt}
                opt_lib.opt_leaf_update(p, g, st, lr, state.step, tc.optimizer)

        stages["unpack"] = (1, cuda_ms(lambda: plan.unpack(
            rec.reshape(plan.n_buckets, plan.bucket_elems) / W), 5, 1))
        stages["optimizer"] = (1, cuda_ms(optimizer, 5, 1))
        # what worker 0 sends of each leaf: explains the sketch's load
        sent = {"/".join(path): float((sparsify_leaf(
                    g.reshape(-1).float(), r[0], cfg)[0] != 0).float().mean())
                for path, g, r in zip(params.paths, grads, state.residual)}
    stages = {"forward_backward": (W, cuda_ms(fwd_bwd, 5, 1)), **stages}
    total = sum(n * ms for n, ms in stages.values())
    out = {"phase": phase, "step_ms_median": statistics.median(step_ms),
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


def phase_innet_stream(cfg, dev, n_params, check):
    """The fxp32 legs at the main path's full stream: two workers' 4%
    dyadic payloads, per-bucket exponents from the f32 producer's maxabs
    agreed over both, each quantized through the quantize leg (bit for
    bit with its plain version and with ``encode``), the windowed tree
    (equal to the flat sum/OR), and the dequant consumer on the aggregate
    (bit for bit with its plain version and with ``decode`` + the f32
    consumer). Times both legs and their plain versions; returns their
    records and the two workers' int32 sketches and words with the tree's
    result, for the switch phase."""
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.core.peeling import peel_blocks
    from repro_torch.kernels import ops, ref
    from repro_torch.net.fixedpoint import FixedPointWire
    from repro_torch.net.topology import make_topology, tree_all_reduce

    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    group, wire = LocalWorkers(WORKERS), FixedPointWire(WORKERS)
    M = wire.mantissa_bits
    nbk = cfg.num_buckets(n_params)
    nbpb = cfg.bucket_elems_for(n_params) // cfg.block_elems
    nb = nbk * nbpb
    G, c, R = cfg.group, cfg.lanes, cfg.rows
    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    xs = [make_blocks(cfg, nb, 0.04, "dyadic", gen) for _ in range(WORKERS)]
    f32 = [ops.encode_pack_quantize(x, ids, cfg) for x in xs]
    e_bucket = group.max([wire.exponents_from_maxabs(
        f[2].reshape(nbk, nbpb).amax(dim=1)) for f in f32])
    e = e_bucket.repeat_interleave(nbpb)
    qw = [check.producer_q(x, ids, cfg, f, wire, e, True)
          for x, f in zip(xs, f32)]
    del f32
    topo = make_topology("flat", group)
    q = tree_all_reduce([g[0].reshape(nbk, -1) for g in qw], topo, "add",
                        window_slots=cfg.switch_slots)[0].reshape(nb, R, c)
    w = tree_all_reduce([g[1].reshape(nbk, -1) for g in qw], topo, "or",
                        window_slots=cfg.switch_slots)[0].reshape(nb, -1)
    if not (torch.equal(q, group.sum([g[0] for g in qw]))
            and torch.equal(w, group.bor([g[1] for g in qw]))):
        raise AssertionError("windowed tree differs from the flat sum/OR")
    _, res = check.consumer_dq(q, w, ids, cfg, wire, e, True)
    x0 = xs[0]
    del xs
    torch.cuda.empty_cache()

    n_el = nb * G * c
    nnz0 = int((x0 != 0).sum())
    nnz = int(index_lib.popcount(w))
    n_res = int(res.sum())
    y = wire.decode(q.reshape(nb, -1), e).reshape(q.shape)
    rounds = peel_blocks(y, index_lib.unpack_bits(w.reshape(-1), (nb, G, c)),
                         ids, cfg).rounds_used
    del y
    emit({"phase": "innet_stream", "blocks": nb, "buckets": nbk,
          "blocks_per_bucket": nbpb, "workers": WORKERS, "mantissa_bits": M,
          "switch_slots": cfg.switch_slots,
          "windows": -(-nbk // cfg.switch_slots), "agree": True,
          "int32_sketch_bytes_per_worker": nb * R * c * 4,
          "exponent_range": [int(e_bucket.min()), int(e_bucket.max())],
          "aggregate_nnz": nnz, "peeled": nnz - n_res, "estimated": n_res,
          "plain_rounds_to_fixpoint": rounds})
    # the f32 legs' bytes and operations (phase 6), plus the (nb,) int32
    # exponents read and, per sketch cell, one multiply and one conversion
    enc_bytes = n_el * 4 + nb * 4 + nb * R * c * 4 + n_el // 8 + nb * 4 + nb * 4
    dec_bytes = nb * R * c * 4 + n_el // 8 + nb * 4 + nb * 4 + n_el * 4 + n_el
    enc_ops = 6 * nnz0 + nb * R * c + n_el + 2 * nb * R * c
    dec_ops = (3 * nnz + 3 * nnz * rounds + 9 * (nnz - n_res) + 10 * n_res
               + 2 * nb * R * c)
    recs = []
    for name, kfn, pfn, nbytes, nops, replaces, pit in [
        ("encode_pack_quantize_q",
         lambda: ops.encode_pack_quantize(x0, ids, cfg, exponents=e,
                                          mantissa_bits=M),
         lambda: ref.encode_pack_quantize_ref(x0, ids, cfg, exponents=e,
                                              mantissa_bits=M),
         enc_bytes, enc_ops, "src/repro/kernels/sketch_wire.py:102", 5),
        ("dequant_peel_unpack_dq",
         lambda: ops.dequant_peel_unpack(q, w, ids, cfg, exponents=e,
                                         mantissa_bits=M),
         lambda: ref.dequant_peel_unpack_ref(q, w, ids, cfg, exponents=e,
                                             mantissa_bits=M),
         dec_bytes, dec_ops, "src/repro/kernels/sketch_wire.py:124", 3),
    ]:
        b_ms, b_by = bound(nbytes, nops)
        recs.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/sketch_wire.cu",
                     "replaces": replaces, "launches": None,
                     "max_abs_err": check.err[name], "ms": cuda_ms(kfn, 10),
                     "plain_ms": cuda_ms(pfn, pit, warmup=1), "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "blocks": nb,
                     "bytes": nbytes, "ops": nops})
    payload = ([g[0].reshape(nbk, -1) for g in qw],
               [g[1].reshape(nbk, -1) for g in qw],
               q.reshape(nbk, -1), w.reshape(nbk, -1))
    del x0
    torch.cuda.empty_cache()
    return recs, payload


def phase_switch(payload, slots):
    """The two workers' int32 sketches and words through the numpy
    SwitchModel, one chunk a bucket: its sums must equal the on-card
    tree's bit for bit, and its window report the topology's profile."""
    import numpy as np
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.net.switch import SwitchModel
    from repro_torch.net.topology import make_topology

    q_w, w_w, q_tree, w_tree = payload
    ports = len(q_w)
    t0 = time.perf_counter()
    sk = np.stack([t.cpu().numpy() for t in q_w])
    bm = np.stack([t.cpu().numpy().view(np.uint32) for t in w_w])
    t1 = time.perf_counter()
    sw = SwitchModel(ports=ports, slots=slots)
    out_sk, out_bm = sw.aggregate(sk, bm, metadata_bytes=sk.shape[1] * 4)
    t2 = time.perf_counter()
    if not (np.array_equal(out_sk, q_tree.cpu().numpy())
            and np.array_equal(out_bm, w_tree.cpu().numpy().view(np.uint32))):
        raise AssertionError("SwitchModel sums differ from the on-card tree")
    rep = sw.report()
    chunk_bytes = sk[0, 0].nbytes + bm[0, 0].nbytes
    prof = make_topology("flat", LocalWorkers(ports)).window_profile(
        chunk_bytes, sk.shape[1], slots)
    keys = ("windows", "occupancy_peak", "window_chunks", "window_root_bytes")
    if any(rep[k] != prof[k] for k in keys) or \
            rep["root_link_tx_bytes"] != prof["root_link_bytes"] + sk.shape[1] * 4:
        raise AssertionError("SwitchModel windows differ from the profile")
    emit({"phase": "switch", "ports": ports, "slots": slots,
          "chunks": int(sk.shape[1]), "chunk_bytes": int(chunk_bytes),
          "windows": rep["windows"], "occupancy_peak": rep["occupancy_peak"],
          "root_link_tx_bytes": rep["root_link_tx_bytes"],
          "port0_rx_bytes": rep["per_port"][0]["rx_bytes"],
          "equal_to_tree": True, "window_profile_equal": True,
          "host_copy_s": t1 - t0, "aggregate_s": t2 - t1})


def dyadic_grads(shapes, density, gen, dev):
    """Per-worker dyadic gradient leaves (values +-2^e, |e| <= 2)."""
    import torch
    out = []
    for _ in range(WORKERS):
        leaves = []
        for sh in shapes:
            e = torch.randint(-2, 3, sh, generator=gen, device=dev)
            sign = torch.where(torch.rand(sh, generator=gen, device=dev) < 0.5,
                               -1.0, 1.0)
            v = sign * torch.exp2(e.float())
            if density < 1.0:
                mask = torch.rand(sh, generator=gen, device=dev) < density
                v = torch.where(mask, v, torch.zeros((), device=dev))
            leaves.append(v)
        out.append(leaves)
    return out


def phase_innet_lossless(mcfg, dev):
    """Dense dyadic gradients of the model in the lossless profile (rows
    60, ratio 2; the kernels keep the consumer's state in device memory):
    the fxp32 in-network aggregate equals the ``compressed`` aggregate bit
    for bit everywhere (dyadic sketches quantize exactly at M=29), and the
    dense mean at every coordinate the peel recovers; as in phase 7, the
    coordinates that differ are no more than the estimated ones, and
    those a ten-thousandth of the non-zeros at most."""
    import torch
    from repro_torch.core.aggregators import make_aggregator
    from repro_torch.core.collectives import AggregationState, LocalWorkers
    from repro_torch.core.config import CompressionConfig
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api

    params = model_api(mcfg).init(0, dev)
    shapes = [tuple(p.shape) for p in params.leaves()]
    del params
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    group = LocalWorkers(WORKERS)
    grads_w = dyadic_grads(shapes, 1.0, gen, dev)
    stubs = [torch.zeros((0,), device=dev) for _ in shapes]
    cfg = CompressionConfig(ratio=2.0, rows=60, wire_dtype="fxp32")
    before = dict(ops.LAUNCHES)
    t = time.perf_counter()
    innet, st = make_aggregator("compressed_innet", cfg, group)(
        grads_w, AggregationState(residual=stubs))
    torch.cuda.synchronize()
    innet_s = time.perf_counter() - t
    if ops.LAUNCHES["dequant_peel_unpack_dq"] != before["dequant_peel_unpack_dq"] + 1:
        raise AssertionError("the lossless innet aggregate did not take the "
                             "dequant kernel")
    comp, st_c = make_aggregator("compressed", cfg, group)(
        grads_w, AggregationState(residual=stubs))
    if not all(torch.equal(a, b) for a, b in zip(innet, comp)):
        raise AssertionError("fxp32 innet aggregate differs from compressed")
    del comp
    dense = make_aggregator("dense", cfg, group)(
        grads_w, AggregationState(residual=None))[0]
    differ = sum(int((a != b).sum()) for a, b in zip(innet, dense))
    nnz, n_est = int(st.stats.nnz), int(st.stats.residual)
    if differ > n_est or n_est * 10_000 > nnz or int(st_c.stats.residual) != n_est:
        raise AssertionError(
            f"{differ} coordinates differ from the dense mean, {n_est} of "
            f"{nnz} fell back to the estimate")
    emit({"phase": "innet_lossless", "profile": {"ratio": 2.0, "rows": 60},
          "nnz": nnz, "peeled": int(st.stats.peeled), "estimated": n_est,
          "differ_from_dense": differ, "equal_to_compressed": True,
          "peeled_equal_bit_for_bit": True, "innet_aggregate_s": innet_s})


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
    phase_kernels_q(cfg, dev, check)
    torch.cuda.empty_cache()

    train, launches, api, tc, state = phase_train(dev)
    phase_breakdown(api, tc, state, train["step_ms"], dev)
    del state
    torch.cuda.empty_cache()
    innet, launches_innet, _, tc_innet, state = phase_train(
        dev, phase="innet_train", wire="fxp32")
    phase_breakdown(api, tc_innet, state, innet["step_ms"], dev,
                    phase="innet_breakdown")
    del state
    torch.cuda.empty_cache()
    n = train["params"]
    n_blocks = cfg.num_buckets(n) * cfg.bucket_elems_for(n) // cfg.block_elems
    recs = phase_main_stream(cfg, dev, n_blocks, check)
    recs_q, payload = phase_innet_stream(cfg, dev, n, check)
    phase_switch(payload, cfg.switch_slots)
    del payload
    torch.cuda.empty_cache()
    recs += recs_q
    # each row's launches come from the path it serves: the f32 legs from
    # the compressed train, the fxp32 legs from the in-network train
    for r in recs:
        on = launches_innet if r["name"].endswith(("_q", "_dq")) else launches
        r["launches"] = on[r["name"]]
        r["launches_by_path"] = {"train": launches[r["name"]],
                                 "innet_train": launches_innet[r["name"]]}
    phase_lossless(api.cfg, tc, dev)
    phase_innet_lossless(api.cfg, dev)

    emit({"kernels": recs})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
