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
   tokens, aggregator ``compressed`` (ratio 0.1, top-k 4%), AdamW with
   the ZeRO-1 update (the default, as every train phase's), one
   warm-up step and three timed steps. The launch counters are zeroed
   just before and read just after: the producer must have run W times
   per step and the consumer once.
5. breakdown — CUDA-event time of each stage of the step (forward and
   backward, sparsify + pack, producer, sum/OR, consumer, unpack,
   optimizer) at the step's shapes, beside the measured step time.
6. main stream — both kernels against their plain versions at the main
   path's shapes: one worker's whole 14,525-block stream into the
   producer, the sum/OR of two workers' payloads at 4% each into the
   consumer (Gaussian to rtol=1e-5, dyadic bit for bit); the sha256 of the
   producer's sketch, words and maxabs bytes (Gaussian, and each dyadic
   worker) and of the consumer's values and residual bytes on both
   inputs; the producer's per-block phase stamps (clock64 cycles waiting
   on loads, summing, in all: medians) and its time at 0.1%, 4% and 40%
   density; a histogram of
   the consumer's per-block rounds to the fixpoint (its counter, which
   the training path leaves NULL), whose largest entry must be the plain
   peel's rounds; the consumer's time with the rounds capped at 0, 1, 2
   and ``cfg.rounds`` (cap 0: loads, initial degrees and output pass
   alone); per round of the plain peel, a block's mean peels and cells
   taking one and several contributions; the kernel and plain times of
   the kernels line are taken here.
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
    (bit for bit), the digests of each worker's quantize-leg output
    (int32 sketch, words, maxabs) and of the consumer's output, its
    per-block rounds histogram as in phase 6; the quantize leg's phase
    stamps; the kernel and plain times of both legs.
11. switch — the same two int32 sketches and word streams through the
    numpy ``SwitchModel`` (ports W, 8 slots): its sums equal the on-card
    tree bit for bit and its window report equals
    ``Topology.window_profile``.
12. innet_lossless — dyadic dense gradients of the same model in the
    lossless profile (rows 60, ratio 2): the fxp32 in-network aggregate
    equals the ``compressed`` aggregate bit for bit everywhere and the
    dense mean at every coordinate the peel recovers.

The Bloom-index slice (``index="bloom"``, the standalone encode and peel
kernels):

13. kernels_std — the standalone encode and peel against their plain
    versions on 2048 blocks at offset ids, the peel fed the candidates of
    a Bloom filter built over the blocks: the main geometry with dyadic
    inputs at 4% and 40% bit for bit and Gaussian inputs to rtol=1e-5,
    atol=1e-6, residual exactly; the unaligned geometry lanes=500 (G=60,
    n % 32 = 16), dyadic and Gaussian; dyadic in the two geometries whose
    state lives in device memory. On every aligned input the standalone
    sketch equals the fused producer's and the standalone peel the fused
    consumer's on the packed bits, bit for bit; two runs bit-identical.
14. bloom_train — the train of phase 4 with ``index="bloom"`` and top-k
    0.1%: per step W standalone encode launches and one standalone peel,
    no fused leg; per step the recovery stats, the filter's fill and the
    candidates against the true union of the two workers' non-zeros (kept
    by an observer of ``bloom_build`` during the step, read after it).
15. bloom_breakdown — its stage times: encode kernel, ``bloom_build``,
    sum/OR, ``bloom_query`` and peel kernel in place of the fused
    producer and consumer.
16. bloom_stream — both standalone kernels against their plain versions
    at the full stream (encode and peel on one worker's Gaussian 0.1%
    stream with its Bloom candidates to rtol=1e-5; encode on one worker's
    dyadic 0.1% stream, peel on the aggregate of two with Bloom
    candidates, bit for bit); their kernel and plain times; and the
    standalone peel on the bitmap bits of two 4% payloads beside the fused
    consumer, equal bit for bit. The sha256 of the encode's sketch
    (Gaussian, and each dyadic worker) and of the peel's values and
    residual bytes on all three inputs, the peel's per-block rounds
    histogram, its time at caps 0, 1 and ``cfg.rounds`` and the
    per-round counts, as in phase 6; the encode's phase stamps and its
    time at 0.1%, 4% and 40% density.
17. bloom_lossless — 1%-dense dyadic gradients per worker in the
    lossless profile (rows 60, ratio 2) with the Bloom index: the
    aggregate equals the dense mean bit for bit at every coordinate, the
    filter's false positives peeling to exactly 0.

The ``torch.distributed`` slice (W ranks as processes):

18. dist_train — after the three emulated trains, their memory freed:
    the train of phase 4 with W=2 ranks as spawned processes sharing
    ``cuda:0`` over gloo (collectives staged through pinned host
    memory), one worker a rank, the ``compressed`` arm and then the
    ``dense`` arm on the same process group. Each rank must launch
    exactly one producer and one consumer a step (none on the dense
    arm); every rank's parameter sha256 must be equal after every step;
    the OR all-reduce of the last step's real words must equal an
    ``all_gather`` and a local OR; losses finite and within rtol 1e-3 of
    phase 4's. Per arm: step times, the last step's collectives replayed
    alone (sketch SUM + word OR against the dense per-leaf all-reduce,
    host clock around a synchronise) and their payload bytes a rank,
    peak memory per rank, backend and staging; and two probes, what NCCL
    says to two ranks on one device and what gloo does with a CUDA
    tensor sent point to point.

The streamed wire, the reduce-scatter wire and ZeRO-1 (phases 4, 9 and
18 now also take each step's parameter sha256):

19. stream_train — LocalWorkers, W=2: the train of phase 4 with
    ``overlap=True`` (415 one-bucket chunks: W producer launches a chunk,
    one consumer launch a step) and the train of phase 9 likewise (52
    chunks of 8 switch slots); each step's parameter sha256, the losses
    and the recovery equal the unstreamed phase's. Then the producer
    stage chunked (one launch a chunk, and one launch alone) beside the
    one-launch producer, on a synthetic 4% stream.
20. rs_train — LocalWorkers, W=2: ``compressed_rs`` on the native wire
    with ZeRO-1, one-shot (W consumer launches a step, one a worker's
    half) and streamed (208 chunks of 2 buckets: W producer and W
    consumer launches a chunk); the two runs' parameter sha256 equal
    after every step and equal to phase 4's (which takes the ZeRO-1
    update too, the default), their recovery equal, step 0's equal to
    phase 4's, the losses equal. Then the consumer on a half
    stream and on one chunk's slice beside the whole stream.
21. dist_rs — W=2 ranks as in phase 18: the ``compressed_rs`` + ZeRO-1
    arm (native, one-shot) and the streamed ``compressed`` arm; after
    every step each arm's parameter sha256 equal on both ranks and to its
    emulation (phase 20's one-shot arm; phase 4, which phase 19 equals),
    each rank's launches the emulation's share; per arm the steps, the
    last step's collectives replayed alone by operation (sketch and word
    reduce-scatters, the recovered-chunk and ZeRO-1 delta gathers, the
    sketch sum and word OR) with their payload bytes a rank, and peak
    memory a rank; for the streamed arm each step's summed reduce time
    and its overlap with the next chunk's producer (host clock around
    each reduce on the communication thread, CUDA events after each
    producer, placed on the host clock by a synchronised event when the
    stream starts); and what gloo's ``reduce_scatter_tensor`` does on
    the card's torch.
22. gather_skip — the same ranks: a synthetic aligned two-leaf tree takes
    the gather-skip path, each rank's aggregate equal to the full
    gather's on its owned coordinates and zero elsewhere and the norm
    summed over the ranks equal to the full gather's; the full-width
    granite shapes take it on no chunk grid.

Wire plans and the ``auto`` strategy (after phase 16, as they read the
codec's rate from phase 6 and the link's from phase 18):

23. auto_train — LocalWorkers, W=2, the ``auto`` aggregator (fxp32 on
    the in-network groups). (a) A fixed mixed plan of all four wires over
    the 415 buckets, the groups after the first starting at odd buckets,
    for 2 steps: the launches of rows 1, 2 and 4 the plan implies (W
    producers a compressed group, one consumer for ``compressed``, W for
    ``compressed_rs``, one dequant consumer for ``compressed_innet``);
    then on step 0's gradients and zero residuals each compressed
    group's aggregate rows equal the fixed strategy's bit for bit, the
    dense group's the sum of the packed streams, the residuals equal.
    (b) ``uniform_plan(415, "compressed")`` for 4 steps: parameter
    sha256 equal to phase 4's after every step. (c) The controller with
    ``replan_every=2`` from priors measured in this run
    (``priors_from_codec_report``: the stream's bytes over the mean of
    the producer's and consumer's ``main_stream`` times, the device
    memory bound, and ``dist_train``'s dense all-reduce bytes over their
    time), driven until it decides: its ``decision_trace()``, each
    bucket's occupancy against the 7.3% limit, the vetoed buckets and
    the ``lm_head`` buckets among them, the decided plan's step time
    beside the best uniform wire's and beside the plan that routes the
    vetoed buckets dense and the rest compressed.
24. dist_auto — W=2 ranks as in phase 18: the mixed plan of 23(a) for 2
    steps; each step's parameter sha256 equal on both ranks and to
    23(a)'s, each rank's launches the plan's for one worker; the last
    step's collectives replayed alone by operation (the dense group's
    sum, the sketch sum and word OR, the reduce-scatters and the
    recovered-chunk gather, the exponent max) and the in-network group's
    P2P tree, with their bytes a rank.

The MoE slice (deepseek-moe-16b, the expert-parallel all-to-all
exchange; after phase 24, the granite phases' memory freed, apart from
25, which runs after phase 13):

25. kernels_a2a — rows 1 and 2 at the exchange's geometry (ratio 2.5,
    rows 6, c 512, G 2) against their plain versions on 2048 blocks at
    offset ids, fully dense (1024 peels a block): dyadic bit for bit,
    Gaussian to phase 3's tolerance, words and residual exactly, every
    value peeled; ``exchange_wire`` equal to the producer; two sources'
    2-lane stacks through the plain lane merge into the consumer, each
    lane at its block offset, equal to the sources' sum bit for bit.
    Then both kernels' and plain times and the bound at the MoE train's
    shapes (the producer on one source's 8192-block stack, the consumer
    on one 4096-block merged lane).
26. moe_train — deepseek-moe-16b at full width (d_model 2048, 16 heads,
    64 routed experts of d_ff 1408, top-6, 2 shared, vocab 102400),
    depth 28 -> 2, bf16, W=2 emulated with ``ep_workers=2``, global
    batch 8 x 1024, aggregator ``compressed`` (ratio 0.1, top-k 4%),
    AdamW with ZeRO-1, under ``ep_exchange`` none, dense and compressed,
    one warm-up and three timed steps each. Launches zeroed just before
    each run: rows 1 / 2 run 2 / 1 a step under none and dense, 2 + 8 /
    1 + 8 under compressed (a producer a source and a consumer a
    receiving rank a MoE layer a worker). Losses of dense and compressed
    within rtol 1e-2 of none's; compressed's parameter sha256 equal to
    dense's after every step; peak memory, step ms.
27. moe_breakdown — the MoE stages, forward only, at the step's shapes
    (attention, routing and dispatch, expert products, local combine,
    shared experts; the exchange's pack, producer, lane merge, consumer,
    unpack + gather), then the DP aggregator's stages and the optimizer
    as phase 5 times them, beside the step ms.
28. dist_a2a — W=2 ranks sharing ``cuda:0`` over gloo (host-staged): the
    dense and compressed exchanges standalone on one MoE layer's payload
    (``(2, 2048, 2048)`` f32 a rank, dyadic), fused and in 2 chunks, 2
    steps each: merged lanes equal to the sources' sum and to each other
    bit for bit, the bytes a rank sends equal to ``strategy_wire_bytes``'
    ``dense_alltoall`` / ``compressed_alltoall`` ``rank_payload_bytes``,
    each rank's launches one producer and one consumer a chunk; the lane
    merges replayed alone by payload kind.

Then the ``{"kernels": [...]}`` line (all six kernel rows, each with
its resident blocks an SM, threads a block and shared-memory bytes from
the occupancy query, its launches on each train path (the ``auto``
phases' and the MoE trains' too), ``dist_train``'s, ``dist_rs``'s,
``dist_auto``'s and ``dist_a2a``'s summed over the ranks, rows 1 and 2
with their ``kernels_a2a`` times under ``a2a``, for the three peel kernels the rounds histogram,
for the three encode kernels the phase stamps; a peel kernel below 48
resident warps an SM, or an encode kernel below 32, fails the run), the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. There is no
CPU fallback: without a CUDA device the script exits non-zero before
printing a result.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
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


def digest(*tensors, chunk=1024):
    """sha256 of a kernel's output bytes: each tensor in turn (a peel's
    f32 values then its int8 residual; a producer's sketch, words and
    maxabs), each in block order (copied to the host a chunk at a time)."""
    h = hashlib.sha256()
    for t in tensors:
        for i in range(0, t.shape[0], chunk):
            h.update(t[i:i + chunk].contiguous().cpu().numpy())
    return h.hexdigest()


def phase_medians(run, nb, dev):
    """Median over the blocks of one run of an encode kernel's per-block
    ``clock64`` stamps (``run(phase_cycles)`` launches it): cycles waiting
    on the block's loads, summing, and in all."""
    import torch
    pc = torch.full((nb, 3), -1, dtype=torch.int64, device=dev)
    run(pc)
    if int(pc.min()) < 0:
        raise AssertionError("a block wrote no phase stamps")
    med = pc.median(dim=0).values.tolist()
    return dict(zip(("load_wait", "sum", "total"), med))


DENSITIES = (0.001, 0.04, 0.4)


def ms_by_density(run, cfg, nb, gen):
    """An encode kernel's time (``run(xb)`` launches it) on Gaussian
    streams of ``nb`` blocks at each of ``DENSITIES`` (the kernels sum
    every term, so the time should not move with the density)."""
    out = {}
    for frac in DENSITIES:
        xb = make_blocks(cfg, nb, frac, "gauss", gen)
        out[str(frac)] = cuda_ms(lambda: run(xb), 10)
        del xb
    return out


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
                    "encode_pack_quantize_q": 0.0, "dequant_peel_unpack_dq": 0.0,
                    "sketch_encode": 0.0, "sketch_peel": 0.0}
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
        """Producer kernel vs plain on ``xb``; returns the kernel's outputs
        (the plain version's Gaussian sketch sums in atomic order, so only
        the kernel's repeats bit for bit from run to run)."""
        from repro_torch.kernels import ops, ref
        want = ref.encode_pack_quantize_ref(xb, ids, cfg)
        got = ops.encode_pack_quantize(xb, ids, cfg)
        for g, w, ex in zip(got, want, (exact, True, exact)):
            self("encode_pack_quantize", g, w, ex)
        return got

    def consumer(self, sk, w, ids, cfg, exact):
        """Consumer kernel vs plain on one payload; returns the kernel's
        outputs."""
        from repro_torch.kernels import ops, ref
        want = ref.dequant_peel_unpack_ref(sk, w, ids, cfg)
        got = ops.dequant_peel_unpack(sk, w, ids, cfg)
        self("dequant_peel_unpack", got[0], want[0], exact)
        self("dequant_peel_unpack", got[1], want[1], True)
        return got

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

    def encode_std(self, xb, ids, cfg, exact):
        """Standalone encode kernel vs plain on ``xb``, and, on an aligned
        geometry, vs the fused producer's sketch bit for bit (any input).
        Returns the kernel's sketch."""
        from repro_torch.kernels import ops, ref
        got = ops.sketch_encode(xb, ids, cfg)
        self("sketch_encode", got, ref.sketch_encode_ref(xb, ids, cfg), exact)
        twin = fused_twin(cfg)
        if twin is not None:
            self("sketch_encode", got, ops.encode_pack_quantize(xb, ids, twin)[0],
                 True)
        return got

    def peel_std(self, sk, bits, ids, cfg, exact):
        """Standalone peel kernel vs plain on one aggregate and its
        candidate bits, and, on an aligned geometry, vs the fused consumer
        on the packed bits, bit for bit (any input). Returns the kernel's
        outputs."""
        from repro_torch.core import index as index_lib
        from repro_torch.kernels import ops, ref
        got = ops.sketch_peel(sk, bits, ids, cfg)
        want = ref.sketch_peel_ref(sk, bits, ids, cfg)
        self("sketch_peel", got[0], want[0], exact)
        self("sketch_peel", got[1], want[1], True)
        twin = fused_twin(cfg)
        if twin is not None:
            words = index_lib.pack_bits(bits).reshape(sk.shape[0], -1)
            fused = ops.dequant_peel_unpack(sk, words, ids, twin)
            self("sketch_peel", got[0], fused[0], True)
            self("sketch_peel", got[1], fused[1], True)
        return got


def fused_twin(cfg):
    """The bitmap config of ``cfg``'s geometry where the fused kernels
    cover it, else None."""
    from repro_torch.kernels import ops
    twin = dataclasses.replace(cfg, index="bitmap")
    return twin if ops.fused_wire_supported(twin) else None


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


def phase_kernels_std(cfg, dev, check):
    """The standalone encode and peel against their plain versions on
    2048 blocks at offset ids; the peel takes the candidates of a Bloom
    filter built over the blocks (the non-zeros and the filter's false
    positives). The main geometry (three input kinds, run-to-run
    repeatability), the unaligned lanes=500 (G=60, n % 32 = 16), and the
    two geometries whose state outgrows shared memory; on every aligned
    geometry each kernel also equals its fused counterpart bit for bit."""
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(5678)
    ids = torch.arange(CHECK_BLOCKS, dtype=torch.int32, device=dev) + CHECK_OFFSET
    cases = [(cfg, CHECK_BLOCKS, kind, frac) for kind, frac in
             [("dyadic", 0.04), ("dyadic", 0.40), ("gauss", 0.04)]]
    unaligned = dataclasses.replace(cfg, lanes=500)
    cases += [(unaligned, CHECK_BLOCKS, kind, 0.04) for kind in ("dyadic", "gauss")]
    cases += [(big, BIG_BLOCKS, "dyadic", 0.04) for big in
              (dataclasses.replace(cfg, ratio=2.0, rows=60),
               dataclasses.replace(cfg, ratio=0.05))]
    for c, nb, kind, frac in cases:
        exact = kind == "dyadic"
        xb = make_blocks(c, nb, frac, kind, gen)
        idb = ids[:nb]
        sk = check.encode_std(xb, idb, c, exact)
        bits = index_lib.bloom_query(xb.shape, c, index_lib.bloom_build(xb, c))
        if not bool(bits[xb != 0].all()):
            raise AssertionError("the Bloom query missed a non-zero")
        _, res = check.peel_std(sk, bits, idb, c, exact)
        if c is cfg and kind == "gauss":   # no atomics: runs repeat bit for bit
            if not torch.equal(ops.sketch_encode(xb, idb, c), sk):
                raise AssertionError("sketch_encode is not run-to-run deterministic")
            runs = [ops.sketch_peel(sk, bits, idb, c) for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError("sketch_peel is not run-to-run deterministic")
        emit({"phase": "kernels_std", "case": f"{kind}@{frac} rows={c.rows} "
              f"G={c.group} lanes={c.lanes}", "blocks": nb, "agree": True,
              "equal_to_fused": fused_twin(c) is not None,
              "nonzeros": int((xb != 0).sum()), "candidates": int(bits.sum()),
              "residual": int(res.sum())})


def bound(nbytes, nops):
    """(ms, what bounds it): bytes over the HBM rate, operations over the
    float32 rate, the larger of the two."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def codec_bytes_ops(nb, cfg, nnz_in, nnz, n_res, rounds):
    """(producer bytes, producer ops, consumer bytes, consumer ops) of
    ``nb`` blocks: each input read once, each output written once. The
    data-dependent work: sign x value + add per (non-zero, hash) of the
    input's ``nnz_in`` non-zeros, the max over the sketch and the
    non-zero test for the bitmap; the peel's initial degrees, one degree
    test per (set bit, hash, round) of the aggregate's ``nnz`` set bits
    until the fixpoint (``rounds``), 9 ops per peeled element (3 sign
    products, 3 subtractions, 3 decrements) and 10 per median estimate
    (``n_res``)."""
    G, c, R = cfg.group, cfg.lanes, cfg.rows
    n_el = nb * G * c
    enc_bytes = n_el * 4 + nb * 4 + nb * R * c * 4 + n_el // 8 + nb * 4
    dec_bytes = nb * R * c * 4 + n_el // 8 + nb * 4 + n_el * 4 + n_el
    enc_ops = 6 * nnz_in + nb * R * c + n_el
    dec_ops = 3 * nnz + 3 * nnz * rounds + 9 * (nnz - n_res) + 10 * n_res
    return enc_bytes, enc_ops, dec_bytes, dec_ops


def block_rounds(peel, nb, dev, plain_rounds):
    """Each block's rounds to its fixpoint in one run of ``peel(counter)``
    (a peel kernel's wrapper writing its per-block counter), as a
    histogram: entry k counts the blocks that ran k rounds. The most any
    block ran must be the plain peel's rounds over the whole stream."""
    import torch
    counter = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    peel(counter)
    if int(counter.max()) != plain_rounds or int(counter.min()) < 0:
        raise AssertionError(f"blocks ran {int(counter.min())}..{int(counter.max())}"
                             f" rounds, the plain peel {plain_rounds}")
    return torch.bincount(counter.long()).tolist()


def ms_by_rounds(peel, cfg, caps):
    """A peel kernel's time with ``cfg.rounds`` capped at each of ``caps``
    (``peel(cfg)`` launches it): cap 0 is the load, initial degrees and
    output pass alone; the rest is the rounds'."""
    return {str(k): cuda_ms(lambda: peel(dataclasses.replace(cfg, rounds=k)), 10)
            for k in caps}


def round_stats(bits, ids, cfg):
    """Per round of the plain peel over the whole stream until its
    fixpoint, a block's mean peels, cells taking one contribution and
    cells taking several: the work the peel kernels' gather and scatter
    see. The peel decisions need the degrees only, not the values."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.core.sketch import (device_tables, gather_rows,
                                         roll_from_sketch, roll_to_sketch,
                                         scatter_rows)
    rows_flat, _ = device_tables(cfg, bits.device)
    rot = hashing.block_rotations(ids, cfg.group, cfg.lanes, cfg.seed)

    def to_cells(mask):
        return scatter_rows(roll_to_sketch(mask.to(torch.int32), rot, cfg.lanes),
                            rows_flat, cfg.rows)

    deg, b, nb, out = to_cells(bits), bits.clone(), bits.shape[0], []
    for _ in range(cfg.rounds):
        d_at = roll_from_sketch(gather_rows(deg, rows_flat), rot, cfg.lanes)
        peel = ((d_at == 1) & b[:, :, None, :]).any(dim=2)
        del d_at
        if not bool(peel.any()):
            break
        cnt = to_cells(peel)
        out.append({"peels": int(peel.sum()) / nb,
                    "cells_one": int((cnt == 1).sum()) / nb,
                    "cells_several": int((cnt >= 2).sum()) / nb})
        deg -= cnt
        b &= ~peel
    return out


def occupancy_fields(name, cfg, dev, hist=None):
    """A kernel row's resident blocks an SM, threads a block and
    shared-memory bytes (the occupancy query at the geometry it ran), and,
    for a peel kernel, its per-block rounds histogram. A peel kernel must
    hold 48 warps an SM, a producer or encode kernel 32."""
    from repro_torch.kernels import ops
    blocks, smem = ops.kernel_occupancy(name, cfg, dev)
    threads = ops.kernel_threads(name, cfg)
    warps, need = blocks * threads // 32, 48 if hist is not None else 32
    if warps < need:
        raise AssertionError(f"{name}: {blocks} blocks of {threads} threads an "
                             f"SM, {warps} warps < {need}")
    return {"blocks_per_sm": blocks, "threads_per_block": threads,
            "warps_per_sm": warps, "smem_bytes": smem,
            "block_rounds_hist": hist}


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
    from repro_torch.kernels.sketch_wire import (dequant_peel_unpack_cuda,
                                                 encode_pack_quantize_cuda)

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    nb = n_blocks
    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    xb = make_blocks(cfg, nb, 0.04, "gauss", gen)
    sk, w, mx = check.producer(xb, ids, cfg, False)
    enc_digests = {"gauss@0.04": digest(sk, w, mx)}
    digests = {"gauss@0.04": digest(*check.consumer(sk, w, ids, cfg, False))}
    del xb, sk, w, mx
    torch.cuda.empty_cache()

    group = LocalWorkers(WORKERS)
    xs = [make_blocks(cfg, nb, 0.04, "dyadic", gen) for _ in range(WORKERS)]
    enc = [check.producer(x, ids, cfg, True) for x in xs]
    for k, e in enumerate(enc):
        enc_digests[f"dyadic@0.04 worker{k}"] = digest(*e)
    sk = group.sum([e[0] for e in enc])
    w = group.bor([e[1] for e in enc])
    del enc
    out = check.consumer(sk, w, ids, cfg, True)
    digests["dyadic@0.04x2"] = digest(*out)
    res = out[1]
    del out
    x0 = xs[0]
    del xs
    torch.cuda.empty_cache()

    G, c = cfg.group, cfg.lanes
    n_el = nb * G * c
    nnz0 = int((x0 != 0).sum())
    nnz = int(index_lib.popcount(w))
    n_res = int(res.sum())
    bits = index_lib.unpack_bits(w.reshape(-1), (nb, G, c))
    rounds = peel_blocks(sk, bits, ids, cfg).rounds_used
    per_round = round_stats(bits, ids, cfg)
    del bits
    hist = block_rounds(lambda r: dequant_peel_unpack_cuda(
        sk, w, ids, cfg, block_rounds=r), nb, dev, rounds)
    by_rounds = ms_by_rounds(lambda k: ops.dequant_peel_unpack(sk, w, ids, k),
                             cfg, (0, 1, 2, cfg.rounds))
    emit({"phase": "main_stream", "blocks": nb, "workers": WORKERS,
          "agree": True, "worker0_nnz": nnz0, "aggregate_nnz": nnz,
          "aggregate_density": nnz / n_el, "peeled": nnz - n_res,
          "estimated": n_res, "plain_rounds_to_fixpoint": rounds,
          "consumer_block_rounds_hist": hist,
          "consumer_ms_by_rounds_cap": by_rounds,
          "plain_per_round_per_block": per_round,
          "sha256_sketch_words_maxabs": enc_digests,
          "sha256_values_residual": digests})
    enc_bytes, enc_ops, dec_bytes, dec_ops = codec_bytes_ops(
        nb, cfg, nnz0, nnz, n_res, rounds)

    hists = {"encode_pack_quantize": None, "dequant_peel_unpack": hist}
    extra = {"encode_pack_quantize": {
        "phase_cycles_median": phase_medians(lambda pc: encode_pack_quantize_cuda(
            x0, ids, cfg, phase_cycles=pc), nb, dev),
        "ms_by_density": ms_by_density(
            lambda x: ops.encode_pack_quantize(x, ids, cfg), cfg, nb, gen)},
        "dequant_peel_unpack": {}}
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
                     "bytes": nbytes, "ops": nops, **extra[name],
                     **occupancy_fields(name, cfg, dev, hists[name])})
    del x0, sk, w
    torch.cuda.empty_cache()
    return recs


class BloomObserver:
    """Keeps what ``bloom_build`` is given and returns during a step (each
    worker's block stream and filter: references only, no work) and
    reads them after the step, outside its clock: ``run_training`` calls
    its log hook after taking the step's time. Per step: the filter's
    fill and the true union of the workers' non-zeros, for the
    candidates of the step's ``RecoveryStats``."""

    def __init__(self):
        self.held, self.steps = [], []

    def __enter__(self):
        from repro_torch.core import index as index_lib
        self._build = build = index_lib.bloom_build

        def observed(xb, cfg, **kw):
            words = build(xb, cfg, **kw)
            self.held.append((xb, words))
            return words

        index_lib.bloom_build = observed
        return self

    def __exit__(self, *exc):
        from repro_torch.core import index as index_lib
        index_lib.bloom_build = self._build

    def after_step(self, _line):
        import torch
        from repro_torch.core import index as index_lib
        if len(self.held) != WORKERS:
            raise AssertionError(f"{len(self.held)} filters built in a step")
        nz = [xb != 0 for xb, _ in self.held]
        filt = functools.reduce(torch.bitwise_or, [w for _, w in self.held])
        self.steps.append({
            "coordinates": nz[0].numel(),
            "worker_nnz": [int(m.sum()) for m in nz],
            "union_nnz": int(functools.reduce(torch.logical_or, nz).sum()),
            "filter_bits": filt.numel() * 32,
            "filter_set_bits": int(index_lib.popcount(filt))})
        self.held.clear()


def phase_train(dev, phase="train", wire="f32", fields=None, tc_fields=None,
                want=None, emit_line=True, wire_plan=None, steps=STEPS,
                arch_name="granite-3-2b", layers=LAYERS):
    """The main path: ``compressed`` (``wire="f32"``) or, with
    ``wire="fxp32"``, ``compressed_innet`` on the fxp32 wire; ``fields``
    override the config's compression fields (the Bloom path:
    ``index="bloom"``, a 0.1% top-k; the streamed paths: ``overlap``),
    ``tc_fields`` its train fields (``aggregator``, ``zero1``,
    ``ep_exchange``, ``ep_workers``), ``arch_name`` and ``layers`` the
    model and its depth,
    ``wire_plan`` the aggregator's wire plan, and ``want`` the launch
    counts the run of ``steps`` steps must give (default: the unstreamed
    paths'). The launch counters are zeroed just before the run and read
    just after; the parameters' sha256 is taken after every step, outside
    the step's clock."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training

    arch = get_arch(arch_name)
    mcfg = dataclasses.replace(arch.model, n_layers=layers)
    innet = wire == "fxp32"
    tc = dataclasses.replace(
        arch.train, workers=WORKERS, accum_steps=1, remat="none",
        aggregator="compressed_innet" if innet else "compressed",
        compression=dataclasses.replace(arch.train.compression, wire_dtype=wire,
                                        **(fields or {})))
    tc = dataclasses.replace(tc, **(tc_fields or {}))
    bloom = tc.compression.index == "bloom"
    api = model_api(mcfg)
    torch.cuda.reset_peak_memory_stats()
    observer = BloomObserver() if bloom else None
    params = api.init(tc.seed, dev)
    digests = []

    def after_step(line):
        if observer is not None:
            observer.after_step(line)
        digests.append(param_digest(params))

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    if bloom:
        with observer:
            res = run_training(api, tc, global_batch=BATCH, seq_len=SEQ,
                               steps=steps, device=dev, params=params,
                               log_every=1, log_fn=after_step)
    else:
        res = run_training(api, tc, global_batch=BATCH, seq_len=SEQ,
                           steps=steps, device=dev, params=params,
                           log_every=1, log_fn=after_step,
                           wire_plan=wire_plan)
    launches = dict(ops.LAUNCHES)
    expect = dict.fromkeys(ops.LAUNCHES, 0)
    if want is not None:
        expect.update(want)
    elif bloom:
        # per step: W standalone encodes, one standalone peel, no fused leg
        expect.update(sketch_encode=WORKERS * steps, sketch_peel=steps)
    else:
        # per step: W f32 producer launches, then one consumer launch (the
        # dequant leg on the fxp32 wire); the quantize leg is off the path
        expect.update(encode_pack_quantize=WORKERS * steps)
        expect["dequant_peel_unpack_dq" if innet else "dequant_peel_unpack"] = steps
    if launches != expect:
        raise AssertionError(f"{phase}: launch counts {launches}, expected {expect}")
    if not all(torch.isfinite(torch.tensor(res.losses))):
        raise AssertionError(f"non-finite loss: {res.losses}")
    recovery = [{k[len("recovery_"):]: int(m[k]) for k in m
                 if k.startswith("recovery_")} for m in res.metrics]
    for r in recovery:
        if r["nnz"] != r["peeled"] + r["residual"]:
            raise AssertionError("recovery stats do not add up")
    n_params = sum(p.numel() for p in res.state.params.leaves())
    out = {"phase": phase, "arch": arch_name, "dtype": mcfg.dtype,
           "params": n_params,
           "reduced": {"n_layers": f"{arch.model.n_layers} -> {layers}"},
           "workers": WORKERS, "global_batch": BATCH, "seq_len": SEQ,
           "aggregator": tc.aggregator, "wire": wire,
           "index": tc.compression.index, "topk_ratio": tc.compression.topk_ratio,
           "topology": tc.compression.topology,
           "switch_slots": tc.compression.switch_slots,
           "overlap": tc.compression.overlap, "zero1": tc.zero1,
           "ep_exchange": tc.ep_exchange, "ep_workers": tc.ep_workers,
           "steps": steps, "warmup_steps": 1,
           "step_ms": [s * 1e3 for s in res.step_seconds[1:]],
           "warmup_ms": res.step_seconds[0] * 1e3,
           "losses": res.losses, "launches": launches, "recovery": recovery,
           "param_sha256_by_step": digests,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    if bloom:
        for r, o in zip(recovery, observer.steps):
            if r["nnz"] < o["union_nnz"]:
                raise AssertionError("fewer candidates than true non-zeros")
            o.update(fill=o["filter_set_bits"] / o["filter_bits"],
                     candidates=r["nnz"],
                     false_positives=r["nnz"] - o["union_nnz"],
                     false_positive_share=(r["nnz"] - o["union_nnz"])
                     / o["coordinates"])
        out["bloom"] = observer.steps
        out["peak_mem_note"] = ("includes the observer's references to both "
                                "workers' block streams")
    if emit_line:
        emit(out)
    return out, launches, api, tc, res.state


def phase_breakdown(api, tc, state, step_ms, dev, phase="breakdown",
                    loss_kw=None, extra=None):
    """CUDA-event time of each stage of the train step, run one at a time
    on the trained state at the step's shapes (median of 5), so the
    stages can be set against the measured step time. On the fxp32
    in-network wire the sum/OR and the consumer give way to the exponent
    agreement and quantization, the windowed switch tree and the dequant
    consumer; with the Bloom index the producer's parts (encode kernel,
    ``bloom_build``, the max) and the consumer's (``bloom_query``, peel
    kernel) are timed apart. ``loss_kw`` goes to the model's loss (the
    MoE path's ``ep_exchange``), ``extra`` into the printed line."""
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.core.aggregators import sparsify_leaf
    from repro_torch.core.blocks import make_plan, to_blocks
    from repro_torch.core.bucketing import make_bucket_plan
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.core.compressor import CompressedLeaf, HomomorphicCompressor
    from repro_torch.data.pipeline import batch_fn
    from repro_torch.kernels import ops
    from repro_torch.net.fixedpoint import FixedPointWire
    from repro_torch.net.topology import make_topology, tree_all_reduce
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import device_batch

    cfg, W = tc.compression, tc.workers
    bloom = cfg.index == "bloom"
    params = state.params
    leaves = params.leaves()
    host = batch_fn(api.cfg, BATCH, SEQ, seed=tc.seed)(0)
    batch = device_batch(host, dev)
    per = BATCH // W

    def fwd_bwd(w=0):
        rows = {k: v[w * per: (w + 1) * per] for k, v in batch.items()}
        loss, _ = api.loss(params.tree(), rows, **(loss_kw or {}))
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
        stages = {"sparsify_pack": (W, cuda_ms(sparsify_pack, 5, 1))}
        if bloom:
            lp = make_plan(stream.numel(), cfg)
            xb0, sk0 = to_blocks(stream, lp), cs[0].sketch
            ids = torch.arange(lp.nb, dtype=torch.int32, device=dev)
            stages["encode_kernel"] = (W, cuda_ms(
                lambda: ops.sketch_encode(xb0, ids, cfg), 5, 1))
            stages["bloom_build"] = (W, cuda_ms(
                lambda: index_lib.bloom_build(xb0, cfg), 5, 1))
            stages["maxabs"] = (W, cuda_ms(lambda: sk0.abs().amax(dim=(1, 2)), 5, 1))
        else:
            stages["producer"] = (W, cuda_ms(lambda: comp.compress(stream), 5, 1))
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
            if bloom:
                bshape = (lp.nb, lp.group, lp.lanes)
                query = lambda: index_lib.bloom_query(bshape, cfg, agg.index_words)
                bits = query()
                stages["bloom_query"] = (1, cuda_ms(query, 5, 1))
                stages["peel_kernel"] = (1, cuda_ms(
                    lambda: ops.sketch_peel(agg.sketch, bits, ids, cfg), 5, 1))
                del bits
            else:
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

        def zero_residual_selection(g):
            """Worker 0's selection of one leaf with a zero residual, as at
            step 0: the share sent, the share whose magnitude ties the
            smallest one sent (the threshold's level), and how many
            distinct magnitudes are sent."""
            flat = g.reshape(-1).float()
            mags = flat.abs()
            sent = sparsify_leaf(flat, torch.zeros_like(flat), cfg)[0] != 0
            if not bool(sent.any()):
                return {"sent": 0.0, "tied_at_threshold": 0.0, "distinct_sent": 0}
            return {"sent": float(sent.float().mean()),
                    "tied_at_threshold": float((mags == mags[sent].min()).float().mean()),
                    "distinct_sent": int(torch.unique(mags[sent]).numel())}

        selection = {"/".join(path): zero_residual_selection(g)
                     for path, g in zip(params.paths, grads)}
    stages = {"forward_backward": (W, cuda_ms(fwd_bwd, 5, 1)), **stages}
    total = sum(n * ms for n, ms in stages.values())
    out = {"phase": phase, "step_ms_median": statistics.median(step_ms),
           "stages_ms": {k: {"per_call": ms, "calls": n, "per_step": n * ms}
                         for k, (n, ms) in stages.items()},
           "sum_of_stages_ms": total, "worker0_sent_fraction": sent,
           "worker0_zero_residual_selection": selection, **(extra or {})}
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
    from repro_torch.kernels.sketch_wire import (dequant_peel_unpack_cuda,
                                                 encode_pack_quantize_cuda)
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
    enc_digests = {f"dyadic@0.04 worker{k}": digest(*g) for k, g in enumerate(qw)}
    del f32
    topo = make_topology("flat", group)
    q = tree_all_reduce([g[0].reshape(nbk, -1) for g in qw], topo, "add",
                        window_slots=cfg.switch_slots)[0].reshape(nb, R, c)
    w = tree_all_reduce([g[1].reshape(nbk, -1) for g in qw], topo, "or",
                        window_slots=cfg.switch_slots)[0].reshape(nb, -1)
    if not (torch.equal(q, group.sum([g[0] for g in qw]))
            and torch.equal(w, group.bor([g[1] for g in qw]))):
        raise AssertionError("windowed tree differs from the flat sum/OR")
    out = check.consumer_dq(q, w, ids, cfg, wire, e, True)
    digests = {"dyadic@0.04x2": digest(*out)}
    res = out[1]
    x0 = xs[0]
    del xs, out
    torch.cuda.empty_cache()

    n_el = nb * G * c
    nnz0 = int((x0 != 0).sum())
    nnz = int(index_lib.popcount(w))
    n_res = int(res.sum())
    y = wire.decode(q.reshape(nb, -1), e).reshape(q.shape)
    rounds = peel_blocks(y, index_lib.unpack_bits(w.reshape(-1), (nb, G, c)),
                         ids, cfg).rounds_used
    del y
    hist = block_rounds(lambda r: dequant_peel_unpack_cuda(
        q, w, ids, cfg, exponents=e, mantissa_bits=M, block_rounds=r),
        nb, dev, rounds)
    emit({"phase": "innet_stream", "blocks": nb, "buckets": nbk,
          "blocks_per_bucket": nbpb, "workers": WORKERS, "mantissa_bits": M,
          "switch_slots": cfg.switch_slots,
          "windows": -(-nbk // cfg.switch_slots), "agree": True,
          "int32_sketch_bytes_per_worker": nb * R * c * 4,
          "exponent_range": [int(e_bucket.min()), int(e_bucket.max())],
          "aggregate_nnz": nnz, "peeled": nnz - n_res, "estimated": n_res,
          "plain_rounds_to_fixpoint": rounds,
          "consumer_block_rounds_hist": hist,
          "sha256_sketch_words_maxabs": enc_digests,
          "sha256_values_residual": digests})
    hists = {"encode_pack_quantize_q": None, "dequant_peel_unpack_dq": hist}
    extra = {"encode_pack_quantize_q": {
        "phase_cycles_median": phase_medians(lambda pc: encode_pack_quantize_cuda(
            x0, ids, cfg, exponents=e, mantissa_bits=M, phase_cycles=pc), nb, dev)},
        "dequant_peel_unpack_dq": {}}
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
                     "bytes": nbytes, "ops": nops, **extra[name],
                     **occupancy_fields(name, cfg, dev, hists[name])})
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


def phase_bloom_stream(cfg, dev, n_blocks, check):
    """The standalone kernels at the Bloom path's full stream: the encode
    on one worker's 0.1% stream (Gaussian to rtol=1e-5, then dyadic bit
    for bit, and equal to the fused producer's sketch), the peel on the
    aggregate of two workers' 0.1% dyadic payloads with the candidates of
    their ORed filters (bit for bit, and equal to the fused consumer on
    the packed candidates). Times both kernels and their plain versions;
    then, for comparison with the fused consumer, the standalone peel and
    the fused consumer on the bitmap bits of two 4% payloads, equal bit
    for bit. Returns the two kernels' records."""
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.core.peeling import peel_blocks
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sketch_encode import sketch_encode_cuda
    from repro_torch.kernels.sketch_peel import sketch_peel_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    nb, G, c, R = n_blocks, cfg.group, cfg.lanes, cfg.rows
    n_el = nb * G * c
    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    group = LocalWorkers(WORKERS)
    density = cfg.topk_ratio
    xg = make_blocks(cfg, nb, density, "gauss", gen)
    skg = check.encode_std(xg, ids, cfg, False)
    enc_digests = {"gauss@0.001": digest(skg)}
    bits = index_lib.bloom_query((nb, G, c), cfg, index_lib.bloom_build(xg, cfg))
    digests = {"gauss@0.001": digest(*check.peel_std(skg, bits, ids, cfg, False))}
    del xg, skg, bits
    xs = [make_blocks(cfg, nb, density, "dyadic", gen) for _ in range(WORKERS)]
    enc = [check.encode_std(x, ids, cfg, True) for x in xs]
    for k, y in enumerate(enc):
        enc_digests[f"dyadic@0.001 worker{k}"] = digest(y)
    sk = group.sum(enc)
    del enc
    filt = group.bor([index_lib.bloom_build(x, cfg) for x in xs])
    bits = index_lib.bloom_query((nb, G, c), cfg, filt)
    union = functools.reduce(torch.logical_or, [x != 0 for x in xs])
    if not bool(bits[union].all()):
        raise AssertionError("the Bloom query missed a non-zero of the union")
    out = check.peel_std(sk, bits, ids, cfg, True)
    digests["dyadic@0.001x2"] = digest(*out)
    res = out[1]
    x0 = xs[0]
    nnz0, n_union = int((x0 != 0).sum()), int(union.sum())
    del xs, union, out
    torch.cuda.empty_cache()
    cand, n_res = int(bits.sum()), int(res.sum())
    rounds = peel_blocks(sk, bits, ids, cfg).rounds_used
    per_round = round_stats(bits, ids, cfg)
    hist = block_rounds(lambda r: sketch_peel_cuda(sk, bits, ids, cfg,
                                                   block_rounds=r), nb, dev, rounds)
    by_rounds = ms_by_rounds(lambda k: ops.sketch_peel(sk, bits, ids, k),
                             cfg, (0, 1, cfg.rounds))

    # the standalone peel on the bitmap bits of two 4% payloads, beside the
    # fused consumer on their words (the main path's consumer, row 2)
    xs4 = [make_blocks(cfg, nb, 0.04, "dyadic", gen) for _ in range(WORKERS)]
    sk4 = group.sum([ops.sketch_encode(x, ids, cfg) for x in xs4])
    bits4 = functools.reduce(torch.logical_or, [x != 0 for x in xs4])
    del xs4
    torch.cuda.empty_cache()
    twin = fused_twin(cfg)
    words4 = index_lib.pack_bits(bits4).reshape(nb, -1)
    std4 = ops.sketch_peel(sk4, bits4, ids, cfg)
    if not all(torch.equal(a, b) for a, b in
               zip(std4, ops.dequant_peel_unpack(sk4, words4, ids, twin))):
        raise AssertionError("standalone peel differs from the fused consumer")
    n4, n4_res = int(bits4.sum()), int(std4[1].sum())
    digests["bitmap_dyadic@0.04x2"] = digest(*std4)
    del std4
    peel4_ms = cuda_ms(lambda: ops.sketch_peel(sk4, bits4, ids, cfg), 5)
    fused4_ms = cuda_ms(lambda: ops.dequant_peel_unpack(sk4, words4, ids, twin), 5)
    del sk4, bits4, words4
    torch.cuda.empty_cache()
    emit({"phase": "bloom_stream", "blocks": nb, "workers": WORKERS,
          "density_per_worker": density, "agree": True,
          "worker0_nnz": nnz0, "union_nnz": n_union,
          "filter_bits": filt.numel() * 32,
          "filter_fill": int(index_lib.popcount(filt)) / (filt.numel() * 32),
          "candidates": cand, "false_positives": cand - n_union,
          "peeled": cand - n_res, "estimated": n_res,
          "plain_rounds_to_fixpoint": rounds, "peel_block_rounds_hist": hist,
          "peel_ms_by_rounds_cap": by_rounds,
          "plain_per_round_per_block": per_round,
          "bitmap_4pct": {"aggregate_nnz": n4, "estimated": n4_res,
                          "standalone_peel_ms": peel4_ms,
                          "fused_consumer_ms": fused4_ms,
                          "equal_bit_for_bit": True},
          "sha256_sketch": enc_digests,
          "sha256_values_residual": digests})
    # bytes: each input read once, each output written once (ids included);
    # operations as phase 6's: sign x value + add per (non-zero, hash) and
    # the store of each cell; the peel's initial degrees, a degree test per
    # (candidate, hash, round) to the fixpoint, 9 per peeled candidate and
    # 10 per estimate
    enc_bytes = n_el * 4 + nb * 4 + nb * R * c * 4
    dec_bytes = nb * R * c * 4 + n_el + nb * 4 + n_el * 4 + n_el
    enc_ops = 6 * nnz0 + nb * R * c
    dec_ops = 3 * cand + 3 * cand * rounds + 9 * (cand - n_res) + 10 * n_res
    hists = {"sketch_encode": None, "sketch_peel": hist}
    extra = {"sketch_encode": {
        "phase_cycles_median": phase_medians(lambda pc: sketch_encode_cuda(
            x0, ids, cfg, phase_cycles=pc), nb, dev),
        "ms_by_density": ms_by_density(
            lambda x: ops.sketch_encode(x, ids, cfg), cfg, nb, gen)},
        "sketch_peel": {}}
    recs = []
    for name, kfn, pfn, nbytes, nops, replaces, pit in [
        ("sketch_encode", lambda: ops.sketch_encode(x0, ids, cfg),
         lambda: ref.sketch_encode_ref(x0, ids, cfg), enc_bytes, enc_ops,
         "src/repro/kernels/sketch_encode.py:114", 5),
        ("sketch_peel", lambda: ops.sketch_peel(sk, bits, ids, cfg),
         lambda: ref.sketch_peel_ref(sk, bits, ids, cfg), dec_bytes, dec_ops,
         "src/repro/kernels/sketch_peel.py:133", 3),
    ]:
        b_ms, b_by = bound(nbytes, nops)
        recs.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/sketch_codec.cu",
                     "replaces": replaces, "launches": None,
                     "max_abs_err": check.err[name], "ms": cuda_ms(kfn, 10),
                     "plain_ms": cuda_ms(pfn, pit, warmup=1), "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "blocks": nb,
                     "bytes": nbytes, "ops": nops, **extra[name],
                     **occupancy_fields(name, cfg, dev, hists[name])})
    del x0, sk, bits
    torch.cuda.empty_cache()
    return recs


def phase_bloom_lossless(mcfg, dev):
    """1%-dense dyadic gradients of the model per worker in the lossless
    profile (rows 60, ratio 2; the peel keeps its state in device memory)
    with the Bloom index: the ``compressed`` aggregate equals the dense
    mean bit for bit at every coordinate, so the filter's false positives
    (candidates beyond the true union) peel to exactly 0."""
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
    gen.manual_seed(17)
    group = LocalWorkers(WORKERS)
    grads_w = dyadic_grads(shapes, 0.01, gen, dev)
    stubs = [torch.zeros((0,), device=dev) for _ in shapes]
    cfg = CompressionConfig(ratio=2.0, rows=60, index="bloom")
    before = dict(ops.LAUNCHES)
    t = time.perf_counter()
    out, st = make_aggregator("compressed", cfg, group)(
        grads_w, AggregationState(residual=stubs))
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t
    delta = {k: ops.LAUNCHES[k] - before[k] for k in before}
    if delta != dict(dict.fromkeys(before, 0), sketch_encode=WORKERS, sketch_peel=1):
        raise AssertionError(f"launches {delta}: expected W encodes and one peel")
    dense = make_aggregator("dense", cfg, group)(
        grads_w, AggregationState(residual=None))[0]
    differ = sum(int((a != b).sum()) for a, b in zip(out, dense))
    union = sum(int(((a != 0) | (b != 0)).sum()) for a, b in zip(*grads_w))
    nnz, n_est = int(st.stats.nnz), int(st.stats.residual)
    if differ or n_est:
        raise AssertionError(
            f"{differ} coordinates differ from the dense mean, {n_est} of "
            f"{nnz} candidates fell back to the estimate")
    emit({"phase": "bloom_lossless", "profile": {"ratio": 2.0, "rows": 60},
          "index": "bloom", "density_per_worker": 0.01, "union_nnz": union,
          "candidates": nnz, "false_positives": nnz - union,
          "peeled": int(st.stats.peeled), "estimated": n_est,
          "differ_from_dense": differ, "equal_to_dense_everywhere": True,
          "aggregate_s": agg_s})


DIST_TIMEOUT = 600       # seconds the dist_train ranks may take in all
PROBE_TIMEOUT = 90       # seconds a backend probe's ranks may take


def param_digest(params):
    """sha256 of a model's parameter bytes, leaf after leaf."""
    import torch
    h = hashlib.sha256()
    for t in params.leaves():
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


class WireLog:
    """The group a ``dist_train`` / ``dist_rs`` / ``dist_auto`` rank hands
    its step: each collective goes on to the rank's
    ``ProcessGroupWorkers``; the log keeps each one's op, shape, dtype and
    name (``step_calls``: the last step's) and the last word OR's input
    and output (references to the step's own tensors). With ``timed``, a
    streamed aggregation's reduces go through :class:`TimedIssue`
    (``streams``: one timeline a stream). With ``bucket_elems``, a sum of
    whole buckets (a wire plan's dense group) is named apart."""

    def __init__(self, group, timed=False, bucket_elems=None):
        self.group, self.calls, self.step_calls, self.words = group, [], [], None
        self.timed, self.streams, self.scattered = timed, [], False
        self.bucket_elems = bucket_elems

    def __getattr__(self, name):
        return getattr(self.group, name)

    def _note(self, op, parts):
        self.calls.append((op, tuple(parts[0].shape), parts[0].dtype,
                           self._label(op)))
        return getattr(self.group, op)(parts)

    def _label(self, op):
        """The replay's name for a call: the reduce-scatters by payload,
        and a gather by where it falls in the step (the first after the
        word reduce-scatter restores the recovered chunks; the others
        gather the ZeRO-1 deltas)."""
        if op == "bor_scatter":
            self.scattered = True
            return "word_reduce_scatter"
        if op == "gather":
            label = "recovered_chunk_gather" if self.scattered \
                else "zero1_delta_gather"
            self.scattered = False
            return label
        return {"sum_scatter": "sketch_reduce_scatter"}.get(op, op)

    def sum(self, parts):
        if self.bucket_elems is not None and parts[0].dim() == 2 and \
                parts[0].shape[1] == self.bucket_elems:
            self.calls.append(("sum", tuple(parts[0].shape), parts[0].dtype,
                               "dense_group_sum"))
            return self.group.sum(parts)
        return self._note("sum", parts)

    def max(self, parts):
        return self._note("max", parts)

    def bor(self, parts):
        out = self._note("bor", parts)
        self.words = (parts[0], out)
        return out

    def sum_scatter(self, parts):
        return self._note("sum_scatter", parts)

    def bor_scatter(self, parts):
        return self._note("bor_scatter", parts)

    def gather(self, parts):
        return self._note("gather", parts)

    def issuer(self):
        inner = self.group.issuer()
        return TimedIssue(inner, self) if self.timed else inner

    def end_step(self):
        self.step_calls, self.calls = self.calls, []


def replay_collectives(group, calls, dev, staging=False):
    """A step's logged collectives (``calls``: op, shape, dtype, name)
    replayed alone on zero buffers, three times, each with the host clock
    around it and a synchronise, totals and medians by name; with
    ``staging``, also the copies to the wire's memory and back alone."""
    import collections
    import torch
    import torch.distributed as dist
    bufs = [(name, op, torch.zeros(shape, dtype=dtype, device=dev))
            for op, shape, dtype, name in calls]
    runs, by_label, copies = [], collections.defaultdict(list), []
    for _ in range(3):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        per = collections.Counter()
        for name, op, b in bufs:
            t = time.perf_counter()
            getattr(group, op)([b])
            torch.cuda.synchronize()
            per[name] += (time.perf_counter() - t) * 1e3
        runs.append((time.perf_counter() - t0) * 1e3)
        for name, ms in per.items():
            by_label[name].append(ms)
    nbytes = collections.Counter()
    for name, _, b in bufs:
        nbytes[name] += b.numel() * b.element_size()
    out = {"ms": runs, "ms_median": statistics.median(runs),
           "ms_median_by_op": {k: statistics.median(v) for k, v in by_label.items()},
           "calls": dict(collections.Counter(name for name, _, _ in bufs)),
           "payload_bytes": dict(nbytes),
           "payload_bytes_total": sum(nbytes.values())}
    if staging:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _, _, b in bufs:
                group.to_wire(b).to(b.device)
            torch.cuda.synchronize()
            copies.append((time.perf_counter() - t0) * 1e3)
        out["staging_copies_ms_median"] = statistics.median(copies)
    return out


def dist_rank(group, dev):
    """One rank of ``dist_train``: the compressed arm, then the dense arm
    on the same process group, each a fresh train of the phase-4 setup
    with this rank's worker. Per step the sha256 of the parameters; per
    arm the launch counters (zeroed just before the run, read just
    after), the peak memory, the last step's collectives replayed alone
    (host clock, synchronised, three times) and their payload bytes; for
    the compressed arm the OR check."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch("granite-3-2b")
    api = model_api(dataclasses.replace(arch.model, n_layers=LAYERS))
    out = {"rank": group.rank, "device": str(dev), "backend": group.backend,
           "staging": group.staging, "arms": {}}
    for aggregator in ("compressed", "dense"):
        tc = dataclasses.replace(arch.train, workers=WORKERS, accum_steps=1,
                                 remat="none", aggregator=aggregator)
        log = WireLog(group)
        params = api.init(tc.seed, dev)
        digests = []

        def after_step(_line):
            log.end_step()
            digests.append(param_digest(params))

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        res = run_training(api, tc, global_batch=BATCH, seq_len=SEQ,
                           steps=STEPS, device=dev, params=params,
                           log_every=1, log_fn=after_step, group=log)
        launches = dict(ops.LAUNCHES)
        arm = {"losses": res.losses, "digests": digests, "launches": launches,
               "step_ms": [t * 1e3 for t in res.step_seconds[1:]],
               "warmup_ms": res.step_seconds[0] * 1e3,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "recovery": [{k[len("recovery_"):]: int(m[k]) for k in m
                             if k.startswith("recovery_")} for m in res.metrics]}
        if aggregator == "compressed":
            w_in, w_out = log.words
            wire = group.to_wire(w_in)
            gathered = [torch.empty_like(wire) for _ in range(group.workers)]
            dist.all_gather(gathered, wire)
            ored = functools.reduce(torch.bitwise_or, gathered)
            arm["or_check"] = {
                "words": w_in.numel(),
                "words_with_bit31": int((w_out < 0).sum()),
                "equal_to_all_gather_or": bool(torch.equal(ored.cpu(), w_out.cpu()))}
            log.words = None
            del w_in, w_out, wire, gathered, ored
        arm["collectives"] = replay_collectives(group, log.step_calls, dev,
                                                staging=True)
        out["arms"][aggregator] = arm
        del res, params, log
        torch.cuda.empty_cache()
    return out


def probe_rank(group, dev, kind):
    """What a backend does with two ranks on one card: ``"nccl"`` an
    ``all_reduce``; ``"gloo_p2p"`` a send of a CUDA tensor from rank 0
    to rank 1 with no staging. Either returns what arrived."""
    import resource
    import torch
    import torch.distributed as dist
    resource.setrlimit(resource.RLIMIT_CORE, (0, 0))   # no core file if it aborts
    x = torch.full((4,), float(group.rank + 1), device=dev)
    if kind == "nccl":
        dist.all_reduce(x)
    elif group.rank == 0:
        dist.send(x, 1)
    else:
        dist.recv(x, 0)
    torch.cuda.synchronize()
    return x.tolist()


def probe(kind):
    """A backend probe's outcome: what the ranks returned, or the first
    and last lines of the error that ended them (a rank that aborts
    leaves its own message on stderr)."""
    from repro_torch.launch.ranks import spawn_ranks
    try:
        got = spawn_ranks(probe_rank, WORKERS, (kind,), device="cuda",
                          timeout=PROBE_TIMEOUT,
                          backend="nccl" if kind == "nccl" else "gloo")
        return {"ok": True, "received": got}
    except (RuntimeError, TimeoutError) as e:
        lines = [l for l in str(e).splitlines() if l.strip()]
        return {"ok": False, "error": lines[:1] + lines[-2:]}


def phase_dist_train(emulated_losses):
    """W=2 ranks as processes sharing ``cuda:0`` over gloo (NCCL refuses
    two ranks on one device: the probe's error is printed), the phase-4
    train on the compressed arm and then the dense arm, one worker a
    rank. Fails unless each rank launched exactly one producer and one
    consumer a step (compressed; none dense), every rank's parameter
    digest is equal after every step, the OR all-reduce of the last
    step's real words equals an ``all_gather`` and a local OR, and the
    losses are finite and within rtol 1e-3 of the emulated ``train``
    phase's (backward atomics make bit equality unlikely: the first
    step's loss is forward only and is reported apart)."""
    from repro_torch.launch.ranks import spawn_ranks

    t0 = time.perf_counter()
    outs = spawn_ranks(dist_rank, WORKERS, device="cuda", timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    want = dict.fromkeys(outs[0]["arms"]["compressed"]["launches"], 0)
    want.update(encode_pack_quantize=STEPS, dequant_peel_unpack=STEPS)
    arms = {}
    for name in ("compressed", "dense"):
        per = [o["arms"][name] for o in outs]
        for r, a in enumerate(per):
            expect = want if name == "compressed" else dict.fromkeys(want, 0)
            if a["launches"] != expect:
                raise AssertionError(f"rank {r} {name}: launch counts "
                                     f"{a['launches']}, expected {expect}")
            if not all(map(math.isfinite, a["losses"])):
                raise AssertionError(f"rank {r} {name}: non-finite loss")
        if any(a["digests"] != per[0]["digests"] for a in per) or \
                len(per[0]["digests"]) != STEPS:
            raise AssertionError(f"{name}: parameter digests differ across ranks")
        if any(a["losses"] != per[0]["losses"] for a in per):
            raise AssertionError(f"{name}: ranks report different losses")
        arms[name] = {
            "losses": per[0]["losses"],
            "step_ms_by_rank": [a["step_ms"] for a in per],
            "warmup_ms_by_rank": [a["warmup_ms"] for a in per],
            "collectives_ms_by_rank": [a["collectives"]["ms"] for a in per],
            "collectives_ms_median_by_rank": [a["collectives"]["ms_median"]
                                              for a in per],
            "collectives_ms_median_by_op_by_rank": [
                a["collectives"]["ms_median_by_op"] for a in per],
            "staging_copies_ms_median_by_rank": [
                a["collectives"]["staging_copies_ms_median"] for a in per],
            "collective_calls": per[0]["collectives"]["calls"],
            "payload_bytes_per_rank_step": per[0]["collectives"]["payload_bytes"],
            "payload_bytes_total_per_rank_step":
                per[0]["collectives"]["payload_bytes_total"],
            "peak_mem_bytes_by_rank": [a["peak_mem_bytes"] for a in per],
            "launches_by_rank": [a["launches"] for a in per],
            "param_sha256_by_step": per[0]["digests"]}
    comp = outs[0]["arms"]["compressed"]
    for r, o in enumerate(outs):
        if not o["arms"]["compressed"]["or_check"]["equal_to_all_gather_or"]:
            raise AssertionError(f"rank {r}: OR all-reduce differs from "
                                 "all_gather + OR")
    rel = [abs(a - b) / abs(b) for a, b in zip(comp["losses"], emulated_losses)]
    if max(rel) > 1e-3:
        raise AssertionError(f"dist losses {comp['losses']} vs emulated "
                             f"{emulated_losses}")
    dense = outs[0]["arms"]["dense"]["collectives"]
    arms["compressed"].update(
        recovery=comp["recovery"], or_check=comp["or_check"],
        emulated_losses=emulated_losses, loss_rel_diff_to_emulated=rel,
        first_loss_equal_to_emulated=comp["losses"][0] == emulated_losses[0])
    line = {"phase": "dist_train", "arch": "granite-3-2b", "layers": LAYERS,
            "workers": WORKERS, "procs": WORKERS, "global_batch": BATCH,
            "seq_len": SEQ, "steps": STEPS, "warmup_steps": 1,
            "backend": outs[0]["backend"], "staging": outs[0]["staging"],
            "devices": [o["device"] for o in outs],
            "wall_s": wall, "arms": arms,
            "probes": {"nccl_two_ranks_one_device": probe("nccl"),
                       "gloo_p2p_cuda_tensor": probe("gloo_p2p")}}
    emit(line)
    # the dense arm's all-reduces, bytes over their time alone (rank 0):
    # the link the wires cross here, gloo host-staged on one card
    link = {"bytes": dense["payload_bytes_total"], "ms": dense["ms_median"]}
    return {k: sum(o["arms"]["compressed"]["launches"][k] for o in outs)
            for k in want}, link


# ----------------------------------------------------------------------
# The streamed wire, the reduce-scatter wire and ZeRO-1
# ----------------------------------------------------------------------

def meta_leaves(shapes_dtypes):
    """Shape-only leaves (``meta`` tensors) for plans and predicates."""
    import torch
    return [torch.empty(sh, dtype=dt, device="meta") for sh, dt in shapes_dtypes]


def stream_grids(shapes_dtypes, cfg):
    """The bucket plan of the model's stream and the chunk grids of the
    new paths: the all-reduce grid with ``overlap`` (a bucket a chunk),
    the innet window grid and the reduce-scatter grid over W."""
    from repro_torch.core.bucketing import make_bucket_plan
    from repro_torch.core.streams import make_stream_plan
    plan = make_bucket_plan(meta_leaves(shapes_dtypes), cfg)
    over = dataclasses.replace(cfg, overlap=True)
    return plan, {
        "allreduce": make_stream_plan(plan, over),
        "innet": make_stream_plan(plan, over, window_buckets=cfg.switch_slots),
        "scatter": make_stream_plan(plan, over, workers=WORKERS, scatter=True)}


def synthetic_stream(cfg, plan, gen, frac=0.04):
    """A worker's Gaussian ``(n_buckets, E)`` stream at ``frac`` density."""
    nb = plan.padded // cfg.block_elems
    return make_blocks(cfg, nb, frac, "gauss", gen).reshape(
        plan.n_buckets, plan.bucket_elems)


def phase_stream_train(dev, cfg, train, innet, shapes_dtypes):
    """LocalWorkers, W=2: ``compressed`` and ``compressed_innet`` (fxp32)
    with ``overlap=True``. Per step W producer launches a chunk (415
    one-bucket chunks; 52 chunks of 8 switch slots) and one consumer
    launch on the reassembled stream; the parameters' sha256 after every
    step and the losses equal the unstreamed phases' (chunking is
    bit-invisible). Then the producer stage chunked (one launch a chunk)
    beside the one-launch producer, on a synthetic 4% stream."""
    import torch
    from repro_torch.core.compressor import HomomorphicCompressor

    plan, grids = stream_grids(shapes_dtypes, cfg)
    arms, launches = {}, {}
    for name, base, wire, grid, consumer in (
            ("compressed_overlap", train, "f32", grids["allreduce"],
             "dequant_peel_unpack"),
            ("innet_fxp32_overlap", innet, "fxp32", grids["innet"],
             "dequant_peel_unpack_dq")):
        want = {"encode_pack_quantize": WORKERS * grid.n_chunks * STEPS,
                consumer: STEPS}
        out, launches[name], _, _, state = phase_train(
            dev, phase=name, wire=wire, fields={"overlap": True}, want=want,
            emit_line=False)
        del state
        torch.cuda.empty_cache()
        if out["param_sha256_by_step"] != base["param_sha256_by_step"] or \
                out["losses"] != base["losses"] or \
                out["recovery"] != base["recovery"]:
            raise AssertionError(f"{name}: parameters, losses or recovery "
                                 f"differ from the unstreamed {base['phase']} phase")
        arms[name] = {k: out[k] for k in (
            "step_ms", "warmup_ms", "losses", "launches", "recovery",
            "param_sha256_by_step", "peak_mem_bytes")}
        arms[name].update(n_chunks=grid.n_chunks, chunk_buckets=grid.chunk_buckets,
                          equal_to=base["phase"],
                          unstreamed_step_ms=base["step_ms"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    comp = HomomorphicCompressor(cfg)
    stream = synthetic_stream(cfg, plan, gen)
    stages = {}
    for name, grid in (("allreduce", grids["allreduce"]), ("innet", grids["innet"])):
        view = grid.chunk_view(stream)
        n = grid.n_chunks

        def chunked():
            for i in range(n):
                comp.compress_wire(view[i].reshape(-1),
                                   block_offset=grid.chunk_start_block(i))

        stages[name] = {
            "chunks": n, "blocks_per_chunk": grid.chunk_buckets * grid.blocks_per_bucket,
            "chunked_ms": cuda_ms(chunked, 3, 1),
            "per_launch_ms": cuda_ms(lambda: comp.compress_wire(
                view[0].reshape(-1)), 20)}
        del view
    stages["one_launch_ms"] = cuda_ms(lambda: comp.compress(stream.reshape(-1)), 5, 1)
    del stream
    torch.cuda.empty_cache()
    emit({"phase": "stream_train", "workers": WORKERS, "arms": arms,
          "producer_stage": stages})
    return launches


def phase_rs_train(dev, cfg, train, shapes_dtypes, consumer_ms):
    """LocalWorkers, W=2: ``compressed_rs`` on the native wire with
    ZeRO-1, one-shot and streamed (208 chunks of 2 buckets, one bucket a
    rank a chunk). Per step W producer launches (W a chunk streamed) and
    W consumer launches, each on its worker's half (W a chunk streamed).
    The two runs' parameter sha256 must be equal after every step and
    equal to phase ``train``'s, which takes the ZeRO-1 update too (the
    reduce-scatter wire's aggregate is ``compressed``'s bit for bit), and
    the losses equal. Then the
    consumer on a half stream (208 buckets) and on one chunk's slice (one
    bucket), beside the whole stream, on a synthetic two-worker 4%
    aggregate."""
    import torch
    from repro_torch.core.compressor import CompressedLeaf, HomomorphicCompressor

    plan, grids = stream_grids(shapes_dtypes, cfg)
    grid = grids["scatter"]
    arms, launches = {}, {}
    for name, fields, chunks in (("oneshot", {}, 1),
                                 ("streamed", {"overlap": True}, grid.n_chunks)):
        want = {"encode_pack_quantize": WORKERS * chunks * STEPS,
                "dequant_peel_unpack": WORKERS * chunks * STEPS}
        out, launches[name], _, _, state = phase_train(
            dev, phase=f"rs_{name}", fields=fields, want=want, emit_line=False,
            tc_fields={"aggregator": "compressed_rs", "zero1": True})
        del state
        torch.cuda.empty_cache()
        arms[name] = {k: out[k] for k in (
            "step_ms", "warmup_ms", "losses", "launches", "recovery",
            "param_sha256_by_step", "peak_mem_bytes")}
        arms[name]["n_chunks"] = chunks
    if arms["oneshot"]["param_sha256_by_step"] != arms["streamed"]["param_sha256_by_step"]:
        raise AssertionError("rs_train: one-shot and streamed parameters differ")
    rel = [abs(a - b) / abs(b) for a, b in zip(arms["oneshot"]["losses"],
                                               train["losses"])]
    if arms["oneshot"]["param_sha256_by_step"] != train["param_sha256_by_step"] \
            or arms["oneshot"]["losses"] != train["losses"]:
        raise AssertionError(f"rs_train parameters or losses "
                             f"{arms['oneshot']['losses']} differ from train's "
                             f"{train['losses']}")
    # the slices' stats add up to the whole stream's: equal to train's at
    # step 0 (the same parameters), and between the two arms at every step
    if arms["oneshot"]["recovery"] != arms["streamed"]["recovery"] or \
            arms["oneshot"]["recovery"][0] != train["recovery"][0]:
        raise AssertionError("rs_train recovery stats differ")

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    comp = HomomorphicCompressor(cfg)
    nbpb, wpb = grid.blocks_per_bucket, grid.words_per_bucket
    pad = grid.padded_buckets - plan.n_buckets
    parts = []
    for _ in range(WORKERS):
        c = comp.compress(synthetic_stream(cfg, plan, gen).reshape(-1))
        parts.append((torch.nn.functional.pad(c.sketch, (0, 0, 0, 0, 0, pad * nbpb)),
                      torch.nn.functional.pad(c.index_words, (0, pad * wpb))))
    sk = parts[0][0] + parts[1][0]
    words = parts[0][1] | parts[1][1]
    del parts
    half = grid.padded_buckets // WORKERS

    def consumer(b0, nbk):
        leaf = CompressedLeaf(sketch=sk[b0 * nbpb:(b0 + nbk) * nbpb],
                              index_words=words[b0 * wpb:(b0 + nbk) * wpb])
        return lambda: comp.recover(leaf, nbk * plan.bucket_elems,
                                    block_offset=b0 * nbpb)

    stages = {"breakdown_consumer_ms": consumer_ms,
              "whole_stream_ms": cuda_ms(consumer(0, plan.n_buckets), 5, 1),
              "half_stream_ms_by_rank": [cuda_ms(consumer(r * half, half), 5, 1)
                                         for r in range(WORKERS)],
              "half_stream_blocks": half * nbpb,
              "chunk_slice_ms": cuda_ms(consumer(0, grid.rank_chunk_buckets), 20),
              "chunk_slice_blocks": grid.rank_chunk_buckets * nbpb}
    del sk, words
    torch.cuda.empty_cache()
    emit({"phase": "rs_train", "workers": WORKERS, "rs_wire": "native",
          "zero1": True, "chunk_buckets": grid.chunk_buckets,
          "loss_rel_diff_to_train": rel, "arms": arms, "consumer_stage": stages})
    return launches, arms


class TimedIssue:
    """Wraps a rank's communication thread for the streamed arm of
    ``dist_rs``: a CUDA event on the main stream as each chunk's reduce is
    issued (right after its producer was enqueued) and the host clock
    around each reduce on the thread. When the stream starts the device
    is synchronised and an event recorded, which places the device's
    events on the host clock."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self.h0 = time.perf_counter()
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e0.record()
        self.marks = []
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        out = self.inner.__exit__(*exc)
        self.log.streams.append((self.h0, self.e0, self.marks))
        return out

    def __call__(self, fn, payload):
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        mark = {"issued": ev}

        def timed(p):
            mark["t0"] = time.perf_counter()
            out = fn(p)
            mark["t1"] = time.perf_counter()
            return out

        self.marks.append(mark)
        return self.inner(timed, payload)


def stream_overlap(h0, e0, marks):
    """One stream's reduce time and its overlap with the producers: chunk
    i's producer is in flight on the device between the events issued
    after chunks i-1 and i (its enqueue included); chunk i's reduce runs
    on the host between its stamps. ``overlap_next_ms``: chunk i's reduce
    against chunk i+1's producer; ``producers_under_reduces_ms``: each
    producer against every reduce (the thread runs one at a time)."""
    ends = [h0 + e0.elapsed_time(m["issued"]) / 1e3 for m in marks]
    starts = [h0] + ends[:-1]
    reduce_s = [m["t1"] - m["t0"] for m in marks]

    def meet(a0, a1, b0, b1):
        return max(0.0, min(a1, b1) - max(a0, b0))

    overlap = [meet(marks[i]["t0"], marks[i]["t1"], starts[i + 1], ends[i + 1])
               for i in range(len(marks) - 1)]
    under, k = 0.0, 0
    for s, e in zip(starts, ends):       # both sequences run in time order
        while k < len(marks) and marks[k]["t1"] <= s:
            k += 1
        j = k
        while j < len(marks) and marks[j]["t0"] < e:
            under += meet(s, e, marks[j]["t0"], marks[j]["t1"])
            j += 1
    return {"chunks": len(marks), "reduce_ms": sum(reduce_s) * 1e3,
            "producers_ms": sum(e - s for s, e in zip(starts, ends)) * 1e3,
            "overlap_next_ms": sum(overlap) * 1e3,
            "chunks_overlapping_next_producer": sum(o > 0 for o in overlap),
            "producers_under_reduces_ms": under * 1e3,
            "last_producer_done_ms": (ends[-1] - h0) * 1e3,
            "first_reduce_wait_ms": (marks[0]["t0"] - h0) * 1e3,
            "stream_ms": (marks[-1]["t1"] - h0) * 1e3}


def dist_rs_rank(group, dev, shapes_dtypes):
    """One rank of ``dist_rs``: the ``compressed_rs`` + ZeRO-1 arm
    (native, one-shot) and the streamed ``compressed`` arm (``overlap``),
    each a fresh train of the phase-4 setup with this rank's worker, as in
    ``dist_rank``; the streamed arm's reduce/producer timeline; the gloo
    ``reduce_scatter_tensor`` probe; then the gather-skip checks."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch("granite-3-2b")
    api = model_api(dataclasses.replace(arch.model, n_layers=LAYERS))
    out = {"rank": group.rank, "device": str(dev), "backend": group.backend,
           "staging": group.staging, "arms": {}}
    for name, fields, tc_fields in (
            ("rs_zero1", {}, {"aggregator": "compressed_rs", "zero1": True}),
            ("overlap", {"overlap": True}, {"aggregator": "compressed"})):
        tc = dataclasses.replace(
            arch.train, workers=WORKERS, accum_steps=1, remat="none",
            compression=dataclasses.replace(arch.train.compression, **fields),
            **tc_fields)
        log = WireLog(group, timed=name == "overlap")
        params = api.init(tc.seed, dev)
        digests, timeline = [], []

        def after_step(_line):
            log.end_step()
            digests.append(param_digest(params))
            timeline.extend(stream_overlap(*st) for st in log.streams)
            log.streams.clear()

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        res = run_training(api, tc, global_batch=BATCH, seq_len=SEQ,
                           steps=STEPS, device=dev, params=params,
                           log_every=1, log_fn=after_step, group=log)
        arm = {"losses": res.losses, "digests": digests,
               "launches": dict(ops.LAUNCHES),
               "step_ms": [t * 1e3 for t in res.step_seconds[1:]],
               "warmup_ms": res.step_seconds[0] * 1e3,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "recovery": [{k[len("recovery_"):]: int(m[k]) for k in m
                             if k.startswith("recovery_")} for m in res.metrics]}
        if timeline:
            arm["stream_by_step"] = timeline
        arm["collectives"] = replay_collectives(group, log.step_calls, dev)
        out["arms"][name] = arm
        del res, params, log
        torch.cuda.empty_cache()
    probe = torch.arange(4 * WORKERS, dtype=torch.float32) * (group.rank + 1)
    got = torch.empty(4)
    try:
        dist.reduce_scatter_tensor(got, probe)
        out["gloo_reduce_scatter_tensor"] = {"ok": True, "received": got.tolist()}
    except (RuntimeError, ValueError, NotImplementedError) as e:
        out["gloo_reduce_scatter_tensor"] = {
            "ok": False, "error": str(e).splitlines()[:1]}
    out["gather_skip"] = gather_skip_check(group, dev, shapes_dtypes)
    return out


def gather_skip_check(group, dev, shapes_dtypes):
    """The gather-skip path on the ranks: a synthetic aligned tree (two
    leaves of 4 buckets, 2 chunks: each leaf's ZeRO-1 slice r lies in rank
    r's run of each chunk) takes it, and each rank's aggregate equals the
    full gather's on its owned coordinates and is zero elsewhere, with
    the grad norm summed over the ranks equal to the full gather's
    (dyadic values: every sum exact). The full-width granite shapes at
    W=2 take it on no grid."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.aggregators import make_aggregator
    from repro_torch.core.collectives import AggregationState
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.config import TrainConfig
    from repro_torch.train.step import zero1_dims

    base = get_arch("granite-3-2b").train.compression
    cfg = dataclasses.replace(base, stream_chunks=2)
    n = 4 * cfg.bucket_elems_for(1 << 30)
    gen = torch.Generator(device=dev)
    gen.manual_seed(40 + group.rank)
    grads = dyadic_grads([(n,), (n,)], 0.04, gen, dev)[:1]   # this rank's
    skip = make_aggregator("compressed_rs", cfg, group, zero1_dims=(0, 0))
    active = skip.gather_skip_active(grads[0])
    views, _ = skip(grads, AggregationState(
        residual=[torch.zeros((1, n), device=dev) for _ in range(2)]))
    full, _ = make_aggregator("compressed_rs", cfg, group)(grads, AggregationState(
        residual=[torch.zeros((1, n), device=dev) for _ in range(2)]))
    own = slice(group.rank * n // WORKERS, (group.rank + 1) * n // WORKERS)
    exact = all(torch.equal(v[own], f[own]) for v, f in zip(views[0], full))
    zero_elsewhere = all(int(v.count_nonzero()) == int(v[own].count_nonzero())
                         for v in views[0])
    norm_r = opt_lib.global_grad_norm(views[0])
    norm = float(torch.sqrt(group.sum([norm_r * norm_r])))
    norm_full = float(opt_lib.global_grad_norm(full))
    leaves = meta_leaves(shapes_dtypes)
    tc = TrainConfig(workers=WORKERS, zero1=True)
    dims = zero1_dims(leaves, tc)
    granite = {}
    per_rank = stream_grids(shapes_dtypes, base)[1]["scatter"].n_chunks
    for chunks in [None] + [k for k in range(1, per_rank + 1) if per_rank % k == 0]:
        c = dataclasses.replace(base, overlap=chunks is None, stream_chunks=chunks)
        granite[str(chunks or "overlap")] = make_aggregator(
            "compressed_rs", c, group, zero1_dims=dims).gather_skip_active(leaves)
    return {"aligned_active": active, "exact_on_owned": exact,
            "zero_elsewhere": zero_elsewhere, "owned_nnz": [
                int(v[own].count_nonzero()) for v in views[0]],
            "norm_summed_over_ranks": norm, "norm_full_gather": norm_full,
            "granite_zero1_dims": dims, "granite_active_by_grid": granite}


def phase_dist_rs(cfg, rs_arms, train, shapes_dtypes):
    """W=2 ranks sharing ``cuda:0`` over gloo, as ``dist_train``: the
    ``compressed_rs`` + ZeRO-1 arm (native, one-shot) and the streamed
    ``compressed`` arm. After every step each arm's parameter sha256 must
    be equal on both ranks and equal to the emulated run of the same
    config (``rs_train``'s one-shot arm; ``train``, which the streamed
    emulation equals), and each rank must have launched the emulation's
    launches over W. Per arm: steps, the last step's collectives replayed
    alone by operation with their payload bytes a rank, peak memory a
    rank; for the streamed arm the reduce time a step and its overlap with
    the next chunk's producer. Then the gloo ``reduce_scatter_tensor``
    probe and the gather-skip checks."""
    from repro_torch.launch.ranks import spawn_ranks

    n_chunks = stream_grids(shapes_dtypes, cfg)[1]["allreduce"].n_chunks
    t0 = time.perf_counter()
    outs = spawn_ranks(dist_rs_rank, WORKERS, (shapes_dtypes,), device="cuda",
                       timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    # a rank runs its own worker's producers; on the reduce-scatter wire
    # it peels its own half, on the all-reduce wire the whole stream
    emulated = {"rs_zero1": (rs_arms["oneshot"], {
                    "encode_pack_quantize": STEPS, "dequant_peel_unpack": STEPS}),
                "overlap": (train, {"encode_pack_quantize": n_chunks * STEPS,
                                    "dequant_peel_unpack": STEPS})}
    arms, launches = {}, {}
    for name, (emu, want) in emulated.items():
        per = [o["arms"][name] for o in outs]
        want = {**dict.fromkeys(per[0]["launches"], 0), **want}
        for r, a in enumerate(per):
            if a["launches"] != want:
                raise AssertionError(f"rank {r} {name}: launch counts "
                                     f"{a['launches']}, expected {want}")
            if a["digests"] != emu["param_sha256_by_step"]:
                raise AssertionError(f"rank {r} {name}: parameters differ from "
                                     "the emulated run")
            if a["losses"] != per[0]["losses"]:
                raise AssertionError(f"{name}: ranks report different losses")
        launches[name] = {k: sum(a["launches"][k] for a in per) for k in want}
        arms[name] = {
            "losses": per[0]["losses"], "emulated_losses": emu["losses"],
            "step_ms_by_rank": [a["step_ms"] for a in per],
            "warmup_ms_by_rank": [a["warmup_ms"] for a in per],
            "collectives_ms_median_by_op_by_rank": [
                a["collectives"]["ms_median_by_op"] for a in per],
            "collectives_ms_median_total_by_rank": [
                a["collectives"]["ms_median"] for a in per],
            "collective_calls": per[0]["collectives"]["calls"],
            "payload_bytes_per_rank_step": per[0]["collectives"]["payload_bytes"],
            "payload_bytes_total_per_rank_step":
                per[0]["collectives"]["payload_bytes_total"],
            "peak_mem_bytes_by_rank": [a["peak_mem_bytes"] for a in per],
            "launches_by_rank": [a["launches"] for a in per],
            "recovery": per[0]["recovery"],
            "param_sha256_by_step": per[0]["digests"]}
        if "stream_by_step" in per[0]:
            arms[name]["stream_by_step_by_rank"] = [a["stream_by_step"] for a in per]
    skips = [o["gather_skip"] for o in outs]
    for r, g in enumerate(skips):
        if not (g["aligned_active"] and g["exact_on_owned"] and g["zero_elsewhere"]
                and g["norm_summed_over_ranks"] == g["norm_full_gather"]):
            raise AssertionError(f"rank {r}: gather-skip check failed: {g}")
        if any(g["granite_active_by_grid"].values()):
            raise AssertionError("gather skip fired at the full-width geometry")
    emit({"phase": "dist_rs", "arch": "granite-3-2b", "layers": LAYERS,
          "workers": WORKERS, "procs": WORKERS, "global_batch": BATCH,
          "seq_len": SEQ, "steps": STEPS, "warmup_steps": 1,
          "backend": outs[0]["backend"], "staging": outs[0]["staging"],
          "devices": [o["device"] for o in outs], "wall_s": wall, "arms": arms,
          "gloo_reduce_scatter_tensor": [o["gloo_reduce_scatter_tensor"]
                                         for o in outs]})
    emit({"phase": "gather_skip", "by_rank": skips})
    return launches


# ----------------------------------------------------------------------
# Wire plans and the auto strategy
# ----------------------------------------------------------------------

AUTO_STEPS = 2           # steps of the fixed mixed plan
CONTROLLER_STEPS = 40    # most steps the controller may take to decide


def mixed_plan(n_buckets):
    """The fixed mixed plan of ``auto_train`` and ``dist_auto``: all four
    wires, each group after the first starting at an odd bucket (no
    multiple of W or of the 8 switch slots)."""
    from repro_torch.core.wireplan import WireGroup, WirePlan
    cuts = (0, 37, 151, 263, n_buckets)
    wires = ("dense", "compressed_rs", "compressed_innet", "compressed")
    return WirePlan(n_buckets, tuple(WireGroup(a, b - a, w) for a, b, w in
                                     zip(cuts, cuts[1:], wires)))


def auto_tc():
    """The train config of the ``auto`` phases: phase 4's with the
    ``auto`` aggregator and fxp32 on the in-network groups."""
    from repro_torch.configs import get_arch
    arch = get_arch("granite-3-2b")
    return dataclasses.replace(
        arch.train, workers=WORKERS, accum_steps=1, remat="none",
        aggregator="auto", compression=dataclasses.replace(
            arch.train.compression, wire_dtype="fxp32"))


def plan_launches(plan, local_workers, steps):
    """The launches ``steps`` steps of ``plan`` imply, for a process
    running ``local_workers`` workers: a compressed group's producer a
    worker; the consumer once (``compressed``), once a worker on its
    slice (``compressed_rs``), or its dequant leg once
    (``compressed_innet`` on fxp32); a dense group none."""
    want = {"encode_pack_quantize": 0, "dequant_peel_unpack": 0,
            "dequant_peel_unpack_dq": 0}
    for g in plan.groups:
        if g.wire == "dense":
            continue
        want["encode_pack_quantize"] += local_workers * steps
        if g.wire == "compressed_innet":
            want["dequant_peel_unpack_dq"] += steps
        else:
            want["dequant_peel_unpack"] += steps * (
                local_workers if g.wire == "compressed_rs" else 1)
    return want


def step0_grads(api, tc, dev):
    """Each worker's gradients at the seed's parameters on step 0's
    batch (the first step of every train phase)."""
    import torch
    from repro_torch.data.pipeline import batch_fn
    from repro_torch.train.loop import device_batch
    params = api.init(tc.seed, dev)
    batch = device_batch(batch_fn(api.cfg, BATCH, SEQ, seed=tc.seed)(0), dev)
    per = BATCH // WORKERS
    grads_w = []
    for w in range(WORKERS):
        loss, _ = api.loss(params.tree(), {k: v[w * per:(w + 1) * per]
                                           for k, v in batch.items()},
                           remat="none")
        grads_w.append([g.detach() for g in
                        torch.autograd.grad(loss, params.leaves())])
    return grads_w


def plan_rows(name, cfg, grads_w, dev, wire_plan=None):
    """One aggregation of ``grads_w`` on LocalWorkers from zero residuals
    through the named strategy (and plan): the aggregated ``(n_buckets,
    E)`` f32 stream before the mean, and the sha256 of the new
    residuals."""
    import torch
    from repro_torch.core.aggregators import make_aggregator
    from repro_torch.core.bucketing import make_bucket_plan
    from repro_torch.core.collectives import AggregationState, LocalWorkers
    from repro_torch.core.compressor import HomomorphicCompressor
    agg = make_aggregator(name, cfg, LocalWorkers(WORKERS), wire_plan=wire_plan)
    state = AggregationState(residual=[
        torch.zeros((WORKERS,) + tuple(g.shape), device=dev) for g in grads_w[0]])
    bplan = make_bucket_plan(grads_w[0], cfg)
    streams = [functools.partial(agg._pack, w, g, state, bplan)
               for w, g in enumerate(grads_w)]
    rec, _ = agg._execute_plan(streams, bplan, HomomorphicCompressor(cfg), dev)
    return rec, digest(*[r.reshape(-1) for r in state.residual], chunk=1 << 26)


def packed_sum(cfg, grads_w, dev, rows):
    """The sum over the workers of their packed (sparsified) streams'
    ``rows``, from zero residuals."""
    import torch
    from repro_torch.core.aggregators import make_aggregator
    from repro_torch.core.bucketing import make_bucket_plan
    from repro_torch.core.collectives import AggregationState, LocalWorkers
    agg = make_aggregator("compressed", cfg, LocalWorkers(WORKERS))
    bplan = make_bucket_plan(grads_w[0], cfg)
    total = None
    for w, g in enumerate(grads_w):
        state = AggregationState(residual=[
            torch.zeros((WORKERS,) + tuple(x.shape), device=dev) for x in g])
        part = agg._pack(w, g, state, bplan)[rows].clone()
        total = part if total is None else total + part
        del state
    return total


def occupancy_report(occ, cfg, bplan, paths):
    """Per-bucket occupancy against the peel limit: a histogram, the
    vetoed buckets (over ``auto_occupancy_margin`` of the capacity),
    which of them hold the ``lm_head`` leaf, and per leaf (``paths``, in
    flatten order; a bucket counts for the leaf it holds most of) its
    vetoed buckets and buckets."""
    import collections
    from repro_torch.core.costmodel import occupancy_feasible
    cap = cfg.peel_capacity / cfg.block_elems
    limit = cfg.auto_occupancy_margin * cap
    edges = [0.0, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07, limit, cap,
             0.10, 0.15, 0.20, 1.0]
    hist = {f"[{a:.4f},{b:.4f})": sum(a <= o < b for o in occ)
            for a, b in zip(edges, edges[1:])}
    hist["1.0"] = sum(o >= 1.0 for o in occ)
    vetoed = [b for b, o in enumerate(occ) if not occupancy_feasible(o, cfg)]
    lm_head_leaf = paths.index(("lm_head",))
    lm = [b for b, segs in enumerate(bplan.bucket_segments)
          if any(sg.leaf == lm_head_leaf for sg in segs)]
    by_leaf = collections.defaultdict(lambda: [0, 0])
    for b, segs in enumerate(bplan.bucket_segments):
        leaf = "/".join(paths[max(segs, key=lambda sg: sg.length).leaf])
        by_leaf[leaf][0] += b in vetoed
        by_leaf[leaf][1] += 1
    return {"limit": limit, "capacity": cap, "histogram": hist,
            "min": min(occ), "max": max(occ), "vetoed": len(vetoed),
            "vetoed_buckets": vetoed, "lm_head_buckets": [lm[0], lm[-1] + 1],
            "lm_head_vetoed": sum(b in lm for b in vetoed),
            "lm_head_bucket_count": len(lm),
            "vetoed_outside_lm_head": [b for b in vetoed if b not in lm],
            "vetoed_and_buckets_by_leaf": dict(by_leaf)}


def phase_auto_train(dev, train, shapes_dtypes, codec_bps, link_bps):
    """LocalWorkers, W=2, the ``auto`` strategy at full width.

    (a) The fixed mixed plan for 2 steps: the launches it implies; then,
    on step 0's gradients and zero residuals, its aggregate rows equal,
    group by group and bit for bit, the fixed strategies' (and a dense
    group's the sum of the packed streams), with equal residuals. (b) The
    uniform plan on ``compressed``: parameter sha256 equal to phase 4's
    after every step. (c) The controller from priors measured in this run
    (``codec_bps``: the stream's bytes over the mean of the producer's and
    the consumer's full-stream times; ``link_bps``: the dense all-reduces
    of ``dist_train``), ``replan_every=2``, driven until it decides: its
    trace, the occupancy against the peel limit, the vetoed buckets, and
    the decided plan's step time beside the best uniform wire's and
    beside the plan that routes the vetoed buckets dense."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import costmodel as cm
    from repro_torch.core.bucketing import make_bucket_plan
    from repro_torch.core.wireplan import plan_from_assignments, uniform_plan
    from repro_torch.data.pipeline import batch_fn
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import device_batch
    from repro_torch.train.step import build_train_step, init_train_state

    tc = auto_tc()
    cfg = tc.compression
    api = model_api(dataclasses.replace(get_arch("granite-3-2b").model,
                                        n_layers=LAYERS))
    bplan = make_bucket_plan(meta_leaves(shapes_dtypes), cfg)
    nb = bplan.n_buckets
    plan = mixed_plan(nb)
    launches = {}

    # (a) the fixed mixed plan
    mixed, launches["mixed"], _, _, state = phase_train(
        dev, phase="auto_mixed", wire="fxp32", tc_fields={"aggregator": "auto"},
        want=plan_launches(plan, WORKERS, AUTO_STEPS), emit_line=False,
        wire_plan=plan, steps=AUTO_STEPS)
    del state
    torch.cuda.empty_cache()
    grads_w = step0_grads(api, tc, dev)
    rec, res_digest = plan_rows("auto", cfg, grads_w, dev, wire_plan=plan)
    groups = []
    for g in plan.groups:
        rows = slice(g.start, g.stop)
        if g.wire == "dense":
            want, want_res = packed_sum(cfg, grads_w, dev, rows), res_digest
        else:
            full, want_res = plan_rows(g.wire, cfg, grads_w, dev)
            want = full[rows].clone()
            del full
        torch.cuda.empty_cache()
        equal = bool(torch.equal(rec[rows], want))
        groups.append({"start": g.start, "n_buckets": g.n_buckets,
                       "wire": g.wire, "rows_equal": equal,
                       "residuals_equal": want_res == res_digest,
                       "equal_to": "sum of the packed streams"
                       if g.wire == "dense" else f"fixed {g.wire}"})
        if not (equal and want_res == res_digest):
            raise AssertionError(f"auto_train: group {g} differs from {groups[-1]['equal_to']}")
        del want
    del rec, grads_w
    torch.cuda.empty_cache()

    # (b) the uniform plan on the compressed wire
    uniform, launches["uniform"], _, _, state = phase_train(
        dev, phase="auto_uniform", wire="fxp32", tc_fields={"aggregator": "auto"},
        want={"encode_pack_quantize": WORKERS * STEPS,
              "dequant_peel_unpack": STEPS},
        emit_line=False, wire_plan=uniform_plan(nb, "compressed"))
    del state
    torch.cuda.empty_cache()
    if uniform["param_sha256_by_step"] != train["param_sha256_by_step"]:
        raise AssertionError("auto_train: the uniform compressed plan's "
                             "parameters differ from phase train's")

    # (c) the controller
    report = {"achieved_codec_bytes_per_s": codec_bps,
              "hbm_bytes_per_s": HBM_BYTES_PER_S, "ici_bytes_per_s": link_bps}
    priors = cm.priors_from_codec_report(report)
    cfg_c = dataclasses.replace(cfg, replan_every=2, **priors)
    tc_c = dataclasses.replace(tc, compression=cfg_c)
    ctl = cm.AutoWireController(bplan, cfg_c, workers=WORKERS, device=dev)
    state = init_train_state(api, tc_c, dev)
    make_batch = batch_fn(api.cfg, BATCH, SEQ, seed=tc.seed)
    fns, walls, step = {}, [], 0

    def run_step(wplan):
        nonlocal state, step
        fn = fns.setdefault(wplan, build_train_step(api, tc_c, wire_plan=wplan))
        batch = device_batch(make_batch(step), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = fn(state, batch)
        occ = metrics["bucket_occupancy"].tolist()       # syncs the device
        wall = time.perf_counter() - t0
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError("auto_train: non-finite loss")
        step += 1
        return wall, occ

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    while True:
        wplan = ctl.plan(step)
        if step > 0 and not ctl.decision_trace()["probing"]:
            break
        if step >= CONTROLLER_STEPS:
            raise AssertionError("auto_train: the controller did not decide "
                                 f"in {CONTROLLER_STEPS} steps")
        wall, occ = run_step(wplan)
        walls.append({"plan": wplan.describe(), "ms": wall * 1e3})
        ctl.observe(wall, {"bucket_occupancy": occ})
    launches["controller"] = dict(ops.LAUNCHES)
    decided = wplan
    trace = ctl.decision_trace()
    # the controller's folded occupancy, which its vetoes read
    occ_rep = occupancy_report(ctl._occupancy, cfg_c, bplan,
                               list(state.params.paths))
    veto_plan = plan_from_assignments(
        ["dense" if b in set(occ_rep["vetoed_buckets"]) else "compressed"
         for b in range(nb)])
    timed = {}
    for name, wp in (("decided", decided), ("veto_dense_else_compressed",
                                            veto_plan)):
        runs = [run_step(wp)[0] * 1e3 for _ in range(3)]
        timed[name] = {"plan": wp.describe(), "step_ms": runs[1:],
                       "warmup_ms": runs[0]}
    best = min(trace["measured_wall_s"].items(), key=lambda kv: kv[1])
    del state, fns
    torch.cuda.empty_cache()
    emit({"phase": "auto_train", "arch": "granite-3-2b", "layers": LAYERS,
          "workers": WORKERS, "global_batch": BATCH, "seq_len": SEQ,
          "buckets": nb, "wire_dtype": cfg.wire_dtype,
          "mixed": {"plan": plan.describe(), "steps": AUTO_STEPS,
                    "step_ms": mixed["step_ms"], "warmup_ms": mixed["warmup_ms"],
                    "losses": mixed["losses"], "launches": mixed["launches"],
                    "recovery": mixed["recovery"],
                    "param_sha256_by_step": mixed["param_sha256_by_step"],
                    "peak_mem_bytes": mixed["peak_mem_bytes"],
                    "groups_on_step0_grads": groups},
          "uniform": {"plan": f"[0:{nb}]=compressed",
                      "step_ms": uniform["step_ms"],
                      "equal_to_train": True, "train_step_ms": train["step_ms"],
                      "param_sha256_by_step": uniform["param_sha256_by_step"]},
          "controller": {"codec_report": report, "priors": priors,
                         "replan_every": 2, "steps": len(walls),
                         "steps_by_window": walls, "decision_trace": trace,
                         "occupancy": occ_rep, "timed": timed,
                         "best_uniform": {"wire": best[0],
                                          "wall_ms": best[1] * 1e3},
                         "launches": launches["controller"]}})
    return launches, mixed["param_sha256_by_step"]


def dist_auto_rank(group, dev, n_buckets):
    """One rank of ``dist_auto``: the fixed mixed plan for 2 steps from the
    phase-4 setup with this rank's worker, as in ``dist_rank``; the last
    step's collectives replayed alone by operation, and the in-network
    group's tree (its int32 sketch sum and word OR, in windows of the
    switch slots, over the P2P tree) replayed alone likewise."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.bucketing import make_bucket_plan
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.net.topology import make_topology, tree_all_reduce
    from repro_torch.train.loop import run_training

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = auto_tc()
    cfg = tc.compression
    api = model_api(dataclasses.replace(get_arch("granite-3-2b").model,
                                        n_layers=LAYERS))
    plan = mixed_plan(n_buckets)
    params = api.init(tc.seed, dev)
    bplan = make_bucket_plan(params.leaves(), cfg)
    log = WireLog(group, bucket_elems=bplan.bucket_elems)
    digests = []

    def after_step(_line):
        log.end_step()
        digests.append(param_digest(params))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    res = run_training(api, tc, global_batch=BATCH, seq_len=SEQ,
                       steps=AUTO_STEPS, device=dev, params=params,
                       log_every=1, log_fn=after_step, group=log,
                       wire_plan=plan)
    out = {"rank": group.rank, "device": str(dev), "backend": group.backend,
           "staging": group.staging, "losses": res.losses, "digests": digests,
           "launches": dict(ops.LAUNCHES),
           "step_ms": [t * 1e3 for t in res.step_seconds[1:]],
           "warmup_ms": res.step_seconds[0] * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "recovery": [{k[len("recovery_"):]: int(m[k]) for k in m
                         if k.startswith("recovery_")} for m in res.metrics]}
    del res, params
    torch.cuda.empty_cache()
    out["collectives"] = replay_collectives(group, log.step_calls, dev)
    innet = next(g for g in plan.groups if g.wire == "compressed_innet")
    nbpb = bplan.blocks_per_bucket(cfg)
    topo = make_topology(cfg.topology, group)
    bufs = {"innet_tree_sketch_add": torch.zeros(
                (innet.n_buckets, nbpb * cfg.rows * cfg.lanes),
                dtype=torch.int32, device=dev),
            "innet_tree_word_or": torch.zeros(
                (innet.n_buckets, bplan.words_per_bucket), dtype=torch.int32,
                device=dev)}
    tree = {}
    for name, buf in bufs.items():
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree_all_reduce([buf], topo, "add" if "add" in name else "or",
                            window_slots=cfg.switch_slots, group=group)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        tree[name] = {"ms_median": statistics.median(ms),
                      "payload_bytes": buf.numel() * buf.element_size(),
                      "windows": -(-innet.n_buckets // cfg.switch_slots)}
    out["innet_tree"] = tree
    return out


def phase_dist_auto(n_buckets, emulated_digests):
    """W=2 ranks sharing ``cuda:0`` over gloo, as ``dist_train``: the fixed
    mixed plan of ``auto_train`` for 2 steps. After every step the
    parameter sha256 must be equal on both ranks and to ``auto_train``'s
    emulated run, and each rank must have launched what the plan implies
    for one worker. Prints the last step's collectives replayed alone by
    operation with their payload bytes a rank, and the in-network
    group's tree replayed alone."""
    from repro_torch.launch.ranks import spawn_ranks

    plan = mixed_plan(n_buckets)
    t0 = time.perf_counter()
    outs = spawn_ranks(dist_auto_rank, WORKERS, (n_buckets,), device="cuda",
                       timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    want = plan_launches(plan, 1, AUTO_STEPS)
    for r, o in enumerate(outs):
        got = {k: o["launches"][k] for k in o["launches"] if o["launches"][k]}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"rank {r}: launch counts {o['launches']}, "
                                 f"expected {want}")
        if o["digests"] != emulated_digests:
            raise AssertionError(f"rank {r}: parameters differ from the "
                                 "emulated auto_train run")
        if o["losses"] != outs[0]["losses"]:
            raise AssertionError("dist_auto: ranks report different losses")
    emit({"phase": "dist_auto", "arch": "granite-3-2b", "layers": LAYERS,
          "workers": WORKERS, "procs": WORKERS, "global_batch": BATCH,
          "seq_len": SEQ, "steps": AUTO_STEPS, "warmup_steps": 1,
          "plan": plan.describe(), "backend": outs[0]["backend"],
          "staging": outs[0]["staging"], "wall_s": wall,
          "losses": outs[0]["losses"],
          "param_sha256_by_step": outs[0]["digests"],
          "equal_to_auto_train": True,
          "step_ms_by_rank": [o["step_ms"] for o in outs],
          "warmup_ms_by_rank": [o["warmup_ms"] for o in outs],
          "collectives_ms_median_by_op_by_rank": [
              o["collectives"]["ms_median_by_op"] for o in outs],
          "collectives_ms_median_total_by_rank": [
              o["collectives"]["ms_median"] for o in outs],
          "collective_calls": outs[0]["collectives"]["calls"],
          "payload_bytes_per_rank_step": outs[0]["collectives"]["payload_bytes"],
          "payload_bytes_total_per_rank_step":
              outs[0]["collectives"]["payload_bytes_total"],
          "innet_tree_by_rank": [o["innet_tree"] for o in outs],
          "peak_mem_bytes_by_rank": [o["peak_mem_bytes"] for o in outs],
          "launches_by_rank": [o["launches"] for o in outs],
          "recovery": outs[0]["recovery"]})
    return {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}


# ----------------------------------------------------------------------
# The MoE slice: the expert-parallel all-to-all exchange
# ----------------------------------------------------------------------

MOE_ARCH, MOE_LAYERS, EP_WORKERS = "deepseek-moe-16b", 2, 2
MOE_SETTINGS = ("none", "dense", "compressed")


def exchange_cfg():
    """The exchange codec the train step builds for deepseek-moe-16b: its
    train config's compression at ratio 2.5 with top-k and error
    feedback off (rows 6, c 512, G 2, 1024-element blocks)."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(MOE_ARCH).train.compression, ratio=2.5,
                               topk_ratio=None, error_feedback=False)


def phase_kernels_a2a(dev, check):
    """Rows 1 and 2 at the exchange's geometry (ratio 2.5, rows 6, c 512,
    G 2) against their plain versions: 2048 blocks at offset ids, fully
    dense (every bit set: 1024 peels a block), dyadic bit for bit and
    Gaussian to phase 3's tolerance, words and residual exactly, every
    value peeled. Then two sources' (2 lanes x 1024 blocks) stacks
    through the producer, the plain lane merge and the consumer, each
    lane at its ``lane_start_block``: the merged lanes equal the sources'
    sum bit for bit. Then the kernel and plain times and the bound at
    the MoE train's shapes: the producer on one source's stack (8192
    blocks), the consumer on one merged lane (4096 blocks). Returns the
    ``a2a`` entries of the two kernel rows."""
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.core.compressor import HomomorphicCompressor
    from repro_torch.core.peeling import peel_blocks
    from repro_torch.kernels import ops, ref

    cfg = exchange_cfg()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2525)
    nb, G, c = CHECK_BLOCKS, cfg.group, cfg.lanes
    ids = torch.arange(nb, dtype=torch.int32, device=dev) + CHECK_OFFSET
    for kind in ("dyadic", "gauss"):
        xb = make_blocks(cfg, nb, 1.0, kind, gen)
        exact = kind == "dyadic"
        sk, w, _ = check.producer(xb, ids, cfg, exact)
        vals, res = check.consumer(sk, w, ids, cfg, exact)
        nnz, n_res = int(index_lib.popcount(w)), int(res.sum())
        if nnz != xb.numel() or n_res:
            raise AssertionError(f"kernels_a2a {kind}: {nnz} of {xb.numel()} "
                                 f"bits set, {n_res} estimated")
        if exact and not torch.equal(vals.reshape(xb.shape), xb):
            raise AssertionError("kernels_a2a: the dense dyadic payload did "
                                 "not peel back to itself")
        emit({"phase": "kernels_a2a", "case": f"{kind}@1.0", "blocks": nb,
              "group": G, "agree": True, "nnz": nnz, "residual": n_res,
              "values_equal_input": bool(torch.equal(vals.reshape(xb.shape), xb))})
    # two sources, two lanes of 1024 blocks each, through the lane merge
    comp = HomomorphicCompressor(cfg)
    lane_nb = nb // 2
    xs = [make_blocks(cfg, nb, 1.0, "dyadic", gen) for _ in range(2)]
    enc = []
    for x in xs:
        sk, w, _ = check.producer(x, ids, cfg, True)
        leaf, _ = comp.exchange_wire(x.reshape(2, 1, lane_nb * G * c), CHECK_OFFSET)
        if not (torch.equal(leaf.sketch.reshape(sk.shape), sk)
                and torch.equal(leaf.index_words.reshape(w.shape), w)):
            raise AssertionError("exchange_wire differs from the producer")
        enc.append(leaf)
    group = LocalWorkers(2)
    msk = group.lane_sum([e.sketch for e in enc], "add")
    mwd = group.lane_sum([e.index_words for e in enc], "or")
    for d in range(2):
        lane_ids = ids[d * lane_nb:(d + 1) * lane_nb]
        vals, res = check.consumer(msk[d], mwd[d].reshape(lane_nb, -1), lane_ids,
                                   cfg, True)
        want = xs[0][d * lane_nb:(d + 1) * lane_nb] + xs[1][d * lane_nb:(d + 1) * lane_nb]
        if not torch.equal(vals.reshape(want.shape), want) or int(res.sum()):
            raise AssertionError(f"kernels_a2a: merged lane {d} != the sum")
    emit({"phase": "kernels_a2a", "case": "2 sources x 2 lanes, lane merge",
          "blocks": nb, "agree": True, "merged_equal_sum": True})
    del xs, enc, msk, mwd
    # times at the MoE train's shapes
    from repro_torch.configs import get_arch
    T_blk = BATCH * SEQ // WORKERS // EP_WORKERS
    lane_blocks = T_blk * get_arch(MOE_ARCH).model.d_model // cfg.block_elems
    pnb = EP_WORKERS * lane_blocks
    pids = torch.arange(pnb, dtype=torch.int32, device=dev)
    x = make_blocks(cfg, pnb, 1.0, "dyadic", gen)
    sk, w, _ = ops.encode_pack_quantize(x, pids, cfg)
    lsk, lw, lids = sk[:lane_blocks], w[:lane_blocks], pids[:lane_blocks]
    bits = index_lib.unpack_bits(lw.reshape(-1), (lane_blocks, G, c))
    rounds = peel_blocks(lsk, bits, lids, cfg).rounds_used
    del bits
    _, res = ops.dequant_peel_unpack(lsk, lw, lids, cfg)
    nnz = int(index_lib.popcount(lw))
    eb, eo, _, _ = codec_bytes_ops(pnb, cfg, int((x != 0).sum()), 0, 0, 0)
    _, _, db, do = codec_bytes_ops(lane_blocks, cfg, 0, nnz, int(res.sum()), rounds)
    out = {}
    for name, kfn, pfn, nbytes, nops, n in [
        ("encode_pack_quantize", lambda: ops.encode_pack_quantize(x, pids, cfg),
         lambda: ref.encode_pack_quantize_ref(x, pids, cfg), eb, eo, pnb),
        ("dequant_peel_unpack", lambda: ops.dequant_peel_unpack(lsk, lw, lids, cfg),
         lambda: ref.dequant_peel_unpack_ref(lsk, lw, lids, cfg), db, do,
         lane_blocks)]:
        b_ms, b_by = bound(nbytes, nops)
        blocks, smem = ops.kernel_occupancy(name, cfg, dev)
        out[name] = {"geometry": {"ratio": cfg.ratio, "rows": cfg.rows,
                                  "lanes": c, "group": G},
                     "blocks": n, "ms": cuda_ms(kfn, 10),
                     "plain_ms": cuda_ms(pfn, 3, warmup=1), "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "ops": nops,
                     "blocks_per_sm": blocks, "smem_bytes": smem,
                     "plain_rounds_to_fixpoint": rounds}
    emit({"phase": "kernels_a2a", "timed": out})
    del x, sk, w, lsk, lw
    torch.cuda.empty_cache()
    return out


def moe_want(name, steps=STEPS):
    """Row 1 and row 2 launches of ``steps`` MoE train steps: the DP
    aggregator's W producers and one consumer a step, and with the
    compressed exchange one producer a source and one consumer a
    receiving rank a MoE layer a worker (one chunk each)."""
    ex = MOE_LAYERS * WORKERS * EP_WORKERS if name == "compressed" else 0
    return {"encode_pack_quantize": (WORKERS + ex) * steps,
            "dequant_peel_unpack": (1 + ex) * steps}


def phase_moe_train(dev):
    """deepseek-moe-16b at full width (depth 28 -> 2, bf16), W=2 emulated,
    ``ep_workers=2``, global batch 8 x 1024, aggregator ``compressed``
    (ratio 0.1, top-k 4%), AdamW with ZeRO-1, one warm-up and three
    timed steps, under each ``ep_exchange``. Launch counters zeroed just
    before each run and read just after (``moe_want``). The losses of
    ``dense`` and ``compressed`` must lie within rtol 1e-2 of ``none``'s
    (the wire regroups each token's six terms, and the trajectories part
    from there), and ``compressed``'s parameter digests must equal
    ``dense``'s after every step (at G 2 the compressed wire reads every
    value back exactly). Returns the launches by setting and the
    compressed run's (line, api, tc, state) for the breakdown."""
    import torch
    lines, launches = {}, {}
    for name in MOE_SETTINGS:
        torch.cuda.empty_cache()
        line, launches[name], api, tc, state = phase_train(
            dev, phase=f"moe_train/{name}", arch_name=MOE_ARCH,
            layers=MOE_LAYERS, want=moe_want(name), emit_line=False,
            tc_fields={"ep_exchange": name, "ep_workers": EP_WORKERS})
        lines[name] = line
        if name != "compressed":
            del state
        else:
            kept = (line, api, tc, state)
        del api, tc
    base = lines["none"]["losses"]
    for name in ("dense", "compressed"):
        lines[name]["loss_rel_diff_vs_none"] = [
            abs(a - b) / abs(b) for a, b in zip(lines[name]["losses"], base)]
    lines["compressed"]["digests_equal_dense"] = (
        lines["compressed"]["param_sha256_by_step"]
        == lines["dense"]["param_sha256_by_step"])
    for name in MOE_SETTINGS:
        emit(lines[name])
    for name in ("dense", "compressed"):
        if max(lines[name]["loss_rel_diff_vs_none"]) > 1e-2:
            raise AssertionError(f"moe_train/{name}: losses off none's by more "
                                 "than rtol 1e-2")
    if not lines["compressed"]["digests_equal_dense"]:
        raise AssertionError("moe_train: the compressed exchange's parameters "
                             "differ from the dense exchange's")
    return launches, kept


def phase_moe_breakdown(api, tc, state, step_ms, dev):
    """CUDA-event time of each MoE stage at the step's shapes (layer 0's
    weights, worker 0's rows, the layer's real input), forward only: the
    attention, the routing and dispatch, the expert products, the local
    combine, the shared experts, and the compressed exchange's pack,
    producer, lane merge, consumer and unpack + gather (calls a step:
    layers x workers, x EP sources for what runs a source or a receiving
    rank). They break down ``forward_backward``; then the DP
    aggregator's stages and the optimizer as ``phase_breakdown`` times
    them, with the exchange in the forward."""
    import torch
    from repro_torch.core.aggregators import CompressedAllToAllExchange
    from repro_torch.core.collectives import LocalWorkers, sketch_all_to_all
    from repro_torch.core.compressor import CompressedLeaf, HomomorphicCompressor
    from repro_torch.core.streams import make_alltoall_stream_plan
    from repro_torch.data.pipeline import batch_fn
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _layer
    from repro_torch.train.loop import device_batch

    cfg, m = api.cfg, api.cfg.moe
    tree = state.params.tree()
    p0 = _layer(tree["layers"], 0)
    tokens = device_batch(batch_fn(cfg, BATCH, SEQ, seed=tc.seed)(0), dev)[
        "tokens"][:BATCH // WORKERS]
    per_step = MOE_LAYERS * WORKERS
    group = LocalWorkers(EP_WORKERS)
    ex = CompressedAllToAllExchange(cfg=exchange_cfg(), group=group)
    comp = HomomorphicCompressor(ex.cfg)
    with torch.no_grad():
        x0 = tree["embed"][tokens]
        pos = torch.arange(SEQ, device=dev)[None, :]
        h1 = L.rmsnorm(x0, p0["ln1"], cfg.norm_eps)
        attn = lambda: L.attention_train(h1, p0["attn"], cfg, positions=pos)
        x1 = x0 + attn()
        h = L.rmsnorm(x1, p0["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
        p = p0["moe"]
        T, D, E = h.shape[0], cfg.d_model, m.num_experts

        def route_dispatch():
            rt = L.moe_route(h, p, m)
            return rt, L._Dispatch.apply(h, rt.gather_idx, rt.tok_slots)

        rt, xg = route_dispatch()
        experts = lambda: L.moe_experts(xg.reshape(E, rt.capacity, D), p)
        y = experts()

        def combine():
            contrib = torch.cat([y.float() * rt.slot_w[:, None],
                                 y.new_zeros(1, D, dtype=torch.float32)])
            return contrib, L._combine(contrib, rt.tok_slots)

        contrib, _ = combine()
        payloads = L.moe_partials(contrib, rt, group)
        plan = ex._plan(payloads)
        splan = make_alltoall_stream_plan(plan, ex.cfg, lanes=EP_WORKERS)
        stacks = [ex._pack(pl, plan) for pl in payloads]
        leaves = [comp.exchange_wire(st, splan.chunk_start_block(0))[0]
                  for st in stacks]
        merge = lambda: sketch_all_to_all([l.sketch for l in leaves],
                                          [l.index_words for l in leaves], group)
        msk, mwd = merge()

        def consumer(r=0):
            return comp.recover(CompressedLeaf(sketch=msk[r], index_words=mwd[r]),
                                splan.chunk_elems,
                                block_offset=splan.lane_start_block(0, r))

        recs = [consumer(r) for r in range(EP_WORKERS)]
        unpack_gather = lambda: group.gather([plan.unpack(r.reshape(
            plan.n_buckets, plan.bucket_elems))[0] for r in recs])[:T]
        wire = group.gather([o[0] for o in ex(payloads)])[:T]
        exact = bool(torch.equal(unpack_gather(), wire))
        del wire
        moe = {"attention": (per_step, cuda_ms(attn, 5, 1)),
               "router_dispatch": (per_step, cuda_ms(route_dispatch, 5, 1)),
               "expert_products": (per_step, cuda_ms(experts, 5, 1)),
               "local_combine": (per_step, cuda_ms(combine, 5, 1)),
               "shared_experts": (per_step, cuda_ms(lambda: L.mlp(h, p["shared"]),
                                                    5, 1)),
               "exchange_pack": (per_step * EP_WORKERS, cuda_ms(
                   lambda: ex._pack(payloads[0], plan), 5, 1)),
               "exchange_producer": (per_step * EP_WORKERS, cuda_ms(
                   lambda: comp.exchange_wire(stacks[0], 0), 5, 1)),
               "exchange_lane_merge": (per_step, cuda_ms(merge, 5, 1)),
               "exchange_consumer": (per_step * EP_WORKERS, cuda_ms(consumer, 5, 1)),
               "exchange_unpack_gather": (per_step, cuda_ms(unpack_gather, 5, 1))}
        del payloads, stacks, leaves, msk, mwd, recs, xg, y, contrib
    torch.cuda.empty_cache()
    ep_ex = tc.ep_exchange
    from repro_torch.core.aggregators import make_exchange
    return phase_breakdown(
        api, tc, state, step_ms, dev, phase="moe_breakdown",
        loss_kw={"ep_exchange": make_exchange(ep_ex, exchange_cfg(),
                                              LocalWorkers(EP_WORKERS))},
        extra={"moe_stages_ms": {k: {"per_call": ms, "calls": n,
                                     "per_step": n * ms}
                                 for k, (n, ms) in moe.items()},
               "moe_stages_note": "forward only; inside forward_backward",
               "exchange_tokens": T, "exchange_capacity": rt.capacity,
               "exchange_payload": [EP_WORKERS, plan.n_buckets, plan.bucket_elems],
               "staged_exchange_equal_exchange": exact})


def dist_a2a_rank(group, dev):
    """One rank of ``dist_a2a``: the dense and the compressed exchange
    standalone on one MoE layer's payload (``(W, T_blk, D)`` f32, dyadic
    and fully dense), fused and in 2 chunks, 2 steps each. Every source's
    payload is made from its own seed here, so each rank checks its
    merged lane against the sources' sum. The P2P sends of each exchange
    are counted by bytes (``collectives.exchange`` wrapped); the lane
    merges of each payload kind are then replayed alone (host clock
    around a synchronise, median of 3). Launch counters zeroed at the
    start, read at the end."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import collectives as coll
    from repro_torch.core.aggregators import make_exchange
    from repro_torch.kernels import ops

    W, r = group.workers, group.rank
    T_blk = BATCH * SEQ // WORKERS // W
    D = get_arch(MOE_ARCH).model.d_model
    sent = []
    p2p = coll.exchange

    def counted(level, sends=(), recvs=()):
        sent.append(sum(t.numel() * t.element_size() for t, _ in sends))
        return p2p(level, sends, recvs)

    def payload(src, step):
        gen = torch.Generator(device=dev)
        gen.manual_seed(9000 + 10 * step + src)
        shape = (W, T_blk, D)
        sign = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5,
                           -1.0, 1.0)
        e = torch.randint(-2, 3, shape, generator=gen, device=dev)
        return sign * torch.exp2(e.to(torch.float32))

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    out = {"rank": r, "backend": group.backend, "staging": group.staging,
           "runs": {}}
    coll.exchange = counted
    try:
        for chunks in (None, 2):
            cfg = dataclasses.replace(exchange_cfg(), stream_chunks=chunks)
            merged = {}
            for name in ("dense", "compressed"):
                ex = make_exchange(name, cfg, group)
                steps_ms, bytes_by_step = [], []
                for step in range(2):
                    pay = payload(r, step)
                    want = sum(payload(s_, step)[r] for s_ in range(W))
                    sent.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = ex([[pay]])[0][0]
                    torch.cuda.synchronize()
                    steps_ms.append((time.perf_counter() - t0) * 1e3)
                    bytes_by_step.append(sum(sent))
                    if not torch.equal(got, want):
                        raise AssertionError(f"rank {r}: {name} x{chunks} step "
                                             f"{step}: merged lane != the sum")
                    merged[name] = got
                out["runs"][f"{name}/{'fused' if chunks is None else chunks}"] = {
                    "ms": steps_ms, "payload_bytes_per_rank": bytes_by_step}
            if not torch.equal(merged["dense"], merged["compressed"]):
                raise AssertionError(f"rank {r}: dense and compressed differ")
    finally:
        coll.exchange = p2p
    out["launches"] = dict(ops.LAUNCHES)
    # the lane merges alone, by payload kind, on zero buffers
    cfg = exchange_cfg()
    lane_blocks = T_blk * D // cfg.block_elems
    nbk = cfg.num_buckets(T_blk * D)
    bufs = {"dense_lane_sum": (torch.zeros(W, nbk, cfg.bucket_elems_for(T_blk * D),
                                           device=dev), "add"),
            "sketch_lane_sum": (torch.zeros(W, lane_blocks, cfg.rows, cfg.lanes,
                                            device=dev), "add"),
            "word_lane_or": (torch.zeros(W, lane_blocks * cfg.block_elems // 32,
                                         dtype=torch.int32, device=dev), "or")}
    out["lane_merge_ms_median"] = {}
    for op, (b, combine) in bufs.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group.lane_sum([b], combine)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["lane_merge_ms_median"][op] = statistics.median(times)
    out["lane_merge_payload_bytes"] = {
        op: b.numel() * b.element_size() for op, (b, _) in bufs.items()}
    return out


def phase_dist_a2a():
    """W=2 ranks sharing ``cuda:0`` over gloo (host-staged), as
    ``dist_train``: the dense and compressed exchanges standalone on one
    MoE layer's payload a rank, dyadic, fused and in 2 chunks. Fails
    unless every rank's merged lane equals the sources' sum bit for bit
    and the two wires agree, each rank launched one producer and one
    consumer a chunk a compressed run, and the bytes a rank sent equal
    ``strategy_wire_bytes``' ``dense_alltoall`` / ``compressed_alltoall``
    ``rank_payload_bytes`` to the byte. Returns the launches summed over
    the ranks."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.ranks import spawn_ranks

    t0 = time.perf_counter()
    outs = spawn_ranks(dist_a2a_rank, EP_WORKERS, (), device="cuda",
                       timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    n = EP_WORKERS * (BATCH * SEQ // WORKERS // EP_WORKERS) \
        * get_arch(MOE_ARCH).model.d_model
    acct = exchange_cfg().strategy_wire_bytes(n, EP_WORKERS, grad_bytes_per_elem=4)
    want_bytes = {"dense": acct["dense_alltoall"]["rank_payload_bytes"],
                  "compressed": acct["compressed_alltoall"]["rank_payload_bytes"]}
    steps, n_chunks = 2, min(2, exchange_cfg().num_buckets(n // EP_WORKERS))
    want_launches = {"encode_pack_quantize": (1 + n_chunks) * steps,
                     "dequant_peel_unpack": (1 + n_chunks) * steps}
    for o in outs:
        for key, run in o["runs"].items():
            if any(b != want_bytes[key.split("/")[0]]
                   for b in run["payload_bytes_per_rank"]):
                raise AssertionError(f"dist_a2a {key}: rank {o['rank']} sent "
                                     f"{run['payload_bytes_per_rank']} B, "
                                     f"accounting {want_bytes}")
        got = {k: v for k, v in o["launches"].items() if v}
        if got != want_launches:
            raise AssertionError(f"dist_a2a: rank {o['rank']} launches {got}, "
                                 f"expected {want_launches}")
    emit({"phase": "dist_a2a", "arch": MOE_ARCH, "procs": EP_WORKERS,
          "payload_shape": [EP_WORKERS, BATCH * SEQ // WORKERS // EP_WORKERS,
                            get_arch(MOE_ARCH).model.d_model],
          "backend": outs[0]["backend"], "staging": outs[0]["staging"],
          "wall_s": wall, "merged_equal_sum": True, "dense_equal_compressed": True,
          "rank_payload_bytes": want_bytes,
          "strategy_wire_bytes": {k: acct[k] for k in ("dense_alltoall",
                                                       "compressed_alltoall")},
          "runs_by_rank": [o["runs"] for o in outs],
          "lane_merge_ms_median_by_rank": [o["lane_merge_ms_median"] for o in outs],
          "lane_merge_payload_bytes": outs[0]["lane_merge_payload_bytes"],
          "launches_by_rank": [o["launches"] for o in outs]})
    return {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}

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
    build.load_all()     # one nvcc a source, all started together
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: v["ptxas"] for k, v in build.BUILD_LOG.items()}})

    cfg = CompressionConfig(ratio=0.1, topk_ratio=0.04)
    bloom_fields = {"index": "bloom", "topk_ratio": 0.001}
    cfg_bloom = dataclasses.replace(cfg, **bloom_fields)
    check = Checker()
    phase_kernels(cfg, dev, check)
    phase_kernels_q(cfg, dev, check)
    phase_kernels_std(cfg_bloom, dev, check)
    a2a = phase_kernels_a2a(dev, check)
    torch.cuda.empty_cache()

    train, launches, api, tc, state = phase_train(dev)
    shapes_dtypes = [(tuple(p.shape), p.dtype) for p in state.params.leaves()]
    consumer_ms = phase_breakdown(api, tc, state, train["step_ms"], dev)[
        "stages_ms"]["consumer"]["per_call"]
    del state
    torch.cuda.empty_cache()
    innet, launches_innet, _, tc_innet, state = phase_train(
        dev, phase="innet_train", wire="fxp32")
    phase_breakdown(api, tc_innet, state, innet["step_ms"], dev,
                    phase="innet_breakdown")
    del state
    torch.cuda.empty_cache()
    bloom, launches_bloom, _, tc_bloom, state = phase_train(
        dev, phase="bloom_train", fields=bloom_fields)
    phase_breakdown(api, tc_bloom, state, bloom["step_ms"], dev,
                    phase="bloom_breakdown")
    del state
    torch.cuda.empty_cache()
    launches_dist, link = phase_dist_train(train["losses"])
    launches_stream = phase_stream_train(dev, tc.compression, train, innet,
                                         shapes_dtypes)
    torch.cuda.empty_cache()
    launches_rs, rs_arms = phase_rs_train(dev, tc.compression, train,
                                          shapes_dtypes, consumer_ms)
    torch.cuda.empty_cache()
    launches_dist_rs = phase_dist_rs(tc.compression, rs_arms, train,
                                     shapes_dtypes)
    n = train["params"]
    n_blocks = cfg.num_buckets(n) * cfg.bucket_elems_for(n) // cfg.block_elems
    recs = phase_main_stream(cfg, dev, n_blocks, check)
    recs_q, payload = phase_innet_stream(cfg, dev, n, check)
    phase_switch(payload, cfg.switch_slots)
    del payload
    torch.cuda.empty_cache()
    recs += recs_q + phase_bloom_stream(cfg_bloom, dev, n_blocks, check)
    torch.cuda.empty_cache()
    # the codec's rate: the stream's bytes over the mean of the producer's
    # and the consumer's full-stream times (main_stream)
    codec_ms = statistics.mean(r["ms"] for r in recs if r["name"] in (
        "encode_pack_quantize", "dequant_peel_unpack"))
    launches_auto, auto_digests = phase_auto_train(
        dev, train, shapes_dtypes,
        codec_bps=n_blocks * cfg.block_elems * 4 / (codec_ms / 1e3),
        link_bps=link["bytes"] / (link["ms"] / 1e3))
    torch.cuda.empty_cache()
    launches_dist_auto = phase_dist_auto(
        cfg.num_buckets(n), auto_digests)
    torch.cuda.empty_cache()
    launches_moe, (moe_line, moe_api, moe_tc, state) = phase_moe_train(dev)
    phase_moe_breakdown(moe_api, moe_tc, state, moe_line["step_ms"], dev)
    del state
    torch.cuda.empty_cache()
    launches_dist_a2a = phase_dist_a2a()
    # each row's launches come from the path it serves: the f32 legs from
    # the compressed train, the fxp32 legs from the in-network train, the
    # standalone kernels from the Bloom train
    for r in recs:
        if r["name"].endswith(("_q", "_dq")):
            on = launches_innet
        elif r["name"].startswith("sketch_"):
            on = launches_bloom
        else:
            on = launches
        r["launches"] = on[r["name"]]
        r["launches_by_path"] = {
            "train": launches[r["name"]],
            "innet_train": launches_innet[r["name"]],
            "bloom_train": launches_bloom[r["name"]],
            "dist_train": launches_dist[r["name"]],
            **{f"stream_train/{k}": v[r["name"]] for k, v in launches_stream.items()},
            **{f"rs_train/{k}": v[r["name"]] for k, v in launches_rs.items()},
            **{f"dist_rs/{k}": v.get(r["name"], 0)
               for k, v in launches_dist_rs.items()},
            **{f"auto_train/{k}": v[r["name"]] for k, v in launches_auto.items()},
            "dist_auto": launches_dist_auto[r["name"]],
            **{f"moe_train/{k}": v[r["name"]] for k, v in launches_moe.items()},
            "dist_a2a": launches_dist_a2a[r["name"]]}
        if r["name"] in a2a:
            r["a2a"] = a2a[r["name"]]
    phase_lossless(api.cfg, tc, dev)
    phase_innet_lossless(api.cfg, dev)
    phase_bloom_lossless(api.cfg, dev)

    emit({"kernels": recs})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
