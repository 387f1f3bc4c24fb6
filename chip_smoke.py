#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure ends the run non-zero):

1. device  — the card's name and power limit (nvidia-smi); TF32 off.
2. build   — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card,
   on 2048 blocks of the main path's geometry at offset block ids:
   dyadic inputs at 4% and 40% density bit for bit; on Gaussian inputs
   every encode (rows 1, 3, 5: sketch, maxabs, q) bit for bit, the
   plain encode summing each cell in the kernels' order on every
   device, and the peels' values to rtol=1e-5, atol=1e-6 (whether they
   were bit for bit too is printed, ``gaussian_bit_equal``); words and
   residual exactly; two runs of each kernel bit-identical. Then,
   dyadic and bit for bit, the lossless profile (rows 60, ratio 2) and
   G=120, whose state the kernels keep in device memory.
4. train   — granite-3-2b at full width, depth cut 40 -> 4, bf16, W=2
   data-parallel workers emulated on the card, global batch 8 x 1024
   tokens, aggregator ``compressed`` (ratio 0.1, top-k 4%), AdamW with
   the ZeRO-1 update (the default, as every train phase's), one
   warm-up step and three timed steps. The launch counters are zeroed
   just before and read just after: the producer must have run W times
   per step and the consumer once, and (in every train phase of AdamW)
   the optimizer's hand kernel once a leaf a step.
5. breakdown — CUDA-event time of each stage of the step (forward and
   backward, sparsify + pack, producer, sum/OR, consumer, unpack,
   optimizer: the hand AdamW kernel, the plain update beside it) at the
   step's shapes, beside the measured step time.
5b. adam_update — the hand AdamW kernel at the benchmark cells' leaf
   shapes (granite-3-2b.d4, deepseek-moe-16b.d1; W 2, ZeRO-1): one
   ``apply_update`` on each path from one state, bit for bit; the
   kernel's time a step and a leaf against its bound (22 B a bf16
   parameter at 3.35 TB/s), the plain update's, ``apply_update``'s on
   both paths, and PyTorch's own fused AdamW (``torch._fused_adamw_``)
   on the same shapes for scale.
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
   bit for bit; Gaussian inputs with q bit for bit, values to
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

18. dist_train — after phases 19-20, their memory freed (its ranks
    spawned once with those of phases 21-22, 24 and 28: each rank runs
    this phase's arms, then theirs, and each phase checks its own
    results when its turn comes):
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
    depth 28 -> 1, bf16, W=2 emulated with ``ep_workers=2``, global
    batch 8 x 1024, aggregator ``compressed`` (ratio 0.1, top-k 4%),
    AdamW with ZeRO-1, under ``ep_exchange`` none, dense and compressed,
    one warm-up and three timed steps each. Launches zeroed just before
    each run: rows 1 / 2 run 2 / 1 a step under none and dense, 2 + 4 /
    1 + 4 under compressed (a producer a source and a consumer a
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

The elastic aggregation service (``repro_torch.elastic``, the serve
launcher's ``--elastic`` rounds; after phase 28, the MoE phases' memory
freed):

29. kernels_elastic — rows 1, 2 and 4 at the elastic geometry (ratio 1,
    c 128, rows 6, G 6, rounds 10) against their plain versions on 2048
    blocks at offset ids 500,000 inside the 580,550-block stream: four
    clients' payloads at 10% density, their sum into the f32 consumer and
    their W = 4 fxp32 quantization (M = 28) into the dequant consumer;
    dyadic at 10% and 40% bit for bit, Gaussian at 10% to phase 3's
    tolerance, words and residual exactly. Then on the full stream, the
    shape the elastic path gives each row (the producer on one client's
    10% stream and on a 4-client aggregate's, both consumers on the
    aggregate): each row against plain again, dyadic bit for bit and
    Gaussian to phase 3's tolerance, and each kernel's and plain time and
    its bound, with blocks an SM, shared-memory bytes and the full
    stream's max_abs_err; the f32 consumer's per-block rounds histogram
    and its time with the rounds capped at 0, 1, 2 and 10.
30. elastic — ``repro_torch.launch.serve.run_elastic`` on the card:
    granite-3-2b at full width, depth 40 -> 4, as the gradient template
    (425 buckets of 1,049,088 elements, 580,550 blocks), cohort 4 with a
    client joining at round 1, 3 rounds, ``--straggle``; f32 and fxp32,
    each unsharded (n_shards 1, batch 1) and sharded (n_shards 4, batch
    4). Every round: folded + deferred = W (0 lost); the fxp32 budget
    28 at W = 4 and 27 at W = 5; a round-0 payload refused as stale in
    round 1; rows 1 / 2 / 4 launched W times (the clients' producers) and
    once a shard for the close and for each deferred payload; on fxp32
    the folded int32 sketch equal to an int64 sum of the folded payloads;
    each sharded close equal to the unsharded one bit for bit; on round 0
    (dyadic gradients) the unsharded close equal to the plain versions'
    on the same folded state. Per round: each client's propose ms, the
    fold ms a payload, the close ms and the consumer's share of it, the
    payload bytes and the peak memory.

The training job whole (``remat`` policies, checkpoints and recovery
in ``run_training``; after phase 30; every train phase above already
runs the ``block`` remat default):

31. remat — granite-3-2b as phase 4 under ``none`` and ``dots``, and
    deepseek-moe-16b as ``moe_train/compressed`` under ``none``: after
    every step the parameter sha256 and the losses equal the ``block``
    run's (phase 4, phase 26), and the launches the same counts (the
    MoE exchange's 2 + 4 producers and 1 + 4 consumers a step: the
    recompute leaves the exchange out). Peak memory and step ms of each
    policy beside ``block``'s.
32. ckpt_train — phase 4's train through ``run_training`` with a
    checkpoint every 2 steps into a temporary directory under
    ``build/`` (the free space for two checkpoints checked first) and a
    failure injected at step 3: one restart, five losses (step 2 again
    after its checkpoint is restored, the loss equal to its first pass
    bit for bit), the final parameter sha256 equal to phase 4's, W
    producers and one consumer a step run. The checkpoint's bytes (18 B
    a parameter), each save's blocking host copy and background write,
    the view's and the restore's time.
33. dist_ckpt — W=2 ranks sharing ``cuda:0`` over gloo train phase 4's
    first two steps and checkpoint (every rank gathers, rank 0 writes;
    in the spawn of phase 18's ranks, the checkpoint kept under
    ``build/`` until this phase);
    the emulated workers restore it and train steps 2-3. The ranks'
    losses and parameters equal phase 4's, one producer and one
    consumer a step a rank, the restored run's final sha256 equal to
    phase 4's; the gathers' time over gloo, the save and the restore.

Serving (``repro_torch.serve``: prefill, KV-cache decode, the continuous
batcher; after phase 33, its memory freed). No codec kernel runs on this
path: the launch counters are zeroed just before each phase and must
read 0 just after.

34. serve — granite-3-2b at full width and full depth (40 layers), bf16,
    random weights from seed 0 (its init's peak on a line of its own):
    ``ServeEngine.generate`` on 8 prompts of 512 tokens (from
    ``default_rng(0)``), 64 new tokens, ``max_len`` 584; then the
    ``ContinuousBatcher`` over 16 requests (prompt ``u % 8``) in 8 slots
    for 192 decode steps: all 16 complete with 64 tokens each, the second
    wave decoding past ``max_len`` (clamped writes). Then, outside the
    counted run: a second ``generate`` with tokens equal to the first,
    through ``ServeClock`` (the engine's own loop, its model calls
    wrapped), timed with CUDA events around the prefill and each decode
    call and keeping the logits. Random weights make rows repeat a
    token, so the checks hold logits: the first wave's decode calls
    against ``generate``'s (inputs equal, logits within a bound), the
    second wave's slots 0 and 7 against a batch-1 engine fed the slot's
    tokens at the positions the shared position implies (576 on, past
    ``max_len``), the prompt's last 3 tokens decoded, each step against
    the prefill of the prompt up to its token, each within a bound from the card's readings; one request through a
    batch-1 batcher equal to a batch-1 ``generate`` call for call, logits
    bit for bit. The decode step's kernels come from two profiled
    ``generate`` runs (5 and 1 new tokens), their difference. Prints
    prefill ms, decode ms a step (each, and the median) beside the bound
    (weights + the whole KV cache at 3.35 TB/s), tokens/s of ``generate``
    and of the batcher (host clock after a synchronise), the peak memory
    after a reset that follows init, the distinct tokens of each row, and
    the sha256 of the tokens and of the completions.
35. serve_moe — deepseek-moe-16b likewise at full width and full depth
    (28 layers), 32 new tokens, no batcher; MoE decode routes at
    ``capacity_factor_decode`` 2.0 (C = 2 at B = 8); its decode/prefill
    check runs on the same weights with both capacity factors E / K, so
    that no token drops.
36. serve_consistency — the reference's prefill/decode check
    (``tests/test_decode_consistency.py``) at full width, f32, depth 4,
    B 2: prefill 64 tokens, decode 3, each step's logits equal to the
    prefill up to its token (65, 66, 67) within atol 2e-3; granite-3-2b, and deepseek-moe-16b with
    both capacity factors E / K (no token drops).

The ssm, hybrid, vlm and encdec families (after phase 36, its memory
freed):

37. ssm_train — mamba2-1.3b at its published widths (d_model 2048,
    d_inner 4096, 64 heads of 64, d_state 128, chunk 256, vocab 50280,
    tied embedding), depth 48 -> 12, bf16, trained as phase 4 (W=2,
    global batch 8 x 1024, ``compressed`` at ratio 0.1 and top-k 4%,
    AdamW with ZeRO-1, ``block`` remat: one Mamba2 layer a unit), one
    warm-up and three timed steps; rows 1 / 2 launched W / 1 times a step.
    Then rows 1 and 2 against their plain versions on the stream the next
    step would send (each worker's producer, the consumer on their sum
    and OR; phase 3's tolerance), and step 0 again from the same init
    under ``use_pallas="never"``: no kernel launched, the parameters equal
    the kernels' step 0 bit for bit. Prints step ms, peak memory, the
    launches, buckets and blocks a step, the parameter sha256 after every
    step.
38. vlm_train — internvl2-2b likewise at its published widths (d_model
    2048, 16 / 8 heads, d_ff 8192, vocab 92553), depth 24 -> 4, each row
    256 visual tokens from ``batch_fn`` before its 1024 text tokens, the
    loss over the text positions only.
39. ssm_serve — mamba2-1.3b at full width, depth 48 -> 24 (it served the
    whole model before; the cut pays for ``dist_serve``) through phase 34's
    ``serve_model``: ``generate`` on 8 prompts of 512 tokens, 64 new; the
    batcher over 16 requests in 8 slots (the batch is axis 1 of every
    cache leaf); the logit checks and the batch-1 check; the decode bound
    counts the weights and the whole decode cache (the f32 Mamba states).
40. hybrid_serve — jamba-v0.1-52b at full width, depth 32 -> 8 (one
    superblock: one attention, seven Mamba2 layers, four MoE FFNs of 16
    experts of d_ff 14336, ~13.3 B parameters), ``generate`` and the
    decode/prefill check as phase 39; no batcher, whose splice
    broadcasts over the superblock's Mamba positions and raises at this
    period, as the reference's.
41. encdec_train — whisper-tiny whole (4 encoder and 4 decoder layers,
    d_model 384, 6 heads of 64, d_ff 1536, vocab 51865 padded to 51968,
    36,487,680 parameters), bf16, trained as phase 37 with rows of 448
    decoder tokens (Whisper's text context) and 1500 frames from
    ``batch_fn``: 34 buckets, 1,190 blocks a step; then the stream check
    and the plain replay of phase 37, and rows 1 and 2 timed on that
    stream (CUDA events, beside their plain versions and their bounds).
42. encdec_serve — whisper-tiny whole through phase 34's
    ``serve_model``: ``generate`` on 8 prompts of 384 tokens and their
    1500 frames (``default_rng(0)``, after the prompts), 64 new,
    ``max_len`` 448; no batcher (its single-request prefill passes no
    frames and raises ``KeyError``, as the reference's); decode against
    prefill in f32 at atol 2e-3, and generate's row 0 against a batch-1
    engine fed its prompt, frames and tokens, within a bound from the
    card's readings. The decode bound counts the weights and the whole
    cache (self K/V and the cross K/V of 1500 frames).

The model axis (after phase 42, its memory freed):

43. dist_model — a grid of 2 data-parallel x 2 model ranks: 4 gloo
    ranks sharing ``cuda:0`` (host-staged), each holding its shards of
    the sharding profile's splits (attention and MLP columns / rows,
    the vocab, the routed experts in groups of E/2) and its data
    index's rows of a global batch of 8; granite-3-2b at full width,
    depth 4, under ``compressed`` (top-k 4%, ZeRO-1) and ``dense``,
    deepseek-moe-16b at full width, depth 1, under ``ep_exchange``
    ``none``, ``dense`` and ``compressed`` (the exchange over the model
    ranks), whisper-tiny whole (3 of 6 heads a rank; rows of 448 tokens
    and 1500 frames) and internvl2-2b at full width, depth 4 (its 256
    visual tokens replicated) and mamba2-1.3b at full width, depth 12
    (half its 64 Mamba heads a rank; ``wB``, ``wC``, the conv and the
    gated norm's scale replicated, the norm's mean over the whole
    ``d_inner``) under ``compressed``, two steps an arm
    (``DIST_MODEL_STEPS``), one arm after another with the caches
    emptied between them; then qwen2.5-3b at full width, depth 2, on a
    grid of 1 data index x 4 model ranks of the same processes (16
    heads, 2 KV heads: half a KV head a rank, the K/V columns gathered).
    Holds on every rank: one producer and one
    consumer a step (the compressed arms), none on dense; the step-0 shard-local aggregate and residuals equal
    to the plain aggregator's on the same group and inputs bit for bit,
    and so on dyadic gradients of the same leaves;
    the replicated leaves' step-0 gradients equal across the model ranks
    of a data index (granite's and mamba's compressed arms); the
    compressed exchange equal to the dense one bit
    for bit (losses, parameter shards) and within rtol 1e-2 of ``none``;
    granite's dense arm, whisper's, internvl's and mamba's losses within
    ``DIST_MODEL_LOSS_RTOL`` of their emulated W=2 trains' (the first
    two of phases 4, 41, 38 and 37, which run at the initial parameters:
    the learning rate is 0 at step 0); the wide arm's losses equal on
    every rank and its step-0 loss within ``DIST_MODEL_LOSS_RTOL`` of the
    unsharded loss rank 0 computes from the gathered parameters on the
    same rows. Prints, beside the card's name and
    power limit, step ms, peak memory a rank and the card's (polled over
    the phase and over each arm), the launches a rank, and the last
    step's model-axis collectives replayed alone (ms and bytes a rank).
43b. dist_serve — serving on the same grid, in the same spawn after
    ``dist_model``'s arms, through ``serve.steps``' grid steps at full
    width, 16 greedy tokens an arm: granite-3-2b at depth 4 in f32 with
    B 8 x 512 (the batch over ``data``, the KV cache's sequence over
    ``model``) and B 1 x 4,096 (the sequence over all four ranks),
    mamba2-1.3b at depth 12, deepseek-moe-16b at depth 1 and whisper-tiny
    whole in f32, granite whole in bf16 for the times. Before the spawn
    (``dist_serve_ref``) the unsharded ``ServeEngine`` on the card writes
    each arm's tokens, logits and prefill cache under ``build/``. Holds
    on every rank, f32 arms: the tokens equal the engine's, the logits at
    every step and the cache block after the prefill within
    ``SERVE_LOGITS_ATOL[arch]["grid_f32"]``, Mamba's conv state the same
    bytes on the model ranks of a data index; no codec launch. Prints
    prefill ms, decode ms a step against the bound of the four ranks'
    weights and caches, the groups' collectives a step replayed alone,
    peak memory a rank and the card's, the bf16 arm's tokens equal to
    the engine's, and the dry run's argument bytes and peak for the
    granite B 8 decode against rank 0's.

The long-sequence shapes (after phase 43, its memory freed; every
training and prefill attention above is blockwise too,
``layers.flash_attention``):

44. long_train — granite-3-2b at full width, depth 40 -> 4, at
    ``train_4k``'s S 4,096, global batch 4 (cut from 256), W=2
    emulated, ``compressed``, the ``block`` remat, ZeRO-1, one warm-up
    and two timed steps: W producer launches and one consumer launch a
    step; step ms and peak memory. Then ``flash_attention`` against the
    plain one-pass softmax at granite's heads (32 / 8 of 64), S 4,096,
    B 1, causal, f32 and bf16: output and q, k, v gradients within
    ``FLASH_ATOL`` of the largest entry; each one's ms forward and
    forward + backward, its peak memory and the blockwise bound.
45. long_serve — granite-3-2b whole (40 layers, bf16) through
    ``ServeEngine.generate``: 2 prompts of 32,768 tokens
    (``prefill_32k``'s length), 16 new; prefill ms, decode ms a step
    beside its bound, the peak memory of the prefill and of the decode;
    no codec kernel launched. Then at depth 4 in f32 (one row) each of 3
    decode steps after a 32,768-token prefill against a prefill of the
    prompt up to its token, within atol 2e-3.

Each phase's wall seconds follow it on a ``phase_seconds`` line, and all
of them together (``phase_seconds_all``) precede the kernels line. To
keep the script well inside its time limit, ``dist_train`` and
``dist_rs`` run two steps an arm (``DIST_STEPS``: a warm-up and a timed
step), held to the first two steps of their emulations; the ranks of
phases 18, 21-22, 24 and 28 are spawned once (``dist_spawn``).

Then the ``{"kernels": [...]}`` line (all six kernel rows, each with
its resident blocks an SM, threads a block and shared-memory bytes from
the occupancy query, its launches on each train path (the ``auto``
phases', the MoE trains' and phases 37-38's, 41's and 44's too), ``dist_train``'s, ``dist_rs``'s,
``dist_auto``'s and ``dist_a2a``'s summed over the ranks, each
``dist_model`` arm's summed over its 4 ranks, rows 1 and 2
with their ``kernels_a2a`` times under ``a2a``, rows 1, 2 and 4 with
their ``kernels_elastic`` times under ``elastic`` and every row's
launches on each ``elastic`` arm, in phases 31-33 (``dist_ckpt``'s
ranks summed) and in phases 34-36, 39-40, 42, 43b and 45 (0), for the three
peel kernels the rounds histogram, for
the three encode kernels the phase stamps; a peel kernel below 48
resident warps an SM, or an encode kernel below 32, fails the run), the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. There is no
CPU fallback: without a CUDA device the script exits non-zero before
printing a result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 on the tensor cores, dense
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
        # whether every output held to a tolerance (the peels' values on
        # Gaussian inputs) was bit for bit all the same
        self.gaussian_bit_equal = dict.fromkeys(self.err, True)

    def __call__(self, name, got, want, exact):
        import torch
        if exact:
            ok = torch.equal(got, want)
        else:
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
            self.gaussian_bit_equal[name] &= torch.equal(got, want)
        if got.dtype.is_floating_point:
            self.err[name] = max(self.err[name], float((got - want).abs().max()))
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({'exact' if exact else 'rtol=1e-5'})")

    def producer(self, xb, ids, cfg):
        """Producer kernel vs plain on ``xb``, bit for bit on any input
        (the plain encode sums each cell in the kernel's order); returns
        the kernel's outputs."""
        from repro_torch.kernels import ops, ref
        want = ref.encode_pack_quantize_ref(xb, ids, cfg)
        got = ops.encode_pack_quantize(xb, ids, cfg)
        for g, w in zip(got, want):
            self("encode_pack_quantize", g, w, True)
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

    def producer_q(self, xb, ids, cfg, f32, wire, e):
        """Quantize leg vs plain on ``xb``, and vs the f32 kernel's outputs
        ``f32`` composed with ``wire.encode``, bit for bit on any input
        (the plain encode sums in the kernels' order, so its q is the
        kernel's). Returns the kernel's outputs."""
        from repro_torch.kernels import ops, ref
        name, M, nb = "encode_pack_quantize_q", wire.mantissa_bits, xb.shape[0]
        got = ops.encode_pack_quantize(xb, ids, cfg, exponents=e, mantissa_bits=M)
        sk, w, mx = f32
        self(name, got[0].reshape(nb, -1), wire.encode(sk.reshape(nb, -1), e), True)
        self(name, got[1], w, True)
        self(name, got[2], mx, True)
        want = ref.encode_pack_quantize_ref(xb, ids, cfg, exponents=e,
                                            mantissa_bits=M)
        for g, wv in zip(got, want):
            self(name, g, wv, True)
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

    def encode_std(self, xb, ids, cfg):
        """Standalone encode kernel vs plain on ``xb``, and, on an aligned
        geometry, vs the fused producer's sketch, bit for bit on any input.
        Returns the kernel's sketch."""
        from repro_torch.kernels import ops, ref
        got = ops.sketch_encode(xb, ids, cfg)
        self("sketch_encode", got, ref.sketch_encode_ref(xb, ids, cfg), True)
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
        sk, w, _ = check.producer(xb, ids, cfg)
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
        sk, w, _ = check.producer(xb, idb, big)
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
        xs = [make_blocks(c, nb, frac, kind, gen) for _ in range(WORKERS)]
        f32 = [ops.encode_pack_quantize(x, ids[:nb], c) for x in xs]
        e = wire.exponents_from_maxabs(group.max([f[2] for f in f32]))
        qs = [check.producer_q(x, ids[:nb], c, f, wire, e)
              for x, f in zip(xs, f32)]
        q = group.sum([g[0] for g in qs])
        w = group.bor([g[1] for g in qs])
        _, res = check.consumer_dq(q, w, ids[:nb], c, wire, e, exact)
        emit({"phase": "kernels_q", "case": f"{kind}@{frac} rows={c.rows} "
              f"G={c.group}", "blocks": nb, "workers": WORKERS,
              "mantissa_bits": wire.mantissa_bits, "agree": True,
              "exponent_range": [int(e.min()), int(e.max())],
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
        sk = check.encode_std(xb, idb, c)
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


def bound(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    """(ms, what bounds it): bytes over the HBM rate, operations over
    ``ops_per_s`` (the float32 rate unless given), the larger of the
    two."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
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
                                         row_lists, scatter_rows)
    rows_flat, _ = device_tables(cfg, bits.device)
    lists = row_lists(cfg, bits.device)
    rot = hashing.block_rotations(ids, cfg.group, cfg.lanes, cfg.seed)

    def to_cells(mask):
        return scatter_rows(roll_to_sketch(mask.to(torch.int32), rot, cfg.lanes),
                            lists)

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
    sk, w, mx = check.producer(xb, ids, cfg)
    enc_digests = {"gauss@0.04": digest(sk, w, mx)}
    digests = {"gauss@0.04": digest(*check.consumer(sk, w, ids, cfg, False))}
    del xb, sk, w, mx
    torch.cuda.empty_cache()

    group = LocalWorkers(WORKERS)
    xs = [make_blocks(cfg, nb, 0.04, "dyadic", gen) for _ in range(WORKERS)]
    enc = [check.producer(x, ids, cfg) for x in xs]
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
                     "max_abs_err": check.err[name],
                     "gaussian_bit_equal": check.gaussian_bit_equal[name],
                     "ms": cuda_ms(kfn, 10),
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
                arch_name="granite-3-2b", layers=LAYERS, seq=SEQ, batch=BATCH):
    """The main path: ``compressed`` (``wire="f32"``) or, with
    ``wire="fxp32"``, ``compressed_innet`` on the fxp32 wire; ``fields``
    override the config's compression fields (the Bloom path:
    ``index="bloom"``, a 0.1% top-k; the streamed paths: ``overlap``),
    ``tc_fields`` its train fields (``aggregator``, ``zero1``,
    ``ep_exchange``, ``ep_workers``), ``arch_name`` and ``layers`` the
    model and its depth, ``seq`` the tokens a row, ``batch`` the rows,
    ``wire_plan`` the aggregator's wire plan, and ``want`` the launch
    counts the run of ``steps`` steps must give (default: the unstreamed
    paths'). The launch counters are zeroed just before the run and read
    just after; the parameters' sha256 is taken after every step, outside
    the step's clock."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import run_training

    arch = get_arch(arch_name)
    mcfg = dataclasses.replace(arch.model, n_layers=layers)
    innet = wire == "fxp32"
    tc = dataclasses.replace(
        arch.train, workers=WORKERS, accum_steps=1,
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
            res = run_training(api, tc, global_batch=batch, seq_len=seq,
                               steps=steps, device=dev, params=params,
                               log_every=1, log_fn=after_step)
    else:
        res = run_training(api, tc, global_batch=batch, seq_len=seq,
                           steps=steps, device=dev, params=params,
                           log_every=1, log_fn=after_step,
                           wire_plan=wire_plan)
    launches = codec_launches()
    expect = dict.fromkeys(launches, 0)
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
    # AdamW on the card: one hand-kernel launch a leaf a step
    adam = ops.LAUNCHES["adam_update"]
    want_adam = steps * len(res.state.params.leaves()) if opt_lib.fused_adamw(
        tc.optimizer, dev, tc.compression.use_pallas) else 0
    if adam != want_adam:
        raise AssertionError(f"{phase}: {adam} adam_update launches, expected "
                             f"{want_adam}")
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
           "reduced": ({} if layers == arch.model.n_layers else
                       {"n_layers": f"{arch.model.n_layers} -> {layers}"}),
           "workers": WORKERS, "global_batch": batch, "seq_len": seq,
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
           "adam_update_launches": adam, "param_sha256_by_step": digests,
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
    from repro_torch.kernels.adam_update import adam_update_cuda
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
        loss, _ = api.loss(params.tree(), rows, remat=tc.remat,
                           **(loss_kw or {}))
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

        def optimizer_plain():
            for i, (p, g) in enumerate(zip(leaves, agg_leaves)):
                st = {k: state.opt[k][i] for k in state.opt}
                opt_lib.opt_leaf_update(p, g, st, lr, state.step, tc.optimizer)

        def optimizer():
            """The hand AdamW kernel over every whole leaf, in place (the
            step's update, replicated: its ZeRO-1 slices move the same
            bytes), the clip folded in."""
            sc = opt_lib.step_scalars(state.step, opt_lib.global_grad_norm(
                agg_leaves), tc.optimizer, dev)
            for i, (p, g) in enumerate(zip(leaves, agg_leaves)):
                adam_update_cuda([p], [g], [state.opt["m"][i]], [state.opt["v"][i]],
                                 sc, tc.optimizer)

        stages["unpack"] = (1, cuda_ms(lambda: plan.unpack(
            rec.reshape(plan.n_buckets, plan.bucket_elems) / W), 5, 1))
        optimizer_plain_ms = cuda_ms(optimizer_plain, 5, 1)
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
           "sum_of_stages_ms": total, "optimizer_plain_ms": optimizer_plain_ms,
           "worker0_sent_fraction": sent,
           "worker0_zero_residual_selection": selection, **(extra or {})}
    emit(out)
    return out


ADAM_CELLS = ("granite-3-2b.d4", "deepseek-moe-16b.d1")
HBM_BYTES_PER_S = 3.35e12


def adam_cell_configs(name: str, mix: dict):
    """(ModelConfig, TrainConfig) of the benchmark cell configuration
    ``bench/configs/<name>.json`` under ``mix``, read from the JSON alone:
    the model's fields, and the mix's workers, ZeRO-1 and optimizer."""
    from repro_torch.models.config import ModelConfig, MoEConfig
    from repro_torch.train.config import TrainConfig
    from repro_torch.train.optimizer import OptimizerConfig
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    fields = {k: v for k, v in cfg.items()
              if k in {f.name for f in dataclasses.fields(ModelConfig)}}
    fields["name"] = cfg["arch"]
    if fields.get("moe"):
        fields["moe"] = MoEConfig(**fields["moe"])
    tc = TrainConfig(workers=mix["workers"], zero1=mix["zero1"],
                     optimizer=OptimizerConfig(**mix["optimizer"]))
    return ModelConfig(**fields), tc


def library_adamw_ms(metas, ocfg, dev) -> dict:
    """PyTorch's own fused AdamW (``torch._fused_adamw_``, one
    multi-tensor call over whole leaves of ``metas``' shapes) for scale:
    it keeps its moments in the parameters' dtype and writes no ZeRO-1
    delta, so it runs f32 throughout (28 B a parameter) and bf16
    throughout (14 B), each with its bytes' time at 3.35 TB/s."""
    import torch
    out = {}
    n = sum(t.numel() for t in metas)
    for dt, per in ((torch.float32, 28), (torch.bfloat16, 14)):
        ts = [[torch.randn(t.shape, device=dev).mul_(s).to(dt) for t in metas]
              for s in (0.02, 1e-3, 1e-4, 1e-4)]
        ts[3] = [x.square_() for x in ts[3]]
        steps = [torch.full((), 3.0, device=dev) for _ in metas]
        ms = cuda_ms(lambda: torch._fused_adamw_(
            *ts, [], steps, lr=ocfg.lr, beta1=ocfg.b1, beta2=ocfg.b2,
            weight_decay=ocfg.weight_decay, eps=ocfg.eps, amsgrad=False,
            maximize=False), 5, 1)
        bound = n * per / HBM_BYTES_PER_S * 1e3
        out[str(dt).split(".")[1]] = {"ms": ms, "bound_ms": bound,
                                      "roofline_pct": bound / ms * 100}
        del ts, steps
        torch.cuda.empty_cache()
    return out


def phase_adam_update(dev):
    """The optimizer's hand AdamW kernel at the benchmark cells' leaf
    shapes (``bench/configs``, the ``train.w2`` mix: bf16 weights, f32
    norm scales and router, f32 moments, W 2 emulated workers with
    ZeRO-1), on random leaves, grads and moments from a fixed seed at
    step 3 with the clip engaged. Per cell: ``apply_update`` once on each
    path from one state, leaves, moments and norm equal bit for bit (else
    the phase fails); then the kernel over every leaf's slices (one
    launch a leaf, the gathers left out: ``kernel_ms``), the plain update
    (``clip_grads`` and ``opt_leaf_update`` a slice, as the plain path's
    ``optimizer/clip`` and ``optimizer/update`` spans time it inside
    ``apply_update``: ``plain_ms``), the bound (the bytes of one pass at
    3.35 TB/s: 22 B a bf16 parameter, 28 an f32 one), ``apply_update``
    whole on both paths and PyTorch's fused AdamW on the same shapes
    (``library``); and each leaf's kernel time against its bound."""
    import torch
    from repro_torch import obs
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.kernels.adam_update import (adam_bytes, adam_occupancy,
                                                 adam_update_cuda, layout)
    from repro_torch.models.params import ParamTree
    from repro_torch.models.registry import model_api
    from repro_torch.serve.steps import params_struct
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.step import TrainState, apply_update, zero1_dims

    mix = json.loads((ROOT / "bench" / "mixes" / "train.w2.json").read_text())
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def rand(shape, dtype, scale, square=False):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return (x * x if square else x).to(dtype)

    cells = {}
    for name in ADAM_CELLS:
        mcfg, tc = adam_cell_configs(name, mix)
        ocfg, W = tc.optimizer, tc.workers
        paths = ParamTree(params_struct(model_api(mcfg)))
        metas = paths.leaves()
        leaves = [rand(t.shape, t.dtype, 0.02) for t in metas]
        grads = [rand(t.shape, t.dtype, 1e-3) for t in metas]
        moms = {"m": [rand(t.shape, ocfg._sdt, 1e-4) for t in metas],
                "v": [rand(t.shape, ocfg._sdt, 1e-4, square=True) for t in metas]}
        dims = zero1_dims(leaves, tc)
        group = LocalWorkers(W)

        def state_of(ls, ms):
            return TrainState(
                params=type("Params", (), {"leaves": lambda self: ls})(),
                opt=ms, residual=[], step=3)

        # one update on each path from the same state: bit for bit
        arms = {}
        for policy in ("never", "auto"):
            ls = [x.clone() for x in leaves]
            ms = {k: [x.clone() for x in v] for k, v in moms.items()}
            obs.enable(dev)
            obs.reset()
            gnorm = apply_update(state_of(ls, ms), grads, dims, group, ocfg,
                                 use_pallas=policy)
            snap = obs.snapshot()
            obs.disable()
            obs.reset()
            arms[policy] = (ls, ms, gnorm, snap)
        (lp, mp, np_, sp), (lk, mk, nk, sk) = arms["never"], arms["auto"]
        same = torch.equal(np_, nk) and all(
            torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                        b.view(torch.int16 if b.element_size() == 2 else torch.int32))
            for a, b in zip(lp + mp["m"] + mp["v"], lk + mk["m"] + mk["v"]))
        if not same:
            raise AssertionError(f"adam_update {name}: the kernel's update "
                                 "differs from the plain path's")
        del arms, lp, mp, sp
        state = state_of(lk, mk)
        sc = opt_lib.step_scalars(3, nk, ocfg, dev)

        def leaf_kernel(i):
            p, d = lk[i], dims[i]
            m, v = mk["m"][i], mk["v"][i]
            if d is None:
                return lambda: adam_update_cuda([p], [grads[i]], [m], [v], sc, ocfg)
            blk = p.shape[d] // W
            return lambda: adam_update_cuda(
                [p.narrow(d, w * blk, blk) for w in range(W)],
                [grads[i].narrow(d, w * blk, blk) for w in range(W)],
                [m.narrow(d, w * blk, blk) for w in range(W)],
                [v.narrow(d, w * blk, blk) for w in range(W)], sc, ocfg, dim=d)

        runs = [leaf_kernel(i) for i in range(len(lk))]

        def kernel():
            for r in runs:
                r()

        def spans(policy):
            """The plain path's clip + update spans (device ms), or the
            kernel's update span, one apply_update."""
            obs.enable(dev)
            obs.reset()
            apply_update(state, grads, dims, group, ocfg, use_pallas=policy)
            snap = obs.snapshot()["spans"]
            obs.disable()
            obs.reset()
            return {k: v["self_device_ms"] for k, v in snap.items()}

        per_leaf = []
        for i, (path, p, d) in enumerate(zip(paths.paths, lk, dims)):
            nbytes = adam_bytes(p.dtype, grads[i].dtype, mk["m"][i].dtype, p.numel())
            ms_ = cuda_ms(lambda: [runs[i]() for _ in range(10)], 5, 1) / 10
            blk = p.shape[0 if d is None else d] // (1 if d is None else W)
            geo = layout([p.narrow(0 if d is None else d, 0, blk)], [grads[i]
                         .narrow(0 if d is None else d, 0, blk)],
                         [mk["m"][i].narrow(0 if d is None else d, 0, blk)],
                         [mk["v"][i].narrow(0 if d is None else d, 0, blk)], d)[0]
            per_leaf.append({"leaf": "/".join(path), "shape": list(p.shape),
                             "dtype": str(p.dtype), "dim": d,
                             "kernel": "tile" if geo.tile else "rows",
                             "ms": ms_, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                             "roofline_pct": nbytes / HBM_BYTES_PER_S * 1e3 / ms_ * 100})
        bound = sum(adam_bytes(p.dtype, g.dtype, m.dtype, p.numel()) for p, g, m
                    in zip(lk, grads, mk["m"])) / HBM_BYTES_PER_S * 1e3
        kernel_ms = cuda_ms(lambda: [kernel() for _ in range(5)], 5, 1) / 5
        plain_spans = [spans("never") for _ in range(3)]
        kernel_spans = [spans("auto") for _ in range(3)]
        cells[name] = {
            "params": sum(p.numel() for p in lk), "leaves": len(lk),
            "bit_equal": same, "kernel_ms": kernel_ms, "bound_ms": bound,
            "roofline_pct": bound / kernel_ms * 100,
            "plain_ms": statistics.median(s.get("optimizer/clip", 0.0)
                                          + s["optimizer/update"] for s in plain_spans),
            "kernel_update_span_ms": statistics.median(s["optimizer/update"]
                                                       for s in kernel_spans),
            "apply_update_ms": {
                policy: cuda_ms(lambda: apply_update(state, grads, dims, group, ocfg,
                                                     use_pallas=policy), 5, 1)
                for policy in ("never", "auto")},
            "per_leaf": per_leaf}
        del state, lk, mk, leaves, grads, moms, runs, nk, np_
        torch.cuda.empty_cache()
        cells[name]["library"] = library_adamw_ms(metas, ocfg, dev)
    bf = torch.bfloat16
    out = {"phase": "adam_update", "step": 3, "cells": cells,
           "blocks_per_sm": {k: adam_occupancy(k == "tile", bf, bf, torch.float32, dev)
                             for k in ("rows", "tile")}}
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
    qw = [check.producer_q(x, ids, cfg, f, wire, e)
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
                     "max_abs_err": check.err[name],
                     "gaussian_bit_equal": check.gaussian_bit_equal[name],
                     "ms": cuda_ms(kfn, 10),
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
    before = codec_launches()
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
    skg = check.encode_std(xg, ids, cfg)
    enc_digests = {"gauss@0.001": digest(skg)}
    bits = index_lib.bloom_query((nb, G, c), cfg, index_lib.bloom_build(xg, cfg))
    digests = {"gauss@0.001": digest(*check.peel_std(skg, bits, ids, cfg, False))}
    del xg, skg, bits
    xs = [make_blocks(cfg, nb, density, "dyadic", gen) for _ in range(WORKERS)]
    enc = [check.encode_std(x, ids, cfg) for x in xs]
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
                     "max_abs_err": check.err[name],
                     "gaussian_bit_equal": check.gaussian_bit_equal[name],
                     "ms": cuda_ms(kfn, 10),
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
    before = codec_launches()
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


DIST_TIMEOUT = 600       # seconds the dist_* phases' ranks may take in all
SPAWN_SHARED = ["dist_train", "dist_rs", "dist_auto", "dist_a2a", "dist_ckpt"]
DIST_STEPS = 2           # steps of each dist_train / dist_rs arm: one warm-up,
                         # one timed (the emulated phases run STEPS)
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
                                 aggregator=aggregator)
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
                           steps=DIST_STEPS, device=dev, params=params,
                           log_every=1, log_fn=after_step, group=log)
        launches = codec_launches()
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


def dist_ranks_rank(group, dev, shapes_dtypes, n_buckets, ckpt_dir):
    """One rank of phases 18, 21-22, 24, 28 and 33, in one spawn, on the
    same process group: ``dist_train``'s arms (:func:`dist_rank`), then
    ``dist_rs``'s and the gather-skip checks (:func:`dist_rs_rank`),
    ``dist_auto``'s mixed plan (:func:`dist_auto_rank`), ``dist_a2a``'s
    exchanges (:func:`dist_a2a_rank`) and ``dist_ckpt``'s checkpointed
    train into ``ckpt_dir`` (:func:`dist_ckpt_rank`), each as its own
    spawn ran it."""
    return {"dist_train": dist_rank(group, dev),
            "dist_rs": dist_rs_rank(group, dev, shapes_dtypes),
            "dist_auto": dist_auto_rank(group, dev, n_buckets),
            "dist_a2a": dist_a2a_rank(group, dev),
            "dist_ckpt": dist_ckpt_rank(group, dev, ckpt_dir)}


def spawn_dist(shapes_dtypes, n_buckets, n_params):
    """The W=2 ranks of ``dist_train``, ``dist_rs``, ``dist_auto``,
    ``dist_a2a`` (whose EP ranks are as many) and ``dist_ckpt``, spawned
    once: each spawn costs 10-20 s before a rank's first step.
    ``dist_ckpt``'s checkpoint goes to a temporary directory under
    ``build/``, which its phase restores from and removes. -> ({phase:
    each rank's result}, the spawn's wall seconds, that directory)."""
    import tempfile
    from repro_torch.launch.ranks import spawn_ranks

    if EP_WORKERS != WORKERS:
        raise ValueError("dist_a2a's EP ranks must be the spawn's W ranks")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    disk_room(build, ckpt_bytes(n_params) + (1 << 30))
    ckpt_dir = tempfile.mkdtemp(dir=build)
    t0 = time.perf_counter()
    outs = spawn_ranks(dist_ranks_rank, WORKERS,
                       (shapes_dtypes, n_buckets, ckpt_dir),
                       device="cuda", timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    return {k: [o[k] for o in outs] for k in outs[0]}, wall, ckpt_dir


def phase_dist_train(emulated_losses, outs, wall):
    """W=2 ranks as processes sharing ``cuda:0`` over gloo (NCCL refuses
    two ranks on one device: the probe's error is printed), the phase-4
    train on the compressed arm and then the dense arm, one worker a
    rank (``outs``: each rank's :func:`dist_rank` result, from the spawn
    the ``dist_*`` phases share, which took ``wall`` seconds). Fails unless each
    rank launched exactly one producer and one
    consumer a step (compressed; none dense), every rank's parameter
    digest is equal after every step, the OR all-reduce of the last
    step's real words equals an ``all_gather`` and a local OR, and the
    losses are finite and within rtol 1e-3 of the emulated ``train``
    phase's (backward atomics make bit equality unlikely: the first
    step's loss is forward only and is reported apart)."""
    want = dict.fromkeys(outs[0]["arms"]["compressed"]["launches"], 0)
    want.update(encode_pack_quantize=DIST_STEPS, dequant_peel_unpack=DIST_STEPS)
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
                len(per[0]["digests"]) != DIST_STEPS:
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
    emulated_losses = emulated_losses[:DIST_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(comp["losses"], emulated_losses)]
    if max(rel) > 1e-3:
        raise AssertionError(f"dist losses {comp['losses']} vs emulated "
                             f"{emulated_losses}")
    dense = outs[0]["arms"]["dense"]["collectives"]
    arms["compressed"].update(
        recovery=comp["recovery"], or_check=comp["or_check"],
        emulated_losses=emulated_losses, loss_rel_diff_to_emulated=rel,
        first_loss_equal_to_emulated=comp["losses"][0] == emulated_losses[0])
    # the two probes' ranks start together: a spawn's time is mostly its
    # ranks' start-up, and each probe's outcome is its own
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        nccl, gloo_p2p = pool.map(probe, ("nccl", "gloo_p2p"))
    line = {"phase": "dist_train", "arch": "granite-3-2b", "layers": LAYERS,
            "workers": WORKERS, "procs": WORKERS, "global_batch": BATCH,
            "seq_len": SEQ, "steps": DIST_STEPS, "warmup_steps": 1,
            "backend": outs[0]["backend"], "staging": outs[0]["staging"],
            "devices": [o["device"] for o in outs],
            "wall_s": wall, "spawn_shared_with": SPAWN_SHARED, "arms": arms,
            "probes": {"nccl_two_ranks_one_device": nccl,
                       "gloo_p2p_cuda_tensor": gloo_p2p}}
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
            arch.train, workers=WORKERS, accum_steps=1,
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
                           steps=DIST_STEPS, device=dev, params=params,
                           log_every=1, log_fn=after_step, group=log)
        arm = {"losses": res.losses, "digests": digests,
               "launches": codec_launches(),
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


def phase_dist_rs(cfg, rs_arms, train, shapes_dtypes, outs, wall):
    """W=2 ranks sharing ``cuda:0`` over gloo, as ``dist_train`` (``outs``:
    each rank's :func:`dist_rs_rank` result, from the spawn the ``dist_*``
    phases share, which took ``wall`` seconds): the
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
    n_chunks = stream_grids(shapes_dtypes, cfg)[1]["allreduce"].n_chunks
    # a rank runs its own worker's producers; on the reduce-scatter wire
    # it peels its own half, on the all-reduce wire the whole stream
    emulated = {"rs_zero1": (rs_arms["oneshot"], {
                    "encode_pack_quantize": DIST_STEPS,
                    "dequant_peel_unpack": DIST_STEPS}),
                "overlap": (train, {"encode_pack_quantize": n_chunks * DIST_STEPS,
                                    "dequant_peel_unpack": DIST_STEPS})}
    arms, launches = {}, {}
    for name, (emu, want) in emulated.items():
        per = [o["arms"][name] for o in outs]
        want = {**dict.fromkeys(per[0]["launches"], 0), **want}
        for r, a in enumerate(per):
            if a["launches"] != want:
                raise AssertionError(f"rank {r} {name}: launch counts "
                                     f"{a['launches']}, expected {want}")
            if a["digests"] != emu["param_sha256_by_step"][:DIST_STEPS]:
                raise AssertionError(f"rank {r} {name}: parameters differ from "
                                     "the emulated run")
            if a["losses"] != per[0]["losses"]:
                raise AssertionError(f"{name}: ranks report different losses")
        launches[name] = {k: sum(a["launches"][k] for a in per) for k in want}
        arms[name] = {
            "losses": per[0]["losses"],
            "emulated_losses": emu["losses"][:DIST_STEPS],
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
          "seq_len": SEQ, "steps": DIST_STEPS, "warmup_steps": 1,
          "backend": outs[0]["backend"], "staging": outs[0]["staging"],
          "devices": [o["device"] for o in outs], "wall_s": wall,
          "spawn_shared_with": SPAWN_SHARED, "arms": arms,
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
        arch.train, workers=WORKERS, accum_steps=1,
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
                           remat=tc.remat)
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
    launches["controller"] = codec_launches()
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
           "launches": codec_launches(),
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


def phase_dist_auto(n_buckets, emulated_digests, outs, wall):
    """W=2 ranks sharing ``cuda:0`` over gloo, as ``dist_train`` (``outs``:
    each rank's :func:`dist_auto_rank` result, from the shared spawn, which
    took ``wall`` seconds): the fixed
    mixed plan of ``auto_train`` for 2 steps. After every step the
    parameter sha256 must be equal on both ranks and to ``auto_train``'s
    emulated run, and each rank must have launched what the plan implies
    for one worker. Prints the last step's collectives replayed alone by
    operation with their payload bytes a rank, and the in-network
    group's tree replayed alone."""
    plan = mixed_plan(n_buckets)
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
          "spawn_shared_with": SPAWN_SHARED,
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

# deepseek at depth 1 (cut from 2 to keep the script inside its budget
# once dist_model took its mamba2 and qwen2.5-3b arms): the MoE layer's
# path is the same at any depth
MOE_ARCH, MOE_LAYERS, EP_WORKERS = "deepseek-moe-16b", 1, 2
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
        sk, w, _ = check.producer(xb, ids, cfg)
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
        sk, w, _ = check.producer(x, ids, cfg)
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
    """deepseek-moe-16b at full width (depth 28 -> 1, bf16), W=2 emulated,
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
        x1 = x0 + attn()[0]
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
    out["launches"] = codec_launches()
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


def phase_dist_a2a(outs, wall):
    """W=2 ranks sharing ``cuda:0`` over gloo (host-staged), as
    ``dist_train`` (``outs``: each rank's :func:`dist_a2a_rank` result, from
    the shared spawn, which took ``wall`` seconds): the dense and
    compressed exchanges standalone on one
    MoE layer's payload a rank, dyadic, fused and in 2 chunks. Fails
    unless every rank's merged lane equals the sources' sum bit for bit
    and the two wires agree, each rank launched one producer and one
    consumer a chunk a compressed run, and the bytes a rank sent equal
    ``strategy_wire_bytes``' ``dense_alltoall`` / ``compressed_alltoall``
    ``rank_payload_bytes`` to the byte. Returns the launches summed over
    the ranks."""
    from repro_torch.configs import get_arch

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
          "wall_s": wall, "spawn_shared_with": SPAWN_SHARED,
          "merged_equal_sum": True, "dense_equal_compressed": True,
          "rank_payload_bytes": want_bytes,
          "strategy_wire_bytes": {k: acct[k] for k in ("dense_alltoall",
                                                       "compressed_alltoall")},
          "runs_by_rank": [o["runs"] for o in outs],
          "lane_merge_ms_median_by_rank": [o["lane_merge_ms_median"] for o in outs],
          "lane_merge_payload_bytes": outs[0]["lane_merge_payload_bytes"],
          "launches_by_rank": [o["launches"] for o in outs]})
    return {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}

ELASTIC_COHORT, ELASTIC_ROUNDS, ELASTIC_SHARDS = 4, 3, 4
ELASTIC_OFFSET = 500_000       # a block range inside the elastic stream
ELASTIC_ARMS = (("f32", 1), ("f32", ELASTIC_SHARDS), ("fxp32", 1),
                ("fxp32", ELASTIC_SHARDS))


def elastic_cfg(wire="f32"):
    """The serve launcher's elastic codec (``repro_torch.launch.serve``):
    ratio 1, c 128, rows 6 (G 6, 768-element blocks), 10 rounds, exact
    top-k 10% with error feedback, 4 MiB buckets."""
    from repro_torch.core.config import CompressionConfig
    return CompressionConfig(ratio=1.0, lanes=128, rows=6, rounds=10,
                             chunk_blocks=8, topk_ratio=0.1, topk_exact=True,
                             error_feedback=True, wire_dtype=wire)


def elastic_blocks(n_params):
    cfg = elastic_cfg()
    return (cfg.num_buckets(n_params) * cfg.bucket_elems_for(n_params)
            // cfg.block_elems)


def phase_kernels_elastic(dev, check, n_params):
    """Rows 1, 2 and 4 at the elastic service's geometry (c 128, G 6,
    rows 6, rounds 10) against their plain versions on 2048 blocks at
    offset ids inside the 580,550-block stream: one client's payload at
    10% density into the producer, the sum of four clients' (W = 4, M = 28
    exponents from the producer's maxabs) into both consumers; dyadic at
    10% and 40% bit for bit, Gaussian at 10% to phase 3's tolerance, words
    and residual exactly, the dequant leg equal to ``decode`` + the f32
    kernel bit for bit. Then each kernel's time, its plain version's and
    its bound on the full stream (the producer on one client's 10%
    stream, the consumers on a 4-client aggregate's, 34.4% dense), with
    blocks an SM and shared-memory bytes, and the f32 consumer's per-block
    rounds histogram and its time with the rounds capped at 0, 1, 2 and
    ``cfg.rounds``. Before the times, each row is held against its plain
    version on the full stream too: the producer on one client's 10%
    stream and on the aggregate's, both consumers on the aggregate,
    dyadic bit for bit and Gaussian to phase 3's tolerance; each timed
    record carries the full stream's ``max_abs_err``. Returns the
    ``elastic`` entries of the three rows."""
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.core.peeling import peel_blocks
    from repro_torch.kernels import ops, ref
    from repro_torch.net.fixedpoint import FixedPointWire

    cfg = elastic_cfg()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2929)
    W = ELASTIC_COHORT
    group, wire = LocalWorkers(W), FixedPointWire(W)
    M, G, c, R = wire.mantissa_bits, cfg.group, cfg.lanes, cfg.rows
    nb = CHECK_BLOCKS
    ids = torch.arange(nb, dtype=torch.int32, device=dev) + ELASTIC_OFFSET
    for kind, frac in [("dyadic", 0.1), ("dyadic", 0.4), ("gauss", 0.1)]:
        exact = kind == "dyadic"
        xs = [make_blocks(cfg, nb, frac, kind, gen) for _ in range(W)]
        enc = [check.producer(x, ids, cfg) for x in xs]
        sk = group.sum([e[0] for e in enc])
        w = group.bor([e[1] for e in enc])
        _, res = check.consumer(sk, w, ids, cfg, exact)
        e = wire.exponents_from_maxabs(group.max([f[2] for f in enc]))
        q = group.sum([wire.encode(f[0].reshape(nb, -1), e).reshape(f[0].shape)
                       for f in enc])
        _, res_q = check.consumer_dq(q, w, ids, cfg, wire, e, exact)
        emit({"phase": "kernels_elastic", "case": f"{kind}@{frac}x{W}",
              "blocks": nb, "block_offset": ELASTIC_OFFSET,
              "geometry": {"ratio": cfg.ratio, "rows": R, "lanes": c, "group": G},
              "mantissa_bits": M, "agree": True,
              "nnz": int(index_lib.popcount(w)), "residual": int(res.sum()),
              "residual_dq": int(res_q.sum())})
        del xs, enc, sk, w, q
    # the full stream, the shape the main path gives each row: held
    # against the plain versions (dyadic bit for bit, Gaussian to phase
    # 3's tolerance, words and residual exactly), then timed
    nbf = elastic_blocks(n_params)
    fids = torch.arange(nbf, dtype=torch.int32, device=dev)
    full = Checker()
    for kind in ("dyadic", "gauss"):
        exact = kind == "dyadic"
        x = make_blocks(cfg, nbf, 0.1, kind, gen)
        full.producer(x, fids, cfg)
        if exact:
            del x
        xa = make_blocks(cfg, nbf, 1 - 0.9 ** W, kind, gen)
        ska, wa, mxa = full.producer(xa, fids, cfg)
        del xa
        ea = wire.exponents_from_maxabs(mxa)
        qa = wire.encode(ska.reshape(nbf, -1), ea).reshape(ska.shape)
        full.consumer(ska, wa, fids, cfg, exact)
        full.consumer_dq(qa, wa, fids, cfg, wire, ea, exact)
        emit({"phase": "kernels_elastic", "case": f"full {kind}", "blocks": nbf,
              "agree": True, "max_abs_err": {
                  k: full.err[k] for k in ("encode_pack_quantize",
                                           "dequant_peel_unpack",
                                           "dequant_peel_unpack_dq")}})
        if exact:
            del ska, wa, mxa, qa
            torch.cuda.empty_cache()
    for k, v in full.err.items():
        check.err[k] = max(check.err[k], v)
    nnz_in = int((x != 0).sum())
    nnz = int(index_lib.popcount(wa))
    bits = index_lib.unpack_bits(wa.reshape(-1), (nbf, G, c))
    rounds = peel_blocks(ska, bits, fids, cfg).rounds_used
    del bits
    n_res = int(ops.dequant_peel_unpack(ska, wa, fids, cfg)[1].sum())
    # where the f32 consumer's time goes: each block's rounds to its
    # fixpoint, and its time with the rounds capped
    from repro_torch.kernels.sketch_wire import dequant_peel_unpack_cuda
    hist = block_rounds(lambda r: dequant_peel_unpack_cuda(
        ska, wa, fids, cfg, block_rounds=r), nbf, dev, rounds)
    by_rounds = ms_by_rounds(lambda k: ops.dequant_peel_unpack(ska, wa, fids, k),
                             cfg, (0, 1, 2, cfg.rounds))
    eb, eo, db, do = codec_bytes_ops(nbf, cfg, nnz_in, nnz, n_res, rounds)
    # the dequant leg also reads the (nb,) exponents and scales each cell
    dqb, dqo = db + nbf * 4, do + 2 * nbf * R * c
    out = {}
    for name, kfn, pfn, nbytes, nops, pit in [
        ("encode_pack_quantize", lambda: ops.encode_pack_quantize(x, fids, cfg),
         lambda: ref.encode_pack_quantize_ref(x, fids, cfg), eb, eo, 5),
        ("dequant_peel_unpack", lambda: ops.dequant_peel_unpack(ska, wa, fids, cfg),
         lambda: ref.dequant_peel_unpack_ref(ska, wa, fids, cfg), db, do, 3),
        ("dequant_peel_unpack_dq",
         lambda: ops.dequant_peel_unpack(qa, wa, fids, cfg, exponents=ea,
                                         mantissa_bits=M),
         lambda: ref.dequant_peel_unpack_ref(qa, wa, fids, cfg, exponents=ea,
                                             mantissa_bits=M), dqb, dqo, 3)]:
        b_ms, b_by = bound(nbytes, nops)
        blocks, smem = ops.kernel_occupancy(name, cfg, dev)
        out[name] = {"geometry": {"ratio": cfg.ratio, "rows": R, "lanes": c,
                                  "group": G},
                     "blocks": nbf, "ms": cuda_ms(kfn, 10),
                     "plain_ms": cuda_ms(pfn, pit, warmup=1), "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "ops": nops,
                     "blocks_per_sm": blocks,
                     "threads_per_block": ops.kernel_threads(name, cfg),
                     "smem_bytes": smem, "max_abs_err": full.err[name],
                     "input_density": (
                         0.1 if name == "encode_pack_quantize" else nnz / x.numel()),
                     "plain_rounds_to_fixpoint": rounds}
    emit({"phase": "kernels_elastic", "timed": out, "aggregate_nnz": nnz,
          "estimated": n_res, "consumer_block_rounds_hist": hist,
          "consumer_ms_by_rounds_cap": by_rounds})
    del x, ska, wa, mxa, qa
    torch.cuda.empty_cache()
    return out


class ConsumerTimer:
    """CUDA-event times of every consumer call (``ops.dequant_peel_unpack``,
    both legs) made while it is entered, in call order: ``ms(a, b)`` sums
    calls ``a`` to ``b``, a round's close's share of the kernel. It wraps
    the op while entered, and nothing else; leaving restores it."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.events, self.orig = [], ops.dequant_peel_unpack

        def timed(*a, **k):
            import torch
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.orig(*a, **k)
            ev[1].record()
            self.events.append(ev)
            return out
        ops.dequant_peel_unpack = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.dequant_peel_unpack = self.orig

    def ms(self, a, b):
        import torch
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[a:b])


def plain_close(srv, chunk_buckets=32):
    """The open round's close recomputed from its folded state with the
    plain versions (``use_pallas="never"``), a run of buckets at a time at
    its global block offset; for an unsharded round without a carried
    residual."""
    import torch
    from repro_torch.core.compressor import CompressedLeaf, HomomorphicCompressor
    eng, st = srv.pending_state()
    comp = HomomorphicCompressor(dataclasses.replace(eng.cfg, use_pallas="never"))
    nbk, E, bpb = eng.contract.n_buckets, eng.contract.bucket_elems, \
        eng.blocks_per_bucket
    out = torch.empty((nbk, E), dtype=torch.float32, device=st.sketch.device)
    for b0 in range(0, nbk, chunk_buckets):
        b1 = min(b0 + chunk_buckets, nbk)
        dq = None
        if eng.fxp32:
            dq = (st.exponents[b0:b1].repeat_interleave(bpb),
                  eng.contract.mantissa_bits)
        out[b0:b1] = comp.recover(
            CompressedLeaf(sketch=st.sketch[b0 * bpb:b1 * bpb],
                           index_words=st.index_words[b0:b1].reshape(-1)),
            (b1 - b0) * E, block_offset=b0 * bpb, dequant=dq).reshape(b1 - b0, E)
    return out


def check_int64_fold(srv, payloads, chunk_blocks=1 << 16):
    """The fxp32 round's folded int32 sketch (each shard's, flushed) against
    an independent int64 sum of the folded clients' quantized payloads."""
    import torch
    eng, st = srv.pending_state()
    if hasattr(eng, "engines"):
        parts = list(zip(eng.engines, st.shard_states))
    else:
        parts = [(eng, st)]
    folded = sorted(st.clients)
    for e, s in parts:
        for a in range(0, e.n_blocks, chunk_blocks):
            b = min(a + chunk_blocks, e.n_blocks)
            g0, g1 = e.block_offset + a, e.block_offset + b
            want = torch.zeros(s.sketch[a:b].shape, dtype=torch.int64,
                               device=s.sketch.device)
            for cl in folded:
                want += payloads[cl].sketch[g0:g1]
            if not torch.equal(s.sketch[a:b].to(torch.int64), want):
                raise AssertionError(f"elastic: folded int32 sketch != int64 sum "
                                     f"of the payloads at blocks {g0}..{g1}")
    return len(folded)


class ElasticHooks:
    """``run_elastic``'s hooks for one arm of ``phase_elastic``: round 0's
    gradients dyadic (from a seeded generator on the card); round 0's
    close held against the plain versions on the same folded state
    (unsharded arms); a round-0 payload submitted in round 1 must be
    refused as stale; on fxp32 the folded int32 sketch against an
    independent int64 sum; each round's launches of rows 1, 2 and 4
    against the expected counts; the consumer's share of the close (from
    ``timer``, a :class:`ConsumerTimer` entered around the run); each
    round's stream kept for the sharded arm to be held against. It
    implements all of ``repro_torch.launch.serve.RoundHooks``."""

    def __init__(self, dev, wire, n_shards, timer, ref_streams=None):
        import torch
        from repro_torch.kernels import ops
        self.dev, self.wire, self.n_shards = dev, wire, n_shards
        self.ref_streams, self.streams, self.rounds = ref_streams, [], []
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(3030)
        self.mark = codec_launches()
        self.stale, self.plain, self.timer, self.first = None, None, timer, 0

    def grads(self, rnd, client, shapes):
        import torch
        from repro_torch.models.params import unflatten_tree
        if rnd != 0:
            return None
        g, out = self.gen, []
        for path, sh in shapes:
            keep = torch.rand(sh, generator=g, device=self.dev) < 1 / 3
            sign = torch.where(torch.rand(sh, generator=g, device=self.dev) < 0.5,
                               -1.0, 1.0)
            e = torch.randint(-2, 3, sh, generator=g, device=self.dev)
            out.append((path, torch.where(keep, sign * torch.exp2(e.float()), 0.0)))
        return unflatten_tree(out)

    def before_close(self, rnd, srv, contract, payloads):
        from repro_torch.elastic import StaleContractError
        rec = {"round": rnd, "plain_checked": False, "int64_checked": 0}
        if rnd == 0:
            self.stale = payloads[1]
            if self.n_shards == 1:
                self.plain = plain_close(srv)
                rec["plain_checked"] = True
        elif rnd == 1:
            try:
                srv.submit(self.stale)
            except StaleContractError:
                rec["stale_refused"] = True
            else:
                raise AssertionError("elastic: a stale payload was folded")
            self.stale = None
        if self.wire == "fxp32":
            rec["int64_checked"] = check_int64_fold(srv, payloads)
        self.rounds.append(rec)
        self.first = len(self.timer.events)

    def after_close(self, rnd, srv, stream, rep):
        import torch
        from repro_torch.kernels import ops
        rec = self.rounds[-1]
        last = len(self.timer.events)
        rec["consumer_ms"] = self.timer.ms(self.first, last)
        rec["consumer_calls"] = last - self.first
        if self.plain is not None:
            if not torch.equal(stream, self.plain):
                raise AssertionError(f"elastic {self.wire}: the kernel close "
                                     "differs from the plain close")
            self.plain = None
        now = codec_launches()
        got = {k: now[k] - self.mark[k] for k in now}
        self.mark = now
        cons = "dequant_peel_unpack_dq" if self.wire == "fxp32" \
            else "dequant_peel_unpack"
        want = dict.fromkeys(now, 0)
        want["encode_pack_quantize"] = rep.workers
        want[cons] = (1 + rep.deferred) * self.n_shards
        if got != want:
            raise AssertionError(f"elastic {self.wire}/{self.n_shards}: round "
                                 f"{rnd} launches {got}, expected {want}")
        rec["launches"] = {k: v for k, v in got.items() if v}
        if self.ref_streams is not None:
            rec["equal_to_unsharded"] = torch.equal(stream, self.ref_streams[rnd])
            if not rec["equal_to_unsharded"]:
                raise AssertionError(f"elastic {self.wire}: sharded round {rnd} "
                                     "differs from the unsharded close")
        else:
            self.streams.append(stream)
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()


def phase_elastic(dev, n_params):
    """The serve launcher's ``run_elastic`` on the card: granite-3-2b at
    full width (depth 40 -> 4) as the gradient template, cohort 4 with a
    client joining at round 1, 3 rounds, ``--straggle`` (client 0 past the
    deadline in round 1, deferred into round 2's residual); the f32 and
    fxp32 wires, each unsharded (n_shards 1, batch 1) and then sharded
    (n_shards 4, batch 4), the hooks of :class:`ElasticHooks` checking
    every round. Fails unless every round accounts for every payload
    (folded + deferred, 0 lost), the fxp32 budget re-prices 28 -> 27 at
    W = 5, each sharded close equals the unsharded one bit for bit, and
    the launches are W producers a round and a consumer a shard for the
    close and for each deferred payload. Returns the launches by arm."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_parser, run_elastic
    from repro_torch.models.registry import model_api

    mcfg = dataclasses.replace(get_arch("granite-3-2b").model, n_layers=LAYERS)
    params = model_api(mcfg).init(0, dev)
    if sum(p.numel() for p in params.leaves()) != n_params:
        raise AssertionError("elastic: the template is not the train phases'")
    launches, ref_streams = {}, None
    for wire, shards in ELASTIC_ARMS:
        arm = f"{wire}/shards{shards}"
        args = build_parser().parse_args([
            "--arch", "granite-3-2b", "--layers", str(LAYERS), "--elastic",
            "--cohort", str(ELASTIC_COHORT), "--rounds", str(ELASTIC_ROUNDS),
            "--wire", wire, "--straggle", "--shards", str(shards),
            "--device", str(dev)])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        with ConsumerTimer() as timer:
            hooks = ElasticHooks(dev, wire, shards, timer,
                                 ref_streams if shards > 1 else None)
            srv, records = run_elastic(args, mcfg, params, hooks=hooks)
        wall = time.perf_counter() - t0
        launches[arm] = codec_launches()
        ms = [r["mantissa_bits"] for r in records]
        if wire == "fxp32" and ms != [28, 27, 27]:
            raise AssertionError(f"elastic: mantissa budgets {ms}, expected "
                                 "[28, 27, 27]")
        for r in records:
            if r["folded"] + r["deferred"] != r["workers"]:
                raise AssertionError(f"elastic {arm}: round {r['round']} lost "
                                     "a payload")
        if [(r["deferred"], r["rejected_stale"], r["residual_carried_in"])
                for r in records] != [(0, 0, False), (1, 1, False), (0, 0, True)]:
            raise AssertionError(f"elastic {arm}: deferrals, stale refusals and "
                                 "carried residuals are not as scheduled")
        for r, h in zip(records, hooks.rounds):
            r.update(h)
            folded = r["folded"]
            emit({"phase": "elastic", "arm": arm, **{
                k: v for k, v in r.items() if k != "propose_ms"},
                "propose_ms_median": statistics.median(r["propose_ms"]),
                "propose_ms": r["propose_ms"],
                "fold_ms_per_payload": r["fold_ms"] / folded})
        emit({"phase": "elastic", "arm": arm, "arch": "granite-3-2b",
              "params": n_params, "reduced": {"n_layers": f"40 -> {LAYERS}"},
              "buckets": srv.plan.n_buckets, "bucket_elems": srv.plan.bucket_elems,
              "blocks": elastic_blocks(n_params), "wall_s": wall,
              "payloads_accounted": sum(r["folded"] + r["deferred"]
                                        for r in records), "lost": 0,
              "launches": {k: v for k, v in launches[arm].items() if v},
              "peak_mem_bytes": torch.cuda.max_memory_allocated()})
        ref_streams = hooks.streams if shards == 1 else None
        del srv, records, hooks
    del params, ref_streams
    torch.cuda.empty_cache()
    return launches


REMAT_ARMS = ("none", "dots")    # phase 31's policies beside the block default
CKPT_EVERY, CKPT_FAIL_AT = 2, 3  # ckpt_train: checkpoints at 2 and 4, a failure at 3


def phase_remat(dev, train, moe_line):
    """granite-3-2b as phase 4 (whose train runs the ``block`` default)
    under each of ``REMAT_ARMS``, and deepseek-moe-16b as
    ``moe_train/compressed`` (``block``) under ``none``: after every step
    the parameter sha256 must equal the ``block`` run's, and the launches
    (the DP aggregator's rows 1 and 2, and on the MoE path the exchange's
    2 + 4 producers and 1 + 4 consumers a step) the same counts, which
    ``phase_train`` holds. Per policy the peak memory and step ms beside
    ``block``'s."""
    import torch
    t0 = time.perf_counter()
    arms = {"granite/block": train}
    runs = [(f"granite/{r}", {"remat": r}, {}) for r in REMAT_ARMS]
    runs.append(("deepseek/none", {"remat": "none", "ep_exchange": "compressed",
                                   "ep_workers": EP_WORKERS},
                 {"arch_name": MOE_ARCH, "layers": MOE_LAYERS,
                  "want": moe_want("compressed")}))
    arms["deepseek/block"] = moe_line
    launches = {}
    for name, tc_fields, kw in runs:
        torch.cuda.empty_cache()
        line, launches[name], _, _, state = phase_train(
            dev, phase=f"remat/{name}", tc_fields=tc_fields, emit_line=False,
            **kw)
        del state
        arms[name] = line
    out = {"phase": "remat", "wall_s": time.perf_counter() - t0, "arms": {}}
    for name, line in arms.items():
        model = name.split("/")[0]
        block = arms[f"{model}/block"]
        out["arms"][name] = {
            "peak_mem_bytes": line["peak_mem_bytes"], "step_ms": line["step_ms"],
            "mean_step_ms": statistics.mean(line["step_ms"]),
            "launches": line["launches"],
            "digests_equal_block": line["param_sha256_by_step"]
            == block["param_sha256_by_step"],
            "losses_equal_block": line["losses"] == block["losses"]}
    emit(out)
    for name, arm in out["arms"].items():
        if not (arm["digests_equal_block"] and arm["losses_equal_block"]):
            raise AssertionError(f"remat/{name}: parameters or losses differ "
                                 "from the block run's")
    return launches


def disk_room(path, need):
    """Raise unless the file system of ``path`` has ``need`` bytes free."""
    import shutil
    free = shutil.disk_usage(path).free
    if free < need:
        raise RuntimeError(f"{free} bytes free under {path}, {need} needed")
    return free


def ckpt_tc():
    """The train config of the checkpoint phases: phase 4's."""
    from repro_torch.configs import get_arch
    arch = get_arch("granite-3-2b")
    return dataclasses.replace(arch.train, workers=WORKERS, accum_steps=1)


def ckpt_bytes(n_params):
    """A granite checkpoint's nominal size: 18 B a parameter (bf16 2,
    AdamW's f32 moments 8, both workers' f32 residual rows 8)."""
    return n_params * 18


def phase_ckpt_train(dev, train):
    """``run_training`` of phase 4's setup with a checkpoint every
    ``CKPT_EVERY`` steps into a temporary directory under ``build/``
    (free space for two checkpoints checked first) and a failure
    injected at step ``CKPT_FAIL_AT``: one restart, five losses (step 2
    run again after the step-2 checkpoint is restored, its loss equal to
    its first pass bit for bit, the others equal to phase 4's), the final
    parameter sha256 equal to phase 4's, W producers and one consumer a
    step executed. The checkpoints' bytes, each save's blocking host copy
    and background write, and the restore's time."""
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.ft.failures import FailureSimulator
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training

    arch = get_arch("granite-3-2b")
    api = model_api(dataclasses.replace(arch.model, n_layers=LAYERS))
    tc = ckpt_tc()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    nominal = ckpt_bytes(train["params"])
    free = disk_room(build, 2 * nominal + (1 << 30))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=build) as d:
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        res = run_training(api, tc, global_batch=BATCH, seq_len=SEQ,
                           steps=STEPS, device=dev, ckpt_dir=d,
                           ckpt_every=CKPT_EVERY, log_every=0,
                           failure_sim=FailureSimulator(
                               fail_at_steps=(CKPT_FAIL_AT,)))
        wall = time.perf_counter() - t0
        launches = codec_launches()
        digest = param_digest(res.state.params)
        res.state = None
    executed = len(res.losses)
    want = {**dict.fromkeys(launches, 0),
            "encode_pack_quantize": WORKERS * executed,
            "dequant_peel_unpack": executed}
    saves = [e for e in res.ckpt_events if e["kind"] == "save"]
    restores = [e for e in res.ckpt_events if e["kind"] == "restore"]
    replay = CKPT_FAIL_AT - CKPT_FAIL_AT % CKPT_EVERY
    out = {"phase": "ckpt_train", "arch": "granite-3-2b",
           "reduced": {"n_layers": f"{arch.model.n_layers} -> {LAYERS}"},
           "workers": WORKERS, "steps": STEPS, "ckpt_every": CKPT_EVERY,
           "fail_at": CKPT_FAIL_AT, "restarts": res.restarts,
           "final_step": res.final_step, "losses": res.losses,
           "replayed_loss_equal": res.losses[replay + 1] == res.losses[replay],
           "losses_equal_train": res.losses[:replay + 1] + res.losses[replay + 2:]
           == train["losses"],
           "final_param_sha256": digest,
           "digest_equal_train": digest == train["param_sha256_by_step"][-1],
           "launches": launches, "wall_s": wall,
           "step_ms": [t * 1e3 for t in res.step_seconds],
           "nominal_ckpt_bytes": nominal, "disk_free_bytes": free,
           "views": [e for e in res.ckpt_events if e["kind"] == "view"],
           "saves": saves, "restores": restores,
           "straggler_events": res.straggler_events,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    if launches != want:
        raise AssertionError(f"ckpt_train: launch counts {launches}, "
                             f"expected {want}")
    if not (res.restarts == 1 and executed == STEPS + 1
            and out["replayed_loss_equal"] and out["losses_equal_train"]
            and out["digest_equal_train"] and len(restores) == 1
            and [e["step"] for e in saves] == [2, 4]):
        raise AssertionError("ckpt_train: the restored run differs from "
                             "phase 4's uninterrupted one")
    return launches


def dist_ckpt_rank(group, dev, ckpt_dir):
    """One rank of ``dist_ckpt``: phase 4's train for 2 steps with a
    checkpoint at step 2 (the gathers on every rank, the files from rank
    0), its launches and the gathers' time (the loop's ``view`` event:
    host clock; gloo's staging copies wait for the card)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch("granite-3-2b")
    api = model_api(dataclasses.replace(arch.model, n_layers=LAYERS))
    tc = ckpt_tc()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    res = run_training(api, tc, global_batch=BATCH, seq_len=SEQ, steps=2,
                       device=dev, ckpt_dir=ckpt_dir, ckpt_every=2,
                       log_every=0, group=group)
    launches = codec_launches()
    gather_ms = [e["ms"] for e in res.ckpt_events if e["kind"] == "view"]
    return {"rank": group.rank, "backend": group.backend,
            "staging": group.staging, "losses": res.losses,
            "launches": launches, "gather_ms": gather_ms,
            "digest": param_digest(res.state.params),
            "ckpt_events": res.ckpt_events,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def phase_dist_ckpt(dev, train, outs, d, wall):
    """W=2 ranks sharing ``cuda:0`` over gloo (as ``dist_train``) train
    phase 4's setup for 2 steps and checkpoint into ``d`` (``outs``:
    each rank's :func:`dist_ckpt_rank` result, from the spawn the
    ``dist_*`` phases share, which took ``wall`` seconds);
    ``LocalWorkers`` then restores the checkpoint and trains steps 2-3,
    and ``d`` is removed. The ranks' losses must equal phase 4's first
    two, each rank launch one producer and one consumer a step, and the
    restored run's final parameter sha256 equal phase 4's. The gathers'
    time over gloo, the save and the restore."""
    import shutil
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import model_api
    from repro_torch.train.loop import run_training

    t_phase = time.perf_counter()
    arch = get_arch("granite-3-2b")
    api = model_api(dataclasses.replace(arch.model, n_layers=LAYERS))
    try:
        torch.cuda.empty_cache()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        res = run_training(api, ckpt_tc(), global_batch=BATCH, seq_len=SEQ,
                           steps=STEPS, device=dev, ckpt_dir=d,
                           ckpt_every=STEPS + 1, log_every=0)
        launches = codec_launches()
        digest = param_digest(res.state.params)
        res.state = None
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rank_want = {**dict.fromkeys(outs[0]["launches"], 0),
                 "encode_pack_quantize": 2, "dequant_peel_unpack": 2}
    want = {**dict.fromkeys(launches, 0),
            "encode_pack_quantize": WORKERS * 2, "dequant_peel_unpack": 2}
    out = {"phase": "dist_ckpt", "workers": WORKERS,
           "backend": outs[0]["backend"], "staging": outs[0]["staging"],
           "wall_s": time.perf_counter() - t_phase,
           "ranks_wall_s": wall, "spawn_shared_with": SPAWN_SHARED,
           "ranks": [{k: o[k] for k in ("rank", "losses", "launches",
                                        "gather_ms", "ckpt_events",
                                        "peak_mem_bytes")} for o in outs],
           "restored": {"losses": res.losses, "launches": launches,
                        "ckpt_events": res.ckpt_events,
                        "step_ms": [t * 1e3 for t in res.step_seconds]},
           "final_param_sha256": digest,
           "digest_equal_train": digest == train["param_sha256_by_step"][-1]}
    emit(out)
    for o in outs:
        if o["launches"] != rank_want or o["losses"] != train["losses"][:2] \
                or o["digest"] != train["param_sha256_by_step"][1]:
            raise AssertionError(f"dist_ckpt: rank {o['rank']} differs from "
                                 "phase 4's first two steps")
    if launches != want or res.losses != train["losses"][2:] \
            or not out["digest_equal_train"]:
        raise AssertionError("dist_ckpt: the restored run differs from "
                             "phase 4's uninterrupted one")
    summed = {k: sum(o["launches"][k] for o in outs) for k in rank_want}
    return {"ranks": summed, "restored": launches}


SERVE_BATCH, SERVE_PROMPT = 8, 512      # batch generate: 8 prompts of 512
SERVE_NEW = {"granite-3-2b": 64, "deepseek-moe-16b": 32, "mamba2-1.3b": 64,
             "jamba-v0.1-52b": 64, "whisper-tiny": 64}
SERVE_REQUESTS = 16                     # continuous: 2 x batch requests
CONSISTENCY_LAYERS, CONSISTENCY_B, CONSISTENCY_S = 4, 2, 64


def zero_launches():
    from repro_torch.kernels import ops
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0


def codec_launches():
    """The codec kernels' launch counters (``LAUNCHES`` without the
    optimizer's ``adam_update``, which :func:`phase_train` checks on its
    own)."""
    from repro_torch.kernels.cuda_common import CODEC_KERNELS, LAUNCHES
    return {k: LAUNCHES[k] for k in CODEC_KERNELS}


def read_launches(phase):
    """The launch counters after a serving run: serving runs none of the
    six kernels, so any launch fails the phase."""
    from repro_torch.kernels import ops
    launches = dict(ops.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"{phase}: serving launched a codec kernel "
                             f"{launches}")
    return launches


def tokens_digest(rows):
    """sha256 of generated tokens: each row (a completion's uid, then its
    tokens) as int32 bytes, in order."""
    import numpy as np
    h = hashlib.sha256()
    for r in rows:
        h.update(np.asarray(r, dtype=np.int32).tobytes())
    return h.hexdigest()


class ServeClock:
    """Times a ``ServeEngine``'s own loop: while it is entered, the engine
    holds a ``ModelAPI`` whose ``prefill`` and ``decode`` record a CUDA
    event before and after the model's call and, with ``keep``, a copy of
    the input tokens and the logits (as f32) that the call returns. Every
    ``generate`` or batcher run in between goes through the engine's own
    code; the engine's api comes back on exit."""

    def __init__(self, eng, keep=False):
        self.eng, self.keep, self.api = eng, keep, eng.api
        self.calls = []     # {"kind", "pos", "start", "end", "tok", "logits"}

    def _wrap(self, kind, fn):
        import torch

        def call(tree, x, *rest):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            logits, cache = fn(tree, x, *rest)
            end.record()
            rec = {"kind": kind, "start": start, "end": end,
                   "pos": rest[-1] if kind == "decode" else None}
            if self.keep:
                rec["tok"] = (x["tokens"] if kind == "prefill" else x).clone()
                rec["logits"] = logits.float()
            self.calls.append(rec)
            return logits, cache
        return call

    def __enter__(self):
        self.eng.api = dataclasses.replace(
            self.api, prefill=self._wrap("prefill", self.api.prefill),
            decode=self._wrap("decode", self.api.decode))
        return self

    def __exit__(self, *exc):
        self.eng.api = self.api

    def of(self, kind):
        return [c for c in self.calls if c["kind"] == kind]

    def prefill_ms(self):
        import torch
        torch.cuda.synchronize()
        return [c["start"].elapsed_time(c["end"]) for c in self.of("prefill")]

    def step_ms(self):
        """A decode step as the engine's loop runs it: from one decode
        call's start to the next's (the argmax and the host's work in
        between included)."""
        import torch
        torch.cuda.synchronize()
        d = self.of("decode")
        return [a["start"].elapsed_time(b["start"]) for a, b in zip(d, d[1:])]


def logits_err(a, b, vocab):
    """max |a - b| over the real vocabulary (the padded entries are -1e30
    on both sides)."""
    return float((a[..., :vocab].float() - b[..., :vocab].float()).abs().max())


def logits_max_abs(logits, vocab):
    return float(logits[..., :vocab].float().abs().max())


def device_busy(fn):
    """``fn()`` under ``torch.profiler`` -> (device busy us: the sum of the
    card's kernels' and copies' durations, kernels launched, us by kernel
    name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, busy_us, kernels = {}, 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        kernels += not e.name.startswith(("Memcpy", "Memset"))
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + us
    return busy_us, kernels, by_name


def profile_decode(eng, prompts, steps=4, extra=None):
    """The card's work in ``steps`` decode steps of the engine's own
    ``generate``: two profiled runs, of 1 + ``steps`` new tokens and of 1,
    and their difference, so that the prefill cancels. -> the card's busy
    time a step, the kernels launched a step, and the kernels taking the
    most device time, by name. The trace's wall time is inflated by the
    profiler, so the idle share is taken against the unprofiled step."""
    long_us, long_k, long_by = device_busy(
        lambda: eng.generate(prompts, max_new=1 + steps, extra=extra))
    short_us, short_k, short_by = device_busy(
        lambda: eng.generate(prompts, max_new=1, extra=extra))
    by_name = {k: v - short_by.get(k, 0.0) for k, v in long_by.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps,
            "device_busy_ms_per_step": (long_us - short_us) / steps / 1e3,
            "kernels_per_step": (long_k - short_k) / steps,
            "top_kernels_ms_per_step": [[k, v / steps / 1e3] for k, v in top]}


# Logit bounds of the serve phases' checks in bf16 at full depth (phases
# 34-35). Read on an H100 80GB HBM3 at 700 W, the same in two runs, with
# the logits' max |logit| over the vocabulary 2.5-2.9: decode vs prefill
# 0.031 (granite) and 0.100 (deepseek); the first wave 0.0; the second
# wave 0.035. Each bound is 2.5x or more above its reading and a tenth
# or less of the logits' max, the order of the error that a wrong slot
# or position gives.
ATTN_LOGITS_ATOL = {
    # decode of the prompt's last 3 tokens vs the prefill of all of them
    "consistency": 0.25,
    # the batcher's slots vs generate's rows (first wave, B = 8 both),
    # and vs a batch-1 engine fed the slot's tokens (second wave)
    "batcher_vs_generate": 0.125,
    "batcher_vs_batch1": 0.125,
}
# Phases 39-40 (mamba2-1.3b, read whole, now at depth 24; jamba-v0.1-52b
# one superblock): the same checks. The decode recurrence and the
# prefill's chunked scan sum the state in different orders in f32, and
# each layer's output rounds to bf16 before the next. Read on an H100 80GB
# HBM3 at 700 W, the same in two runs, with the logits' max |logit|
# 2.8-3.6: mamba2 decode vs prefill 0.088, the first wave 0.0, the second
# wave 0.072; jamba decode vs prefill 0.176 (its MoE layers at E / K, no
# token dropped). Each bound is 2.8x or more above its reading and a sixth
# or less of the logits' max.
SSM_LOGITS_ATOL = {"consistency": 0.25, "batcher_vs_generate": 0.125,
                   "batcher_vs_batch1": 0.25}
HYBRID_LOGITS_ATOL = {"consistency": 0.5}
# Phase 42 (whisper-tiny whole): decode against prefill in f32 at the
# reference's own bound (``tests/test_decode_consistency.py``), and
# generate's row 0 in bf16 against a batch-1 engine fed its prompt, frames
# and tokens over the prefill and 64 decode steps. Read on an H100 80GB
# HBM3 at 700 W with the logits' max |logit| 2.50: decode vs prefill
# 1.5e-6, batch-1 0.0156; the bound is 4x the reading and a fortieth of
# the logits' max.
ENCDEC_LOGITS_ATOL = {"consistency_f32": 2e-3, "generate_vs_batch1": 0.0625}
SERVE_LOGITS_ATOL = {"granite-3-2b": ATTN_LOGITS_ATOL,
                     "deepseek-moe-16b": ATTN_LOGITS_ATOL,
                     "mamba2-1.3b": SSM_LOGITS_ATOL,
                     "jamba-v0.1-52b": HYBRID_LOGITS_ATOL,
                     "whisper-tiny": ENCDEC_LOGITS_ATOL}


def no_drop(cfg):
    """``cfg`` with both MoE capacity factors E / K, so that no token
    drops in prefill or decode (a dense config as it is)."""
    if cfg.moe is None:
        return cfg
    cf = cfg.moe.num_experts / cfg.moe.top_k
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf, capacity_factor_decode=cf))


def decode_prefill_err(api, params, prompts, max_len, extra=None, start=None):
    """The reference's prefill/decode consistency check
    (``tests/test_decode_consistency.py``) in the model's own dtype, held
    at every decode step: prefill ``prompts[:, :start]`` (all but the
    last 3 prompt tokens by default), decode the rest one token at a
    time, and each step's logits against the last-position logits of a
    prefill of the prompt up to that token (every prefill given
    ``extra``, the encdec family's frames) -> the error at each step,
    the largest, and the logits' largest magnitude."""
    import torch
    from repro_torch.serve import ServeEngine
    B, S = prompts.shape
    start = S - 3 if start is None else start
    eng = ServeEngine(api, params, max_len=max_len, batch=B)
    _, cache = eng.prefill(prompts[:, :start], extra)
    errs, top, V = [], 0.0, api.cfg.vocab
    for p in range(start, S):
        tok = torch.as_tensor(prompts[:, p], device=eng.device).long()
        logits_d, cache = eng.decode(tok, cache, p)
        logits_p, _ = eng.prefill(prompts[:, :p + 1], extra)
        errs.append(logits_err(logits_d, logits_p, V))
        top = max(top, logits_max_abs(logits_p, V))
        del logits_p
        torch.cuda.empty_cache()
    return {"rows": B, "prompt_len": start, "decoded": S - start,
            "max_abs_err_by_step": errs, "max_abs_err": max(errs),
            "logits_max_abs": top}


def batcher_checks(eng, one, prompts, gen_clock, cont_clock, done, max_new):
    """The continuous run held to ``generate`` by logits, not tokens alone.

    First wave (uids 0..B-1, slot u, the prompts ``generate`` took, the
    same position): each decode call's inputs and logits against
    ``generate``'s for the same rows. Second wave (uid B + i in slot i,
    admitted when the whole first wave ends together): for slots 0 and
    B - 1, the slot's logits at each step against a batch-1 engine fed
    the same prompt and the slot's own tokens at the positions the shared
    position gives (the first wave's end, S + max_new, on), which run
    past ``max_len``."""
    import torch
    B, V = eng.batch, eng.api.cfg.vocab
    gen, cont = gen_clock.of("decode"), cont_clock.of("decode")
    by_uid = {c.uid: c.tokens for c in done}
    first_tok = all(torch.equal(g["tok"], c["tok"])
                    for g, c in zip(gen, cont[:max_new]))
    first = max(logits_err(g["logits"], c["logits"], V)
                for g, c in zip(gen, cont[:max_new]))
    second, positions = 0.0, [c["pos"] for c in cont[max_new:]]
    start = max(prompts.shape[1] + max_new, prompts.shape[1])
    for slot in (0, B - 1):
        toks = by_uid[B + slot]
        if [int(c["tok"][slot]) for c in cont[max_new:]] != toks:
            raise AssertionError(f"serve: slot {slot} of the second wave "
                                 f"does not hold uid {B + slot}")
        _, cache = one.prefill(prompts[slot][None])
        for k, c in enumerate(cont[max_new:]):
            logits, cache = one.decode(
                torch.tensor([toks[k]], device=one.device), cache, start + k)
            second = max(second, logits_err(logits[0], c["logits"][slot], V))
    return {"first_wave_tokens_equal": first_tok,
            "first_wave_max_abs_err": first,
            "second_wave_max_abs_err": second,
            "second_wave_positions": [positions[0], positions[-1]],
            "second_wave_positions_want": [start, start + len(positions) - 1],
            "logits_max_abs": max(logits_max_abs(c["logits"], V)
                                  for c in cont)}


def batch1_err(one, prompts, extra, clock):
    """``generate``'s row 0 (``clock``: its calls, logits kept) against
    the batch-1 engine ``one`` fed row 0's prompt, its ``extra`` rows and
    row 0's tokens at the same positions: the largest |logit difference|
    over the prefill and every decode step."""
    V = one.api.cfg.vocab
    logits, cache = one.prefill(prompts[:1],
                                {k: v[:1] for k, v in (extra or {}).items()})
    err = logits_err(logits[0], clock.of("prefill")[0]["logits"][0], V)
    decodes = clock.of("decode")
    for c in decodes:
        logits, cache = one.decode(c["tok"][:1], cache, c["pos"])
        err = max(err, logits_err(logits[0], c["logits"][0], V))
    return {"steps": len(decodes), "max_abs_err": err}


def cache_bytes(api, params, batch, max_len):
    """Bytes of the decode cache at ``batch`` x ``max_len``: K/V, and the
    Mamba layers' f32 states (read and written whole a step)."""
    from repro_torch.models.params import flatten_tree
    cache = api.init_cache(params.tree(), batch, max_len)
    n = sum(t.numel() * t.element_size() for _, t in flatten_tree(cache))
    del cache
    return n


def serve_model(dev, arch_name, phase, continuous, layers=None,
                prompt_len=SERVE_PROMPT, max_len=None):
    """Phases 34-35, 39-40 and 42: ``arch_name`` at full width and full
    depth (``layers`` cuts it), bf16, random weights from seed 0, served
    through ``ServeEngine.generate`` (and with ``continuous`` the
    ``ContinuousBatcher``) on ``SERVE_BATCH`` prompts of ``prompt_len``
    tokens, in caches of ``max_len`` positions (default ``prompt_len +
    max_new + 8``), the launch counters zeroed just before and read just
    after; then, not counted, generate again (timed, keeping its logits),
    the logit checks (bounds ``SERVE_LOGITS_ATOL`` by arch), the profiled
    decode and the batch-1 check. For the encdec family the frames come
    from the prompts' generator after them and go to ``generate`` as
    ``extra``; its decode/prefill check runs in f32 (the same draws from
    seed 0, not rounded to bf16) and generate's row 0 is held to a
    batch-1 engine fed its prompt, frames and tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api
    from repro_torch.serve import ContinuousBatcher, Request, ServeEngine

    t_phase = time.perf_counter()
    torch.cuda.init()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_arch(arch_name).model
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = model_api(cfg)
    t0 = time.perf_counter()
    params = api.init(0, dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    leaves = params.leaves()
    n_params = sum(p.numel() for p in leaves)
    w_bytes = sum(p.numel() * p.element_size() for p in leaves)
    emit({"phase": f"{phase}/init", "arch": arch_name,
          "layers": cfg.n_layers, "params": n_params,
          "weight_bytes": w_bytes, "allocated_before_bytes": before,
          "init_s": init_s,
          "init_peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
    max_new = SERVE_NEW[arch_name]
    max_len = max_len or prompt_len + max_new + 8
    B = SERVE_BATCH
    encdec = cfg.family == "encdec"
    kv_bytes = cache_bytes(api, params, B, max_len)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServeEngine(api, params, max_len=max_len, batch=B)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (B, prompt_len), dtype=np.int32)
    extra = None
    if encdec:
        extra = {"frames": rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)
                                      ).astype(np.float32)}

    zero_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=max_new, extra=extra)
    torch.cuda.synchronize(dev)
    gen_s = time.perf_counter() - t0
    done, cont_s = None, None
    if continuous:
        cb = ContinuousBatcher(eng)
        for u in range(SERVE_REQUESTS):
            cb.submit(Request(uid=u, prompt=prompts[u % B],
                              max_new_tokens=max_new))
        # the clock keeps each step's logits (one f32 copy a step)
        with ServeClock(eng, keep=True) as cont_clock:
            t0 = time.perf_counter()
            done = cb.run(decode_steps=3 * max_new)
            torch.cuda.synchronize(dev)
            cont_s = time.perf_counter() - t0
    launches = read_launches(phase)

    # a second run through the engine's own loop, timed, and keeping each
    # call's logits for the batcher's checks (one token copy a call)
    with ServeClock(eng, keep=continuous or encdec) as clock:
        again = eng.generate(prompts, max_new=max_new, extra=extra)
    step_ms = clock.step_ms()
    peak = torch.cuda.max_memory_allocated(dev)
    prof = profile_decode(eng, prompts, extra=extra)
    prof["device_idle_share"] = 1 - (prof["device_busy_ms_per_step"]
                                     / statistics.median(step_ms))
    bounds = SERVE_LOGITS_ATOL[arch_name]
    if encdec:
        f32 = model_api(dataclasses.replace(cfg, dtype="float32"))
        consistency = decode_prefill_err(
            f32, f32.init(0, dev), prompts[:2], max_len,
            {"frames": extra["frames"][:2]})
        consistency.update(dtype="float32",
                           ok=consistency["max_abs_err"]
                           <= bounds["consistency_f32"])
        torch.cuda.empty_cache()
    else:
        # the same weights with no token dropped, in prefill or decode,
        # so that the two agree as the reference's check needs
        consistency = decode_prefill_err(model_api(no_drop(cfg)), params,
                                         prompts[:2], max_len)
        consistency["ok"] = consistency["max_abs_err"] <= bounds["consistency"]
    res = {"phase": phase, "arch": arch_name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": str(cfg.activation_dtype),
           "params": n_params, "weight_bytes": w_bytes,
           "reduced": ({"n_layers": f"{get_arch(arch_name).model.n_layers}"
                                    f" -> {cfg.n_layers}"} if layers else {}),
           "family": cfg.family,
           # the decode cache: K/V (zero past the prompt until written)
           # and the Mamba layers' f32 states
           "cache_bytes": kv_bytes,
           "batch": B, "prompt_len": prompt_len, "max_new": max_new,
           "max_len": max_len, "generate_s": gen_s,
           "tokens_per_s": out.size / gen_s,
           "prefill_ms": clock.prefill_ms()[0],
           "decode_step_ms": step_ms,
           "decode_step_ms_median": statistics.median(step_ms),
           "decode_bound_ms": (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
           "peak_mem_bytes": peak, "tokens_sha256": tokens_digest(out),
           "deterministic": bool(np.array_equal(out, again)),
           # random weights: a row may well repeat one token, so the
           # checks below hold logits, which a token hides
           "distinct_tokens_by_row": [len(set(r.tolist())) for r in out],
           "consistency": consistency,
           "decode_profile": prof, "launches": launches,
           "first_row": out[0][:16].tolist()}
    ok = res["deterministic"] and consistency["ok"]
    if encdec:
        res.update(enc_seq=cfg.enc_seq, enc_layers=cfg.enc_layers)
        one = ServeEngine(api, params, max_len=max_len, batch=1)
        res["generate_vs_batch1"] = batch1_err(one, prompts, extra, clock)
        ok = ok and res["generate_vs_batch1"]["max_abs_err"] \
            <= bounds["generate_vs_batch1"]
        del one
    if continuous:
        res.update({
            "continuous_requests": len(done),
            "continuous_tokens": sum(len(c.tokens) for c in done),
            "continuous_s": cont_s,
            "continuous_tokens_per_s": sum(len(c.tokens) for c in done) / cont_s,
            "continuous_sha256": tokens_digest([c.uid] + c.tokens for c in done),
            # the second wave decodes from prompt + max_new on: positions
            # at max_len and past it write the cache's last entry
            "continuous_clamped_steps": max(0, prompt_len + 2 * max_new
                                            - max_len)})
        ok = ok and sorted(c.uid for c in done) == list(range(SERVE_REQUESTS)) \
            and all(len(c.tokens) == max_new for c in done)
        one = ServeEngine(api, params, max_len=max_len, batch=1)
        res["batcher_logits"] = batcher_checks(
            eng, one, prompts, clock, cont_clock, done, max_new)
        del cont_clock, clock
        with ServeClock(one, keep=True) as want_clock:
            want = one.generate(prompts[:1], max_new=max_new)[0]
        cb = ContinuousBatcher(one)
        cb.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=max_new))
        with ServeClock(one, keep=True) as got_clock:
            got = cb.run(decode_steps=3 * max_new)
        pairs = list(zip(want_clock.calls, got_clock.calls))
        res["batch1_equal_generate"] = (
            len(got) == 1 and got[0].tokens == want.tolist()
            and len(want_clock.calls) == len(got_clock.calls)
            and all(a["kind"] == b["kind"] and a["pos"] == b["pos"]
                    and torch.equal(a["logits"], b["logits"])
                    for a, b in pairs))
        res["batch1_calls"] = len(pairs)
        bl = res["batcher_logits"]
        ok = ok and res["batch1_equal_generate"] \
            and bl["first_wave_tokens_equal"]
        for key, err in (("batcher_vs_generate", bl["first_wave_max_abs_err"]),
                         ("batcher_vs_batch1", bl["second_wave_max_abs_err"])):
            ok = ok and err <= bounds[key]
    res["logits_atol"] = bounds
    res["wall_s"] = time.perf_counter() - t_phase
    emit(res)
    if not ok:
        raise AssertionError(f"{phase}: generation not deterministic, decode "
                             "off prefill, the continuous requests incomplete "
                             "or off generate's logits, or batch-1 serving "
                             "differs from generate")
    return launches


def phase_serve_consistency(dev):
    """Phase 36: the reference's prefill/decode consistency
    (``tests/test_decode_consistency.py``) at full width, f32, depth 4:
    prefill S tokens, decode 3, and each step's logits equal the prefill
    up to its token to atol 2e-3; granite-3-2b, and deepseek-moe-16b with
    ``capacity_factor = capacity_factor_decode = E / K`` (no token
    drops)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api

    t_phase = time.perf_counter()
    zero_launches()
    arms = {}
    for name in ("granite-3-2b", "deepseek-moe-16b"):
        cfg = no_drop(dataclasses.replace(
            get_arch(name).model, dtype="float32", n_layers=CONSISTENCY_LAYERS))
        api = model_api(cfg)
        S = CONSISTENCY_S
        toks = np.random.default_rng(1).integers(
            1, cfg.vocab, (CONSISTENCY_B, S + 3), dtype=np.int32)
        err = decode_prefill_err(api, api.init(0, dev), toks,
                                 S + 8)["max_abs_err"]
        arms[name] = {"layers": cfg.n_layers, "dtype": "float32",
                      "batch": CONSISTENCY_B, "prompt_len": S,
                      "max_abs_err": err, "ok": err <= 2e-3}
        torch.cuda.empty_cache()
    launches = read_launches("serve_consistency")
    emit({"phase": "serve_consistency", "atol": 2e-3, "arms": arms,
          "launches": launches, "wall_s": time.perf_counter() - t_phase})
    bad = [k for k, a in arms.items() if not a["ok"]]
    if bad:
        raise AssertionError(f"serve_consistency: decode differs from prefill "
                             f"beyond atol 2e-3 on {bad}")
    return launches


# ----------------------------------------------------------------------
# The ssm, hybrid, vlm and encdec families
# ----------------------------------------------------------------------

SSM_ARCH, SSM_TRAIN_LAYERS = "mamba2-1.3b", 12
SSM_SERVE_LAYERS = 24     # of mamba2-1.3b's 48: ssm_serve's depth
VLM_ARCH, VLM_TRAIN_LAYERS = "internvl2-2b", 4
HYBRID_ARCH, HYBRID_SERVE_LAYERS = "jamba-v0.1-52b", 8    # one superblock
# whisper-tiny whole (4 + 4 layers); 448 decoder tokens, Whisper's
# published text context: the train's rows, and the serve's max_len
# (prompts of 384, 64 new)
ENCDEC_ARCH, ENCDEC_LAYERS, ENCDEC_SEQ, ENCDEC_PROMPT = "whisper-tiny", 4, 448, 384


def stream_check(api, tc, state, check, dev, seq=SEQ, timed=False):
    """Rows 1 and 2 against their plain versions on the stream the next
    train step would send: each worker's gradients on its rows of batch
    ``STEPS`` at the trained state, top-k with the state's residual rows,
    packed into the bucket stream; the producer on each worker's stream,
    the consumer on the sum and OR of their payloads, each launched once
    on the whole stream as the step launches it, held to phase 3's
    tolerance (Gaussian-like values; words and residual exactly). The
    moments are dropped first (the check needs the parameters and the
    residuals). With ``timed``, then each kernel's CUDA-event ms on this
    stream (the producer on worker 0's, the consumer on the aggregate),
    its plain version's and its bound (this stream's non-zeros, estimates
    and the plain peel's rounds to the fixpoint).
    Returns the blocks, each worker's and the aggregate's non-zeros, the
    estimated count, the kernels' output digests and the times."""
    import torch
    from repro_torch.core import index as index_lib
    from repro_torch.core.aggregators import sparsify_leaf
    from repro_torch.core.blocks import make_plan, to_blocks
    from repro_torch.core.bucketing import make_bucket_plan
    from repro_torch.core.collectives import LocalWorkers
    from repro_torch.data.pipeline import batch_fn
    from repro_torch.train.loop import device_batch

    cfg, W = tc.compression, tc.workers
    state.opt.clear()
    torch.cuda.empty_cache()
    leaves = state.params.leaves()
    batch = device_batch(batch_fn(api.cfg, BATCH, seq, seed=tc.seed)(STEPS), dev)
    per = BATCH // W
    group = LocalWorkers(W)
    payloads, nnz_w = [], []
    for w in range(W):
        rows = {k: v[w * per:(w + 1) * per] for k, v in batch.items()}
        loss, _ = api.loss(state.params.tree(), rows, remat=tc.remat)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            plan = make_bucket_plan(grads, cfg)
            stream = plan.pack_flat([
                sparsify_leaf(g.reshape(-1).float(), r[w], cfg)[0]
                for g, r in zip(grads, state.residual)]).reshape(-1)
            del grads
            lp = make_plan(stream.numel(), cfg)
            xb = to_blocks(stream, lp)
            ids = torch.arange(lp.nb, dtype=torch.int32, device=dev)
            nnz_w.append(int((xb != 0).sum()))
            payloads.append(check.producer(xb, ids, cfg))
            if timed and w == 0:
                xb0 = xb
            del stream, xb
    with torch.no_grad():
        sk = group.sum([p[0] for p in payloads])
        words = group.bor([p[1] for p in payloads])
        enc = [digest(*p) for p in payloads]
        del payloads
        values, res = check.consumer(sk, words, ids, cfg, False)
        nnz = int(index_lib.popcount(words))
        out = {"blocks": lp.nb, "worker_nnz": nnz_w, "aggregate_nnz": nnz,
               "estimated": int(res.sum()),
               "sha256_sketch_words_maxabs": enc,
               "sha256_values_residual": digest(values, res),
               "agree": True}
        if timed:
            out["timed"] = time_codec(xb0, sk, words, ids, cfg, dev, nnz_w[0],
                                      nnz, int(res.sum()))
            del xb0
    del sk, words, values, res
    torch.cuda.empty_cache()
    return out


def time_codec(xb, sk, words, ids, cfg, dev, nnz_in, nnz, n_res):
    """Rows 1 and 2 on a train path's own stream: the producer on one
    worker's blocks ``xb`` (``nnz_in`` non-zeros), the consumer on the
    aggregate ``sk`` / ``words`` (``nnz`` set bits, ``n_res`` estimated);
    each kernel's CUDA-event ms, its plain version's, its bound (the
    bytes it moves, or this stream's operations with the plain peel's
    rounds to its fixpoint), resident blocks an SM and shared memory."""
    from repro_torch.core import index as index_lib
    from repro_torch.core.peeling import peel_blocks
    from repro_torch.kernels import ops, ref
    nb, G, c = xb.shape[0], cfg.group, cfg.lanes
    bits = index_lib.unpack_bits(words.reshape(-1), (nb, G, c))
    rounds = peel_blocks(sk, bits, ids, cfg).rounds_used
    del bits
    eb, eo, _, _ = codec_bytes_ops(nb, cfg, nnz_in, 0, 0, 0)
    _, _, db, do = codec_bytes_ops(nb, cfg, 0, nnz, n_res, rounds)
    out = {}
    for name, kfn, pfn, nbytes, nops in [
        ("encode_pack_quantize", lambda: ops.encode_pack_quantize(xb, ids, cfg),
         lambda: ref.encode_pack_quantize_ref(xb, ids, cfg), eb, eo),
        ("dequant_peel_unpack", lambda: ops.dequant_peel_unpack(sk, words, ids, cfg),
         lambda: ref.dequant_peel_unpack_ref(sk, words, ids, cfg), db, do)]:
        b_ms, b_by = bound(nbytes, nops)
        blocks, smem = ops.kernel_occupancy(name, cfg, dev)
        out[name] = {"geometry": {"ratio": cfg.ratio, "rows": cfg.rows,
                                  "lanes": c, "group": G},
                     "blocks": nb, "ms": cuda_ms(kfn, 10),
                     "plain_ms": cuda_ms(pfn, 3, warmup=1), "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "ops": nops,
                     "blocks_per_sm": blocks, "smem_bytes": smem,
                     "plain_rounds_to_fixpoint": rounds}
    return out


def plain_replay(api, tc, dev, want_digest, want_loss, seq=SEQ):
    """Step 0 of the train again from the same init under
    ``use_pallas="never"`` (the plain versions of rows 1 and 2 on the
    card): no kernel may launch, and the parameters after the step must
    equal the kernels' run's bit for bit (``want_digest``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train.loop import run_training

    never = dataclasses.replace(tc, compression=dataclasses.replace(
        tc.compression, use_pallas="never"))
    params = api.init(tc.seed, dev)
    zero_launches()
    res = run_training(api, never, global_batch=BATCH, seq_len=seq, steps=1,
                       device=dev, params=params, log_every=0)
    launches = dict(ops.LAUNCHES)
    got = param_digest(params)
    out = {"launches": launches, "loss": res.losses[0],
           "loss_equal": res.losses[0] == want_loss,
           "param_sha256": got, "digest_equal": got == want_digest}
    del params, res
    torch.cuda.empty_cache()
    if any(launches.values()):
        raise AssertionError(f"plain replay launched a kernel: {launches}")
    return out


def phase_family_train(dev, check, phase, arch_name, layers, seq=SEQ,
                       timed=False):
    """Phases 37-38 and 41: ``arch_name`` at its published widths, depth
    cut to ``layers``, bf16, trained as phase 4 (W=2 emulated, global
    batch 8 x ``seq`` tokens, plus the vlm's 256 visual tokens or the
    encdec's 1500 frames a row, the arch's
    ``compressed`` wire at ratio 0.1 and top-k 4%, AdamW with ZeRO-1, the
    ``block`` remat default, one warm-up and three timed steps): the
    producer W times and the consumer once a step (``phase_train``
    holds the counts). Then rows 1 and 2 against their plain versions on
    the next step's stream (``stream_check``) and step 0 replayed under
    ``use_pallas="never"`` (``plain_replay``), bit for bit. With
    ``timed``, rows 1 and 2 timed on that stream beside their plain
    versions and bounds (``time_codec``). Returns the launches and the
    losses."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    line, launches, api, tc, state = phase_train(
        dev, phase=phase, arch_name=arch_name, layers=layers, emit_line=False,
        seq=seq)
    cfg, n = tc.compression, line["params"]
    line["buckets_per_step"] = cfg.num_buckets(n)
    line["blocks_per_step"] = (cfg.num_buckets(n) * cfg.bucket_elems_for(n)
                               // cfg.block_elems)
    line["remat"] = tc.remat
    if api.cfg.family == "vlm":
        line["vis_tokens"] = api.cfg.vis_tokens
    if api.cfg.family == "encdec":
        line.update(enc_layers=api.cfg.enc_layers, enc_seq=api.cfg.enc_seq)
    line["stream_check"] = stream_check(api, tc, state, check, dev, seq=seq,
                                        timed=timed)
    del state
    torch.cuda.empty_cache()
    line["plain_replay"] = plain_replay(api, tc, dev,
                                        line["param_sha256_by_step"][0],
                                        line["losses"][0], seq=seq)
    line["final_param_sha256"] = line["param_sha256_by_step"][-1]
    line["wall_s"] = time.perf_counter() - t0
    emit(line)
    if not line["plain_replay"]["digest_equal"]:
        raise AssertionError(f"{phase}: step 0 under use_pallas='never' "
                             "differs from the kernels' step 0")
    return launches, line["losses"]


# ----------------------------------------------------------------------
# The long-sequence shapes (blockwise attention)
# ----------------------------------------------------------------------

# train_4k's row length at 4 rows (cut from its 256 so that one card
# holds the step), one warm-up and two timed steps
LONG_SEQ, LONG_BATCH, LONG_STEPS = 4096, 4, 3
# prefill_32k's length at 2 rows (cut from its 32 and decode_32k's 128:
# the KV cache alone is 2.7 GB a row), then 16 new tokens; the f32
# decode/prefill hold at this length on one row (four prefills of 32k)
LONG_PROMPT, LONG_SERVE_BATCH, LONG_NEW = 32768, 2, 16
# flash_attention against the one-pass softmax on the card: outputs and
# gradients within these fractions of the largest entry. f32: the two
# sum a row's 4,096 terms in other orders (a few ulps); bf16 operands:
# one bf16 ulp of the output's largest binade (2^-7 of its entry), two to
# four of a gradient's (each rounds its f32 result once, from sums in
# other orders)
FLASH_ATOL = {"float32": {"out": 1e-5, "grad": 1e-5},
              "bfloat16": {"out": 2.0 ** -7, "grad": 2.0 ** -6}}


def onepass_attention(q, k, v, causal):
    """The plain one-pass softmax: the whole (B, H, Sq, Skv) f32 score
    tensor, the causal mask at -1e30, ``exp(s - max)``, the unnormalised
    probabilities in v's dtype times v in f32, then divided by their
    sum: the function ``flash_attention`` computes, in one block."""
    import torch
    S, H, hd = q.shape[1:]
    rep = H // k.shape[2]
    kh = k.repeat_interleave(rep, dim=2).to(torch.float32)
    vh = v.repeat_interleave(rep, dim=2).to(torch.float32)
    s = q.to(torch.float32).transpose(1, 2) @ kh.permute(0, 2, 3, 1) \
        * (1.0 / math.sqrt(hd))
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[:, None] < torch.arange(k.shape[1],
                                                      device=q.device), -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = p.to(v.dtype).to(torch.float32) @ vh.transpose(1, 2)
    return (o / p.sum(dim=-1, keepdim=True)).transpose(1, 2).to(q.dtype)


def attention_bound(B, H, KV, hd, pairs, backward, dtype):
    """(ms, "bytes" | "operations"): the least time of the visited block
    pairs' products (scores and values; in the backward the scores again
    and four products) at the card's rate for ``dtype`` operands (bf16
    on the tensor cores, the reference's block products; f32 outside
    them), against q, the output (and in the backward the output's
    gradient and dq) at H heads and k, v (dk, dv) at KV heads, each
    moved once."""
    import torch
    cells = sum((qs[1] - qs[0]) * (ks[1] - ks[0]) for qs, row in pairs
                for ks, _ in row)
    ops = 2 * B * H * cells * hd * (7 if backward else 2)
    sq = pairs[-1][0][1]
    size = torch.finfo(dtype).bits // 8
    nbytes = B * sq * hd * (2 * H + 2 * KV) * size * (2 if backward else 1)
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound(nbytes, ops, rate)


def flash_hold(cfg, dev):
    """``flash_attention`` against :func:`onepass_attention` at ``cfg``'s
    heads (32 query heads, 8 KV heads of 64 for granite) at S
    ``LONG_SEQ``, B 1, causal, in f32 and with bf16 operands: the output
    and the gradients of q, k and v within :data:`FLASH_ATOL` of the
    largest entry; then each one's CUDA-event ms forward and forward +
    backward (bf16), its peak memory over a forward and backward, and
    the blockwise bound."""
    import torch
    from repro_torch.models import layers as L
    S, H, KV, hd = LONG_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev)
    gen.manual_seed(4096)
    out = {"seq": S, "batch": 1, "heads": H, "kv_heads": KV, "head_dim": hd,
           "q_block": cfg.q_block, "kv_block": L.KV_BLOCK, "atol": FLASH_ATOL}
    fns = {"flash": lambda q, k, v: L.flash_attention(q, k, v, True, cfg.q_block),
           "onepass": lambda q, k, v: onepass_attention(q, k, v, True)}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        x = [torch.randn((1, S, h, hd), generator=gen, device=dev).to(dt)
             .requires_grad_() for h in (H, KV, KV)]
        do = torch.randn((1, S, H, hd), generator=gen, device=dev).to(dt)
        res = {}
        for key, fn in fns.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            o = fn(*x)
            res[key] = [o] + list(torch.autograd.grad(o, x, do))
            res[key + "_peak"] = torch.cuda.max_memory_allocated(dev)
        errs, ok = {}, True
        for i, part in enumerate(("out", "dq", "dk", "dv")):
            got = res["flash"][i].detach().float()
            want = res["onepass"][i].detach().float()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            errs[part] = {"max_abs_err": err, "max_abs": scale}
            ok = ok and err <= FLASH_ATOL[name]["out" if i == 0 else "grad"] * scale
        out[name] = {"errors": errs, "ok": ok,
                     "peak_mem_bytes": {k: res[k + "_peak"] for k in fns}}
        if dt == torch.bfloat16:
            pairs = L._block_pairs(S, S, True, cfg.q_block, L.KV_BLOCK, 0)
            for key, fn in fns.items():
                out[name][f"{key}_fwd_ms"] = cuda_ms(lambda: fn(*x), 3, warmup=1)
                out[name][f"{key}_fwd_bwd_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(fn(*x), x, do), 3, warmup=1)
            out[name]["fwd_bound_ms"], out[name]["bound_by"] = \
                attention_bound(1, H, KV, hd, pairs, False, dt)
            out[name]["fwd_bwd_bound_ms"] = attention_bound(
                1, H, KV, hd, pairs, True, dt)[0]
            out[name]["bound_ops_per_s"] = BF16_OPS_PER_S
        del x, do, res
    torch.cuda.empty_cache()
    return out


def phase_long_train(dev):
    """Phase 44: granite-3-2b at full width (d_model 2048, 32 / 8 heads,
    d_ff 8192, bf16), depth 40 -> 4, at ``train_4k``'s S 4,096 with a
    global batch of 4 rows (cut from 256): W=2 emulated, ``compressed``
    (ratio 0.1, top-k 4%), the ``block`` remat, ZeRO-1, one warm-up and
    two timed steps, every attention blockwise (8 query blocks x 4 key
    blocks a row, 20 pairs visited); W producer launches and one
    consumer launch a step (``phase_train`` holds the counts). Then
    :func:`flash_hold` at granite's heads. Prints step ms, peak memory,
    the launches, beside the card's name and power limit."""
    import torch
    line, launches, api, tc, state = phase_train(
        dev, phase="long_train", steps=LONG_STEPS, seq=LONG_SEQ,
        batch=LONG_BATCH, emit_line=False)
    del state
    torch.cuda.empty_cache()
    line.update(card=smi_line(), shape="train_4k", remat=tc.remat)
    line["reduced"]["global_batch"] = f"256 -> {LONG_BATCH}"
    line["flash_vs_onepass"] = hold = flash_hold(api.cfg, dev)
    emit(line)
    if not (hold["float32"]["ok"] and hold["bfloat16"]["ok"]):
        raise AssertionError("long_train: flash_attention differs from the "
                             "one-pass softmax beyond FLASH_ATOL")
    return launches


class PeakClock(ServeClock):
    """A :class:`ServeClock` that also splits the peak memory: the
    prefill's, read right after the prefill call (then the peak is
    reset), and the decode's, the peak since (the cache included)."""

    prefill_peak = None

    def _wrap(self, kind, fn):
        call = super()._wrap(kind, fn)
        if kind != "prefill":
            return call

        def prefill(*args):
            import torch
            out = call(*args)
            self.prefill_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            return out
        return prefill


def phase_long_serve(dev):
    """Phase 45: granite-3-2b whole (40 layers, bf16, random weights from
    seed 0) through ``ServeEngine.generate``, the serve launcher's call:
    2 prompts of 32,768 tokens (``prefill_32k``'s length; 2 rows, cut
    from its 32 and ``decode_32k``'s 128), 16 new tokens, ``max_len``
    prompt + 24 as the launcher's default; every attention of the
    prefill blockwise (64 query blocks x 32 key blocks a row, 1,056 pairs
    visited), the decode one pass over the whole cache. The launch
    counters zeroed before and read after (serving runs no codec
    kernel). Prints the prefill ms and its tokens/s beside the bound of
    its attention products (bf16 on the tensor cores), the decode ms a step
    (CUDA events, the engine's own loop) beside its bound (the weights'
    and the whole cache's bytes at 3.35 TB/s), the peak memory of the
    prefill and of the decode. Then ``serve_consistency``'s hold at
    this length: depth 4, f32, one row, the prefill of 32,768 tokens and
    3 decode steps, each step's logits against the last-position logits
    of a prefill of the prompt up to its token, within atol 2e-3."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models.registry import model_api
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_arch("granite-3-2b").model
    api = model_api(cfg)
    params = api.init(0, dev)
    leaves = params.leaves()
    w_bytes = sum(p.numel() * p.element_size() for p in leaves)
    B, S, new = LONG_SERVE_BATCH, LONG_PROMPT, LONG_NEW
    max_len = S + new + 8
    kv_bytes = cache_bytes(api, params, B, max_len)
    eng = ServeEngine(api, params, max_len=max_len, batch=B)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, (B, S),
                                                dtype=np.int32)
    zero_launches()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with PeakClock(eng) as clock:
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=new)
        torch.cuda.synchronize(dev)
        gen_s = time.perf_counter() - t0
    launches = read_launches("long_serve")
    peaks = {"prefill": clock.prefill_peak,
             "decode": torch.cuda.max_memory_allocated(dev)}
    step_ms = clock.step_ms()
    prefill_ms = clock.prefill_ms()[0]
    del eng, params, leaves, clock
    torch.cuda.empty_cache()

    f32 = model_api(dataclasses.replace(cfg, dtype="float32",
                                        n_layers=CONSISTENCY_LAYERS))
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (1, S + 3),
                                            dtype=np.int32)
    consistency = decode_prefill_err(f32, f32.init(0, dev), toks, S + 3,
                                     start=S)
    consistency.update(layers=CONSISTENCY_LAYERS, dtype="float32", atol=2e-3,
                       ok=consistency["max_abs_err"] <= 2e-3)
    torch.cuda.empty_cache()
    line = {"phase": "long_serve", "card": smi_line(), "arch": cfg.name,
            "layers": cfg.n_layers, "dtype": str(cfg.activation_dtype),
            "shape": ["prefill_32k", "decode_32k"], "batch": B,
            "prompt_len": S, "max_new": new, "max_len": max_len,
            "reduced": {"batch": f"32 (prefill_32k) / 128 (decode_32k) -> {B}"},
            "weight_bytes": w_bytes, "cache_bytes": kv_bytes,
            "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": B * S / (prefill_ms / 1e3),
            "prefill_attention_bound_ms": cfg.n_layers * attention_bound(
                B, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                L._block_pairs(S, S, True, cfg.q_block, L.KV_BLOCK, 0),
                False, cfg.activation_dtype)[0],
            "decode_step_ms": step_ms,
            "decode_step_ms_median": statistics.median(step_ms),
            "decode_bound_ms": (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
            "peak_mem_bytes": peaks,
            "generate_s": gen_s, "tokens_sha256": tokens_digest(out),
            "first_row": out[0].tolist(), "consistency": consistency,
            "launches": launches, "wall_s": time.perf_counter() - t_phase}
    emit(line)
    if not consistency["ok"]:
        raise AssertionError("long_serve: a decode step's logits differ from "
                             "the prefill's beyond atol 2e-3")
    return launches


# ----------------------------------------------------------------------
# The model axis: a grid of W data-parallel x MP model ranks
# ----------------------------------------------------------------------

MODEL_PARALLEL = 2        # model ranks a data index (a grid of WORKERS x this)
DIST_MODEL_STEPS = 2      # steps of each dist_model arm: a warm-up, a timed one
# each arch's depth and tokens a row on the grid: granite, internvl2-2b as
# phases 4 and 38 (depth 4; internvl's rows also take their 256 visual
# tokens), deepseek at depth 1, whisper-tiny whole as phase 41 (448
# decoder tokens and 1500 frames a row), mamba2-1.3b as phase 37 (depth
# 12), qwen2.5-3b at depth 2 on the wide grid
DIST_MODEL_LAYERS = {"granite-3-2b": LAYERS, "deepseek-moe-16b": 1,
                     "whisper-tiny": 4, "internvl2-2b": 4,
                     "mamba2-1.3b": SSM_TRAIN_LAYERS, "qwen2.5-3b": 2}
DIST_MODEL_SEQ = {"whisper-tiny": 448}
# (arch, data-parallel aggregator, ep_exchange) of each arm, in order
DIST_MODEL_ARMS = (("granite-3-2b", "compressed", "none"),
                   ("granite-3-2b", "dense", "none"),
                   ("deepseek-moe-16b", "compressed", "none"),
                   ("deepseek-moe-16b", "compressed", "dense"),
                   ("deepseek-moe-16b", "compressed", "compressed"),
                   ("whisper-tiny", "compressed", "none"),
                   ("internvl2-2b", "compressed", "none"),
                   ("mamba2-1.3b", "compressed", "none"))
# the arms held to an emulated W=2 train of the same arch, seed and rows
# (their first two losses run at the initial parameters): granite's dense
# arm to phase 4, the families' compressed arms to phases 37, 38 and 41
DIST_MODEL_EMULATED = {"granite-3-2b/dense/none": "train",
                       "internvl2-2b/compressed/none": "vlm_train",
                       "whisper-tiny/compressed/none": "encdec_train",
                       "mamba2-1.3b/compressed/none": "ssm_train"}
# the arms whose replicated leaves' step-0 gradients are held equal across
# the model ranks (granite's also against the plain aggregator)
DIST_MODEL_HOLD = ("granite-3-2b/compressed/none", "mamba2-1.3b/compressed/none")
# the dense grid's losses against the emulated W=2 train's: the card's
# readings 2.5e-6 and 1.4e-6 (PERF.md, the model axis), a bf16 rehearsal
# on the CPU at the smoke width 1.0e-4; a reduction missed or doubled
# moves the loss by far more
DIST_MODEL_LOSS_RTOL = 1e-3
# the wide arm, after the others on the same ranks: qwen2.5-3b (16 heads,
# 2 KV heads) on a grid of 1 data index x 4 model ranks, so each rank
# holds half a KV head; its step-0 loss held to the unsharded loss that
# rank 0 computes from the gathered parameters on the same rows
DIST_MODEL_WIDE = ("qwen2.5-3b", 4)


class ModelAxisLog(WireLog):
    """The model-axis group a ``dist_model`` rank hands its step: a
    :class:`WireLog` that names each call by its op and logs the
    exchange's lane sums too, for :func:`replay_collectives`."""

    def _label(self, op):
        return op

    def lane_sum(self, parts, combine):
        op = f"lane_sum_{combine}"
        self.calls.append((op, tuple(parts[0].shape), parts[0].dtype, op))
        return self.group.lane_sum(parts, combine)

    def lane_sum_add(self, parts):       # the replay's names
        return self.group.lane_sum(parts, "add")

    def lane_sum_or(self, parts):
        return self.group.lane_sum(parts, "or")


class AggregateHold:
    """Within it, the train step's aggregator keeps its first call's
    inputs (each local worker's gradients, the residuals before) and
    outputs (the aggregate, the residuals after), copies on the device."""

    def __enter__(self):
        from repro_torch.core import aggregators as agg_lib
        self.lib, self.orig = agg_lib, agg_lib.make_aggregator
        self.made, self.inputs, self.outputs = None, None, None
        hold = self

        class Recorder:
            def __init__(self, agg):
                self.agg = agg

            def __call__(self, grads_w, state):
                if hold.inputs is not None:
                    return self.agg(grads_w, state)
                hold.inputs = ([[g.clone() for g in gw] for gw in grads_w],
                               [r.clone() for r in state.residual])
                out, st = self.agg(grads_w, state)
                hold.outputs = ([o.clone() for o in out],
                                [r.clone() for r in st.residual])
                return out, st

        def make(name, cfg, group, **kw):
            hold.made = (name, cfg, group, kw)
            return Recorder(self.orig(name, cfg, group, **kw))

        agg_lib.make_aggregator = make
        return self

    def __exit__(self, *exc):
        self.lib.make_aggregator = self.orig

    def _run(self, plain, grads_w, res):
        from repro_torch.core.collectives import AggregationState
        name, cfg, group, kw = self.made
        if plain:
            cfg = dataclasses.replace(cfg, use_pallas="never")
        return self.orig(name, cfg, group, **kw)(
            grads_w, AggregationState(residual=[r.clone() for r in res]))

    def plain_check(self, seed):
        """The same aggregator under ``use_pallas="never"`` over the same
        group. On the kept inputs (the step's gradients): the aggregate
        bit for bit (the plain encode sums each cell in the kernels'
        order, and the plain peel subtracts a round's values in it), its
        largest difference, whether its non-zeros sit where the kernels'
        do, and the residuals bit for bit. Then, on dyadic gradients of
        the same leaves (``seed``; every sum exact in any order), the
        kernels' aggregator and the plain one: aggregate and residuals bit
        for bit."""
        import torch
        grads_w, res = self.inputs
        out, st = self._run(True, grads_w, res)
        ref = self.outputs[0]
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(out, ref))
        real = {"max_abs_err": err,
                "aggregate_equal": all(torch.equal(a, b)
                                       for a, b in zip(out, ref)),
                "nonzeros_equal": all(torch.equal(a != 0, b != 0)
                                      for a, b in zip(out, ref)),
                "residual_equal": all(torch.equal(a, b) for a, b in
                                      zip(st.residual, self.outputs[1]))}
        del out, st
        gen = torch.Generator(device=res[0].device)
        gen.manual_seed(seed)

        def dyadic(g):
            sign = torch.randint(0, 2, g.shape, generator=gen,
                                 device=g.device) * 2 - 1
            e = torch.randint(-2, 3, g.shape, generator=gen, device=g.device)
            return (sign * torch.exp2(e.float())).to(g.dtype)

        dy = [[dyadic(g) for g in gw] for gw in grads_w]
        zero = [torch.zeros_like(r) for r in res]
        (ko, ks), (po, ps) = (self._run(False, dy, zero),
                              self._run(True, dy, zero))
        dyad = {"aggregate_equal": all(torch.equal(a, b) for a, b in zip(ko, po)),
                "residual_equal": all(torch.equal(a, b) for a, b in
                                      zip(ks.residual, ps.residual))}
        return real, dyad


def _dist_model_arm(arch_name, api, tc, data, log, dev, rank, hold):
    """One ``dist_model`` arm on this rank: a fresh train from
    ``tc.seed`` of ``DIST_MODEL_STEPS`` steps over ``data`` and the
    model-axis group ``log`` (a :class:`ModelAxisLog`), the caches
    emptied first; its losses, step ms, peak memory, the card's used
    memory (rank 0 polls it), the launch counters (zeroed just before
    the run, read just after), the sha256 of the parameter shards, the
    last step's model-axis collectives replayed alone. Returns (the
    arm's record, the trained state's leaf paths and specs)."""
    import threading
    import torch
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import leaf_spec
    from repro_torch.train.loop import run_training

    def after_step(_line, log=log):
        log.end_step()

    t_arm = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stop, card = threading.Event(), [0]
    poller = threading.Thread(target=_card_peak, args=(stop, card),
                              daemon=True)
    if rank == 0:
        poller.start()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    try:
        with hold:
            res = run_training(api, tc, global_batch=BATCH,
                               seq_len=DIST_MODEL_SEQ.get(arch_name, SEQ),
                               steps=DIST_MODEL_STEPS, device=dev,
                               log_every=1, log_fn=after_step,
                               group=data, model=log)
    finally:
        stop.set()
        if poller.is_alive():
            poller.join()
    launches = codec_launches()
    arm = {"losses": res.losses, "launches": launches,
           "grad_norm": [m["grad_norm"] for m in res.metrics],
           "step_ms": [t * 1e3 for t in res.step_seconds[1:]],
           "warmup_ms": res.step_seconds[0] * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "card_peak_used_bytes": card[0] if rank == 0 else None,
           "param_sha256": param_digest(res.state.params),
           "local_params": sum(p.numel() for p in res.state.params.leaves())}
    paths = res.state.params.paths
    specs = [leaf_spec(p, t.ndim, tc.sharding) for p, t in
             zip(paths, res.state.params.leaves())]
    del res
    torch.cuda.empty_cache()
    arm["train_wall_s"] = time.perf_counter() - t_arm
    return arm, paths, specs


def _unsharded_loss(api, tc, dev, data, model, rank):
    """The step-0 loss without the model axis: the initial parameters
    (``tc.seed``) cut into this rank's shards as the train cuts them and
    gathered back whole (every rank), then on rank 0 the loss of each
    row of batch 0 on them, averaged (the rows are of one length, so
    this is the batch's loss); None on the other ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import batch_fn
    from repro_torch.models.params import unflatten_tree
    from repro_torch.parallel.sharding import gather_leaf
    from repro_torch.train.loop import device_batch
    from repro_torch.train.step import leaf_specs, shard_params

    shards = shard_params(api.init(tc.seed, dev), tc, model, data)
    specs = leaf_specs(shards, tc, model, data)
    whole = unflatten_tree([(path, gather_leaf(p, s, model))
                            for path, p, s in zip(shards.paths,
                                                  shards.leaves(), specs)])
    del shards
    loss = None
    if rank == 0:
        batch = device_batch(batch_fn(api.cfg, BATCH, SEQ, seed=tc.seed)(0),
                             dev)
        with torch.no_grad():
            rows = [api.loss(whole, {k: v[i:i + 1]
                                     for k, v in batch.items()})[0]
                    for i in range(BATCH)]
        loss = float(torch.stack(rows).mean())
    del whole
    torch.cuda.empty_cache()
    dist.barrier()
    return loss


def dist_model_rank(mesh, dev, serve_ref_dir):
    """One rank of ``dist_model`` on its grid (``mesh``: a ``RankMesh``),
    every arm of :data:`DIST_MODEL_ARMS` in turn (:func:`_dist_model_arm`)
    on the global batch's rows of this rank's data index; on the arms of
    :data:`DIST_MODEL_HOLD` the sha256 of the replicated leaves' step-0
    gradients, and on granite's compressed arm the step-0 aggregate
    against the plain aggregator. Then the wide arm
    (:data:`DIST_MODEL_WIDE`) on a grid of the same ranks, all on the
    model axis, with the unsharded step-0 loss (:func:`_unsharded_loss`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import model_api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank, "coords": mesh.coords, "device": str(dev),
           "backend": mesh.data.backend, "staging": mesh.data.staging,
           "arms": {}}
    for arch_name, aggregator, exchange in DIST_MODEL_ARMS:
        key = f"{arch_name}/{aggregator}/{exchange}"
        arch = get_arch(arch_name)
        api = model_api(dataclasses.replace(
            arch.model, n_layers=DIST_MODEL_LAYERS[arch_name]))
        tc = dataclasses.replace(arch.train, workers=WORKERS, accum_steps=1,
                                 aggregator=aggregator, ep_exchange=exchange)
        log = ModelAxisLog(mesh.model)
        hold = AggregateHold() if key in DIST_MODEL_HOLD \
            else contextlib.nullcontext()
        arm, paths, specs = _dist_model_arm(arch_name, api, tc, mesh.data,
                                            log, dev, mesh.rank, hold)
        if isinstance(hold, AggregateHold):
            grads = hold.inputs[0][0]
            arm["replicated_grad_sha256"] = {
                ".".join(p): hashlib.sha256(g.contiguous().view(torch.uint8)
                                            .cpu().numpy()).hexdigest()
                for p, g, sp in zip(paths, grads, specs)
                if all(a is None for a in sp)}
            if arch_name == "granite-3-2b":
                # the plain peel's temporaries are large: one data group
                # at a time, the others waiting with their memory freed
                for t in range(MODEL_PARALLEL):
                    if mesh.coords["model"] == t:
                        real, dyad = hold.plain_check(1000 + mesh.rank)
                        torch.cuda.empty_cache()
                    dist.barrier()
                arm.update(plain_step0=real, plain_dyadic=dyad)
            del hold.inputs, hold.outputs, grads
            torch.cuda.empty_cache()
        arm["model_axis"] = replay_collectives(log, log.step_calls, dev,
                                               staging=True)
        out["arms"][key] = arm
    # the wide arm: every rank on the model axis of one data index
    arch_name, mp = DIST_MODEL_WIDE
    wide = make_host_mesh(mp)
    arch = get_arch(arch_name)
    api = model_api(dataclasses.replace(
        arch.model, n_layers=DIST_MODEL_LAYERS[arch_name]))
    tc = dataclasses.replace(arch.train, workers=wide.shape["data"],
                             accum_steps=1)
    out["wide_grid"] = wide.shape
    t0 = time.perf_counter()
    unsharded = _unsharded_loss(api, tc, dev, wide.data, wide.model,
                                mesh.rank)
    unsharded_s = time.perf_counter() - t0
    log = ModelAxisLog(wide.model)
    arm, _, _ = _dist_model_arm(arch_name, api, tc, wide.data, log, dev,
                                mesh.rank, contextlib.nullcontext())
    arm.update(unsharded_loss=unsharded, unsharded_s=unsharded_s)
    arm["model_axis"] = replay_collectives(log, log.step_calls, dev,
                                           staging=True)
    out["arms"][f"{arch_name}/{tc.aggregator}/none@{wide.shape['data']}x{mp}"] = arm
    del wide
    torch.cuda.empty_cache()
    out["serve"] = dist_serve_rank(mesh, dev, serve_ref_dir)
    return out


def _card_peak(stop, peak):
    """Poll the card's used memory (every process's) until ``stop``."""
    import torch
    while not stop.is_set():
        free, total = torch.cuda.mem_get_info()
        peak[0] = max(peak[0], total - free)
        stop.wait(0.25)


def phase_dist_model(dev, emulated, serve_ref_dir):
    """A grid of ``WORKERS`` data-parallel x ``MODEL_PARALLEL`` model
    ranks, 4 gloo ranks sharing ``cuda:0`` (host-staged, as
    ``dist_train``): each arm of :data:`DIST_MODEL_ARMS` trains
    ``DIST_MODEL_STEPS`` steps at full width (granite-3-2b and
    internvl2-2b at depth 4, deepseek-moe-16b at depth 1, whisper-tiny
    whole, mamba2-1.3b at depth 12 on its Mamba heads) on a global batch
    of 8 rows, each rank on its shards (the sharding profile's tensor,
    vocab, expert and Mamba-head splits) and its data index's rows; then
    qwen2.5-3b at depth 2 on a grid of 1 x 4 of the same ranks
    (:data:`DIST_MODEL_WIDE`: 16 heads, 2 KV heads, so each rank holds
    half a KV head). Fails unless, on every rank:
    granite's compressed arm launched one producer and one consumer a
    step and its dense arm none; its step-0 aggregate and residuals equal
    the plain aggregator's (``use_pallas="never"``, the same group and
    inputs) bit for bit, and so do they on dyadic gradients of the same
    shard-local leaves (``AggregateHold.plain_check``); the replicated
    leaves' step-0 gradients equal
    bit for bit across the model ranks of a data index (granite's and
    mamba2-1.3b's compressed arms, :data:`DIST_MODEL_HOLD`); every rank
    reports the same losses; the arms of :data:`DIST_MODEL_EMULATED`
    (granite's dense arm, the whisper-tiny, internvl2-2b and mamba2-1.3b
    arms) lie
    within ``DIST_MODEL_LOSS_RTOL`` of the emulated W=2 train of their
    arch (one process, same seed and rows: ``emulated`` by phase name,
    the first two losses of phases 4, 41, 38 and 37; the warm-up's learning
    rate is 0 at step 0, so both steps run at the initial parameters
    whatever the aggregator, and a dense emulated run gives phase 4's
    losses bit for bit), and the families' arms launch one producer and
    one consumer a step; the wide arm's step-0 loss lies within
    ``DIST_MODEL_LOSS_RTOL`` of the unsharded loss on the same rows;
    deepseek's ``compressed`` exchange equals its
    ``dense`` exchange bit for bit (losses and the parameter shards'
    sha256) and lies within rtol 1e-2 of ``none``'s losses. Prints,
    beside the card's name and power limit: step ms, peak memory a rank
    and the card's (polled over the phase, and by rank 0 over each arm),
    the launches a rank, and the last step's model-axis collectives
    replayed alone (ms and bytes a rank)."""
    import threading
    import torch
    from repro_torch.launch.ranks import spawn_ranks

    smi = smi_line()
    stop, peak = threading.Event(), [0]
    poller = threading.Thread(target=_card_peak, args=(stop, peak), daemon=True)
    poller.start()
    t0 = time.perf_counter()
    try:
        outs = spawn_ranks(dist_model_rank, WORKERS * MODEL_PARALLEL,
                           (serve_ref_dir,), device="cuda",
                           model_parallel=MODEL_PARALLEL, timeout=DIST_TIMEOUT)
    finally:
        stop.set()
        poller.join()
    wall = time.perf_counter() - t0
    torch.cuda.empty_cache()

    arms = {}
    for key in outs[0]["arms"]:
        per = [o["arms"][key] for o in outs]
        arms[key] = {
            "losses": per[0]["losses"], "grad_norm": per[0]["grad_norm"],
            "step_ms_by_rank": [a["step_ms"] for a in per],
            "warmup_ms_by_rank": [a["warmup_ms"] for a in per],
            "peak_mem_bytes_by_rank": [a["peak_mem_bytes"] for a in per],
            "card_peak_used_bytes": per[0]["card_peak_used_bytes"],
            "launches_by_rank": [a["launches"] for a in per],
            "local_params_by_rank": [a["local_params"] for a in per],
            "train_wall_s_by_rank": [a["train_wall_s"] for a in per],
            "param_sha256_by_rank": [a["param_sha256"] for a in per],
            "model_axis_calls": per[0]["model_axis"]["calls"],
            "model_axis_bytes_per_rank_step":
                per[0]["model_axis"]["payload_bytes_total"],
            "model_axis_bytes_by_op": per[0]["model_axis"]["payload_bytes"],
            "model_axis_ms_median_by_rank": [a["model_axis"]["ms_median"]
                                             for a in per],
            "model_axis_ms_median_by_op_by_rank": [
                a["model_axis"]["ms_median_by_op"] for a in per],
            "staging_copies_ms_median_by_rank": [
                a["model_axis"]["staging_copies_ms_median"] for a in per]}
        for extra in ("plain_step0", "plain_dyadic"):
            if extra in per[0]:
                arms[key][f"{extra}_by_rank"] = [a[extra] for a in per]
    comp, dense = "granite-3-2b/compressed/none", "granite-3-2b/dense/none"
    moe = {ex: f"deepseek-moe-16b/compressed/{ex}"
           for ex in ("none", "dense", "compressed")}
    rel = {}
    for key, phase in DIST_MODEL_EMULATED.items():
        want = emulated[phase][:DIST_MODEL_STEPS]
        arms[key]["emulated_losses"] = want
        rel[key] = [abs(a - b) / abs(b) for a, b in
                    zip(arms[key]["losses"], want)]
        arms[key]["loss_rel_diff_to_emulated"] = rel[key]
    wide = [k for k in arms if "@" in k]
    for key in wide:
        want = outs[0]["arms"][key]["unsharded_loss"]
        arms[key]["unsharded_loss"] = want
        arms[key]["unsharded_s"] = outs[0]["arms"][key]["unsharded_s"]
        rel[key] = [abs(arms[key]["losses"][0] - want) / abs(want)]
        arms[key]["loss_rel_diff_to_unsharded"] = rel[key]
    moe_rel = [abs(a - b) / abs(b) for a, b in
               zip(arms[moe["compressed"]]["losses"], arms[moe["none"]]["losses"])]
    by_rank = {o["rank"]: o for o in outs}
    rep_equal = {key: all(
        by_rank[r]["arms"][key]["replicated_grad_sha256"]
        == by_rank[r - r % MODEL_PARALLEL]["arms"][key]["replicated_grad_sha256"]
        for r in by_rank) for key in DIST_MODEL_HOLD}
    line = {"phase": "dist_model", "card": smi,
            "grid": {"data": WORKERS, "model": MODEL_PARALLEL},
            "wide_grid": outs[0]["wide_grid"],
            "ranks": WORKERS * MODEL_PARALLEL, "global_batch": BATCH,
            "seq_len": {a: DIST_MODEL_SEQ.get(a, SEQ) for a in DIST_MODEL_LAYERS},
            "steps": DIST_MODEL_STEPS, "warmup_steps": 1,
            "layers": DIST_MODEL_LAYERS,
            "backend": outs[0]["backend"], "staging": outs[0]["staging"],
            "devices": [o["device"] for o in outs],
            "coords": [o["coords"] for o in outs],
            "wall_s": wall, "card_peak_used_bytes": peak[0], "arms": arms,
            "loss_rtol_to_emulated": DIST_MODEL_LOSS_RTOL,
            "moe_compressed_loss_rel_diff_to_none": moe_rel,
            "replicated_grads_equal_across_model_ranks": rep_equal}
    emit(line)
    steps = DIST_MODEL_STEPS
    for o in outs:
        a = o["arms"]
        if (a[comp]["launches"]["encode_pack_quantize"],
                a[comp]["launches"]["dequant_peel_unpack"]) != (steps, steps) \
                or any(a[dense]["launches"].values()):
            raise AssertionError(f"dist_model: rank {o['rank']} launches "
                                 f"{a[comp]['launches']} / {a[dense]['launches']}")
        real, dyad = a[comp]["plain_step0"], a[comp]["plain_dyadic"]
        if not (real["aggregate_equal"] and real["residual_equal"]
                and dyad["aggregate_equal"] and dyad["residual_equal"]):
            raise AssertionError(f"dist_model: rank {o['rank']}'s aggregate "
                                 f"differs from the plain aggregator's: "
                                 f"{real} {dyad}")
        for key in ("whisper-tiny/compressed/none",
                    "internvl2-2b/compressed/none",
                    "mamba2-1.3b/compressed/none"):
            if (a[key]["launches"]["encode_pack_quantize"],
                    a[key]["launches"]["dequant_peel_unpack"]) != (steps, steps):
                raise AssertionError(f"dist_model {key}: rank {o['rank']} "
                                     f"launches {a[key]['launches']}")
        if a[moe["compressed"]]["launches"]["encode_pack_quantize"] <= \
                a[moe["none"]]["launches"]["encode_pack_quantize"]:
            raise AssertionError("dist_model: the compressed exchange "
                                 "launched no producer")
        if a[moe["compressed"]]["losses"] != a[moe["dense"]]["losses"] or \
                a[moe["compressed"]]["param_sha256"] != a[moe["dense"]]["param_sha256"]:
            raise AssertionError(f"dist_model: rank {o['rank']}'s compressed "
                                 "exchange differs from the dense exchange")
    for key, arm in arms.items():
        if any(a["losses"] != arm["losses"] for a in
               (o["arms"][key] for o in outs)) or \
                not all(map(math.isfinite, arm["losses"])):
            raise AssertionError(f"dist_model {key}: ranks report different "
                                 "or non-finite losses")
    if not all(rep_equal.values()):
        raise AssertionError(f"dist_model: a replicated leaf's gradient "
                             f"differs across the model ranks: {rep_equal}")
    if max(max(r) for r in rel.values()) > DIST_MODEL_LOSS_RTOL \
            or max(moe_rel) > 1e-2:
        raise AssertionError(f"dist_model: losses off: against the emulated "
                             f"trains and the unsharded loss {rel}, moe "
                             f"{moe_rel}")
    return ({key: {k: sum(o["arms"][key]["launches"][k] for o in outs)
                   for k in outs[0]["arms"][key]["launches"]}
             for key in outs[0]["arms"]}, [o["serve"] for o in outs])


# ----------------------------------------------------------------------
# Serving on the grid (dist_serve): the dist_model ranks, after its arms
# ----------------------------------------------------------------------

# (name, arch, depth (None: whole), dtype, global batch, prompt, new) of
# each arm, in order. The f32 arms are held to the unsharded engine; the
# bf16 arm (granite whole) is timed, its tokens counted against the
# unsharded engine's
DIST_SERVE_ARMS = (
    ("granite_b8", "granite-3-2b", 4, "float32", 8, 512, 16),
    ("granite_b1", "granite-3-2b", 4, "float32", 1, 4096, 16),
    ("mamba2", "mamba2-1.3b", SSM_TRAIN_LAYERS, "float32", 8, 512, 16),
    ("deepseek", "deepseek-moe-16b", 1, "float32", 8, 512, 16),
    ("whisper", "whisper-tiny", None, "float32", 8, ENCDEC_PROMPT, 16),
    ("granite_bf16", "granite-3-2b", None, "bfloat16", 8, 512, 16))
# the f32 grid's logits and prefill caches against the unsharded engine's
# on the same card: the same f32 math summed in other orders (the
# row-parallel sums and the decode combine over the ranks), so a
# few ulps of the logits' max; a reduction missed or doubled moves them
# by its whole size. The bound is the reference's decode-consistency one
# (``tests/test_decode_consistency.py``)
DIST_SERVE_ATOL = 2e-3
for _atol in (ATTN_LOGITS_ATOL, SSM_LOGITS_ATOL, ENCDEC_LOGITS_ATOL):
    _atol["grid_f32"] = DIST_SERVE_ATOL


def dist_serve_cfg(arch_name, layers, dtype):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch_name).model
    return dataclasses.replace(cfg, dtype=dtype,
                               n_layers=layers or cfg.n_layers)


def dist_serve_inputs(cfg, B, prompt):
    """Prompts from seed 0, and the encdec family's frames after them."""
    import numpy as np
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, cfg.vocab, (B, prompt), dtype=np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)
                                     ).astype(np.float32)
    return batch


def dist_serve_max_len(cfg, prompt, new):
    return ENCDEC_SEQ if cfg.family == "encdec" else prompt + new


def dist_serve_reference(dev):
    """The unsharded engine on the card for every ``dist_serve`` arm:
    ``ServeEngine.prefill`` and ``decode`` as ``generate`` calls them
    (greedy), from the arm's seed-0 weights and prompts. Writes each
    arm's tokens, and for the f32 arms each step's logits and the cache
    after the prefill, to a directory under ``build/`` -> its path."""
    import tempfile
    import torch
    from repro_torch.models.params import flatten_tree
    from repro_torch.models.registry import model_api
    from repro_torch.serve import ServeEngine

    (ROOT / "build").mkdir(exist_ok=True)
    ref_dir = tempfile.mkdtemp(prefix="dist_serve_", dir=ROOT / "build")
    for name, arch_name, layers, dtype, B, prompt, new in DIST_SERVE_ARMS:
        cfg = dist_serve_cfg(arch_name, layers, dtype)
        api = model_api(cfg)
        batch = dist_serve_inputs(cfg, B, prompt)
        extra = {k: v for k, v in batch.items() if k != "tokens"} or None
        eng = ServeEngine(api, api.init(0, dev),
                          max_len=dist_serve_max_len(cfg, prompt, new), batch=B)
        logits, cache = eng.prefill(batch["tokens"], extra)
        out = {"logits": [], "tokens": []}
        if dtype == "float32":
            # copies: decode updates the cache in place
            out["cache0"] = {"/".join(p): t.to("cpu", copy=True)
                             for p, t in flatten_tree(cache)}
        tok = logits.argmax(dim=-1)
        for i in range(new + 1):
            if dtype == "float32":
                out["logits"].append(logits.cpu())
            out["tokens"].append(tok.cpu())
            if i == new:
                break
            logits, cache = eng.decode(tok, cache, prompt + i)
            tok = logits.argmax(dim=-1)
        torch.save(out, f"{ref_dir}/{name}.pt")
        del eng, cache, logits, out
        torch.cuda.empty_cache()
    return ref_dir


class ServeLogMesh:
    """``mesh`` (a ``RankMesh``) with each group the serve steps ask for
    wrapped in a :class:`ModelAxisLog`, its calls named by the group's
    axes."""

    def __init__(self, mesh):
        self.mesh, self.shape, self.coords = mesh, mesh.shape, mesh.coords
        self.logs = {}

    def group(self, axes):
        g = self.mesh.group(axes)
        if g is None:
            return None
        key = "+".join(a for a in axes if self.shape.get(a, 1) > 1)
        if key not in self.logs:
            log = ModelAxisLog(g)
            log._label = lambda op, key=key: f"{key}:{op}"
            self.logs[key] = log
        return self.logs[key]

    def end_step(self):
        for log in self.logs.values():
            log.end_step()


def _tree_bytes(tree):
    from repro_torch.models.params import flatten_tree
    return sum(t.numel() * t.element_size() for _, t in flatten_tree(tree))


def _dist_serve_arm(mesh, dev, ref_dir, arm):
    """One ``dist_serve`` arm on this rank: the whole weights from seed 0
    cut to its shards, the prefill and the greedy decode steps through
    the grid's serve steps (the launch counters zeroed just before and
    read just after), timed; held against the unsharded run's file."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.params import flatten_tree
    from repro_torch.models.registry import model_api
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import steps as st

    name, arch_name, layers, dtype, B, prompt, new = arm
    cfg = dist_serve_cfg(arch_name, layers, dtype)
    prof = get_arch(arch_name).profile
    api = model_api(cfg)
    torch.cuda.empty_cache()
    params = st.shard_params(api.init(0, dev), prof, mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in dist_serve_inputs(cfg, B, prompt).items()}
    batch["tokens"] = batch["tokens"].long()
    max_len = dist_serve_max_len(cfg, prompt, new)
    log = ServeLogMesh(mesh)
    prefill = st.build_prefill_step(api, prof, log, max_len)
    decode = st.build_decode_step(api, prof, log)
    ref = torch.load(f"{ref_dir}/{name}.pt")
    bspec = shd.batch_pspec(B, mesh.shape, prof)

    def rows(x):
        return shd.shard_leaf(x, bspec, mesh.shape, mesh.coords)

    held = dtype == "float32"
    errs, steps_ms, toks = [], [], []
    zero_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out = {"prefill_ms": prefill_ms,
           "param_bytes": _tree_bytes(params), "cache_bytes": _tree_bytes(cache)}
    if held:
        sh = st.serve_shardings(api, prof, mesh, B, max(max_len, prompt))
        specs = dict(flatten_tree(sh["cache"]))
        out["cache_max_err"] = max(
            float((t.float() - shd.shard_leaf(ref["cache0"]["/".join(p)],
                                              specs[p], mesh.shape,
                                              mesh.coords).to(dev).float()
                   ).abs().max()) for p, t in flatten_tree(cache))
    if cfg.family in ("ssm", "hybrid"):
        out["conv_sha256"] = [hashlib.sha256(
            t.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
            for p, t in flatten_tree(cache) if p[-1] == "conv"]
    torch.cuda.reset_peak_memory_stats(dev)
    tok = st.gather_batch(logits.argmax(-1), prof, mesh, B)
    for i in range(new + 1):
        if held:
            errs.append(float((logits - rows(ref["logits"][i].to(dev)))
                              .abs().max()))
        toks.append(tok.cpu())
        if i == new:
            break
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = decode(params, tok, cache, prompt + i)
        tok = st.gather_batch(logits.argmax(-1), prof, mesh, B)
        torch.cuda.synchronize(dev)
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        log.end_step()
    out["launches"] = read_launches("dist_serve")
    tokens = torch.stack(toks).numpy()
    want = torch.stack(ref["tokens"]).numpy()
    out.update(
        decode_ms=steps_ms, decode_peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
        tokens_equal=bool(np.array_equal(tokens, want)),
        tokens_equal_count=int((tokens == want).sum()), tokens_total=int(want.size),
        tokens_sha256=hashlib.sha256(tokens.astype(np.int32).tobytes()).hexdigest())
    if held:
        out["logits_max_err"] = max(errs)
        out["logits_max_abs"] = max(logits_max_abs(r, cfg.vocab)
                                    for r in ref["logits"])
    if cfg.family in ("ssm", "hybrid"):
        out["conv_sha256_end"] = [hashlib.sha256(
            t.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
            for p, t in flatten_tree(cache) if p[-1] == "conv"]
    out["collectives"] = {key: replay_collectives(lg, lg.step_calls, dev,
                                                  staging=True)
                          for key, lg in sorted(log.logs.items())
                          if lg.step_calls}
    del params, cache, logits, ref
    torch.cuda.empty_cache()
    return out


def dist_serve_rank(mesh, dev, ref_dir):
    """Every ``dist_serve`` arm on this rank of the grid, in turn; rank 0
    polls the card's used memory over each arm."""
    import threading
    out = {}
    for arm in DIST_SERVE_ARMS:
        stop, card = threading.Event(), [0]
        poller = threading.Thread(target=_card_peak, args=(stop, card),
                                  daemon=True)
        if mesh.rank == 0:
            poller.start()
        try:
            out[arm[0]] = _dist_serve_arm(mesh, dev, ref_dir, arm)
        finally:
            stop.set()
            if poller.is_alive():
                poller.join()
        out[arm[0]]["card_peak_used_bytes"] = card[0] if mesh.rank == 0 else None
    return out


def phase_dist_serve(dev, outs, ref_dir):
    """Serving on the grid of ``dist_model``'s ranks (2 data x 2 model,
    host-staged gloo on one card), through ``serve.steps``'
    ``build_prefill_step`` / ``build_decode_step`` at full width: the
    arms of :data:`DIST_SERVE_ARMS` (granite-3-2b at depth 4 in f32 with
    B 8 x 512, the batch over ``data`` and the sequence over ``model``,
    and B 1 x 4,096, the sequence over all four ranks; mamba2-1.3b at
    depth 12, deepseek-moe-16b at depth 1 and whisper-tiny whole in f32;
    granite whole in bf16 for the times), 16 greedy tokens each. Fails
    unless on every rank each f32 arm's tokens equal the unsharded
    engine's (``dist_serve_reference``, the same call), its logits at
    every step and its cache block after the prefill lie within
    ``SERVE_LOGITS_ATOL[arch]["grid_f32"]`` of the engine's, Mamba's
    conv state is the same bytes on the model ranks of a data index, and
    no codec kernel launched. Prints, beside the card's name and power
    limit: prefill ms, decode ms a step against the bound of the four
    ranks' weights and caches at 3.35 TB/s, the model axis's and the
    combine's collectives a rank a step replayed alone (ms and bytes),
    peak memory a rank and the card's, for the bf16 arm how many of its
    tokens equal the engine's; and the dry run's ``argument_bytes`` and
    peak for the granite f32 B 8 arm's decode on rank 0, against what the
    rank held and its peak."""
    import shutil
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import model_api
    from repro_torch.configs import get_arch

    smi = smi_line()
    shutil.rmtree(ref_dir, ignore_errors=True)
    arms, bad = {}, []
    for name, arch_name, layers, dtype, B, prompt, new in DIST_SERVE_ARMS:
        per = [o[name] for o in outs]
        held = dtype == "float32"
        nbytes = sum(a["param_bytes"] + a["cache_bytes"] for a in per)
        decode_ms = [statistics.median(a["decode_ms"]) for a in per]
        arm = {"arch": arch_name, "layers": layers or "whole", "dtype": dtype,
               "batch": B, "prompt": prompt, "new": new,
               "prefill_ms_by_rank": [a["prefill_ms"] for a in per],
               "decode_ms_median_by_rank": decode_ms,
               "decode_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "decode_bound_bytes": nbytes,
               "param_bytes_by_rank": [a["param_bytes"] for a in per],
               "cache_bytes_by_rank": [a["cache_bytes"] for a in per],
               "decode_peak_mem_bytes_by_rank": [a["decode_peak_mem_bytes"]
                                                 for a in per],
               "card_peak_used_bytes": per[0]["card_peak_used_bytes"],
               "collectives_rank0": {
                   k: {"calls": v["calls"], "payload_bytes": v["payload_bytes"],
                       "bytes_per_step": v["payload_bytes_total"],
                       "ms_median": v["ms_median"],
                       "ms_median_by_op": v["ms_median_by_op"],
                       "staging_copies_ms_median": v["staging_copies_ms_median"]}
                   for k, v in per[0]["collectives"].items()},
               "tokens_equal_by_rank": [a["tokens_equal"] for a in per],
               "tokens_equal_count": per[0]["tokens_equal_count"],
               "tokens_total": per[0]["tokens_total"]}
        if held:
            atol = SERVE_LOGITS_ATOL[arch_name]["grid_f32"]
            arm.update(atol=atol,
                       logits_max_err_by_rank=[a["logits_max_err"] for a in per],
                       logits_max_abs=per[0]["logits_max_abs"],
                       cache_max_err_by_rank=[a["cache_max_err"] for a in per])
            for r, a in enumerate(per):
                if not a["tokens_equal"] or a["logits_max_err"] > atol \
                        or a["cache_max_err"] > atol:
                    bad.append((name, r, a["tokens_equal"], a["logits_max_err"],
                                a["cache_max_err"]))
        if "conv_sha256" in per[0]:
            same = all(per[r]["conv_sha256"] == per[r - r % MODEL_PARALLEL]
                       ["conv_sha256"] and per[r]["conv_sha256_end"]
                       == per[r - r % MODEL_PARALLEL]["conv_sha256_end"]
                       for r in range(len(per)))
            arm["conv_state_equal_across_model_ranks"] = same
            if not same:
                bad.append((name, "conv state differs across the model ranks"))
        if any(any(a["launches"].values()) for a in per):
            bad.append((name, "launched a codec kernel"))
        arms[name] = arm
    # the dry run's figures for the granite f32 B 8 arm's decode, rank 0
    name, arch_name, layers, dtype, B, prompt, new = DIST_SERVE_ARMS[0]
    cfg = dist_serve_cfg(arch_name, layers, dtype)
    rec = dryrun.trace_serve(model_api(cfg), get_arch(arch_name).profile,
                             dryrun.RecordingMesh({"data": WORKERS,
                                                   "model": MODEL_PARALLEL}),
                             "decode", B, dist_serve_max_len(cfg, prompt, new))
    r0 = outs[0][name]
    emit({"phase": "dist_serve", "card": smi,
          "grid": {"data": WORKERS, "model": MODEL_PARALLEL},
          "arms": arms,
          "dryrun_granite_b8_decode": {
              "argument_bytes": rec["memory"]["argument_bytes"],
              "peak_per_device_gib": rec["memory"]["peak_per_device_gib"],
              "rank0_param_plus_cache_bytes": r0["param_bytes"] + r0["cache_bytes"],
              "rank0_decode_peak_mem_gib": r0["decode_peak_mem_bytes"] / 2**30,
              "collectives": rec["collectives"]}})
    if bad:
        raise AssertionError(f"dist_serve: {bad}")
    return {k: 0 for k in outs[0][DIST_SERVE_ARMS[0][0]]["launches"]}


PHASE_SECONDS = {}      # wall seconds of each phase (or group), in order


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept under ``name`` and
    printed on a line of their own."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    emit({"phase_seconds": name, "seconds": PHASE_SECONDS[name]})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.config import CompressionConfig
    from repro_torch.kernels import build

    t_main = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    t0 = time.perf_counter()
    build.load_all()     # one nvcc a source, all started together
    PHASE_SECONDS["build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": PHASE_SECONDS["build"],
          "ptxas": {k: v["ptxas"] for k, v in build.BUILD_LOG.items()}})

    cfg = CompressionConfig(ratio=0.1, topk_ratio=0.04)
    bloom_fields = {"index": "bloom", "topk_ratio": 0.001}
    cfg_bloom = dataclasses.replace(cfg, **bloom_fields)
    check = Checker()
    timed("kernels", phase_kernels, cfg, dev, check)
    timed("kernels_q", phase_kernels_q, cfg, dev, check)
    timed("kernels_std", phase_kernels_std, cfg_bloom, dev, check)
    a2a = timed("kernels_a2a", phase_kernels_a2a, dev, check)
    torch.cuda.empty_cache()

    train, launches, api, tc, state = timed("train", phase_train, dev)
    shapes_dtypes = [(tuple(p.shape), p.dtype) for p in state.params.leaves()]
    consumer_ms = timed("breakdown", phase_breakdown, api, tc, state,
                        train["step_ms"], dev)["stages_ms"]["consumer"]["per_call"]
    del state
    torch.cuda.empty_cache()
    timed("adam_update", phase_adam_update, dev)
    torch.cuda.empty_cache()
    innet, launches_innet, _, tc_innet, state = timed(
        "innet_train", phase_train, dev, phase="innet_train", wire="fxp32")
    timed("innet_breakdown", phase_breakdown, api, tc_innet, state,
          innet["step_ms"], dev, phase="innet_breakdown")
    del state
    torch.cuda.empty_cache()
    bloom, launches_bloom, _, tc_bloom, state = timed(
        "bloom_train", phase_train, dev, phase="bloom_train", fields=bloom_fields)
    timed("bloom_breakdown", phase_breakdown, api, tc_bloom, state,
          bloom["step_ms"], dev, phase="bloom_breakdown")
    del state
    torch.cuda.empty_cache()
    launches_stream = timed("stream_train", phase_stream_train, dev,
                            tc.compression, train, innet, shapes_dtypes)
    torch.cuda.empty_cache()
    launches_rs, rs_arms = timed("rs_train", phase_rs_train, dev, tc.compression,
                                 train, shapes_dtypes, consumer_ms)
    torch.cuda.empty_cache()
    # one spawn runs the rank work of every dist_* phase but dist_ckpt;
    # each phase then checks its own ranks' results
    ranks, dist_wall, dist_ckpt_dir = timed(
        "dist_spawn", spawn_dist, shapes_dtypes,
        cfg.num_buckets(train["params"]), train["params"])
    launches_dist, link = timed("dist_train", phase_dist_train,
                                train["losses"], ranks["dist_train"], dist_wall)
    launches_dist_rs = timed("dist_rs", phase_dist_rs, tc.compression, rs_arms,
                             train, shapes_dtypes, ranks["dist_rs"], dist_wall)
    n = train["params"]
    n_blocks = cfg.num_buckets(n) * cfg.bucket_elems_for(n) // cfg.block_elems
    recs = timed("main_stream", phase_main_stream, cfg, dev, n_blocks, check)
    recs_q, payload = timed("innet_stream", phase_innet_stream, cfg, dev, n,
                            check)
    timed("switch", phase_switch, payload, cfg.switch_slots)
    del payload
    torch.cuda.empty_cache()
    recs += recs_q + timed("bloom_stream", phase_bloom_stream, cfg_bloom, dev,
                           n_blocks, check)
    torch.cuda.empty_cache()
    # the codec's rate: the stream's bytes over the mean of the producer's
    # and the consumer's full-stream times (main_stream)
    codec_ms = statistics.mean(r["ms"] for r in recs if r["name"] in (
        "encode_pack_quantize", "dequant_peel_unpack"))
    launches_auto, auto_digests = timed(
        "auto_train", phase_auto_train, dev, train, shapes_dtypes,
        codec_bps=n_blocks * cfg.block_elems * 4 / (codec_ms / 1e3),
        link_bps=link["bytes"] / (link["ms"] / 1e3))
    torch.cuda.empty_cache()
    launches_dist_auto = timed("dist_auto", phase_dist_auto,
                               cfg.num_buckets(n), auto_digests,
                               ranks["dist_auto"], dist_wall)
    torch.cuda.empty_cache()
    launches_moe, (moe_line, moe_api, moe_tc, state) = timed(
        "moe_train", phase_moe_train, dev)
    timed("moe_breakdown", phase_moe_breakdown, moe_api, moe_tc, state,
          moe_line["step_ms"], dev)
    del state
    torch.cuda.empty_cache()
    launches_dist_a2a = timed("dist_a2a", phase_dist_a2a, ranks["dist_a2a"],
                              dist_wall)
    torch.cuda.empty_cache()
    elastic_k = timed("kernels_elastic", phase_kernels_elastic, dev, check, n)
    launches_elastic = timed("elastic", phase_elastic, dev, n)
    torch.cuda.empty_cache()
    launches_remat = timed("remat", phase_remat, dev, train, moe_line)
    torch.cuda.empty_cache()
    launches_ckpt = timed("ckpt_train", phase_ckpt_train, dev, train)
    torch.cuda.empty_cache()
    launches_dist_ckpt = timed("dist_ckpt", phase_dist_ckpt, dev, train,
                               ranks["dist_ckpt"], dist_ckpt_dir, dist_wall)
    torch.cuda.empty_cache()
    launches_serve = {"serve": timed("serve", serve_model, dev, "granite-3-2b",
                                     "serve", True)}
    torch.cuda.empty_cache()
    launches_serve["serve_moe"] = timed("serve_moe", serve_model, dev,
                                        "deepseek-moe-16b", "serve_moe", False)
    torch.cuda.empty_cache()
    launches_serve["serve_consistency"] = timed(
        "serve_consistency", phase_serve_consistency, dev)
    torch.cuda.empty_cache()
    launches_family, family_losses = {}, {"train": train["losses"]}
    launches_family["ssm_train"], family_losses["ssm_train"] = timed(
        "ssm_train", phase_family_train, dev, check, "ssm_train", SSM_ARCH,
        SSM_TRAIN_LAYERS)
    launches_family["vlm_train"], family_losses["vlm_train"] = timed(
        "vlm_train", phase_family_train, dev, check, "vlm_train", VLM_ARCH,
        VLM_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    launches_serve["ssm_serve"] = timed("ssm_serve", serve_model, dev, SSM_ARCH,
                                        "ssm_serve", True,
                                        layers=SSM_SERVE_LAYERS)
    torch.cuda.empty_cache()
    launches_serve["hybrid_serve"] = timed(
        "hybrid_serve", serve_model, dev, HYBRID_ARCH, "hybrid_serve", False,
        layers=HYBRID_SERVE_LAYERS)
    torch.cuda.empty_cache()
    launches_family["encdec_train"], family_losses["encdec_train"] = timed(
        "encdec_train", phase_family_train, dev, check, "encdec_train",
        ENCDEC_ARCH, ENCDEC_LAYERS, seq=ENCDEC_SEQ, timed=True)
    torch.cuda.empty_cache()
    launches_serve["encdec_serve"] = timed(
        "encdec_serve", serve_model, dev, ENCDEC_ARCH, "encdec_serve", False,
        prompt_len=ENCDEC_PROMPT, max_len=ENCDEC_SEQ)
    torch.cuda.empty_cache()
    serve_ref_dir = timed("dist_serve_ref", dist_serve_reference, dev)
    torch.cuda.empty_cache()
    launches_dist_model, serve_outs = timed("dist_model", phase_dist_model, dev,
                                            family_losses, serve_ref_dir)
    torch.cuda.empty_cache()
    launches_serve["dist_serve"] = timed("dist_serve", phase_dist_serve, dev,
                                         serve_outs, serve_ref_dir)
    launches_long = timed("long_train", phase_long_train, dev)
    torch.cuda.empty_cache()
    launches_serve["long_serve"] = timed("long_serve", phase_long_serve, dev)
    torch.cuda.empty_cache()
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
            "dist_a2a": launches_dist_a2a[r["name"]],
            **{f"elastic/{k}": v[r["name"]] for k, v in launches_elastic.items()},
            **{f"remat/{k}": v[r["name"]] for k, v in launches_remat.items()},
            "ckpt_train": launches_ckpt[r["name"]],
            **{k: v[r["name"]] for k, v in launches_family.items()},
            "long_train": launches_long[r["name"]],
            **{f"dist_ckpt/{k}": v.get(r["name"], 0)
               for k, v in launches_dist_ckpt.items()},
            **{k: v[r["name"]] for k, v in launches_serve.items()},
            **{f"dist_model/{k}": v[r["name"]]
               for k, v in launches_dist_model.items()}}
        if r["name"] in a2a:
            r["a2a"] = a2a[r["name"]]
        if r["name"] in elastic_k:
            r["elastic"] = elastic_k[r["name"]]
    timed("lossless", phase_lossless, api.cfg, tc, dev)
    timed("innet_lossless", phase_innet_lossless, api.cfg, dev)
    timed("bloom_lossless", phase_bloom_lossless, api.cfg, dev)

    emit({"phase_seconds_all": PHASE_SECONDS,
          "total_s": time.perf_counter() - t_main})
    emit({"kernels": recs})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
