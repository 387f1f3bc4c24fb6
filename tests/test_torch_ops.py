"""Dispatch rules of ``repro_torch.kernels.ops`` and the CUDA kernels
against their plain versions.

The dispatch tests run anywhere. The kernel tests carry the ``cuda``
marker and skip without a CUDA device (the kernels exist only on the
card); on a machine with one they run with

    PYTHONPATH=src python -m pytest tests/test_torch_ops.py -m cuda

This file imports no JAX, so it runs where only PyTorch is installed.
Kernel vs plain: dyadic inputs bit for bit (every sum exact in any
order); Gaussian inputs to rtol=1e-5, atol=1e-6 (the plain encode
sums in the kernels' order on every device, so the encodes agree bit
for bit, as ``tests/test_torch_plain_cuda.py`` holds); words and
residual masks exactly on every input (they depend on integers only).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import index as index_lib
from repro_torch.core.compressor import HomomorphicCompressor
from repro_torch.core.config import CompressionConfig
from repro_torch.kernels import ops, ref
from repro_torch.net.fixedpoint import FixedPointWire, pow2

CFGS = [
    CompressionConfig(ratio=0.2, lanes=128, rows=6, rounds=8),
    CompressionConfig(ratio=0.1, lanes=256, rows=12, rounds=8),
    CompressionConfig(ratio=0.5, lanes=512, rows=6, rounds=8),
    CompressionConfig(ratio=0.1, topk_ratio=0.04),      # the main path's
    # state larger than shared memory: the kernels keep it in device memory
    CompressionConfig(ratio=2.0, rows=60),   # lossless profile: the consumer
    CompressionConfig(ratio=0.05, rows=6),   # G=120: producer and consumer
]
IDS = [f"l{c.lanes}r{c.rows}g{c.group}" for c in CFGS]
# the standalone encode and peel also take block_elems % 32 != 0
STD_CFGS = CFGS + [CompressionConfig(ratio=0.2, lanes=100, rows=6, rounds=8),
                   CompressionConfig(ratio=0.1, lanes=500, rows=6)]
STD_IDS = [f"l{c.lanes}r{c.rows}g{c.group}" for c in STD_CFGS]


def blocks(cfg, nb, frac, seed, kind="dyadic"):
    r = np.random.default_rng(seed)
    n = nb * cfg.block_elems
    x = np.zeros(n, np.float32)
    k = max(1, int(n * frac))
    idx = r.choice(n, size=k, replace=False)
    if kind == "dyadic":
        x[idx] = r.choice([-1.0, 1.0], size=k) * np.exp2(r.integers(-2, 3, size=k))
    else:
        x[idx] = r.normal(size=k)
    return torch.from_numpy(x.reshape(nb, cfg.group, cfg.lanes))


def ids_for(nb, offset=37, device="cpu"):
    return torch.arange(nb, dtype=torch.int32, device=device) + offset


# ----------------------------------------------------------------------
# Dispatch (any machine)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["auto", "never"])
def test_cpu_tensors_take_the_plain_version(policy):
    cfg = dataclasses.replace(CFGS[0], use_pallas=policy)
    xb, ids = blocks(cfg, 3, 0.05, 1), ids_for(3)
    before = dict(ops.LAUNCHES)
    got = ops.encode_pack_quantize(xb, ids, cfg)
    want = ref.encode_pack_quantize_ref(xb, ids, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    v, r = ops.dequant_peel_unpack(got[0], got[1], ids, cfg)
    v2, r2 = ref.dequant_peel_unpack_ref(want[0], want[1], ids, cfg)
    assert torch.equal(v, v2) and torch.equal(r, r2)
    assert ops.LAUNCHES == before, "a CPU call must not count a kernel launch"


def test_always_on_cpu_raises():
    cfg = dataclasses.replace(CFGS[0], use_pallas="always")
    xb, ids = blocks(cfg, 1, 0.05, 2), ids_for(1)
    with pytest.raises(ValueError, match="CUDA"):
        ops.encode_pack_quantize(xb, ids, cfg)
    sk, w, _ = ref.encode_pack_quantize_ref(xb, ids, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        ops.dequant_peel_unpack(sk, w, ids, cfg)


def test_exponents_on_the_kernel_path_raise(monkeypatch):
    """Where the kernel path is taken (a CUDA tensor), malformed
    ``exponents`` raise in the wrapper before anything is built or
    launched: they must be (nb,) int32, with 2 <= mantissa_bits <= 30."""
    monkeypatch.setattr(ops, "_use_kernel", lambda cfg, t: True)
    cfg = CFGS[0]
    xb, ids = blocks(cfg, 2, 0.05, 3), ids_for(2)
    sk, w, _ = ref.encode_pack_quantize_ref(xb, ids, cfg)
    q = sk.to(torch.int32)
    before = dict(ops.LAUNCHES)
    for exps, mbits, err in [
            (torch.zeros(2, dtype=torch.int64), 29, TypeError),
            (torch.zeros(3, dtype=torch.int32), 29, ValueError),
            (torch.zeros(2, dtype=torch.int32), 31, ValueError)]:
        with pytest.raises(err):
            ops.encode_pack_quantize(xb, ids, cfg, exponents=exps,
                                     mantissa_bits=mbits)
        with pytest.raises(err):
            ops.dequant_peel_unpack(q, w, ids, cfg, exponents=exps,
                                    mantissa_bits=mbits)
    with pytest.raises(TypeError, match="int32"):   # an f32 sketch on the dq leg
        ops.dequant_peel_unpack(sk, w, ids, cfg,
                                exponents=torch.zeros(2, dtype=torch.int32),
                                mantissa_bits=29)
    assert ops.LAUNCHES == before


def test_exponents_reach_the_kernel_wrappers(monkeypatch):
    """On the kernel path ``exponents`` and ``mantissa_bits`` go to the
    CUDA wrappers (the quantize and dequant legs), unchanged."""
    monkeypatch.setattr(ops, "_use_kernel", lambda cfg, t: True)
    seen = {}

    def spy(name):
        def wrapper(*args, **kw):
            seen[name] = (args, kw)
            return name
        return wrapper

    monkeypatch.setattr(ops, "encode_pack_quantize_cuda", spy("producer"))
    monkeypatch.setattr(ops, "dequant_peel_unpack_cuda", spy("consumer"))
    cfg = CFGS[0]
    xb, ids = blocks(cfg, 2, 0.05, 3), ids_for(2)
    sk, w, _ = ref.encode_pack_quantize_ref(xb, ids, cfg)
    exps = torch.tensor([-3, 5], dtype=torch.int32)
    assert ops.encode_pack_quantize(xb, ids, cfg, exponents=exps,
                                    mantissa_bits=29) == "producer"
    assert ops.dequant_peel_unpack(sk.to(torch.int32), w, ids, cfg,
                                   exponents=exps, mantissa_bits=29) == "consumer"
    for name in ("producer", "consumer"):
        args, kw = seen[name]
        assert kw["exponents"] is exps and kw["mantissa_bits"] == 29
        assert args[-1] is cfg
    ops.encode_pack_quantize(xb, ids, cfg)
    assert seen["producer"][1] == {"exponents": None, "mantissa_bits": None}


def test_exponents_need_mantissa_bits():
    cfg = CFGS[0]
    xb, ids = blocks(cfg, 1, 0.05, 4), ids_for(1)
    with pytest.raises(ValueError, match="together"):
        ops.encode_pack_quantize(xb, ids, cfg, exponents=torch.zeros(1))


@pytest.mark.parametrize("cfg,supported", [
    (CompressionConfig(), True),
    (CompressionConfig(index="bloom"), False),
    (CompressionConfig(ratio=0.1, lanes=12, rows=3), False),   # 360 % 32 != 0
    (CompressionConfig(ratio=2.0, rows=60), True),             # lossless profile
])
def test_fused_wire_guard(cfg, supported):
    """The fused ops refuse the geometries they do not cover; the
    compressor takes the composed path (standalone encode and peel) for
    those, and recovers a sparse stream exactly."""
    assert ops.fused_wire_supported(cfg) is supported
    if not supported:
        xb = torch.zeros((1, cfg.group, cfg.lanes))
        with pytest.raises(ValueError, match="unsupported"):
            ops.encode_pack_quantize(xb, ids_for(1), cfg)
        x = torch.zeros(4 * cfg.block_elems)   # whole words on the unaligned bitmap
        x[5], x[-3] = 1.0, -2.0
        comp = HomomorphicCompressor(cfg)
        before = dict(ops.LAUNCHES)
        assert torch.equal(comp.recover(comp.compress(x), x.numel()), x)
        assert ops.LAUNCHES == before


def test_wire_codec_passes():
    cfg = CFGS[0]
    assert ops.wire_codec_passes(cfg) == {"producer": 1, "consumer": 1}
    assert ops.wire_codec_passes(cfg, device="cpu") == {"producer": 2, "consumer": 2}
    assert ops.wire_codec_passes(cfg, quantized=True, device="cpu") == \
        {"producer": 3, "consumer": 3}
    never = dataclasses.replace(cfg, use_pallas="never")
    assert ops.wire_codec_passes(never) == {"producer": 2, "consumer": 2}


@pytest.mark.parametrize("policy", ["auto", "never", "always"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_wire_codec_passes_agree_with_dispatch(policy, device):
    """The analytic pass counts follow the dispatch on every device and
    policy: one pass each way where the fused kernel runs, the composed
    plain passes where the plain version runs, and a raise where the
    dispatch raises. Analytic, so the CUDA rows run without a card."""
    cfg = dataclasses.replace(CFGS[0], use_pallas=policy)
    dev = torch.device(device)
    if device == "cpu" and policy == "always":
        with pytest.raises(ValueError, match="CUDA"):
            ops._use_kernel(cfg, dev)
        with pytest.raises(ValueError, match="CUDA"):
            ops.wire_codec_passes(cfg, device=device)
        return
    passes = 1 if ops._use_kernel(cfg, dev) else 2
    assert passes == (1 if device == "cuda" and policy != "never" else 2)
    assert ops.wire_codec_passes(cfg, device=device) == \
        {"producer": passes, "consumer": passes}
    if device == "cpu":          # what the dispatch runs here, counted
        xb, ids = blocks(cfg, 2, 0.05, 6), ids_for(2)
        before = dict(ops.LAUNCHES)
        ops.dequant_peel_unpack(*ops.encode_pack_quantize(xb, ids, cfg)[:2],
                                ids, cfg)
        assert ops.LAUNCHES == before


def test_sketch_estimate_is_the_plain_median():
    cfg = CFGS[0]
    xb, ids = blocks(cfg, 2, 0.03, 5), ids_for(2)
    sk, _, _ = ref.encode_pack_quantize_ref(xb, ids, cfg)
    assert torch.equal(ops.sketch_estimate(sk, ids, cfg),
                       ref.sketch_estimate_ref(sk, ids, cfg))


def candidate_bits(xb, seed):
    """The non-zeros plus ~1% extra candidates, as a Bloom query gives."""
    r = np.random.default_rng(seed)
    extra = torch.from_numpy(r.random(tuple(xb.shape)) < 0.01).to(xb.device)
    return (xb != 0) | extra


@pytest.mark.parametrize("policy", ["auto", "never"])
def test_standalone_ops_on_cpu_take_the_plain_version(policy):
    cfg = dataclasses.replace(STD_CFGS[-2], use_pallas=policy)
    xb, ids = blocks(cfg, 3, 0.05, 11), ids_for(3)
    before = dict(ops.LAUNCHES)
    y = ops.sketch_encode(xb, ids, cfg)
    assert torch.equal(y, ref.sketch_encode_ref(xb, ids, cfg))
    bits = candidate_bits(xb, 11)
    got = ops.sketch_peel(y, bits, ids, cfg)
    want = ref.sketch_peel_ref(y, bits, ids, cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.LAUNCHES == before


def test_standalone_always_on_cpu_raises():
    cfg = dataclasses.replace(STD_CFGS[-2], use_pallas="always")
    xb, ids = blocks(cfg, 1, 0.05, 12), ids_for(1)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sketch_encode(xb, ids, cfg)
    y = ref.sketch_encode_ref(xb, ids, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sketch_peel(y, xb != 0, ids, cfg)


def test_standalone_wrappers_check_inputs_before_launch(monkeypatch):
    """On the kernel path, inputs the kernels do not take raise in the
    wrapper before anything is built or launched."""
    monkeypatch.setattr(ops, "_use_kernel", lambda cfg, t: True)
    cfg = STD_CFGS[-2]
    xb, ids = blocks(cfg, 2, 0.05, 13), ids_for(2)
    y = ref.sketch_encode_ref(xb, ids, cfg)
    before = dict(ops.LAUNCHES)
    with pytest.raises(TypeError, match="float"):
        ops.sketch_encode(xb.double(), ids, cfg)
    with pytest.raises(TypeError, match="int32"):
        ops.sketch_encode(xb, ids.long(), cfg)
    with pytest.raises(ValueError, match="shape"):
        ops.sketch_encode(xb[:, :-1], ids, cfg)
    with pytest.raises(TypeError, match="bool"):
        ops.sketch_peel(y, (xb != 0).int(), ids, cfg)
    with pytest.raises(TypeError, match="float32"):
        ops.sketch_peel(y.double(), xb != 0, ids, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sketch_peel(y, (xb != 0).transpose(1, 2).contiguous().transpose(1, 2),
                        ids, cfg)
    assert ops.LAUNCHES == before


def test_standalone_ops_reach_the_kernel_wrappers(monkeypatch):
    monkeypatch.setattr(ops, "_use_kernel", lambda cfg, t: True)
    monkeypatch.setattr(ops, "sketch_encode_cuda", lambda *a: ("encode", a))
    monkeypatch.setattr(ops, "sketch_peel_cuda", lambda *a: ("peel", a))
    cfg = STD_CFGS[-1]
    xb, ids = blocks(cfg, 1, 0.05, 14), ids_for(1)
    name, args = ops.sketch_encode(xb, ids, cfg)
    assert name == "encode" and args[0] is xb and args[-1] is cfg
    bits = xb != 0
    name, args = ops.sketch_peel(xb, bits, ids, cfg)
    assert name == "peel" and args[1] is bits and args[-1] is cfg


def test_build_lists_every_source():
    from repro_torch.kernels import build
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == \
        sorted(p.name for p in build.SOURCES.values())


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes changes the library's
    name (so the next use rebuilds it); a file it does not include does
    not."""
    import shutil
    from repro_torch.kernels import build
    for f in build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "SOURCES", {
        k: tmp_path / v.name for k, v in build.SOURCES.items()})
    before = {k: build._library_path(k) for k in build.SOURCES}
    assert all(p.parent == build.BUILD_DIR for p in before.values())
    assert [p.name for p in build._included(tmp_path / "sketch_codec.cu")] == \
        ["sketch_codec.cu", "sketch_tile.cuh"]
    (tmp_path / "unrelated.cuh").write_text("// edited\n")
    assert {k: build._library_path(k) for k in build.SOURCES} == before
    header = tmp_path / "sketch_tile.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {k: build._library_path(k) for k in build.SOURCES}
    assert all(after[k] != before[k] for k in ("sketch_wire", "sketch_codec"))


def test_compressor_roundtrip_and_stats_on_cpu():
    cfg = CFGS[2]
    x = blocks(cfg, 4, 0.03, 6).reshape(-1)[:-100]
    comp = HomomorphicCompressor(cfg)
    c = comp.compress(x, block_offset=11)
    rec, stats = comp.recover(c, x.numel(), with_stats=True, block_offset=11)
    assert torch.equal(rec, x)
    assert int(stats.nnz) == int((x != 0).sum())
    assert int(stats.residual) == 0 and int(stats.peeled) == int(stats.nnz)


# ----------------------------------------------------------------------
# CUDA kernels (the card only)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _run_both(cfg, xb, ids):
    sk_r, w_r, mx_r = ref.encode_pack_quantize_ref(xb, ids, cfg)
    sk_k, w_k, mx_k = ops.encode_pack_quantize(xb, ids, cfg)
    v_r, r_r = ref.dequant_peel_unpack_ref(sk_r, w_r, ids, cfg)
    v_k, r_k = ops.dequant_peel_unpack(sk_r, w_r, ids, cfg)
    return (sk_k, w_k, mx_k, v_k, r_k), (sk_r, w_r, mx_r, v_r, r_r)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
@pytest.mark.parametrize("frac", [0.04, 0.4])
def test_kernels_match_plain_dyadic(cuda_dev, cfg, frac):
    xb = blocks(cfg, 5, frac, 7).to(cuda_dev)
    got, want = _run_both(cfg, xb, ids_for(5, 7000, cuda_dev))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_kernels_match_plain_gaussian(cuda_dev, cfg):
    xb = blocks(cfg, 5, 0.04, 8, kind="gauss").to(cuda_dev)
    got, want = _run_both(cfg, xb, ids_for(5, 37, cuda_dev))
    sk_k, w_k, mx_k, v_k, r_k = got
    sk_r, w_r, mx_r, v_r, r_r = want
    torch.testing.assert_close(sk_k, sk_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mx_k, mx_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v_k, v_r, rtol=1e-5, atol=1e-6)
    assert torch.equal(w_k, w_r) and torch.equal(r_k, r_r)


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit_and_count_launches(cuda_dev):
    """No float atomics: the same Gaussian input gives the same bits twice;
    each wrapper call adds exactly one launch."""
    cfg = CFGS[3]
    xb = blocks(cfg, 9, 0.04, 9, kind="gauss").to(cuda_dev)
    ids = ids_for(9, 0, cuda_dev)
    before = dict(ops.LAUNCHES)
    a = ops.encode_pack_quantize(xb, ids, cfg)
    b = ops.encode_pack_quantize(xb, ids, cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = ops.dequant_peel_unpack(a[0], a[1], ids, cfg)
    d = ops.dequant_peel_unpack(a[0], a[1], ids, cfg)
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    assert ops.LAUNCHES["encode_pack_quantize"] == before["encode_pack_quantize"] + 2
    assert ops.LAUNCHES["dequant_peel_unpack"] == before["dequant_peel_unpack"] + 2


@pytest.mark.cuda
def test_cuda_dispatch_rules(cuda_dev):
    """``"never"`` runs the plain version on the card and counts no
    launch; ``"auto"`` still raises where a kernel cannot fit."""
    cfg = dataclasses.replace(CFGS[0], use_pallas="never")
    xb, ids = blocks(cfg, 1, 0.05, 10).to(cuda_dev), ids_for(1, 0, cuda_dev)
    before = dict(ops.LAUNCHES)
    got = ops.encode_pack_quantize(xb, ids, cfg)
    want = ref.encode_pack_quantize_ref(xb, ids, cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ops.dequant_peel_unpack(want[0], want[1], ids, cfg)
    want = ref.dequant_peel_unpack_ref(want[0], want[1], ids, cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].device.type == "cuda"
    assert ops.LAUNCHES == before
    with pytest.raises(TypeError, match="int32"):   # exponents on the card, f32
        ops.encode_pack_quantize(xb, ids, CFGS[0],
                                 exponents=torch.zeros(1, device=cuda_dev),
                                 mantissa_bits=29)
    with pytest.raises(TypeError):
        ops.encode_pack_quantize(xb.double(), ids, CFGS[0])
    huge = CompressionConfig(ratio=0.001, rows=6)   # bits alone > shared memory
    xb = torch.zeros((1, huge.group, huge.lanes), device=cuda_dev)
    sk = torch.zeros((1, huge.rows, huge.lanes), device=cuda_dev)
    w = torch.zeros((1, huge.block_elems // 32), dtype=torch.int32, device=cuda_dev)
    with pytest.raises(ValueError, match="shared memory"):
        ops.dequant_peel_unpack(sk, w, ids, huge)
    never = dataclasses.replace(huge, use_pallas="never")
    got = ops.dequant_peel_unpack(sk, w, ids, never)
    want = ref.dequant_peel_unpack_ref(sk, w, ids, never)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


# ----------------------------------------------------------------------
# the fxp32 legs on the card: quantize producer, dequant consumer
# ----------------------------------------------------------------------

def _two_worker_exponents(cfg, xbs, ids, mbits=29):
    """Per-block W=2 exponents from the kernels' real maxabs, as the
    in-network aggregator agrees on them (FixedPointWire(2), M=29)."""
    wire = FixedPointWire(2)
    assert wire.mantissa_bits == mbits
    mx = [ops.encode_pack_quantize(xb, ids, cfg)[2] for xb in xbs]
    return wire, wire.exponents_from_maxabs(torch.maximum(*mx))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
@pytest.mark.parametrize("frac", [0.04, 0.4])
def test_quantized_legs_match_plain_dyadic(cuda_dev, cfg, frac):
    ids = ids_for(5, 7000, cuda_dev)
    xbs = [blocks(cfg, 5, frac, 20 + s).to(cuda_dev) for s in range(2)]
    wire, e = _two_worker_exponents(cfg, xbs, ids)
    M = wire.mantissa_bits
    qs = []
    for xb in xbs:
        got = ops.encode_pack_quantize(xb, ids, cfg, exponents=e, mantissa_bits=M)
        want = ref.encode_pack_quantize_ref(xb, ids, cfg, exponents=e,
                                            mantissa_bits=M)
        assert got[0].dtype == torch.int32
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        qs.append(got)
    q = qs[0][0] + qs[1][0]
    words = qs[0][1] | qs[1][1]
    got = ops.dequant_peel_unpack(q, words, ids, cfg, exponents=e, mantissa_bits=M)
    want = ref.dequant_peel_unpack_ref(q, words, ids, cfg, exponents=e,
                                       mantissa_bits=M)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_quantized_legs_equal_f32_legs_composed_with_the_wire(cuda_dev, cfg):
    """On Gaussian inputs the quantize leg equals the f32 producer kernel
    followed by ``FixedPointWire.encode``, and the dequant leg equals
    ``decode`` followed by the f32 consumer kernel, bit for bit. Against
    the plain versions: q within one step plus the f32 tolerance
    (rtol=1e-5, atol=1e-6) at the block's scale of the plain q (the plain
    version sums in atomic order, and an ulp of a cell near the block's
    max is 2^(M-24) steps of q), values within rtol=1e-5, atol=1e-6."""
    ids = ids_for(5, 37, cuda_dev)
    xbs = [blocks(cfg, 5, 0.04, 30 + s, kind="gauss").to(cuda_dev) for s in range(2)]
    wire, e = _two_worker_exponents(cfg, xbs, ids)
    M = wire.mantissa_bits
    nb = 5
    qs = []
    for xb in xbs:
        sk, w, mx = ops.encode_pack_quantize(xb, ids, cfg)
        q, wq, mxq = ops.encode_pack_quantize(xb, ids, cfg, exponents=e,
                                              mantissa_bits=M)
        assert torch.equal(q.reshape(nb, -1), wire.encode(sk.reshape(nb, -1), e))
        assert torch.equal(w, wq) and torch.equal(mx, mxq)
        q_plain = ref.encode_pack_quantize_ref(xb, ids, cfg, exponents=e,
                                               mantissa_bits=M)[0]
        steps = ((1e-5 * sk.abs() + 1e-6).reshape(nb, -1)
                 * pow2(M - e)[:, None]).reshape(q.shape)
        assert bool(((q - q_plain).abs() <= steps + 1).all())
        qs.append((q, w))
    q = qs[0][0] + qs[1][0]
    words = qs[0][1] | qs[1][1]
    v, r = ops.dequant_peel_unpack(q, words, ids, cfg, exponents=e, mantissa_bits=M)
    y = wire.decode(q.reshape(nb, -1), e).reshape(q.shape)
    v2, r2 = ops.dequant_peel_unpack(y, words, ids, cfg)
    assert torch.equal(v, v2) and torch.equal(r, r2)
    v3, r3 = ref.dequant_peel_unpack_ref(q, words, ids, cfg, exponents=e,
                                         mantissa_bits=M)
    torch.testing.assert_close(v, v3, rtol=1e-5, atol=1e-6)
    assert torch.equal(r, r3)


@pytest.mark.cuda
def test_quantized_legs_count_their_own_launches(cuda_dev):
    cfg = CFGS[3]
    xb = blocks(cfg, 3, 0.04, 40).to(cuda_dev)
    ids = ids_for(3, 0, cuda_dev)
    e = torch.zeros(3, dtype=torch.int32, device=cuda_dev)
    before = dict(ops.LAUNCHES)
    q, w, _ = ops.encode_pack_quantize(xb, ids, cfg, exponents=e, mantissa_bits=29)
    ops.dequant_peel_unpack(q, w, ids, cfg, exponents=e, mantissa_bits=29)
    after = dict(ops.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "encode_pack_quantize": 0, "dequant_peel_unpack": 0,
        "encode_pack_quantize_q": 1, "dequant_peel_unpack_dq": 1,
        "sketch_encode": 0, "sketch_peel": 0,
        "adam_update": 0}


# ----------------------------------------------------------------------
# the standalone encode and peel on the card (Bloom / unaligned geometries)
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cfg", STD_CFGS, ids=STD_IDS)
@pytest.mark.parametrize("frac", [0.04, 0.4])
def test_standalone_kernels_match_plain_dyadic(cuda_dev, cfg, frac):
    xb = blocks(cfg, 5, frac, 50).to(cuda_dev)
    ids = ids_for(5, 7000, cuda_dev)
    y = ops.sketch_encode(xb, ids, cfg)
    assert torch.equal(y, ref.sketch_encode_ref(xb, ids, cfg))
    bits = candidate_bits(xb, 50)
    want = ref.sketch_peel_ref(y, bits, ids, cfg)
    for b in (bits, bits.to(torch.uint8)):
        got = ops.sketch_peel(y, b, ids, cfg)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", STD_CFGS, ids=STD_IDS)
def test_standalone_kernels_match_plain_gaussian(cuda_dev, cfg):
    xb = blocks(cfg, 5, 0.04, 51, kind="gauss").to(cuda_dev)
    ids = ids_for(5, 37, cuda_dev)
    y = ops.sketch_encode(xb, ids, cfg)
    torch.testing.assert_close(y, ref.sketch_encode_ref(xb, ids, cfg),
                               rtol=1e-5, atol=1e-6)
    bits = candidate_bits(xb, 51)
    v, r = ops.sketch_peel(y, bits, ids, cfg)
    v2, r2 = ref.sketch_peel_ref(y, bits, ids, cfg)
    torch.testing.assert_close(v, v2, rtol=1e-5, atol=1e-6)
    assert torch.equal(r, r2)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_standalone_kernels_equal_fused_bit_for_bit(cuda_dev, cfg):
    """Gaussian inputs (sums not exact): the standalone encode equals the
    fused producer's sketch, and the standalone peel the fused consumer on
    the packed words of the same bits, bit for bit."""
    xb = blocks(cfg, 5, 0.04, 52, kind="gauss").to(cuda_dev)
    ids = ids_for(5, 37, cuda_dev)
    sk, _, _ = ops.encode_pack_quantize(xb, ids, cfg)
    assert torch.equal(ops.sketch_encode(xb, ids, cfg), sk)
    bits = candidate_bits(xb, 52)
    words = index_lib.pack_bits(bits).reshape(5, -1)
    got = ops.sketch_peel(sk, bits, ids, cfg)
    want = ops.dequant_peel_unpack(sk, words, ids, cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_standalone_kernels_repeat_and_count_launches(cuda_dev):
    cfg = STD_CFGS[-1]
    xb = blocks(cfg, 9, 0.04, 53, kind="gauss").to(cuda_dev)
    ids = ids_for(9, 0, cuda_dev)
    bits = candidate_bits(xb, 53)
    before = dict(ops.LAUNCHES)
    a, b = (ops.sketch_encode(xb, ids, cfg) for _ in range(2))
    assert torch.equal(a, b)
    c, d = (ops.sketch_peel(a, bits, ids, cfg) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    after = dict(ops.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "encode_pack_quantize": 0, "dequant_peel_unpack": 0,
        "encode_pack_quantize_q": 0, "dequant_peel_unpack_dq": 0,
        "sketch_encode": 2, "sketch_peel": 2,
        "adam_update": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_standalone_encode_takes_half_precision(cuda_dev, dtype):
    cfg = STD_CFGS[-2]
    xb = blocks(cfg, 3, 0.05, 54).to(cuda_dev)     # dyadic: exact in both
    ids = ids_for(3, 0, cuda_dev)
    assert torch.equal(ops.sketch_encode(xb.to(dtype), ids, cfg),
                       ops.sketch_encode(xb, ids, cfg))


@pytest.mark.cuda
def test_standalone_cuda_dispatch_rules(cuda_dev):
    """As ``test_cuda_dispatch_rules``, for the standalone encode and
    peel."""
    cfg = dataclasses.replace(STD_CFGS[-2], use_pallas="never")
    xb, ids = blocks(cfg, 1, 0.05, 55).to(cuda_dev), ids_for(1, 0, cuda_dev)
    before = dict(ops.LAUNCHES)
    y = ops.sketch_encode(xb, ids, cfg)
    assert y.device.type == "cuda"
    assert torch.equal(y, ref.sketch_encode_ref(xb, ids, cfg))
    got = ops.sketch_peel(y, xb != 0, ids, cfg)
    want = ref.sketch_peel_ref(y, xb != 0, ids, cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.LAUNCHES == before
    huge = CompressionConfig(ratio=0.001, rows=6)   # bits alone > shared memory
    sk = torch.zeros((1, huge.rows, huge.lanes), device=cuda_dev)
    bits = torch.zeros((1, huge.group, huge.lanes), dtype=torch.bool, device=cuda_dev)
    with pytest.raises(ValueError, match="shared memory"):
        ops.sketch_peel(sk, bits, ids, huge)
    never = dataclasses.replace(huge, use_pallas="never")
    got = ops.sketch_peel(sk, bits, ids, never)
    want = ref.sketch_peel_ref(sk, bits, ids, never)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ----------------------------------------------------------------------
# the peel kernels stop each block at its own fixpoint
# ----------------------------------------------------------------------

# per-block densities of one launch whose blocks reach their fixpoints at
# different rounds: empty, sparse (lossless), near the peeling threshold,
# overfull, every bit set
MIX = (0.0, 0.01, 0.1, 0.2, 0.4, 1.0)


def mixed_blocks(cfg, seed, kind="dyadic", densities=MIX):
    r = np.random.default_rng(seed)
    shape = (len(densities), cfg.group, cfg.lanes)
    if kind == "dyadic":
        vals = r.choice([-1.0, 1.0], size=shape) * np.exp2(r.integers(-2, 3, size=shape))
    else:
        vals = r.normal(size=shape)
    mask = r.random(shape) < np.asarray(densities)[:, None, None]
    return torch.from_numpy(np.where(mask, vals, 0.0).astype(np.float32))


def _plain_rounds(sk, bits, ids, cfg):
    """Each block's rounds to its fixpoint (at most cfg.rounds), peeled
    alone by the plain version."""
    from repro_torch.core.peeling import peel_blocks
    return [peel_blocks(sk[k:k + 1], bits[k:k + 1], ids[k:k + 1], cfg).rounds_used
            for k in range(sk.shape[0])]


def _check_peels(cfg, xb, ids, exact):
    """The f32 consumer, the dequant consumer and the standalone peel on
    one launch of ``xb``'s blocks: each against its plain version, each
    block's rounds against the plain peel of that block alone, the
    dequant leg against ``decode`` + the f32 kernel and the standalone
    peel against the fused consumer bit for bit, and a second run of each
    bit-identical. Returns the blocks' rounds."""
    from repro_torch.kernels.sketch_peel import sketch_peel_cuda
    from repro_torch.kernels.sketch_wire import dequant_peel_unpack_cuda
    nb, dev = xb.shape[0], xb.device

    def same(got, want):
        if exact:
            assert torch.equal(got[0], want[0])
        else:
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        assert torch.equal(got[1], want[1])

    def counter():
        return torch.full((nb,), -1, dtype=torch.int32, device=dev)

    sk, w, mx = ops.encode_pack_quantize(xb, ids, cfg)
    bits = xb != 0
    want_rounds = _plain_rounds(sk, bits, ids, cfg)
    rounds = counter()
    got = dequant_peel_unpack_cuda(sk, w, ids, cfg, block_rounds=rounds)
    same(got, ref.dequant_peel_unpack_ref(sk, w, ids, cfg))
    assert rounds.tolist() == want_rounds
    again = ops.dequant_peel_unpack(sk, w, ids, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    std_rounds = counter()
    std = sketch_peel_cuda(sk, bits, ids, cfg, block_rounds=std_rounds)
    same(std, ref.sketch_peel_ref(sk, bits, ids, cfg))
    assert all(torch.equal(a, b) for a, b in zip(std, got))
    assert torch.equal(std_rounds, rounds)

    wire = FixedPointWire(2)
    e, M = wire.exponents_from_maxabs(mx), wire.mantissa_bits
    q = ops.encode_pack_quantize(xb, ids, cfg, exponents=e, mantissa_bits=M)[0]
    dq_rounds = counter()
    dq = dequant_peel_unpack_cuda(q, w, ids, cfg, exponents=e, mantissa_bits=M,
                                  block_rounds=dq_rounds)
    same(dq, ref.dequant_peel_unpack_ref(q, w, ids, cfg, exponents=e,
                                         mantissa_bits=M))
    y = wire.decode(q.reshape(nb, -1), e).reshape(q.shape)
    assert all(torch.equal(a, b) for a, b in
               zip(dq, ops.dequant_peel_unpack(y, w, ids, cfg)))
    assert dq_rounds.tolist() == _plain_rounds(y, bits, ids, cfg)
    return want_rounds


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
def test_peel_kernels_stop_each_block_at_its_fixpoint(cuda_dev, cfg, kind):
    """One launch whose blocks reach their fixpoints at different rounds,
    in every geometry (the last two keep the peel state in device memory):
    dyadic bit for bit, Gaussian to rtol=1e-5, atol=1e-6."""
    xb = mixed_blocks(cfg, 3, kind).to(cuda_dev)
    rounds = _check_peels(cfg, xb, ids_for(len(MIX), 7000, cuda_dev),
                          kind == "dyadic")
    assert len(set(rounds)) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFGS[3], CFGS[4]], ids=[IDS[3], IDS[4]])
@pytest.mark.parametrize("rounds", [0, 1])
def test_peel_kernels_take_short_caps(cuda_dev, cfg, rounds):
    """``rounds=0`` (the median estimate for every set bit) and
    ``rounds=1``: every block runs exactly that many rounds; each wrapper
    call counts one launch of its own kernel."""
    cfg = dataclasses.replace(cfg, rounds=rounds)
    xb = mixed_blocks(cfg, 4).to(cuda_dev)
    before = dict(ops.LAUNCHES)
    got = _check_peels(cfg, xb, ids_for(len(MIX), 37, cuda_dev), True)
    assert got == [rounds] * len(MIX)
    after = dict(ops.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "encode_pack_quantize": 1, "dequant_peel_unpack": 3,
        "encode_pack_quantize_q": 1, "dequant_peel_unpack_dq": 1,
        "sketch_encode": 0, "sketch_peel": 1,
        "adam_update": 0}


@pytest.mark.cuda
def test_peel_kernels_report_their_occupancy(cuda_dev):
    """At the main path's geometry three 512-thread peel blocks (48 warps)
    share an SM; the geometries whose state lives in device memory keep
    only the bits, rotations and tables in shared memory."""
    main, lossless = CFGS[3], CFGS[4]
    for name in ("dequant_peel_unpack", "dequant_peel_unpack_dq", "sketch_peel"):
        blocks, smem = ops.kernel_occupancy(name, main, cuda_dev)
        assert blocks >= 3 and smem == 63_580
        blocks, smem = ops.kernel_occupancy(name, lossless, cuda_dev)
        assert blocks >= 3 and smem < 4 * lossless.rows * lossless.lanes
    for name in ("encode_pack_quantize", "sketch_encode"):
        assert ops.kernel_occupancy(name, main, cuda_dev)[0] >= 1


# ----------------------------------------------------------------------
# the streamed encode (producer legs and standalone encode) on the card
# ----------------------------------------------------------------------

# a fused geometry whose bitmap words straddle batch rows and chunks
# (c % 32 != 0, n % 32 == 0; G = 40 in chunks of 20 rows)
STRADDLE = CompressionConfig(ratio=0.15, lanes=100, rows=6)
# the plane variant with its plane in device memory: 60 rows of 1024
# lanes (240 KiB) exceed shared memory
PLANE_DEV = CompressionConfig(ratio=2.0, rows=60, lanes=1024)
ENC_CFGS = CFGS + [STRADDLE, PLANE_DEV]
ENC_IDS = IDS + ["straddle", "plane_dev"]
ENC_STD_CFGS = STD_CFGS + [PLANE_DEV]
ENC_STD_IDS = STD_IDS + ["plane_dev"]
# all zero, the Bloom path's 0.1% (most batch rows empty), the bitmap
# path's 4%, every element
ENC_DENSITIES = [0.0, 0.001, 0.04, 1.0]


def signed_blocks(cfg, nb, density, seed, kind):
    """Blocks at ``density`` holding -0.0 at 1% of their zeros."""
    r = np.random.default_rng(seed)
    shape = (nb, cfg.group, cfg.lanes)
    if kind == "dyadic":
        vals = r.choice([-1.0, 1.0], size=shape) * np.exp2(r.integers(-2, 3, size=shape))
    else:
        vals = r.normal(size=shape)
    mask = r.random(shape) < density
    x = np.where(mask, vals, 0.0).astype(np.float32)
    x[(~mask) & (r.random(shape) < 0.01)] = -0.0
    return torch.from_numpy(x)


def _plain_in_order(fn, *args, **kw):
    """A plain version run on the CPU, which adds a sketch row's terms in
    index order, the (i, j) order the kernels sum in: on
    any input its outputs equal the kernels' bit for bit. (The plain
    version on the card sums in the same order, as
    ``tests/test_torch_plain_cuda.py`` holds.)"""
    dev = args[0].device
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    kw = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    out = fn(*cpu, **kw)
    if isinstance(out, tuple):
        return tuple(o.to(dev) for o in out)
    return out.to(dev)


def _check_producer(cfg, xb, ids):
    """Both producer legs against their plain versions summed in order,
    bit for bit on any input: the f32 leg's sketch, words and maxabs, the
    quantize leg's int32 sketch; and the quantize leg equal to ``encode``
    of the f32 leg. Returns the f32 leg's outputs."""
    sk, w, mx = ops.encode_pack_quantize(xb, ids, cfg)
    want = _plain_in_order(ref.encode_pack_quantize_ref, xb, ids, cfg)
    for g, r in zip((sk, w, mx), want):
        assert torch.equal(g, r)
    wire = FixedPointWire(2)
    e, M, nb = wire.exponents_from_maxabs(mx), wire.mantissa_bits, xb.shape[0]
    q, wq, mxq = ops.encode_pack_quantize(xb, ids, cfg, exponents=e, mantissa_bits=M)
    assert torch.equal(q.reshape(nb, -1), wire.encode(sk.reshape(nb, -1), e))
    assert torch.equal(wq, w) and torch.equal(mxq, mx)
    q_r = _plain_in_order(ref.encode_pack_quantize_ref, xb, ids, cfg,
                          exponents=e, mantissa_bits=M)[0]
    assert torch.equal(q, q_r)
    return sk, w, mx


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ENC_CFGS, ids=ENC_IDS)
@pytest.mark.parametrize("density", ENC_DENSITIES)
@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
def test_streamed_producer_matches_plain(cuda_dev, cfg, density, kind):
    """Every geometry (incl. the plane variant, its plane in shared memory
    for the lossless profile and in device memory for 1024 lanes, and
    G=120) at every density, with -0.0 in the input, bit for bit with the
    plain version summed in order."""
    xb = signed_blocks(cfg, 7, density, 60, kind).to(cuda_dev)
    sk, _, mx = _check_producer(cfg, xb, ids_for(7, 7000, cuda_dev))
    if density == 0.0:
        assert not bool(sk.any()) and not bool(torch.signbit(sk).any())
        assert not bool(mx.any())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ENC_STD_CFGS, ids=ENC_STD_IDS)
@pytest.mark.parametrize("density", ENC_DENSITIES)
@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
def test_streamed_encode_matches_plain(cuda_dev, cfg, density, kind):
    """The standalone encode at every geometry (odd lanes and
    ``block_elems % 32 != 0`` included) and density, -0.0 in the input,
    bit for bit with the plain version summed in order; on an aligned
    geometry it equals the fused producer's sketch bit for bit."""
    xb = signed_blocks(cfg, 7, density, 61, kind).to(cuda_dev)
    ids = ids_for(7, 7000, cuda_dev)
    y = ops.sketch_encode(xb, ids, cfg)
    assert torch.equal(y, _plain_in_order(ref.sketch_encode_ref, xb, ids, cfg))
    if ops.fused_wire_supported(cfg):
        assert torch.equal(y, ops.encode_pack_quantize(xb, ids, cfg)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFGS[3], STD_CFGS[-1], STRADDLE],
                         ids=[IDS[3], STD_IDS[-1], "straddle"])
def test_streamed_encode_takes_unaligned_views(cuda_dev, cfg):
    """A contiguous view whose data pointer is 4 bytes past a 16-byte
    boundary takes the 4-byte copies: the same bits as an aligned copy."""
    nb = 5
    xb = signed_blocks(cfg, nb, 0.04, 62, "gauss").to(cuda_dev)
    ids = ids_for(nb, 37, cuda_dev)
    buf = torch.empty(xb.numel() + 4, device=cuda_dev)
    view = buf[1:1 + xb.numel()].view(xb.shape)
    view.copy_(xb)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    assert torch.equal(ops.sketch_encode(view, ids, cfg),
                       ops.sketch_encode(xb, ids, cfg))
    if ops.fused_wire_supported(cfg):
        got = ops.encode_pack_quantize(view, ids, cfg)
        want = _check_producer(cfg, xb, ids)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
def test_streamed_encode_takes_a_large_group(cuda_dev, kind):
    """G = 6000 (ratio 0.001), whose peel state exceeds shared memory:
    the encode's 3G pairs (8 bytes each) still fit, and the producer's
    words go straight to device memory, so both producer legs and the
    standalone encode run there (the sketch-only path, compress then
    estimate), bit for bit with the plain version summed in order."""
    cfg = CompressionConfig(ratio=0.001, rows=6)
    assert cfg.group == 6000
    xb = signed_blocks(cfg, 2, 0.04, 65, kind).to(cuda_dev)
    ids = ids_for(2, 3, cuda_dev)
    sk = _check_producer(cfg, xb, ids)[0]
    assert torch.equal(ops.sketch_encode(xb, ids, cfg), sk)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 133])
def test_streamed_encode_any_block_count(cuda_dev, nb):
    """One block, and a count that is no multiple of the SMs."""
    cfg = CFGS[3]
    xb = signed_blocks(cfg, nb, 0.04, 63, "dyadic").to(cuda_dev)
    ids = ids_for(nb, 11, cuda_dev)
    _check_producer(cfg, xb, ids)
    assert torch.equal(ops.sketch_encode(xb, ids, cfg),
                       ref.sketch_encode_ref(xb, ids, cfg))


@pytest.mark.cuda
def test_streamed_encode_repeats_and_stamps_its_phases(cuda_dev):
    """Two runs of each kernel give the same bits, with and without the
    per-block phase stamps; each call counts one launch of its own leg;
    the stamps are cycles (load wait + summing <= total)."""
    from repro_torch.kernels.sketch_encode import sketch_encode_cuda
    from repro_torch.kernels.sketch_wire import encode_pack_quantize_cuda
    cfg, nb = CFGS[3], 9
    xb = signed_blocks(cfg, nb, 0.04, 64, "gauss").to(cuda_dev)
    ids = ids_for(nb, 0, cuda_dev)
    e = torch.full((nb,), 4, dtype=torch.int32, device=cuda_dev)
    before = dict(ops.LAUNCHES)
    stamps = [torch.full((nb, 3), -1, dtype=torch.int64, device=cuda_dev)
              for _ in range(3)]
    for leg, kw in [("encode_pack_quantize", {}),
                    ("encode_pack_quantize_q", {"exponents": e, "mantissa_bits": 29})]:
        a = ops.encode_pack_quantize(xb, ids, cfg, **kw)
        b = encode_pack_quantize_cuda(xb, ids, cfg, phase_cycles=stamps[len(kw) // 2],
                                      **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = ops.sketch_encode(xb, ids, cfg)
    assert torch.equal(a, sketch_encode_cuda(xb, ids, cfg, phase_cycles=stamps[2]))
    after = dict(ops.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "encode_pack_quantize": 2, "dequant_peel_unpack": 0,
        "encode_pack_quantize_q": 2, "dequant_peel_unpack_dq": 0,
        "sketch_encode": 2, "sketch_peel": 0,
        "adam_update": 0}
    for pc in stamps:
        assert bool((pc >= 0).all())
        assert bool((pc[:, 0] + pc[:, 1] <= pc[:, 2]).all())


@pytest.mark.cuda
def test_encode_kernels_hold_32_warps_an_sm(cuda_dev):
    """At the main path's geometry the producer legs and the encode hold
    at least two blocks and 32 warps an SM; the lossless profile takes the
    plane variant, its plane in shared memory, and 60 rows of 1024 lanes
    the plane variant with its plane in device memory."""
    main, lossless = CFGS[3], CFGS[4]
    for name in ("encode_pack_quantize", "encode_pack_quantize_q", "sketch_encode"):
        blocks, smem = ops.kernel_occupancy(name, main, cuda_dev)
        threads = ops.kernel_threads(name, main)
        assert blocks >= 2 and blocks * threads >= 32 * 32, (name, blocks, threads)
        assert smem < 64 * 1024
        blocks, smem = ops.kernel_occupancy(name, lossless, cuda_dev)
        assert blocks >= 1 and smem > 4 * lossless.rows * lossless.lanes
        blocks, smem = ops.kernel_occupancy(name, PLANE_DEV, cuda_dev)
        assert blocks >= 1 and smem < 4 * PLANE_DEV.rows * PLANE_DEV.lanes
