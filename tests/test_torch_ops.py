"""Dispatch rules of ``repro_torch.kernels.ops`` and the CUDA kernels
against their plain versions.

The dispatch tests run anywhere. The kernel tests carry the ``cuda``
marker and skip without a CUDA device (the kernels exist only on the
card); on a machine with one they run with

    PYTHONPATH=src python -m pytest tests/test_torch_ops.py -m cuda

This file imports no JAX, so it runs where only PyTorch is installed.
Kernel vs plain: dyadic inputs bit for bit (every sum exact in any
order); Gaussian inputs to rtol=1e-5, atol=1e-6, because the plain
version's ``index_add_`` sums in atomic order on the card; words and
residual masks exactly on every input (they depend on integers only).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compressor import HomomorphicCompressor
from repro_torch.core.config import CompressionConfig
from repro_torch.kernels import ops, ref

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
    """The quantize/dequant legs have no kernel yet: where the kernel path
    is taken (a CUDA tensor), ``exponents`` raises before any launch."""
    monkeypatch.setattr(ops, "_use_kernel", lambda cfg, t: True)
    cfg = CFGS[0]
    xb, ids = blocks(cfg, 1, 0.05, 3), ids_for(1)
    exps = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="in-network"):
        ops.encode_pack_quantize(xb, ids, cfg, exponents=exps, mantissa_bits=29)
    sk, w, _ = ref.encode_pack_quantize_ref(xb, ids, cfg)
    with pytest.raises(NotImplementedError, match="in-network"):
        ops.dequant_peel_unpack(sk.to(torch.int32), w, ids, cfg,
                                exponents=exps, mantissa_bits=29)


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
    assert ops.fused_wire_supported(cfg) is supported
    if not supported:
        xb = torch.zeros((1, cfg.group, cfg.lanes))
        with pytest.raises(ValueError, match="unsupported"):
            ops.encode_pack_quantize(xb, ids_for(1), cfg)
        with pytest.raises(NotImplementedError):
            HomomorphicCompressor(cfg).compress(torch.zeros(cfg.block_elems))


def test_wire_codec_passes():
    cfg = CFGS[0]
    assert ops.wire_codec_passes(cfg) == {"producer": 1, "consumer": 1}
    assert ops.wire_codec_passes(cfg, device="cpu") == {"producer": 2, "consumer": 2}
    assert ops.wire_codec_passes(cfg, quantized=True, device="cpu") == \
        {"producer": 3, "consumer": 3}
    never = dataclasses.replace(cfg, use_pallas="never")
    assert ops.wire_codec_passes(never) == {"producer": 2, "consumer": 2}


def test_sketch_estimate_is_the_plain_median():
    cfg = CFGS[0]
    xb, ids = blocks(cfg, 2, 0.03, 5), ids_for(2)
    sk, _, _ = ref.encode_pack_quantize_ref(xb, ids, cfg)
    assert torch.equal(ops.sketch_estimate(sk, ids, cfg),
                       ref.sketch_estimate_ref(sk, ids, cfg))


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
    cfg = dataclasses.replace(CFGS[0], use_pallas="never")
    xb, ids = blocks(cfg, 1, 0.05, 10).to(cuda_dev), ids_for(1, 0, cuda_dev)
    with pytest.raises(ValueError, match="never"):
        ops.encode_pack_quantize(xb, ids, cfg)
    with pytest.raises(NotImplementedError, match="in-network"):
        ops.encode_pack_quantize(xb, ids, CFGS[0],
                                 exponents=torch.zeros(1, dtype=torch.int32,
                                                       device=cuda_dev),
                                 mantissa_bits=29)
    with pytest.raises(TypeError):
        ops.encode_pack_quantize(xb.double(), ids, CFGS[0])
    huge = CompressionConfig(ratio=0.001, rows=6)   # bits alone > shared memory
    xb = torch.zeros((1, huge.group, huge.lanes), device=cuda_dev)
    sk = torch.zeros((1, huge.rows, huge.lanes), device=cuda_dev)
    w = torch.zeros((1, huge.block_elems // 32), dtype=torch.int32, device=cuda_dev)
    with pytest.raises(ValueError, match="shared memory"):
        ops.dequant_peel_unpack(sk, w, ids, huge)
