"""Plain PyTorch paths on the card (``cuda``-marked: skipped without
one). The module imports no JAX, so it runs where the card is.

- The plain encode (``kernels.ref``, through ``core.sketch.scatter_rows``)
  sums each sketch cell in ascending ``t = 3i + j`` from +0.0 on every
  device: two plain encodes of one Gaussian stream (with signed zeros)
  are equal bit for bit, and equal the hand encode (rows 1 and 5) and
  the CPU's plain encode bit for bit; the plain peel repeats bit for bit
  from run to run.
- ``layers.flash_attention`` on the card against the same function on
  the CPU, forward and gradients, with TF32 off: f32 at rtol 1e-5 with
  atol 1e-6 of the largest entry (the two devices' block products add in
  other orders), bf16 operands at atol 2^-8 (outputs) and 2^-6
  (gradients) of the largest entry, as ``tests/test_torch_attention.py``
  holds the CPU's to the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.config import CompressionConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from test_torch_ops import cuda_dev  # noqa: F401  (the card's fixture)

CFG = CompressionConfig(ratio=0.1, topk_ratio=0.04)


def _stream(cfg, nb, seed):
    r = np.random.default_rng(seed)
    shape = (nb, cfg.group, cfg.lanes)
    x = np.where(r.random(shape) < 0.4, r.normal(size=shape), 0.0)
    x[(x == 0) & (r.random(shape) < 0.05)] = -0.0
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG, CompressionConfig(ratio=2.0, rows=60),
                                 CompressionConfig(ratio=2.5, rows=6)],
                         ids=["main", "lossless", "exchange"])
def test_plain_encode_is_deterministic_and_equals_the_hand_encode(cuda_dev, cfg):
    nb = 256
    xb = _stream(cfg, nb, cfg.rows).to(cuda_dev)
    ids = torch.arange(nb, dtype=torch.int32, device=cuda_dev) + 7000
    a = ref.encode_pack_quantize_ref(xb, ids, cfg)
    b = ref.encode_pack_quantize_ref(xb, ids, cfg)
    cpu = ref.encode_pack_quantize_ref(xb.cpu(), ids.cpu(), cfg)
    hand = ops.encode_pack_quantize(xb, ids, cfg)
    std = ops.sketch_encode(xb, ids, cfg)
    for x, y, z, h in zip(a, b, cpu, hand):
        assert torch.equal(x, y) and torch.equal(x.cpu(), z) and torch.equal(x, h)
    assert torch.equal(a[0], std)
    p1 = ref.dequant_peel_unpack_ref(a[0], a[1], ids, cfg)
    p2 = ref.dequant_peel_unpack_ref(a[0], a[1], ids, cfg)
    assert all(torch.equal(x, y) for x, y in zip(p1, p2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,sq,skv,rep", [(True, 1100, 1100, 4),
                                               (False, 300, 1500, 1)])
def test_flash_attention_on_the_card_matches_the_cpu(cuda_dev, dtype, causal,
                                                     sq, skv, rep):
    r = np.random.default_rng(sq)
    h, hd = 8, 64
    q, do = (r.standard_normal((2, sq, h, hd)) for _ in range(2))
    k, v = (r.standard_normal((2, skv, h // rep, hd)) for _ in range(2))
    outs = []
    for dev in (cuda_dev, torch.device("cpu")):
        t = [torch.tensor(x, dtype=torch.float32).to(dtype).to(dev)
             .requires_grad_() for x in (q, k, v)]
        out = L.flash_attention(*t, causal, 512)
        g = torch.autograd.grad(out, t, torch.tensor(do).to(dtype).to(dev))
        outs.append([x.detach().float().cpu().numpy() for x in (out,) + g])
    for i, (got, want) in enumerate(zip(*outs)):
        scale = np.abs(want).max()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
        else:
            tol = 2.0 ** -8 if i == 0 else 2.0 ** -6
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
