"""The all-to-all exchange and the MoE layer through the hand kernels on
the card (``cuda``-marked: skipped without one), against their plain
versions. The module imports no JAX, so it runs where the card is.

At the exchange's geometry (ratio 2.5, rows 6, c 512: G 2) each of a
block's two batch rows has a sketch row of its own (rows 4 and 5), where
a rotation puts one element a cell, so the peel reads every value back
exactly: the exchange through the kernels equals the plain exchange bit
for bit on any payload, and numpy's sum on dyadic ones.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.core.aggregators import make_exchange
from repro_torch.core.collectives import LocalWorkers
from repro_torch.core.config import CompressionConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from test_torch_ops import cuda_dev  # noqa: F401  (the card's fixture)

EX = dict(ratio=2.5, topk_ratio=None, error_feedback=False)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [None, 2], ids=["fused", "chunked"])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_exchange_through_kernels_equals_plain_at_g2(cuda_dev, w, chunks):
    """Dyadic payloads at 95% density; one producer and one consumer
    launch a source (a receiving rank) a chunk."""
    fields = dict(EX, bucket_bytes=4 * 2048, stream_chunks=chunks)
    group = LocalWorkers(w)
    r = np.random.default_rng(w)
    n = 2 * 2048                               # 2 buckets of 2 blocks a lane
    pay = np.zeros((w, w, n), np.float32)
    nz = r.random(pay.shape) < 0.95
    pay[nz] = (r.choice([-1.0, 1.0], nz.sum())
               * np.exp2(r.integers(-2, 3, nz.sum())))
    payloads = [[torch.from_numpy(pay[s]).to(cuda_dev)] for s in range(w)]
    before = dict(ops.LAUNCHES)
    got = make_exchange("compressed", CompressionConfig(**fields), group)(payloads)
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    plain = make_exchange("compressed", CompressionConfig(
        **fields, use_pallas="never"), group)(payloads)
    assert launched["encode_pack_quantize"] == w * (chunks or 1)
    assert launched["dequant_peel_unpack"] == w * (chunks or 1)
    for g, p, want in zip(got, plain, pay.sum(axis=0)):
        assert torch.equal(g[0], p[0])
        np.testing.assert_array_equal(g[0].cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense", "compressed"])
def test_moe_ffn_on_the_card_matches_its_cpu_run(cuda_dev, name):
    """The f32 smoke layer at EP 2, the compressed wire through the hand
    kernels, against the same layer run plainly on the CPU: the gathers,
    combines and wire are the same arithmetic, the matmuls sum in another
    order (rtol 1e-5, atol 1e-6). Two runs on the card repeat bit for
    bit (no atomics in the dispatch or the combine)."""
    cfg = get_arch("deepseek-moe-16b").smoke
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=6))
    p_cpu = L.init_moe(torch.Generator().manual_seed(0), cfg)
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.normal(size=(256, cfg.d_model)).astype(np.float32))
    ct = torch.from_numpy(r.normal(size=(256, cfg.d_model)).astype(np.float32))

    def run(dev, use_pallas):
        p = {k: ({kk: vv.to(dev).requires_grad_() for kk, vv in v.items()}
                 if k == "shared" else v.to(dev).requires_grad_())
             for k, v in p_cpu.items()}
        leaves = [v for k, v in p.items() if k != "shared"] + \
            list(p["shared"].values())
        xt = x.to(dev).requires_grad_()
        ex = make_exchange(name, CompressionConfig(**EX, use_pallas=use_pallas),
                           LocalWorkers(2))
        out, aux = L.moe_ffn(xt, p, cfg.moe, ep_exchange=ex)
        grads = torch.autograd.grad((out * ct.to(dev)).mean() + aux,
                                    leaves + [xt])
        return [out.detach().cpu()] + [g.cpu() for g in grads]

    cpu = run("cpu", "never")
    card = run(cuda_dev, "auto")
    again = run(cuda_dev, "auto")
    for a, b, c in zip(card, cpu, again):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert torch.equal(a, c)
