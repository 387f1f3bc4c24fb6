"""The elastic service's codec through the hand kernels on the card
(``cuda``-marked: skipped without one), against their plain versions.
The module imports no JAX, so it runs where the card is.

The serve launcher's elastic geometry (ratio 1, c 128, rows 6: G 6,
768-element blocks, 10 rounds) at block offsets near the end of the
580,550-block granite stream: the producer (row 1), the f32 consumer
(row 2) and the dequant consumer (row 4) equal their plain versions bit
for bit on dyadic inputs (every sum exact) and within ``rtol=1e-5,
atol=1e-6`` on Gaussian ones, words and residual exactly; and a small
elastic round folds and closes through them as it does plainly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.config import CompressionConfig
from repro_torch.elastic import ElasticClient, ElasticServer
from repro_torch.kernels import ops, ref
from repro_torch.net.fixedpoint import FixedPointWire
from test_torch_ops import cuda_dev  # noqa: F401  (the card's fixture)

CFG = CompressionConfig(ratio=1.0, lanes=128, rows=6, rounds=10,
                        chunk_blocks=8, topk_ratio=0.1, topk_exact=True,
                        error_feedback=True)
OFFSET = 580_550 - 512


def blocks(r, nb, frac, kind):
    shape = (nb, CFG.group, CFG.lanes)
    if kind == "dyadic":
        v = r.choice([-1.0, 1.0], size=shape) * np.exp2(r.integers(-2, 3, shape))
    else:
        v = r.normal(size=shape)
    return np.where(r.random(shape) < frac, v, 0.0).astype(np.float32)


def close(got, want, exact):
    if exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,frac", [("dyadic", 0.1), ("dyadic", 0.4),
                                       ("gauss", 0.1)])
def test_rows_1_2_4_at_the_elastic_geometry(cuda_dev, kind, frac):
    W, nb, exact = 4, 512, kind == "dyadic"
    wire = FixedPointWire(W)
    r = np.random.default_rng(int(frac * 10))
    ids = torch.arange(nb, dtype=torch.int32, device=cuda_dev) + OFFSET
    before = dict(ops.LAUNCHES)
    enc = []
    for _ in range(W):
        xb = torch.from_numpy(blocks(r, nb, frac, kind)).to(cuda_dev)
        got = ops.encode_pack_quantize(xb, ids, CFG)
        want = ref.encode_pack_quantize_ref(xb, ids, CFG)
        close(got[0], want[0], exact)
        assert torch.equal(got[1], want[1])
        close(got[2], want[2], exact)
        enc.append(got)
    sk = sum(e[0] for e in enc)
    w = enc[0][1] | enc[1][1] | enc[2][1] | enc[3][1]
    v, res = ops.dequant_peel_unpack(sk, w, ids, CFG)
    v_p, res_p = ref.dequant_peel_unpack_ref(sk, w, ids, CFG)
    close(v, v_p, exact)
    assert torch.equal(res, res_p)
    e = wire.exponents_from_maxabs(torch.stack([x[2] for x in enc]).amax(0))
    q = sum(wire.encode(x[0].reshape(nb, -1), e).reshape(x[0].shape) for x in enc)
    M = wire.mantissa_bits
    v_q, res_q = ops.dequant_peel_unpack(q, w, ids, CFG, exponents=e,
                                         mantissa_bits=M)
    v_qp, res_qp = ref.dequant_peel_unpack_ref(q, w, ids, CFG, exponents=e,
                                               mantissa_bits=M)
    close(v_q, v_qp, exact)
    assert torch.equal(res_q, res_qp)
    # the dequant leg is decode + the f32 consumer, bit for bit
    y = wire.decode(q.reshape(nb, -1), e).reshape(q.shape)
    v_c, res_c = ops.dequant_peel_unpack(y, w, ids, CFG)
    assert torch.equal(v_q, v_c) and torch.equal(res_q, res_c)
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    assert launched == {**dict.fromkeys(before, 0), "encode_pack_quantize": W,
                        "dequant_peel_unpack": 2, "dequant_peel_unpack_dq": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("wire,shards", [("f32", 1), ("f32", 3), ("fxp32", 1),
                                         ("fxp32", 3)])
def test_elastic_round_through_kernels_equals_plain(cuda_dev, wire, shards):
    """Three clients' dyadic gradients through one round on the card and
    the same round with the plain versions: the same stream bit for bit,
    with three producer launches and a consumer launch a shard."""
    cfg = dataclasses.replace(CFG, wire_dtype=wire, bucket_bytes=4 * 768 * 8)
    r = np.random.default_rng(7)
    trees = [{"a": blocks(r, 24, 0.3, "dyadic").reshape(-1)[:18000],
              "b": blocks(r, 4, 0.3, "dyadic").reshape(48, 64)}
             for _ in range(3)]
    outs = []
    for c, dev in ((cfg, cuda_dev), (dataclasses.replace(cfg, use_pallas="never"),
                                     cuda_dev)):
        srv = ElasticServer(trees[0], c, n_shards=shards, batch_size=shards,
                            device=dev)
        clients = [ElasticClient(w, c, device=dev) for w in range(3)]
        for w in range(3):
            srv.join(w)
        before = dict(ops.LAUNCHES)
        contract = srv.open_round()
        if wire == "fxp32":
            for w in range(3):
                srv.submit_exponents(clients[w].propose(contract, trees[w]))
            shared = srv.seal_exponents()
            for w in range(3):
                srv.submit(clients[w].payload(contract, shared))
        else:
            for w in range(3):
                srv.submit(clients[w].contribute(contract, trees[w]))
        out, rep = srv.close_round()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        assert rep.folded == 3 and rep.close_reason == "complete"
        outs.append((out, launched))
    assert torch.equal(outs[0][0], outs[1][0])
    cons = "dequant_peel_unpack_dq" if wire == "fxp32" else "dequant_peel_unpack"
    assert outs[0][1] == {**dict.fromkeys(outs[0][1], 0),
                          "encode_pack_quantize": 3, cons: shards}
    assert not any(outs[1][1].values())
