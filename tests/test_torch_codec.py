"""PyTorch port vs the JAX reference: the codec's plain versions.

``encode_blocks``, ``estimate_blocks``, ``peel_blocks`` and both composed
``kernels/ref.py`` functions over the ``CFGS`` sweep of
``tests/test_kernels.py``. Dyadic inputs (values ±2^e, |e| <= 2) make
every float sum exact in any order, so those compare bit for bit; other
inputs compare within the reference's own ``atol=1e-5`` (the two
frameworks sum scatter contributions in their own orders). Integer
outputs (words, residual masks, quantized int32 sketches) compare
exactly on every input.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import CompressionConfig as JaxConfig
from repro.core import peeling as jpeel
from repro.core import sketch as jsketch
from repro.kernels import ref as jref
from repro.net.fixedpoint import FixedPointWire
from repro_torch.core import peeling as tpeel
from repro_torch.core import sketch as tsketch
from repro_torch.core.config import CompressionConfig
from repro_torch.kernels import ref as tref

CFGS = [
    JaxConfig(ratio=0.2, lanes=128, rows=6, rounds=8),
    JaxConfig(ratio=0.2, lanes=256, rows=6, rounds=8),
    JaxConfig(ratio=0.1, lanes=256, rows=12, rounds=8),
    JaxConfig(ratio=0.5, lanes=512, rows=6, rounds=8),
]
IDS = [f"l{c.lanes}r{c.rows}g{c.group}" for c in CFGS]
GAUSS_ATOL = 1e-5   # the reference's own peel tolerance (test_kernels.py)
NB = 3              # one block count throughout: JAX compiles once per shape


def tcfg(jc):
    return CompressionConfig(**dataclasses.asdict(jc))


def dyadic_blocks(cfg, nb, frac, seed):
    r = np.random.default_rng(seed)
    n = nb * cfg.block_elems
    x = np.zeros(n, np.float32)
    k = max(1, int(n * frac))
    idx = r.choice(n, size=k, replace=False)
    x[idx] = (r.choice([-1.0, 1.0], size=k)
              * np.exp2(r.integers(-2, 3, size=k))).astype(np.float32)
    return x.reshape(nb, cfg.group, cfg.lanes)


def gauss_blocks(cfg, nb, frac, seed):
    r = np.random.default_rng(seed)
    n = nb * cfg.block_elems
    x = np.zeros(n, np.float32)
    k = max(1, int(n * frac))
    x[r.choice(n, size=k, replace=False)] = r.normal(size=k)
    return x.reshape(nb, cfg.group, cfg.lanes)


def _ids(nb, offset=37):
    return np.arange(nb, dtype=np.int32) + offset


def _both(xb, ids):
    return (jnp.asarray(xb), jnp.asarray(ids)), \
        (torch.from_numpy(xb), torch.from_numpy(ids))


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
def test_encode_and_estimate_match_reference(cfg, kind):
    make = dyadic_blocks if kind == "dyadic" else gauss_blocks
    xb, ids = make(cfg, NB, 0.05, seed=11), _ids(NB)
    (jx, jid), (tx, tid) = _both(xb, ids)
    want = np.asarray(jsketch.encode_blocks(jx, jid, cfg))
    got = tsketch.encode_blocks(tx, tid, tcfg(cfg)).numpy()
    est_w = np.asarray(jsketch.estimate_blocks(jnp.asarray(want), jid, cfg))
    est_g = tsketch.estimate_blocks(torch.from_numpy(want.copy()), tid, tcfg(cfg)).numpy()
    if kind == "dyadic":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(est_g, est_w)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_ATOL)
        np.testing.assert_allclose(est_g, est_w, rtol=0, atol=GAUSS_ATOL)


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
@pytest.mark.parametrize("frac", [0.02, 0.3])
def test_peel_blocks_matches_reference(cfg, frac):
    """Sparse (fully peeled) and overfull (median fallback) blocks."""
    xb, ids = dyadic_blocks(cfg, NB, frac, seed=17), _ids(NB, 5)
    (jx, jid), (tx, tid) = _both(xb, ids)
    y = jsketch.encode_blocks(jx, jid, cfg)
    want = jpeel.peel_blocks(y, jx != 0, jid, cfg)
    got = tpeel.peel_blocks(torch.from_numpy(np.array(y)), tx != 0, tid,
                            tcfg(cfg))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.residual.numpy(), np.asarray(want.residual))
    np.testing.assert_array_equal(got.peeled.numpy(), np.asarray(want.peeled))
    assert got.rounds_used == int(want.rounds_used)


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
@pytest.mark.parametrize("kind,frac", [("dyadic", 0.04), ("dyadic", 0.4),
                                       ("gauss", 0.04)])
def test_wire_refs_match_reference(cfg, kind, frac):
    """Composed producer and consumer, at offset (mid-stream) block ids."""
    make = dyadic_blocks if kind == "dyadic" else gauss_blocks
    xb, ids = make(cfg, NB, frac, seed=3), _ids(NB, 7000)
    (jx, jid), (tx, tid) = _both(xb, ids)
    sk_w, w_w, mx_w = jref.encode_pack_quantize_ref(jx, jid, cfg)
    sk_g, w_g, mx_g = tref.encode_pack_quantize_ref(tx, tid, tcfg(cfg))
    np.testing.assert_array_equal(w_g.numpy(), np.asarray(w_w).view(np.int32))
    v_w, r_w = jref.dequant_peel_unpack_ref(sk_w, w_w, jid, cfg)
    v_g, r_g = tref.dequant_peel_unpack_ref(
        torch.from_numpy(np.array(sk_w)), w_g, tid, tcfg(cfg))
    np.testing.assert_array_equal(r_g.numpy(), np.asarray(r_w))
    if kind == "dyadic":
        np.testing.assert_array_equal(sk_g.numpy(), np.asarray(sk_w))
        np.testing.assert_array_equal(mx_g.numpy(), np.asarray(mx_w))
        np.testing.assert_array_equal(v_g.numpy(), np.asarray(v_w))
    else:
        np.testing.assert_allclose(sk_g.numpy(), np.asarray(sk_w), rtol=0,
                                   atol=GAUSS_ATOL)
        np.testing.assert_allclose(mx_g.numpy(), np.asarray(mx_w), rtol=0,
                                   atol=GAUSS_ATOL)
        np.testing.assert_allclose(v_g.numpy(), np.asarray(v_w), rtol=0,
                                   atol=GAUSS_ATOL)


@pytest.mark.parametrize("cfg", CFGS[:2], ids=IDS[:2])
def test_quantized_legs_match_reference(cfg):
    """fxp32 quantize and dequant legs on the plain path, to the int32 bit:
    dyadic sketches quantize exactly, and the dequantized peel matches."""
    xb, ids = dyadic_blocks(cfg, NB, 0.05, seed=23), _ids(NB, 100)
    (jx, jid), (tx, tid) = _both(xb, ids)
    wire = FixedPointWire(workers=2)
    _, _, mx = jref.encode_pack_quantize_ref(jx, jid, cfg)
    exps = np.array(wire.exponents_from_maxabs(mx))
    M = wire.mantissa_bits
    q_w, w_w, mx_w = jref.encode_pack_quantize_ref(jx, jid, cfg, exponents=exps,
                                                   mantissa_bits=M)
    q_g, w_g, mx_g = tref.encode_pack_quantize_ref(
        tx, tid, tcfg(cfg), exponents=torch.from_numpy(exps), mantissa_bits=M)
    assert q_g.dtype == torch.int32
    np.testing.assert_array_equal(q_g.numpy(), np.asarray(q_w))
    np.testing.assert_array_equal(mx_g.numpy(), np.asarray(mx_w))
    v_w, r_w = jref.dequant_peel_unpack_ref(q_w, w_w, jid, cfg, exponents=exps,
                                            mantissa_bits=M)
    v_g, r_g = tref.dequant_peel_unpack_ref(q_g, w_g, tid, tcfg(cfg),
                                            exponents=torch.from_numpy(exps),
                                            mantissa_bits=M)
    np.testing.assert_array_equal(v_g.numpy(), np.asarray(v_w))
    np.testing.assert_array_equal(r_g.numpy(), np.asarray(r_w))


def test_quantize_rounds_half_to_even():
    """rint semantics: halves round to even, as jnp.rint."""
    from repro.net.fixedpoint import pow2 as jpow2
    from repro_torch.net.fixedpoint import pow2 as tpow2
    k = np.arange(-126, 128, dtype=np.int32)
    np.testing.assert_array_equal(tpow2(torch.from_numpy(k)).numpy(),
                                  np.asarray(jpow2(jnp.asarray(k))))
    v = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.4999], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnp.rint(jnp.asarray(v))))
