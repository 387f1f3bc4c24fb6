"""What the peel kernels' per-block exit rests on, pinned on the plain
PyTorch peel and against the JAX reference's fixed-round peel.

The CUDA peel kernels stop each block's rounds at that block's own
fixpoint (the first round that peels nothing), at most ``cfg.rounds``.
That gives the output of all ``cfg.rounds`` rounds because:

- a round that peels nothing changes no state, so every cap at or above
  the fixpoint gives the same values, peeled and residual masks;
- blocks do not interact, so peeling a concatenation of blocks equals
  peeling each block alone at its own id, and the concatenation's rounds
  to the fixpoint are the most any one block needs.

Both hold here for ``core.peeling.peel_blocks`` and, on the same numpy
inputs, for the reference's ``peel_tile`` (the body of the Pallas peel,
which always runs ``cfg.rounds`` rounds) and its Pallas kernel in
interpret mode. Dyadic inputs compare bit for bit; Gaussian inputs within
the reference's own ``atol=1e-5`` (the two frameworks sum scatter
contributions in their own orders); masks exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import CompressionConfig as JaxConfig
from repro.core import hashing as jhash
from repro.kernels import sketch_peel_pallas
from repro.kernels.sketch_peel import peel_tile
from repro_torch.core.config import CompressionConfig
from repro_torch.core.peeling import peel_blocks
from repro_torch.core.sketch import encode_blocks

GEOMS = [
    JaxConfig(ratio=0.2, lanes=128, rows=6, rounds=10),   # G=30
    JaxConfig(ratio=0.2, lanes=100, rows=6, rounds=10),   # G=30, n % 32 = 24
]
GEOM_IDS = [f"l{c.lanes}g{c.group}" for c in GEOMS]
GAUSS_ATOL = 1e-5
# per-block densities of one launch whose blocks reach their fixpoints at
# different rounds: empty, sparse (lossless, one or two rounds), near the
# peeling threshold (many rounds), overfull (stuck at once), every bit set
MIX = (0.0, 0.01, 0.15, 0.30, 0.60, 1.0)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tcfg(jc, **kw):
    return CompressionConfig(**{**dataclasses.asdict(jc), **kw})


def mixed_blocks(cfg, densities, seed, kind):
    """(nb, G, c) values, one block a density, with every bit of a
    density-1 block set."""
    r = np.random.default_rng(seed)
    shape = (len(densities), cfg.group, cfg.lanes)
    if kind == "dyadic":
        vals = r.choice([-1.0, 1.0], size=shape) * np.exp2(r.integers(-2, 3, size=shape))
    else:
        vals = r.normal(size=shape)
    mask = r.random(shape) < np.asarray(densities)[:, None, None]
    return np.where(mask, vals, 0.0).astype(np.float32)


def peel(jc, xb, ids, rounds):
    """The port's plain peel of ``xb``'s sketch with ``cfg.rounds =
    rounds``: (values, peeled, residual) as numpy, and the rounds used."""
    cfg = tcfg(jc, rounds=rounds)
    x, i = torch.from_numpy(xb), torch.from_numpy(ids)
    r = peel_blocks(encode_blocks(x, i, cfg), x != 0, i, cfg)
    return (r.values.numpy(), r.peeled.numpy(), r.residual.numpy()), r.rounds_used


def jax_peel(jc, xb, ids, rounds):
    """The reference's fixed-round ``peel_tile`` on the same inputs (the
    sketch encoded by the port, bit for bit the reference's on dyadic
    values): (values, residual) as numpy."""
    cfg = dataclasses.replace(jc, rounds=rounds)
    y = encode_blocks(torch.from_numpy(xb), torch.from_numpy(ids), tcfg(jc)).numpy()
    rows_flat = jnp.asarray(jhash.batch_rows(jc.group, jc.rows, jc.seed).reshape(-1))
    signs = jnp.asarray(jhash.batch_signs(jc.group, jc.seed))
    v, b = jit_peel_tile(cfg)(jnp.asarray(ids), rows_flat, signs,
                              jnp.asarray(y), jnp.asarray(xb != 0))
    return np.asarray(v), np.asarray(b)


@functools.lru_cache(maxsize=None)
def jit_peel_tile(cfg):
    """``peel_tile`` jitted with ``cfg`` static: one compiled function a
    geometry and cap (eagerly, every call re-dispatches each op)."""
    return jax.jit(functools.partial(peel_tile, cfg=cfg))


def assert_values(got, want, kind):
    if kind == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_ATOL)


@pytest.mark.parametrize("jc", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
@pytest.mark.parametrize("extra", [0, 1, 3, 40])
def test_caps_at_or_past_the_fixpoint_agree(jc, kind, extra):
    """``cfg.rounds`` set to the fixpoint or any larger cap gives the same
    values, peeled and residual, the same rounds used, and the reference's
    fixed-round peel at that cap."""
    xb = mixed_blocks(jc, MIX, 11, kind)
    ids = np.arange(len(MIX), dtype=np.int32) + 91
    _, fix = peel(jc, xb, ids, 64)
    assert 0 < fix < 64
    want, _ = peel(jc, xb, ids, fix)
    got, used = peel(jc, xb, ids, fix + extra)
    assert used == fix
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    jv, jres = jax_peel(jc, xb, ids, fix + extra)
    np.testing.assert_array_equal(got[2], jres)
    assert_values(got[0], jv, kind)


@pytest.mark.parametrize("jc", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
@pytest.mark.parametrize("offset", [0, 7000])
def test_blocks_peel_alone_as_in_a_launch(jc, kind, offset):
    """Peeling the concatenation of blocks at ids ``offset + k`` equals
    the concatenation of each block peeled alone at its id; its rounds
    used are the most any block needs; and it equals the reference's
    fixed-round peel of the concatenation."""
    xb = mixed_blocks(jc, MIX, 12, kind)
    ids = np.arange(len(MIX), dtype=np.int32) + offset
    got, used = peel(jc, xb, ids, jc.rounds)
    alone = [peel(jc, xb[k:k + 1], ids[k:k + 1], jc.rounds) for k in range(len(MIX))]
    for part in range(3):
        np.testing.assert_array_equal(
            got[part], np.concatenate([a[0][part] for a in alone]))
    assert used == max(a[1] for a in alone)
    assert len({a[1] for a in alone}) > 2, "blocks should stop at different rounds"
    jv, jres = jax_peel(jc, xb, ids, jc.rounds)
    np.testing.assert_array_equal(got[2], jres)
    assert_values(got[0], jv, kind)


@pytest.mark.parametrize("rounds", [0, 1, 2])
def test_short_caps_match_the_pallas_kernel(rounds):
    """Caps below the fixpoint (the kernels' ``rounds=0`` and ``1``): the
    plain peel equals the reference's Pallas peel in interpret mode, which
    runs exactly ``rounds`` rounds, bit for bit on dyadic inputs."""
    jc = GEOMS[0]
    xb = mixed_blocks(jc, MIX, 13, "dyadic")
    ids = np.arange(len(MIX), dtype=np.int32) + 37
    got, used = peel(jc, xb, ids, rounds)
    assert used == rounds
    cfg = dataclasses.replace(jc, rounds=rounds)
    y = encode_blocks(torch.from_numpy(xb), torch.from_numpy(ids), tcfg(jc)).numpy()
    v, r = sketch_peel_pallas(jnp.asarray(y), jnp.asarray(xb != 0),
                              jnp.asarray(ids), cfg, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(v))
    np.testing.assert_array_equal(got[2], np.asarray(r) != 0)
