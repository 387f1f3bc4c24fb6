"""The port's Mamba2 mixer (``repro_torch/models/ssm.py``) against the
JAX reference (``src/repro/models/ssm.py``): the chunked SSD scan, the
forward with its decode state, and the one-token decode.

The mixer's params are the port's draws from seed 0 on the smoke config
of ``configs/mamba2_1_3b.py`` (float32), given to both sides as numpy;
inputs are Gaussian numpy arrays from a seeded generator, and the scan's
inputs are what the mixer's projections make of them. Tolerances: the
scan in f32 to rtol=1e-5, atol=1e-6 (the two frameworks run the same
math in their own einsum and cumsum orders); the mixer's outputs and
states to the same; gradients at strongly negative ``dA`` to 1e-4; the
port's decode after its prefill against its forward over the longer
sequence to 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.mamba2_1_3b import ARCH as J_ARCH
from repro.models import ssm as JS
from repro_torch.convert import params_to_numpy
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.params import ParamTree

TOL = dict(rtol=1e-5, atol=1e-6)
JCFG = J_ARCH.smoke
CFG = ModelConfig(**{**dataclasses.asdict(JCFG),
                     "ssm": SSMConfig(**dataclasses.asdict(JCFG.ssm))})
B = 2


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixer():
    """(port params, reference params) of one mixer, the port's draws."""
    gen = torch.Generator().manual_seed(0)
    p = ParamTree(S.init_mamba(gen, CFG))
    np_tree = params_to_numpy(p)
    return p.tree(), jax.tree.map(jnp.asarray, np_tree)


def _x(S_len, seed=3):
    return np.random.default_rng(seed).normal(
        size=(B, S_len, CFG.d_model)).astype(np.float32)


def scan_inputs(p, S_len, seed=3, da_scale=1.0):
    """The scan's inputs as the mixer makes them from a Gaussian ``x``
    (xdt, dA, B, C as numpy f32); ``da_scale`` multiplies ``dA``."""
    with torch.no_grad():
        xh, _, Bm, Cm, dt, _ = S._project(torch.from_numpy(_x(S_len, seed)),
                                          p, CFG)
        dA = dt * -torch.exp(p["A_log"]) * da_scale
        return [t.numpy() for t in (xh * dt[..., None], dA, Bm, Cm)]


@pytest.mark.parametrize("S_len", [64, 50, 12])
def test_ssd_chunk_scan_matches_reference(mixer, S_len):
    """At the smoke config's chunk of 32: S a multiple of the chunk, S
    not a multiple of it (the last chunk padded with ``dA = 0``, ``xdt =
    0``), and S below the chunk (``Q = S``): the outputs and the final
    state."""
    chunk = CFG.ssm.chunk
    ins = scan_inputs(mixer[0], S_len)
    jy, jst = jax.jit(JS._ssd_chunk_scan, static_argnums=4)(
        *map(jnp.asarray, ins), chunk)
    y, st = S._ssd_chunk_scan(*map(torch.from_numpy, ins), chunk)
    H, P, N = CFG.ssm.n_heads(CFG.d_model), CFG.ssm.head_dim, CFG.ssm.d_state
    assert y.shape == (B, S_len, H, P) and st.shape == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def test_ssd_grads_finite_at_strongly_negative_dA(mixer):
    """``dA`` ten times the mixer's (decays to e^-200 and below across a
    chunk): the masked exponent keeps every gradient finite, and they
    agree with the reference's."""
    ins = scan_inputs(mixer[0], 40, seed=1, da_scale=10.0)
    assert ins[1].min() < -20
    rng = np.random.default_rng(2)
    wy = rng.normal(size=ins[0].shape).astype(np.float32)
    ws = rng.normal(size=(B,) + ins[0].shape[2:] + (CFG.ssm.d_state,)
                    ).astype(np.float32)
    chunk = CFG.ssm.chunk

    def jloss(*a):
        y, st = JS._ssd_chunk_scan(*a, chunk)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, ins))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, st = S._ssd_chunk_scan(*ts, chunk)
    loss = (y * torch.from_numpy(wy)).sum() + (st * torch.from_numpy(ws)).sum()
    g = torch.autograd.grad(loss, ts)
    for a, b in zip(g, jg):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_param_tree_matches_reference(mixer):
    """The port's mixer tree has the reference's paths, shapes and
    dtypes (``A_log`` / ``D_skip`` sort before the lower-case keys)."""
    p, _ = mixer
    want = JS.init_mamba(jax.random.PRNGKey(0), JCFG)
    got = ParamTree(p)
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(want)[0]]
    assert list(got.paths) == jpaths
    for t, a in zip(got.leaves(), jax.tree.leaves(want)):
        assert tuple(t.shape) == a.shape and str(t.dtype)[6:] == a.dtype.name


@pytest.mark.parametrize("S_len", [40, 64])
def test_mamba_forward_and_state_match_reference(mixer, S_len):
    p, jp = mixer
    x = _x(S_len)
    jy, jst = JS.mamba_forward(jnp.asarray(x), jp, JCFG, return_state=True)
    with torch.no_grad():
        y, st = S.mamba_forward(torch.from_numpy(x), p, CFG, return_state=True)
        y_only = S.mamba_forward(torch.from_numpy(x), p, CFG)
    assert torch.equal(y, y_only)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert sorted(st) == sorted(jst) == ["conv", "ssm"]
    for k in st:
        assert st[k].dtype == torch.float32
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), **TOL)


def test_mamba_decode_matches_reference(mixer):
    """One decode step from a non-zero state (a prefill's) on both
    sides."""
    p, jp = mixer
    x = _x(24)
    tok = _x(1, seed=4)
    _, jst = JS.mamba_forward(jnp.asarray(x), jp, JCFG, return_state=True)
    jy, jst2 = JS.mamba_decode(jnp.asarray(tok), jp, JCFG, jst)
    state = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    with torch.no_grad():
        y, st2 = S.mamba_decode(torch.from_numpy(tok), p, CFG, state)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in st2:
        np.testing.assert_allclose(st2[k].numpy(), np.asarray(jst2[k]), **TOL)
    zero = S.init_mamba_state(B, CFG)
    jzero = JS.init_mamba_state(B, JCFG)
    for k in zero:
        assert tuple(zero[k].shape) == jzero[k].shape


def test_decode_after_prefill_matches_longer_forward(mixer):
    """Prefill 37 steps (two chunks, the second padded), then decode 3
    one at a time: each output equals the forward over all 40 at its
    position, and the last state the forward's final state."""
    p, _ = mixer
    x = torch.from_numpy(_x(40, seed=5))
    with torch.no_grad():
        full, want_st = S.mamba_forward(x, p, CFG, return_state=True)
        _, st = S.mamba_forward(x[:, :37], p, CFG, return_state=True)
        for t in range(37, 40):
            y, st = S.mamba_decode(x[:, t:t + 1], p, CFG, st)
            np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(),
                                       rtol=1e-4, atol=1e-4)
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), want_st[k].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_softplus_is_logaddexp_past_the_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 25.0, 60.0])
    np.testing.assert_allclose(S.softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))),
                               rtol=1e-6)
