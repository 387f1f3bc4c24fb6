"""The port's remat policies (``models/transformer.lm_hidden``) at the
smoke configs of ``configs/granite_3_2b.py`` and
``configs/deepseek_moe_16b.py``.

Every policy recomputes the same ops on the same inputs, so losses and
gradients under ``block``, ``block_nocse`` and ``dots`` equal ``none``'s
bit for bit, with the MoE layers' exchange too, whose producers run once
a forward under every policy (the recompute leaves the exchange out).
Against the reference's ``remat="block"`` the tolerances are those of
the existing ``remat="none"`` comparisons: rtol=1e-5 with atol=1e-7 for
gradient entries near zero (``test_torch_train.py``,
``test_torch_moe.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.deepseek_moe_16b import ARCH as J_MOE
from repro.configs.granite_3_2b import ARCH as J_DENSE
from repro.data.pipeline import batch_fn as j_batch_fn
from repro.models.transformer import init_lm as j_init_lm, lm_loss as j_lm_loss
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import compressor as comp_lib
from repro_torch.core.aggregators import make_exchange
from repro_torch.core.collectives import LocalWorkers
from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.registry import model_api
from repro_torch.models.transformer import REMAT_POLICIES, lm_hidden, lm_loss
from repro_torch.train.config import TrainConfig
from repro_torch.train.loop import device_batch, run_training

B, S = 4, 32
TOL = dict(rtol=1e-5, atol=1e-7)
EX = dict(ratio=2.5, topk_ratio=None, error_feedback=False, lanes=128,
          use_pallas="never")


def _cfg(jcfg):
    moe = None if jcfg.moe is None else MoEConfig(**dataclasses.asdict(jcfg.moe))
    return ModelConfig(**{**dataclasses.asdict(jcfg), "moe": moe})


MODELS = {"granite": (J_DENSE.smoke, _cfg(J_DENSE.smoke)),
          "deepseek": (J_MOE.smoke, _cfg(J_MOE.smoke))}


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return {k: jax.tree.map(np.asarray, j_init_lm(jax.random.PRNGKey(0), jc))
            for k, (jc, _) in MODELS.items()}


@pytest.fixture
def exchange_calls(monkeypatch):
    """The exchange's producer calls, counted at the compressor."""
    calls = []
    orig = comp_lib.HomomorphicCompressor.exchange_wire

    def counted(self, *a, **k):
        calls.append(self.cfg.ratio)
        return orig(self, *a, **k)

    monkeypatch.setattr(comp_lib.HomomorphicCompressor, "exchange_wire", counted)
    return calls


def _loss_grads(cfg, params, batch, remat, ep_exchange=None):
    loss, metrics = lm_loss(params.tree(), cfg, batch, remat=remat,
                            ep_exchange=ep_exchange)
    return loss, metrics, torch.autograd.grad(loss, params.leaves())


@pytest.mark.parametrize("model", ["granite", "deepseek"])
def test_policies_equal_none_bit_for_bit(jparams, model, exchange_calls):
    """Loss, metrics and every gradient under each policy equal
    ``none``'s bit for bit; for deepseek through the compressed exchange
    over 2 EP ranks, whose producers run the same count under each."""
    _, cfg = MODELS[model]
    params = params_from_jax(jparams[model], "cpu")
    batch = device_batch(j_batch_fn(MODELS[model][0], B, S, seed=0)(0), "cpu")
    ex = None
    if cfg.moe is not None:
        ex = make_exchange("compressed", CompressionConfig(**EX), LocalWorkers(2))
    runs, counts = {}, {}
    for remat in REMAT_POLICIES:
        exchange_calls.clear()
        runs[remat] = _loss_grads(cfg, params, batch, remat, ex)
        counts[remat] = len(exchange_calls)
    want_loss, want_m, want_g = runs["none"]
    for remat, (loss, m, g) in runs.items():
        assert torch.equal(loss, want_loss), remat
        assert all(torch.equal(m[k], want_m[k]) for k in want_m), remat
        assert all(torch.equal(a, b) for a, b in zip(g, want_g)), remat
    # layers x EP sources a forward, and none in any recompute
    want = cfg.n_layers * 2 if cfg.moe is not None else 0
    assert counts == dict.fromkeys(REMAT_POLICIES, want)


@pytest.mark.parametrize("model", ["granite", "deepseek"])
def test_block_matches_reference_block(jparams, model):
    """The port under ``block`` against the reference's
    ``jax.value_and_grad`` of ``lm_loss(..., remat="block")``."""
    jcfg, cfg = MODELS[model]
    host = j_batch_fn(jcfg, B, S, seed=0)(0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_lm_loss(p, jcfg, jb, remat="block"), has_aux=True)(
            jparams[model])
    params = params_from_jax(jparams[model], "cpu")
    loss, metrics, grads = _loss_grads(cfg, params, device_batch(host, "cpu"),
                                       "block")
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("nll", "zloss"):
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=1e-5)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)


def test_two_compressed_steps_at_w2_equal_none():
    """Two W=2 ``compressed`` steps (ZeRO-1) under ``block`` leave the
    losses, the parameters and the residuals of ``none``'s bit for bit;
    ``block`` is the train config's default."""
    arch = get_arch("granite-3-2b")
    assert TrainConfig().remat == "block"
    base = dataclasses.replace(arch.train, workers=2, accum_steps=1)
    assert base.remat == "block"
    runs = {}
    for remat in ("none", "block"):
        tc = dataclasses.replace(base, remat=remat)
        runs[remat] = run_training(model_api(arch.smoke), tc, global_batch=B,
                                   seq_len=S, steps=2, device="cpu",
                                   log_every=0)
    a, b = runs["none"], runs["block"]
    assert a.losses == b.losses
    for x, y in zip(a.state.params.leaves(), b.state.params.leaves()):
        assert torch.equal(x, y)
    for x, y in zip(a.state.residual, b.state.residual):
        assert torch.equal(x, y)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat 'bogus'"):
        TrainConfig(remat="bogus")
    _, cfg = MODELS["granite"]
    params = model_api(cfg).init(0, "cpu")
    with pytest.raises(ValueError, match="unknown remat"):
        lm_hidden(params.tree(), cfg, torch.zeros((1, 4), dtype=torch.int64),
                  remat="full")
