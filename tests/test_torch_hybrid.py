"""The hybrid family (jamba: Mamba2 + attention superblocks with MoE) and
the ssm family's model level against the JAX reference: the parameter
tree, loss and gradients under the remat policies, prefill, decode, the
continuous batcher's splice.

Configs: the smoke configs of ``configs/jamba_v0_1_52b.py`` (4 layers,
``attn_period`` 2: superblocks of one Mamba and one attention layer,
MoE on the odd position) and ``configs/mamba2_1_3b.py``, float32. Params
are the port's draws from seed 0 as one numpy tree, given to the
reference as is and to the port through ``params_from_jax``; the
reference's caches go across with ``cache_from_jax``.

Tolerances: loss to rtol=1e-5 and gradients to rtol=1e-5, atol=1e-7, as
``tests/test_torch_train.py`` holds granite; logits and caches to
rtol=1e-5, atol=1e-6 as ``tests/test_torch_serve.py``; the port's remat
policies bit for bit with each other; generated tokens exactly equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.jamba_v0_1_52b import ARCH as J_JAMBA
from repro.configs.mamba2_1_3b import ARCH as J_MAMBA
from repro.data.pipeline import batch_fn as j_batch_fn
from repro.models import model_api as j_model_api
from repro.models.transformer import init_lm as j_init_lm
from repro.serve import (ContinuousBatcher as JBatcher, Request as JRequest,
                         ServeEngine as JEngine)
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 params_from_jax, params_to_numpy)
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models.registry import model_api
from repro_torch.models.transformer import REMAT_POLICIES
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine
from repro_torch.train.loop import device_batch

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"
MODELS = {"jamba": J_JAMBA.smoke, "mamba": J_MAMBA.smoke}


def port_cfg(jcfg) -> ModelConfig:
    """The reference's ``ModelConfig`` as the port's, field for field."""
    d = dataclasses.asdict(jcfg)
    d["moe"] = None if jcfg.moe is None else MoEConfig(**d["moe"])
    d["ssm"] = None if jcfg.ssm is None else SSMConfig(**d["ssm"])
    return ModelConfig(**d)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """The reference's and the port's API and params for one config."""

    def __init__(self, jcfg):
        self.jcfg, self.cfg = jcfg, port_cfg(jcfg)
        self.japi, self.api = j_model_api(jcfg), model_api(self.cfg)
        np_tree = params_to_numpy(self.api.init(0, CPU))
        self.np_params = np_tree
        self.jparams = jax.tree.map(jnp.asarray, np_tree)
        self.params = params_from_jax(np_tree, device=CPU)
        self.tree = self.params.tree()
        self._jprefill, self._jdecode = {}, jax.jit(self.japi.decode)

    def prefill_fn(self, max_len):
        if max_len not in self._jprefill:
            self._jprefill[max_len] = jax.jit(
                lambda p, b: self.japi.prefill(p, b, max_len))
        return self._jprefill[max_len]

    def jengine(self, max_len, batch):
        eng = JEngine(self.japi, self.jparams, max_len=max_len, batch=batch)
        eng._prefill, eng._decode = self.prefill_fn(max_len), self._jdecode
        return eng


_PAIRS = {}


def pair(name) -> Pair:
    if name not in _PAIRS:
        _PAIRS[name] = Pair(MODELS[name])
    return _PAIRS[name]


S, MAX = 8, 12


def _prompts(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, shape,
                                                dtype=np.int32)


def _close_caches(got, want):
    got, want = cache_to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TOL), got, want)


def test_jamba_param_tree_matches_reference():
    """Paths (``superblocks/pos0..``, ``A_log`` / ``D_skip`` before the
    lower-case keys), shapes, dtypes and the flatten order the
    compressed wire packs by."""
    cfg = port_cfg(J_JAMBA.smoke)
    want = jax.eval_shape(lambda: j_init_lm(jax.random.PRNGKey(0), J_JAMBA.smoke))
    got = model_api(cfg).init(0, CPU)
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert list(got.paths) == [tuple(k.key for k in p) for p, _ in jflat]
    for t, (_, a) in zip(got.leaves(), jflat):
        assert tuple(t.shape) == a.shape and str(t.dtype) == f"torch.{a.dtype}"
    n_super = cfg.n_layers // cfg.attn_period
    assert tuple(got.tree()["superblocks"]["pos0"]["mamba"]["wx"].shape)[0] \
        == n_super
    assert "moe" in got.tree()["superblocks"]["pos1"]
    assert "ffn" in got.tree()["superblocks"]["pos0"]


@pytest.fixture(scope="module")
def jamba_grads():
    """The reference's loss and gradients under ``none`` and ``block`` on
    one batch, and the batch."""
    pr = pair("jamba")
    host = j_batch_fn(pr.jcfg, 2, 40, seed=0)(0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    out = {}
    for remat in ("none", "block"):
        (jl, _), jg = jax.value_and_grad(
            lambda p: pr.japi.loss(p, jb, remat=remat), has_aux=True)(pr.jparams)
        out[remat] = (float(jl), [np.asarray(g) for g in jax.tree.leaves(jg)])
    return host, out


def _port_grads(pr, host, remat):
    loss, _ = pr.api.loss(pr.tree, device_batch(host, CPU), remat=remat)
    return loss, torch.autograd.grad(loss, pr.params.leaves())


@pytest.mark.parametrize("remat", ["none", "block"])
def test_jamba_loss_and_grads_match_reference(jamba_grads, remat):
    host, want = jamba_grads
    pr = pair("jamba")
    loss, grads = _port_grads(pr, host, remat)
    jl, jg = want[remat]
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    for g, w in zip(grads, jg):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)


def test_jamba_remat_policies_bit_for_bit(jamba_grads):
    """Each policy checkpoints a whole superblock; values and gradients
    equal ``none``'s bit for bit."""
    host, _ = jamba_grads
    pr = pair("jamba")
    base_loss, base = _port_grads(pr, host, "none")
    for remat in REMAT_POLICIES[1:]:
        loss, grads = _port_grads(pr, host, remat)
        assert torch.equal(loss, base_loss), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, base)), remat


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_cache_matches_reference(name):
    pr = pair(name)
    want = pr.japi.init_cache(pr.jparams, 3, 20)
    got = pr.api.init_cache(pr.tree, 3, 20)
    assert jax.tree.structure(cache_to_numpy(got)) == jax.tree.structure(want)
    for (_, t), a in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                         jax.tree.leaves(want)):
        assert tuple(t.shape) == a.shape and str(t.dtype) == f"torch.{a.dtype}"
        assert not t.any()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_and_decode_match_reference(name):
    """Prefill (last logits, the cache: Mamba states and, for jamba, the
    padded K/V), then three decode steps from the reference's cache fed
    the reference's greedy tokens."""
    pr = pair(name)
    toks = _prompts(pr.cfg, (2, S))
    jl, jc = pr.prefill_fn(MAX)(pr.jparams, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        logits, cache = pr.api.prefill(
            pr.tree, {"tokens": torch.from_numpy(toks).long()}, MAX)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _close_caches(cache, jc)
    cache = cache_from_jax(jax.tree.map(np.asarray, jc), device=CPU)
    jl = np.asarray(jl)
    for pos in range(S, S + 3):
        tok = np.argmax(jl, axis=-1).astype(np.int32)
        jl, jc = pr._jdecode(pr.jparams, jnp.asarray(tok), jc, jnp.int32(pos))
        jl = np.asarray(jl)
        with torch.inference_mode():
            logits, cache = pr.api.decode(pr.tree, torch.from_numpy(tok).long(),
                                          cache, pos)
        np.testing.assert_allclose(logits.numpy(), jl, **TOL)
        _close_caches(cache, jc)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_decode_consistency_on_the_port(name):
    """Prefill S then decode 3 tokens equals the prefill of S + 3 tokens
    (the reference's own check, ``tests/test_decode_consistency.py``,
    at its atol 2e-3). jamba's MoE layers run at both capacity factors
    E / K, so that no token drops in either."""
    pr = pair(name)
    cfg = pr.cfg
    if cfg.moe is not None:
        cf = cfg.moe.num_experts / cfg.moe.top_k
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf, capacity_factor_decode=cf))
    api = model_api(cfg)
    toks = torch.from_numpy(_prompts(cfg, (2, 15), seed=2).astype(np.int64))
    with torch.inference_mode():
        _, cache = api.prefill(pr.tree, {"tokens": toks[:, :12]}, 20)
        for i in range(3):
            logits_d, cache = api.decode(pr.tree, toks[:, 12 + i], cache, 12 + i)
        logits_p, _ = api.prefill(pr.tree, {"tokens": toks}, 20)
    np.testing.assert_allclose(logits_d.numpy(), logits_p.numpy(), atol=2e-3)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_continuous_batcher_matches_reference(name):
    """5 requests over 2 slots. For mamba the batch is axis 1 of every
    cache leaf; for jamba (``attn_period`` 2) the splice keeps the
    reference's semantics: slot 0's admission writes its Mamba state
    over every slot, a later slot's writes none. The completions match
    uid for uid and token for token."""
    pr = pair(name)
    # two prompt lengths: each is one compile of the reference's prefill
    lens, news = (5, 9, 5, 9, 5), (4, 3, 5, 4, 6)
    reqs = [(u, _prompts(pr.cfg, (n,), seed=10 + u), m)
            for u, (n, m) in enumerate(zip(lens, news))]
    jb = JBatcher(pr.jengine(MAX, 2))
    pb = ContinuousBatcher(ServeEngine(pr.api, pr.params, max_len=MAX, batch=2))
    for u, prompt, m in reqs:
        jb.submit(JRequest(uid=u, prompt=prompt, max_new_tokens=m))
        pb.submit(Request(uid=u, prompt=prompt, max_new_tokens=m))
    want = [(c.uid, c.tokens) for c in jb.run(decode_steps=64)]
    got = [(c.uid, c.tokens) for c in pb.run(decode_steps=64)]
    assert got == want
    assert [len(t) for _, t in sorted(got)] == list(news)


def test_generate_matches_reference():
    pr = pair("jamba")
    toks = _prompts(pr.cfg, (2, S), seed=4)
    want = pr.jengine(MAX, 2).generate(toks, 4)
    got = ServeEngine(pr.api, pr.params, max_len=MAX, batch=2).generate(toks, 4)
    np.testing.assert_array_equal(got, want)


def test_batchers_raise_at_the_published_period():
    """``attn_period`` 8 (jamba's published one) at 8 layers: the Mamba
    leaves ``(1, 7, B, ...)`` do not broadcast into a slot, and both
    batchers raise at the first admission."""
    jcfg = dataclasses.replace(J_JAMBA.smoke, n_layers=8, attn_period=8,
                               attn_offset=4)
    cfg = port_cfg(jcfg)
    api = model_api(cfg)
    np_tree = params_to_numpy(api.init(0, CPU))
    prompt = _prompts(cfg, (4,), seed=1)
    jeng = JEngine(j_model_api(jcfg), jax.tree.map(jnp.asarray, np_tree),
                   max_len=MAX, batch=2)
    jb = JBatcher(jeng)
    jb.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(ValueError, match="broadcasting"):
        jb.run(decode_steps=4)
    pb = ContinuousBatcher(ServeEngine(api, params_from_jax(np_tree, CPU),
                                       max_len=MAX, batch=2))
    pb.submit(Request(uid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(RuntimeError, match="must match"):
        pb.run(decode_steps=4)
