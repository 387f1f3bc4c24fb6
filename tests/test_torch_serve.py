"""The port's serving path against the JAX reference: prefill, KV-cache
decode, ``ServeEngine`` and ``ContinuousBatcher``, and the serve
launcher's batch and ``--continuous`` modes.

Configs: the smoke configs of ``configs/granite_3_2b.py`` and
``configs/deepseek_moe_16b.py`` (float32), and the dense config of
``tests/test_decode_consistency.py`` (``qkv_bias=True``). Params are
one numpy tree (the port's draws from seed 0) given to the reference
as is and to the port through ``params_from_jax``; the reference's
caches go across with ``cache_from_jax``.

Tolerances: logits and caches to rtol=1e-5, atol=1e-6 (the two
frameworks run the same f32 math in their own matmul and reduction
orders); generated tokens exactly equal. The prefill/decode consistency
is the reference's own check at its bound, atol=2e-3.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.deepseek_moe_16b import ARCH as J_MOE
from repro.configs.granite_3_2b import ARCH as J_DENSE
from repro.models import ModelConfig as JModelConfig
from repro.models import MoEConfig as JMoEConfig
from repro.models import model_api as j_model_api
from repro.serve import (ContinuousBatcher as JBatcher, Request as JRequest,
                         ServeEngine as JEngine)
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 params_from_jax, params_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.registry import model_api
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"
# the dense config of tests/test_decode_consistency.py
J_BIAS = JModelConfig(name="d", family="dense", qkv_bias=True, n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=256, dtype="float32", q_block=16)


def _cfg(jcfg):
    moe = None if jcfg.moe is None else MoEConfig(**dataclasses.asdict(jcfg.moe))
    return ModelConfig(**{**dataclasses.asdict(jcfg), "moe": moe})


MODELS = {"granite": J_DENSE.smoke, "deepseek": J_MOE.smoke,
          "dense_bias": J_BIAS}


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """The reference's and the port's API and params for one config.
    ``like`` lends another pair's params: a config that differs only in
    its capacity factors draws the same ones."""

    def __init__(self, jcfg, like: "Pair" = None):
        self.jcfg, self.cfg = jcfg, _cfg(jcfg)
        self.japi, self.api = j_model_api(jcfg), model_api(self.cfg)
        if like is None:
            # the port's draws from seed 0 as one numpy tree, given to
            # both sides: far cheaper than compiling the reference's init
            np_tree = params_to_numpy(self.api.init(0, CPU))
            self.jparams = jax.tree.map(jnp.asarray, np_tree)
            self.params = params_from_jax(np_tree, device=CPU)
        else:
            self.jparams, self.params = like.jparams, like.params
        self.tree = self.params.tree()
        self._jprefill, self._jdecode = {}, jax.jit(self.japi.decode)

    def _prefill_fn(self, max_len):
        if max_len not in self._jprefill:
            self._jprefill[max_len] = jax.jit(
                lambda p, b: self.japi.prefill(p, b, max_len))
        return self._jprefill[max_len]

    def jengine(self, max_len, batch):
        """The reference's ``ServeEngine`` on the pair's jitted prefill
        and decode (the functions it jits itself), so that each shape
        compiles once in the module."""
        eng = JEngine(self.japi, self.jparams, max_len=max_len, batch=batch)
        eng._prefill, eng._decode = self._prefill_fn(max_len), self._jdecode
        return eng

    def jprefill(self, tokens, max_len):
        logits, cache = self._prefill_fn(max_len)(
            self.jparams, {"tokens": jnp.asarray(tokens)})
        return np.asarray(logits), cache

    def jdecode(self, tok, cache, pos):
        logits, cache = self._jdecode(self.jparams, jnp.asarray(tok), cache,
                                      jnp.int32(pos))
        return np.asarray(logits), cache

    def prefill(self, tokens, max_len):
        with torch.inference_mode():
            logits, cache = self.api.prefill(
                self.tree, {"tokens": torch.from_numpy(tokens).long()}, max_len)
        return logits.numpy(), cache

    def decode(self, tok, cache, pos):
        with torch.inference_mode():
            logits, cache = self.api.decode(
                self.tree, torch.from_numpy(np.asarray(tok)).long(), cache, pos)
        return logits.numpy(), cache


_PAIRS = {}


def pair(name) -> Pair:
    if name not in _PAIRS:
        _PAIRS[name] = Pair(MODELS[name])
    return _PAIRS[name]


# prompts of (B, S) = (2, 8) into caches of MAX positions in most tests,
# so that the reference compiles those shapes once
S, MAX = 8, 12


def _prompts(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, shape,
                                                dtype=np.int32)


def _close_caches(got, want):
    got, want = cache_to_numpy(got), jax.tree.map(np.asarray, want)
    assert sorted(got) == sorted(want) == ["k", "v"]
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_cache_matches_reference(name):
    pr = pair(name)
    want = pr.japi.init_cache(pr.jparams, 3, 20)
    got = pr.api.init_cache(pr.tree, 3, 20)
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape == (
            pr.cfg.n_layers, 3, 20, pr.cfg.n_kv_heads, pr.cfg.hd)
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        assert not got[k].any()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_matches_reference(name):
    """Last-position logits and the padded cache (K after RoPE)."""
    pr = pair(name)
    toks = _prompts(pr.cfg, (2, S))
    jl, jc = pr.jprefill(toks, MAX)
    logits, cache = pr.prefill(toks, MAX)
    assert logits.shape == (2, pr.cfg.padded_vocab)
    np.testing.assert_allclose(logits, jl, **TOL)
    _close_caches(cache, jc)
    assert not cache["k"][:, :, S:].any()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decode_matches_reference_from_its_cache(name):
    """Three decode steps, both sides fed the reference's prefill cache
    (through ``cache_from_jax``) and the reference's greedy tokens."""
    pr = pair(name)
    toks = _prompts(pr.cfg, (2, S), seed=1)
    jl, jc = pr.jprefill(toks, MAX)
    cache = cache_from_jax(jax.tree.map(np.asarray, jc), device=CPU)
    pos = S
    for _ in range(3):
        tok = np.argmax(jl, axis=-1).astype(np.int32)
        jl, jc = pr.jdecode(tok, jc, pos)
        logits, cache = pr.decode(tok, cache, pos)
        np.testing.assert_allclose(logits, jl, **TOL)
        _close_caches(cache, jc)
        pos += 1


# the reference's own consistency check (tests/test_decode_consistency.py)
CONSISTENCY = {
    "dense": J_BIAS,
    "moe": JModelConfig(name="m", family="moe",
                        moe=JMoEConfig(num_experts=8, top_k=2,
                                       shared_experts=1, expert_d_ff=64,
                                       capacity_factor=4.0,
                                       capacity_factor_decode=8.0),
                        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, dtype="float32", q_block=16)}


@pytest.mark.parametrize("family", sorted(CONSISTENCY))
def test_prefill_decode_consistency_on_the_port(family):
    """Prefill S then decode 3 tokens equals the prefill of S + 3 tokens
    (the port's own params from a seed)."""
    cfg = _cfg(CONSISTENCY[family])
    api = model_api(cfg)
    tree = api.init(0, CPU).tree()
    toks = torch.from_numpy(_prompts(cfg, (2, 15)).astype(np.int64))
    S, MAX = 12, 20
    with torch.inference_mode():
        _, cache = api.prefill(tree, {"tokens": toks[:, :S]}, MAX)
        for i in range(3):
            logits_d, cache = api.decode(tree, toks[:, S + i], cache, S + i)
        logits_p, _ = api.prefill(tree, {"tokens": toks}, MAX)
    np.testing.assert_allclose(logits_d.numpy(), logits_p.numpy(), atol=2e-3)


def test_moe_decode_drops_tokens_as_the_reference(monkeypatch):
    """deepseek's smoke config with ``capacity_factor_decode=0.5``: at
    B = 4, K = 2, E = 8 an expert keeps C = 1 slot, so tokens drop; the
    port drops the reference's and its logits match."""
    jcfg = dataclasses.replace(J_MOE.smoke, moe=dataclasses.replace(
        J_MOE.smoke.moe, capacity_factor_decode=0.5))
    pr = Pair(jcfg, like=pair("deepseek"))
    dropped = []
    route = L.moe_route

    def spy(x, p, m, capacity_factor=None):
        rt = route(x, p, m, capacity_factor)
        if capacity_factor == 0.5:
            dropped.append(int((rt.tok_slots == rt.gather_idx.numel()).sum()))
        return rt

    monkeypatch.setattr(L, "moe_route", spy)
    toks = _prompts(pr.cfg, (4, 10), seed=2)
    jl, jc = pr.jprefill(toks, 16)
    cache = cache_from_jax(jax.tree.map(np.asarray, jc), device=CPU)
    for pos in (10, 11):
        tok = np.argmax(jl, axis=-1).astype(np.int32)
        jl, jc = pr.jdecode(tok, jc, pos)
        logits, cache = pr.decode(tok, cache, pos)
        np.testing.assert_allclose(logits, jl, **TOL)
        _close_caches(cache, jc)
    assert len(dropped) == 2 * pr.cfg.n_layers
    assert sum(dropped) > 0, dropped


def test_decode_past_max_len_matches_reference():
    """Positions 8..15 into a cache of 12: from position 12 on the write
    lands on the last entry (the clamp), RoPE takes the unclamped
    position and every key is valid."""
    pr = pair("granite")
    toks = _prompts(pr.cfg, (2, S), seed=3)
    jl, jc = pr.jprefill(toks, MAX)
    cache = cache_from_jax(jax.tree.map(np.asarray, jc), device=CPU)
    for pos in range(S, MAX + 4):
        tok = np.argmax(jl, axis=-1).astype(np.int32)
        jl, jc = pr.jdecode(tok, jc, pos)
        logits, cache = pr.decode(tok, cache, pos)
        np.testing.assert_allclose(logits, jl, **TOL)
        _close_caches(cache, jc)
    assert tuple(cache["k"].shape)[2] == MAX


@pytest.mark.parametrize("name", ["granite", "deepseek"])
def test_generate_matches_reference(name):
    pr = pair(name)
    toks = _prompts(pr.cfg, (2, S), seed=4)
    want = pr.jengine(MAX, 2).generate(toks, 4)
    eng = ServeEngine(pr.api, pr.params, max_len=MAX, batch=2)
    got = eng.generate(toks, 4)
    assert got.dtype == np.int32 and got.shape == (2, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(toks, 4), got)


@pytest.mark.parametrize("name", ["granite", "deepseek"])
def test_continuous_batcher_matches_reference(name):
    """5 requests of different prompt lengths over 2 slots: the shared
    position reaches 12, past ``max_len`` 12, in the later waves. The
    completions match uid for uid and token for token."""
    pr = pair(name)
    lens, news = (5, 9, 4, 7, 6), (4, 3, 5, 4, 6)
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
    assert sorted(u for u, _ in got) == [0, 1, 2, 3, 4]
    assert [len(t) for _, t in sorted(got)] == list(news)


@pytest.mark.parametrize("name", ["granite", "deepseek"])
def test_continuous_single_request_equals_generate(name):
    pr = pair(name)
    prompt = np.arange(1, S + 1, dtype=np.int32)
    eng = ServeEngine(pr.api, pr.params, max_len=MAX, batch=1)
    want = eng.generate(prompt[None], max_new=6)[0]
    cb = ContinuousBatcher(eng)
    cb.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
    done = cb.run(decode_steps=16)
    assert [c.uid for c in done] == [0]
    assert done[0].tokens == want.tolist()


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_serve_launcher_modes(capsys, mode):
    """``python -m repro_torch.launch.serve --arch granite-3-2b --smoke
    --device cpu [--continuous]``: the reference's lines and counts at
    its defaults (batch 4, prompt 16, 32 new tokens)."""
    from repro_torch.launch.serve import main
    argv = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu"]
    res = main(argv + (["--continuous"] if mode == "continuous" else []))
    lines = capsys.readouterr().out.strip().splitlines()
    rate = r" in \d+\.\d\ds \(\d+\.\d tok/s\)"
    if mode == "batch":
        assert len(lines) == 2
        assert re.fullmatch(r"batch generate: \(4, 32\) tokens" + rate,
                            lines[0]), lines[0]
        assert lines[1] == f"first row: {res[0][:16].tolist()}"
        assert res.shape == (4, 32)
    else:
        assert len(lines) == 1
        assert re.fullmatch(r"continuous: 8 requests, 256 tokens" + rate,
                            lines[0]), lines[0]
        assert sorted(c.uid for c in res) == list(range(8))
