"""The encdec family (whisper-tiny) against the JAX reference: the
layers it adds (LayerNorm, the GELU MLP, non-causal and cross attention,
cross-attention decode), the parameter tree, ``encode``, the loss and
its gradients under every remat policy, prefill, decode, ``batch_fn``'s
``frames``, ``ServeEngine.generate(extra=)``, the continuous batcher's
refusal and the serve launcher.

Config: the smoke config of ``configs/whisper_tiny.py`` (2 + 2 layers,
d 128, float32, ``q_block`` 64). Params are the port's draws from seed 0
as one numpy tree, given to the reference as is and to the port through
``params_from_jax``; the reference's caches go across with
``cache_from_jax``.

Tolerances: layers, logits and caches to rtol=1e-5, atol=1e-6 (the
encoder's output to atol=1e-5, see its test); loss and
nll to rtol=1e-5, gradients to rtol=1e-5, atol=1e-7; the port's remat
policies bit for bit with ``none``; its decode against its own prefill
to the reference's consistency bound, atol=2e-3; tokens and ``frames``
exactly equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.whisper_tiny import ARCH as J_WHISPER
from repro.data.pipeline import batch_fn as j_batch_fn
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import model_api as j_model_api
from repro.serve import (ContinuousBatcher as JBatcher, Request as JRequest,
                         ServeEngine as JEngine)
from repro_torch.configs import get_arch
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 params_from_jax, params_to_numpy)
from repro_torch.data.pipeline import Prefetcher, batch_fn, host_tensors
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models.registry import model_api
from repro_torch.models.transformer import REMAT_POLICIES
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine
from repro_torch.train.loop import device_batch

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"
JCFG = J_WHISPER.smoke
CFG = get_arch("whisper-tiny").smoke
B, S, MAX = 2, 8, 12


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """(the port's ParamTree, the reference's params): one numpy tree."""
    np_tree = params_to_numpy(model_api(CFG).init(0, CPU))
    return params_from_jax(np_tree, CPU), jax.tree.map(jnp.asarray, np_tree)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _both(a):
    return torch.from_numpy(a), jnp.asarray(a)


def _frames(batch, seed=3):
    return _rand((batch, CFG.enc_seq, CFG.d_model), seed)


def _prompts(shape, seed=0):
    return np.random.default_rng(seed).integers(1, CFG.vocab, shape,
                                                dtype=np.int32)


def _layer(tree, i):
    """Layer ``i`` of a stacked subtree (either framework's)."""
    return jax.tree.map(lambda t: t[i], tree)


def test_config_and_tree_match_reference():
    """The smoke and published configs field for field, and the built
    trees' paths, shapes, dtypes and flatten order; the published tree has
    31 leaves and 36,487,680 parameters."""
    for got, want in ((CFG, JCFG), (get_arch("whisper-tiny").model,
                                    J_WHISPER.model)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    j_init = lambda c: jax.eval_shape(lambda: JE.init_encdec(
        jax.random.PRNGKey(0), c))
    got = model_api(CFG).init(0, CPU)
    jflat = jax.tree_util.tree_flatten_with_path(j_init(JCFG))[0]
    assert list(got.paths) == [tuple(k.key for k in p) for p, _ in jflat]
    for t, (_, a) in zip(got.leaves(), jflat):
        assert tuple(t.shape) == a.shape and str(t.dtype) == f"torch.{a.dtype}"
    assert "bq" not in got.tree()["dec_layers"]["xattn"]
    assert "w_gate" not in got.tree()["enc_layers"]["mlp"]
    full = jax.tree.leaves(j_init(J_WHISPER.model))
    assert len(full) == 31 and sum(a.size for a in full) == 36_487_680
    built = model_api(get_arch("whisper-tiny").model).init(0, CPU)
    assert [tuple(t.shape) for t in built.leaves()] == [a.shape for a in full]


def test_layernorm_matches_reference():
    """With the config's eps (1e-6, not the function's default) and a
    scale and bias that are not ones and zeros."""
    p = {"scale": torch.from_numpy(_rand((CFG.d_model,), 1)),
         "bias": torch.from_numpy(_rand((CFG.d_model,), 2))}
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    x, jx = _both(_rand((B, S, CFG.d_model), 0) * 3 + 1)
    got = L.layernorm(x, p, CFG.norm_eps)
    want = JL.layernorm(jx, jp, JCFG.norm_eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_mlp_matches_reference(params):
    """The tanh form of GELU (``jax.nn.gelu``'s default), not torch's
    exact default."""
    tree, jtree = params[0].tree(), params[1]
    p = {k: v[0] for k, v in tree["enc_layers"]["mlp"].items()}
    x, jx = _both(_rand((B, S, CFG.d_model), 4) * 4)
    got = L.mlp(x, p)
    want = JL.mlp(jx, _layer(jtree["enc_layers"]["mlp"], 0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# (what, query length, key length): the encoder's non-causal
# self-attention; cross-attention at the smoke enc_seq; at 100 frames,
# which the reference pads to two query blocks of 64; at 1,100, past its
# 1,024-key block (the keys padded to 2,048, the padding masked, two
# blocks of online softmax)
ATTN_CASES = [("self", 64, 64), ("self", 100, 100), ("cross", 8, 64),
              ("cross", 8, 100), ("cross", 100, 1100)]


@pytest.mark.parametrize("kind,sq,skv", ATTN_CASES)
def test_attention_train_matches_reference(params, kind, sq, skv):
    tree, jtree = params[0].tree(), params[1]
    key = "enc_layers" if kind == "self" else "dec_layers"
    sub = "attn" if kind == "self" else "xattn"
    p = {k: v[0] for k, v in tree[key][sub].items()}
    jp = _layer(jtree[key][sub], 0)
    x, jx = _both(_rand((B, sq, CFG.d_model), 5))
    kw, jkw = {"causal": False}, {"causal": False}
    if kind == "cross":
        kv, jkv = _both(_rand((B, skv, CFG.d_model), 6))
        kw["kv_input"], jkw["kv_input"] = kv, jkv
    got, (k, v) = L.attention_train(x, p, CFG, **kw)
    want, (jk, jv) = jax.jit(lambda x_, kv_: JL.attention_train(
        x_, jp, JCFG, causal=False, kv_input=kv_))(jx, jkw.get("kv_input"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.detach().numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), **TOL)


def test_attention_cross_decode_matches_reference(params):
    tree, jtree = params[0].tree(), params[1]
    p = {k: v[0] for k, v in tree["dec_layers"]["xattn"].items()}
    x, jx = _both(_rand((B, 1, CFG.d_model), 7))
    shape = (B, CFG.enc_seq, CFG.n_kv_heads, CFG.hd)
    ek, jek = _both(_rand(shape, 8))
    ev, jev = _both(_rand(shape, 9))
    got = L.attention_cross_decode(x, p, CFG, ek, ev)
    want = JL.attention_cross_decode(jx, _layer(jtree["dec_layers"]["xattn"], 0),
                                     JCFG, jek, jev)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_sinusoid_matches_reference():
    """sin and cos concatenated, not interleaved, in f32."""
    np.testing.assert_allclose(E._sinusoid(CFG.enc_seq, CFG.d_model).numpy(),
                               np.asarray(JE._sinusoid(JCFG.enc_seq,
                                                       JCFG.d_model)), **TOL)


def test_encode_matches_reference(params):
    """The encoder blocks, whose self-attention takes RoPE as the
    reference's does, against the reference's jitted ``encode``. atol
    1e-5 on these unit-scale outputs: under jit XLA fuses the sinusoid's
    ``pow`` and ``sin`` into an approximation that differs from its own
    eager values (and the port's) by up to 3.8e-6 at this size."""
    tree, jtree = params
    f, jf = _both(_frames(B))
    got = E.encode(tree.tree(), CFG, f)
    want = jax.jit(lambda p, x: JE.encode(p, JCFG, x))(jtree, jf)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def grads(params):
    """The reference's loss, nll and gradients under ``none`` and
    ``block`` on one batch, and the batch."""
    _, jtree = params
    host = j_batch_fn(JCFG, B, 16, seed=0)(0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    japi = j_model_api(JCFG)
    out = {}
    for remat in ("none", "block"):
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda p: japi.loss(p, jb, remat=remat), has_aux=True))(jtree)
        out[remat] = (float(jl), float(jm["nll"]),
                      [np.asarray(g) for g in jax.tree.leaves(jg)])
    return host, out


def _port_grads(tree, host, remat):
    loss, metrics = model_api(CFG).loss(tree.tree(), device_batch(host, CPU),
                                        remat=remat)
    return loss, metrics, torch.autograd.grad(loss, tree.leaves())


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_grads_match_reference(params, grads, remat):
    host, want = grads
    loss, metrics, got = _port_grads(params[0], host, remat)
    jl, jnll, jg = want[remat]
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    np.testing.assert_allclose(metrics["nll"].item(), jnll, rtol=1e-5)
    assert metrics["aux"].item() == 0.0
    for g, w in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)


def test_remat_policies_bit_for_bit(params, grads):
    """``block`` and ``dots`` checkpoint each decoder layer,
    ``block_nocse`` runs as ``none`` (the reference's mapping); values
    and gradients equal ``none``'s bit for bit."""
    host, _ = grads
    base_loss, _, base = _port_grads(params[0], host, "none")
    for remat in REMAT_POLICIES[1:]:
        loss, _, got = _port_grads(params[0], host, remat)
        assert torch.equal(loss, base_loss), remat
        assert all(torch.equal(a, b) for a, b in zip(got, base)), remat


def test_loss_refuses_an_exchange_and_unknown_remat(params):
    host = j_batch_fn(JCFG, B, 16, seed=0)(0)
    api = model_api(CFG)
    with pytest.raises(ValueError, match="no MoE"):
        api.loss(params[0].tree(), device_batch(host, CPU), ep_exchange=object())
    with pytest.raises(ValueError, match="unknown remat"):
        api.loss(params[0].tree(), device_batch(host, CPU), remat="bogus")


def test_init_cache_matches_reference(params):
    tree, jtree = params
    want = j_model_api(JCFG).init_cache(jtree, 3, 20)
    got = model_api(CFG).init_cache(tree.tree(), 3, 20)
    assert sorted(got) == sorted(want) == ["k", "v", "xk", "xv"]
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        assert not got[k].any()


def _close_caches(got, want):
    got, want = cache_to_numpy(got), jax.tree.map(np.asarray, want)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **TOL)


def test_prefill_and_decode_match_reference(params):
    """Prefill (last logits; the self K/V padded to ``max_len``, the
    cross K/V), then one decode from the reference's cache, fed the
    reference's greedy token."""
    tree, jtree = params
    japi, api = j_model_api(JCFG), model_api(CFG)
    toks, frames = _prompts((B, S)), _frames(B)
    jl, jc = jax.jit(lambda p, b: japi.prefill(p, b, MAX))(
        jtree, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    with torch.inference_mode():
        logits, cache = api.prefill(tree.tree(), {
            "tokens": torch.from_numpy(toks).long(),
            "frames": torch.from_numpy(frames)}, MAX)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _close_caches(cache, jc)
    cache = cache_from_jax(jax.tree.map(np.asarray, jc), device=CPU)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    jl, jc = jax.jit(japi.decode)(jtree, jnp.asarray(tok), jc, jnp.int32(S))
    with torch.inference_mode():
        logits, cache = api.decode(tree.tree(), torch.from_numpy(tok).long(),
                                   cache, S)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _close_caches(cache, jc)


def test_prefill_decode_consistency_on_the_port(params):
    """Prefill 12 tokens then decode 3 equals the prefill of all 15 (the
    reference's own check, ``tests/test_decode_consistency.py``, at its
    atol 2e-3)."""
    api, tree = model_api(CFG), params[0].tree()
    toks = torch.from_numpy(_prompts((2, 15), seed=2).astype(np.int64))
    frames = torch.from_numpy(_frames(2, seed=4))
    with torch.inference_mode():
        _, cache = api.prefill(tree, {"tokens": toks[:, :12],
                                      "frames": frames}, 20)
        for i in range(3):
            logits_d, cache = api.decode(tree, toks[:, 12 + i], cache, 12 + i)
        logits_p, _ = api.prefill(tree, {"tokens": toks, "frames": frames}, 20)
    np.testing.assert_allclose(logits_d.numpy(), logits_p.numpy(), atol=2e-3)


@pytest.mark.parametrize("step", [0, 3])
def test_batch_frames_equal_reference_bit_for_bit(step):
    got = batch_fn(CFG, B, S, seed=5)(step)
    want = j_batch_fn(JCFG, B, S, seed=5)(step)
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["frames"].shape == (B, CFG.enc_seq, CFG.d_model)
    assert got["frames"].dtype == np.float32


def test_device_batch_and_prefetcher_keep_frames_f32():
    make = batch_fn(CFG, B, S, seed=1)
    host = make(0)
    for got in (device_batch(host, CPU), host_tensors(host)):
        assert got["tokens"].dtype == torch.int64
        assert got["frames"].dtype == torch.float32
        np.testing.assert_array_equal(got["frames"].numpy(), host["frames"])
    pf = Prefetcher(make, device=CPU, start_step=0)
    try:
        step, got = next(pf)
        assert step == 0 and got["frames"].dtype == torch.float32
        np.testing.assert_array_equal(got["frames"].numpy(), host["frames"])
    finally:
        pf.close()


def test_generate_with_frames_matches_reference(params):
    tree, jtree = params
    toks, frames = _prompts((B, S), seed=6), _frames(B, seed=7)
    jeng = JEngine(j_model_api(JCFG), jtree, max_len=MAX + 4, batch=B)
    want = jeng.generate(toks, 6, extra={"frames": frames})
    eng = ServeEngine(model_api(CFG), tree, max_len=MAX + 4, batch=B)
    got = eng.generate(toks, 6, extra={"frames": frames})
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (B, 6)


def test_batchers_raise_without_frames(params):
    """The batcher's single-request prefill passes the prompt alone, so
    both packages fail at the first admission for want of ``frames``."""
    tree, jtree = params
    prompt = _prompts((5,), seed=1)
    jb = JBatcher(JEngine(j_model_api(JCFG), jtree, max_len=MAX, batch=2))
    jb.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        jb.run(decode_steps=4)
    pb = ContinuousBatcher(ServeEngine(model_api(CFG), tree, max_len=MAX, batch=2))
    pb.submit(Request(uid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        pb.run(decode_steps=4)


def test_serve_launcher_takes_whisper(capsys):
    """Batch mode: ``frames`` from the prompts' generator, greedy tokens
    of the batch's shape, equal to ``generate`` on the same draws;
    ``--continuous`` raises ``KeyError`` as the reference's launcher."""
    from repro_torch.launch.serve import main as serve
    argv = ["--arch", "whisper-tiny", "--smoke", "--batch", "2",
            "--prompt-len", "8", "--max-new", "4", "--device", "cpu"]
    toks = serve(argv)
    assert toks.shape == (2, 4)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, CFG.vocab, (2, 8), dtype=np.int32)
    frames = rng.normal(0, 1, (2, CFG.enc_seq, CFG.d_model)).astype(np.float32)
    eng = ServeEngine(model_api(CFG), model_api(CFG).init(0, CPU),
                      max_len=8 + 4 + 8, batch=2)
    np.testing.assert_array_equal(
        toks, eng.generate(prompts, 4, extra={"frames": frames}))
    with pytest.raises(KeyError, match="frames"):
        serve(argv + ["--continuous"])
    capsys.readouterr()


def test_train_launcher_takes_whisper(capsys):
    from repro_torch.launch.train import main as train
    out = train(["--arch", "whisper-tiny", "--smoke", "--steps", "2",
                 "--global-batch", "4", "--seq-len", "16", "--device", "cpu"])
    assert out["arch"] == "whisper-tiny" and len(out["losses"]) == 2
    assert out["aggregator"] == "compressed"
    assert all(np.isfinite(out["losses"]))
    capsys.readouterr()
