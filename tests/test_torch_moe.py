"""The MoE family of the PyTorch port against the JAX reference, at the
smoke config of ``configs/deepseek_moe_16b.py`` (2 layers, d_model 128,
8 experts of d_ff 128, top-2, 2 shared, vocab 512, float32).

Tolerances: the two frameworks run the same f32 math with their own
matmul and reduction orders, so ``moe_ffn``'s output, aux and gradients,
and the LM loss and its gradients, agree to rtol=1e-5 with atol=1e-7
(the bound of ``test_torch_train.py``'s loss-and-grads test; the scalar
is a mean, so gradients are of the order of the loss's), and loss curves
to rtol=1e-5.

With an exchange, the forward is the wire's value: each EP rank's
partial combine (its expert group's slots, added in slot order) summed
over the ranks, against the local combine's one sum in slot order. At
ratio 2.5 and G = 2 every element of a block has a cell of its own in
each lane, so the compressed wire reads every value back exactly and
equals the dense wire; only the regrouping of each token's K terms
rounds. Held to rtol=1e-6, atol=1e-7: at top-2 no token's two terms are
regrouped (the forward is measured equal bit for bit); at top-6 the
largest difference measured here is a few f32 ulps. The gradient runs
through the local combine (the splice), so for a scalar linear in the
output it equals the local combine's bit for bit; the W = 2 x
``ep_workers`` 2 training losses of ``none``, ``dense`` and
``compressed`` agree to rtol=1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.configs.deepseek_moe_16b import ARCH as JARCH
from repro.core import CompressionConfig as JaxCompression
from repro.core.aggregators import make_exchange as j_make_exchange
from repro.data.pipeline import batch_fn as j_batch_fn
from repro.models import layers as JL
from repro.models import model_api as j_model_api
from repro.models.transformer import init_lm as j_init_lm, lm_loss as j_lm_loss
from repro.parallel.sharding import ShardingProfile
from repro.train import OptimizerConfig as JOpt, TrainConfig as JTrain
from repro.train.loop import run_training as j_run_training
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.aggregators import make_exchange
from repro_torch.core.collectives import LocalWorkers
from repro_torch.core.config import CompressionConfig
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.registry import model_api
from repro_torch.models.transformer import lm_loss
from repro_torch.train.config import TrainConfig
from repro_torch.train.loop import device_batch, run_training
from repro_torch.train.optimizer import OptimizerConfig

JCFG = JARCH.smoke
CFG = ModelConfig(**{**dataclasses.asdict(JCFG),
                     "moe": MoEConfig(**dataclasses.asdict(JCFG.moe))})
B, S, T = 4, 32, 64
EX = dict(ratio=2.5, topk_ratio=None, error_feedback=False, lanes=128,
          use_pallas="never")
TOL = dict(rtol=1e-5, atol=1e-7)


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
    return jax.tree.map(np.asarray, j_init_lm(jax.random.PRNGKey(0), JCFG))


def _layer0(jparams):
    return jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(T, CFG.d_model)).astype(np.float32),
            r.normal(size=(T, CFG.d_model)).astype(np.float32))


def _jax_moe(pm, x, ct, m, ep_exchange=None):
    """Reference ``moe_ffn``: (out, aux, grads of mean(out*ct) + aux for
    every param and x), in a W = 1 shard_map region with an exchange."""
    def f(p, xx):
        out, aux = JL.moe_ffn(xx, p, m, ep_exchange=ep_exchange)
        return jnp.mean(out * ct) + aux, (out, aux)

    g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
    if ep_exchange is not None:
        mesh = make_mesh((1,), ("data",))
        g = jax.jit(shard_map(g, mesh=mesh, in_specs=(
            jax.tree.map(lambda _: P(), pm), P()), out_specs=P(),
            axis_names={"data"}, check_vma=False))
    (_, (out, aux)), (gp, gx) = g(jax.tree.map(jnp.asarray, pm), jnp.asarray(x))
    return (np.asarray(out), float(aux),
            [np.asarray(a) for a in jax.tree.leaves(gp)] + [np.asarray(gx)])


def _port_moe(tp, x, ct, m, ep_exchange=None):
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = L.moe_ffn(xt, tp.tree(), m, ep_exchange=ep_exchange)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).mean() + aux,
                                tp.leaves() + [xt])
    return out.detach(), aux.detach(), grads


def test_moe_ffn_matches_reference(jparams):
    pm = _layer0(jparams)
    x, ct = _inputs()
    tp = params_from_jax(pm, "cpu")
    # the capacity drops tokens on this input: the trash slot is exercised
    logits = torch.from_numpy(x) @ tp.tree()["router"]
    counts = torch.bincount(logits.topk(CFG.moe.top_k).indices.reshape(-1),
                            minlength=CFG.moe.num_experts)
    cap = int(np.ceil(T * CFG.moe.top_k * CFG.moe.capacity_factor
                      / CFG.moe.num_experts))
    assert int(counts.max()) > cap
    jout, jaux, jgrads = _jax_moe(pm, x, ct, JCFG.moe)
    out, aux, grads = _port_moe(tp, x, ct, CFG.moe)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    np.testing.assert_allclose(aux.item(), jaux, rtol=1e-5)
    assert len(grads) == len(jgrads)
    for g, want in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["dense", "compressed"])
def test_moe_ffn_w1_exchange_matches_reference(jparams, name):
    pm = _layer0(jparams)
    x, ct = _inputs(1)
    jex = j_make_exchange(name, JaxCompression(**EX), make_mesh((1,), ("data",)),
                          ("data",), outer_manual=("data",))
    jout, jaux, jgrads = _jax_moe(pm, x, ct, JCFG.moe, ep_exchange=jex)
    tp = params_from_jax(pm, "cpu")
    ex = make_exchange(name, CompressionConfig(**EX), LocalWorkers(1))
    out, aux, grads = _port_moe(tp, x, ct, CFG.moe, ep_exchange=ex)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    np.testing.assert_allclose(aux.item(), jaux, rtol=1e-5)
    for g, want in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), want, **TOL)


@pytest.mark.parametrize("top_k", [2, 6])
@pytest.mark.parametrize("name", ["dense", "compressed"])
@pytest.mark.parametrize("ep", [2, 4])
def test_moe_ffn_ep_exchange_splices_the_local_combine(jparams, ep, name, top_k):
    m = dataclasses.replace(CFG.moe, top_k=top_k)
    tp = params_from_jax(_layer0(jparams), "cpu")
    x, ct = _inputs(2)
    local = _port_moe(tp, x, ct, m)
    ex = make_exchange(name, CompressionConfig(**EX), LocalWorkers(ep))
    wire = _port_moe(tp, x, ct, m, ep_exchange=ex)
    np.testing.assert_allclose(wire[0].numpy(), local[0].numpy(),
                               rtol=1e-6, atol=1e-7)
    if top_k == 2:                  # no token's two terms are regrouped
        assert torch.equal(wire[0], local[0])
    assert torch.equal(wire[1], local[1])
    for a, b in zip(wire[2], local[2]):
        assert torch.equal(a, b)


def test_moe_exchange_wires_agree_bit_for_bit(jparams):
    """Compressed == dense on real activations: at G = 2 every value is
    read back from a cell of its own."""
    m = dataclasses.replace(CFG.moe, top_k=6)
    tp = params_from_jax(_layer0(jparams), "cpu")
    x, _ = _inputs(3)
    outs = [L.moe_ffn(torch.from_numpy(x), tp.tree(), m, ep_exchange=make_exchange(
        name, CompressionConfig(**EX), LocalWorkers(2)))[0]
        for name in ("dense", "compressed")]
    assert torch.equal(outs[0], outs[1])


def test_moe_lm_loss_and_grads_match_reference(jparams):
    host = j_batch_fn(JCFG, B, S, seed=0)(0)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_lm_loss(p, JCFG, {k: jnp.asarray(v) for k, v in host.items()}),
        has_aux=True)(jparams)
    p = params_from_jax(jparams, "cpu")
    assert list(p.paths) == [tuple(k.key for k in path) for path, _ in
                             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    loss, metrics = lm_loss(p.tree(), CFG, device_batch(host, "cpu"))
    grads = torch.autograd.grad(loss, p.leaves())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("nll", "aux", "zloss"):
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=1e-5)
    assert float(jm["aux"]) > 0
    for g, want in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)


def test_moe_params_convert_bit_for_bit():
    """A bf16 MoE tree: the f32 router and the bf16 expert stacks cross
    through their raw bits, and back."""
    cfg16 = dataclasses.replace(JCFG, dtype="bfloat16")
    jp = jax.tree.map(np.asarray, j_init_lm(jax.random.PRNGKey(1), cfg16))
    p = params_from_jax(jp, "cpu")
    tree = p.tree()["layers"]["moe"]
    assert tree["router"].dtype == torch.float32
    assert tree["we_gate"].dtype == torch.bfloat16
    for t, a in zip(p.leaves(), jax.tree.leaves(jp)):
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.detach().view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.detach().numpy(), a)
    back = params_to_numpy(p)
    jax.tree.map(lambda b, a: np.testing.assert_array_equal(
        b, a.astype(np.float32)), back, jp)


def test_port_init_has_the_reference_tree():
    ours = model_api(CFG).init(0, "cpu")
    ref = jax.eval_shape(lambda k: j_init_lm(k, JCFG), jax.random.PRNGKey(0))
    want = [(tuple(k.key for k in path), tuple(a.shape)) for path, a in
            jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [(p, tuple(t.shape)) for p, t in zip(ours.paths, ours.leaves())] == want


def test_four_steps_at_w1_match_jax_run_training(jparams):
    jopt = JOpt(lr=5e-3, warmup_steps=1, total_steps=50)
    jtc = JTrain(aggregator="compressed",
                 compression=JaxCompression(ratio=0.1, topk_ratio=0.04),
                 optimizer=jopt, sharding=ShardingProfile(zero1=False),
                 remat="none", accum_steps=1, seed=0)
    want = j_run_training(j_model_api(JCFG), jtc,
                          make_mesh((1, 1), ("data", "model")),
                          global_batch=B, seq_len=S, steps=4, log_every=0).losses
    tc = TrainConfig(aggregator="compressed",
                     compression=CompressionConfig(ratio=0.1, topk_ratio=0.04),
                     optimizer=OptimizerConfig(**dataclasses.asdict(jopt)),
                     workers=1, seed=0)
    got = run_training(model_api(CFG), tc, global_batch=B, seq_len=S, steps=4,
                       device="cpu", params=params_from_jax(jparams, "cpu"),
                       log_every=0).losses
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_w2_ep2_training_under_every_exchange():
    """W = 2 workers, each emulating 2 EP ranks: the three ``ep_exchange``
    settings train to the same losses; the exchange runs in every MoE
    layer's forward (counted on the compressor's producer)."""
    from repro_torch.core import compressor as comp_lib
    base = dataclasses.replace(get_arch("deepseek-moe-16b").train, workers=2,
                               accum_steps=1, ep_workers=2)
    calls = []
    orig = comp_lib.HomomorphicCompressor.exchange_wire

    def counted(self, *a, **k):
        calls.append(self.cfg.ratio)
        return orig(self, *a, **k)

    losses = {}
    try:
        comp_lib.HomomorphicCompressor.exchange_wire = counted
        for name in ("none", "dense", "compressed"):
            calls.clear()
            tc = dataclasses.replace(base, ep_exchange=name)
            res = run_training(model_api(CFG), tc, global_batch=B, seq_len=S,
                               steps=3, device="cpu", log_every=0)
            losses[name] = res.losses
            # layers x workers x EP sources a step, at the exchange's ratio
            want = 3 * CFG.n_layers * 2 * 2 if name == "compressed" else 0
            assert calls == [2.5] * want
    finally:
        comp_lib.HomomorphicCompressor.exchange_wire = orig
    for name in ("dense", "compressed"):
        np.testing.assert_allclose(losses[name], losses["none"], rtol=1e-6)
    assert all(np.isfinite(losses["none"]))


def test_train_config_rejects_unknown_exchange_with_reference_text():
    with pytest.raises(ValueError) as want:
        JTrain(ep_exchange="bogus")
    with pytest.raises(ValueError) as got:
        TrainConfig(ep_exchange="bogus")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="ep_workers must be >= 1"):
        TrainConfig(ep_workers=0)


def test_other_families_still_refused():
    """A family outside the reference's six raises."""
    other = dataclasses.replace(CFG, family="retrieval")
    with pytest.raises(NotImplementedError, match="'dense', 'moe'"):
        model_api(other)


def test_launcher_runs_moe_with_compressed_exchange():
    from repro_torch.launch.train import main
    out = main(["--arch", "deepseek-moe-16b", "--smoke", "--ep-exchange",
                "compressed", "--ep-workers", "2", "--steps", "2",
                "--global-batch", "4", "--seq-len", "16", "--device", "cpu"])
    assert (out["arch"], out["ep_exchange"], out["ep_workers"], out["workers"]) \
        == ("deepseek-moe-16b", "compressed", 2, 2)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))

