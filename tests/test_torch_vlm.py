"""The vlm family (internvl2-2b's stub vision frontend: precomputed patch
embeddings prepended to the text) against the JAX reference: the
batch's ``vis_embed``, its dtype through the prefetcher and
``device_batch``, the loss over text positions, its gradients, and
prefill with the visual prefix.

Config: the smoke config of ``configs/internvl2_2b.py`` (2 layers,
d_model 128, 8 visual tokens, float32). Params are the port's draws
from seed 0 as one numpy tree, given to both sides. Tolerances: loss to
rtol=1e-5, gradients to rtol=1e-5, atol=1e-7, logits and caches to
rtol=1e-5, atol=1e-6, as the dense family's tests.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.internvl2_2b import ARCH as J_ARCH
from repro.data.pipeline import batch_fn as j_batch_fn
from repro.models import model_api as j_model_api
from repro_torch.convert import cache_to_numpy, params_from_jax, params_to_numpy
from repro_torch.data.pipeline import Prefetcher, batch_fn, host_tensors
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.train.loop import device_batch

JCFG = J_ARCH.smoke
CFG = ModelConfig(**dataclasses.asdict(JCFG))
TOL = dict(rtol=1e-5, atol=1e-6)
B, S = 2, 24


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
    np_tree = params_to_numpy(model_api(CFG).init(0, "cpu"))
    return params_from_jax(np_tree, "cpu"), jax.tree.map(jnp.asarray, np_tree)


@pytest.mark.parametrize("step", [0, 3])
def test_batch_vis_embed_equals_reference_bit_for_bit(step):
    got = batch_fn(CFG, B, S, seed=5)(step)
    want = j_batch_fn(JCFG, B, S, seed=5)(step)
    assert sorted(got) == sorted(want) == ["labels", "tokens", "vis_embed"]
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["vis_embed"].shape == (B, CFG.vis_tokens, CFG.d_model)
    assert got["vis_embed"].dtype == np.float32


def test_device_batch_and_prefetcher_keep_vis_embed_f32():
    """The tokens become int64, ``vis_embed`` stays f32 (bit for bit):
    an int64 cast would truncate it to integers."""
    make = batch_fn(CFG, B, S, seed=1)
    host = make(0)
    for got in (device_batch(host, "cpu"), host_tensors(host)):
        assert got["tokens"].dtype == got["labels"].dtype == torch.int64
        assert got["vis_embed"].dtype == torch.float32
        np.testing.assert_array_equal(got["vis_embed"].numpy(), host["vis_embed"])
    pf = Prefetcher(make, device="cpu", start_step=0)
    try:
        for want_step in range(2):
            step, got = next(pf)
            assert step == want_step
            assert got["vis_embed"].dtype == torch.float32
            np.testing.assert_array_equal(got["vis_embed"].numpy(),
                                          make(step)["vis_embed"])
            assert got["tokens"].dtype == torch.int64
    finally:
        pf.close()


def test_loss_and_grads_with_vis_embed_match_reference(params):
    """The loss reads the text positions only; gradients reach the
    embedding through the text positions and every layer through all
    ``V + S`` positions."""
    p, jp = params
    host = j_batch_fn(JCFG, B, S, seed=0)(0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda q: j_model_api(JCFG).loss(q, jb), has_aux=True)(jp)
    loss, metrics = model_api(CFG).loss(p.tree(), device_batch(host, "cpu"))
    grads = torch.autograd.grad(loss, p.leaves())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(metrics["nll"].item(), float(jm["nll"]), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    # the visual prefix moves the loss: it is not read past
    no_vis = {k: v for k, v in device_batch(host, "cpu").items()
              if k != "vis_embed"}
    assert model_api(CFG).loss(p.tree(), no_vis)[0].item() != loss.item()


@pytest.mark.parametrize("max_len", [40, 20])
def test_prefill_with_vis_embed_matches_reference(params, max_len):
    """The cache holds ``max(max_len, V + S)`` positions: padded past
    the prefix and prompt (40), or exactly them where the prefix alone
    takes the room (20 < 8 + 24)."""
    p, jp = params
    host = j_batch_fn(JCFG, B, S, seed=2)(0)
    jl, jc = j_model_api(JCFG).prefill(
        jp, {"tokens": jnp.asarray(host["tokens"]),
             "vis_embed": jnp.asarray(host["vis_embed"])}, max_len)
    batch = device_batch(host, "cpu")
    with torch.inference_mode():
        logits, cache = model_api(CFG).prefill(
            p.tree(), {"tokens": batch["tokens"],
                       "vis_embed": batch["vis_embed"]}, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    got = cache_to_numpy(cache)
    assert got["k"].shape[2] == max(max_len, CFG.vis_tokens + S)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k], np.asarray(jc[k]), **TOL)
