"""W=2 training of the ssm, hybrid and encdec families against the JAX
reference: the smoke configs of ``configs/mamba2_1_3b.py``,
``configs/jamba_v0_1_52b.py`` and ``configs/whisper_tiny.py`` (float32;
whisper's batches carry ``frames``), through the lossless compressed
wire, as ``tests/test_torch_train.py::
test_w2_lossless_compressed_tracks_dense_and_reference`` does for
granite-3-2b.

The W=2 reference is composed in-process (the tier-1 process sees one
JAX device): per worker ``value_and_grad`` on its batch rows, the
composed compressed aggregate of ``test_torch_aggregate.py`` (or the
f32 mean for ``dense``), then ``opt_leaf_update`` per leaf: the
reference's ``zero1=False`` step. Params are the port's draws from seed
0, given to both sides as numpy.

Tolerances: the port's dense and compressed curves within 1e-4 absolute
(the bound ``tests/drivers/train_step_driver.py`` sets), the compressed
curve against the reference's to rtol=1e-5, as for granite.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as J_ARCHS
from repro.core import CompressionConfig as JaxCompression
from repro.data.pipeline import batch_fn as j_batch_fn
from repro.models import model_api as j_model_api
from repro.train import OptimizerConfig as JOpt
from repro.train import optimizer as j_opt
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.config import CompressionConfig
from repro_torch.models.registry import model_api
from repro_torch.train.config import TrainConfig
from repro_torch.train.loop import run_training
from repro_torch.train.optimizer import OptimizerConfig
from test_torch_aggregate import jax_compressed_aggregate

B, S = 4, 40
LOSSLESS = dict(ratio=2.0, lanes=512, rows=60, chunk_blocks=64)
MOMENTUM = dict(kind="momentum", lr=1e-2, warmup_steps=0, total_steps=100,
                grad_clip=0.0)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_w2_losses(jcfg, np_params, steps, ocfg, compression=None):
    """The reference's W=2 step, composed: ``compression`` (a
    ``CompressionConfig`` field dict) takes the compressed aggregate,
    None the f32 mean of the two workers' gradients; the replicated
    update with ``ocfg`` (a ``JOpt`` field dict). Returns the losses, each
    the mean of the two workers'."""
    jo = JOpt(**ocfg)
    params = jax.tree.map(jnp.asarray, np_params)
    leaves, treedef = jax.tree.flatten(params)
    sdt = jnp.bfloat16 if jo.state_dtype == "bfloat16" else jnp.float32
    names = ("m", "v") if jo.kind == "adamw" else ("m",)
    mom = {k: [jnp.zeros(p.shape, sdt) for p in leaves] for k in names}
    api = j_model_api(jcfg)
    vg = jax.jit(jax.value_and_grad(lambda p, b: api.loss(p, b)[0]))
    make = j_batch_fn(jcfg, B, S, seed=0)
    stubs = [np.zeros((0,), np.float32) for _ in leaves]
    losses = []
    for step in range(steps):
        host = make(step)
        lw, gw = [], []
        for w in range(2):
            rows = {k: jnp.asarray(v[w * B // 2:(w + 1) * B // 2])
                    for k, v in host.items()}
            l, g = vg(params, rows)
            lw.append(l)
            gw.append([np.asarray(x) for x in jax.tree.leaves(g)])
        if compression is None:
            agg = [(a.astype(np.float32) + b.astype(np.float32)) / 2
                   for a, b in zip(*gw)]
        else:
            agg, _ = jax_compressed_aggregate(
                gw, [stubs, stubs], JaxCompression(**compression))
        lr = j_opt.lr_schedule(jnp.int32(step), jo)
        new = []
        for i, (p, g) in enumerate(zip(leaves, agg)):
            np_, st = j_opt.opt_leaf_update(
                p, jnp.asarray(g, p.dtype), {k: mom[k][i] for k in names},
                lr, jnp.int32(step), jo)
            new.append(np_)
            for k in names:
                mom[k][i] = st[k]
        leaves = new
        params = jax.tree.unflatten(treedef, leaves)
        losses.append(float((lw[0] + lw[1]) / 2))
    return losses


def port_w2(cfg, np_params, aggregator, steps, ocfg, compression):
    tc = TrainConfig(aggregator=aggregator,
                     compression=CompressionConfig(**compression),
                     optimizer=OptimizerConfig(**ocfg), workers=2, seed=0,
                     zero1=False)
    return run_training(model_api(cfg), tc, global_batch=B, seq_len=S,
                        steps=steps, device="cpu",
                        params=params_from_jax(np_params, "cpu"), log_every=0)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b",
                                  "whisper-tiny"])
def test_w2_lossless_compressed_tracks_dense_and_reference(arch):
    """Three steps: the port's compressed run recovers every coordinate,
    tracks its dense run within 1e-4 and the reference's composed
    compressed run to rtol=1e-5. The port trains under its default
    ``block`` remat (for jamba a whole superblock a unit, for whisper
    each decoder layer), the reference's composition under ``none``."""
    cfg = get_arch(arch).smoke
    np_params = params_to_numpy(model_api(cfg).init(0, "cpu"))
    dense = port_w2(cfg, np_params, "dense", 3, MOMENTUM, LOSSLESS)
    comp = port_w2(cfg, np_params, "compressed", 3, MOMENTUM, LOSSLESS)
    assert all(abs(a - b) < 1e-4 for a, b in zip(dense.losses, comp.losses)), \
        (dense.losses, comp.losses)
    assert all(m["recovery_residual"] == 0 for m in comp.metrics)
    want = jax_w2_losses(J_ARCHS[arch].smoke, np_params, 3, MOMENTUM, LOSSLESS)
    np.testing.assert_allclose(comp.losses, want, rtol=1e-5)

