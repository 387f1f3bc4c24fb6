"""PyTorch port vs the JAX reference: parameters, loss and gradients, and
training, at the smoke config of ``configs/granite_3_2b.py`` (2 layers,
d_model 128, vocab 512, float32).

Tolerances: the two frameworks run the same f32 math with their own
matmul and reduction orders, so loss and gradients agree to rtol=1e-5
(with atol=1e-7 for gradient entries near zero), and loss curves to
rtol=1e-5. The W=2 dense and lossless-compressed port curves agree to
1e-4 absolute, the bound ``tests/drivers/train_step_driver.py`` sets for
that check: peeling recovers Gaussian gradients up to the rounding of its
subtractions.

The W=2 JAX reference is composed in-process (the tier-1 process sees
one JAX device, and the reference's multi-device drivers fail): per
worker ``value_and_grad`` on its batch rows, the composed compressed
aggregate of ``test_torch_aggregate.py``, then ``opt_leaf_update`` per
leaf: the reference's ``zero1=False`` step. With ``zero1=True`` the
composition is the reference's ZeRO-1 ``leaf_update``
(``src/repro/train/step.py:350-377``): ``repro.core.streams.
zero_slice_dim`` picks each leaf's dim, ``opt_leaf_update`` runs on each
rank's slice (``jax.lax.dynamic_slice_in_dim``) and the leaf becomes
``p + concatenate(new_p_s - p_s)``, the tiled ``all_gather`` of the
deltas in rank order. One such update on f32 leaves agrees with the
port's ``apply_update`` to rtol 1e-6: without clipping bit for bit
(largest relative difference 0, the same f32 operations on each
element), with clipping at most 4.3e-7 relative (AdamW's moments), from
the grad norm, which the two frameworks sum in their own orders.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from jax.sharding import PartitionSpec as P

from repro.configs.granite_3_2b import ARCH as JARCH
from repro.core import CompressionConfig as JaxCompression
from repro.core.streams import zero_slice_dim as j_zero_slice_dim
from repro.data.pipeline import batch_fn as j_batch_fn
from repro.models import model_api as j_model_api
from repro.models.transformer import init_lm as j_init_lm, lm_loss as j_lm_loss
from repro.parallel.sharding import ShardingProfile
from repro.train import OptimizerConfig as JOpt, TrainConfig as JTrain
from repro.train import optimizer as j_opt
from repro.train.loop import run_training as j_run_training
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.collectives import LocalWorkers
from repro_torch.core.config import CompressionConfig
from repro_torch.data.pipeline import batch_fn
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.models.transformer import lm_loss
from repro_torch.train.config import TrainConfig
from repro_torch.train.loop import device_batch, run_training
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import TrainState, apply_update, zero1_dims
from test_torch_aggregate import jax_compressed_aggregate

JCFG = JARCH.smoke
CFG = ModelConfig(**dataclasses.asdict(JCFG))
B, S = 4, 32


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, j_init_lm(jax.random.PRNGKey(0), JCFG))


def test_params_roundtrip_in_flatten_order(jparams):
    p = params_from_jax(jparams, "cpu")
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert list(p.paths) == jpaths
    for t, a in zip(p.leaves(), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(t.detach().numpy(), a)
    back = params_to_numpy(p)
    jax.tree.map(np.testing.assert_array_equal, back, jparams)


def test_bf16_params_convert_bit_for_bit():
    cfg16 = dataclasses.replace(JCFG, dtype="bfloat16")
    jp = jax.tree.map(np.asarray, j_init_lm(jax.random.PRNGKey(1), cfg16))
    p = params_from_jax(jp, "cpu")
    for t, a in zip(p.leaves(), jax.tree.leaves(jp)):
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.detach().view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.detach().numpy(), a)


def test_batches_match_reference():
    for step in (0, 5):
        a = batch_fn(CFG, B, S, seed=3)(step)
        b = j_batch_fn(JCFG, B, S, seed=3)(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_lm_loss_and_grads_match_reference(jparams):
    host = j_batch_fn(JCFG, B, S, seed=0)(0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_lm_loss(p, JCFG, jb), has_aux=True)(jparams)
    p = params_from_jax(jparams, "cpu")
    loss, metrics = lm_loss(p.tree(), CFG, device_batch(host, "cpu"))
    grads = torch.autograd.grad(loss, p.leaves())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("nll", "zloss"):
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=1e-5)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("accum", [1, 2])
def test_four_steps_at_w1_match_jax_run_training(jparams, accum):
    """One worker aggregates densely on both sides (the reference's rule);
    ``accum=2`` takes the microbatch accumulation path."""
    jopt = JOpt(lr=5e-3, warmup_steps=1, total_steps=50)
    jtc = JTrain(aggregator="compressed",
                 compression=JaxCompression(ratio=0.1, topk_ratio=0.04),
                 optimizer=jopt, sharding=ShardingProfile(zero1=False),
                 remat="none", accum_steps=accum, seed=0)
    from repro.compat import make_mesh
    want = j_run_training(j_model_api(JCFG), jtc, make_mesh((1, 1), ("data", "model")),
                          global_batch=B, seq_len=S, steps=4, log_every=0).losses
    tc = TrainConfig(aggregator="compressed",
                     compression=CompressionConfig(ratio=0.1, topk_ratio=0.04),
                     optimizer=OptimizerConfig(**dataclasses.asdict(jopt)),
                     workers=1, accum_steps=accum, seed=0)
    got = run_training(model_api(CFG), tc, global_batch=B, seq_len=S, steps=4,
                       device="cpu", params=params_from_jax(jparams, "cpu"),
                       log_every=0).losses
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


LOSSLESS = dict(ratio=2.0, lanes=512, rows=60, chunk_blocks=64)
MOMENTUM = dict(kind="momentum", lr=1e-2, warmup_steps=0, total_steps=100,
                grad_clip=0.0)


def jax_zero1_update(leaves, grads, mom, lr, step, ocfg, workers=2):
    """The reference's ZeRO-1 ``leaf_update`` over ``workers`` ranks,
    composed: each leaf with a ``zero_slice_dim`` updated slice by slice
    and ``p + concatenate(deltas)``, the others replicated. ``mom`` maps
    each moment to its (whole) leaves, updated in place. Returns the new
    leaves."""
    new = []
    for i, (p, g) in enumerate(zip(leaves, grads)):
        st_full = {k: v[i] for k, v in mom.items()}
        d = j_zero_slice_dim(p.shape, P(), workers)
        if d is None:
            np_, st = j_opt.opt_leaf_update(p, g, st_full, lr, step, ocfg)
            new.append(np_)
            for k in mom:
                mom[k][i] = st[k]
            continue
        blk = p.shape[d] // workers
        deltas, sts = [], []
        for r in range(workers):
            def sl(x):
                return jax.lax.dynamic_slice_in_dim(x, r * blk, blk, axis=d)
            p_s = sl(p)
            new_p_s, st = j_opt.opt_leaf_update(
                p_s, sl(g), {k: sl(v) for k, v in st_full.items()}, lr, step, ocfg)
            deltas.append((new_p_s - p_s).astype(p.dtype))
            sts.append(st)
        new.append(p + jnp.concatenate(deltas, axis=d))
        for k in mom:
            mom[k][i] = jnp.concatenate([st[k] for st in sts], axis=d)
    return new


def jax_w2_compressed_losses(jparams, steps, compression=LOSSLESS, zero1=False):
    """The reference's W=2 compressed step, composed, with the
    ``CompressionConfig`` fields ``compression``; ``zero1`` takes the
    ZeRO-1 update (:func:`jax_zero1_update`) in place of the replicated
    one."""
    jc = JaxCompression(**compression)
    ocfg = JOpt(**MOMENTUM)
    params = jax.tree.map(jnp.asarray, jparams)
    leaves, treedef = jax.tree.flatten(params)
    mom = [jnp.zeros(p.shape, jnp.float32) for p in leaves]
    vg = jax.jit(jax.value_and_grad(lambda p, b: j_lm_loss(p, JCFG, b)[0]))
    make = j_batch_fn(JCFG, B, S, seed=0)
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
        agg, _ = jax_compressed_aggregate(gw, [stubs, stubs], jc)
        lr = j_opt.lr_schedule(jnp.int32(step), ocfg)
        if zero1:
            moms = {"m": mom}
            leaves = jax_zero1_update(leaves, [jnp.asarray(g) for g in agg],
                                      moms, lr, jnp.int32(step), ocfg)
        else:
            new = []
            for i, (p, g) in enumerate(zip(leaves, agg)):
                np_, st = j_opt.opt_leaf_update(p, jnp.asarray(g), {"m": mom[i]},
                                                lr, jnp.int32(step), ocfg)
                new.append(np_)
                mom[i] = st["m"]
            leaves = new
        params = jax.tree.unflatten(treedef, leaves)
        losses.append(float((lw[0] + lw[1]) / 2))
    return losses


def test_w2_lossless_compressed_tracks_dense_and_reference(jparams):
    def port(aggregator):
        tc = TrainConfig(aggregator=aggregator,
                         compression=CompressionConfig(**LOSSLESS),
                         optimizer=OptimizerConfig(**MOMENTUM), workers=2, seed=0,
                         zero1=False)
        return run_training(model_api(CFG), tc, global_batch=B, seq_len=S,
                            steps=6, device="cpu",
                            params=params_from_jax(jparams, "cpu"), log_every=0)
    dense, comp = port("dense"), port("compressed")
    assert all(abs(a - b) < 1e-4 for a, b in zip(dense.losses, comp.losses)), \
        (dense.losses, comp.losses)
    assert all(m["recovery_residual"] == 0 for m in comp.metrics)
    assert comp.losses[-1] < comp.losses[0]
    want = jax_w2_compressed_losses(jparams, 6)
    np.testing.assert_allclose(comp.losses, want, rtol=1e-5)


def test_launcher_runs_on_cpu():
    from repro_torch.launch.train import main
    out = main(["--arch", "granite-3-2b", "--smoke", "--workers", "2",
                "--steps", "2", "--global-batch", "4", "--seq-len", "16",
                "--device", "cpu"])
    assert out["workers"] == 2 and out["aggregator"] == "compressed"
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_launcher_procs_print_rank0_summary_equal_to_one_process(capsys):
    """``--procs 2`` spawns two gloo ranks on the CPU; the summary printed
    is rank 0's, and its losses are the one-process W=2 run's."""
    from repro_torch.launch.train import main
    argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "2",
            "--global-batch", "4", "--seq-len", "16", "--device", "cpu"]
    one = main(argv + ["--workers", "2"])
    capsys.readouterr()
    two = main(argv + ["--procs", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == two
    assert (two["procs"], two["workers"], one["procs"]) == (2, 2, 1)
    assert two["losses"] == one["losses"] and len(two["losses"]) == 2
    with pytest.raises(SystemExit):
        main(argv + ["--procs", "2", "--workers", "3"])


def test_w2_zero1_rs_tracks_reference(jparams):
    """``compressed_rs`` with ZeRO-1 at W=2 (the lossless profile) against
    the composed reference step with the ZeRO-1 update."""
    tc = TrainConfig(aggregator="compressed_rs",
                     compression=CompressionConfig(**LOSSLESS),
                     optimizer=OptimizerConfig(**MOMENTUM), workers=2,
                     zero1=True, seed=0)
    got = run_training(model_api(CFG), tc, global_batch=B, seq_len=S, steps=4,
                       device="cpu", params=params_from_jax(jparams, "cpu"),
                       log_every=0)
    assert all(m["recovery_residual"] == 0 for m in got.metrics)
    want = jax_w2_compressed_losses(jparams, 4, zero1=True)
    np.testing.assert_allclose(got.losses, want, rtol=1e-5)


@pytest.mark.parametrize("kind,clip", [("adamw", 1.0), ("adamw", 0.0),
                                       ("momentum", 0.0)])
def test_zero1_update_matches_reference(kind, clip):
    """One ZeRO-1 update at W=2 on the same f32 leaves, grads and moments:
    the port's ``apply_update`` on ``LocalWorkers`` against the composed
    reference (a leaf with no slice dim, (3, 7), updates replicated).
    Momentum is held without clipping: the two frameworks sum the grad
    norm in their own orders, an ulp of the clip scale, and a momentum
    element near cancellation then moves by up to 1.6e-6 relative."""
    rng = np.random.default_rng(4)
    shapes = [(8, 6), (4, 10, 6), (6,), (3, 7), (2, 16)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    g0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ocfg = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)
    moms = ("m", "v") if kind == "adamw" else ("m",)
    m0 = {k: [np.abs(rng.normal(size=s)).astype(np.float32) for s in shapes]
          for k in moms}
    tc = TrainConfig(workers=2, zero1=True, optimizer=OptimizerConfig(**ocfg))
    leaves = [torch.from_numpy(x.copy()) for x in p0]
    dims = zero1_dims(leaves, tc)
    assert dims == [0, 1, 0, None, 1]
    opt = init_opt_state(leaves, tc.optimizer)
    for k in moms:
        for t, x in zip(opt[k], m0[k]):
            t.copy_(torch.from_numpy(x))
    params = type("Params", (), {"leaves": lambda self: leaves})()
    state = TrainState(params=params, opt=opt, residual=[], step=3)
    gnorm = apply_update(state, [torch.from_numpy(g) for g in g0], dims,
                         LocalWorkers(2), tc.optimizer)
    jo = JOpt(**ocfg)
    jg = [jnp.asarray(g) for g in g0]
    jnorm = j_opt.global_grad_norm(jg)
    if clip:
        jg = j_opt.clip_grads(jg, jnorm, jo.grad_clip)
    jmom = {k: [jnp.asarray(x) for x in v] for k, v in m0.items()}
    want = jax_zero1_update([jnp.asarray(x) for x in p0], jg, jmom,
                            j_opt.lr_schedule(jnp.int32(3), jo), jnp.int32(3), jo)
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-6)
    for a, b in zip(leaves, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    for k in moms:
        for a, b in zip(opt[k], jmom[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_launcher_rs_zero1_overlap_procs_equal_one_process(capsys):
    """``--aggregator compressed_rs --zero1 --overlap`` on the CPU, the
    stream cut into one-block buckets so that it streams: the rank-0
    summary of ``--procs 2`` equals the one-process run's."""
    from repro_torch.launch.train import main
    argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "2",
            "--global-batch", "4", "--seq-len", "16", "--device", "cpu",
            "--aggregator", "compressed_rs", "--zero1", "--overlap",
            "--bucket-bytes", str(4 * 30720)]     # 14 one-block buckets: 7 chunks
    one = main(argv + ["--workers", "2"])
    capsys.readouterr()
    two = main(argv + ["--procs", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == two
    assert (one["aggregator"], one["zero1"], one["overlap"]) == \
        ("compressed_rs", True, True)
    assert {k: v for k, v in two.items() if k != "procs"} == \
        {k: v for k, v in one.items() if k != "procs"}
    assert all(np.isfinite(one["losses"]))
