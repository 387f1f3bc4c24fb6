"""The port's training loop with checkpoints, injected failures and the
prefetcher (``repro_torch/train/loop.py``, ``repro_torch/data/
pipeline.py``) against the reference's and against its own
uninterrupted runs.

- The reference's restart test (``tests/test_train_smoke.py``: W=1,
  dense, ZeRO-1 off, remat none, 12 steps, a checkpoint every 4, a
  failure at 6) held against the reference's ``run_training`` on the
  same settings: 14 losses to rtol=1e-5, the bound of
  ``test_four_steps_at_w1_match_jax_run_training``; the replayed steps'
  losses equal their first pass bit for bit.
- W=2 ``compressed`` with ZeRO-1 at the granite smoke config: a run
  interrupted at step 3 and restored from its step-2 checkpoint ends with
  the parameters, moments and residuals of an uninterrupted run, bit for
  bit; so do a run of 2 gloo ranks restored on ``LocalWorkers``, a
  ``LocalWorkers`` checkpoint restored on the ranks, and a failure on
  the ranks; the ranks' checkpoint is byte for byte the emulation's.
- The prefetcher yields the reference's ``(step, batch)`` items in
  order.

The spawned ranks run :func:`_rank` on one CPU thread and the emulated
runs here do too (the ranks equal the emulation bit for bit on one
thread, ``test_torch_dist.py``); the ranks import this module, so JAX
is imported inside the tests only.
"""
import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ft.failures import FailureSimulator

B, S, STEPS = 4, 32, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores. Module-wide,
    so the shared runs take the thread count of the tests' own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke():
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import model_api
    arch = get_arch("granite-3-2b")
    tc = dataclasses.replace(arch.train, workers=2, accum_steps=1,
                             remat="none")
    return model_api(arch.smoke), tc


def _train(steps, group=None, **kw):
    from repro_torch.train.loop import run_training
    api, tc = _smoke()
    return run_training(api, tc, global_batch=B, seq_len=S, steps=steps,
                        device="cpu", log_every=0, group=group, **kw)


def _state_bytes(state):
    """sha256 of the parameters, of the moments and of the residuals."""
    def h(ts):
        d = hashlib.sha256()
        for t in ts:
            d.update(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy())
        return d.hexdigest()
    return {"params": h(state.params.leaves()),
            "opt": {k: h(v) for k, v in state.opt.items()},
            "residual": h(state.residual), "step": state.step}


def _rank(group, dev, dirs):
    """One rank: a run resumed from the emulation's step-2 checkpoint
    (``dirs[0]``), and a run that checkpoints at steps 2 and 4, fails at
    step 3 and restores (``dirs[1]``)."""
    resumed = _train(STEPS, group, ckpt_dir=dirs[0], ckpt_every=100)
    failed = _train(STEPS, group, ckpt_dir=dirs[1], ckpt_every=2,
                    failure_sim=FailureSimulator(fail_at_steps=(3,)))
    return {"resumed": resumed.losses,
            "resumed_params": _state_bytes(resumed.state)["params"],
            "failed": failed.losses, "restarts": failed.restarts,
            "failed_params": _state_bytes(failed.state)["params"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The emulation's first two steps with their checkpoint, its
    uninterrupted run, and the two ranks' results, spawned as soon as
    that checkpoint exists and run while the tests go on."""
    from repro_torch.launch.ranks import spawn_ranks
    root = tmp_path_factory.mktemp("loop")
    dirs = [str(root / n) for n in ("emulated", "ranks")]
    first2 = _train(2, ckpt_dir=dirs[0], ckpt_every=2)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(spawn_ranks, _rank, 2, (dirs,), device="cpu",
                        timeout=300, threads=1, init_dir=root)
    full = _train(STEPS)
    yield {"first2": first2, "full": full, "dirs": dirs,
           "ranks": ranks.result}
    pool.shutdown(wait=True)


def test_restart_matches_reference_run_training(tmp_path):
    """The reference's restart test on the port, against the
    reference's ``run_training`` with the same settings and init."""
    import jax
    from repro.compat import make_mesh
    from repro.ft import FailureSimulator as JFailures
    from repro.models import ModelConfig as JModel, model_api as j_model_api
    from repro.models.transformer import init_lm as j_init_lm
    from repro.parallel.sharding import ShardingProfile
    from repro.train import OptimizerConfig as JOpt, TrainConfig as JTrain
    from repro.train.loop import run_training as j_run_training
    from repro_torch.convert import params_from_jax
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.registry import model_api
    from repro_torch.train.config import TrainConfig
    from repro_torch.train.loop import run_training
    from repro_torch.train.optimizer import OptimizerConfig

    jcfg = JModel(name="tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                  dtype="float32")
    jopt = JOpt(lr=5e-3, warmup_steps=1, total_steps=50)
    jtc = JTrain(aggregator="dense", optimizer=jopt,
                 sharding=ShardingProfile(zero1=False), remat="none")
    kw = dict(global_batch=4, seq_len=32, steps=12, ckpt_every=4,
              log_every=0)
    want = j_run_training(j_model_api(jcfg), jtc,
                          make_mesh((1, 1), ("data", "model")),
                          ckpt_dir=str(tmp_path / "ref"),
                          failure_sim=JFailures(fail_at_steps=(6,)), **kw)
    tc = TrainConfig(aggregator="dense", workers=1, zero1=False, remat="none",
                     optimizer=OptimizerConfig(**dataclasses.asdict(jopt)))
    params = params_from_jax(jax.tree.map(
        np.asarray, j_init_lm(jax.random.PRNGKey(0), jcfg)), "cpu")
    got = run_training(model_api(ModelConfig(**dataclasses.asdict(jcfg))), tc,
                       device="cpu", params=params,
                       ckpt_dir=str(tmp_path / "port"),
                       failure_sim=FailureSimulator(fail_at_steps=(6,)), **kw)
    assert (got.restarts, got.final_step) == (want.restarts, want.final_step) \
        == (1, 12)
    assert len(got.losses) == len(want.losses) == 12 + 2
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    # the replayed steps 4 and 5 equal their first pass bit for bit
    assert got.losses[6:8] == got.losses[4:6]
    kinds = [e["kind"] for e in got.ckpt_events]
    assert (kinds.count("view"), kinds.count("save"),
            kinds.count("restore")) == (3, 3, 1)


def test_w2_restart_equals_uninterrupted(runs, tmp_path):
    """W=2 compressed with ZeRO-1: checkpoints at 2 and 4, a failure at
    step 3, the step-2 checkpoint restored and step 2 replayed; the end
    state equals the uninterrupted run's bit for bit."""
    res = _train(STEPS, ckpt_dir=str(tmp_path), ckpt_every=2,
                 failure_sim=FailureSimulator(fail_at_steps=(3,)))
    full = runs["full"]
    assert res.restarts == 1 and res.final_step == STEPS
    assert len(res.losses) == STEPS + 1
    assert res.losses[3] == res.losses[2]
    assert res.losses[:3] + res.losses[4:] == full.losses
    assert _state_bytes(res.state) == _state_bytes(full.state)
    manifest = json.load(open(tmp_path / "step_00000002" / "manifest.json"))
    assert manifest["metadata"] == {"loss": full.losses[1]}


def test_failure_without_checkpoints_propagates():
    """No ``ckpt_dir``: the injected failure is raised, as the
    reference's loop raises it."""
    from repro_torch.ft.failures import InjectedFailure
    with pytest.raises(InjectedFailure, match="step 1"):
        _train(2, failure_sim=FailureSimulator(fail_at_steps=(1,)))


def test_rank_checkpoint_restores_on_local_workers(runs, tmp_path):
    """The 2 gloo ranks' step-2 checkpoint equals the emulation's byte
    for byte, and the emulation restores it and trains steps 2-3 to the
    uninterrupted run's state."""
    runs["ranks"]()
    emu_dir, rank_dir = runs["dirs"]
    full = runs["full"]

    def leaves(d):
        return json.load(open(os.path.join(d, "step_00000002",
                                           "manifest.json")))["leaves"]
    assert leaves(rank_dir) == leaves(emu_dir)
    shutil.copytree(os.path.join(rank_dir, "step_00000002"),
                    tmp_path / "step_00000002")
    res = _train(STEPS, ckpt_dir=str(tmp_path), ckpt_every=100)
    assert res.losses == full.losses[2:]
    assert _state_bytes(res.state) == _state_bytes(full.state)


def test_local_checkpoint_and_failure_on_ranks(runs):
    """The ranks resume from the emulation's step-2 checkpoint, and fail
    at step 3 and restore their own: both end on the uninterrupted run's
    parameters."""
    ranks = runs["ranks"]()
    full = runs["full"]
    want = _state_bytes(full.state)["params"]
    for r in ranks:
        assert r["resumed"] == full.losses[2:]
        assert r["resumed_params"] == want
        assert r["restarts"] == 1
        assert r["failed"] == full.losses[:3] + full.losses[2:]
        assert r["failed_params"] == want


def test_prefetcher_orders_steps():
    """The reference's ordering test, the items compared with the
    reference prefetcher's; on a device the batches are its int64
    tensors."""
    from repro.data.pipeline import Prefetcher as JPrefetcher, batch_fn as j_batch_fn
    from repro.models import ModelConfig as JModel
    from repro_torch.data.pipeline import Prefetcher, batch_fn
    from repro_torch.models.config import ModelConfig

    jcfg = JModel(name="t", family="dense", n_layers=1, d_model=32, n_heads=2,
                  n_kv_heads=1, d_ff=64, vocab=128, dtype="float32")
    f = batch_fn(ModelConfig(**dataclasses.asdict(jcfg)), 2, 8, seed=0)
    pf = Prefetcher(f, depth=2, start_step=0)
    got = [next(pf) for _ in range(5)]
    pf.close()
    jpf = JPrefetcher(j_batch_fn(jcfg, 2, 8, seed=0), depth=2, start_step=0)
    want = [next(jpf) for _ in range(5)]
    jpf.close()
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2, 3, 4]
    for (_, a), (_, b) in zip(got, want):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    pf = Prefetcher(f, device="cpu", depth=1, start_step=3)
    step, batch = next(pf)
    pf.close()
    assert step == 3 and batch["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(batch["tokens"].numpy(), f(3)["tokens"])
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("given", [False, True], ids=["seed_init", "params"])
def test_failure_before_first_checkpoint_restarts_from_init(runs, tmp_path,
                                                            given):
    """A failure before any checkpoint exists goes back to the run's
    initial state (the seed's init, or the caller's ``params``, which the
    run updates in place) and replays from step 0."""
    api, tc = _smoke()
    params = api.init(tc.seed + 1, "cpu") if given else None
    res = _train(2, ckpt_dir=str(tmp_path), ckpt_every=2, params=params,
                 failure_sim=FailureSimulator(fail_at_steps=(1,)))
    want = _train(2, params=api.init(tc.seed + 1, "cpu")) if given \
        else runs["first2"]
    assert res.restarts == 1 and res.final_step == 2
    assert res.losses == want.losses[:1] + want.losses
    assert _state_bytes(res.state) == _state_bytes(want.state)
