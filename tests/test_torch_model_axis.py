"""The model axis at MP = 2 against the JAX reference's unsharded model.

One spawn of 2 gloo ranks on the CPU (a grid of 1 data index x 2 model
ranks, one thread each; ``launch/ranks.py``) runs every case: numpy
parameters (the port's init from a seed) taken in through
``convert.params_from_jax`` and cut into the rank's shards
(``train.step.shard_params``), one forward and backward in a
``model_region``, and the gradients gathered back whole
(``sharding.gather_leaf``). The parent holds them to the reference's
``jax.value_and_grad(api.loss)`` on one device, on the same numpy
parameters and batch, computed while the ranks run:

- granite-3-2b's smoke config (heads 4/2 -> 2/1 a rank), and the same
  at granite's own vocab, 49,155, padded to 49,280 (shard 1 holds the
  padding columns), with ``remat="block"`` (the recompute runs the
  axis's collectives again);
- qwen2-7b's smoke config (``bq/bk/bv`` sharded);
- granite's smoke config with ``tie_embeddings=True`` (the head is the
  vocab-sharded ``embed`` transposed);
- deepseek-moe-16b's smoke config (8 routed experts, 4 a rank; the
  shared experts column/row-sharded), with ``remat="block"``;
- internvl2-2b's smoke config (the vlm family: 8 visual-prefix tokens,
  replicated, before the text), with ``remat="block"``;
- whisper-tiny's smoke config (the encdec family: the encoder's
  self-attention, the cross-attention and both GELU MLPs on their
  shards, the tied head vocab-parallel) at 100 frames, so the encoder
  runs two query blocks of 64, with ``remat="block"``;
- mamba2-1.3b's smoke config (the ssm family: 16 Mamba heads, 8 a rank;
  ``wB``, ``wC``, the conv and the gated norm's scale replicated, the
  norm's mean over the whole ``d_inner``), with ``remat="block"``;
- jamba-v0.1-52b's smoke config (the hybrid superblock: attention, MoE
  and Mamba positions on their shards), with ``remat="block"``;
- granite's smoke config with 6 heads and 3 KV heads of 32 (MP 2 does
  not divide the KV heads: each rank holds 1.5 of them, gathered whole
  before RoPE).

Tolerances: the loss and its metrics at rtol 1e-5; the gradients at
rtol 1e-5 with atol 1e-5 of the leaf's largest entry. The same f32 math
runs in other summation orders: the row-parallel products, the
gradients through ``copy_to_model`` and the vocab ``logsumexp`` add
their two halves last. The readings: at most 9.2e-7 of the leaf's
largest entry (``embed`` and the attention projections), where
``test_torch_train``'s elementwise atol 1e-7 leaves out a few entries
near zero on ``embed`` (2.7e-7 absolute at most); the Mamba cases'
``A_log`` 3.8e-6 (mamba2) and 5.3e-6 (jamba) of its largest entry, where
the port's unsharded gradient is already 4.2e-6 / 5.9e-6 off the
reference's (the same f32 sums in other orders through ``exp``), and
granite with 3 KV heads 8.6e-7. The grad norm
(``train.step.model_axis_sq_norm`` from the shards) at rtol 1e-6 of
``jnp.sqrt`` of the sum of squares of the reference's gradient. Every
replicated leaf's gradient (the norm scales, the router) is equal bit
for bit on the two ranks (the Mamba cases' ``wB``, ``wC``, conv and
norm scale too: their shard-local gradients summed over the axis), and
so is the loss.

The launcher: ``--procs 4 --model-parallel 2`` trains granite's smoke
config on a 2 x 2 grid (and internvl2-2b, whisper-tiny, mamba2-1.3b and
kimi-k2 under its own profile), and ``--model-parallel 2`` without
``--procs`` is an argument error.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import model_api
from repro_torch.parallel.hints import model_region
from repro_torch.parallel.sharding import gather_leaf
from repro_torch.train.config import TrainConfig
from repro_torch.train.step import leaf_specs, model_axis_sq_norm, shard_params

B, S = 2, 16


def _cases():
    granite = get_arch("granite-3-2b").smoke
    return [
        ("granite", granite, "none"),
        ("granite_vocab49155", dataclasses.replace(granite, vocab=49155),
         "block"),
        ("qwen2", get_arch("qwen2-7b").smoke, "none"),
        ("granite_tied", dataclasses.replace(granite, tie_embeddings=True),
         "none"),
        ("deepseek", get_arch("deepseek-moe-16b").smoke, "block"),
        ("internvl", get_arch("internvl2-2b").smoke, "block"),
        ("whisper", dataclasses.replace(get_arch("whisper-tiny").smoke,
                                        enc_seq=100), "block"),
        ("mamba2", get_arch("mamba2-1.3b").smoke, "block"),
        ("jamba", get_arch("jamba-v0.1-52b").smoke, "block"),
        ("granite_kv3", dataclasses.replace(granite, n_heads=6, n_kv_heads=3,
                                            head_dim=32), "none"),
    ]


def _inputs(cfg, rng):
    """The family's batch: tokens and labels, and the vlm's visual prefix
    or the encdec's frames (f32)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vis_embed"] = rng.standard_normal(
            (B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _rank(mesh, device, inputs):
    """Each case's loss, metrics, gathered gradients, grad norm and
    replicated gradients on this rank."""
    out = {}
    tc = TrainConfig()
    for name, cfg, remat in _cases():
        np_params, batch = inputs[name]
        api = model_api(cfg)
        params = shard_params(params_from_jax(np_params, device), tc,
                              mesh.model)
        leaves = params.leaves()
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        with model_region(mesh.model):
            loss, metrics = api.loss(params.tree(), b, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
        specs = leaf_specs(params, tc, mesh.model)
        whole = [gather_leaf(g, s, mesh.model).numpy()
                 for g, s in zip(grads, specs)]
        norm = torch.sqrt(model_axis_sq_norm(grads, specs, mesh.model))
        out[name] = {
            "loss": loss.item(),
            "metrics": {k: v.item() for k, v in metrics.items()},
            "grads": dict(zip(params.paths, whole)),
            "norm": norm.item(),
            "replicated": {p: g.numpy() for p, g, s in
                           zip(params.paths, grads, specs)
                           if all(a is None for a in s)},
            "local_shapes": {p: tuple(g.shape) for p, g in
                             zip(params.paths, grads)}}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the reference's, the spawn running while
    the reference computes."""
    import concurrent.futures

    from repro_torch.convert import params_to_numpy
    from repro_torch.launch.ranks import spawn_ranks

    rng = np.random.default_rng(0)
    inputs = {}
    for i, (name, cfg, _) in enumerate(_cases()):
        inputs[name] = (params_to_numpy(model_api(cfg).init(i, "cpu")),
                        _inputs(cfg, rng))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn_ranks, _rank, 2, (inputs,), device="cpu",
                        model_parallel=2, threads=1, timeout=300,
                        init_dir=str(tmp_path_factory.mktemp("rdv")))
        ref = {name: _reference(cfg, *inputs[name])
               for name, cfg, _ in _cases()}
        return fut.result(), ref


def _reference(cfg, np_params, batch):
    """The reference's loss, metrics, gradients and grad norm, unsharded
    on one device."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.models import model_api as j_model_api
    from repro_torch.models.params import flatten_tree

    jcfg = dataclasses.replace(j_get_arch(cfg.name).smoke, vocab=cfg.vocab,
                               tie_embeddings=cfg.tie_embeddings,
                               enc_seq=cfg.enc_seq, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads,
                               head_dim=cfg.head_dim)
    japi = j_model_api(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, jb), has_aux=True))(jp)
    return {"loss": float(jl), "metrics": {k: float(v) for k, v in jm.items()},
            "grads": dict(flatten_tree(jax.tree.map(np.asarray, jg))),
            "norm": float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                                       for g in jax.tree.leaves(jg))))}


@pytest.mark.parametrize("name", [c[0] for c in _cases()])
def test_loss_and_gradients_match_unsharded_reference(runs, name):
    got, ref = runs
    r0, r1 = got[0][name], got[1][name]
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], ref[name]["loss"], rtol=1e-5)
    for k, v in ref[name]["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-5, atol=1e-7)
    assert set(r0["grads"]) == set(ref[name]["grads"])
    for path, want in ref[name]["grads"].items():
        np.testing.assert_allclose(r0["grads"][path], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=str(path))
        np.testing.assert_array_equal(r0["grads"][path], r1["grads"][path])


@pytest.mark.parametrize("name", [c[0] for c in _cases()])
def test_grad_norm_from_shards_matches_reference(runs, name):
    got, ref = runs
    assert got[0][name]["norm"] == got[1][name]["norm"]
    np.testing.assert_allclose(got[0][name]["norm"], ref[name]["norm"],
                               rtol=1e-6)


@pytest.mark.parametrize("name", [c[0] for c in _cases()])
def test_replicated_gradients_equal_across_model_ranks(runs, name):
    got, _ = runs
    rep0, rep1 = got[0][name]["replicated"], got[1][name]["replicated"]
    assert rep0 and set(rep0) == set(rep1)
    for path in rep0:
        np.testing.assert_array_equal(rep0[path], rep1[path], err_msg=str(path))
    if name == "deepseek":
        assert ("layers", "moe", "router") in rep0
    if name == "mamba2":
        assert {("layers", "mamba", k) for k in ("wB", "wC", "conv_w",
                                                 "conv_b")} <= set(rep0)


def test_shards_are_the_profile_split(runs):
    got, _ = runs
    sh = got[0]["granite_vocab49155"]["local_shapes"]
    assert sh[("embed",)] == (24640, 128)          # 49,280 / 2
    assert sh[("lm_head",)] == (128, 24640)
    assert sh[("layers", "attn", "wq")] == (2, 128, 64)   # 2 of 4 heads
    assert sh[("layers", "attn", "wk")] == (2, 128, 32)   # 1 of 2 KV heads
    assert sh[("layers", "ffn", "w_down")] == (2, 128, 128)
    ds = got[0]["deepseek"]["local_shapes"]
    assert ds[("layers", "moe", "we_gate")][:2] == (2, 4)  # 4 of 8 experts
    assert ds[("layers", "moe", "router")] == (2, 128, 8)
    assert "bq" in dict((p[-1], 0) for p in got[0]["qwen2"]["local_shapes"])
    kv3 = got[0]["granite_kv3"]["local_shapes"]
    assert kv3[("layers", "attn", "wq")] == (2, 128, 96)     # 3 of 6 heads
    assert kv3[("layers", "attn", "wk")] == (2, 128, 48)     # 1.5 KV heads
    mb = got[0]["mamba2"]["local_shapes"]
    assert mb[("layers", "mamba", "wx")] == (2, 128, 128)    # 8 of 16 heads
    assert mb[("layers", "mamba", "A_log")] == (2, 8)
    assert mb[("layers", "mamba", "wo")] == (2, 128, 128)
    assert mb[("layers", "mamba", "conv_w")] == (2, 4, 288)  # replicated
    assert mb[("layers", "mamba", "wB")] == (2, 128, 16)


def test_launcher_trains_on_a_grid_and_refuses_a_lone_model_axis(tmp_path,
                                                                  capsys):
    from repro_torch.launch import train as launcher

    summary = launcher.main([
        "--arch", "granite-3-2b", "--smoke", "--procs", "4",
        "--model-parallel", "2", "--steps", "2", "--global-batch", "4",
        "--seq-len", "16", "--device", "cpu", "--timeout", "300"])
    assert (summary["workers"], summary["model_parallel"]) == (2, 2)
    assert summary["final_step"] == 2
    assert all(np.isfinite(summary["losses"]))
    for argv in (["--model-parallel", "2"],
                 ["--procs", "3", "--model-parallel", "2"]):
        with pytest.raises(SystemExit):
            launcher.main(["--arch", "granite-3-2b", "--smoke", "--device",
                           "cpu"] + argv)
    assert "--model-parallel" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-tiny"])
def test_launcher_trains_vlm_and_encdec_on_a_grid(arch):
    from repro_torch.launch import train as launcher

    summary = launcher.main([
        "--arch", arch, "--smoke", "--procs", "4", "--model-parallel", "2",
        "--steps", "2", "--global-batch", "4", "--seq-len", "16",
        "--device", "cpu", "--timeout", "300"])
    assert (summary["workers"], summary["model_parallel"]) == (2, 2)
    assert summary["final_step"] == 2
    assert all(np.isfinite(summary["losses"]))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "kimi-k2-1t-a32b"])
def test_launcher_trains_ssm_and_kimi_profile_on_a_grid(arch):
    """The ssm family (Mamba heads on the model axis) and kimi-k2's
    profile (experts over the data ranks, the dense pure-auto step)
    through the launcher on a 2 x 2 grid."""
    from repro_torch.launch import train as launcher

    summary = launcher.main([
        "--arch", arch, "--smoke", "--procs", "4", "--model-parallel", "2",
        "--steps", "2", "--global-batch", "4", "--seq-len", "16",
        "--device", "cpu", "--timeout", "300"])
    assert (summary["workers"], summary["model_parallel"]) == (2, 2)
    assert summary["final_step"] == 2
    assert summary["aggregator"] == get_arch(arch).train.aggregator
    assert all(np.isfinite(summary["losses"]))
