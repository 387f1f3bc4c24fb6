"""The train step on a grid of 2 data-parallel x 2 model ranks against
the JAX reference.

One spawn of 4 gloo ranks on the CPU (``launch/ranks.py``,
``model_parallel=2``; rank ``d·2 + t`` is data index d, model index t)
runs every grid case in :func:`_rank`, while the parent computes the
references:

- **the dense step**: 3 steps of granite-3-2b's smoke config (f32,
  momentum at lr 1e-2 with the clip at 1.0, ZeRO-1) from the same
  parameters and rows, held to the reference's own dense step on a (data 2, model 2)
  mesh of 4 fake CPU devices, run in a subprocess that sets
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before its
  first JAX import, as the reference's drivers do: losses and grad
  norms at rtol 1e-5, final parameters at rtol 1e-5 with atol 1e-6 of
  the leaf's largest entry (the readings: losses within 1.5e-7
  relative, grad norms 1.1e-7, parameters within 8.4e-8 of their leaf's
  largest entry). Momentum, not AdamW: AdamW's ``rsqrt(v)`` turns the
  two frameworks' rounding on near-zero gradients into parameter
  differences of up to 1 % of a leaf's scale after 3 steps, for the
  port's single-process step as for the grid's. The loss and the grad
  norm are the same bits on every rank.
- **the compressed aggregation**: the reference's compressed step on a
  model axis stops in JAX 0.9.0 (``core/aggregators.py:502``, the
  nested ``shard_map``), so each rank's aggregate is held to the
  reference's nested-branch functions composed here on the same shard:
  ``make_bucket_plan(grads, cfg, shapes=local_shapes)``,
  ``_sparsify_leaf`` a local leaf, ``plan.pack_flat``,
  ``HomomorphicCompressor.compress`` with ``use_pallas="never"``, the
  sum of the sketches and the OR of the words over the rank's data
  group, ``recover`` and ``plan.unpack(buckets / W)``. On dyadic
  shard-local gradients over 2 steps (top-k 4 %, error feedback, 5
  buckets) the aggregate and the new residual match bit for bit.
- **the lossless check** of ``tests/drivers/train_step_driver.py``
  (lines 61-64, 79-88, 119-120) on the port's grid: its tiny MoE config,
  ratio 2.0, rows 60, lanes 512, momentum without clipping, 4 steps;
  the compressed losses within 1e-4 of the dense ones.
- **deepseek-moe-16b** (smoke, the config's own aggregator): 2 steps
  with ``ep_exchange`` ``dense`` and ``compressed`` over the model
  ranks give the same losses and parameters bit for bit (the exchange's
  geometry peels a dense payload exactly), and ``none`` (the partials'
  all-reduce) the same losses within rtol 1e-6.
- **internvl2-2b and whisper-tiny** (the vlm and encdec families; smoke
  configs, whisper at 100 frames so its encoder runs two query blocks):
  2 dense steps under the ``block`` remat on the grid, held to the
  reference's own step on the same (data 2, model 2) mesh (the dense
  step's subprocess runs it too) and, as a second witness, to the
  port's own step on ``LocalWorkers(2)`` in the parent: losses and grad
  norms at rtol 1e-5, parameters at rtol 1e-5 with atol 1e-6 of the
  leaf's largest entry, as the dense step above.
- **kimi-k2's profile** (smoke config; experts over the data ranks,
  4 a rank, their ``d_ff`` over the model ranks, no manual DP axes):
  the loss, metrics and the gathered gradients of the global batch of
  8 rows (each data rank's 4 rows through the layers' token all-gather
  and reduce-scatter, then ``train.step.expert_mean``) and the grad norm
  from the shards, held to the reference's unsharded
  ``jax.value_and_grad`` over the whole batch at the model-axis test's
  tolerances (rtol 1e-5; gradients atol 1e-5 of the leaf's largest
  entry), at the config's capacity factor and at 0.5, where tokens
  drop: there the reference's loss over each half of the batch routed
  alone differs from the whole batch's by more than 1e-4 relative (10x
  the hold's rtol; 7.4e-4 on these inputs), so a per-rank capacity
  would miss. And 3 steps of the config's train
  settings (``dense``, momentum, 2 microbatches, ``block`` remat, the
  clip at 1.0) held to the reference's own pure auto-sharded step on the
  (data 2, model 2) mesh in the dense step's subprocess, with the
  config's bf16 momentum and with an f32 one: losses and grad norms at
  rtol 1e-5, and at the f32 state the parameters at rtol 1e-5 with atol
  1e-6 of the leaf's largest entry (the bf16 state rounds gradients that
  differ in their last f32 bits to neighbouring bf16 moments: 1.6e-6
  apart on ``embed`` after 3 steps); the layout-free view gathers the
  expert shards over the data ranks, and loaded into a fresh state on
  the grid it gives the same view back bit for bit.
- **the checkpoint**: the layout-free state of 2 steps on the grid
  (granite smoke, compressed with top-k, EF and ZeRO-1) loads into
  ``LocalWorkers(2)`` and gives back the same view; the view of 2 steps
  on ``LocalWorkers(2)`` loads into the grid and gives back the same
  view; all bit for bit.

Off the grid: every one of the ten smoke configs passes
``check_model_axis`` at MP 2 under its own profile; a profile of another
layout raises ``NotImplementedError``, and query columns or a Mamba-head
count that MP does not divide ``ValueError``.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import aggregators as agg_lib
from repro_torch.core.collectives import AggregationState, LocalWorkers
from repro_torch.core.config import CompressionConfig
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.params import flatten_tree
from repro_torch.models.registry import model_api
from repro_torch.parallel import sharding as shd
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.parallel.hints import model_region
from repro_torch.train.step import (build_train_step, expert_mean,
                                    experts_group, init_train_state,
                                    leaf_specs, load_state_view,
                                    model_axis_sq_norm, shard_params,
                                    state_view)

B, S = 8, 32
GRANITE = get_arch("granite-3-2b")
DEEPSEEK = get_arch("deepseek-moe-16b")
OPT = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=100)
# momentum with the clip at 1.0: linear in the gradient but for the clip,
# so rounding noise stays rounding noise (AdamW's rsqrt(v) amplifies it
# on the entries whose gradients are near zero)
DENSE_OPT = OptimizerConfig(kind="momentum", lr=1e-2, warmup_steps=0,
                            total_steps=100)
DENSE_TC = TrainConfig(aggregator="dense", workers=2, optimizer=DENSE_OPT,
                       remat="none")
# train_step_driver.py's tiny MoE and its lossless profile under momentum
TINY = ModelConfig(name="tiny", family="moe", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                   moe=MoEConfig(num_experts=8, top_k=2, shared_experts=1,
                                 expert_d_ff=64, capacity_factor=2.0),
                   dtype="float32")
MOM = OptimizerConfig(kind="momentum", lr=1e-2, warmup_steps=0,
                      total_steps=100, grad_clip=0.0)
LOSSLESS = CompressionConfig(ratio=2.0, lanes=512, rows=60, chunk_blocks=64)
# the shard-local aggregation: 5 buckets of the granite smoke shards
AGG_CFG = CompressionConfig(ratio=0.1, topk_ratio=0.04, lanes=128,
                            bucket_bytes=4 * 128 * 640, use_pallas="never")
CKPT_TC = dataclasses.replace(GRANITE.train, workers=2, accum_steps=1,
                              remat="none", optimizer=OPT)
# the vlm and encdec families on the grid: dense steps under the block remat
FAMILIES = {"internvl": get_arch("internvl2-2b").smoke,
            "whisper": dataclasses.replace(get_arch("whisper-tiny").smoke,
                                           enc_seq=100)}
FAMILY_TC = dataclasses.replace(DENSE_TC, remat="block")
# kimi-k2's profile: its train settings, 2 microbatches, lr 1e-2 from step
# 1; the steps run with the config's bf16 momentum and with an f32 one
KIMI = get_arch("kimi-k2-1t-a32b")
KIMI_TC = dataclasses.replace(KIMI.train, workers=2, accum_steps=2,
                              remat="block", optimizer=OptimizerConfig(
                                  kind="momentum", state_dtype="bfloat16",
                                  lr=1e-2, warmup_steps=0, total_steps=100))
KIMI_STEPS = {"kimi_step": "float32", "kimi_step_bf16": "bfloat16"}
# the value_and_grad holds: the config's capacity factor, and 0.5 (drops)
KIMI_CASES = {"kimi": KIMI.smoke,
              "kimi_drop": dataclasses.replace(KIMI.smoke, moe=dataclasses.replace(
                  KIMI.smoke.moe, capacity_factor=0.5))}


def _batch(cfg, seed):
    """Tokens and labels, and the vlm's visual prefix or the encdec's
    frames (f32)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vis_embed"] = rng.standard_normal(
            (B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch, device):
    """The numpy batch on ``device``: ids as int64, the rest as they are."""
    return {k: torch.from_numpy(v).to(device) if v.dtype.kind == "f"
            else torch.from_numpy(v).to(device).long() for k, v in batch.items()}


def _dyadic(shape, rng):
    return (rng.choice([-1.0, 1.0], size=shape)
            * np.exp2(rng.integers(-2, 3, size=shape))).astype(np.float32)


def _train(mesh, device, cfg, tc, np_params, batch, steps):
    """``steps`` steps on the grid from ``np_params`` (whole) on a fixed
    batch -> (losses, grad norms, the state's layout-free view)."""
    api = model_api(cfg)
    state = init_train_state(api, tc, device, params_from_jax(np_params, device),
                             group=mesh.data, model=mesh.model)
    step = build_train_step(api, tc, group=mesh.data, model=mesh.model)
    b = _torch_batch(batch, device)
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, state


def _view(state, tc, mesh):
    """The state's layout-free view as numpy (a bf16 moment as f32, which
    holds it exactly)."""
    v = state_view(state, tc, mesh.data, mesh.model)
    return [(t.detach().float() if t.dtype == torch.bfloat16 else t.detach())
            .numpy().copy() for _, t in
            flatten_tree({"opt": v.opt, "params": v.params,
                          "residual": v.residual})]


def _shard_grads():
    """Each rank's dyadic gradients of its granite smoke shards, 2 steps:
    ``[rank][step] -> leaves``."""
    params = model_api(GRANITE.smoke).init(0, "cpu")
    shapes = [shd.local_shape(t.shape, shd.leaf_spec(p, t.ndim, GRANITE.profile),
                              {"model": 2})
              for p, t in zip(params.paths, params.leaves())]
    rngs = [np.random.default_rng(100 + r) for r in range(4)]
    return [[[_dyadic(s, rngs[r]) for s in shapes] for _ in range(2)]
            for r in range(4)]


def _aggregate(mesh, grads_steps):
    """Compressed aggregations of this rank's gradients over its data
    group -> per step (aggregate, new residual)."""
    agg = agg_lib.make_aggregator("compressed", AGG_CFG, mesh.data)
    res = [torch.zeros((1,) + g.shape) for g in grads_steps[0]]
    steps = []
    for grads in grads_steps:
        out, st = agg([[torch.from_numpy(g) for g in grads]],
                      AggregationState(residual=res))
        res = st.residual
        steps.append(([o.numpy() for o in out],
                      [r[0].numpy().copy() for r in res]))
    return steps


def _kimi_grads(mesh, device, cfg, np_params, batch):
    """kimi's loss and gradient of the global batch on the grid: this
    data index's rows through the layers, the expert-parallel mean, the
    gradients gathered whole -> (loss, metrics, {path: grad}, norm)."""
    api = model_api(cfg)
    params = shard_params(params_from_jax(np_params, device), KIMI_TC,
                          mesh.model, mesh.data)
    specs = leaf_specs(params, KIMI_TC, mesh.model, mesh.data)
    data = experts_group(KIMI_TC, mesh.data)
    per, d = B // 2, mesh.coords["data"]
    rows = {k: v[d * per:(d + 1) * per]
            for k, v in _torch_batch(batch, device).items()}
    with model_region(mesh.model, experts=data):
        loss, metrics = api.loss(params.tree(), rows, remat="none")
        grads = torch.autograd.grad(loss, params.leaves())
    grads = expert_mean(grads, specs, mesh.data)
    names = list(metrics)
    mean = mesh.data.sum([torch.stack([loss.detach()] + [metrics[k].detach()
                                                         for k in names])]) / 2
    whole = {p: shd.gather_leaf(shd.gather_leaf(g, s, mesh.model), s,
                                mesh.data, axis="data").numpy()
             for p, g, s in zip(params.paths, grads, specs)}
    norm = torch.sqrt(model_axis_sq_norm(grads, specs, mesh.model, data))
    return (mean[0].item(), dict(zip(names, mean[1:].tolist())), whole,
            norm.item())


def _rank(mesh, device, inputs):
    out = {"coords": mesh.coords}
    g_params, g_batch = inputs["granite"]
    losses, norms, state = _train(mesh, device, GRANITE.smoke, DENSE_TC,
                                  g_params, g_batch, 3)
    out["dense"] = (losses, norms, _view(state, DENSE_TC, mesh))
    out["aggregate"] = _aggregate(mesh, inputs["aggregate"][mesh.rank])
    t_params, t_batch = inputs["tiny"]
    for agg in ("dense", "compressed"):
        tc = TrainConfig(aggregator=agg, workers=2, optimizer=MOM,
                         compression=LOSSLESS, zero1=False, remat="block")
        out[f"lossless_{agg}"] = _train(mesh, device, TINY, tc, t_params,
                                        t_batch, 4)[0]
    d_params, d_batch = inputs["deepseek"]
    for ex in ("none", "dense", "compressed"):
        tc = dataclasses.replace(DEEPSEEK.train, workers=2, accum_steps=1,
                                 remat="none", ep_exchange=ex)
        losses, _, state = _train(mesh, device, DEEPSEEK.smoke, tc, d_params,
                                  d_batch, 2)
        out[f"ep_{ex}"] = (losses, [p.detach().numpy().copy()
                                    for p in state.params.leaves()])
    for name, cfg in FAMILIES.items():
        losses, norms, state = _train(mesh, device, cfg, FAMILY_TC,
                                      *inputs[name], 2)
        out[name] = (losses, norms, _view(state, FAMILY_TC, mesh))
    for name, cfg in KIMI_CASES.items():
        out[name] = _kimi_grads(mesh, device, cfg, *inputs["kimi"])
    for name, sdt in KIMI_STEPS.items():
        tc = dataclasses.replace(KIMI_TC, optimizer=dataclasses.replace(
            KIMI_TC.optimizer, state_dtype=sdt))
        losses, norms, state = _train(mesh, device, KIMI.smoke, tc,
                                      *inputs["kimi"], 3)
        view = _view(state, tc, mesh)
        # the view loaded into a fresh state on the grid gives it back
        fresh = init_train_state(model_api(KIMI.smoke), tc, device,
                                 params_from_jax(inputs["kimi"][0], device),
                                 group=mesh.data, model=mesh.model)
        load_state_view(fresh, _view_leaves(state_view(state, tc, mesh.data,
                                                       mesh.model)),
                        tc, mesh.data, mesh.model)
        again = _view(fresh, tc, mesh)
        out[name] = (losses, norms, view,
                     [tuple(p.shape) for p in state.params.leaves()],
                     all(np.array_equal(a, b) for a, b in zip(view, again)))
    # checkpoints across layouts
    _, _, state = _train(mesh, device, GRANITE.smoke, CKPT_TC, g_params,
                         g_batch, 2)
    out["ckpt_grid"] = _view(state, CKPT_TC, mesh)
    state = init_train_state(model_api(GRANITE.smoke), CKPT_TC, device,
                             params_from_jax(g_params, device),
                             group=mesh.data, model=mesh.model)
    load_state_view(state, [torch.from_numpy(x) for x in inputs["ckpt_local"]],
                    CKPT_TC, mesh.data, mesh.model)
    out["ckpt_from_local"] = _view(state, CKPT_TC, mesh)
    return out


def _local_family(cfg, np_params, batch):
    """2 dense steps on ``LocalWorkers(2)`` (one process) -> (losses, grad
    norms, {path: params})."""
    api = model_api(cfg)
    state = init_train_state(api, FAMILY_TC, "cpu", params_from_jax(np_params,
                                                                     "cpu"))
    step = build_train_step(api, FAMILY_TC)
    b = _torch_batch(batch, "cpu")
    losses, norms = [], []
    for _ in range(2):
        state, m = step(state, b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    params = {p: t.detach().numpy().copy() for p, t in
              zip(state.params.paths, state.params.leaves())}
    return losses, norms, params


def _view_leaves(view):
    """A ``state_view``'s leaves in ``view_paths`` order."""
    return ([t for _, t in flatten_tree(view.params)]
            + [t for k in sorted(view.opt)
               for _, t in flatten_tree(view.opt[k])]
            + [t for _, t in flatten_tree(view.residual)] + [view.step])


def _local_ckpt(np_params, batch):
    """2 steps on LocalWorkers(2): (the state's view as _view lists it,
    its leaves in view_paths order)."""
    api = model_api(GRANITE.smoke)
    state = init_train_state(api, CKPT_TC, "cpu", params_from_jax(np_params,
                                                                  "cpu"))
    step = build_train_step(api, CKPT_TC)
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    for _ in range(2):
        state, _ = step(state, b)
    v = state_view(state, CKPT_TC)
    listed = [t.detach().numpy().copy() for _, t in
              flatten_tree({"opt": v.opt, "params": v.params,
                            "residual": v.residual})]
    return listed, [t.detach().clone() for t in _view_leaves(v)]


_REFERENCE_DENSE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.compat import make_mesh
    from repro.configs import get_arch
    from repro.models import model_api
    from repro.parallel.sharding import ShardingProfile
    from repro.train import TrainConfig, OptimizerConfig
    from repro.train import init_train_state, build_train_step
    from repro.train.step import batch_specs

    mesh = make_mesh((2, 2), ("data", "model"))

    def run(arch, remat, steps, src, dst, enc_seq=None, kimi=None):
        data = np.load(src)
        tree, batch = {}, {}
        for key in data.files:
            if not key.startswith("p/"):
                batch[key] = jnp.asarray(data[key])
                continue
            node = tree
            *head, last = key[2:].split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(data[key])
        cfg = get_arch(arch).smoke
        if enc_seq is not None:
            cfg = dataclasses.replace(cfg, enc_seq=enc_seq)
        api = model_api(cfg)
        tc = TrainConfig(aggregator="dense", remat=remat,
                         optimizer=OptimizerConfig(kind="momentum", lr=1e-2,
                                                   warmup_steps=0,
                                                   total_steps=100),
                         sharding=ShardingProfile(zero1=True))
        if kimi:     # the arch's own settings and profile: a pure-auto step
            tc = dataclasses.replace(
                get_arch(arch).train, remat=remat, accum_steps=2,
                optimizer=OptimizerConfig(kind="momentum", lr=1e-2,
                                          warmup_steps=0, total_steps=100,
                                          state_dtype=kimi))
        state = init_train_state(api, tc, mesh, jax.random.PRNGKey(0))
        state = dataclasses.replace(state, params=tree)
        step_fn, specs = build_train_step(api, tc, mesh)(state)
        _, bnamed = batch_specs(batch, mesh, tc)
        jitted = jax.jit(step_fn, in_shardings=(specs["named"], bnamed),
                         out_shardings=(specs["named"], None))
        st = jax.device_put(state, specs["named"])
        b = jax.device_put(batch, bnamed)
        losses, norms = [], []
        for _ in range(steps):
            st, m = jitted(st, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        flat = jax.tree_util.tree_flatten_with_path(st.params)[0]
        out = {"p/" + "/".join(str(k.key) for k in path): np.asarray(v)
               for path, v in flat}
        np.savez(dst, losses=np.array(losses), norms=np.array(norms), **out)

    for case in json.loads(sys.argv[1]):
        run(**case)
''')


def _reference_dense(tmp, cases):
    """The reference's dense step on a (data 2, model 2) mesh of 4 fake
    CPU devices, in one subprocess for every case: ``cases`` maps a name
    to (arch, remat, steps, enc_seq, np_params, batch) -> name to
    (losses, grad norms, {path: params})."""
    jobs = []
    for name, (arch, remat, steps, enc_seq, np_params, batch) in cases.items():
        src = os.path.join(tmp, f"{name}_in.npz")
        dst = os.path.join(tmp, f"{name}_out.npz")
        np.savez(src, **{"p/" + "/".join(p): v
                         for p, v in flatten_tree(np_params)}, **batch)
        jobs.append({"arch": arch, "remat": remat, "steps": steps,
                     "enc_seq": enc_seq, "src": src, "dst": dst})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, "-c", _REFERENCE_DENSE, json.dumps(jobs)],
                   env=env, check=True, timeout=300)
    out = {}
    for name, job in zip(cases, jobs):
        data = np.load(job["dst"])
        params = {tuple(k[2:].split("/")): data[k] for k in data.files
                  if k.startswith("p/")}
        out[name] = (list(data["losses"]), list(data["norms"]), params)
    return out


def _reference_aggregate(ranks):
    """The reference's nested-branch functions composed over one data
    group (``ranks``: its members' gradients by step, data index order)
    -> per step, the aggregate and each member's new residual."""
    import jax.numpy as jnp
    from repro.core import CompressionConfig as JConfig
    from repro.core.aggregators import _sparsify_leaf
    from repro.core.bucketing import make_bucket_plan
    from repro.core.compressor import (CompressedLeaf,
                                       HomomorphicCompressor)

    jc = JConfig(**dataclasses.asdict(AGG_CFG))
    comp = HomomorphicCompressor(jc)
    W = len(ranks)
    res = [[np.zeros_like(g) for g in ranks[0][0]] for _ in range(W)]
    out = []
    for s in range(len(ranks[0])):
        grads_w = [r[s] for r in ranks]
        shapes = [g.shape for g in grads_w[0]]
        plan = make_bucket_plan([jnp.asarray(g) for g in grads_w[0]], jc,
                                shapes=shapes)
        sks, words = [], []
        for w in range(W):
            flats, nrs = [], []
            for g, r in zip(grads_w[w], res[w]):
                flat, nr = _sparsify_leaf(jnp.asarray(g).reshape(-1),
                                          jnp.asarray(r), jc)
                flats.append(flat)
                nrs.append(np.asarray(nr).reshape(g.shape))
            res[w] = nrs
            c = comp.compress(plan.pack_flat(flats).reshape(-1))
            sks.append(np.asarray(c.sketch))
            words.append(np.asarray(c.index_words))
        rec = comp.recover(CompressedLeaf(
            sketch=jnp.asarray(sum(sks[1:], sks[0])),
            index_words=jnp.asarray(np.bitwise_or.reduce(np.stack(words), 0))),
            plan.padded)
        agg = plan.unpack(rec.reshape(plan.n_buckets, plan.bucket_elems) / W)
        out.append(([np.asarray(a) for a in agg], [list(r) for r in res]))
    return out


def _reference_grads(cfg, np_params, batch):
    """The reference's loss, metrics, gradients and grad norm of the
    whole batch on one device, and its loss over each half of the batch
    routed alone (the per-rank capacity a data split would give)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.models import model_api as j_model_api

    jcfg = dataclasses.replace(j_get_arch(cfg.name).smoke, moe=dataclasses.replace(
        j_get_arch(cfg.name).smoke.moe, capacity_factor=cfg.moe.capacity_factor))
    japi = j_model_api(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss = jax.jit(lambda p, b: japi.loss(p, b))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, jb), has_aux=True))(jp)
    halves = [float(loss(jp, {k: v[h * B // 2:(h + 1) * B // 2]
                              for k, v in jb.items()})[0]) for h in range(2)]
    return {"loss": float(jl), "metrics": {k: float(v) for k, v in jm.items()},
            "grads": dict(flatten_tree(jax.tree.map(np.asarray, jg))),
            "norm": float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                                       for g in jax.tree.leaves(jg)))),
            "halves_loss": float(np.mean(halves))}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    from repro_torch.launch.ranks import spawn_ranks

    tmp = str(tmp_path_factory.mktemp("grid"))
    inputs = {"granite": (params_to_numpy(model_api(GRANITE.smoke).init(1, "cpu")),
                          _batch(GRANITE.smoke, 1)),
              "tiny": (params_to_numpy(model_api(TINY).init(2, "cpu")),
                       _batch(TINY, 2)),
              "deepseek": (params_to_numpy(model_api(DEEPSEEK.smoke).init(3, "cpu")),
                           _batch(DEEPSEEK.smoke, 3))}
    for i, (name, cfg) in enumerate(FAMILIES.items()):
        inputs[name] = (params_to_numpy(model_api(cfg).init(4 + i, "cpu")),
                        _batch(cfg, 4 + i))
    inputs["kimi"] = (params_to_numpy(model_api(KIMI.smoke).init(6, "cpu")),
                      _batch(KIMI.smoke, 6))
    local_listed, local_leaves = _local_ckpt(*inputs["granite"])
    inputs["ckpt_local"] = [t.numpy() for t in local_leaves]
    inputs["aggregate"] = _shard_grads()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fut = ex.submit(spawn_ranks, _rank, 4, (inputs,), device="cpu",
                        model_parallel=2, threads=1, timeout=300,
                        init_dir=tmp)
        cases = {"granite": ("granite-3-2b", "none", 3, None)
                             + inputs["granite"]}
        for name, cfg in FAMILIES.items():
            enc_seq = cfg.enc_seq if cfg.family == "encdec" else None
            cases[name] = (cfg.name, FAMILY_TC.remat, 2, enc_seq) + inputs[name]
        for name in KIMI_STEPS:
            cases[name] = (KIMI.smoke.name, KIMI_TC.remat, 3, None) \
                + inputs["kimi"]
        ref = ex.submit(_reference_dense, tmp, cases)
        kimi = {name: _reference_grads(cfg, *inputs["kimi"])
                for name, cfg in KIMI_CASES.items()}
        agg = [_reference_aggregate([inputs["aggregate"][d * 2 + t]
                                     for d in range(2)]) for t in range(2)]
        families = {name: _local_family(cfg, *inputs[name])
                    for name, cfg in FAMILIES.items()}
        ref = ref.result()
        return {"ranks": fut.result(), "ref_dense": ref.pop("granite"),
                "ref_kimi_steps": {n: ref.pop(n) for n in KIMI_STEPS},
                "ref_kimi": kimi,
                "ref_families": ref,
                "ref_aggregate": agg, "inputs": inputs,
                "local_listed": local_listed, "families": families}


def test_grid_coordinates_are_model_innermost(grid):
    assert [r["coords"] for r in grid["ranks"]] == [
        {"data": d, "model": t} for d in range(2) for t in range(2)]


def test_dense_step_matches_reference_dense_step_on_2x2_mesh(grid):
    want_losses, want_norms, want_params = grid["ref_dense"]
    views = [r["dense"] for r in grid["ranks"]]
    for losses, norms, _ in views[1:]:
        assert losses == views[0][0] and norms == views[0][1]
    losses, norms, view = views[0]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    assert losses[-1] < losses[0]
    # the view lists opt, params, residual: the params are those paths
    paths = [p for p, _ in flatten_tree(grid["inputs"]["granite"][0])]
    n_opt = len(view) - 2 * len(paths)
    got = dict(zip(paths, view[n_opt:n_opt + len(paths)]))
    for path in paths:
        want = want_params[path]
        np.testing.assert_allclose(got[path], want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_step_on_2x2_grid_matches_local_step_and_reference(grid, name):
    views = [r[name] for r in grid["ranks"]]
    for losses, norms, _ in views[1:]:
        assert losses == views[0][0] and norms == views[0][1]
    losses, norms, view = views[0]
    paths = [p for p, _ in flatten_tree(grid["inputs"][name][0])]
    n_opt = len(view) - 2 * len(paths)
    got = dict(zip(paths, view[n_opt:n_opt + len(paths)]))
    # the reference's own step on the (data 2, model 2) mesh, then the
    # port's single-process step as a second witness
    for want_losses, want_norms, want_params in (grid["ref_families"][name],
                                                 grid["families"][name]):
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
        for path in paths:
            want = want_params[path]
            np.testing.assert_allclose(got[path], want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=str(path))


@pytest.mark.parametrize("name", list(KIMI_CASES))
def test_kimi_profile_gradient_is_the_global_batch_reference(grid, name):
    ref = grid["ref_kimi"][name]
    got = [r[name] for r in grid["ranks"]]
    for loss, metrics, grads, norm in got[1:]:
        assert loss == got[0][0] and norm == got[0][3]
    loss, metrics, grads, norm = got[0]
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-7)
    assert set(grads) == set(ref["grads"])
    for path, want in ref["grads"].items():
        np.testing.assert_allclose(grads[path], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=str(path))
        for r in got[1:]:
            np.testing.assert_array_equal(r[2][path], grads[path])
    np.testing.assert_allclose(norm, ref["norm"], rtol=1e-6)
    if name == "kimi_drop":
        # tokens drop: the batch's halves routed alone give another loss
        # (7.4e-4 relative on these inputs, 74x the hold's rtol)
        assert abs(ref["halves_loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"])


@pytest.mark.parametrize("name", list(KIMI_STEPS))
def test_kimi_profile_step_matches_reference_pure_auto_step(grid, name):
    want_losses, want_norms, want_params = grid["ref_kimi_steps"][name]
    views = [r[name] for r in grid["ranks"]]
    assert all(v[4] for v in views)            # the view reloads exactly
    for losses, norms, view, _, _ in views[1:]:
        assert losses == views[0][0] and norms == views[0][1]
        for a, b in zip(view, views[0][2]):
            np.testing.assert_array_equal(a, b)
    losses, norms, view, shapes, _ = views[0]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    assert losses[-1] != losses[0]
    paths = [p for p, _ in flatten_tree(grid["inputs"]["kimi"][0])]
    n_opt = len(view) - 2 * len(paths)
    got = dict(zip(paths, view[n_opt:n_opt + len(paths)]))
    # a bf16 moment rounds gradients that differ in their last f32 bits
    # to neighbouring bf16 values (one ulp, 2^-8 of the moment): the
    # parameters are held at the f32 state only
    for path in (paths if KIMI_STEPS[name] == "float32" else ()):
        want = want_params[path]
        np.testing.assert_allclose(got[path], want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=str(path))
    # each rank held 4 of 8 experts, 64 of 128 of their d_ff
    local = dict(zip(paths, shapes))
    assert local[("layers", "moe", "we_gate")] == (2, 4, 128, 64)
    assert local[("layers", "moe", "we_down")] == (2, 4, 64, 128)


def test_shard_local_compressed_aggregate_matches_composed_reference(grid):
    ranks = grid["ranks"]
    for t in range(2):
        members = [ranks[d * 2 + t]["aggregate"] for d in range(2)]
        for s, (agg, res) in enumerate(grid["ref_aggregate"][t]):
            for d in range(2):
                got_agg, got_res = members[d][s]
                for a, b in zip(got_agg, agg):
                    np.testing.assert_array_equal(a, b)
                for a, b in zip(got_res, res[d]):
                    np.testing.assert_array_equal(a, b)
                    np.testing.assert_array_equal(a != 0, b != 0)
    # the two model ranks of a data index pack different shards
    a0, a1 = (ranks[t]["aggregate"][0][0] for t in range(2))
    assert any(not np.array_equal(x, y) for x, y in zip(a0, a1))


def test_lossless_compressed_tracks_dense_under_momentum(grid):
    r = grid["ranks"][0]
    dense, comp = r["lossless_dense"], r["lossless_compressed"]
    assert dense[-1] < dense[0]
    assert all(abs(a - b) < 1e-4 for a, b in zip(dense, comp)), (dense, comp)


def test_deepseek_exchanges_on_the_model_axis(grid):
    for r in grid["ranks"]:
        l_none, _ = r["ep_none"]
        l_dense, p_dense = r["ep_dense"]
        l_comp, p_comp = r["ep_compressed"]
        assert l_dense == l_comp
        for a, b in zip(p_dense, p_comp):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(l_dense, l_none, rtol=1e-6)


def test_checkpoint_round_trips_across_layouts(grid):
    ranks = grid["ranks"]
    # the grid's view is one state, on every rank
    for r in ranks[1:]:
        for a, b in zip(r["ckpt_grid"], ranks[0]["ckpt_grid"]):
            np.testing.assert_array_equal(a, b)
    # grid -> LocalWorkers(2) -> view
    api = model_api(GRANITE.smoke)
    np_params = grid["inputs"]["granite"][0]
    state = init_train_state(api, CKPT_TC, "cpu", params_from_jax(np_params,
                                                                  "cpu"))
    grid_view = ranks[0]["ckpt_grid"]
    # _view lists opt, params, residual in path order; view_paths wants
    # params, opt (by moment), residual, step
    n = len(list(flatten_tree(np_params)))
    moms = len(grid_view) // n - 2
    opt, params, res = (grid_view[:moms * n], grid_view[moms * n:(moms + 1) * n],
                        grid_view[(moms + 1) * n:])
    leaves = params + opt + res + [np.int32(2)]
    load_state_view(state, [torch.as_tensor(x) for x in leaves], CKPT_TC)
    v = state_view(state, CKPT_TC)
    back = [t.detach().numpy() for _, t in
            flatten_tree({"opt": v.opt, "params": v.params,
                          "residual": v.residual})]
    for a, b in zip(back, grid_view):
        np.testing.assert_array_equal(a, b)
    # LocalWorkers(2) -> grid -> view
    for r in ranks:
        for a, b in zip(r["ckpt_from_local"], grid["local_listed"]):
            np.testing.assert_array_equal(a, b)


def test_model_axis_refuses_unported_families_and_layouts():
    from repro_torch.configs import list_archs
    from repro_torch.models.transformer import check_model_axis
    from repro_torch.parallel.sharding import ShardingProfile

    # every smoke config passes at MP 2 under its own profile, kimi's too
    names = list_archs()
    assert len(names) == 10 and "kimi-k2-1t-a32b" in names
    for name in names:
        arch = get_arch(name)
        check_model_axis(arch.smoke, 2, arch.profile)
        check_model_axis(arch.smoke, 1, arch.profile)        # no model axis
    # a layout other than the default's or kimi's
    group = type("G", (), {"workers": 2, "first_worker": 0})()
    for prof in (ShardingProfile(ep_axes=("data",)),
                 ShardingProfile(ep_ff_axis="model"),
                 ShardingProfile(dp_axes=(), ep_axes=("data",)),
                 ShardingProfile(vocab_axis=None)):
        with pytest.raises(NotImplementedError, match="profile"):
            check_model_axis(DEEPSEEK.smoke, 2, prof)
        with pytest.raises(NotImplementedError, match="model_parallel=2"):
            build_train_step(model_api(DEEPSEEK.smoke),
                             dataclasses.replace(DEEPSEEK.train, workers=1,
                                                 sharding=prof),
                             model=group)
    # query heads MP does not divide are fine (the reference's uneven
    # head split: the heads gathered whole), query columns it does not
    # divide raise
    odd = dataclasses.replace(GRANITE.smoke, n_heads=3, n_kv_heads=3,
                              head_dim=32)
    check_model_axis(odd, 2)
    with pytest.raises(ValueError, match=r"n_heads \* hd 102"):
        check_model_axis(dataclasses.replace(odd, head_dim=34), 4)
    # KV heads MP does not divide are fine (their columns are gathered)
    check_model_axis(dataclasses.replace(GRANITE.smoke, n_heads=6,
                                         n_kv_heads=3, head_dim=32), 2)
    # Mamba heads MP does not divide: 3 heads of 16 (d_inner 48)
    mamba = get_arch("mamba2-1.3b")
    odd_ssm = dataclasses.replace(mamba.smoke, d_model=24)
    with pytest.raises(ValueError, match="ssm n_heads 3"):
        check_model_axis(odd_ssm, 2, mamba.profile)
    jamba = get_arch("jamba-v0.1-52b")
    with pytest.raises(ValueError, match="ssm n_heads 3"):
        check_model_axis(dataclasses.replace(jamba.smoke, d_model=24), 2,
                         jamba.profile)
