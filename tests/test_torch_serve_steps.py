"""Serving on the (data x model) rank grid (``repro_torch.serve.steps``)
against the reference's sharded serve steps.

The reference's side runs in one subprocess with 4 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before its first
JAX import): for each case it jits ``build_prefill_step`` and
``build_decode_step`` with the ``in_shardings`` / ``out_shardings`` of
``serve_shardings``, as its ``launch/dryrun.py:lower_cell`` does, on a
``(data 2, model 2)`` mesh (``(1, 4)`` for qwen2.5-3b, whose smoke
config's 2 KV heads the 4 model ranks split inside a head), and returns
the logits of the prefill and of 4 greedy decode steps, the tokens, the
caches after the prefill and after the last step (gathered whole), and
its spec trees. The port's side is one spawn of 4 gloo ranks on the CPU
(``launch/ranks.py``, ``model_parallel=2``; qwen2.5-3b on
``make_host_mesh(4)`` inside the same ranks) running the port's steps
on the same parameters and prompts, its tokens gathered over the data
ranks between steps (``steps.gather_batch``).

The holds, at the smoke configs of granite-3-2b (dense), deepseek-moe-16b
(moe: its MoE layers route every data rank's tokens as one batch, the
reference's serve routing), kimi-k2's profile (experts over the data
ranks) and qwen2.5-3b, at B 4 (the batch over ``data``, the sequence
over ``model``) and B 1 (the sequence over every rank), prompts of 8:

- the greedy tokens equal;
- the logits at ``rtol=1e-5, atol=1e-6`` (``tests/test_torch_serve.py``'s);
- each rank's cache, after the prefill and after the last step, equal
  at the same tolerance to its ``shard_leaf`` block of the reference's
  whole cache under ``cache_pspecs``;
- ``serve_shardings``' spec trees equal the reference's
  ``PartitionSpec``\\ s as tuples.

Off the reference: the two-pass decode combine on dyadic q, K and V
(scores that are either the row's max or 181 below it, so every weight
is 0 or 1/4, and every sum exact) equals the unsharded
``attention_decode`` bit for bit, with the sequence over the model ranks
and over all four; and a cache length that does not split over the
sequence's ranks raises ``ValueError``.

The ssm, hybrid, vlm and encdec families are in
``tests/test_torch_serve_families.py``, which reuses this file's
machinery.
"""
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
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.params import flatten_tree
from repro_torch.models.registry import model_api
from repro_torch.parallel import sharding as shd

TOL = dict(rtol=1e-5, atol=1e-6)
S, NEW = 8, 4
# name -> (arch, global batch, model ranks, smoke config overrides)
CASES = {f"{short}_b{B}": (arch, B, mp, {})
         for short, arch, mp in (("granite", "granite-3-2b", 2),
                                 ("deepseek", "deepseek-moe-16b", 2),
                                 ("kimi", "kimi-k2-1t-a32b", 2),
                                 ("qwen", "qwen2.5-3b", 4))
         for B in (4, 1)}
# query heads the 4 model ranks do not divide (the reference's uneven
# head split: 6 heads of 32, 48 query columns a rank)
UNEVEN = {"n_heads": 6, "n_kv_heads": 3, "head_dim": 32}
CASES["granite_h6_b4"] = ("granite-3-2b", 4, 4, UNEVEN)


def case_cfg(case):
    """The case's smoke config, with its overrides."""
    arch, _, _, over = case
    return dataclasses.replace(get_arch(arch).smoke, **over)


def vis_len(cfg) -> int:
    return cfg.vis_tokens if cfg.family == "vlm" else 0


def max_len(cfg) -> int:
    """The cache's positions: the prompt (after the vlm's prefix) and
    the new tokens."""
    return S + vis_len(cfg) + NEW


def make_inputs(cases, seed0=1):
    """Each case's whole parameters (the port's draws, as numpy) and its
    global batch."""
    out = {}
    for i, (name, case) in enumerate(cases.items()):
        cfg, B = case_cfg(case), case[1]
        rng = np.random.default_rng(seed0 + i)
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if cfg.family == "vlm":
            batch["vis_embed"] = rng.standard_normal(
                (B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        out[name] = (params_to_numpy(model_api(cfg).init(seed0 + i, "cpu")),
                     batch)
    return out


def _flat(tree):
    return {"/".join(p): t.detach().cpu().numpy().copy()
            for p, t in flatten_tree(tree)}


def serve_case(mesh, device, case, np_params, batch):
    """The port's prefill and NEW greedy decode steps on ``mesh`` -> the
    rank's logits a step, the tokens, and its caches after the prefill
    and after the last step."""
    from repro_torch.serve import steps as st

    cfg, prof = case_cfg(case), get_arch(case[0]).profile
    api = model_api(cfg)
    params = st.shard_params(params_from_jax(np_params, device).tree(), prof,
                             mesh)
    prefill = st.build_prefill_step(api, prof, mesh, max_len(cfg))
    decode = st.build_decode_step(api, prof, mesh)
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    b["tokens"] = b["tokens"].long()
    B = b["tokens"].shape[0]
    logits, cache = prefill(params, b)
    out = {"logits": [logits.numpy().copy()], "cache0": _flat(cache)}
    tok = st.gather_batch(logits.argmax(-1), prof, mesh, B)
    toks = [tok.numpy().copy()]
    for i in range(NEW):
        logits, cache = decode(params, tok, cache, S + vis_len(cfg) + i)
        out["logits"].append(logits.numpy().copy())
        tok = st.gather_batch(logits.argmax(-1), prof, mesh, B)
        toks.append(tok.numpy().copy())
    out["tokens"] = np.stack(toks)
    out["cache"] = _flat(cache)
    return out


# ----------------------------------------------------------------------
# the two-pass combine on dyadic values, and a length that does not split
# ----------------------------------------------------------------------

COMBINE_S, COMBINE_POS = 16, 9


def dyadic_attention(seed=0):
    """granite smoke's attention on dyadic inputs whose scores are the
    row's max (4 keys at or before ``COMBINE_POS``, the new token's
    among them) or 181 below it: q = 4u, a hit key 4u, a miss -4u, with
    u = ±1 per coordinate, so ``s = ±90.5`` and ``exp`` is 1 or 0."""
    cfg = get_arch("granite-3-2b").smoke
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(seed)
    B = 2

    def dy(shape, lo=-2, hi=1):
        return (rng.choice([-1.0, 1.0], size=shape)
                * np.exp2(rng.integers(lo, hi, size=shape))).astype(np.float32)

    u = rng.choice([-1.0, 1.0], size=hd).astype(np.float32)
    p = {"wq": dy((D, H * hd)), "wk": dy((D, KV * hd)),
         "wv": dy((D, KV * hd)), "wo": dy((H * hd, D))}
    p["wq"][0] = np.tile(4 * u, H)
    p["wk"][0] = np.tile(4 * u, KV)
    x = np.zeros((B, 1, D), np.float32)
    x[..., 0] = 1.0
    k = np.empty((B, COMBINE_S, KV, hd), np.float32)
    hits = np.zeros((B, COMBINE_S, KV), bool)
    for b in range(B):
        for g in range(KV):
            hits[b, rng.choice(COMBINE_POS, 3, replace=False), g] = True
            hits[b, COMBINE_POS + 1 + rng.choice(COMBINE_S - COMBINE_POS - 1,
                                                 2, replace=False), g] = True
    k[:] = -4 * u
    k[hits] = 4 * u
    v = dy((B, COMBINE_S, KV, hd))
    return cfg, {kk: vv for kk, vv in p.items()}, x, k, v


def combine_on_grid(mesh, device):
    """This rank's output and cache block of the sharded decode, with the
    sequence over the model ranks and over all four."""
    from repro_torch.models import layers as L
    from repro_torch.parallel import hints

    cfg, p, x, k, v = dyadic_attention()
    spec = {n: shd.leaf_spec(("attn", n), 2, get_arch("granite-3-2b").profile)
            for n in p}
    shard = {n: torch.from_numpy(shd.shard_leaf(torch.from_numpy(w), spec[n],
                                                mesh.shape, mesh.coords).numpy())
             for n, w in p.items()}
    out = {}
    for axes in (("model",), ("data", "model")):
        seq = mesh.group(axes)
        cspec = (None, axes, None, None)
        kb = shd.shard_leaf(torch.from_numpy(k), cspec, mesh.shape,
                            mesh.coords).clone()
        vb = shd.shard_leaf(torch.from_numpy(v), cspec, mesh.shape,
                            mesh.coords).clone()
        with torch.inference_mode(), hints.model_region(mesh.model, seq=seq):
            o, kb, vb = L.attention_decode(torch.from_numpy(x), shard, cfg,
                                           kb, vb, COMBINE_POS, rope=False)
        out[axes] = (o.numpy().copy(), kb.numpy().copy(), vb.numpy().copy())
    return out


def split_error(mesh, device):
    """The message of the prefill whose cache length (10) does not split
    over the 4 ranks its B 1 sequence is spread over."""
    from repro_torch.serve import steps as st

    arch = get_arch("granite-3-2b")
    api = model_api(arch.smoke)
    params = st.shard_params(api.init(0, "cpu"), arch.profile, mesh)
    prefill = st.build_prefill_step(api, arch.profile, mesh, 10)
    try:
        prefill(params, {"tokens": torch.zeros((1, S), dtype=torch.long)})
    except ValueError as e:
        return str(e)
    return None


def uneven_grads(mesh, device, np_params, batch):
    """The loss and the gradients (gathered whole) of the uneven-head
    granite on a grid of 4 model ranks."""
    from repro_torch.models.params import ParamTree, unflatten_tree
    from repro_torch.parallel.hints import model_region

    cfg, prof = case_cfg(CASES["granite_h6_b4"]), get_arch("granite-3-2b").profile
    api = model_api(cfg)
    whole = params_from_jax(np_params, device)
    specs = [shd.leaf_spec(p, t.ndim, prof)
             for p, t in zip(whole.paths, whole.leaves())]
    params = ParamTree(unflatten_tree([
        (p, shd.shard_leaf(t.detach(), s, mesh.shape, mesh.coords).clone())
        for p, t, s in zip(whole.paths, whole.leaves(), specs)]))
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with model_region(mesh.model):
        loss, _ = api.loss(params.tree(), b)
        grads = torch.autograd.grad(loss, params.leaves())
    return loss.item(), {"/".join(p): shd.gather_leaf(g, s, mesh.model).numpy()
                         for p, g, s in zip(params.paths, grads, specs)}


def grid_rank(mesh, device, inputs, cases, extras):
    from repro_torch.launch.mesh import make_host_mesh

    wide = make_host_mesh(4) if any(c[2] == 4 for c in cases.values()) else None
    out = {"coords": mesh.coords}
    for name, case in cases.items():
        out[name] = serve_case(mesh if case[2] == 2 else wide, device, case,
                               *inputs[name])
    if extras:
        out["combine"] = combine_on_grid(mesh, device)
        out["split_error"] = split_error(mesh, device)
        out["uneven_grads"] = uneven_grads(wide, device, *extras["uneven"])
    return out


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------

REFERENCE_SERVE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import make_mesh
    from repro.configs import get_arch
    from repro.models import model_api
    from repro.serve.steps import (build_decode_step, build_prefill_step,
                                   serve_shardings)

    def spec(s):
        return [list(a) if isinstance(a, tuple) else a for a in s]

    def flat(tree, fn):
        out = {}
        for path, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, (P, NamedSharding)))[0]:
            out["/".join(str(k.key) for k in path)] = fn(v)
        return out

    def run(arch, over, mesh_shape, src, dst, S, new, max_len, vis):
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
        spec_a = get_arch(arch)
        cfg = dataclasses.replace(spec_a.smoke, **over)
        prof = spec_a.train.sharding
        api = model_api(cfg)
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
        B = batch["tokens"].shape[0]
        length = max(max_len, S + vis)
        sh = serve_shardings(api, prof, mesh, B, length)
        bsh = {k: sh["batch"] for k in batch}
        prefill = jax.jit(build_prefill_step(api, prof, mesh, max_len),
                          in_shardings=(sh["params"], bsh))
        decode = jax.jit(build_decode_step(api, prof, mesh),
                         in_shardings=(sh["params"], sh["batch"], sh["cache"],
                                       None),
                         out_shardings=(None, sh["cache"]))
        params = jax.device_put(tree, sh["params"])
        logits, cache = prefill(params, jax.device_put(batch, bsh))
        out = {"logits_0": np.asarray(logits)}
        out.update({"cache0/" + k: v for k, v in
                    flat(cache, np.asarray).items()})
        cache = jax.device_put(cache, sh["cache"])
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks = [np.asarray(tok)]
        for i in range(new):
            logits, cache = decode(params, jax.device_put(tok, sh["batch"]),
                                   cache, S + vis + i)
            out[f"logits_{i + 1}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            toks.append(np.asarray(tok))
        out["tokens"] = np.stack(toks)
        out.update({"cache/" + k: v for k, v in flat(cache, np.asarray).items()})
        np.savez(dst, **out)
        specs = {"params": flat(sh["pspecs"], spec),
                 "cache": flat(sh["cache"], lambda s: spec(s.spec)),
                 "batch": spec(sh["batch"].spec)}
        with open(dst + ".json", "w") as f:
            json.dump(specs, f)

    for case in json.loads(sys.argv[1]):
        run(**case)
''')


def reference_serve(tmp, cases, inputs):
    """The reference's sharded serve steps for every case, in one
    subprocess -> name to (logits a step, tokens, {path: cache after
    prefill}, {path: cache after the last step}, its spec trees)."""
    jobs = []
    for name, case in cases.items():
        arch, B, mp, over = case
        cfg = case_cfg(case)
        np_params, batch = inputs[name]
        src = os.path.join(tmp, f"{name}_in.npz")
        dst = os.path.join(tmp, f"{name}_out.npz")
        np.savez(src, **{"p/" + "/".join(p): v
                         for p, v in flatten_tree(np_params)}, **batch)
        jobs.append({"arch": arch, "over": over, "mesh_shape": [4 // mp, mp],
                     "src": src,
                     "dst": dst, "S": S, "new": NEW, "max_len": max_len(cfg),
                     "vis": vis_len(cfg)})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, "-c", REFERENCE_SERVE, json.dumps(jobs)],
                   env=env, check=True, timeout=600)
    out = {}
    for name, job in zip(cases, jobs):
        data = np.load(job["dst"])
        with open(job["dst"] + ".json") as f:
            specs = json.load(f)
        out[name] = {
            "logits": [data[f"logits_{i}"] for i in range(NEW + 1)],
            "tokens": data["tokens"],
            "cache0": {k[7:]: data[k] for k in data.files
                       if k.startswith("cache0/")},
            "cache": {k[6:]: data[k] for k in data.files
                      if k.startswith("cache/")},
            "specs": specs}
    return out


def run_grid(tmp, cases, extras):
    """The port's grid and the reference for ``cases``, side by side;
    with ``extras``, the grid's holds that need no reference."""
    import concurrent.futures

    from repro_torch.launch.ranks import spawn_ranks

    inputs = make_inputs(cases)
    if extras:
        cfg = case_cfg(CASES["granite_h6_b4"])
        rng = np.random.default_rng(7)
        extras = {"uneven": (
            params_to_numpy(model_api(cfg).init(7, "cpu")),
            {k: rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
             for k in ("tokens", "labels")})}
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ref = ex.submit(reference_serve, tmp, cases, inputs)
        ranks = spawn_ranks(grid_rank, 4, (inputs, cases, extras),
                            device="cpu", model_parallel=2, threads=1,
                            timeout=600, init_dir=tmp)
        return {"ranks": ranks, "ref": ref.result(), "inputs": inputs,
                "extras": extras}


def _rows(x, B, coords, mp):
    """The rows of the global ``x`` a rank of a (4/mp, mp) grid serves."""
    W = 4 // mp
    if B % W:
        return x
    d = coords["data"] if mp == 2 else 0
    n = B // W
    return x[d * n:(d + 1) * n]


def _rank_coords(r, mp):
    return {"data": r // mp, "model": r % mp}


def _cache_specs(case):
    """Each cache path's spec on the case's mesh (the port's)."""
    from repro_torch.serve import steps as st

    arch, B, mp, _ = case
    cfg = case_cfg(case)
    mesh = MeshShape({"data": 4 // mp, "model": mp})
    sh = st.serve_shardings(model_api(cfg), get_arch(arch).profile, mesh, B,
                            max_len(cfg))
    return {"/".join(p): s for p, s in flatten_tree(sh["cache"])}, mesh


def _spec_json(s):
    """A spec as JSON lists, a one-name entry as the name (JAX's
    ``PartitionSpec`` normalises ``P(("data",))`` to ``P("data")``)."""
    return [(a[0] if len(a) == 1 else list(a))
            if isinstance(a, (tuple, list)) else a for a in s]


def _norm(tree):
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    return _spec_json(tree)


# ----------------------------------------------------------------------
# the holds (shared with tests/test_torch_serve_families.py)
# ----------------------------------------------------------------------

def check_tokens(run, name):
    want = run["ref"][name]["tokens"]
    for r in run["ranks"]:
        np.testing.assert_array_equal(r[name]["tokens"], want)


def check_logits(run, name, cases):
    arch, B, mp, _ = cases[name]
    want = run["ref"][name]["logits"]
    for rank, r in enumerate(run["ranks"]):
        coords = _rank_coords(rank, mp)
        for i, (got, w) in enumerate(zip(r[name]["logits"], want)):
            np.testing.assert_allclose(got, _rows(w, B, coords, mp), **TOL,
                                       err_msg=f"rank {rank} step {i}")


def check_caches(run, name, cases):
    arch, B, mp, _ = cases[name]
    specs, mesh = _cache_specs(cases[name])
    for which in ("cache0", "cache"):
        want = run["ref"][name][which]
        assert set(want) == set(specs)
        for rank, r in enumerate(run["ranks"]):
            coords = _rank_coords(rank, mp)
            got = r[name][which]
            assert set(got) == set(specs)
            for path, w in want.items():
                block = shd.shard_leaf(torch.from_numpy(w), specs[path],
                                       mesh.shape, coords).numpy()
                np.testing.assert_allclose(got[path], block, **TOL,
                                           err_msg=f"{which} {path} rank {rank}")


def check_specs(run, name, cases):
    from repro_torch.serve import steps as st

    arch, B, mp, _ = cases[name]
    cfg = case_cfg(cases[name])
    mesh = MeshShape({"data": 4 // mp, "model": mp})
    sh = st.serve_shardings(model_api(cfg), get_arch(arch).profile, mesh, B,
                            max_len(cfg))
    want = _norm(run["ref"][name]["specs"])
    assert {"/".join(p): _spec_json(s)
            for p, s in flatten_tree(sh["pspecs"])} == want["params"]
    assert {"/".join(p): _spec_json(s)
            for p, s in flatten_tree(sh["cache"])} == want["cache"]
    assert _spec_json(sh["batch"]) == want["batch"]
    # the local shapes are the whole shapes cut by the specs
    for p, t in flatten_tree(sh["params_struct"]):
        s = dict(flatten_tree(sh["pspecs"]))[p]
        assert dict(flatten_tree(sh["params"]))[p] == shd.local_shape(
            tuple(t.shape), s, mesh.shape)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return run_grid(str(tmp_path_factory.mktemp("serve_steps")), CASES, True)


def test_grid_ranks_are_model_innermost(grid):
    assert [r["coords"] for r in grid["ranks"]] == [
        {"data": d, "model": t} for d in range(2) for t in range(2)]


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_equal_reference(grid, name):
    check_tokens(grid, name)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_reference_sharded_steps(grid, name):
    check_logits(grid, name, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_cache_blocks_match_reference_cache_pspecs(grid, name):
    check_caches(grid, name, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_serve_shardings_spec_trees_equal_reference(grid, name):
    check_specs(grid, name, CASES)


@pytest.mark.parametrize("axes", [("model",), ("data", "model")])
def test_two_pass_combine_is_bit_for_bit_on_dyadic_values(grid, axes):
    from repro_torch.models import layers as L

    cfg, p, x, k, v = dyadic_attention()
    kw, vw = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    with torch.inference_mode():
        o, kw, vw = L.attention_decode(
            torch.from_numpy(x), {n: torch.from_numpy(w) for n, w in p.items()},
            cfg, kw, vw, COMBINE_POS, rope=False)
    mesh = {"data": 2, "model": 2}
    cspec = (None, axes, None, None)
    for rank, r in enumerate(grid["ranks"]):
        got_o, got_k, got_v = r["combine"][axes]
        coords = _rank_coords(rank, 2)
        np.testing.assert_array_equal(got_o, o.numpy())
        np.testing.assert_array_equal(
            got_k, shd.shard_leaf(kw, cspec, mesh, coords).numpy())
        np.testing.assert_array_equal(
            got_v, shd.shard_leaf(vw, cspec, mesh, coords).numpy())
    # the scores really are 0 or 1/4 weights: the new token was written
    assert not np.array_equal(kw.numpy(), k)


def test_uneven_query_heads_train_on_the_model_axis(grid):
    """Loss and gradients of 6 query heads on 4 model ranks (each rank's
    48 columns end inside a head) equal the unsharded port's."""
    cfg = case_cfg(CASES["granite_h6_b4"])
    api = model_api(cfg)
    np_params, batch = grid["extras"]["uneven"]
    params = params_from_jax(np_params, "cpu")
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, _ = api.loss(params.tree(), b)
    grads = torch.autograd.grad(loss, params.leaves())
    for r in grid["ranks"]:
        got_loss, got = r["uneven_grads"]
        np.testing.assert_allclose(got_loss, loss.item(), rtol=1e-6)
        for p, g in zip(params.paths, grads):
            want = g.numpy()
            np.testing.assert_allclose(got["/".join(p)], want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=str(p))


def test_cache_length_that_does_not_split_raises(grid):
    for r in grid["ranks"]:
        assert r["split_error"] is not None
        assert "cache length 10 does not split" in r["split_error"]
