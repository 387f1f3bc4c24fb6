"""The port's partition rules (``repro_torch.parallel.sharding``), mesh
shapes and elastic sizing against the JAX reference's.

Pins, all exact:

- the spec table: ``param_pspecs`` of the smoke tree of every arch in
  the registry (all ten, each under its own profile, kimi's included)
  equals the reference's ``param_pspecs`` leaf by leaf, the reference's
  ``PartitionSpec`` read as a tuple;
- ``local_shape`` equals the reference's ``core/aggregators._local_shape``
  and ``zero_slice_dim`` with specs the reference's, on every smoke leaf
  under (data 2, model 2), (pod 2, data 16, model 16) and (data 4,
  model 1);
- the cases of ``tests/test_sharding_rules.py`` for ``batch_pspec``,
  ``cache_pspecs``, ``filter_rules_for_mesh`` and ``strip_axes``, and
  the same functions on further meshes and batches against the
  reference's own outputs (a mesh is its shape here; the reference's
  functions read ``mesh.shape`` and ``mesh.axis_names`` only);
- ``ShardingProfile.logical_rules`` equals the reference's;
- ``elastic_mesh`` sizes ``(data, model)`` as the reference's
  ``elastic_data_parallel`` (the cases of ``tests/test_data_ft.py``),
  and ``Membership.local_mesh`` as ``tests/drivers/elastic_driver.py``
  on its pool of 8 devices (3 clients: data 2; 10 clients: data 8, and
  ``{"data": 4, "model": 2}`` at model_parallel 2);
- ``grid_ranks`` puts the model axis innermost (rank ``d·MP + t``), the
  reference's ``make_mesh((data, model))`` device order, and
  ``make_production_mesh`` has the reference's shapes.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_arch as j_get_arch
from repro.core.aggregators import _local_shape as j_local_shape
from repro.core.streams import zero_slice_dim as j_zero_slice_dim
from repro.ft.failures import elastic_data_parallel as j_elastic_dp
from repro.models import model_api as j_model_api
from repro.parallel import sharding as jshd
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.streams import zero_slice_dim
from repro_torch.elastic.membership import Membership
from repro_torch.ft.failures import elastic_mesh
from repro_torch.launch.mesh import grid_ranks, make_production_mesh
from repro_torch.models.params import flatten_tree
from repro_torch.models.registry import model_api
from repro_torch.parallel import sharding as shd

MESHES = [{"data": 2, "model": 2}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 1}, {"data": 1, "model": 1}]


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _spec(p):
    """A spec as a tuple, a one-name tuple entry as the name (JAX's
    ``PartitionSpec`` normalises ``P(("data",))`` to ``P("data")``)."""
    return tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s
                 for s in p)


@pytest.fixture(scope="module")
def trees():
    """{arch: (port leaves [(path, tensor)], reference specs by path)}."""
    out = {}
    for name in list_archs():
        arch, jarch = get_arch(name), j_get_arch(name)
        tree = model_api(arch.smoke).init(0, "cpu").tree()
        jtree = jax.eval_shape(j_model_api(jarch.smoke).init,
                               jax.random.PRNGKey(0))
        jspecs = jshd.param_pspecs(jtree, jarch.train.sharding)
        flat = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        want = {tuple(str(k.key) for k in path): _spec(s) for path, s in flat}
        out[name] = (flatten_tree(tree), want, arch.train.sharding)
    return out


@pytest.mark.parametrize("name", sorted(
    ["qwen2-7b", "qwen2.5-3b", "qwen1.5-32b", "granite-3-2b", "mamba2-1.3b",
     "internvl2-2b", "jamba-v0.1-52b", "deepseek-moe-16b", "kimi-k2-1t-a32b",
     "whisper-tiny"]))
def test_spec_table_equals_reference(trees, name):
    leaves, want, prof = trees[name]
    assert get_arch(name).train.sharding == get_arch(name).profile
    got = flatten_tree(shd.param_pspecs(dict(_unflat(leaves)), prof))
    assert [p for p, _ in got] == sorted(want)
    for path, spec in got:
        assert spec == want[path], (name, path)


def _unflat(leaves):
    from repro_torch.models.params import unflatten_tree
    return unflatten_tree(leaves)


def test_all_ten_archs_covered():
    assert len(list_archs()) == 10


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
def test_local_shape_and_zero_slice_dim_equal_reference(trees, mesh):
    for name, (leaves, want, _) in trees.items():
        dp = mesh.get("pod", 1) * mesh["data"]
        for path, t in leaves:
            spec = want[path]
            shape = tuple(t.shape)
            if all(s is None or all(a in mesh for a in
                                    (s if isinstance(s, tuple) else (s,)))
                   for s in spec):
                assert shd.local_shape(shape, spec, mesh) == \
                    j_local_shape(shape, jax.sharding.PartitionSpec(*spec),
                                  _mesh(mesh)), (name, path)
            assert zero_slice_dim(shape, spec, dp) == \
                j_zero_slice_dim(shape, jax.sharding.PartitionSpec(*spec), dp)


def test_shard_and_gather_roundtrip():
    full = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    spec = (None, "model", None)
    mesh = {"data": 2, "model": 3}
    parts = [shd.shard_leaf(full, spec, mesh, {"data": 1, "model": t})
             for t in range(3)]
    assert all(p.shape == shd.local_shape(full.shape, spec, mesh)
               for p in parts)
    assert torch.equal(torch.cat(parts, dim=1), full)
    # a dim over two axes takes the rank-major block
    spec2 = (("data", "model"), None, None)
    full2 = torch.arange(12 * 2).reshape(12, 2, 1)
    got = shd.shard_leaf(full2, spec2, mesh, {"data": 1, "model": 2})
    assert torch.equal(got, full2[10:12])
    with pytest.raises(ValueError):
        shd.shard_leaf(torch.zeros(5, 2), ("model", None), mesh, {"model": 0})
    # no model dim, or no group: the shard itself
    assert shd.gather_leaf(full, (None, None, None), None) is full


# ----------------------------------------------------------------------
# the cases of tests/test_sharding_rules.py, and more meshes
# ----------------------------------------------------------------------

def test_rule_cases_of_the_reference_tests(trees):
    specs = dict(flatten_tree(shd.param_pspecs(
        _unflat(trees["qwen2-7b"][0]), get_arch("qwen2-7b").profile)))
    assert specs[("layers", "attn", "wq")] == (None, None, "model")
    assert specs[("layers", "attn", "wo")] == (None, "model", None)
    assert specs[("layers", "attn", "bq")] == (None, "model")
    assert specs[("layers", "ffn", "w_down")] == (None, "model", None)
    assert specs[("layers", "ln1", "scale")] == (None, None)
    assert specs[("embed",)] == ("model", None)
    mesh = {"data": 1, "model": 1}
    prof = shd.ShardingProfile()
    assert shd.batch_pspec(4, mesh, prof) == (("data",),)
    assert shd.batch_pspec(1, mesh, prof) == (("data",),)
    c = shd.cache_pspecs(get_arch("qwen2-7b").smoke, 8, mesh, prof)
    assert set(c) == {"k", "v"}
    c = shd.cache_pspecs(get_arch("jamba-v0.1-52b").smoke, 8, mesh, prof)
    assert set(c) == {"mamba", "kv"}
    rules = {"dp": ("pod", "data"), "tp": "model", "ep": "pod"}
    assert shd.filter_rules_for_mesh(rules, mesh) == \
        {"dp": ("data",), "tp": "model", "ep": None}
    assert shd.strip_axes((("pod", "data"), "model"), ["pod", "data"]) == \
        (None, "model")


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return _spec(tree)


@pytest.mark.parametrize("mesh", MESHES[:3], ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("batch", [1, 3, 4, 8, 128])
def test_batch_and_cache_specs_equal_reference(mesh, batch):
    for name in list_archs():
        prof, jprof = get_arch(name).profile, j_get_arch(name).profile
        assert _spec(shd.batch_pspec(batch, mesh, prof)) == \
            _spec(jshd.batch_pspec(batch, _mesh(mesh), jprof))
        got = shd.cache_pspecs(get_arch(name).smoke, batch, mesh, prof)
        want = jshd.cache_pspecs(j_get_arch(name).smoke, batch, _mesh(mesh),
                                 jprof)
        assert _tuples(got) == _tuples(want), name


def test_filter_strip_and_logical_rules_equal_reference():
    for name in list_archs():
        prof, jprof = get_arch(name).profile, j_get_arch(name).profile
        assert dataclasses.asdict(prof) == dataclasses.asdict(jprof)
        for inside in (False, True):
            rules = prof.logical_rules(inside)
            assert rules == jprof.logical_rules(inside)
            for mesh in MESHES:
                assert shd.filter_rules_for_mesh(rules, mesh) == \
                    jshd.filter_rules_for_mesh(rules, _mesh(mesh))
    P = jax.sharding.PartitionSpec
    for spec, axes in [((("pod", "data"), "model"), ["pod"]),
                       ((None, ("data", "model"), "data"), ["data"]),
                       (("model",), ["model"]), ((), ["data"])]:
        assert _spec(shd.strip_axes(spec, axes)) == \
            _spec(jshd.strip_axes(P(*spec), axes))


# ----------------------------------------------------------------------
# meshes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("avail,mp", [(7, 1), (6, 2), (5, 4), (12, 3),
                                      (8, 2), (3, 2), (1, 1)])
def test_elastic_mesh_sizes_as_reference(avail, mp):
    m = elastic_mesh(avail, mp)
    assert m.shape == {"data": j_elastic_dp(avail, mp), "model": mp}
    assert m.axis_names == ("data", "model")
    assert m.size == m.shape["data"] * mp


def test_elastic_mesh_single_device_and_refusal():
    assert elastic_mesh(available_devices=1, model_parallel=1).shape == \
        {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        elastic_mesh(available_devices=1, model_parallel=2)


def test_local_mesh_follows_the_roster_as_the_elastic_driver():
    mem = Membership()
    for c in range(3):
        mem.join(c)
    assert mem.local_mesh(devices=8).shape == {"data": 2, "model": 1}
    for c in range(3, 10):
        mem.join(c)
    assert mem.local_mesh(devices=8).shape == {"data": 8, "model": 1}
    assert mem.local_mesh(model_parallel=2, devices=8).shape == \
        {"data": 4, "model": 2}
    mem.leave(0)
    mem.leave(1)
    assert mem.local_mesh(devices=8).shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError, match="empty roster"):
        Membership().local_mesh(devices=8)


def test_grid_order_and_production_shapes():
    dp, mp = grid_ranks(2, 2)
    # the reference's make_mesh((2, 2)) lays devices 0..3 out row-major:
    # device (d, t) = 2·d + t
    devices = np.arange(4).reshape(2, 2)
    assert dp == tuple(tuple(devices[:, t]) for t in range(2))
    assert mp == tuple(tuple(devices[d, :]) for d in range(2))
    assert grid_ranks(4, 1) == (((0, 1, 2, 3),), ((0,), (1,), (2,), (3,)))
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512


def test_hints_outside_a_region_are_the_unsharded_forms():
    from repro_torch.parallel import hints

    x = torch.randn(3, 5, requires_grad=True)
    assert hints.model_group() is None and hints.model_index() == 0
    assert hints.constrain(x, ("dp", None, "tp")) is x
    assert hints.copy_to_model(x) is x and hints.reduce_from_model(x) is x
    table = torch.randn(7, 4)
    tokens = torch.tensor([[0, 6, 3]])
    assert torch.equal(hints.vocab_embed(table, tokens), table[tokens])
    labels = torch.tensor([1, 4, 0])
    lse, ll = hints.vocab_parallel_lse(x, labels)
    assert torch.equal(lse, torch.logsumexp(x, dim=-1))
    assert torch.equal(ll, x[torch.arange(3), labels])
    one = type("G", (), {"workers": 1})()
    with hints.model_region(one):             # a group of one binds nothing
        assert hints.model_group() is None
