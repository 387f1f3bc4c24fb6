"""The port's plan layer against the JAX reference's, on the CPU: wire
plans (``core/wireplan.py``), the wire accounting of the config
(``wire_bytes``, ``strategy_wire_bytes``) and the cost model
(``core/costmodel.py``). All host logic, compared on the same inputs:

- plan validation raises the same exception with the same text, and
  ``describe()``, ``uniform_wire``, ``is_trivial``, ``wire_of`` and
  ``plan_from_assignments`` agree;
- ``wire_bytes`` and ``strategy_wire_bytes`` are equal dicts over stream
  lengths, W in {1, 2, 3, 8}, the bitmap and the Bloom index, the f32
  and fxp32 wires and ``zero1_aligned``;
- ``analytic_bucket_costs``, ``analytic_alltoall_costs`` and
  ``analytic_plan`` are equal floats and plans, the port's ``device``
  standing in for the reference's backend: ``"cpu"`` (or
  ``use_pallas="never"``) for its composed path, ``"cuda"`` for its
  ``use_pallas="always"`` kernels;
- the two controllers driven by the same synthetic walls and occupancy
  give the same plan at every step and equal ``decision_trace()`` JSON;
- ``priors_from_codec_report`` is equal on full reports, and the port
  raises where the reference would take a TPU constant.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.wireplan as jwp
from repro.core import costmodel as jcm
from repro.core.bucketing import make_bucket_plan as j_make_bucket_plan
from repro.core.config import CompressionConfig as JaxConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import wireplan as wp
from repro_torch.core.bucketing import make_bucket_plan
from repro_torch.core.config import GAMMA, CompressionConfig

# tests/test_wireplan.py's geometry: block_elems 768, two blocks a bucket
FIELDS = dict(ratio=1.0, lanes=128, rows=6, rounds=10, chunk_blocks=4,
              bucket_bytes=2 * 768 * 4, replan_every=4)
CFG = CompressionConfig(**FIELDS)
JCFG = JaxConfig(**FIELDS)


def _plans(n_buckets=6):
    """The same n-bucket stream as a plan of each package."""
    n = n_buckets * 1536 - 10
    plan = make_bucket_plan([torch.zeros(n)], CFG)
    jplan = j_make_bucket_plan({"a": np.zeros(n, np.float32)}, JCFG)
    assert plan.n_buckets == jplan.n_buckets == n_buckets
    assert plan.bucket_elems == jplan.bucket_elems
    return plan, jplan


def _outcome(build, m):
    """``build(module)``'s describe() string (or value), or its
    exception's text."""
    try:
        out = build(m)
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", out if isinstance(out, str) else out.describe())


G = lambda m, *a, **k: m.WireGroup(*a, **k)          # noqa: E731
PLAN_CASES = {
    "mixed": lambda m: m.WirePlan(6, (G(m, 0, 2, "dense"),
                                      G(m, 2, 2, "compressed"),
                                      G(m, 4, 2, "compressed_rs"))),
    "chunked": lambda m: m.WirePlan(6, (G(m, 0, 3, "compressed_innet", 1),
                                        G(m, 3, 3, "compressed", 3))),
    "alltoall": lambda m: m.uniform_plan(6, "compressed", pattern="alltoall"),
    "positional_pattern": lambda m: m.WirePlan(
        6, (G(m, 0, 6, "compressed", 3, "alltoall"),)),
    "empty": lambda m: m.WirePlan(6, ()),
    "short": lambda m: m.WirePlan(6, (G(m, 0, 5, "dense"),)),
    "gap_front": lambda m: m.WirePlan(6, (G(m, 1, 5, "dense"),)),
    "overlap": lambda m: m.WirePlan(6, (G(m, 0, 4, "dense"),
                                        G(m, 3, 3, "compressed"))),
    "hole": lambda m: m.WirePlan(6, (G(m, 0, 4, "dense"),
                                     G(m, 5, 1, "compressed"))),
    "zero_buckets": lambda m: m.WirePlan(0, (G(m, 0, 1, "dense"),)),
    "mixed_patterns": lambda m: m.WirePlan(
        6, (G(m, 0, 3, "compressed"), G(m, 3, 3, "compressed",
                                        pattern="alltoall"))),
    "unknown_wire": lambda m: m.uniform_plan(2, "quantum"),
    "empty_group": lambda m: m.uniform_plan(0, "dense"),
    "negative_start": lambda m: m.WirePlan(2, (G(m, -1, 2, "dense"),)),
    "zero_chunks": lambda m: m.uniform_plan(2, "compressed", stream_chunks=0),
    "dense_chunks": lambda m: m.uniform_plan(2, "dense", stream_chunks=2),
    "unknown_pattern": lambda m: m.uniform_plan(2, "dense", pattern="gossip"),
    "rs_alltoall": lambda m: m.uniform_plan(2, "compressed_rs",
                                            pattern="alltoall"),
    "innet_alltoall": lambda m: m.uniform_plan(2, "compressed_innet",
                                               pattern="alltoall"),
}


def test_constants_and_registry_match_reference():
    from repro_torch.core.aggregators import AGGREGATORS
    assert wp.WIRES == jwp.WIRES and wp.PATTERNS == jwp.PATTERNS
    for p in wp.PATTERNS:
        assert wp.pattern_wires(p) == jwp.pattern_wires(p)
    with pytest.raises(ValueError, match="unknown pattern 'broadcast'"):
        wp.pattern_wires("broadcast")
    assert set(wp.WIRES) == set(AGGREGATORS) - {"auto"}
    assert cm.fixed_wires() == jcm.fixed_wires()
    assert cm.COMPRESSED_WIRES == jcm.COMPRESSED_WIRES
    assert GAMMA == 1.23


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_validation_and_describe_match_reference(case):
    got = _outcome(PLAN_CASES[case], wp)
    assert got == _outcome(PLAN_CASES[case], jwp)
    assert (got[0] == "ok") == (case in ("mixed", "chunked", "alltoall",
                                         "positional_pattern"))


@pytest.mark.parametrize("case", ["mixed", "chunked", "alltoall"])
def test_plan_properties_match_reference(case):
    p, q = PLAN_CASES[case](wp), PLAN_CASES[case](jwp)
    assert (p.uniform_wire, p.is_trivial, p.pattern) == \
        (q.uniform_wire, q.is_trivial, q.pattern)
    assert [p.wire_of(b) for b in range(6)] == [q.wire_of(b) for b in range(6)]
    assert [g.stop for g in p.groups] == [g.stop for g in q.groups]
    for b in (-1, 6):
        assert _outcome(lambda m: p.wire_of(b), wp) == \
            _outcome(lambda m: q.wire_of(b), jwp)


@pytest.mark.parametrize("wires", [
    ["dense", "dense", "compressed", "compressed", "compressed", "dense"],
    ["compressed_rs"] * 4,
    ["compressed_innet", "dense", "compressed_rs", "compressed"],
], ids=["coalesce", "uniform", "four"])
def test_plan_from_assignments_matches_reference(wires):
    p, q = wp.plan_from_assignments(wires), jwp.plan_from_assignments(wires)
    assert p.describe() == q.describe() and p.is_trivial == q.is_trivial
    assert [dataclasses.astuple(g) for g in p.groups] == \
        [dataclasses.astuple(g) for g in q.groups]
    with pytest.raises(ValueError, match="at least one bucket"):
        wp.plan_from_assignments([])


# ----------------------------------------------------------------------
# wire accounting
# ----------------------------------------------------------------------

LENGTHS = [1, 767, 1536 * 5 + 3, 123_457, 2_000_001]


@pytest.mark.parametrize("workers", [1, 2, 3, 8])
@pytest.mark.parametrize("index", ["bitmap", "bloom"])
@pytest.mark.parametrize("wire", ["f32", "fxp32"])
def test_strategy_wire_bytes_match_reference(workers, index, wire):
    for fields in (FIELDS, dict(ratio=0.1, topk_ratio=0.04),
                   dict(ratio=0.3, lanes=500, bucket_bytes=1 << 16)):
        f = dict(fields, index=index, wire_dtype=wire)
        cfg, jcfg = CompressionConfig(**f), JaxConfig(**f)
        assert (cfg.sketch_elems, cfg.peel_capacity) == \
            (jcfg.sketch_elems, jcfg.peel_capacity)
        for n in LENGTHS:
            assert cfg.padded_size(n) == jcfg.padded_size(n)
            for gb in (2, 4):
                assert cfg.wire_bytes(n, gb) == jcfg.wire_bytes(n, gb)
                for aligned in (False, True):
                    got = cfg.strategy_wire_bytes(
                        n, workers, grad_bytes_per_elem=gb,
                        zero1_aligned=aligned)
                    want = jcfg.strategy_wire_bytes(
                        n, workers, grad_bytes_per_elem=gb,
                        zero1_aligned=aligned)
                    assert got == want, (fields, n, gb, aligned)
                    assert json.dumps(got) == json.dumps(want)
    with pytest.raises(ValueError, match="workers must be >= 1"):
        CFG.strategy_wire_bytes(10, 0)


def test_compressor_wire_bytes_is_the_config_s():
    from repro_torch.core.compressor import HomomorphicCompressor
    assert HomomorphicCompressor(CFG).wire_bytes(5000, 4) == \
        CFG.wire_bytes(5000, 4)


# ----------------------------------------------------------------------
# the cost model
# ----------------------------------------------------------------------

# port (policy, device) -> the reference's policy with the same passes
BACKENDS = {"never_cpu": ("never", "cpu", "never"),
            "auto_cpu": ("auto", "cpu", "auto"),
            "never_cuda": ("never", "cuda", "never"),
            "cuda_kernels": ("auto", "cuda", "always")}


def _cfgs(backend, **fields):
    policy, device, jpolicy = BACKENDS[backend]
    return (dataclasses.replace(CFG, use_pallas=policy, **fields), device,
            dataclasses.replace(JCFG, use_pallas=jpolicy, **fields))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("fields", [{}, dict(wire_dtype="fxp32"),
                                    dict(index="bloom", ratio=0.3)], ids=str)
def test_analytic_costs_and_plan_match_reference(backend, fields):
    plan, jplan = _plans()
    cfg, dev, jcfg = _cfgs(backend, **fields)
    for W in (1, 2, 4, 8):
        for gb in (2, 4):
            got = cm.analytic_bucket_costs(plan, cfg, W, gb, device=dev)
            assert got == jcm.analytic_bucket_costs(jplan, jcfg, W, gb)
            assert cm.analytic_plan(plan, cfg, W, gb, device=dev) \
                .describe() == jcm.analytic_plan(jplan, jcfg, W, gb).describe()
            for n in (1, 9_000, 250_001):
                assert cm.analytic_alltoall_costs(n, cfg, W, gb, device=dev) \
                    == jcm.analytic_alltoall_costs(n, jcfg, W, gb)
    assert cm.analytic_plan(plan, cfg, 1, device=dev).uniform_wire == "dense"


def test_occupancy_and_finest_chunks_match_reference():
    cap = CFG.peel_capacity / CFG.block_elems
    for occ in (0.0, 0.5 * cap, 0.9 * cap - 1e-9, 0.9 * cap, 0.9 * cap + 1e-9,
                cap, 1.0):
        assert cm.occupancy_feasible(occ, CFG) == \
            jcm.occupancy_feasible(occ, JCFG)
    for cfg, jcfg in ((CFG, JCFG),
                      (dataclasses.replace(CFG, index="bloom"),
                       dataclasses.replace(JCFG, index="bloom"))):
        for wire in wp.WIRES:
            for nb, W in ((6, 4), (415, 2), (1, 1), (17, 3)):
                assert cm._finest_chunks(wire, nb, W, cfg) == \
                    jcm._finest_chunks(wire, nb, W, jcfg)


def _drive(ctl, steps, walls, occupancy):
    """Synthetic walls: a uniform plan costs its wire's entry, a mixed
    plan the bucket-weighted mix (a chunk override 10% less); the plan
    of every step, and the plan after the last."""
    plans = []
    for step in range(steps):
        p = ctl.plan(step)
        plans.append(p.describe())
        w = p.uniform_wire
        if w is not None:
            wall = walls[w] * (0.9 if p.groups[0].stream_chunks else 1.0)
        else:
            wall = sum(walls[g.wire] * g.n_buckets for g in p.groups) \
                / p.n_buckets
        tel = None if occupancy is None else \
            {"bucket_occupancy": occupancy(step)}
        ctl.observe(wall + 1e-4 * (step % 3), tel)
    plans.append(ctl.plan(steps).describe())
    return plans


WALLS = {"dense": 0.0030, "compressed": 0.0055,
         "compressed_rs": 0.0050, "compressed_innet": 0.0060}
SCENARIOS = {
    "dense_wins": (WALLS, None),
    "veto": (dict(WALLS, compressed=0.0010),
             lambda s: [0.01, 0.01, 0.99, 0.99, 0.01, 0.01]),
    "drifting_occupancy": (dict(WALLS, compressed_rs=0.0008),
                           lambda s: [0.02 * s, 0.5, 0.01, 0.3 + 0.05 * s,
                                      0.0, 0.6]),
    "innet_wins": (dict(WALLS, compressed_innet=0.0005),
                   lambda s: [0.01] * 6),
}


@pytest.mark.parametrize("backend", ["never_cpu", "cuda_kernels"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("workers", [2, 4])
def test_controller_matches_reference(backend, scenario, workers):
    plan, jplan = _plans()
    cfg, dev, jcfg = _cfgs(backend)
    walls, occupancy = SCENARIOS[scenario]
    ctl = cm.AutoWireController(plan, cfg, workers=workers, device=dev)
    jctl = jcm.AutoWireController(jplan, jcfg, workers=workers)
    steps = 10 * cfg.replan_every
    got = _drive(ctl, steps, walls, occupancy)
    assert got == _drive(jctl, steps, walls, occupancy)
    trace = ctl.decision_trace()
    assert json.dumps(trace, sort_keys=True) == \
        json.dumps(jctl.decision_trace(), sort_keys=True)
    assert not trace["probing"]
    if scenario == "veto":
        assert got[-1] == "[0:2]=compressed | [2:4]=dense | [4:6]=compressed"


def test_controller_plan_static_within_window_and_mixed_key():
    plan, _ = _plans()
    ctl = cm.AutoWireController(plan, CFG, workers=4, device="cpu")
    plans = [ctl.plan(s) for s in range(CFG.replan_every)]
    assert all(p == plans[0] for p in plans)
    mixed = wp.WirePlan(6, (wp.WireGroup(0, 3, "dense"),
                            wp.WireGroup(3, 3, "compressed")))
    assert ctl._plan_key(mixed) is None
    assert ctl._plan_key(wp.uniform_plan(6, "compressed", stream_chunks=3)) \
        == ("compressed", 3)


REPORTS = {
    "achieved": {"achieved_codec_bytes_per_s": 1.2e12,
                 "hbm_bytes_per_s": 3.35e12, "ici_bytes_per_s": 2.5e9},
    "hbm_only": {"achieved_codec_bytes_per_s": None,
                 "hbm_bytes_per_s": 3.35e12, "ici_bytes_per_s": 9e10},
    "no_achieved_key": {"hbm_bytes_per_s": 8e11, "ici_bytes_per_s": 1},
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_priors_from_codec_report_match_reference(name):
    got = cm.priors_from_codec_report(REPORTS[name])
    assert got == jcm.priors_from_codec_report(REPORTS[name])
    cfg = dataclasses.replace(CFG, **got)        # valid priors
    assert cfg.auto_link_gbps > 0 and cfg.auto_codec_gbps > 0


@pytest.mark.parametrize("missing,key", [
    ("ici_bytes_per_s", "ici_bytes_per_s"),
    ("hbm_bytes_per_s", "hbm_bytes_per_s"),
    ("both_codec", "achieved_codec_bytes_per_s")])
def test_priors_from_codec_report_raise_without_a_key(missing, key):
    report = dict(REPORTS["hbm_only"])
    if missing == "both_codec":
        report = {"ici_bytes_per_s": 1e9}
    else:
        report.pop(missing)
    with pytest.raises(ValueError, match=key):
        cm.priors_from_codec_report(report)
